// One-warp and few-warp loops that time, on the card, the pieces csrc/fire.cu's
// design rests on. Built and driven by fire_micro.py beside this file; not
// part of the port's path.
//   latency:  dependent chains of one or two integer instructions;
//   decode_pairs / encode_pairs: the chain loops of an earlier form of the
//     kernels (one 4-byte shared-memory cell a row, a multiply-add and a
//     byte permute a row at decode), with and without reading the next
//     block's operands while this one computes;
//   decode_dot / encode_cells: the chain loops as the kernels have them
//     (16-byte cells, the two-way dot product at decode), alone in a CTA;
//   stores: W warps of a CTA storing 8 rows a block, row stride D.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int32_t signed_byte1(uint32_t x) {
  int32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(x), "r"(0u), "r"(0x9991u));
  return d;
}
template <int BITS>
__device__ __forceinline__ int32_t sext(uint32_t x) {
  if constexpr (BITS == 8) return (int32_t)(int8_t)x;
  else if constexpr (BITS == 16) return (int32_t)(int16_t)x;
  else return (int32_t)x;
}
constexpr int GROUP = 32, TILE_BLOCKS = 16;
__device__ __forceinline__ int32_t coef_of(int32_t counter) {
  return sext<16>((uint32_t)(counter >> 5) << 4);
}
__device__ __forceinline__ int32_t next_counter(int32_t counter, uint32_t gs) {
  return sext<16>((uint32_t)counter + (uint32_t)(sext<8>(gs) >> 2));
}

// MODE 0: x = x * a + b; 1: then the byte permute; 2: then >> 16; 3: the
// two-way dot product; 4: the high half of the product, plus b
template <int MODE>
__global__ void latency_kernel(uint32_t a, uint32_t b, int iters, long long* out) {
  uint32_t x = threadIdx.x + b;
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (MODE == 0) x = x * a + b;
      if (MODE == 1) x = (uint32_t)signed_byte1(x * a + b);
      if (MODE == 2) x = (uint32_t)((int32_t)(x * a + b) >> 16);
      if (MODE == 3) x = (uint32_t)__dp2a_lo((int)a, (int)x, (int)b);
      if (MODE == 4) x = (uint32_t)__mulhi((int)x, (int)a) + b;
    }
  }
  const long long c1 = clock64();
  if (threadIdx.x == 0) out[0] = c1 - c0;
  if (x == 0x12345) out[1] = x;
}

// FLAGS bit0: store deltas; bit1: use sign loads; bit2: counter update; bit3: prefetch pairs (else load at block start)
template <int FLAGS>
__global__ void decode_pairs_kernel(int tiles, long long* out, uint32_t seed) {
  __shared__ uint32_t wsm[128 * 32]; __shared__ int8_t ssm[64 * 32];
  const int lane = threadIdx.x;
  for (int i = lane; i < 128 * 32; i += 32) wsm[i] = (i * seed) << 8;
  for (int i = lane; i < 64 * 32; i += 32) ssm[i] = (int8_t)((i * seed >> 7) % 3 - 1);
  __syncwarp();
  int32_t prev_delta = lane, counter = lane * 77;
  uint32_t* w = wsm + lane; const int8_t* sign = ssm + lane;
  long long c0 = clock64();
  for (int t = 0; t < tiles; ++t) {
    const int nblk = TILE_BLOCKS;
    uint32_t e0[8], e1[8]; int32_t m0[4], m1[4];
    auto load = [&](uint32_t(&e)[8], int32_t(&m)[4], int b) {
#pragma unroll
      for (int r = 0; r < 8; ++r) e[r] = w[(b * 8 + r) * GROUP];
      if (FLAGS & 2) {
#pragma unroll
      for (int h = 0; h < 4; ++h) m[h] = sign[(b * 4 + h) * GROUP];
      } else { for (int h = 0; h < 4; ++h) m[h] = 1; }
    };
    auto step = [&](const uint32_t(&e)[8], const int32_t(&m)[4], int b) {
      const uint32_t c = (uint32_t)coef_of(counter);
      uint32_t grad_sum = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r & 1) grad_sum += (uint32_t)m[r >> 1] * (uint32_t)prev_delta;
        prev_delta = signed_byte1((uint32_t)prev_delta * c + e[r]);
        if (FLAGS & 1) w[(b * 8 + r) * GROUP] = (uint32_t)prev_delta;
      }
      if (FLAGS & 4) counter = next_counter(counter, grad_sum); else counter += grad_sum & 1;
    };
    if (FLAGS & 8) {
      load(e0, m0, 0);
      for (int b = 0; b < nblk; b += 2) {
        if (b + 1 < nblk) load(e1, m1, b + 1);
        step(e0, m0, b);
        if (b + 1 < nblk) { if (b + 2 < nblk) load(e0, m0, b + 2); step(e1, m1, b + 1); }
      }
    } else {
      for (int b = 0; b < nblk; ++b) { load(e0, m0, b); step(e0, m0, b); }
    }
  }
  long long c1 = clock64();
  if (lane == 0) out[0] = c1 - c0;
  if (prev_delta == 0x12345 && counter == 77) out[1] = 1;
}
template <int FLAGS>
__global__ void encode_pairs_kernel(int tiles, long long* out, uint32_t seed) {
  __shared__ int32_t dsm[128 * 32]; __shared__ int32_t csm[16 * 32];
  const int lane = threadIdx.x;
  for (int i = lane; i < 128 * 32; i += 32) dsm[i] = (int8_t)(i * seed >> 5);
  __syncwarp();
  int32_t counter = lane * 77;
  const int32_t* dl = dsm + lane; int32_t* coefs = csm + lane;
  long long c0 = clock64();
  for (int t = 0; t < tiles; ++t) {
    const int nblk = TILE_BLOCKS;
    int32_t x0[8], x1[8];
    auto load = [&](int32_t(&x)[8], int b) {
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = dl[(b * 8 + r) * GROUP];
    };
    auto step = [&](const int32_t(&x)[8], int b) {
      const int32_t c = coef_of(counter);
      if (FLAGS & 1) coefs[b * GROUP] = c;
      uint32_t grad[4];
#pragma unroll
      for (int r = 1; r < 8; r += 2) {
        const int32_t pred = sext<8>((uint32_t)((int32_t)((uint32_t)x[r - 1] * (uint32_t)c) >> 8));
        const int32_t err = sext<8>((uint32_t)x[r] - (uint32_t)pred);
        grad[r >> 1] = err == 0 ? 0u : (err < 0 ? 0u - (uint32_t)x[r - 1] : (uint32_t)x[r - 1]);
      }
      counter = next_counter(counter, (grad[0] + grad[1]) + (grad[2] + grad[3]));
    };
    load(x0, 0);
    for (int b = 0; b < nblk; b += 2) {
      if (b + 1 < nblk) load(x1, b + 1);
      step(x0, b);
      if (b + 1 < nblk) { if (b + 2 < nblk) load(x0, b + 2); step(x1, b + 1); }
    }
  }
  long long c1 = clock64();
  if (lane == 0) out[0] = c1 - c0;
  if (counter == 0x12345) out[1] = 1;
}
// the decode u8 chain with dp2a and 128-bit shared accesses: data [block][half][lane][4], aux [block][lane][4]
template <int FLAGS>
__global__ void decode_dot_kernel(int tiles, long long* out, uint32_t seed) {
  __shared__ uint4 wsm[16 * 2 * 32]; __shared__ int4 ssm[16 * 32];
  const int lane = threadIdx.x;
  for (int i = lane; i < 16 * 2 * 32; i += 32) wsm[i] = make_uint4((i * seed) << 8, (i * seed * 3) << 8, (i * seed * 5) << 8, (i * seed * 7) << 8);
  for (int i = lane; i < 16 * 32; i += 32) ssm[i] = make_int4(65536, -65536, 0, 65536);
  __syncwarp();
  uint32_t s = lane; int32_t counter = lane * 77;
  long long c0 = clock64();
  for (int t = 0; t < tiles; ++t) {
    for (int b = 0; b < 16; ++b) {
      const uint4 ea = wsm[(b * 2) * 32 + lane], eb = wsm[(b * 2 + 1) * 32 + lane];
      const int4 m = ssm[b * 32 + lane];
      const int c = coef_of(counter) << 16;
      const uint32_t e[8] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y, eb.z, eb.w};
      const int mm[4] = {m.x, m.y, m.z, m.w};
      uint32_t o[8]; int acc = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r & 1) acc = __dp2a_lo(mm[r >> 1], (int)s, acc);
        s = (uint32_t)__dp2a_lo(c, (int)s, (int)e[r]);
        o[r] = s;
      }
      if (FLAGS & 1) { wsm[(b * 2) * 32 + lane] = make_uint4(o[0], o[1], o[2], o[3]); wsm[(b * 2 + 1) * 32 + lane] = make_uint4(o[4], o[5], o[6], o[7]); }
      counter = next_counter(counter, (uint32_t)acc);
    }
  }
  long long c1 = clock64();
  if (lane == 0) out[0] = c1 - c0;
  if (s == 0x12345 && counter == 77) out[1] = 1;
}
// the encode chain, no explicit prefetch, 128-bit loads; FLAGS 1: unroll 2
template <int FLAGS>
__global__ void encode_cells_kernel(int tiles, long long* out, uint32_t seed) {
  __shared__ int4 dsm[16 * 2 * 32]; __shared__ int32_t csm[16 * 32];
  const int lane = threadIdx.x;
  for (int i = lane; i < 16 * 2 * 32; i += 32) dsm[i] = make_int4((int8_t)(i * seed >> 5), (int8_t)(i * seed >> 9), (int8_t)(i * seed >> 13), (int8_t)(i * seed >> 17));
  __syncwarp();
  int32_t counter = lane * 77;
  long long c0 = clock64();
  for (int t = 0; t < tiles; ++t) {
#pragma unroll(FLAGS & 1 ? 2 : 1)
    for (int b = 0; b < 16; ++b) {
      const int4 xa = dsm[(b * 2) * 32 + lane], xb = dsm[(b * 2 + 1) * 32 + lane];
      const int32_t x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const int32_t c = coef_of(counter);
      csm[b * 32 + lane] = c;
      uint32_t grad[4];
#pragma unroll
      for (int r = 1; r < 8; r += 2) {
        const int32_t pred = sext<8>((uint32_t)((int32_t)((uint32_t)x[r - 1] * (uint32_t)c) >> 8));
        const int32_t err = sext<8>((uint32_t)x[r] - (uint32_t)pred);
        grad[r >> 1] = err == 0 ? 0u : (err < 0 ? 0u - (uint32_t)x[r - 1] : (uint32_t)x[r - 1]);
      }
      counter = next_counter(counter, (grad[0] + grad[1]) + (grad[2] + grad[3]));
    }
  }
  long long c1 = clock64();
  if (lane == 0) out[0] = c1 - c0;
  if (counter == 0x12345) out[1] = 1;
}
// W warps of one CTA; warp w stores blocks b = w, w + W, ... of 8 rows x 32 lanes, row stride D elements
template <typename T>
__global__ void stores_kernel(T* out, int nblocks, int D, long long* cyc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  uint32_t v = threadIdx.x;
  __syncthreads();
  long long c0 = clock64();
  for (int b = warp; b < nblocks; b += W) {
    T* o = out + (long long)b * 8 * D + lane + blockIdx.x * 32;
#pragma unroll
    for (int r = 0; r < 8; ++r, o += D) { v = v * 1664525u + 1013904223u; *o = (T)v; }
  }
  long long c1 = clock64();
  if (threadIdx.x == 0 && blockIdx.x == 0) cyc[0] = c1 - c0;
}
}  // namespace

extern "C" {

int fire_micro_latency(int mode, int iters, long long* out) {
  switch (mode) {
    case 0: latency_kernel<0><<<1, 32>>>(0x9e3779b1u, 0x7f4a7c15u, iters, out); break;
    case 1: latency_kernel<1><<<1, 32>>>(0x9e3779b1u, 0x7f4a7c15u, iters, out); break;
    case 2: latency_kernel<2><<<1, 32>>>(0x9e3779b1u, 0x7f4a7c15u, iters, out); break;
    case 3: latency_kernel<3><<<1, 32>>>(0x12340000u, 0x7f4a7c15u, iters, out); break;
    default: latency_kernel<4><<<1, 32>>>(0x12345678u, 0x7fu, iters, out); break;
  }
  return (int)cudaDeviceSynchronize();
}

// prefetch != 0: the next block's operands are read while this one computes
int fire_micro_pairs(int decode, int prefetch, int tiles, long long* out) {
  if (decode) {
    if (prefetch) decode_pairs_kernel<15><<<1, 32>>>(tiles, out, 2654435761u);
    else decode_pairs_kernel<7><<<1, 32>>>(tiles, out, 2654435761u);
  } else {
    encode_pairs_kernel<1><<<1, 32>>>(tiles, out, 2654435761u);
  }
  return (int)cudaDeviceSynchronize();
}

// the chain loops as the kernels have them; unroll2: encode's loop unrolled
int fire_micro_cells(int decode, int unroll2, int tiles, long long* out) {
  if (decode) decode_dot_kernel<1><<<1, 32>>>(tiles, out, 2654435761u);
  else if (unroll2) encode_cells_kernel<1><<<1, 32>>>(tiles, out, 2654435761u);
  else encode_cells_kernel<0><<<1, 32>>>(tiles, out, 2654435761u);
  return (int)cudaDeviceSynchronize();
}

int fire_micro_stores(int bytes, int warps, int ctas, int nblocks, int D, void* out,
                      long long* cycles) {
  if (bytes == 1)
    stores_kernel<uint8_t><<<ctas, warps * 32>>>((uint8_t*)out, nblocks, D, cycles);
  else if (bytes == 2)
    stores_kernel<uint16_t><<<ctas, warps * 32>>>((uint16_t*)out, nblocks, D, cycles);
  else
    stores_kernel<uint32_t><<<ctas, warps * 32>>>((uint32_t*)out, nblocks, D, cycles);
  return (int)cudaDeviceSynchronize();
}

}  // extern "C"
