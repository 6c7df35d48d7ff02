// Row-major delta decode kernels for Hopper (sm_90a), bound with ctypes.
//
// unpack_zz_kernel<EB, RAW>  (K1, and K4 and K5 as its RAW mode)
//   Replaces sprintz_tpu/ops/pallas_decode.py:_unpack_zz_kernel (unpack_zz)
//   and, in RAW mode, sprintz_tpu/ops/pallas_pack.py:_unpack_kernel
//   (unpack_rows_pallas, K4: <16, true>, i32 fields) and _unpack_mxu_kernel
//   (unpack_rows_pallas_mxu, K5: <8, true>, its bf16 output that is exact
//   for u8 fields, here u8 fields: a quarter of K4's writes). The TPU's
//   block-diagonal MXU dot has no counterpart: the GPU reads the field's
//   bytes at their address. For every (block, row, dim) it reads the field at
//   bit offset `off` (the exclusive prefix of the block's widths) from a
//   3-byte window of the row, each byte guarded by `< maxb`, shifts it by
//   `off & 7` and masks it to `w` bits. A u16 field shifted by up to 7 bits
//   reaches 23 bits, so the window is 3 bytes for every element size.
//   Non-raw mode zigzag-decodes the field, stores `delta + 2^(EB-1)` narrow
//   and writes each tile's per-dim i32 sum of the signed deltas; RAW mode
//   stores the field, as u8 at EB 8 (fields of u8 streams are at most 8
//   bits wide) and as i32 at EB 16.
//   Bound on this card: bytes. It moves the payload, the i32 widths and
//   offsets once and writes one narrow value per field (about 2.5 bytes of
//   traffic per u8 value), with about a dozen integer operations per field.
//   Design: one thread per (row, dim); a CTA owns one tile of blocks for 32
//   dims, so neighbouring threads read and write neighbouring dims and the
//   tile total needs only a shared-memory reduction over the 8 row lanes,
//   written once, with no atomics and no zeroed buffer. The TPU version's
//   select-accumulate over every byte of the row becomes three guarded byte
//   loads at a data-dependent address, which the GPU does directly.
//
// prefix_finish_kernel<EB>  (K2)
//   Replaces sprintz_tpu/ops/pallas_decode.py:_prefix_finish_kernel
//   (prefix_finish). For each tile of rows_tile rows and each dim: the
//   inclusive prefix of the biased deltas minus bias x rows, plus the tile's
//   exclusive offset, masked to EB bits and narrowed. The TPU computed the
//   prefix as a bf16 lower-triangular matmul; here it is an integer scan.
//   Bound on this card: bytes (one narrow read and one narrow write per
//   value, one add each).
//   Design: one thread per (tile, dim) walks the tile's rows with a running
//   u32 sum (wrapping is absorbed by the EB-bit mask); neighbouring threads
//   take neighbouring dims, so each row's loads and stores coalesce.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SZ = 8;      // rows per block
constexpr int DIMS_PER_CTA = 32;  // threadIdx.x: dims; threadIdx.y: rows
constexpr int SCAN_THREADS = 128;

template <int EB>
struct Narrow;
template <>
struct Narrow<8> {
  using type = uint8_t;
};
template <>
struct Narrow<16> {
  using type = uint16_t;
};

template <int EB, bool RAW>
struct UnpackOut {
  using type = typename Narrow<EB>::type;
};
template <>
struct UnpackOut<8, true> {
  using type = uint8_t;
};
template <>
struct UnpackOut<16, true> {
  using type = int32_t;
};

template <int EB, bool RAW>
__global__ void unpack_zz_kernel(const uint8_t* __restrict__ dense,
                                 const int32_t* __restrict__ widths,
                                 const int32_t* __restrict__ off,
                                 typename UnpackOut<EB, RAW>::type* __restrict__ out,
                                 int32_t* __restrict__ tile_tot, int64_t nb,
                                 int ndims, int maxb, int tile_blocks) {
  __shared__ int32_t part[BLOCK_SZ][DIMS_PER_CTA];
  const int d = blockIdx.y * DIMS_PER_CTA + threadIdx.x;
  const int r = threadIdx.y;
  const int64_t b0 = (int64_t)blockIdx.x * tile_blocks;
  const int64_t b1 = b0 + tile_blocks < nb ? b0 + tile_blocks : nb;
  int32_t sum = 0;
  if (d < ndims) {
    for (int64_t b = b0; b < b1; ++b) {
      const int32_t w = widths[b * ndims + d];
      const int32_t o = off[b * ndims + d];
      const int32_t q = o >> 3;
      const int64_t row = b * BLOCK_SZ + r;
      const uint8_t* src = dense + row * maxb;
      uint32_t word = 0;
      if ((uint32_t)q < (uint32_t)maxb) word = src[q];
      if ((uint32_t)(q + 1) < (uint32_t)maxb) word |= (uint32_t)src[q + 1] << 8;
      if ((uint32_t)(q + 2) < (uint32_t)maxb) word |= (uint32_t)src[q + 2] << 16;
      const uint32_t u = (word >> (o & 7)) & ((1u << w) - 1u);
      const int64_t oi = row * ndims + d;
      if constexpr (RAW) {
        out[oi] = (typename UnpackOut<EB, RAW>::type)u;
      } else {
        const int32_t delta = (int32_t)(u >> 1) ^ -(int32_t)(u & 1u);
        out[oi] = (typename Narrow<EB>::type)(delta + (1 << (EB - 1)));
        sum += delta;
      }
    }
  }
  if constexpr (!RAW) {
    part[r][threadIdx.x] = sum;
    __syncthreads();
    if (r == 0 && d < ndims) {
      int32_t t = 0;
#pragma unroll
      for (int i = 0; i < BLOCK_SZ; ++i) t += part[i][threadIdx.x];
      tile_tot[(int64_t)blockIdx.x * ndims + d] = t;
    }
  }
}

template <int EB>
__global__ void prefix_finish_kernel(const typename Narrow<EB>::type* __restrict__ bz,
                                     const int32_t* __restrict__ tile_off,
                                     typename Narrow<EB>::type* __restrict__ out,
                                     int64_t rows, int ndims, int rows_tile,
                                     int64_t ntiles) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ntiles * ndims) return;
  const int64_t tile = g / ndims;
  const int64_t d = g - tile * ndims;
  const int64_t r0 = tile * rows_tile;
  const int64_t r1 = r0 + rows_tile < rows ? r0 + rows_tile : rows;
  constexpr uint32_t kBias = 1u << (EB - 1);
  constexpr uint32_t kMask = (1u << EB) - 1u;
  uint32_t acc = (uint32_t)tile_off[g];
#pragma unroll 8
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t i = r * ndims + d;
    acc += (uint32_t)bz[i] - kBias;
    out[i] = (typename Narrow<EB>::type)(acc & kMask);
  }
}

}  // namespace

extern "C" {

// dense (nb, 8, maxb) u8; widths, off (nb, ndims) i32.
// raw == 0: out (nb, 8, ndims) u8/u16 biased deltas, tile_tot
//           (ceil(nb / tile_blocks), ndims) i32.
// raw != 0: out (nb, 8, ndims) fields, u8 at elem_bits 8 and i32 at 16;
//           tile_tot unused.
int sprintz_unpack_zz(const void* dense, const void* widths, const void* off,
                      void* out, void* tile_tot, long long nb, int ndims,
                      int maxb, int tile_blocks, int elem_bits, int raw,
                      void* stream) {
  const long long ntiles = (nb + tile_blocks - 1) / tile_blocks;
  const dim3 grid((unsigned)ntiles, (unsigned)((ndims + DIMS_PER_CTA - 1) / DIMS_PER_CTA));
  const dim3 block(DIMS_PER_CTA, BLOCK_SZ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* dn = static_cast<const uint8_t*>(dense);
  const int32_t* wd = static_cast<const int32_t*>(widths);
  const int32_t* of = static_cast<const int32_t*>(off);
  int32_t* tt = static_cast<int32_t*>(tile_tot);
  if (raw && elem_bits == 8) {
    unpack_zz_kernel<8, true><<<grid, block, 0, s>>>(
        dn, wd, of, static_cast<uint8_t*>(out), tt, nb, ndims, maxb, tile_blocks);
  } else if (raw && elem_bits == 16) {
    unpack_zz_kernel<16, true><<<grid, block, 0, s>>>(
        dn, wd, of, static_cast<int32_t*>(out), tt, nb, ndims, maxb, tile_blocks);
  } else if (raw) {
    return (int)cudaErrorInvalidValue;
  } else if (elem_bits == 8) {
    unpack_zz_kernel<8, false><<<grid, block, 0, s>>>(
        dn, wd, of, static_cast<uint8_t*>(out), tt, nb, ndims, maxb, tile_blocks);
  } else if (elem_bits == 16) {
    unpack_zz_kernel<16, false><<<grid, block, 0, s>>>(
        dn, wd, of, static_cast<uint16_t*>(out), tt, nb, ndims, maxb, tile_blocks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// bz, out (rows, ndims) u8/u16; tile_off (ceil(rows / rows_tile), ndims) i32.
int sprintz_prefix_finish(const void* bz, const void* tile_off, void* out,
                          long long rows, int ndims, int rows_tile,
                          int elem_bits, void* stream) {
  const long long ntiles = (rows + rows_tile - 1) / rows_tile;
  const long long nthreads = ntiles * ndims;
  const unsigned nblocks = (unsigned)((nthreads + SCAN_THREADS - 1) / SCAN_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* to = static_cast<const int32_t*>(tile_off);
  if (elem_bits == 8) {
    prefix_finish_kernel<8><<<nblocks, SCAN_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(bz), to, static_cast<uint8_t*>(out), rows,
        ndims, rows_tile, ntiles);
  } else if (elem_bits == 16) {
    prefix_finish_kernel<16><<<nblocks, SCAN_THREADS, 0, s>>>(
        static_cast<const uint16_t*>(bz), to, static_cast<uint16_t*>(out), rows,
        ndims, rows_tile, ntiles);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The message of a CUDA error code, for the errors of every library here.
const char* sprintz_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
