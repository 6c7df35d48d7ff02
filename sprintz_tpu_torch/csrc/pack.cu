// Row-major bit-pack kernel for Hopper (sm_90a), bound with ctypes.
//
// pack_rows_kernel<ELEM_SZ>  (K3)
//   Replaces sprintz_tpu/ops/pallas_pack.py:_pack_kernel (pack_rows_pallas).
//   Each block row holds its dims' zigzag fields back to back, LSB first:
//   dim d's field starts at bit `off` = the exclusive prefix of the block's
//   widths. The row's maxb = ndims * ELEM_SZ bytes are written in full,
//   zero-filled past ceil(sum(w) / 8).
//   Bound on this card: bytes. It reads the i32 errors and widths once and
//   writes the dense payload once, with a few integer operations a field.
//   Design: a CTA of 128 threads packs a tile of consecutive rows (whole
//   blocks, about 4096 errors; part of one block where rows are long: the
//   wrapper picks the tile), whose errors and whose output bytes are each
//   one contiguous range:
//   1. each thread issues its first 16-byte loads of the tile's errors (4
//      dims a load, neighbouring lanes on neighbouring addresses); then
//      the CTA copies the tile's widths into shared memory and zeroes a
//      staging image of the tile's output bytes;
//   2. one warp a block scans the widths into (offset << 5 | width), 32
//      dims a step, once for the block's 8 rows;
//   3. each thread merges the fields of a load that lie in one row into a
//      run (32 bits at u8, 64 at u16) and ORs the run into the image with
//      shared-memory atomicOr, zero words skipped. It steps the row and
//      dim of its loads by counters, with no division a load; where ndims
//      % 4 == 0 (ROW_LOADS) a load lies in one row and takes one run;
//   4. the image leaves in 16-byte stores, aligned to the output; the
//      16-byte pieces at the tile's two ends that other tiles share leave
//      a byte at a time. One writer a byte, and the image's zeros are the
//      zero fill.
//
// pack_lowdim_kernel<ELEM_SZ>  (the lowdim layout's pack)
//   Replaces sprintz_tpu/ops/pack.py:pack_dims_lowdim (pack.py:251), an
//   XLA pass (one-hot matmuls or selects): JAX has no Pallas kernel here.
//   The lowdim layout (u8 ndims <= 4, u16 ndims <= 2) is column-major
//   within a block: dim d's 8 zigzag fields of w = widths[b, d] bits sit
//   back to back at bits r * w of the (block, dim) section, exactly w
//   bytes, in a dense (nb, D, EB) buffer whose EB = 8 * ELEM_SZ bytes are
//   zero past w.
//   Bound on this card: bytes. It reads the i32 errors and widths once and
//   writes the dense sections once, with a shift and an OR a field.
//   Design: a thread a (block, dim) item, neighbouring lanes on
//   neighbouring items, so that the section stores are consecutive and
//   the i32 reads of a row of the block are too. A thread issues its 8
//   loads at once, ORs the masked fields into one 64-bit word (u8) or two
//   (u16, where a field at r * w up to bit 112 may cross from the first
//   into the second), and stores the section with one 8- or 16-byte
//   store.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SZ = 8;  // rows per block
constexpr int PACK_THREADS = 128;
constexpr int PACK_LOADS = 4;  // 16-byte loads a thread has in flight
constexpr int SMEM_DEFAULT = 48 * 1024;  // above it the kernel must opt in
constexpr int SMEM_MAX = 227 * 1024;     // what a CTA may opt in to

// 16-byte units of the staging image of a tile of tile_rows rows: the
// image starts at the 16-byte boundary at or below the tile's first byte.
__host__ __device__ inline int pack_stage_units(int tile_rows, int maxb) {
  return (int)(((long long)tile_rows * maxb + 15 + 15) / 16);
}

// Blocks whose widths a tile needs: a tile of 8 rows or more is whole
// blocks; a shorter one divides 8 and lies in one block.
__host__ __device__ inline int pack_tile_blocks(int tile_rows) {
  return tile_rows >= BLOCK_SZ ? tile_rows / BLOCK_SZ : 1;
}

__host__ __device__ inline long long pack_smem_bytes(int tile_rows, int ndims,
                                                     int elem_sz) {
  return 16LL * pack_stage_units(tile_rows, ndims * elem_sz) +
         4LL * pack_tile_blocks(tile_rows) * ndims;
}

// OR a run of bits that starts at bit `pos` of the image: 2 words for a
// 32-bit run, 3 for a 64-bit one.
__device__ __forceinline__ void or_run(uint32_t* stage, int pos, uint32_t run) {
  if (run == 0) return;
  const int word = pos >> 5;
  const uint64_t lo = (uint64_t)run << (pos & 31);
  if ((uint32_t)lo) atomicOr(stage + word, (uint32_t)lo);
  if ((uint32_t)(lo >> 32)) atomicOr(stage + word + 1, (uint32_t)(lo >> 32));
}

__device__ __forceinline__ void or_run(uint32_t* stage, int pos, uint64_t run) {
  if (run == 0) return;
  const int word = pos >> 5;
  const int sh = pos & 31;
  const uint64_t lo = run << sh;
  const uint32_t w0 = (uint32_t)lo;
  const uint32_t w1 = (uint32_t)(lo >> 32);
  const uint32_t w2 = sh ? (uint32_t)(run >> (64 - sh)) : 0u;
  if (w0) atomicOr(stage + word, w0);
  if (w1) atomicOr(stage + word + 1, w1);
  if (w2) atomicOr(stage + word + 2, w2);
}

// ROW_LOADS: ndims % 4 == 0, so that each 16-byte load lies in one row.
template <int ELEM_SZ, bool ROW_LOADS>
__global__ void __launch_bounds__(PACK_THREADS)
    pack_rows_kernel(const int32_t* __restrict__ errs,
                     const int32_t* __restrict__ widths, uint8_t* __restrict__ out,
                     int64_t nrows, int ndims, int tile_rows) {
  extern __shared__ uint4 smem[];
  constexpr int kMaxWidth = 8 * ELEM_SZ;
  const int tid = threadIdx.x;
  const int maxb = ndims * ELEM_SZ;
  const int64_t row0 = (int64_t)blockIdx.x * tile_rows;
  const int rows = (int)(nrows - row0 < tile_rows ? nrows - row0 : tile_rows);
  const int64_t g0 = row0 * maxb;  // the tile's output bytes [g0, g1)
  const int64_t g1 = g0 + (int64_t)rows * maxb;
  const int64_t gbase = g0 & ~(int64_t)15;  // the image's first byte
  const int units = (int)((g1 - gbase + 15) >> 4);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_ow = stage + 4 * pack_stage_units(tile_rows, maxb);
  const int64_t b0 = row0 / BLOCK_SZ;
  const int nblk = (int)((row0 + rows - 1) / BLOCK_SZ - b0 + 1);

  // 1. The tile's errors are elements [e0, e1): 16-byte units [c0, c1),
  // whose elements outside the tile are skipped.
  const int64_t e0 = row0 * ndims;
  const int nel = rows * ndims;
  const int64_t c0 = e0 >> 2;
  const int64_t c1 = (e0 + nel + 3) >> 2;
  const int4* errs4 = reinterpret_cast<const int4*>(errs);
  int4 v[PACK_LOADS];
  int64_t base = c0 + tid;
#pragma unroll
  for (int u = 0; u < PACK_LOADS; ++u) {
    const int64_t c = base + u * PACK_THREADS;
    if (c < c1) v[u] = __ldg(errs4 + c);
  }
  for (int i = tid; i < nblk * ndims; i += PACK_THREADS) {
    int w = __ldg(widths + b0 * ndims + i);
    s_ow[i] = w < 0 ? 0 : (w > kMaxWidth ? kMaxWidth : w);  // memory safety only
  }
  for (int i = tid; i < units; i += PACK_THREADS) smem[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // 2. Offsets, once a block: an inclusive warp scan 32 dims a step.
  const int lane = tid & 31;
  for (int b = tid >> 5; b < nblk; b += PACK_THREADS / 32) {
    uint32_t* ow = s_ow + b * ndims;
    int carry = 0;
    for (int d0 = 0; d0 < ndims; d0 += 32) {
      const int d = d0 + lane;
      const int w = d < ndims ? (int)ow[d] : 0;
      int incl = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      if (d < ndims) ow[d] = ((uint32_t)(carry + incl - w) << 5) | (uint32_t)w;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();

  // 3. The fields of each load, merged into runs of contiguous bits (4
  // fields of 8 bits at most fit 32). The thread keeps the tile row r and
  // the dim d of its next load's first element, stepping them a load at a
  // time: li = r * ndims + d, with r < 0 before the tile's first element.
  using Run = typename std::conditional<ELEM_SZ == 1, uint32_t, uint64_t>::type;
  const int roff = (int)(row0 % BLOCK_SZ);  // nonzero for tiles under 8 rows
  const int bit0 = (int)(g0 - gbase) * 8;   // the tile's first bit in the image
  constexpr int STEP = 4 * PACK_THREADS;    // elements from a load to the next
  const int qs = STEP / ndims, rs = STEP - qs * ndims;
  int li = (int)(4 * base - e0);
  int r = li < 0 ? -((ndims - 1 - li) / ndims) : li / ndims;  // floor
  int d = li - r * ndims;
  while (true) {
#pragma unroll
    for (int u = 0; u < PACK_LOADS; ++u) {
      if (base + u * PACK_THREADS >= c1) break;
      const int32_t e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      if (ROW_LOADS) {  // 4 dims of one row: one run
        const uint32_t* ow = s_ow + ((r + roff) / BLOCK_SZ) * ndims + d;
        const int pos = bit0 + r * maxb * 8 + (int)(ow[0] >> 5);
        Run run = 0;
        int nbits = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int w = (int)(ow[j] & 31u);
          run |= (Run)((uint32_t)e[j] & ((1u << w) - 1u)) << nbits;
          nbits += w;
        }
        or_run(stage, pos, run);
      } else {  // elements of two rows, or outside the tile
        Run run = 0;
        int pos = 0, nbits = 0, rj = r, dj = d;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (li + j >= 0 && li + j < nel) {
            const uint32_t ow = s_ow[((rj + roff) / BLOCK_SZ) * ndims + dj];
            const int w = (int)(ow & 31u);
            const int bit = bit0 + rj * maxb * 8 + (int)(ow >> 5);
            if (bit != pos + nbits) {  // not contiguous with the run: a new row
              or_run(stage, pos, run);
              run = 0;
              pos = bit;
              nbits = 0;
            }
            run |= (Run)((uint32_t)e[j] & ((1u << w) - 1u)) << nbits;
            nbits += w;
          }
          if (++dj == ndims) {
            dj = 0;
            ++rj;
          }
        }
        or_run(stage, pos, run);
      }
      li += STEP;
      r += qs;
      d += rs;
      if (d >= ndims) {
        d -= ndims;
        ++r;
      }
    }
    base += PACK_LOADS * PACK_THREADS;
    if (base >= c1) break;
#pragma unroll
    for (int u = 0; u < PACK_LOADS; ++u) {
      const int64_t c = base + u * PACK_THREADS;
      if (c < c1) v[u] = __ldg(errs4 + c);
    }
  }
  __syncthreads();

  // 4. The image, out in 16-byte units; the shared end units byte by byte.
  const int64_t q0 = gbase >> 4;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const uint8_t* st8 = reinterpret_cast<const uint8_t*>(stage);
  for (int u = tid; u < units; u += PACK_THREADS) {
    const int64_t a = (q0 + u) << 4;
    if (a >= g0 && a + 16 <= g1) {
      out4[q0 + u] = smem[u];
    } else {
      for (int k = 0; k < 16; ++k) {
        if (a + k >= g0 && a + k < g1) out[a + k] = st8[16 * u + k];
      }
    }
  }
}

template <int ELEM_SZ, bool ROW_LOADS>
int launch_pack(const int32_t* e, const int32_t* w, uint8_t* o, long long nrows,
                int ndims, int tile_rows, cudaStream_t s) {
  const long long smem = pack_smem_bytes(tile_rows, ndims, ELEM_SZ);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err =
        cudaFuncSetAttribute(pack_rows_kernel<ELEM_SZ, ROW_LOADS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned ntiles = (unsigned)((nrows + tile_rows - 1) / tile_rows);
  pack_rows_kernel<ELEM_SZ, ROW_LOADS><<<ntiles, PACK_THREADS, (size_t)smem, s>>>(
      e, w, o, nrows, ndims, tile_rows);
  return (int)cudaGetLastError();
}

template <int ELEM_SZ>
int launch_pack(const int32_t* e, const int32_t* w, uint8_t* o, long long nrows,
                int ndims, int tile_rows, cudaStream_t s) {
  return ndims % 4 == 0
             ? launch_pack<ELEM_SZ, true>(e, w, o, nrows, ndims, tile_rows, s)
             : launch_pack<ELEM_SZ, false>(e, w, o, nrows, ndims, tile_rows, s);
}

constexpr int LOWDIM_THREADS = 256;

template <int ELEM_SZ>
__global__ void __launch_bounds__(LOWDIM_THREADS)
    pack_lowdim_kernel(const int32_t* __restrict__ errs,
                       const int32_t* __restrict__ widths, uint8_t* __restrict__ out,
                       int64_t nitems, int ndims) {
  constexpr int kMaxWidth = 8 * ELEM_SZ;
  const int64_t i = (int64_t)blockIdx.x * LOWDIM_THREADS + threadIdx.x;
  if (i >= nitems) return;
  const int64_t b = i / ndims;
  const int d = (int)(i - b * ndims);
  int w = __ldg(widths + i);
  w = w < 0 ? 0 : (w > kMaxWidth ? kMaxWidth : w);  // memory safety only
  const uint32_t mask = (1u << w) - 1u;
  const int32_t* e = errs + (b * BLOCK_SZ * ndims + d);
  uint32_t v[BLOCK_SZ];
#pragma unroll
  for (int r = 0; r < BLOCK_SZ; ++r) v[r] = (uint32_t)__ldg(e + r * ndims) & mask;
  if constexpr (ELEM_SZ == 1) {  // 8 fields of at most 8 bits: one word
    uint64_t word = 0;
#pragma unroll
    for (int r = 0; r < BLOCK_SZ; ++r) word |= (uint64_t)v[r] << (r * w);
    reinterpret_cast<uint64_t*>(out)[i] = word;
  } else {  // at most 16 bits: a field at p < 64 spills its bits past 64 into hi
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int r = 0; r < BLOCK_SZ; ++r) {
      const int p = r * w;
      if (p < 64) {
        lo |= (uint64_t)v[r] << p;
        if (p) hi |= (uint64_t)v[r] >> (64 - p);
      } else {
        hi |= (uint64_t)v[r] << (p - 64);
      }
    }
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
  }
}

template <int ELEM_SZ>
int launch_pack_lowdim(const int32_t* e, const int32_t* w, uint8_t* o, long long nb,
                       int ndims, cudaStream_t s) {
  const long long nitems = nb * ndims;
  const unsigned ctas = (unsigned)((nitems + LOWDIM_THREADS - 1) / LOWDIM_THREADS);
  pack_lowdim_kernel<ELEM_SZ><<<ctas, LOWDIM_THREADS, 0, s>>>(e, w, o, nitems, ndims);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// errs (nb, 8, ndims) i32 zigzag errors; widths (nb, ndims) i32 legal widths
// -> out (nb, 8, ndims * elem_sz) u8. A CTA packs tile_rows rows: a multiple
// of 8, or a divisor of 8. errs and out are 16-byte aligned.
int sprintz_pack_rows(const void* errs, const void* widths, void* out,
                      long long nb, int ndims, int elem_sz, int tile_rows,
                      void* stream) {
  if (tile_rows <= 0 ||
      (tile_rows >= BLOCK_SZ ? tile_rows % BLOCK_SZ : BLOCK_SZ % tile_rows) ||
      ((uintptr_t)errs | (uintptr_t)out) & 15) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nrows = nb * BLOCK_SZ;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* e = static_cast<const int32_t*>(errs);
  const int32_t* w = static_cast<const int32_t*>(widths);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (elem_sz == 1) return launch_pack<1>(e, w, o, nrows, ndims, tile_rows, s);
  if (elem_sz == 2) return launch_pack<2>(e, w, o, nrows, ndims, tile_rows, s);
  return (int)cudaErrorInvalidValue;
}

// errs (nb, 8, ndims) i32 zigzag errors; widths (nb, ndims) i32 legal lowdim
// widths -> out (nb, ndims, 8 * elem_sz) u8, each (block, dim) section its 8
// fields of w bits back to back, zero past w bytes. out is 16-byte aligned;
// ndims * elem_sz is at most 4 (the lowdim layout).
int sprintz_pack_dims_lowdim(const void* errs, const void* widths, void* out,
                             long long nb, int ndims, int elem_sz, void* stream) {
  if (nb < 1 || ndims < 1 || ndims * elem_sz > 4 || ((uintptr_t)out & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* e = static_cast<const int32_t*>(errs);
  const int32_t* w = static_cast<const int32_t*>(widths);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (elem_sz == 1) return launch_pack_lowdim<1>(e, w, o, nb, ndims, s);
  if (elem_sz == 2) return launch_pack_lowdim<2>(e, w, o, nb, ndims, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
