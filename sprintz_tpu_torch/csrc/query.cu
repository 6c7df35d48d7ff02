// Column reduce for query pushdown on Hopper (sm_90a), bound with ctypes.
//
// reduce_cols_kernel<T, OP, GAPS>
//   Replaces the reduction that the JAX package's query pushdown runs in XLA
//   after its decode: jnp.sum(dtype=int32) / jnp.max / jnp.min down the rows
//   of the decoded values, in the fused pass
//   (sprintz_tpu/query/pushdown.py:_get_fused_run, pushdown.py:76-86) and in
//   the compact delta pass (_get_compact_run, pushdown.py:139-152). The JAX
//   package has no Pallas kernel here.
//   vals (rows, ndims) u8/u16 -> out (ndims,) u32: the per-column sum mod
//   2^32 (the reference's i32 accumulators, query.hpp:283-291, wrap the same
//   way), max or min. With GAPS (the compact delta pass: run rows never
//   materialise), the last row of block b, row 8b + 7, counts
//   1 + gap_after[b] times in the sum: gap_after[b] run rows follow the
//   block, and a delta run repeats the value before it. Max and min ignore
//   the gaps (a run repeats a value they already saw). A leading run (rows
//   of 0 before the first data block) only brings a 0 to min: the entry
//   point then starts min's output at 0.
//   Bound on this card: bytes. It reads each value once (1 or 2 bytes) and
//   writes ndims words, with two or three integer operations a value.
//   Design (simple first): a CTA of THREADS threads covers a tile of CW
//   columns (the power of two at or above ndims, at most 32) and a strip of
//   ITEMS * (THREADS / CW) rows. Thread t owns column t % CW of the tile and
//   rows t / CW + k * (THREADS / CW) of the strip, so a warp reads 32 / CW
//   whole rows of a narrow table (ndims <= 32) or 32 neighbouring columns of
//   one row, and keeps a u32 accumulator. The CTA's row lanes are folded in
//   shared memory (a tree, log2(THREADS / CW) steps), and one thread a
//   column adds the CTA's result to the output with one atomicAdd / atomicMax
//   / atomicMin (unsigned). The output is set on the device first
//   (cudaMemsetAsync: 0 for sum and max, all ones for min, 0 for min after a
//   leading run). Strips run along grid.x, column tiles along grid.y.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 32;  // rows a thread reads in a strip
static_assert(THREADS >= 8 * 32, "row lanes come in multiples of a block's 8 rows");
enum Op { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };

template <int OP>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_MAX) return a > b ? a : b;
  return a < b ? a : b;
}

template <typename T, int OP, bool GAPS>
__global__ void __launch_bounds__(THREADS)
reduce_cols_kernel(const T* __restrict__ vals, const int32_t* __restrict__ gap_after,
                   uint32_t* __restrict__ out, long long rows, int ndims, int log2_cw) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint32_t* red = reinterpret_cast<uint32_t*>(smem_raw);
  const int cw = 1 << log2_cw;
  const int lanes = THREADS >> log2_cw;  // row lanes of the CTA
  const int t = threadIdx.x;
  const int row_lane = t >> log2_cw;
  const int col = blockIdx.y * cw + (t & (cw - 1));
  const long long strip = (long long)ITEMS * lanes;
  const long long r0 = blockIdx.x * strip + row_lane;
  // at least 8 row lanes and strips of whole blocks: all of a thread's rows
  // sit at the same place in their blocks, so the gap test is the thread's
  const bool last_row = GAPS && (row_lane & 7) == 7;
  uint32_t acc = OP == OP_MIN ? 0xffffffffu : 0u;
  if (col < ndims) {
#pragma unroll 8
    for (int k = 0; k < ITEMS; ++k) {
      const long long r = r0 + (long long)k * lanes;
      if (r < rows) {
        uint32_t v = vals[r * ndims + col];
        if (last_row) v *= 1u + (uint32_t)gap_after[r >> 3];
        acc = combine<OP>(acc, v);
      }
    }
  }
  red[t] = acc;
  __syncthreads();
  for (int s = lanes >> 1; s > 0; s >>= 1) {
    if (row_lane < s) red[t] = combine<OP>(red[t], red[t + (s << log2_cw)]);
    __syncthreads();
  }
  if (row_lane == 0 && col < ndims) {
    if (OP == OP_SUM) {
      atomicAdd(out + col, red[t]);
    } else if (OP == OP_MAX) {
      atomicMax(out + col, red[t]);
    } else {
      atomicMin(out + col, red[t]);
    }
  }
}

template <typename T, int OP, bool GAPS>
int launch_reduce(const void* vals, const void* gap_after, uint32_t* out, long long rows,
                  int ndims, int log2_cw, cudaStream_t s) {
  const long long strip = (long long)ITEMS * (THREADS >> log2_cw);
  const dim3 grid((unsigned)((rows + strip - 1) / strip),
                  (unsigned)((ndims + (1 << log2_cw) - 1) >> log2_cw));
  reduce_cols_kernel<T, OP, GAPS><<<grid, THREADS, THREADS * sizeof(uint32_t), s>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(gap_after), out, rows, ndims,
      log2_cw);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* vals, const void* gap_after, uint32_t* out, long long rows, int ndims,
             int op, int log2_cw, cudaStream_t s) {
  if (op == OP_SUM && gap_after) {
    return launch_reduce<T, OP_SUM, true>(vals, gap_after, out, rows, ndims, log2_cw, s);
  }
  if (op == OP_SUM) return launch_reduce<T, OP_SUM, false>(vals, nullptr, out, rows, ndims, log2_cw, s);
  if (op == OP_MAX) return launch_reduce<T, OP_MAX, false>(vals, nullptr, out, rows, ndims, log2_cw, s);
  return launch_reduce<T, OP_MIN, false>(vals, nullptr, out, rows, ndims, log2_cw, s);
}

}  // namespace

extern "C" {

// vals (rows, ndims) u8 (elem_bits 8) or u16 (16) -> out (ndims,) u32: op 0
// the sum mod 2^32, 1 the max, 2 the min down each column. gap_after: null,
// or (rows / 8) i32 run rows after each 8-row block, counted in the sum as
// repeats of the block's last row (rows a multiple of 8). leading_gap: the
// rows start after a run of zeros (min's output starts at 0). Sets the output
// itself; rows >= 1.
int sprintz_reduce_cols(const void* vals, const void* gap_after, void* out, long long rows,
                        int ndims, int elem_bits, int op, int leading_gap, void* stream) {
  if (rows < 1 || ndims < 1 || ndims > 65535 || op < OP_SUM || op > OP_MIN ||
      (elem_bits != 8 && elem_bits != 16) || (gap_after && (op != OP_SUM || rows % 8))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int fill = op == OP_MIN && !leading_gap ? 0xff : 0;
  cudaError_t err = cudaMemsetAsync(o, fill, (size_t)ndims * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  int log2_cw = 0;
  while (log2_cw < 5 && (1 << log2_cw) < ndims) ++log2_cw;
  if (elem_bits == 8) return dispatch<uint8_t>(vals, gap_after, o, rows, ndims, op, log2_cw, s);
  return dispatch<uint16_t>(vals, gap_after, o, rows, ndims, op, log2_cw, s);
}

}  // extern "C"
