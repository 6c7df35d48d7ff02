// Column reduce for query pushdown on Hopper (sm_90a), bound with ctypes.
//
// reduce_cols_kernel<T, OP, GAPS, KIND>
//   Replaces the reduction that the JAX package's query pushdown runs in XLA
//   after its decode: jnp.sum(dtype=int32) / jnp.max / jnp.min down the rows
//   of the decoded values, in the fused pass
//   (sprintz_tpu/query/pushdown.py:_get_fused_run, pushdown.py:76-86) and in
//   the compact delta pass (_get_compact_run, pushdown.py:139-152). The JAX
//   package has no Pallas kernel here. The port's delta queries take the
//   reduce as an epilogue of their decode (csrc/decode.cu, REDUCE); this
//   kernel is FIRE's fused pass and any caller with values on the card.
//   vals (rows, ndims) u8/u16 -> out (ndims,) u32: the per-column sum mod
//   2^32 (the reference's i32 accumulators, query.hpp:283-291, wrap the same
//   way), max or min. With GAPS (the compact delta pass: run rows never
//   materialise), the last row of block b, row 8b + 7, counts
//   1 + gap_after[b] times in the sum: gap_after[b] run rows follow the
//   block, and a delta run repeats the value before it. Max and min ignore
//   the gaps (a run repeats a value they already saw). A leading run (rows
//   of 0 before the first data block) only brings a 0 to min.
//   Bound on this card: bytes. It reads each value once (1 or 2 bytes) and
//   writes ndims words, with two or three integer operations a value.
//   Design: one wave of CTAs (the SMs x the CTAs a SM holds, fewer for a
//   small table), each striding over rows, so the fixed costs (launch, the
//   CTA's fold, its atomics) are paid once a CTA and not once a strip:
//   - loads: a 16-byte vector a thread where a row's bytes are a multiple
//     of 16 (SPLIT: m = row bytes / 16 vectors a row) or divide 16 (PACKED:
//     a vector holds 16 / row bytes whole rows); a value a thread else
//     (SCALAR). A CTA's threads are (row lanes) x (CW vector columns, the
//     power of two at or above the vectors a row, at most 32; column tiles
//     of CW along grid.y), and a thread strides over rows by the grid's row
//     lanes, a multiple of 8: its columns stay fixed, and so does its rows'
//     place in their blocks, so only the threads on a block's last row read
//     gap words, one a block;
//   - a thread loads UNROLL vectors (and their gap words) before it adds
//     any; it keeps a u32 a lane of its vector, folds the lanes of one
//     column (PACKED), then the warp folds its row lanes by shuffles and the
//     8 warps theirs through shared memory (one __syncthreads);
//   - across CTAs, with no memset: kept accumulators (ndims words and a
//     count, zero between launches; one buffer a device and stream, kept by
//     the wrapper). Each CTA adds its partials with one atomic a column; the
//     last CTA to count itself in writes the result and sets the
//     accumulators and the count back to zero. Max and min share one
//     accumulator protocol: min is kept as the max of v ^ mask (mask =
//     2^EB - 1), so 0 is every op's identity (the twin of csrc/decode.cu's
//     reduce epilogue, which uses the same words).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // vectors in flight a thread
enum Op { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };
enum Kind { SCALAR = 0, SPLIT = 1, PACKED = 2 };

template <int OP>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  return OP == OP_SUM ? a + b : (a > b ? a : b);
}

// The CTA's partials are in acc (ndims words, then the count): the last CTA
// of the launch to count itself in writes the result and clears acc. Every
// thread of the CTA calls it; s_flag is a word of shared memory.
__device__ __forceinline__ void publish(uint32_t* acc, uint32_t* out, int ndims, int op,
                                        int leading_gap, uint32_t mask, unsigned* s_flag) {
  __syncthreads();  // the CTA's atomics, then (the barrier and the fence) its count
  const unsigned nctas = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    __threadfence();
    *s_flag = atomicAdd(acc + ndims, 1u) == nctas - 1u;
  }
  __syncthreads();
  if (*s_flag) {
    __threadfence();
    for (int d = threadIdx.x; d < ndims; d += blockDim.x) {
      const uint32_t a = atomicExch(acc + d, 0u);
      out[d] = op == OP_MIN ? (leading_gap ? 0u : a ^ mask) : a;
    }
    if (threadIdx.x == 0) acc[ndims] = 0u;
  }
}

// A table of `nsup` super-rows of `nvec` vectors: rows and their values
// (SCALAR) or 16-byte vectors (SPLIT), or 16-byte units of whole rows
// (PACKED, nvec 1; `tail` bytes in a last, short unit).
struct Table {
  long long nsup;
  int nvec, ndims, log2_cw, log2_d, tail;
};

template <typename T, int OP, bool GAPS, int KIND>
__global__ void __launch_bounds__(THREADS)
reduce_cols_kernel(const T* __restrict__ vals, const int32_t* __restrict__ gap_after,
                   uint32_t* __restrict__ acc, uint32_t* __restrict__ out, Table tb, int op,
                   int leading_gap) {
  constexpr int ES = sizeof(T);
  constexpr int NL = KIND == SCALAR ? 1 : 16 / ES;  // lanes a thread holds
  constexpr uint32_t kMask = (1u << (8 * ES)) - 1u;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem_raw);  // [WARPS][tile columns]
  const uint32_t flip = op == OP_MIN ? kMask : 0u;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int cw = 1 << tb.log2_cw;
  const int lanes = THREADS >> tb.log2_cw;  // row lanes of the CTA, a multiple of 8
  const int vc = blockIdx.y * cw + (t & (cw - 1));
  const long long step = (long long)gridDim.x * lanes;
  const long long r_start = (long long)blockIdx.x * lanes + (t >> tb.log2_cw);
  // PACKED: rows a unit, and the place in its block of the thread's units'
  // last row of a block (the same for every unit of the thread)
  const int rpu = NL >> tb.log2_d;
  const int jl = (int)((7 - r_start * rpu) & 7);
  const bool last = GAPS && KIND != PACKED && (r_start & 7) == 7;
  uint32_t a[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) a[i] = 0u;

  // A super-row's vector and, for a sum with gaps, the gap words of its
  // last rows of a block (PACKED: up to two; else the thread's row's, or 0),
  // loaded together so that the gap words wait no longer than the values
  struct Item {
    uint4 v;
    uint32_t g1, g2;
  };
  auto gap_words = [&](Item& it, long long r, int nrows) {
    it.g1 = it.g2 = 0u;
    if (!GAPS) return;
    if (KIND == PACKED) {
      const long long row0 = r * rpu;
      if (jl < nrows) it.g1 = (uint32_t)gap_after[(row0 + jl) >> 3];
      if (jl + 8 < nrows) it.g2 = (uint32_t)gap_after[(row0 + jl + 8) >> 3];
    } else if (last) {
      it.g1 = (uint32_t)gap_after[r >> 3];
    }
  };
  auto load = [&](long long r) -> Item {
    Item it;
    if (KIND == SCALAR) {
      it.v = make_uint4(vals[r * tb.nvec + vc], 0u, 0u, 0u);
    } else {
      it.v = reinterpret_cast<const uint4*>(vals)[r * tb.nvec + vc];
    }
    gap_words(it, r, rpu);
    return it;
  };
  // The lanes' values of an item (its first nvalid lanes)
  auto take = [&](const Item& it, int nvalid) {
    const uint32_t word[4] = {it.v.x, it.v.y, it.v.z, it.v.w};
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      uint32_t x;
      if (KIND == SCALAR) {
        x = it.v.x;
      } else {
        x = (word[i * ES / 4] >> (8 * ((i * ES) & 3))) & kMask;
      }
      if (KIND == PACKED && i >= nvalid) continue;
      if (OP == OP_SUM) {
        uint32_t w = 1u;
        if (GAPS && KIND == PACKED) {
          const int j = i >> tb.log2_d;
          w += j == jl ? it.g1 : (j == jl + 8 ? it.g2 : 0u);
        } else if (GAPS) {
          w += it.g1;
        }
        a[i] += x * w;
      } else {
        a[i] = combine<OP>(a[i], x ^ flip);
      }
    }
  };

  if (vc < tb.nvec) {
    long long r = r_start;
    for (; r + (UNROLL - 1) * step < tb.nsup; r += UNROLL * step) {
      Item it[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) it[u] = load(r + u * step);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) take(it[u], NL);
    }
    for (; r < tb.nsup; r += step) take(load(r), NL);
    if (KIND == PACKED && tb.tail && r == tb.nsup) {  // the short last unit, a value at a time
      uint32_t word[4] = {0u, 0u, 0u, 0u};
      const uint8_t* src = reinterpret_cast<const uint8_t*>(vals) + 16 * r;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (b < tb.tail) word[b >> 2] |= (uint32_t)src[b] << (8 * (b & 3));
      }
      Item it{make_uint4(word[0], word[1], word[2], word[3]), 0u, 0u};
      gap_words(it, r, (tb.tail / ES) >> tb.log2_d);
      take(it, tb.tail / ES);
    }
  }

  // Fold: a PACKED thread's lanes of one column, then the warp's row lanes
  // by shuffles, then the warps' through shared memory.
  int tcols = cw * NL;  // columns of the tile
  if (KIND == PACKED) {
#pragma unroll
    for (int s = NL / 2; s >= 1; s >>= 1) {
      if (s >= tb.ndims) {
#pragma unroll
        for (int i = 0; i < s; ++i) a[i] = combine<OP>(a[i], a[i + s]);
      }
    }
    tcols = tb.ndims;
  }
  for (int o = 16; o >= cw; o >>= 1) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (KIND != PACKED || i < tcols) a[i] = combine<OP>(a[i], __shfl_xor_sync(0xffffffffu, a[i], o));
    }
  }
  if (lane < cw) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (KIND != PACKED || i < tcols) s_w[warp * tcols + lane * NL + i] = a[i];
    }
  }
  __syncthreads();
  const int col0 = blockIdx.y * cw * NL;  // the tile's first column
  for (int c = t; c < tcols && col0 + c < tb.ndims; c += THREADS) {
    uint32_t v = s_w[c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = combine<OP>(v, s_w[w * tcols + c]);
    if (OP == OP_SUM) {
      atomicAdd(acc + col0 + c, v);
    } else {
      atomicMax(acc + col0 + c, v);
    }
  }
  publish(acc, out, tb.ndims, op, leading_gap, kMask, reinterpret_cast<unsigned*>(s_w));
}

int device_sms() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cache[dev]) cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev];
}

template <typename T, int OP, bool GAPS, int KIND>
int launch_reduce(const void* vals, const void* gap_after, uint32_t* acc, uint32_t* out,
                  const Table& tb, int op, int leading_gap, cudaStream_t s) {
  constexpr int NL = KIND == SCALAR ? 1 : 16 / sizeof(T);
  // the warps' partials: a tile's columns (a PACKED row's ndims <= NL)
  constexpr size_t kMaxSmem = (size_t)WARPS * (KIND == PACKED ? NL : 32 * NL) * sizeof(uint32_t);
  auto kernel = reduce_cols_kernel<T, OP, GAPS, KIND>;
  const int cw = 1 << tb.log2_cw;
  const size_t smem = (size_t)WARPS * (KIND == PACKED ? tb.ndims : cw * NL) * sizeof(uint32_t);
  // resident CTAs a SM at the most shared memory (the same on every card of
  // a host); a smaller tile only leaves more room
  static int per_sm = 0;
  if (!per_sm) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, kMaxSmem);
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * device_sms();
  const unsigned tiles = (unsigned)((tb.nvec + cw - 1) / cw);
  const long long lanes = THREADS / cw;
  long long strips = (tb.nsup + lanes * UNROLL - 1) / (lanes * UNROLL);
  const long long room = wave / tiles > 1 ? wave / tiles : 1;
  if (strips > room) strips = room;
  if (strips < 1) strips = 1;
  kernel<<<dim3((unsigned)strips, tiles), THREADS, smem, s>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(gap_after), acc, out, tb, op,
      leading_gap);
  return (int)cudaGetLastError();
}

template <typename T, int KIND>
int dispatch(const void* vals, const void* gap_after, uint32_t* acc, uint32_t* out,
             const Table& tb, int op, int leading_gap, cudaStream_t s) {
  if (op == OP_SUM && gap_after) {
    return launch_reduce<T, OP_SUM, true, KIND>(vals, gap_after, acc, out, tb, op, leading_gap, s);
  }
  if (op == OP_SUM) {
    return launch_reduce<T, OP_SUM, false, KIND>(vals, nullptr, acc, out, tb, op, leading_gap, s);
  }
  return launch_reduce<T, OP_MAX, false, KIND>(vals, nullptr, acc, out, tb, op, leading_gap, s);
}

template <typename T>
int dispatch(const void* vals, const void* gap_after, uint32_t* acc, uint32_t* out,
             long long rows, int ndims, int op, int leading_gap, cudaStream_t s) {
  const long long rb = (long long)ndims * sizeof(T);  // a row's bytes
  Table tb{rows, ndims, ndims, 0, 0, 0};
  auto pow2_cw = [](long long n) {  // log2 of the power of two at or above n, at most 32
    int l = 0;
    while (l < 5 && (1ll << l) < n) ++l;
    return l;
  };
  if (rb % 16 == 0) {
    tb.nvec = (int)(rb / 16);
    tb.log2_cw = pow2_cw(tb.nvec);
    return dispatch<T, SPLIT>(vals, gap_after, acc, out, tb, op, leading_gap, s);
  }
  if (16 % rb == 0) {
    const long long bytes = rows * rb;
    tb.nsup = bytes / 16;
    tb.tail = (int)(bytes % 16);
    tb.nvec = 1;
    while ((1 << tb.log2_d) < ndims) ++tb.log2_d;
    return dispatch<T, PACKED>(vals, gap_after, acc, out, tb, op, leading_gap, s);
  }
  tb.log2_cw = pow2_cw(ndims);
  return dispatch<T, SCALAR>(vals, gap_after, acc, out, tb, op, leading_gap, s);
}

}  // namespace

extern "C" {

// vals (rows, ndims) u8 (elem_bits 8) or u16 (16), 16-byte aligned -> out
// (ndims,) u32: op 0 the sum mod 2^32, 1 the max, 2 the min down each
// column. gap_after: null, or (rows / 8) i32 run rows after each 8-row
// block, counted in the sum as repeats of the block's last row (rows a
// multiple of 8). leading_gap: the rows start after a run of zeros (min's
// output is then 0). acc: ndims + 1 u32 words, zero on entry and left zero
// (the kept accumulators and their count). Writes the whole output; no
// memset; rows >= 1.
int sprintz_reduce_cols(const void* vals, const void* gap_after, void* out, long long rows,
                        int ndims, int elem_bits, int op, int leading_gap, void* acc,
                        void* stream) {
  if (rows < 1 || ndims < 1 || ndims > 65535 || op < OP_SUM || op > OP_MIN || !acc ||
      (elem_bits != 8 && elem_bits != 16) || (gap_after && (op != OP_SUM || rows % 8)) ||
      (uintptr_t)vals & 15) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* a = static_cast<uint32_t*>(acc);
  if (elem_bits == 8) return dispatch<uint8_t>(vals, gap_after, a, o, rows, ndims, op, leading_gap, s);
  return dispatch<uint16_t>(vals, gap_after, a, o, rows, ndims, op, leading_gap, s);
}

}  // extern "C"
