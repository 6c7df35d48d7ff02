// Delta decode kernels for Hopper (sm_90a), bound with ctypes: the row-major
// layout's and the lowdim layout's.
//
// unpack_zz_kernel<EB, RAW, CONTIG>  (K1, and K4 and K5 as its RAW mode)
//   Replaces sprintz_tpu/ops/pallas_decode.py:_unpack_zz_kernel (unpack_zz)
//   and, in RAW mode, sprintz_tpu/ops/pallas_pack.py:_unpack_kernel
//   (unpack_rows_pallas, K4: <16, true>, i32 fields) and _unpack_mxu_kernel
//   (unpack_rows_pallas_mxu, K5: <8, true>, its bf16 output that is exact
//   for u8 fields, here u8 fields: a quarter of K4's writes). The TPU's
//   block-diagonal MXU dot has no counterpart: the GPU reads the field's
//   bytes at their address. For every (block, row, dim) it reads the field at
//   bit offset `off` (the exclusive prefix of the block's u8 widths) from a
//   3-byte window of the row, bytes at or past maxb read as 0, shifts it by
//   `off & 7` and masks it to `w` bits. A u16 field shifted by up to 7 bits
//   reaches 23 bits, so the window is 3 bytes for every element size.
//   Non-raw mode zigzag-decodes the field and stores `delta + 2^(EB-1)`
//   narrow; it also turns each tile's per-dim sum of the signed deltas into
//   the tile's exclusive offset (below). RAW mode stores the field, as u8 at
//   EB 8 (fields of u8 streams are at most 8 bits wide) and as i32 at EB 16.
//   Bound on this card: bytes. It reads the payload and the u8 widths once
//   and writes one narrow value per field (about 2.1 bytes of traffic per u8
//   value), with about a dozen integer operations per field.
//   Design: a CTA of 256 threads owns a tile of TILE_BLOCKS blocks across
//   all dims. The tile's payload rows and output rows are each one
//   contiguous range of memory:
//   1. the widths and the payload go to shared memory in 16-byte cp.async
//      copies, all in flight at once, in two groups: the widths and the
//      first half of the blocks' rows, then the second half; once the
//      first group has landed, 8 lanes a block scan the block's u8 widths
//      into (offset << 5 | width), each lane a segment of dims;
//   2. each thread takes (block, 4 dims) items (2 dims at EB 16),
//      neighbouring lanes on neighbouring dims: the fields' offset words,
//      then for each of the block's 8 rows one 64-bit window of the row
//      from two aligned shared words, out of which each field is a funnel
//      shift and a mask, written into a shared image of the output rows;
//      the first half's blocks while the second group arrives;
//   3. the image leaves in 16-byte stores, the first half's rows while the
//      second half's fields are extracted; the units at the two ends, which
//      other tiles share, a byte at a time.
//   Rows wider than the tile's shared memory (ndims is a u16, so a row may
//   reach 128 KiB) go in chunks of dims (CONTIG false): each row of the
//   chunk is staged from its block's running bit offset, which the scan
//   carries from chunk to chunk, and stored as a range of its own.
//   Tile offsets (K1): the CTA takes its tile from an atomic ticket, so it
//   only waits on tiles that started before it. For each dim it publishes
//   its total in an (ntiles, ndims) status word of flag and value before it
//   stores its image, then walks back over its predecessors' words,
//   LOOK_BACK words at once, summing totals until it meets an inclusive
//   prefix (a single-pass decoupled look-back), publishes its own
//   inclusive prefix and writes the exclusive one. The C entry point zeroes
//   the status words and the ticket on the launch's stream.
//
// prefix_finish_kernel<EB, CONTIG, CHUNKED, REDUCE>  (K2)
//   Replaces sprintz_tpu/ops/pallas_decode.py:_prefix_finish_kernel
//   (prefix_finish). For each tile of TILE_ROWS rows and each dim: the
//   inclusive prefix of the biased deltas minus bias x rows, plus the tile's
//   exclusive offset, masked to EB bits and narrowed. The TPU computed the
//   prefix as a bf16 lower-triangular matmul; here it is an integer scan.
//   Bound on this card: bytes (one narrow read and one narrow write per
//   value, one add each).
//   Design: a CTA of 256 threads a tile (in chunks of dims for wide rows).
//   The tile goes to shared memory in 16-byte cp.async copies; each thread
//   sums a run of RUN_ROWS rows of one dim (neighbouring lanes on
//   neighbouring dims), the runs' sums are scanned in shared memory, and
//   each thread walks its run again from its prefix, writing the values in
//   place; the image leaves in 16-byte stores as in K1.
//
// decode_lowdim_kernel<EB, ND, RAW, CHUNKED, REDUCE>  (the lowdim layout's delta decode)
//   Replaces the JAX package's fused lowdim delta pass,
//   sprintz_tpu/decoder.py:_decode_lowdim_grouped (decoder.py:265): the
//   unpack (sprintz_tpu/ops/pack.py:unpack_dims_lowdim, pack.py:683, an XLA
//   pass of one-hot einsums or selects), the zigzag decode and the prefix
//   over rows; JAX has no Pallas kernel here. The lowdim layout (u8 ND <= 4,
//   u16 ND <= 2) stores a block column-major: dim d's 8 fields of w bits at
//   bits r * w of its (block, dim) section of EB bytes (dense (nb, ND, EB)
//   u8). Its non-raw mode writes the values, (nb * 8, ND) u8/u16: the
//   running sum of the zigzag-decoded fields down each dim, modulo 2^EB.
//   RAW mode writes the fields, u8 at EB 8 and i32 at EB 16, for the FIRE
//   decode.
//   Bound on this card: bytes. It reads each section and width once and
//   writes one narrow value a field, with about a dozen integer operations
//   a field.
//   Design: a row of these widths is ND * EB <= 32 bits, so the kernel
//   keeps a row's ND values in one 32-bit word and adds rows lane by lane
//   (vadd: a SIMD add of ND lanes of EB bits, carries kept in their lane):
//   the prefix of every dim is one scan of words. A thread owns K whole
//   blocks (K = 4 / (ND * EB / 8), 1 at u8 D 3: 24 or 32 bytes of sections
//   in and as many bytes of values out) and a CTA of LD_THREADS threads a
//   span of LD_THREADS * K blocks:
//   1. the CTA takes its span from an atomic ticket (non-raw), then the
//      span's sections and widths go to shared memory in 16-byte cp.async
//      copies (stage_range);
//   2. each thread extracts its blocks' fields (one or two 64-bit words a
//      section, each field a shift and a mask), zigzag-decodes them into
//      its rows' words and scans its 8K rows in registers;
//   3. the CTA scans its threads' totals (a warp scan of shuffles, then the
//      8 warps' totals); warp 0 publishes the span's total in its status
//      word as soon as it has it, then runs the look-back over the spans
//      before it, 32 status words at once (a lane a word: a ballot finds
//      the nearest inclusive prefix, a warp reduction sums the totals up to
//      it; a span waits only on spans whose tickets came before its own),
//      and publishes its inclusive prefix;
//   4. each thread adds its exclusive prefix to its rows and writes them
//      into a shared image of the span's output, which leaves in 16-byte
//      stores (store_range).
//   The status words need no memset: the last span to finish its look-back
//   (a second atomic counter) zeroes them and both counters, so every
//   launch leaves them as it found them, and the wrapper keeps one zeroed
//   buffer a device and stream. RAW mode takes steps 1, 2 and 4, its span
//   from blockIdx.
//
// The REDUCE instantiations of K2 and the lowdim decode  (query pushdown's
// reduce as an epilogue)
//   Replace the reduce of the JAX package's compact query pass
//   (sprintz_tpu/query/pushdown.py:139-152: jnp.sum(dtype=int32) / max /
//   min over the decoded data blocks, run rows counted through gaps) and of
//   its fused delta pass (pushdown.py:76-86), which a standalone reduce
//   (csrc/query.cu) ran after the decode: here the kernel that finishes the
//   values folds them while they are in registers or shared memory, with
//   no launch of its own. Per launch (runtime arguments, uniform, no more
//   instantiations): the op (sum mod 2^32 / max / min down each dim), the
//   gaps (block b's last row counts 1 + gap_after[b] times in the sum),
//   leading_gap (min is 0 after a leading run of zeros) and store (write the
//   values, or keep them on the chip: the compact pass needs only the
//   (ndims,) result).
//   - K2: each (run, dim) item folds the values it finishes into a sum and a
//     max (of v ^ mask for min) in registers, the tile's 32 gap words staged
//     with its other cp.async copies; the 4 runs of a dim fold in shared
//     memory and the CTA adds its dims' partials to the accumulators with
//     one atomic a dim. Without store the image never leaves shared memory.
//   - the lowdim decode: once the exclusive prefix is added (step 4), each
//     thread folds its rows' lanes (its K gap words read with its
//     sections), a warp by shuffles, the 8 warps through shared memory, and
//     warp 0 adds the span's partials to the accumulators.
//   - across CTAs, with no memset and no launch: kept accumulators (ndims
//     words and, for K2, a count after them; zero between launches, one
//     buffer a device and stream, kept by the wrapper). The last CTA to
//     count itself in (K2: the count after the accumulators; the lowdim
//     decode: its own finishing count) writes the (ndims,) result and sets
//     the accumulators back to zero: min is kept as the max of v ^ mask, so
//     0 is every op's identity (csrc/query.cu's reduce keeps the same words).
//   The serial instantiations (REDUCE false) are the kernels above,
//   unchanged.
//
// The CHUNKED instantiations of K1, K2 and the lowdim decode  (a decode in
// chunks, each from its own state)
//   Replace the delta half of the JAX package's chunk-parallel decode
//   (sprintz_tpu/decoder.py:945-947, vmapped over a sidecar's chunks, or a
//   batch's streams): chunk c's values are state_c + its own prefix, mod
//   2^EB. The chunk starts (C + 1 block indices) and states ((C, D) i32)
//   come in beside the payload, and each tile or span finds its chunk
//   starts by a warp's search of them while its payload lands. The
//   look-backs become segmented ones (see "chunks" below); K2 and the
//   lowdim decode restart their running sums from a chunk's state at its
//   start. The chunked decode costs no launch beyond the serial decode's
//   (it replaced two launches after it: a CTA a chunk that took each
//   chunk's correction, then CTAs that added it). The serial
//   instantiations (CHUNKED false) are the kernels above, unchanged.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SZ = 8;  // rows per block
constexpr int TILE_BLOCKS = 32;
constexpr int TILE_ROWS = TILE_BLOCKS * BLOCK_SZ;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_LANES = THREADS / TILE_BLOCKS;  // K1's lanes a block's widths
constexpr int RUN_ROWS = 64;  // K2: rows of a thread's run
constexpr int RUNS = TILE_ROWS / RUN_ROWS;
constexpr int SMEM_DEFAULT = 48 * 1024;  // above it the kernel must opt in
constexpr int SMEM_BUDGET = 112 * 1024;  // two CTAs a SM at the widest tile
constexpr int READ_SLACK = 8;  // K1 reads two words from a field's byte on
constexpr int LOOK_BACK = 4;   // status words K1's look-back reads at once
constexpr unsigned long long FLAG_TOTAL = 1ull << 32;   // status: a tile's total
constexpr unsigned long long FLAG_PREFIX = 2ull << 32;  // inclusive prefix

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

// Shared memory of a tile, computed on the host. The tile is one chunk of
// dc = ndims dims where it fits SMEM_BUDGET (contig: its rows are staged
// and stored as one range each); else rows are staged and stored one at a
// time, in chunks of dc dims, each row's images in_stride and out_stride
// bytes apart.
struct Plan {
  int dc;
  int contig;
  int window;  // bytes a row's chunk may need from its first field's byte
  int in_stride, out_stride, w_stride;
  int out_off, w_off, aux_off, smem;  // w_off: K1's widths, K2's tile offsets
  int red_off, gap_off;  // K2's REDUCE: the runs' partials, the tile's gap words
};

// The REDUCE epilogue's arguments, uniform across a launch: op (RED_*),
// gap_after (null, or a gap word a block), leading_gap, store (write the
// values), the accumulators (ndims words, then K2's count; zero on entry,
// left zero) and the (ndims,) u32 result.
enum ReduceOp { RED_SUM = 0, RED_MAX = 1, RED_MIN = 2 };
template <bool B>
struct Flag {  // a compile-time flag, for a generic lambda's loop
  static constexpr bool value = B;
};
struct ReduceArgs {
  const int32_t* gap_after;
  uint32_t* acc;
  uint32_t* out;
  int op, leading_gap, store;
};

__host__ __device__ constexpr int round16(long long n) { return (int)((n + 15) / 16 * 16); }

// ---- device helpers (PTX)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's copies but those of its last committed group.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A status word is flag << 32 | value, written and read whole, so no fence
// orders a value against its flag.
__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// ---- end of device helpers

// Copy bytes [g0, g0 + len) of src (16-byte aligned, gtot bytes) into img,
// where img[0] stands for byte g0 & ~15: whole 16-byte units by cp.async
// (the caller waits), a unit that runs past gtot a byte at a time. Thread t
// of nt takes every nt-th unit.
__device__ __forceinline__ void stage_range(uint8_t* img, const uint8_t* src, int64_t g0,
                                            int len, int64_t gtot, int t, int nt) {
  if (len <= 0) return;
  const int64_t a = g0 & ~(int64_t)15;
  const int units = (int)((g0 + len - a + 15) >> 4);
  for (int u = t; u < units; u += nt) {
    const int64_t g = a + 16 * (int64_t)u;
    if (g + 16 <= gtot) {
      cp_async16(img + 16 * u, src + g);
    } else {
      for (int k = 0; k < 16 && g + k < gtot; ++k) img[16 * u + k] = src[g + k];
    }
  }
}

// Store bytes [g0, g0 + len) of dst from img (img[0] stands for byte
// g0 & ~15): whole units in one 16-byte store, the units at the two ends,
// whose other bytes belong to other tiles or chunks, a byte at a time.
__device__ __forceinline__ void store_range(uint8_t* dst, int64_t g0, int len,
                                            const uint8_t* img, int t, int nt) {
  if (len <= 0) return;
  const int64_t a = g0 & ~(int64_t)15;
  const int64_t e = g0 + len;
  const int units = (int)((e - a + 15) >> 4);
  for (int u = t; u < units; u += nt) {
    const int64_t g = a + 16 * (int64_t)u;
    if (g >= g0 && g + 16 <= e) {
      *reinterpret_cast<uint4*>(dst + g) = *reinterpret_cast<const uint4*>(img + 16 * u);
    } else {
      for (int k = 0; k < 16; ++k) {
        if (g + k >= g0 && g + k < e) dst[g + k] = img[16 * u + k];
      }
    }
  }
}

// Tile `tile`'s exclusive offset in dim d: the decoupled look-back over the
// (ntiles, ndims) status words. It reads LOOK_BACK predecessors at once and
// sums back to the nearest inclusive prefix; look_back, once the tile's
// total `agg` is published, also publishes the tile's inclusive prefix.
__device__ __forceinline__ uint32_t look_back_sum(const unsigned long long* status,
                                                  int64_t tile, int ndims, int d) {
  uint32_t excl = 0;
  bool done = false;
  for (int64_t next = tile - 1; !done; next -= LOOK_BACK) {
    unsigned long long v[LOOK_BACK];
#pragma unroll
    for (int i = 0; i < LOOK_BACK; ++i) {  // before tile 0: a prefix of 0
      v[i] = next - i >= 0 ? ld_status(status + (next - i) * ndims + d) : FLAG_PREFIX;
    }
#pragma unroll
    for (int i = 0; i < LOOK_BACK; ++i) {
      if (!done) {
        while (v[i] < FLAG_TOTAL) v[i] = ld_status(status + (next - i) * ndims + d);
        excl += (uint32_t)v[i];
        done = v[i] >= FLAG_PREFIX;
      }
    }
  }
  return excl;
}

__device__ __forceinline__ uint32_t look_back(unsigned long long* status, int64_t tile,
                                              int ndims, int d, uint32_t agg) {
  if (tile == 0) return 0;
  const uint32_t excl = look_back_sum(status, tile, ndims, d);
  st_status(status + tile * ndims + d, FLAG_PREFIX | (excl + agg));
  return excl;
}

// The REDUCE epilogue's last step, by every thread of the CTA once its
// partials are in ra.acc: the last CTA of the launch to count itself in
// (ra.acc[ndims]) writes the result and clears the accumulators and the
// count. s_flag: a word of shared memory. The twin of csrc/query.cu's
// publish.
template <int EB>
__device__ __forceinline__ void reduce_publish(const ReduceArgs& ra, int ndims,
                                               unsigned* s_flag) {
  constexpr uint32_t kMask = (1u << EB) - 1u;
  __syncthreads();  // the CTA's atomics, then (the barrier and the fence) its count
  if (threadIdx.x == 0) {
    __threadfence();
    *s_flag = atomicAdd(ra.acc + ndims, 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  if (*s_flag) {
    __threadfence();
    for (int d = threadIdx.x; d < ndims; d += blockDim.x) {
      const uint32_t a = atomicExch(ra.acc + d, 0u);
      ra.out[d] = ra.op == RED_MIN ? (ra.leading_gap ? 0u : a ^ kMask) : a;
    }
    if (threadIdx.x == 0) ra.acc[ndims] = 0u;
  }
}

// ---- chunks: a decode cut at a sidecar's checkpoints (or a batch's streams)
//
// Chunk c is blocks [first[c], first[c + 1]) and its values are
// state[c] + the prefix of its own deltas: the delta half of the JAX
// package's chunk-parallel decode (sprintz_tpu/decoder.py:945-947, vmapped
// over the chunks). The kernels fold it into their look-back: a tile (K1)
// or span (the lowdim decode) that holds a chunk start publishes an
// inclusive prefix at once, state + its deltas from its last chunk start
// on, and the look-back of the tiles after it stops there (a segmented
// look-back); its rows from a chunk start on take the chunk's state where
// others take the tile's offset. A tile that starts on a chunk start
// needs no look-back at all, which at a sidecar's default (16 groups, 32
// blocks) is every tile. With one chunk from the zero state the values are
// the serial decode's.

// Chunk starts of blocks [b0, b0 + n) in shared memory: mark[k] = c + 1
// where block b0 + k starts chunk c (the last chunk of that start: chunks
// before it are empty), else 0; *last = 1 + the last such k, or 0.
struct ChunkMarks {
  unsigned* mark;
  unsigned* last;
  int* range;  // the chunks that own blocks b0 and b0 + n - 1
};

// #{c < n : first[c] <= x} for a rising `first`: a warp's search, 32
// samples a round (the range shrinks 32-fold); every lane returns it.
__device__ __forceinline__ int count_le(const long long* __restrict__ first, int n, long long x,
                                        int lane) {
  int lo = 0, hi = n;  // first[c] <= x below lo, > x from hi on
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const int k = __popc(__ballot_sync(0xffffffffu, i < hi && first[i] <= x));
    if (k == 0) return lo;
    const int top = lo + k * step;
    lo += (k - 1) * step + 1;
    hi = top < hi ? top : hi;
  }
  const int i = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, i < hi && first[i] <= x));
}

// All threads of the CTA: warp 0 searches `first` for the chunks that own
// the first and last block, then every thread marks the starts of the
// chunks between. Two __syncthreads.
__device__ __forceinline__ void mark_chunks(const long long* __restrict__ first, int nchunks,
                                            long long b0, int n, int cap, ChunkMarks m,
                                            int tid, int nt) {
  for (int k = tid; k < cap; k += nt) m.mark[k] = 0;
  if (tid < 32) {
    const int lo = count_le(first, nchunks, b0, tid) - 1;
    const int hi = count_le(first, nchunks, b0 + n - 1, tid) - 1;
    if (tid == 0) {
      m.range[0] = lo;
      m.range[1] = hi;
      *m.last = 0;
    }
  }
  __syncthreads();
  for (int c = m.range[0] + tid; c <= m.range[1]; c += nt) {
    const long long k = first[c] - b0;  // < n: the last block's chunk starts at or before it
    if (k >= 0) {
      atomicMax(m.mark + k, (unsigned)c + 1u);
      atomicMax(m.last, (unsigned)k + 1u);
    }
  }
  __syncthreads();
}

template <int EB, bool RAW, bool CONTIG, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
    unpack_zz_kernel(const uint8_t* __restrict__ dense, const uint8_t* __restrict__ widths,
                     typename UnpackOut<EB, RAW>::type* __restrict__ out,
                     int32_t* __restrict__ tile_off, unsigned long long* __restrict__ status,
                     int64_t nb, int ndims, int maxb, Plan p,
                     const long long* __restrict__ first, int nchunks,
                     const int32_t* __restrict__ cstate) {
  using OutT = typename UnpackOut<EB, RAW>::type;
  constexpr int OS = sizeof(OutT);
  constexpr uint32_t kBias = 1u << (EB - 1);
  // Fields an item reads from one 64-bit window: a window from the first
  // field's byte holds NV fields of at most EB bits after a shift of up to
  // 7 bits and an alignment of up to 24 bits.
  constexpr int NV = EB == 8 ? 4 : 2;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_in = smem;
  uint8_t* s_out = smem + p.out_off;
  uint8_t* s_w = smem + p.w_off;
  // [TILE_BLOCKS][dc + 1]: a word of padding a block, against bank
  // conflicts of the scan's writes, whose lanes are a segment apart
  const int ow_stride = p.dc + 1;
  uint32_t* s_ow = reinterpret_cast<uint32_t*>(smem + p.aux_off);
  uint32_t* s_tot = s_ow + TILE_BLOCKS * ow_stride;                 // [dc]
  int32_t* s_boff = reinterpret_cast<int32_t*>(s_tot + p.dc);       // [TILE_BLOCKS]
  int32_t* s_tile = s_boff + TILE_BLOCKS;
  // CHUNKED: the tile's chunk starts
  const ChunkMarks cm{reinterpret_cast<unsigned*>(s_tile + 1),
                      reinterpret_cast<unsigned*>(s_tile + 1) + TILE_BLOCKS,
                      reinterpret_cast<int*>(s_tile + 1) + TILE_BLOCKS + 1};
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t ntiles = (nb + TILE_BLOCKS - 1) / TILE_BLOCKS;

  int64_t tile = blockIdx.x;
  if (!RAW) {
    if (tid == 0) {
      *s_tile = (int32_t)atomicAdd(reinterpret_cast<unsigned*>(status + ntiles * ndims), 1u);
    }
    __syncthreads();
    tile = *s_tile;
  }
  const int64_t b0 = tile * TILE_BLOCKS;
  const int nbt = (int)(nb - b0 < TILE_BLOCKS ? nb - b0 : TILE_BLOCKS);
  const int rows = nbt * BLOCK_SZ;
  const int64_t row0 = b0 * BLOCK_SZ;
  const int64_t gtot = nb * BLOCK_SZ * (int64_t)maxb;
  const int in_base = (int)((row0 * maxb) & 15);
  const int64_t wtot = nb * (int64_t)ndims;
  const int64_t out0 = row0 * ndims * OS;  // the tile's first output byte
  const int out_base = (int)(out0 & 15);
  uint8_t* out8 = reinterpret_cast<uint8_t*>(out);
  // the widths' scan: SCAN_LANES lanes a block, each a segment of the dims
  const int sb = tid / SCAN_LANES;
  const int sl = tid % SCAN_LANES;
  const unsigned smask = ((1u << SCAN_LANES) - 1u) << (lane & (32 - SCAN_LANES));
  int carry = 0;  // block sb's bit offset at the chunk's first dim
  if (tid < TILE_BLOCKS) s_boff[tid] = 0;
  __syncthreads();

  for (int d0 = 0; d0 < ndims; d0 += p.dc) {
    const int dc = ndims - d0 < p.dc ? ndims - d0 : p.dc;
    // 1. Into shared memory in two cp.async groups: the widths and the
    // payload of the first half of the blocks, then that of the second,
    // which arrives while the first half's fields are extracted. Then 8
    // lanes a block scan the block's widths into offsets.
    auto stage_rows = [&](int r_lo, int r_hi) {
      if constexpr (CONTIG) {  // the second group from the unit after the first's last
        const int64_t e = (row0 + r_hi) * maxb;
        const int64_t g = r_lo ? ((row0 + r_lo) * maxb + 15) & ~(int64_t)15 : row0 * maxb;
        stage_range(s_in + (int)((g & ~(int64_t)15) - ((row0 * maxb) & ~(int64_t)15)), dense,
                    g, (int)(e - g), gtot, tid, THREADS);
      } else {
        for (int r = r_lo + warp; r < r_hi; r += WARPS) {
          const int q0 = s_boff[r / BLOCK_SZ] >> 3;
          const int len = maxb - q0 < p.window ? maxb - q0 : p.window;
          stage_range(s_in + r * p.in_stride, dense, (row0 + r) * maxb + q0, len, gtot, lane,
                      32);
        }
      }
    };
    if constexpr (CONTIG) {
      stage_range(s_w, widths, b0 * ndims, nbt * ndims, wtot, tid, THREADS);
    } else {
      for (int b = warp; b < nbt; b += WARPS) {
        stage_range(s_w + b * p.w_stride, widths, (b0 + b) * ndims + d0, dc, wtot, lane, 32);
      }
    }
    const int half = (nbt + 1) / 2;  // blocks of the first group
    stage_rows(0, half * BLOCK_SZ);
    cp_async_commit();
    stage_rows(half * BLOCK_SZ, rows);
    cp_async_commit();
    if (!RAW) {
      for (int j = tid; j < dc; j += THREADS) s_tot[j] = 0;
    }
    if (CHUNKED && d0 == 0) mark_chunks(first, nchunks, b0, nbt, TILE_BLOCKS, cm, tid, THREADS);
    // CHUNKED: the tile's total counts its blocks from its last chunk start
    const int from = CHUNKED ? (int)*cm.last - 1 : -1;
    cp_async_wait_prior();
    __syncthreads();
    if (sb < nbt) {  // uniform in the block's 8 lanes
      const uint8_t* wb = CONTIG ? s_w + (int)((b0 * ndims) & 15) + sb * ndims
                                 : s_w + sb * p.w_stride + (int)(((b0 + sb) * ndims + d0) & 15);
      const int seg = (dc + SCAN_LANES - 1) / SCAN_LANES;
      const int j0 = sl * seg;
      const int j1 = j0 + seg < dc ? j0 + seg : dc;
      int sum = 0;
      for (int j = j0; j < j1; ++j) sum += wb[j] < EB ? wb[j] : EB;  // widths are <= EB
      int incl = sum;
#pragma unroll
      for (int o = 1; o < SCAN_LANES; o <<= 1) {
        const int t = __shfl_up_sync(smask, incl, o, SCAN_LANES);
        if (sl >= o) incl += t;
      }
      int off = carry + incl - sum;
      for (int j = j0; j < j1; ++j) {
        const int w = wb[j] < EB ? wb[j] : EB;
        s_ow[sb * ow_stride + j] = ((uint32_t)off << 5) | (uint32_t)w;
        off += w;
      }
      carry += __shfl_sync(smask, incl, SCAN_LANES - 1, SCAN_LANES);
    }
    __syncthreads();

    // 2. (block, NV dims) items: the NV fields of each of the block's 8
    // rows, from one 64-bit window of the row; the blocks of the first
    // group, then, once they have arrived, those of the second.
    const int nq = (dc + NV - 1) / NV;
    const int bstep = THREADS / nq;
    const int qstep = THREADS - bstep * nq;
    auto extract = [&](int b_lo, int b_hi) {
      int b = b_lo + tid / nq;
      int jq = tid % nq;
      for (int it = b_lo * nq + tid; it < b_hi * nq; it += THREADS) {
        const int j = jq * NV;
        const uint32_t* ow = s_ow + b * ow_stride + j;
        int q = (int)(ow[0] >> 8);  // the window's first byte: the first field's
        uint32_t rel[NV], mask[NV];  // each field's bit in the window, and its bits
  #pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int off = j + k < dc ? (int)(ow[k] >> 5) : 8 * q;
          const int lim = maxb - (off >> 3);  // bytes of its 3-byte window in the row
          const uint32_t keep = lim >= 3 ? 0xFFFFFFu : lim <= 0 ? 0u : (1u << (8 * lim)) - 1u;
          rel[k] = (uint32_t)(off - 8 * q);
          mask[k] = j + k < dc ? ((1u << (ow[k] & 31u)) - 1u) & (keep >> (off & 7)) : 0u;
        }
        int in_pos, in_step, out_pos, out_step;
        if constexpr (CONTIG) {
          if (q >= maxb) q = 0;  // fields past the row read a byte of it, masked
          in_pos = in_base + b * BLOCK_SZ * maxb + q;
          in_step = maxb;
          out_pos = out_base + (b * BLOCK_SZ * ndims + j) * OS;
          out_step = ndims * OS;
        } else {  // s_boff holds the block's bit offset at the chunk's first dim
          const int q0 = s_boff[b] >> 3;
          if (q >= maxb) q = q0;
          in_pos = b * BLOCK_SZ * p.in_stride + q - q0;
          in_step = p.in_stride;
          out_pos = b * BLOCK_SZ * p.out_stride + j * OS;
          out_step = p.out_stride;
        }
        uint32_t sum[NV] = {};
  #pragma unroll
        for (int r8 = 0; r8 < BLOCK_SZ; ++r8) {
          const int r = b * BLOCK_SZ + r8;
          int pos = in_pos + r8 * in_step;
          int opos = out_pos + r8 * out_step;
          if constexpr (!CONTIG) {  // each row's image starts at its first byte's place in a unit
            pos += (int)((in_base + (int64_t)r * maxb + (s_boff[b] >> 3)) & 15);
            opos += (int)((out_base + ((int64_t)r * ndims + d0) * OS) & 15);
          }
          const uint32_t* w4 = reinterpret_cast<const uint32_t*>(s_in + (pos & ~3));
          const uint32_t a = 8 * (pos & 3);
          const uint32_t lo = __funnelshift_r(w4[0], w4[1], a);
          const uint32_t hi = w4[1] >> a;
  #pragma unroll
          for (int k = 0; k < NV; ++k) {
            const uint32_t u = __funnelshift_r(lo, hi, rel[k]) & mask[k];
            OutT* o = reinterpret_cast<OutT*>(s_out + opos) + k;
            if constexpr (RAW) {
              if (j + k < dc) *o = (OutT)u;
            } else {
              const uint32_t delta = (u >> 1) ^ (0u - (u & 1u));
              if (j + k < dc) *o = (OutT)(delta + kBias);
              sum[k] += delta;
            }
          }
        }
        if (!RAW) {
  #pragma unroll
          for (int k = 0; k < NV; ++k) {
            if (j + k < dc && (!CHUNKED || b >= from)) atomicAdd(s_tot + j + k, sum[k]);
          }
        }
        b += bstep;
        jq += qstep;
        if (jq >= nq) {
          jq -= nq;
          ++b;
        }
      }
    };
    // 3. The image out, a group's rows at a time; the tile's totals
    // published; the tile's offsets; the blocks' offsets carried on.
    auto store_rows = [&](int r_lo, int r_hi) {
      if constexpr (CONTIG) {
        const int64_t g = out0 + (int64_t)r_lo * ndims * OS;
        store_range(out8, g, (r_hi - r_lo) * ndims * OS,
                    s_out + (int)((g & ~(int64_t)15) - (out0 & ~(int64_t)15)), tid, THREADS);
      } else {
        for (int r = r_lo + warp; r < r_hi; r += WARPS) {
          store_range(out8, ((row0 + r) * ndims + d0) * OS, dc * OS, s_out + r * p.out_stride,
                      lane, 32);
        }
      }
    };
    extract(0, half);
    cp_async_wait_all();
    __syncthreads();
    store_rows(0, half * BLOCK_SZ);
    extract(half, nbt);
    __syncthreads();
    if (!RAW && !CHUNKED) {
      for (int jj = tid; jj < dc; jj += THREADS) {  // the first tile's total is its prefix
        st_status(status + tile * ndims + d0 + jj,
                  (tile == 0 ? FLAG_PREFIX : FLAG_TOTAL) | s_tot[jj]);
      }
    }
    if (CHUNKED) {  // a tile with a chunk start: state + its deltas from there, a prefix
      const unsigned owner = from >= 0 ? cm.mark[from] : 0u;
      for (int jj = tid; jj < dc; jj += THREADS) {
        st_status(status + tile * ndims + d0 + jj,
                  owner ? FLAG_PREFIX | (uint32_t)(cstate[(owner - 1) * (int64_t)ndims + d0 + jj] +
                                                   (int32_t)s_tot[jj])
                        : FLAG_TOTAL | s_tot[jj]);
      }
    }
    store_rows(half * BLOCK_SZ, rows);
    if (!RAW && !CHUNKED) {
      for (int jj = tid; jj < dc; jj += THREADS) {
        tile_off[tile * ndims + d0 + jj] =
            (int32_t)look_back(status, tile, ndims, d0 + jj, s_tot[jj]);
      }
    }
    if (CHUNKED) {  // the offset entering the tile: its chunk's state where it starts one
      const unsigned head = cm.mark[0];
      for (int jj = tid; jj < dc; jj += THREADS) {
        const int d = d0 + jj;
        if (head) {
          tile_off[tile * ndims + d] = cstate[(head - 1) * (int64_t)ndims + d];
        } else {
          const uint32_t excl = look_back_sum(status, tile, ndims, d);
          if (from < 0) st_status(status + tile * ndims + d, FLAG_PREFIX | (excl + s_tot[jj]));
          tile_off[tile * ndims + d] = (int32_t)excl;
        }
      }
    }
    if (sl == 0 && sb < nbt) s_boff[sb] = carry;
    __syncthreads();
  }
}

template <int EB, bool CONTIG, bool CHUNKED, bool REDUCE>
__global__ void __launch_bounds__(THREADS)
    prefix_finish_kernel(const typename Narrow<EB>::type* __restrict__ bz,
                         const int32_t* __restrict__ tile_off,
                         typename Narrow<EB>::type* __restrict__ out, int64_t nrows,
                         int ndims, Plan p, const long long* __restrict__ first, int nchunks,
                         const int32_t* __restrict__ cstate, ReduceArgs ra) {
  using T = typename Narrow<EB>::type;
  constexpr int ES = sizeof(T);
  constexpr uint32_t kBias = 1u << (EB - 1);
  constexpr uint32_t kMask = (1u << EB) - 1u;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_run = reinterpret_cast<uint32_t*>(smem + p.aux_off);  // [RUNS][dc]
  // CHUNKED: the tile's chunk starts, and each run's last one (its mark)
  unsigned* s_runs_last = s_run + RUNS * p.dc;
  const ChunkMarks cm{s_runs_last + RUNS, s_runs_last + RUNS + TILE_BLOCKS,
                      reinterpret_cast<int*>(s_runs_last + RUNS + TILE_BLOCKS + 1)};
  // REDUCE: the (run, dim) items' partials [RUNS][dc], the tile's gap words
  uint32_t* s_red = reinterpret_cast<uint32_t*>(smem + p.red_off);
  const uint32_t* s_gap = reinterpret_cast<const uint32_t*>(smem + p.gap_off);
  const int64_t ntiles = (nrows + TILE_ROWS - 1) / TILE_ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t row0 = tile * TILE_ROWS;
  const int rows = (int)(nrows - row0 < TILE_ROWS ? nrows - row0 : TILE_ROWS);
  const int64_t g0 = row0 * ndims * ES;  // the tile's first byte
  const int base = (int)(g0 & 15);
  const uint8_t* src = reinterpret_cast<const uint8_t*>(bz);
  uint8_t* dst = reinterpret_cast<uint8_t*>(out);

  for (int d0 = 0; d0 < ndims; d0 += p.dc) {
    const int dc = ndims - d0 < p.dc ? ndims - d0 : p.dc;
    if constexpr (CONTIG) {
      stage_range(smem, src, g0, rows * ndims * ES, nrows * ndims * ES, tid, THREADS);
    } else {
      for (int r = warp; r < rows; r += WARPS) {
        stage_range(smem + r * p.in_stride, src, ((row0 + r) * ndims + d0) * ES, dc * ES,
                    nrows * ndims * ES, lane, 32);
      }
    }
    const int64_t to0 = (tile * ndims + d0) * 4;  // the chunk's tile offsets
    stage_range(smem + p.w_off, reinterpret_cast<const uint8_t*>(tile_off), to0, dc * 4,
                ntiles * ndims * 4, tid, THREADS);
    const uint32_t* s_toff = reinterpret_cast<const uint32_t*>(smem + p.w_off + (to0 & 15));
    if (REDUCE && ra.gap_after && d0 == 0) {  // the tile's blocks' gap words (rows are whole blocks)
      stage_range(smem + p.gap_off, reinterpret_cast<const uint8_t*>(ra.gap_after),
                  tile * TILE_BLOCKS * 4, rows / BLOCK_SZ * 4, nrows / BLOCK_SZ * 4, tid,
                  THREADS);
    }
    if (CHUNKED && d0 == 0) {
      mark_chunks(first, nchunks, row0 / BLOCK_SZ, (rows + BLOCK_SZ - 1) / BLOCK_SZ,
                  TILE_BLOCKS, cm, tid, THREADS);
      if (tid < RUNS) {
        unsigned last = 0;
        for (int b = tid * (RUN_ROWS / BLOCK_SZ); b < (tid + 1) * (RUN_ROWS / BLOCK_SZ); ++b) {
          if (cm.mark[b]) last = cm.mark[b];
        }
        s_runs_last[tid] = last;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // (run, dim) items; the value of row r, dim j of the chunk at elem(r, j)
    auto elem = [&](int r, int j) -> T* {
      const int pos = CONTIG
                          ? base + (r * ndims + j) * ES
                          : r * p.in_stride + (int)((base + ((int64_t)r * ndims + d0) * ES) & 15) +
                                j * ES;
      return reinterpret_cast<T*>(smem + pos);
    };
    // a chunk's state in dim j of the chunk of dims
    auto state = [&](unsigned mark, int j) -> uint32_t {
      return (uint32_t)cstate[(mark - 1) * (int64_t)ndims + d0 + j];
    };
    for (int it = tid; it < RUNS * dc; it += THREADS) {
      const int k = it / dc;
      const int j = it - k * dc;
      const int r1 = (k + 1) * RUN_ROWS < rows ? (k + 1) * RUN_ROWS : rows;
      uint32_t sum = 0;
      if constexpr (CHUNKED) {  // the run's sum from its last chunk start on
        for (int r0 = k * RUN_ROWS; r0 < r1; r0 += BLOCK_SZ) {
          if (cm.mark[r0 / BLOCK_SZ]) sum = 0;
#pragma unroll
          for (int r = r0; r < r0 + BLOCK_SZ; ++r) sum += (uint32_t)*elem(r, j) - kBias;
        }
      } else {
#pragma unroll 8
        for (int r = k * RUN_ROWS; r < r1; ++r) sum += (uint32_t)*elem(r, j) - kBias;
      }
      s_run[k * p.dc + j] = sum;
    }
    __syncthreads();
    for (int it = tid; it < RUNS * dc; it += THREADS) {
      const int k = it / dc;
      const int j = it - k * dc;
      const int r1 = (k + 1) * RUN_ROWS < rows ? (k + 1) * RUN_ROWS : rows;
      uint32_t acc = s_toff[j];
      if constexpr (CHUNKED) {  // a run with a chunk start restarts the sum from its state
        for (int kk = 0; kk < k; ++kk) {
          const unsigned last = s_runs_last[kk];
          acc = (last ? state(last, j) : acc) + s_run[kk * p.dc + j];
        }
        for (int r0 = k * RUN_ROWS; r0 < r1; r0 += BLOCK_SZ) {
          const unsigned mark = cm.mark[r0 / BLOCK_SZ];
          if (mark) acc = state(mark, j);
#pragma unroll
          for (int r = r0; r < r0 + BLOCK_SZ; ++r) {
            T* v = elem(r, j);
            acc += (uint32_t)*v - kBias;
            *v = (T)(acc & kMask);
          }
        }
      } else if constexpr (REDUCE) {  // the values folded as they are finished
        for (int kk = 0; kk < k; ++kk) acc += s_run[kk * p.dc + j];
        // a loop for each op and store flag (uniform across the launch):
        // the sum weighs a block's last row by 1 + its gap, max and min
        // take the max of x ^ flip
        auto run = [&](auto sum, auto store) {
          constexpr bool kSum = decltype(sum)::value, kStore = decltype(store)::value;
          const uint32_t flip = ra.op == RED_MIN ? kMask : 0u;
          uint32_t red = 0;
          auto step = [&](int r, uint32_t w) {
            T* v = elem(r, j);
            acc += (uint32_t)*v - kBias;
            const uint32_t x = acc & kMask;
            if constexpr (kStore) *v = (T)x;
            if constexpr (kSum) {
              red += x * w;
            } else {
              red = red > (x ^ flip) ? red : x ^ flip;
            }
          };
          int r0 = k * RUN_ROWS;
          for (; r0 + BLOCK_SZ <= r1; r0 += BLOCK_SZ) {
            const uint32_t w7 = kSum && ra.gap_after ? 1u + s_gap[r0 / BLOCK_SZ] : 1u;
#pragma unroll
            for (int r8 = 0; r8 < BLOCK_SZ; ++r8) step(r0 + r8, r8 == BLOCK_SZ - 1 ? w7 : 1u);
          }
          for (int r = r0; r < r1; ++r) step(r, 1u);  // a short last block: no gaps then
          return red;
        };
        const bool sum = ra.op == RED_SUM;
        s_red[k * p.dc + j] =
            ra.store ? (sum ? run(Flag<true>{}, Flag<true>{}) : run(Flag<false>{}, Flag<true>{}))
                     : (sum ? run(Flag<true>{}, Flag<false>{}) : run(Flag<false>{}, Flag<false>{}));
      } else {
        for (int kk = 0; kk < k; ++kk) acc += s_run[kk * p.dc + j];
#pragma unroll 8
        for (int r = k * RUN_ROWS; r < r1; ++r) {
          T* v = elem(r, j);
          acc += (uint32_t)*v - kBias;
          *v = (T)(acc & kMask);
        }
      }
    }
    __syncthreads();
    if constexpr (REDUCE) {  // the tile's partial of each dim, into the accumulators
      for (int j = tid; j < dc; j += THREADS) {
        uint32_t v = s_red[j];
#pragma unroll
        for (int k = 1; k < RUNS; ++k) {
          const uint32_t y = s_red[k * p.dc + j];
          v = ra.op == RED_SUM ? v + y : (v > y ? v : y);
        }
        if (ra.op == RED_SUM) {
          atomicAdd(ra.acc + d0 + j, v);
        } else {
          atomicMax(ra.acc + d0 + j, v);
        }
      }
    }
    if (!REDUCE || ra.store) {
      if constexpr (CONTIG) {
        store_range(dst, g0, rows * ndims * ES, smem, tid, THREADS);
      } else {
        for (int r = warp; r < rows; r += WARPS) {
          store_range(dst, ((row0 + r) * ndims + d0) * ES, dc * ES, smem + r * p.in_stride,
                      lane, 32);
        }
      }
    }
    __syncthreads();
  }
  if constexpr (REDUCE) reduce_publish<EB>(ra, ndims, s_red);
}

// ---- the lowdim layout: u8 ND <= 4, u16 ND <= 2, so a row is ND * EB <= 32 bits

constexpr int LD_THREADS = 256;
constexpr int LD_WARPS = LD_THREADS / 32;
constexpr int LD_LOOK_BACK = 4;  // status words a lane of the look-back reads at once

// A thread's share of a span: K whole blocks, 8K rows of RB bytes, CW 8-byte
// words of sections (and as many of values); a span is LD_THREADS threads'.
template <int ES, int ND>
struct LowdimShape {
  static constexpr int RB = ND * ES;
  static constexpr int K = RB == 3 ? 1 : 4 / RB;
  static constexpr int NR = BLOCK_SZ * K;
  static constexpr int CW = K * RB;
  static constexpr int SPAN = LD_THREADS * K;
};

// Lane-wise sum of two rows of 8- or 16-bit lanes: the lanes' top bits are
// added apart, so that no carry leaves its lane.
template <int EB>
__device__ __forceinline__ uint32_t vadd(uint32_t a, uint32_t b) {
  constexpr uint32_t H = EB == 8 ? 0x80808080u : 0x80008000u;
  return ((a & ~H) + (b & ~H)) ^ ((a ^ b) & H);
}

// The rows' words a thread leaves in order: NR rows of RB bytes, packed
// into NR * RB / 8 words of 8 bytes.
template <int RB, int NR>
__device__ __forceinline__ void put_rows(uint64_t* dst, const uint32_t (&row)[NR]) {
  uint64_t acc = 0;
  int nbits = 0, wi = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const uint64_t v = row[r] & (uint32_t)((1ull << (8 * RB)) - 1);
    acc |= v << nbits;
    nbits += 8 * RB;
    if (nbits >= 64) {
      dst[wi++] = acc;
      nbits -= 64;
      acc = nbits ? v >> (8 * RB - nbits) : 0;
    }
  }
}

// The exclusive prefix of span `span` from the status words of the spans
// before it, 32 * LD_LOOK_BACK words a round (lane l reads span - 1 - l,
// then 32 words further back, ...), nearest first, until one holds an
// inclusive prefix. When every span starts at once, a span's rounds meet
// the prefixes spreading from span 0 after about span / (64 * LD_LOOK_BACK)
// rounds. Every lane returns it.
template <int EB>
__device__ __forceinline__ uint32_t lowdim_look_back(unsigned long long* status, int64_t span,
                                                     int lane) {
  uint32_t excl = 0;
  for (int64_t next = span - 1;; next -= 32 * LD_LOOK_BACK) {
    unsigned long long v[LD_LOOK_BACK];
#pragma unroll
    for (int j = 0; j < LD_LOOK_BACK; ++j) {  // before span 0: a prefix of 0
      const int64_t i = next - 32 * j - lane;
      v[j] = i >= 0 ? ld_status(status + i) : FLAG_PREFIX;
    }
#pragma unroll
    for (int j = 0; j < LD_LOOK_BACK; ++j) {
      while (__any_sync(0xffffffffu, v[j] < FLAG_TOTAL)) {
        if (v[j] < FLAG_TOTAL) v[j] = ld_status(status + next - 32 * j - lane);
      }
      const unsigned pre = __ballot_sync(0xffffffffu, v[j] >= FLAG_PREFIX);
      const int stop = pre ? __ffs((int)pre) - 1 : 31;  // the nearest prefix's lane
      uint32_t x = lane <= stop ? (uint32_t)v[j] : 0u;
#pragma unroll
      for (int o = 16; o; o >>= 1) x = vadd<EB>(x, __shfl_xor_sync(0xffffffffu, x, o));
      excl = vadd<EB>(excl, x);
      if (pre) return excl;
    }
  }
}

// Shared memory of the lowdim decode: the span's sections and widths, its
// output image, the warps' totals, the span's exclusive prefix and its
// ticket. A thread's part of the image is kOutWords 8-byte words (3, 4 or
// 8), kept kPadWords apart, an odd number, so that the 8-byte stores of a
// half-warp's threads fall in 16 different banks.
// CHUNKED: also the span's chunk starts (ChunkMarks) and each warp's flag;
// REDUCE: each warp's partials.
template <int EB, int ND, bool RAW, bool CHUNKED, bool REDUCE = false>
struct DecodeLowdimSmem {
  using S = LowdimShape<EB / 8, ND>;
  static constexpr int kOutWords = RAW && EB == 16 ? S::NR * ND / 2 : S::CW;
  static constexpr int kPadWords = kOutWords | 1;
  static constexpr int kIn = 0;
  static constexpr int kWidths = kIn + 8 * S::CW * LD_THREADS;
  static constexpr int kImage = kWidths + round16(S::SPAN * ND);
  static constexpr int kWarp = kImage + 8 * kPadWords * LD_THREADS;
  static constexpr int kMarks = kWarp + 4 * LD_WARPS + 16;
  static constexpr int kBytes =
      kMarks + (CHUNKED ? 4 * (S::SPAN + 3 + LD_WARPS) : 0) + (REDUCE ? 4 * LD_WARPS * ND : 0);
};

// The segmented scan's step: (flag, value) of rows a, then of rows b after
// them. A flag says that the value is absolute (it holds a chunk's state);
// else it is a sum to add to what comes before.
template <int EB>
__device__ __forceinline__ void seg_add(uint32_t& fa, uint32_t& va, uint32_t fb, uint32_t vb) {
  va = fb ? vb : vadd<EB>(va, vb);
  fa |= fb;
}

template <int EB, int ND, bool RAW, bool CHUNKED, bool REDUCE>
__global__ void __launch_bounds__(LD_THREADS)
    decode_lowdim_kernel(const uint8_t* __restrict__ dense, const uint8_t* __restrict__ widths,
                         uint8_t* __restrict__ out, unsigned long long* __restrict__ status,
                         int64_t nb, const long long* __restrict__ first, int nchunks,
                         const int32_t* __restrict__ cstate, ReduceArgs ra) {
  using S = LowdimShape<EB / 8, ND>;
  using L = DecodeLowdimSmem<EB, ND, RAW, CHUNKED, REDUCE>;
  constexpr int K = S::K, NR = S::NR, SPAN = S::SPAN;
  constexpr uint32_t kMask = (1u << EB) - 1u;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint64_t* s_in = reinterpret_cast<const uint64_t*>(smem + L::kIn);
  uint8_t* s_w = smem + L::kWidths;
  uint8_t* s_img = smem + L::kImage;
  uint32_t* s_warp = reinterpret_cast<uint32_t*>(smem + L::kWarp);  // [LD_WARPS]
  uint32_t* s_excl = s_warp + LD_WARPS;
  int32_t* s_ticket = reinterpret_cast<int32_t*>(s_excl + 1);
  // status[0]: the ticket and finish counters; status[1 + s]: span s's word
  unsigned* counters = reinterpret_cast<unsigned*>(status);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t nspans = (nb + SPAN - 1) / SPAN;

  // 1. The span, then its sections and widths (both from a 16-byte boundary:
  // b0 is a multiple of SPAN) into shared memory.
  int64_t span = blockIdx.x;
  if (!RAW) {
    if (tid == 0) *s_ticket = (int32_t)atomicAdd(counters, 1u);
    __syncthreads();
    span = *s_ticket;
  }
  const int64_t b0 = span * SPAN;
  const int nbs = (int)(nb - b0 < SPAN ? nb - b0 : SPAN);
  stage_range(smem + L::kIn, dense, b0 * ND * EB, nbs * ND * EB, nb * ND * EB, tid, LD_THREADS);
  stage_range(s_w, widths, b0 * ND, nbs * ND, nb * ND, tid, LD_THREADS);
  // CHUNKED: the span's chunk starts, while the copies land
  unsigned* s_marks = reinterpret_cast<unsigned*>(smem + L::kMarks);
  unsigned* s_wflag = s_marks + SPAN + 3;  // [LD_WARPS]
  const ChunkMarks cm{s_marks, s_marks + SPAN, reinterpret_cast<int*>(s_marks + SPAN + 1)};
  if (CHUNKED) mark_chunks(first, nchunks, b0, nbs, SPAN, cm, tid, LD_THREADS);
  // REDUCE: the weight of each of the thread's blocks' last row in a sum
  // (1 + its gap word), read while the copies land
  uint32_t gw[REDUCE ? K : 1];
#pragma unroll
  for (int k = 0; k < (REDUCE ? K : 1); ++k) {
    gw[k] = 1u;
    if (REDUCE && ra.gap_after && tid * K + k < nbs) gw[k] += (uint32_t)ra.gap_after[b0 + tid * K + k];
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. The thread's K blocks: fields -> zigzag-decoded deltas in the lanes
  // of their rows' words (raw: the fields; at EB 16 i32 fields, in f32);
  // blocks past nb are zeros.
  uint64_t* img = reinterpret_cast<uint64_t*>(s_img) + tid * L::kPadWords;
  uint32_t row[NR];
  uint32_t f32[RAW && EB == 16 ? NR * ND : 1];
#pragma unroll
  for (int r = 0; r < NR; ++r) row[r] = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int blk = tid * K + k;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int it = blk * ND + d;
      const int w0 = blk < nbs ? s_w[it] : 0;
      const int w = w0 < EB ? w0 : EB;  // widths are <= EB
      const uint32_t mask = (1u << w) - 1u;
      uint32_t u[BLOCK_SZ];
      if constexpr (EB == 8) {
        const uint64_t x = blk < nbs ? s_in[it] : 0;
#pragma unroll
        for (int r = 0; r < BLOCK_SZ; ++r) u[r] = (uint32_t)(x >> (r * w)) & mask;
      } else {  // a field at p < 64 may take its high bits from the second word
        const uint64_t lo = blk < nbs ? s_in[2 * it] : 0;
        const uint64_t hi = blk < nbs ? s_in[2 * it + 1] : 0;
#pragma unroll
        for (int r = 0; r < BLOCK_SZ; ++r) {
          const int p = r * w;
          const uint64_t x = p < 64 ? (lo >> p) | (p ? hi << (64 - p) : 0) : hi >> (p - 64);
          u[r] = (uint32_t)x & mask;
        }
      }
#pragma unroll
      for (int r = 0; r < BLOCK_SZ; ++r) {
        if constexpr (RAW && EB == 16) {
          f32[(k * BLOCK_SZ + r) * ND + d] = u[r];
        } else {
          const uint32_t v = RAW ? u[r] : ((u[r] >> 1) ^ (0u - (u[r] & 1u))) & kMask;
          row[k * BLOCK_SZ + r] |= v << (d * EB);
        }
      }
    }
  }

  if constexpr (!RAW && CHUNKED) {
    // 2b. The rows' running sum in registers, from a chunk's state (its
    // lanes packed as a row is) at each chunk start: rows from the first
    // start on (fs) are values, those before it sums to add to the prefix.
    int fs = NR;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned mark = s_marks[tid * K + k];  // 0 past the span's blocks
      uint32_t st = 0;
      if (mark) {
#pragma unroll
        for (int d = 0; d < ND; ++d)
          st |= ((uint32_t)cstate[(mark - 1) * (int64_t)ND + d] & kMask) << (d * EB);
        if (fs == NR) fs = k * BLOCK_SZ;
      }
#pragma unroll
      for (int r = k * BLOCK_SZ; r < (k + 1) * BLOCK_SZ; ++r) {
        if (r == k * BLOCK_SZ && mark) {
          row[r] = vadd<EB>(st, row[r]);
        } else if (r > 0) {
          row[r] = vadd<EB>(row[r - 1], row[r]);
        }
      }
    }
    // 3. The CTA's segmented scan of the threads' (flag, value) pairs: a
    // warp's by shuffles, then the warps' in order. Warp 0 publishes the
    // span's: a prefix where the span holds a chunk start, else a total,
    // after which it looks back as the serial decode does. A span whose
    // first block starts a chunk needs no look-back.
    uint32_t f = fs < NR, v = row[NR - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t tf = __shfl_up_sync(0xffffffffu, f, o);
      const uint32_t tv = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) {
        uint32_t a = tf, av = tv;
        seg_add<EB>(a, av, f, v);
        f = a, v = av;
      }
    }
    uint32_t ef = __shfl_up_sync(0xffffffffu, f, 1), ev = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) ef = 0, ev = 0;
    if (lane == 31) s_warp[warp] = v, s_wflag[warp] = f;
    __syncthreads();
    if (warp == 0) {
      uint32_t sf = 0, sv = 0;  // the span's
      for (int i = 0; i < LD_WARPS; ++i) seg_add<EB>(sf, sv, s_wflag[i], s_warp[i]);
      unsigned long long* st = status + 1;
      if (lane == 0) st_status(st + span, (sf ? FLAG_PREFIX : FLAG_TOTAL) | sv);
      uint32_t excl = 0;
      if (!s_marks[0]) {  // span > 0: span 0 starts chunk 0
        excl = lowdim_look_back<EB>(st, span, lane);
        if (lane == 0 && !sf) st_status(st + span, FLAG_PREFIX | vadd<EB>(excl, sv));
      }
      if (lane == 0) *s_excl = excl;
    }
    uint32_t bf = 0, bv = 0;  // the rows before this thread's
    for (int i = 0; i < warp; ++i) seg_add<EB>(bf, bv, s_wflag[i], s_warp[i]);
    seg_add<EB>(bf, bv, ef, ev);
    __syncthreads();
    const uint32_t base = bf ? bv : vadd<EB>(*s_excl, bv);
    // 4. Values into the image.
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r < fs) row[r] = vadd<EB>(base, row[r]);
    }
  } else if constexpr (!RAW) {
    // 2b. The rows' running sum in registers.
#pragma unroll
    for (int r = 1; r < NR; ++r) row[r] = vadd<EB>(row[r - 1], row[r]);
    // 3. The CTA's scan of the threads' totals; warp 0 publishes the span's
    // total, looks back and publishes its inclusive prefix, while the other
    // warps sum the totals of the warps before them.
    uint32_t incl = row[NR - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = vadd<EB>(incl, t);
    }
    uint32_t base = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) base = 0;
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      uint32_t agg = lane < LD_WARPS ? s_warp[lane] : 0u;
#pragma unroll
      for (int o = 16; o; o >>= 1) agg = vadd<EB>(agg, __shfl_xor_sync(0xffffffffu, agg, o));
      unsigned long long* st = status + 1;
      if (lane == 0) st_status(st + span, (span == 0 ? FLAG_PREFIX : FLAG_TOTAL) | agg);
      if (span > 0) {
        const uint32_t excl = lowdim_look_back<EB>(st, span, lane);
        if (lane == 0) st_status(st + span, FLAG_PREFIX | vadd<EB>(excl, agg));
        if (lane == 0) *s_excl = excl;
      } else if (lane == 0) {
        *s_excl = 0;
      }
    }
    for (int i = 0; i < warp; ++i) base = vadd<EB>(base, s_warp[i]);
    __syncthreads();
    base = vadd<EB>(base, *s_excl);
    // 4. Values into the image.
#pragma unroll
    for (int r = 0; r < NR; ++r) row[r] = vadd<EB>(base, row[r]);
    if constexpr (REDUCE) {
      // 5. The thread's rows of its blocks (not those past nb) folded lane by
      // lane, then the warp's threads by shuffles; each warp's partials into
      // shared memory for warp 0.
      uint32_t rv[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) rv[d] = 0u;
      if (ra.op == RED_SUM) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (tid * K + k < nbs) {
#pragma unroll
            for (int r8 = 0; r8 < BLOCK_SZ; ++r8) {
#pragma unroll
              for (int d = 0; d < ND; ++d) {
                const uint32_t x = (row[k * BLOCK_SZ + r8] >> (d * EB)) & kMask;
                rv[d] += r8 == BLOCK_SZ - 1 ? x * gw[k] : x;
              }
            }
          }
        }
      } else {
        const uint32_t flip = ra.op == RED_MIN ? kMask : 0u;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (tid * K + k < nbs) {
#pragma unroll
            for (int r8 = 0; r8 < BLOCK_SZ; ++r8) {
#pragma unroll
              for (int d = 0; d < ND; ++d) {
                const uint32_t x = ((row[k * BLOCK_SZ + r8] >> (d * EB)) & kMask) ^ flip;
                rv[d] = rv[d] > x ? rv[d] : x;
              }
            }
          }
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const uint32_t y = __shfl_xor_sync(0xffffffffu, rv[d], o);
          rv[d] = ra.op == RED_SUM ? rv[d] + y : (rv[d] > y ? rv[d] : y);
        }
      }
      uint32_t* s_redw = reinterpret_cast<uint32_t*>(smem + L::kMarks);  // [LD_WARPS][ND]
      if (lane == 0) {
#pragma unroll
        for (int d = 0; d < ND; ++d) s_redw[warp * ND + d] = rv[d];
      }
    }
  }
  if constexpr (RAW && EB == 16) {
#pragma unroll
    for (int i = 0; i < L::kOutWords; ++i) {
      img[i] = (uint64_t)f32[2 * i + 1] << 32 | f32[2 * i];
    }
  } else if (!REDUCE || ra.store) {
    put_rows<S::RB>(img, row);
  }
  __syncthreads();
  // The image out in 16-byte stores (the span's output starts on 16 bytes;
  // its last unit may be one word).
  constexpr int W = L::kOutWords, WP = L::kPadWords;
  constexpr int WB = W / K;  // 8-byte words of a block's output
  const int nwords = nbs * WB;
  const uint64_t* s_words = reinterpret_cast<const uint64_t*>(s_img);
  uint64_t* dst = reinterpret_cast<uint64_t*>(out) + b0 * WB;
  for (int q = 2 * tid; q < ((!REDUCE || ra.store) ? nwords : 0); q += 2 * LD_THREADS) {
    const uint64_t lo = s_words[q / W * WP + q % W];
    if (q + 1 < nwords) {
      const uint64_t hi = s_words[(q + 1) / W * WP + (q + 1) % W];
      *reinterpret_cast<uint4*>(dst + q) =
          make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
    } else {
      dst[q] = lo;
    }
  }
  if (!RAW && warp == 0) {  // the last span to finish zeroes the status words
    if constexpr (REDUCE) {  // the span's partials first (the 8 warps'), into the accumulators
      const uint32_t* s_redw = reinterpret_cast<const uint32_t*>(smem + L::kMarks);
      if (lane < ND) {
        uint32_t v = s_redw[lane];
        for (int w = 1; w < LD_WARPS; ++w) {
          const uint32_t y = s_redw[w * ND + lane];
          v = ra.op == RED_SUM ? v + y : (v > y ? v : y);
        }
        if (ra.op == RED_SUM) {
          atomicAdd(ra.acc + lane, v);
        } else {
          atomicMax(ra.acc + lane, v);
        }
      }
      __syncwarp();  // the lanes' atomics, then (the fence below) the count
    }
    unsigned last = 0;
    if (lane == 0) {
      __threadfence();
      last = atomicAdd(counters + 1, 1u) == (unsigned)(nspans - 1);
    }
    if (__shfl_sync(0xffffffffu, last, 0)) {
      for (int64_t i = lane; i <= nspans; i += 32) status[i] = 0;
      if constexpr (REDUCE) {  // the result; the accumulators back to zero
        __threadfence();
        if (lane < ND) {
          const uint32_t a = atomicExch(ra.acc + lane, 0u);
          ra.out[lane] = ra.op == RED_MIN ? (ra.leading_gap ? 0u : a ^ kMask) : a;
        }
      }
    }
  }
}

// K1's tile: contiguous where the whole rows fit SMEM_BUDGET, else the
// widest chunk of dims (a multiple of 32) that fits.
Plan unpack_plan(int ndims, int maxb, int es, int os, bool chunked) {
  Plan p{};
  const int marks = chunked ? 4 * (TILE_BLOCKS + 3) : 0;  // ChunkMarks
  auto aux = [marks](int dc) {
    return 4 * TILE_BLOCKS * (dc + 1) + 4 * dc + 4 * TILE_BLOCKS + 16 + marks;
  };
  p.out_off = round16(15 + (long long)TILE_ROWS * maxb + READ_SLACK);
  p.w_off = p.out_off + round16(15 + (long long)TILE_ROWS * ndims * os);
  p.aux_off = p.w_off + round16(15 + (long long)TILE_BLOCKS * ndims);
  p.smem = p.aux_off + aux(ndims);
  if (p.smem <= SMEM_BUDGET) {
    p.dc = ndims;
    p.contig = 1;
    p.window = maxb;
    return p;
  }
  for (int dc = 32;; dc += 32) {
    const int window = dc * es + 3 < maxb ? dc * es + 3 : maxb;
    const int in_stride = round16(window + 15 + READ_SLACK);
    const int out_stride = round16(15 + dc * os);
    const int w_stride = round16(15 + dc);
    const int smem = TILE_ROWS * (in_stride + out_stride) + TILE_BLOCKS * w_stride + aux(dc);
    if (dc > 32 && (smem > SMEM_BUDGET || dc >= ndims)) break;
    p.dc = dc;
    p.window = window;
    p.in_stride = in_stride;
    p.out_stride = out_stride;
    p.w_stride = w_stride;
    p.out_off = TILE_ROWS * in_stride;
    p.w_off = p.out_off + TILE_ROWS * out_stride;
    p.aux_off = p.w_off + TILE_BLOCKS * w_stride;
    p.smem = smem;
  }
  return p;
}

// K2's tile: one image of the values, in place, and the tile's offsets
// (REDUCE: also the runs' partials and the tile's gap words).
Plan finish_plan(int ndims, int es, bool chunked, bool reduce) {
  Plan p{};
  const int marks = chunked ? 4 * (RUNS + TILE_BLOCKS + 3) : 0;  // runs' last, ChunkMarks
  auto red = [reduce](int dc) { return reduce ? 4 * RUNS * dc + round16(15 + 4 * TILE_BLOCKS) : 0; };
  p.w_off = round16(15 + (long long)TILE_ROWS * ndims * es);
  p.aux_off = p.w_off + round16(15 + 4LL * ndims);
  p.smem = p.aux_off + 4 * RUNS * ndims + marks + red(ndims);
  if (p.smem <= SMEM_BUDGET) {
    p.dc = ndims;
    p.contig = 1;
  } else {
    for (int dc = 32;; dc += 32) {
      const int in_stride = round16(15 + dc * es);
      const int smem =
          TILE_ROWS * in_stride + round16(15 + 4 * dc) + 4 * RUNS * dc + marks + red(dc);
      if (dc > 32 && (smem > SMEM_BUDGET || dc >= ndims)) break;
      p.dc = dc;
      p.in_stride = in_stride;
      p.w_off = TILE_ROWS * in_stride;
      p.aux_off = p.w_off + round16(15 + 4 * dc);
      p.smem = smem;
    }
  }
  p.red_off = p.aux_off + 4 * RUNS * p.dc + marks;
  p.gap_off = p.red_off + 4 * RUNS * p.dc;
  return p;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The chunks of a chunked launch (null first: the serial decode)
struct ChunkArgs {
  const long long* first;
  int nchunks;
  const int32_t* state;
};

template <int EB, bool RAW, bool CONTIG, bool CHUNKED>
int launch_unpack(const uint8_t* dense, const uint8_t* widths, void* out, int32_t* tile_off,
                  unsigned long long* status, long long nb, int ndims, int maxb, const Plan& p,
                  const ChunkArgs& ck, cudaStream_t s) {
  using OutT = typename UnpackOut<EB, RAW>::type;
  const long long ntiles = (nb + TILE_BLOCKS - 1) / TILE_BLOCKS;
  cudaError_t err = allow_smem(unpack_zz_kernel<EB, RAW, CONTIG, CHUNKED>, p.smem);
  if (err == cudaSuccess && !RAW) {  // the status words and the ticket
    err = cudaMemsetAsync(status, 0, (size_t)(ntiles * ndims + 1) * sizeof(*status), s);
  }
  if (err != cudaSuccess) return (int)err;
  unpack_zz_kernel<EB, RAW, CONTIG, CHUNKED><<<(unsigned)ntiles, THREADS, (size_t)p.smem, s>>>(
      dense, widths, static_cast<OutT*>(out), tile_off, status, nb, ndims, maxb, p, ck.first,
      ck.nchunks, ck.state);
  return (int)cudaGetLastError();
}

template <int EB, bool RAW, bool CHUNKED>
int launch_unpack(const uint8_t* dense, const uint8_t* widths, void* out, int32_t* tile_off,
                  unsigned long long* status, long long nb, int ndims, int maxb,
                  const ChunkArgs& ck, cudaStream_t s) {
  const Plan p = unpack_plan(ndims, maxb, EB / 8,
                             (int)sizeof(typename UnpackOut<EB, RAW>::type), CHUNKED);
  return p.contig ? launch_unpack<EB, RAW, true, CHUNKED>(dense, widths, out, tile_off, status,
                                                          nb, ndims, maxb, p, ck, s)
                  : launch_unpack<EB, RAW, false, CHUNKED>(dense, widths, out, tile_off, status,
                                                           nb, ndims, maxb, p, ck, s);
}

template <int EB, bool CONTIG, bool CHUNKED, bool REDUCE>
int launch_finish(const void* bz, const int32_t* tile_off, void* out, long long rows, int ndims,
                  const Plan& p, const ChunkArgs& ck, const ReduceArgs& ra, cudaStream_t s) {
  using T = typename Narrow<EB>::type;
  const cudaError_t err = allow_smem(prefix_finish_kernel<EB, CONTIG, CHUNKED, REDUCE>, p.smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned ntiles = (unsigned)((rows + TILE_ROWS - 1) / TILE_ROWS);
  prefix_finish_kernel<EB, CONTIG, CHUNKED, REDUCE><<<ntiles, THREADS, (size_t)p.smem, s>>>(
      static_cast<const T*>(bz), tile_off, static_cast<T*>(out), rows, ndims, p, ck.first,
      ck.nchunks, ck.state, ra);
  return (int)cudaGetLastError();
}

template <int EB, bool CHUNKED, bool REDUCE>
int launch_finish(const void* bz, const int32_t* tile_off, void* out, long long rows, int ndims,
                  const ChunkArgs& ck, const ReduceArgs& ra, cudaStream_t s) {
  const Plan p = finish_plan(ndims, EB / 8, CHUNKED, REDUCE);
  return p.contig
             ? launch_finish<EB, true, CHUNKED, REDUCE>(bz, tile_off, out, rows, ndims, p, ck, ra, s)
             : launch_finish<EB, false, CHUNKED, REDUCE>(bz, tile_off, out, rows, ndims, p, ck, ra,
                                                         s);
}

template <int EB, int ND, bool RAW, bool CHUNKED, bool REDUCE>
int launch_lowdim(const uint8_t* dense, const uint8_t* widths, void* out,
                  unsigned long long* status, long long nb, const ChunkArgs& ck,
                  const ReduceArgs& ra, cudaStream_t s) {
  constexpr int span = LowdimShape<EB / 8, ND>::SPAN;
  constexpr int smem = DecodeLowdimSmem<EB, ND, RAW, CHUNKED, REDUCE>::kBytes;
  static_assert(smem <= SMEM_DEFAULT, "the lowdim decode stays in the default shared memory");
  // the status words are zero: the last span of every launch zeroes them
  const unsigned spans = (unsigned)((nb + span - 1) / span);
  decode_lowdim_kernel<EB, ND, RAW, CHUNKED, REDUCE><<<spans, LD_THREADS, (size_t)smem, s>>>(
      dense, widths, static_cast<uint8_t*>(out), status, nb, ck.first, ck.nchunks, ck.state, ra);
  return (int)cudaGetLastError();
}

template <bool RAW, bool CHUNKED, bool REDUCE = false>
int launch_lowdim(const uint8_t* dense, const uint8_t* widths, void* out,
                  unsigned long long* status, long long nb, int ndims, int elem_bits,
                  const ChunkArgs& ck, cudaStream_t s, const ReduceArgs& ra = ReduceArgs{}) {
  switch (elem_bits * 8 + ndims) {
    case 8 * 8 + 1: return launch_lowdim<8, 1, RAW, CHUNKED, REDUCE>(dense, widths, out, status, nb, ck, ra, s);
    case 8 * 8 + 2: return launch_lowdim<8, 2, RAW, CHUNKED, REDUCE>(dense, widths, out, status, nb, ck, ra, s);
    case 8 * 8 + 3: return launch_lowdim<8, 3, RAW, CHUNKED, REDUCE>(dense, widths, out, status, nb, ck, ra, s);
    case 8 * 8 + 4: return launch_lowdim<8, 4, RAW, CHUNKED, REDUCE>(dense, widths, out, status, nb, ck, ra, s);
    case 16 * 8 + 1: return launch_lowdim<16, 1, RAW, CHUNKED, REDUCE>(dense, widths, out, status, nb, ck, ra, s);
    case 16 * 8 + 2: return launch_lowdim<16, 2, RAW, CHUNKED, REDUCE>(dense, widths, out, status, nb, ck, ra, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The checks of a REDUCE launch's arguments (those of csrc/query.cu's
// sprintz_reduce_cols): false where the kernel cannot take them.
bool reduce_args_ok(long long rows, int ndims, const ReduceArgs& ra, const void* out) {
  return rows >= 1 && ndims >= 1 && ndims <= 65535 && ra.op >= RED_SUM && ra.op <= RED_MIN &&
         ra.acc && ra.out && (!ra.store || (out && !((uintptr_t)out & 15))) &&
         (!ra.gap_after || (ra.op == RED_SUM && rows % BLOCK_SZ == 0 &&
                            !((uintptr_t)ra.gap_after & 15)));
}

}  // namespace

extern "C" {

// The chunks of a chunked decode, for each entry point below: first null
// (the serial decode), or (nchunks + 1) i64 block indices on the device,
// first[0] = 0, rising, first[nchunks] = nb (16-byte aligned or not), and
// state (nchunks, ndims) i32 on the device, chunk c's value before its
// first row. The values of chunk c are state[c] + the prefix of its own
// deltas, mod 2^elem_bits.

// dense (nb, 8, maxb) u8; widths (nb, ndims) u8, each at most elem_bits;
// dense, widths and out 16-byte aligned.
// raw == 0: out (nb, 8, ndims) u8/u16 biased deltas; tile_off
//           (ceil(nb / 32), ndims) i32 exclusive offsets of the tiles (with
//           chunks: the value entering each tile, its chunk's state where it
//           starts one); status ceil(nb / 32) * ndims + 1 words of 8 bytes,
//           scratch.
// raw != 0: out (nb, 8, ndims) fields, u8 at elem_bits 8 and i32 at 16;
//           tile_off, status and the chunks unused.
int sprintz_unpack_zz(const void* dense, const void* widths, void* out, void* tile_off,
                      void* status, long long nb, int ndims, int maxb, int elem_bits, int raw,
                      const void* first, int nchunks, const void* state, void* stream) {
  if (((uintptr_t)dense | (uintptr_t)widths | (uintptr_t)out) & 15 ||
      (first != nullptr && (raw || nchunks < 1 || state == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* dn = static_cast<const uint8_t*>(dense);
  const uint8_t* wd = static_cast<const uint8_t*>(widths);
  int32_t* to = static_cast<int32_t*>(tile_off);
  unsigned long long* st = static_cast<unsigned long long*>(status);
  const ChunkArgs ck{static_cast<const long long*>(first), nchunks,
                     static_cast<const int32_t*>(state)};
  if (raw && elem_bits == 8)
    return launch_unpack<8, true, false>(dn, wd, out, to, st, nb, ndims, maxb, ck, s);
  if (raw && elem_bits == 16)
    return launch_unpack<16, true, false>(dn, wd, out, to, st, nb, ndims, maxb, ck, s);
  if (raw) return (int)cudaErrorInvalidValue;
  if (elem_bits == 8)
    return first ? launch_unpack<8, false, true>(dn, wd, out, to, st, nb, ndims, maxb, ck, s)
                 : launch_unpack<8, false, false>(dn, wd, out, to, st, nb, ndims, maxb, ck, s);
  if (elem_bits == 16)
    return first ? launch_unpack<16, false, true>(dn, wd, out, to, st, nb, ndims, maxb, ck, s)
                 : launch_unpack<16, false, false>(dn, wd, out, to, st, nb, ndims, maxb, ck, s);
  return (int)cudaErrorInvalidValue;
}

// bz, out (rows, ndims) u8/u16; tile_off (ceil(rows / 256), ndims) i32;
// all three 16-byte aligned. With chunks, rows = first[nchunks] * 8.
int sprintz_prefix_finish(const void* bz, const void* tile_off, void* out, long long rows,
                          int ndims, int elem_bits, const void* first, int nchunks,
                          const void* state, void* stream) {
  if (((uintptr_t)bz | (uintptr_t)tile_off | (uintptr_t)out) & 15 ||
      (first != nullptr && (nchunks < 1 || state == nullptr || rows % BLOCK_SZ))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* to = static_cast<const int32_t*>(tile_off);
  const ChunkArgs ck{static_cast<const long long*>(first), nchunks,
                     static_cast<const int32_t*>(state)};
  const ReduceArgs none{};
  if (elem_bits == 8)
    return first ? launch_finish<8, true, false>(bz, to, out, rows, ndims, ck, none, s)
                 : launch_finish<8, false, false>(bz, to, out, rows, ndims, ck, none, s);
  if (elem_bits == 16)
    return first ? launch_finish<16, true, false>(bz, to, out, rows, ndims, ck, none, s)
                 : launch_finish<16, false, false>(bz, to, out, rows, ndims, ck, none, s);
  return (int)cudaErrorInvalidValue;
}

// K2 with the reduce as its epilogue (serial only): bz, tile_off, out and
// rows as sprintz_prefix_finish's (out unused and may be null without
// store); op 0 the sum mod 2^32, 1 the max, 2 the min down each dim, into
// red (ndims,) u32; gap_after null, or (rows / 8) i32, 16-byte aligned,
// run rows after each block, counted in the sum as repeats of its last row
// (rows a multiple of 8; sum only); leading_gap: min is 0; store: write the
// values too; acc: ndims + 1 u32 words, zero on entry and left zero.
int sprintz_prefix_finish_reduce(const void* bz, const void* tile_off, void* out, long long rows,
                                 int ndims, int elem_bits, int op, const void* gap_after,
                                 int leading_gap, int store, void* acc, void* red, void* stream) {
  const ReduceArgs ra{static_cast<const int32_t*>(gap_after), static_cast<uint32_t*>(acc),
                      static_cast<uint32_t*>(red), op, leading_gap, store};
  if (((uintptr_t)bz | (uintptr_t)tile_off) & 15 || !reduce_args_ok(rows, ndims, ra, out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* to = static_cast<const int32_t*>(tile_off);
  const ChunkArgs none{nullptr, 0, nullptr};
  if (elem_bits == 8) return launch_finish<8, false, true>(bz, to, out, rows, ndims, none, ra, s);
  if (elem_bits == 16) return launch_finish<16, false, true>(bz, to, out, rows, ndims, none, ra, s);
  return (int)cudaErrorInvalidValue;
}

// The lowdim layout: dense (nb, ndims, elem_bits) u8 sections (8 fields of
// w bits at bits r * w); widths (nb, ndims) u8, each at most elem_bits;
// ndims * elem_bits <= 32; dense, widths and out 16-byte aligned.
// raw == 0: out (nb * 8, ndims) u8/u16 values, the running sum of the
//           zigzag-decoded fields down each dim modulo 2^elem_bits (of each
//           chunk's, from its state); status ceil(nb / span) + 1 words of 8
//           bytes, zero on entry and left zero (span: 256 * max(1, 4 /
//           (ndims * elem_bits / 8)) blocks, 256 at u8 D 3).
// raw != 0: out (nb, 8, ndims) fields, u8 at elem_bits 8 and i32 at 16;
//           status and the chunks unused.
int sprintz_decode_lowdim(const void* dense, const void* widths, void* out, void* status,
                          long long nb, int ndims, int elem_bits, int raw, const void* first,
                          int nchunks, const void* state, void* stream) {
  if (nb < 1 || ((uintptr_t)dense | (uintptr_t)widths | (uintptr_t)out) & 15 ||
      (first != nullptr && (raw || nchunks < 1 || state == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* dn = static_cast<const uint8_t*>(dense);
  const uint8_t* wd = static_cast<const uint8_t*>(widths);
  unsigned long long* st = static_cast<unsigned long long*>(status);
  const ChunkArgs ck{static_cast<const long long*>(first), nchunks,
                     static_cast<const int32_t*>(state)};
  if (raw) return launch_lowdim<true, false>(dn, wd, out, st, nb, ndims, elem_bits, ck, s);
  return first ? launch_lowdim<false, true>(dn, wd, out, st, nb, ndims, elem_bits, ck, s)
               : launch_lowdim<false, false>(dn, wd, out, st, nb, ndims, elem_bits, ck, s);
}

// The lowdim decode with the reduce as its epilogue (serial only): dense,
// widths, out and status as sprintz_decode_lowdim's with raw 0 (out unused
// and may be null without store); op, gap_after (nb words), leading_gap,
// store, acc and red as sprintz_prefix_finish_reduce's (acc's count word
// unused: the decode's own finishing count publishes the result).
int sprintz_decode_lowdim_reduce(const void* dense, const void* widths, void* out, void* status,
                                 long long nb, int ndims, int elem_bits, int op,
                                 const void* gap_after, int leading_gap, int store, void* acc,
                                 void* red, void* stream) {
  const ReduceArgs ra{static_cast<const int32_t*>(gap_after), static_cast<uint32_t*>(acc),
                      static_cast<uint32_t*>(red), op, leading_gap, store};
  if (nb < 1 || ((uintptr_t)dense | (uintptr_t)widths) & 15 || !status ||
      !reduce_args_ok(nb * BLOCK_SZ, ndims, ra, out)) {
    return (int)cudaErrorInvalidValue;
  }
  const ChunkArgs none{nullptr, 0, nullptr};
  return launch_lowdim<false, false, true>(
      static_cast<const uint8_t*>(dense), static_cast<const uint8_t*>(widths), out,
      static_cast<unsigned long long*>(status), nb, ndims, elem_bits, none,
      static_cast<cudaStream_t>(stream), ra);
}

// The message of a CUDA error code, for the errors of every library here.
const char* sprintz_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
