// FIRE (xff) forecaster scan for Hopper (sm_90a), bound with ctypes.
//
// fire_encode_kernel<EB, TRUNC, STATES, XF>, fire_decode_kernel<EB, TRUNC, XF>,
// fire_decode_short_kernel<EB, TRUNC>
//   Replace the lax.scan of sprintz_tpu/models/forecasters.py:_fire_scan
//   (forecasters.py:303-339) over _fire_block_step (:247-300). TRUNC is
//   truncate_coeffs: true for the row-major layout's int16 coefficient
//   (the counter's bits above eb - 4, forecasters.py:234-238), false for
//   the lowdim layout's full-precision one (counter >> 1, :239-240). JAX
//   runs this pass outside Pallas; there is no TPU kernel behind it.
//   Encode: rows (N, D) i32 unsigned values -> zigzag errors (N, D) i32,
//   and with STATES the i32 carry before each block (prev value, prev
//   delta, learning counter), _fire_scan(return_states=True)'s output
//   (as (nb, D, 4) words), which a checkpoint sidecar takes its states
//   from.
//   Carries across calls (the serial scans, encode and decode): an
//   optional (3, D) i32 `init`, the carry entering the first block, and an
//   optional (3, D) i32 `fin`, which receives the carry after the last
//   block: _fire_scan(init_state=, return_final=True), the state that a
//   sharded scan hands from one shard to the next
//   (sprintz_tpu/parallel/shard.py:_fire_chain). The lanes hold the carry
//   in registers at the end of their chain; the chain warp stores the
//   counter after its last tile (and, at decode, the value and delta
//   beside it), and at encode the first finisher, after its last tile,
//   the last row's value (from the input) and delta (from the ring). All
//   of it is outside the loops over blocks: a per-block test in the
//   finishers made the encode with STATES 12-17% slower on an H100.
//   Decode: zigzag errors (N, D), u8 at EB 8 (K4's narrow mode) or i32 at
//   EB 16 -> values (N, D) u8/u16, split into C chunks of whole blocks
//   (chunk c is blocks [first[c], first[c + 1])), chunk c from its own
//   (3, D) i32 state: the vmapped fire_decode(init_state=) of
//   sprintz_tpu/decoder.py:949-951, over a sidecar's checkpoints. The
//   serial decode is the case C = 1, from one optional state.
//
//   What bounds it. Each dim's state passes through every block in order,
//   so a dim is one lane's work and the card runs D lanes. The first
//   kernel here gave each lane a loop over device memory: load 8 rows,
//   wait, compute, store, and only then ask for the next 8. It was bound
//   by that round trip (about 1350 cycles a block at encode, 840 at
//   decode), not by the recurrence. The recurrence itself is short:
//   - encode: deltas depend on the input alone and the coefficient is
//     fixed inside a block, so the only serial path is counter -> coef ->
//     one odd row's prediction, error and gradient term (the four odd
//     rows beside each other) -> their sum -> counter, once a block:
//     15 dependent integer operations a block at EB 8 (3 coef, multiply,
//     shift, subtract, shift, compare, 2 selects, 2 adds, shift,
//     shift-and-add, sign-extend), 14 at EB 16 (no last sign-extend);
//     with the full-precision coefficient (TRUNC false) the 3 coefficient
//     operations are one shift: 13 and 12;
//   - decode: delta[r] = sext(err[r] + (delta[r-1] * coef >> EB)) a row,
//     and the counter once a block beside the last row. At EB 8 a row is
//     one operation (below): 7 rows + 9 for the counter and coefficient
//     = 16 a block. At EB 16 a row is a shift and a multiply-add:
//     14 + 6 = 20 a block. TRUNC false: 14 and 18.
//   The chain bound is blocks x those operations x the card's latency for
//   one dependent integer multiply-add, which sprintz_fire_chain_probe
//   measures (4.14 cycles on an H100; a shift between two multiply-adds
//   makes the pair 10.2, not 8.3, since it leaves the multiplier's pipe
//   and comes back). The byte and operation bounds are microseconds.
//
//   Design. One CTA owns 32 neighbouring dims and is warp-specialised
//   around a ring of STAGES row tiles (TILE_BLOCKS blocks x 32 dims) in
//   shared memory, handed on through mbarriers (loaded -> chained -> free):
//   - loader warps keep the ring full, LOAD_TEAMS tiles at a time. A lane
//     starts LOAD_DEPTH independent loads of its dim (neighbouring lanes,
//     neighbouring addresses) before it uses the first, and the loaders
//     run up to STAGES - 2 tiles ahead of the chain. They do the work that
//     needs no state on the way to shared memory: encode's deltas;
//     decode's zigzag decode, left-shifted so that the chain adds it
//     inside its multiply-add, and the sign of each odd row's error. The
//     loads are plain, not cp.async: its copies are 4 bytes at least and
//     aligned, which u8 rows of any D are not, and the loaders transform
//     what they load anyway.
//   - one chain warp, one lane a dim, reads only shared memory and runs
//     only the recurrence, with a scheduler of the SM to itself. Encode:
//     the four odd rows' terms of a block, their sum sign-extended once
//     (sext(sext(a+b)+c) == sext(a+b+c)), the block's coefficient left for
//     the finishers. Decode: the deltas, written in place of the errors,
//     and beside the chain the running value above each block, so that no
//     finisher's block waits for another.
//   - FINISHERS finisher warps do the rest, a block each in turn, and
//     store coalesced. Encode: all eight predictions and errors from the
//     deltas and the block's coefficient, zigzag, mask. Decode: values are
//     the running sum of the block's deltas, mod 2^EB.
//   Chunks. A lane of the decode is a (chunk, dim) pair: a CTA's 32 lanes
//   are 32 / L chunks of L = min(D, 32) neighbouring dims each, so that at
//   D <= 4 one warp carries 8 to 32 chunks where the serial decode ran 1 to
//   4 live lanes; at D > 32 a chunk spans ceil(D / 32) CTAs. Each lane
//   loads, chains and stores its own chunk's rows; chunks differ in length
//   (runs), so a CTA runs as many tiles as its longest chunk needs, and a
//   lane stores only the blocks of its own. Lanes past the last chunk or
//   dim shadow a live lane's rows and store nothing. One kernel serves the
//   serial decode (C = 1) and the chunked one where a chunk is long: the
//   lane mapping is the only difference, and at C = 1 it is the serial
//   kernel's. Short chunks take fire_decode_short_kernel (below).
//   All arithmetic wraps as JAX's int32 does: products and sums are taken
//   in uint32_t and read back as int32_t. That holds for the full-precision
//   coefficient too, which at EB 16 reaches 2^30 (a 32-bit counter >> 1),
//   so that delta * coef wraps: the prediction reads only bits EB to
//   2 EB - 1 of the product, which the low 32 bits hold exactly. At EB 8
//   the full coefficient is an int16 counter >> 1 and still fits the 16-bit
//   half of decode's dot-product multiplier. A chunk-parallel decode from
//   sidecar states is the way past the chain; at D <= 4 (the lowdim layout)
//   one CTA runs 1 to 4 live lanes of it.
//
//   XF: the standalone preprocessor's FIRE (sprintz_tpu/transforms.py's xff
//   head, _fire_block_step(transform=True), forecasters.py:247-300), in
//   the same two kernels, instantiated with TRUNC alone (no states, no
//   carries, one chunk): the serial encode and decode of a stream from
//   the zero state. It differs from the codec's FIRE in four ways: the
//   errors are raw, not zigzag (encode writes err & mask as i32, decode
//   reads the stored u8 or u16 errors); the learning shift is 3 at EB 16
//   (Fire::kLearningShift); at EB 8 the even dims of the stream multiply
//   the previous delta's low byte, zero-extended, where the odd dims
//   sign-extend it; at EB 16 the prediction is
//   sext16(((delta * coef) >> 16) << 2). Encode's chain is the codec's:
//   at EB 8 the loaders store an even dim's deltas zero-extended (its
//   operand; everything else the chain and the finishers do with a delta
//   is mod 2^8), and at EB 16 each odd row's prediction adds a shift (one
//   dependent operation more a block). Decode's chain is xf_decode_chain:
//   at EB 8 an even dim's row is a two-way dot product that reads the
//   delta's byte unsigned (dp2a_su), one instruction as the codec's, and a
//   CTA takes 32 dims of one parity (ChunkLane's parity form) so that its
//   chain warp runs one form; at EB 16 the word keeps the delta over zero
//   low bits, so that a multiply-high gives (delta * coef) >> 16 and a
//   shift-add the next word: two operations a row, as the codec's.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SZ = 8;        // rows per block
constexpr int LEARNING_SHIFT = 1;  // FIRE_LEARNING_SHIFT
constexpr int GRAD_SHIFT = 2;      // LOG2_BLOCK_SZ - FIRE_LOG2_LEARNING_DOWNSAMPLE

constexpr int GROUP = 32;        // dims per CTA: one lane of each warp a dim
constexpr int TILE_BLOCKS = 16;  // blocks per tile
constexpr int TILE_ROWS = TILE_BLOCKS * BLOCK_SZ;
constexpr int STAGES = 8;        // tiles in the ring, a power of two
constexpr int LOAD_BLOCKS = 4;   // blocks a loader warp loads at once
constexpr int LOAD_DEPTH = LOAD_BLOCKS * BLOCK_SZ;  // independent loads a lane
constexpr int TEAM_WARPS = TILE_BLOCKS / LOAD_BLOCKS;  // loader warps on a tile
constexpr int LOAD_TEAMS = 2;  // tiles being loaded at once
constexpr int LOAD_WARPS = LOAD_TEAMS * TEAM_WARPS;
// One warp's stores to global memory leave about 12 cycles apart, whatever
// their width (3 apart over several warps), and a block has eight of
// them: the finishers take every FINISHERS-th block each. Two were not
// enough to keep up with encode's chain; more than four gained nothing.
constexpr int FINISHERS = 4;
// Warp 0 is the chain. An SM runs warp w on its scheduler w % 4, so warps
// 4, 8, ... would take the chain's instruction slots: they stay spare
// and exit at once. The other warps are numbered 0, 1, ... as helpers:
// first the finishers, then the loaders.
constexpr int SCHEDULERS = 4;
__host__ __device__ constexpr int helpers_below(int warp) {
  return warp - 1 - (warp - 1) / SCHEDULERS;
}
__host__ __device__ constexpr int warps_for(int helpers) {
  int w = 1;
  while (helpers_below(w) < helpers) ++w;
  return w;
}
constexpr int WARPS = warps_for(FINISHERS + LOAD_WARPS);

// A tile in shared memory: for each block two uint4 a lane (rows 0-3 and
// 4-7 of its dim), [block][half][lane], so that every access is 16 bytes
// wide and a warp's lanes are 16 bytes apart (no bank conflicts); beside
// it one 16-byte cell a block and lane, [block][lane]: encode's
// coefficient; decode's four odd rows' signs, and once the chain has read
// them the value above the block in the first.
constexpr int DATA_BYTES = TILE_BLOCKS * 2 * GROUP * 16;
constexpr int AUX_BYTES = TILE_BLOCKS * GROUP * 16;
constexpr int STAGE_BYTES = DATA_BYTES + AUX_BYTES;
constexpr int BARRIER_BYTES = 256;  // 3 * STAGES mbarriers, padded
constexpr int SMEM_BYTES = BARRIER_BYTES + STAGES * STAGE_BYTES;
// row offsets inside a tile are 32-bit (TILE_ROWS * ndims must fit) and so
// is the count of tiles
constexpr int MAX_NDIMS = 1 << 24;
constexpr long long MAX_BLOCKS = 1LL << 34;

static_assert((STAGES & (STAGES - 1)) == 0, "slot and parity by mask and shift");
static_assert(STAGES >= LOAD_TEAMS + 2, "a tile each for chain and finishers");
static_assert(3 * STAGES * 8 <= BARRIER_BYTES, "barriers");
static_assert(SMEM_BYTES <= 232448, "shared memory of one SM");

// ---- mbarriers and timers (PTX)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// release: what this thread wrote before is visible to who waits
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// acquire: returns once the phase of this parity has completed. try_wait
// suspends the warp in hardware until then or a time limit; testing and
// sleeping instead changed no time.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the card's global timer, nanoseconds
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// c + a's signed 16-bit halves times b's bytes 0 and 1 read UNSIGNED:
// __dp2a_lo with unsigned bytes (the preprocessor's even dims at EB 8)
__device__ __forceinline__ uint32_t dp2a_su(int32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// ---- end of PTX

// The low BITS of x, read as signed; a byte or short cast is one
// instruction.
template <int BITS>
__device__ __forceinline__ int32_t sext(uint32_t x) {
  if constexpr (BITS == 8) {
    return (int32_t)(int8_t)x;
  } else if constexpr (BITS == 16) {
    return (int32_t)(int16_t)x;
  } else {
    static_assert(BITS == 32, "sext width");
    return (int32_t)x;
  }
}

// XF: the preprocessor's FIRE (see the header)
template <int EB, bool XF = false>
struct Fire {
  static constexpr int kCounterBits = EB == 8 ? 16 : 32;
  static constexpr int kShft = EB - 4;
  // the coefficient's learning shift: the preprocessor's is 3 at EB 16
  // (predict.cpp:62, sprintz_tpu/transforms.py:103)
  static constexpr int kLearningShift = XF && EB == 16 ? 3 : LEARNING_SHIFT;
  static constexpr uint32_t kMask = (1u << EB) - 1u;
  using narrow_t = typename std::conditional<EB == 8, uint8_t, uint16_t>::type;
  // decode reads zigzag errors, u8 (EB 8) or i32 (EB 16); the
  // preprocessor's raw errors as stored, u8 or u16
  using errs_t = typename std::conditional<
      XF, narrow_t, typename std::conditional<EB == 8, uint8_t, int32_t>::type>::type;
  // XF at EB 8: the loaders' mask of an even dim's deltas, whose prediction
  // multiplies the previous delta's low byte, zero-extended
  static constexpr bool kByteOperand = XF && EB == 8;

  template <bool TRUNC>
  __device__ static __forceinline__ int32_t coef(int32_t counter) {
    if constexpr (TRUNC) {
      return sext<16>((uint32_t)(counter >> (kLearningShift + kShft)) << kShft);
    } else {
      return counter >> kLearningShift;
    }
  }
  __device__ static __forceinline__ int32_t prediction(int32_t prev_delta,
                                                        int32_t c) {
    if constexpr (XF && EB == 16) {
      return sext<16>(
          (uint32_t)((int32_t)((uint32_t)prev_delta * (uint32_t)c) >> 16) << 2);
    } else {
      return sext<EB>(
          (uint32_t)((int32_t)((uint32_t)prev_delta * (uint32_t)c) >> EB));
    }
  }
  __device__ static __forceinline__ int32_t next_counter(int32_t counter,
                                                          int32_t grad_shifted) {
    return sext<kCounterBits>((uint32_t)counter + (uint32_t)grad_shifted);
  }

  // Decode's chain carries a word with the delta in its bits EB to
  // 2 EB - 1: word' = delta * coef + (err << EB) has the next delta there,
  // the low EB bits of err + (delta * coef >> EB), which is what
  // _fire_block_step's sign_extend(err + sign_extend(product >> EB)) keeps.
  // At EB 8 the delta is byte 1 of the word, and a two-way dot product
  // (16-bit halves of a times signed bytes 0 and 1 of b, plus c) with the
  // multiplier in a's high half reads it there, sign and all: one
  // instruction a row, no shift or extension between two multiplies, which
  // would cross from the multiplier's pipe to the ALU's and back. At EB 16
  // the product needs 32 bits, so the delta is shifted out first.
  __device__ static __forceinline__ int32_t delta_of(uint32_t word) {
    if constexpr (EB == 8) {
      return (int32_t)(int8_t)(word >> 8);
    } else {
      return (int32_t)word >> 16;
    }
  }
  // the multiplier m in the form advance() takes it
  __device__ static __forceinline__ int32_t multiplier(int32_t m) {
    if constexpr (EB == 8) {
      return (int32_t)((uint32_t)m << 16);
    } else {
      return m;
    }
  }
  // delta_of(word) * m + addend, m from multiplier()
  __device__ static __forceinline__ uint32_t advance(uint32_t word, int32_t m,
                                                      uint32_t addend) {
    if constexpr (EB == 8) {
      return (uint32_t)__dp2a_lo(m, (int32_t)word, (int32_t)addend);
    } else {
      return (uint32_t)delta_of(word) * (uint32_t)m + addend;
    }
  }
  // An odd row's sign s in {-1, 0, 1} as the loaders leave it, s << 16, is
  // advance()'s multiplier at EB 8; at EB 16 the sum of the terms then
  // sits in the high half, and sext(sum) >> GRAD_SHIFT is one shift.
  __device__ static __forceinline__ int32_t grad_shifted(uint32_t sum) {
    if constexpr (EB == 8) {
      return sext<8>(sum) >> GRAD_SHIFT;
    } else {
      return (int32_t)sum >> (16 + GRAD_SHIFT);
    }
  }
};

// The ring's barriers and tiles in dynamic shared memory. Tile t lives in
// slot t % STAGES; each role passes a slot once a round, so the parity to wait
// for is the round's.
struct Ring {
  uint64_t* loaded;   // loaders -> chain
  uint64_t* chained;  // chain -> finishers
  uint64_t* free_;    // finishers -> loaders
  unsigned char* stages;

  __device__ explicit Ring(unsigned char* smem)
      : loaded(reinterpret_cast<uint64_t*>(smem)),
        chained(loaded + STAGES),
        free_(chained + STAGES),
        stages(smem + BARRIER_BYTES) {}

  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(loaded + s, TEAM_WARPS * 32);
      mbar_init(chained + s, 32);
      mbar_init(free_ + s, FINISHERS * 32);
    }
    mbar_init_fence();
  }
  __device__ static __forceinline__ int slot(int t) { return t & (STAGES - 1); }
  __device__ static __forceinline__ uint32_t round_parity(int t) {
    return (uint32_t)(t / STAGES) & 1u;
  }
  // this lane's first cell of slot s: cell (block b, half h) is at
  // [(2 * b + h) * GROUP], the block's aux cell at [b * GROUP]
  __device__ __forceinline__ uint4* data(int s, int lane) const {
    return reinterpret_cast<uint4*>(stages + s * STAGE_BYTES) + lane;
  }
  __device__ __forceinline__ uint4* aux(int s, int lane) const {
    return reinterpret_cast<uint4*>(stages + s * STAGE_BYTES + DATA_BYTES) + lane;
  }
};

__device__ __forceinline__ int blocks_in_tile(long long nb, int t) {
  const long long left = nb - (long long)t * TILE_BLOCKS;
  return left < TILE_BLOCKS ? (left > 0 ? (int)left : 0) : TILE_BLOCKS;
}

// a block's eight words of one lane, from and to its two cells
__device__ __forceinline__ void read_block(const uint4* cells, int b,
                                           uint32_t (&x)[BLOCK_SZ]) {
  const uint4 lo = cells[(2 * b) * GROUP], hi = cells[(2 * b + 1) * GROUP];
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}
__device__ __forceinline__ void write_block(uint4* cells, int b,
                                            const uint32_t* x) {
  cells[(2 * b) * GROUP] = make_uint4(x[0], x[1], x[2], x[3]);
  cells[(2 * b + 1) * GROUP] = make_uint4(x[4], x[5], x[6], x[7]);
}

// ------------------------------------------------------------------ encode

// LOAD_DEPTH rows at p (row stride ndims) and the row above them -> their
// deltas, in LOAD_BLOCKS blocks from block b0 of `cells`. FULL: all of
// them exist; else `left` of them do. Where has_above is false (the
// stream's first row) the value above is `above0`, the carried one.
// STATES: also the value above each block, in word 1 of its aux cell.
// BYTE_OPERAND: the deltas ANDed with `omask` (the preprocessor's even dims
// at EB 8: 0xff).
template <int EB, bool FULL, bool STATES, bool BYTE_OPERAND = false>
__device__ __forceinline__ void load_deltas(const int32_t* __restrict__ p,
                                            uint32_t ndims, bool has_above,
                                            int32_t above0, long long left, uint4* cells,
                                            uint4* aux, int b0, uint32_t omask = ~0u) {
  int32_t v[LOAD_DEPTH + 1];
  v[0] = has_above ? (FULL || left >= 0 ? *(p - ndims) : 0) : above0;
#pragma unroll
  for (int j = 0; j < LOAD_DEPTH; ++j)
    v[j + 1] = FULL || j < left ? p[(uint32_t)j * ndims] : 0;
  uint32_t dl[LOAD_DEPTH];
#pragma unroll
  for (int j = 0; j < LOAD_DEPTH; ++j) {
    dl[j] = (uint32_t)sext<EB>((uint32_t)v[j + 1] - (uint32_t)v[j]);
    if constexpr (BYTE_OPERAND) dl[j] &= omask;
  }
#pragma unroll
  for (int q = 0; q < LOAD_BLOCKS; ++q) {
    write_block(cells, b0 + q, dl + q * BLOCK_SZ);
    if constexpr (STATES)
      reinterpret_cast<int32_t*>(aux + (b0 + q) * GROUP)[1] = v[q * BLOCK_SZ];
  }
}

// STATES: states (nb, ndims, 4) receives the carry before each block, its
// words 0-2 (word 3 is 0). The chain leaves the counter in word 0 of the
// block's aux cell where it leaves the coefficient otherwise, the loaders
// the value above the block in word 1, and the finishers, which hold the
// delta above each block and take the coefficient from the counter, write
// all three in one 16-byte store: three 4-byte stores a (block, dim) made
// the finishers the pipeline's slowest role (10% on the whole encode, in
// probes/sidecar_probe.py's ablations).
// XF: the preprocessor's FIRE, raw errors (err & mask) in place of zigzag
// ones; at EB 8 the loaders zero-extend the deltas of even dims d.
template <int EB, bool TRUNC, bool STATES, bool XF = false>
__global__ void __launch_bounds__(32 * WARPS)
    fire_encode_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                       int32_t* __restrict__ states, const int32_t* __restrict__ init,
                       int32_t* __restrict__ fin, long long nb, int ndims) {
  using F = Fire<EB, XF>;
  extern __shared__ __align__(16) unsigned char fire_smem[];
  Ring ring(fire_smem);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp != 0 && warp % SCHEDULERS == 0) return;  // spare
  const int helper = helpers_below(warp);
  const int d = blockIdx.x * GROUP + lane;
  const bool active = d < ndims;
  const long long nrows = nb * BLOCK_SZ;
  const int ntiles = (int)((nb + TILE_BLOCKS - 1) / TILE_BLOCKS);

  if (warp == 0) {
    // counter -> coef -> the odd rows' gradient terms -> counter
    int32_t counter = init != nullptr && active ? init[2 * ndims + d] : 0;
    for (int t = 0; t < ntiles; ++t) {
      const int s = Ring::slot(t);
      mbar_wait(ring.loaded + s, Ring::round_parity(t));
      const uint4* cells = ring.data(s, lane);
      int32_t* coefs = reinterpret_cast<int32_t*>(ring.aux(s, lane));
      const int nblk = blocks_in_tile(nb, t);
#pragma unroll 2
      for (int b = 0; b < nblk; ++b) {
        uint32_t x[BLOCK_SZ];
        read_block(cells, b, x);
        const int32_t c = F::template coef<TRUNC>(counter);
        // with STATES the counter, of which the finishers take the
        // coefficient themselves: one store a block on the chain either way
        coefs[b * GROUP * 4] = STATES ? counter : c;
        uint32_t grad[BLOCK_SZ / 2];
#pragma unroll
        for (int r = 1; r < BLOCK_SZ; r += 2) {
          const int32_t err =
              sext<EB>(x[r] - (uint32_t)F::prediction((int32_t)x[r - 1], c));
          // icopysign(err, prev_delta) (util.h:63-74)
          grad[r >> 1] = err == 0 ? 0u : (err < 0 ? 0u - x[r - 1] : x[r - 1]);
        }
        counter = F::next_counter(
            counter,
            sext<EB>((grad[0] + grad[1]) + (grad[2] + grad[3])) >> GRAD_SHIFT);
      }
      mbar_arrive(ring.chained + s);
    }
    if (fin != nullptr && active) fin[2 * ndims + d] = counter;
  } else if (helper >= FINISHERS) {
    // values -> deltas: a team of TEAM_WARPS warps loads every LOAD_TEAMS-th
    // tile, each warp LOAD_BLOCKS of its blocks
    const int lw = helper - FINISHERS;
    const int b0 = (lw % TEAM_WARPS) * LOAD_BLOCKS;
    const int dsafe = active ? d : ndims - 1;  // loads stay in bounds
    const int32_t init_val = init != nullptr ? init[dsafe] : 0;
    const uint32_t omask = (d & 1) == 0 ? 0xffu : ~0u;  // F::kByteOperand
    for (int t = lw / TEAM_WARPS; t < ntiles; t += LOAD_TEAMS) {
      const int s = Ring::slot(t);
      mbar_wait(ring.free_ + s, Ring::round_parity(t) ^ 1u);
      const long long row0 = (long long)t * TILE_ROWS + b0 * BLOCK_SZ;
      const int32_t* p = in + (row0 * ndims + dsafe);
      if ((long long)(t + 1) * TILE_ROWS <= nrows)
        load_deltas<EB, true, STATES, F::kByteOperand>(p, (uint32_t)ndims, row0 > 0,
                                                       init_val, 0, ring.data(s, lane),
                                                       ring.aux(s, lane), b0, omask);
      else
        load_deltas<EB, false, STATES, F::kByteOperand>(p, (uint32_t)ndims, row0 > 0,
                                                        init_val, nrows - row0,
                                                        ring.data(s, lane), ring.aux(s, lane),
                                                        b0, omask);
      mbar_arrive(ring.loaded + s);
    }
  } else {
    // deltas and the block's coefficient -> zigzag errors, every
    // FINISHERS-th block
    const int f = helper;
    // the delta of the row above the tile
    uint32_t halo = init != nullptr && active ? (uint32_t)init[ndims + d] : 0u;
    for (int t = 0; t < ntiles; ++t) {
      const int s = Ring::slot(t);
      mbar_wait(ring.chained + s, Ring::round_parity(t));
      const uint4* cells = ring.data(s, lane);
      const int32_t* coefs = reinterpret_cast<const int32_t*>(ring.aux(s, lane));
      const int nblk = blocks_in_tile(nb, t);
      int32_t* tile_out = out + ((long long)t * TILE_ROWS * ndims + d);
      for (int b = f; b < nblk; b += FINISHERS) {
        const int32_t cell = coefs[b * GROUP * 4];
        const int32_t c = STATES ? F::template coef<TRUNC>(cell) : cell;
        uint32_t x[BLOCK_SZ];
        read_block(cells, b, x);
        uint32_t prev = b ? cells[(2 * b - 1) * GROUP].w : halo;
        if constexpr (STATES) {
          if (active)
            reinterpret_cast<int4*>(states)[((long long)t * TILE_BLOCKS + b) * ndims + d] =
                make_int4(coefs[b * GROUP * 4 + 1], (int32_t)prev, cell, 0);
        }
        uint32_t zz[BLOCK_SZ];
#pragma unroll
        for (int r = 0; r < BLOCK_SZ; ++r) {
          const int32_t err = sext<EB>(x[r] - (uint32_t)F::prediction((int32_t)prev, c));
          if constexpr (XF) {
            zz[r] = (uint32_t)err & F::kMask;  // raw
          } else {
            zz[r] = (((uint32_t)err << 1) ^ (uint32_t)(err >> 31)) & F::kMask;
          }
          prev = x[r];
        }
        if (active) {
          int32_t* o = tile_out + (uint32_t)(b * BLOCK_SZ) * (uint32_t)ndims;
#pragma unroll
          for (int r = 0; r < BLOCK_SZ; ++r, o += ndims) *o = (int32_t)zz[r];
        }
      }
      // a tile that has a successor is full
      halo = cells[(2 * TILE_BLOCKS - 1) * GROUP].w;
      mbar_arrive(ring.free_ + s);
    }
    // the carry after the last block: its last row's value and delta. No
    // tile after the last reuses its slot, so its deltas are still there.
    if (fin != nullptr && active && f == 0) {
      const int nblk = blocks_in_tile(nb, ntiles - 1);
      fin[d] = in[(nrows - 1) * ndims + d];
      fin[ndims + d] = (int32_t)ring.data(Ring::slot(ntiles - 1), lane)[(2 * nblk - 1) * GROUP].w;
    }
  }
}

// ------------------------------------------------------------------ decode

// LOAD_DEPTH rows of zigzag errors at p (row stride ndims) -> err << EB,
// the addend of the chain's multiply-add, in LOAD_BLOCKS blocks from block
// b0 of `cells`, and each block's four odd rows' signs << 16, the
// multipliers of its gradient terms, in its cell of `signs`. FULL: all rows
// exist; else `left` of them do. XF: the errors are raw, not zigzag.
template <int EB, bool FULL, bool XF = false>
__device__ __forceinline__ void load_errors(
    const typename Fire<EB, XF>::errs_t* __restrict__ p, uint32_t ndims, long long left,
    uint4* cells, uint4* signs, int b0) {
  uint32_t u[LOAD_DEPTH];
#pragma unroll
  for (int j = 0; j < LOAD_DEPTH; ++j)
    u[j] = FULL || j < left ? (uint32_t)p[(uint32_t)j * ndims] : 0u;
  uint32_t sg[LOAD_DEPTH / 2];
#pragma unroll
  for (int j = 0; j < LOAD_DEPTH; ++j) {
    int32_t err;
    if constexpr (XF) {
      err = sext<EB>(u[j]);
    } else {
      err = sext<EB>((u[j] >> 1) ^ (0u - (u[j] & 1u)));
    }
    u[j] = (uint32_t)err << EB;
    if (j & 1) sg[j >> 1] = err == 0 ? 0u : (err < 0 ? 0xffff0000u : 0x00010000u);
  }
#pragma unroll
  for (int q = 0; q < LOAD_BLOCKS; ++q) {
    write_block(cells, b0 + q, u + q * BLOCK_SZ);
    signs[(b0 + q) * GROUP] =
        make_uint4(sg[4 * q], sg[4 * q + 1], sg[4 * q + 2], sg[4 * q + 3]);
  }
}

// A decode lane's (chunk, dim) pair and its chunk's blocks (see Chunks in
// the header). `first` holds nchunks + 1 block indices, or is null for one
// chunk of all nb blocks.
struct ChunkLane {
  int chunk, d;
  bool active;          // a live (chunk, dim): it stores
  long long b0, nblk;   // the blocks its loads read: its own chunk's, or a
                        // live lane's where it is not live
  long long cta_nblk;   // the most blocks of any chunk of the CTA

  __device__ ChunkLane(const long long* __restrict__ first, int nchunks, long long nb,
                       int ndims, int lane) {
    const int per = ndims < GROUP ? ndims : GROUP;  // lanes a chunk
    const int chunks_per_cta = GROUP / per;
    const int dgroups = (ndims + per - 1) / per;
    const int cg = (int)(blockIdx.x / dgroups), dg = (int)(blockIdx.x % dgroups);
    const int cl = lane / per;
    chunk = cg * chunks_per_cta + cl;
    d = dg * per + lane % per;
    active = cl < chunks_per_cta && chunk < nchunks && d < ndims;
    // the rows a lane that is not live loads: the last live chunk's of the
    // CTA, at the last dim
    int ca = chunk < nchunks ? chunk : nchunks - 1;
    if (cl >= chunks_per_cta) ca = cg * chunks_per_cta + chunks_per_cta - 1;
    if (ca >= nchunks) ca = nchunks - 1;
    b0 = first ? first[ca] : 0;
    nblk = first ? first[ca + 1] - b0 : nb;
    if (d >= ndims) d = ndims - 1;
    long long most = nblk;
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      const long long o = __shfl_xor_sync(0xffffffffu, most, m);
      most = o > most ? o : most;
    }
    cta_nblk = most;
  }

  // The preprocessor's decode at EB 8 (one chunk of nb blocks): CTA i takes
  // the 32 dims of one parity 2 * lane + (i & 1) from 64 * (i >> 1), so
  // that its chain runs one form of the prediction (xf_decode_chain).
  __device__ ChunkLane(long long nb, int ndims, int lane)
      : chunk(0),
        d(64 * (int)(blockIdx.x >> 1) + 2 * lane + (int)(blockIdx.x & 1)),
        active(d < ndims),
        b0(0),
        nblk(nb),
        cta_nblk(nb) {
    if (d >= ndims) d = ndims - 1;
  }
};

// The preprocessor's decode chain (XF, from the zero state): the ring
// kernel's chain with the preprocessor's prediction. At EB 8 an odd dim's
// row is the codec's (Fire::advance) and an even dim's reads the delta's
// byte unsigned (dp2a_su, EVEN): one instruction a row either way, a CTA's
// dims all of one parity. At EB 16 the word holds the delta in its high
// half over zero low bits, so that the high word of word * coef is
// (delta * coef) >> 16, and the next word is that << 18 plus the loaders'
// err << 16: a multiply-high and a shift-add a row. The word then is the
// delta times 2^16, so the value and the gradient terms take it as it is:
// the value above the block runs in the high half of `val` (an add a row),
// and a term is the word times the error's sign (no shift out of the word).
template <int EB, bool EVEN>
__device__ __forceinline__ void xf_decode_chain(const Ring& ring, int lane, int ntiles,
                                                long long cta_nblk) {
  using F = Fire<EB, true>;
  uint32_t word = 0, val = 0;
  int32_t counter = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int s = Ring::slot(t);
    mbar_wait(ring.loaded + s, Ring::round_parity(t));
    uint4* cells = ring.data(s, lane);
    uint4* signs = ring.aux(s, lane);
    const int nblk = blocks_in_tile(cta_nblk, t);
    for (int b = 0; b < nblk; ++b) {
      uint32_t e[BLOCK_SZ];
      read_block(cells, b, e);
      const uint4 sg = signs[b * GROUP];
      signs[b * GROUP].x = EB == 8 ? val : val >> 16;  // the value above the block
      // the odd rows' signs: << 16 (advance()'s multipliers) at EB 8, as
      // they are at EB 16
      const int sh = EB == 8 ? 0 : 16;
      const int32_t m[BLOCK_SZ / 2] = {(int32_t)sg.x >> sh, (int32_t)sg.y >> sh,
                                       (int32_t)sg.z >> sh, (int32_t)sg.w >> sh};
      const int32_t c = F::template coef<true>(counter);
      const int32_t cm = EB == 8 ? F::multiplier(c) : c;
      uint32_t grad_sum = 0;
#pragma unroll
      for (int r = 0; r < BLOCK_SZ; ++r) {
        // icopysign(err, prev_delta): the error's sign times prev_delta
        if constexpr (EB == 8) {
          if (r & 1) grad_sum = F::advance(word, m[r >> 1], grad_sum);
          word = e[r] = EVEN ? dp2a_su(cm, word, e[r]) : F::advance(word, cm, e[r]);
          val = F::advance(word, F::multiplier(1), val);  // val += the delta
        } else {
          if (r & 1) grad_sum += word * (uint32_t)m[r >> 1];
          word = e[r] = ((uint32_t)__mulhi((int32_t)word, cm) << 18) + e[r];
          val += word;
        }
      }
      write_block(cells, b, e);
      counter = F::next_counter(counter, F::grad_shifted(grad_sum));
    }
    mbar_arrive(ring.chained + s);
  }
}

// XF: the preprocessor's FIRE (one chunk, no state, no fin): raw errors,
// xf_decode_chain, and at EB 8 ChunkLane's parity form.
template <int EB, bool TRUNC, bool XF = false>
__global__ void __launch_bounds__(32 * WARPS)
    fire_decode_kernel(const typename Fire<EB, XF>::errs_t* __restrict__ in,
                       const int32_t* __restrict__ state, int32_t* __restrict__ fin,
                       typename Fire<EB, XF>::narrow_t* __restrict__ out,
                       const long long* __restrict__ first, int nchunks, long long nb,
                       int ndims) {
  using F = Fire<EB, XF>;
  extern __shared__ __align__(16) unsigned char fire_smem[];
  Ring ring(fire_smem);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp != 0 && warp % SCHEDULERS == 0) return;  // spare
  const int helper = helpers_below(warp);
  const ChunkLane cl = XF && EB == 8 ? ChunkLane(nb, ndims, lane)
                                     : ChunkLane(first, nchunks, nb, ndims, lane);
  const int d = cl.d;  // in bounds, live or not
  const bool active = cl.active;
  const long long nrows = cl.nblk * BLOCK_SZ;  // of the lane's chunk
  const int ntiles = (int)((cl.cta_nblk + TILE_BLOCKS - 1) / TILE_BLOCKS);
  const long long row_base = cl.b0 * BLOCK_SZ;

  if (XF && warp == 0) {
    if (EB == 8 && (blockIdx.x & 1) == 0)
      xf_decode_chain<EB, true>(ring, lane, ntiles, cl.cta_nblk);
    else
      xf_decode_chain<EB, false>(ring, lane, ntiles, cl.cta_nblk);
  } else if (warp == 0) {
    // the delta, a multiply-add a row (Fire::advance), written in place of
    // the errors as the word that holds it; the counter once a block; and,
    // off the chain, the running value above each block, so that the
    // finishers' blocks do not depend on each other
    uint32_t word = 0, beyond = 0, val = 0;
    int32_t counter = 0;
    if (state != nullptr && active) {
      const int32_t* st = state + (long long)cl.chunk * 3 * ndims + d;
      const int32_t prev_delta = st[ndims];
      val = (uint32_t)st[0];
      counter = st[2 * ndims];
      word = (uint32_t)prev_delta << EB;
      // a carried delta wider than EB bits (no encoder leaves one): what
      // the word cannot hold, times the first coefficient, joins the
      // first row's addend
      beyond = (uint32_t)(prev_delta - F::delta_of(word)) *
               (uint32_t)F::template coef<TRUNC>(counter);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = Ring::slot(t);
      mbar_wait(ring.loaded + s, Ring::round_parity(t));
      uint4* cells = ring.data(s, lane);
      if (t == 0) cells[0].x += beyond;
      uint4* signs = ring.aux(s, lane);
      const int nblk = blocks_in_tile(cl.cta_nblk, t);
      for (int b = 0; b < nblk; ++b) {
        uint32_t e[BLOCK_SZ];
        read_block(cells, b, e);
        const uint4 sg = signs[b * GROUP];
        signs[b * GROUP].x = val;  // the value above the block
        const int32_t m[BLOCK_SZ / 2] = {(int32_t)sg.x, (int32_t)sg.y, (int32_t)sg.z,
                                         (int32_t)sg.w};
        const int32_t c = F::multiplier(F::template coef<TRUNC>(counter));
        uint32_t grad_sum = 0;
#pragma unroll
        for (int r = 0; r < BLOCK_SZ; ++r) {
          // icopysign(err, prev_delta): the error's sign times prev_delta
          if (r & 1) grad_sum = F::advance(word, m[r >> 1], grad_sum);
          word = e[r] = F::advance(word, c, e[r]);
          val = F::advance(word, F::multiplier(1), val);  // val += the delta
        }
        write_block(cells, b, e);
        counter = F::next_counter(counter, F::grad_shifted(grad_sum));
      }
      mbar_arrive(ring.chained + s);
    }
    if (fin != nullptr && active) {  // one chunk: the carry after it
      fin[d] = (int32_t)(val & F::kMask);
      fin[ndims + d] = F::delta_of(word);
      fin[2 * ndims + d] = counter;
    }
  } else if (helper >= FINISHERS) {
    // a team of TEAM_WARPS warps loads every LOAD_TEAMS-th tile, each warp
    // LOAD_BLOCKS of its blocks
    const int lw = helper - FINISHERS;
    const int b0 = (lw % TEAM_WARPS) * LOAD_BLOCKS;
    for (int t = lw / TEAM_WARPS; t < ntiles; t += LOAD_TEAMS) {
      const int s = Ring::slot(t);
      mbar_wait(ring.free_ + s, Ring::round_parity(t) ^ 1u);
      // rows from the chunk's start; past its end the loads read zeros
      const long long row0 = (long long)t * TILE_ROWS + b0 * BLOCK_SZ;
      const typename F::errs_t* p = in + ((row_base + row0) * ndims + d);
      if ((long long)(t + 1) * TILE_ROWS <= nrows)
        load_errors<EB, true, XF>(p, (uint32_t)ndims, 0, ring.data(s, lane),
                                  ring.aux(s, lane), b0);
      else
        load_errors<EB, false, XF>(p, (uint32_t)ndims, nrows - row0, ring.data(s, lane),
                                   ring.aux(s, lane), b0);
      mbar_arrive(ring.loaded + s);
    }
  } else {
    // values: the running sum of a block's deltas from the value above it,
    // mod 2^EB, every FINISHERS-th block
    const int f = helper;
    for (int t = 0; t < ntiles; ++t) {
      const int s = Ring::slot(t);
      mbar_wait(ring.chained + s, Ring::round_parity(t));
      const uint4* cells = ring.data(s, lane);
      const uint4* above = ring.aux(s, lane);
      // this lane's blocks in the tile: those of its own chunk
      const int nblk = blocks_in_tile(cl.nblk, t);
      typename F::narrow_t* tile_out =
          out + ((row_base + (long long)t * TILE_ROWS) * ndims + d);
      for (int b = f; b < nblk; b += FINISHERS) {
        uint32_t x[BLOCK_SZ];
        read_block(cells, b, x);
        uint32_t val = above[b * GROUP].x;
#pragma unroll
        for (int r = 0; r < BLOCK_SZ; ++r) {
          val += (uint32_t)F::delta_of(x[r]);
          x[r] = val;
        }
        if (active) {
          typename F::narrow_t* o =
              tile_out + (uint32_t)(b * BLOCK_SZ) * (uint32_t)ndims;
#pragma unroll
          for (int r = 0; r < BLOCK_SZ; ++r, o += ndims)
            *o = (typename F::narrow_t)(x[r] & F::kMask);
        }
      }
      mbar_arrive(ring.free_ + s);
    }
  }
}

// ------------------------------------------------- decode in short chunks

// fire_decode_short_kernel<EB, TRUNC>: the chunked decode where a chunk's
// values fit in shared memory whole: a sidecar's default chunk (16 groups,
// 32 blocks) is 16 KB of u8 values at D 64 and 1 KB at D 4, and the 8 MiB
// u8 walk's 512 such chunks are 64 KB an SM, so every chunk of the stream
// is resident in one wave. The ring kernel exists to hide a long chain
// behind its loads; a short chain needs no ring. Its CTAs (512 threads, a
// ring of 98 KB, two a SM) filled and drained their ring around 32 blocks
// and ran about four waves at the 8 MiB u8 walk (0.0455 ms on an H100,
// bound 0.0051).
//   Work unit: a CTA of SHORT_THREADS threads takes `cpc` whole chunks over
//   all D dims (D <= SHORT_MAX_DIMS, so a chunk's errors are one contiguous
//   byte range): one chunk at D >= 32, 32 / D chunks below (a warp of 8
//   chunks at D 4). The CTA's chunk starts go to shared memory first, with
//   a prefix of the 16-byte units each chunk's image takes, so that the
//   stage and the store run over the CTA's units as one list and not chunk
//   by chunk.
//   1. Stage: all threads copy the chunks' errors into shared memory in
//      16-byte loads, STAGE_DEPTH units a thread in flight before the first
//      is used (a first form loaded a chunk's units one round trip after
//      another, chunk after chunk: 0.026 ms at the 8 MiB u8 walk and
//      0.029-0.040 at the 4 MiB walks on an H100, probes/sidecar_probe.py,
//      slower than the ring there), zigzag-decoded on the way (at EB 8 four
//      bytes in a few word operations; at EB 16 the i32 errors narrowed to
//      u16, half the bytes). A chunk's image keeps its bytes' alignment to
//      16 (image byte 0 is the unit of the chunk's first byte); units at the
//      ends of the errors are read a byte at a time.
//   2. Chain: a lane is a (chunk, dim) pair and runs the ring's chain warp
//      recurrence (Fire::advance, one dot product a row at EB 8, a shift and
//      a multiply-add at EB 16; the counter once a block) on its column of
//      the image, the next block's errors loaded while it chains the
//      current one, and writes the values in place. No ring, no mbarrier:
//      the data is resident. A lane chains only its own chunk's blocks;
//      chunks of other lengths in its warp diverge (a sidecar's chunks are
//      of one length but where runs lengthen them, so the lanes are not
//      sorted by length).
//   3. Store: each chunk's values are one byte range of the output; all
//      threads store its whole 16-byte units, the units at its two ends
//      (which a neighbouring chunk shares) a byte at a time.
//   What bounds it: the chain. Its lanes are C x D (1024 warps at the 8
//   MiB u8 walk, about two a scheduler; 512 at the 4 MiB d4 one), each
//   about 100 instructions a block, so they issue and wait more than they
//   compute:
//   about 10k of the 21k cycles a CTA at the 8 MiB u8 walk, beside 8.5k of
//   stage and 1.2k of store (clock64 counters, probes/sidecar_probe.py
//   --variants, on an H100). A pipeline that staged and stored pieces of
//   the chunks beside the chain gained nothing there (the chain took the
//   time the pieces saved).
//   Banks: at D < 32 a warp's lanes read several chunks, a row apart in
//   each. Chunk images step 16 bytes past a multiple of 128, so the 8
//   chunks of a warp at u8 D 4 fall in 8 different bank groups; at a row of
//   4 bytes or less (u8 D <= 2, u16 D 1) 2 or 4 chunks share one. An odd
//   number of words between chunks would free those too, but the stage's
//   16-byte stores need images on 16 bytes.
constexpr int SHORT_MAX_DIMS = 256;           // a chunk's lanes, one a dim
constexpr int SHORT_CHUNK_BYTES = 48 * 1024;  // a chunk's values in shared memory, at most
constexpr int SHORT_LANES = 32;               // a CTA's lanes where chunks are narrow
constexpr int SHORT_MAX_CHUNKS = 32;          // a CTA's chunks: a warp's scan, two a lane
constexpr int SHORT_THREADS = 256;
constexpr int STAGE_DEPTH = 8;                // units a thread loads at once
constexpr int SHORT_BUDGET = 56 * 1024;       // a CTA's shared memory: four a SM
static_assert(SHORT_MAX_DIMS <= SHORT_THREADS, "a lane a dim");
static_assert(SHORT_LANES <= 2 * SHORT_MAX_CHUNKS, "the scan's two chunks a lane");

// The short decode's launch: chunks a CTA, bytes a chunk's image, shared
// memory a CTA (the images, then the chunk starts and unit prefix); cpc 0
// where the longest chunk does not fit.
struct ShortPlan {
  int cpc, slot, smem;
};

ShortPlan short_plan(long long most, int ndims, int elem_bits) {
  ShortPlan p{};
  const long long bytes = most * BLOCK_SZ * ndims * (elem_bits / 8);
  if (ndims > SHORT_MAX_DIMS || bytes > SHORT_CHUNK_BYTES) return p;
  // 15 bytes before the first (its unit's start) and 15 after the last
  p.slot = (int)((bytes + 30 + 127) / 128 * 128 + 16);
  p.cpc = ndims < SHORT_LANES ? SHORT_LANES / ndims : 1;
  if (p.cpc * p.slot > SHORT_BUDGET) p.cpc = SHORT_BUDGET / p.slot;
  p.smem = p.cpc * p.slot + 8 * (SHORT_MAX_CHUNKS + 1) + 4 * (SHORT_MAX_CHUNKS + 1);
  return p;
}

// A word of four zigzag bytes -> their four signed errors, bytewise.
__device__ __forceinline__ uint32_t unzigzag4(uint32_t x) {
  return ((x >> 1) & 0x7f7f7f7fu) ^ ((x & 0x01010101u) * 0xffu);
}

__device__ __forceinline__ uint32_t unzigzag16(uint32_t u) {
  return ((u >> 1) ^ (0u - (u & 1u))) & 0xffffu;
}

template <int EB, bool TRUNC>
__global__ void __launch_bounds__(SHORT_THREADS)
    fire_decode_short_kernel(const typename Fire<EB>::errs_t* __restrict__ in,
                             const int32_t* __restrict__ states,
                             typename Fire<EB>::narrow_t* __restrict__ out,
                             const long long* __restrict__ first, int nchunks, long long nb,
                             int ndims, int cpc, int slot) {
  using F = Fire<EB>;
  using T = typename F::narrow_t;
  constexpr int ES = (int)sizeof(T);
  // values are elements of the (nb * 8, ndims) stream; a unit of the image
  // is 16 bytes: 16 u8 values, or 8 u16 values from 8 i32 errors
  constexpr int PER_UNIT = EB == 8 ? 16 : 8;
  extern __shared__ __align__(16) unsigned char fire_smem[];
  long long* s_e0 = reinterpret_cast<long long*>(fire_smem + cpc * slot);  // [nc + 1]
  int* s_units = reinterpret_cast<int*>(s_e0 + SHORT_MAX_CHUNKS + 1);       // [nc + 1]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c0 = blockIdx.x * cpc;
  const int nc = nchunks - c0 < cpc ? nchunks - c0 : cpc;
  const long long total = nb * BLOCK_SZ * ndims;
  const long long row = (long long)BLOCK_SZ * ndims;  // elements a block

  // 0. The chunks' first elements, and the units of the images before each:
  // image byte 0 of chunk cl is unit a(cl) = its first element rounded
  // down to PER_UNIT elements (EB 16: the first element itself, which lies
  // on a unit: first * 8 * ndims * 2 bytes).
  if (tid <= nc) s_e0[tid] = first[c0 + tid] * row;
  __syncthreads();
  if (tid < 32) {  // a warp's scan, two chunks a lane
    auto units = [&](int cl) {
      return cl < nc ? (int)((s_e0[cl + 1] - s_e0[cl] / PER_UNIT * PER_UNIT + PER_UNIT - 1) /
                             PER_UNIT)
                     : 0;
    };
    const int a = units(2 * tid), b = units(2 * tid + 1);
    int incl = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += t;
    }
    const int excl = incl - a - b;
    if (2 * tid <= nc) s_units[2 * tid] = excl;
    if (2 * tid + 1 <= nc) s_units[2 * tid + 1] = excl + a;
  }
  __syncthreads();
  const int nunits = s_units[nc];
  // the chunk of the CTA's unit u
  auto chunk_of = [&](int u) {
    int lo = 0, hi = nc;  // s_units[lo] <= u < s_units[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_units[mid] <= u) lo = mid; else hi = mid;
    }
    return lo;
  };

  // 1. Stage, STAGE_DEPTH units a thread in flight.
  for (int u0 = tid; u0 < nunits; u0 += STAGE_DEPTH * nt) {
    uint4 v[STAGE_DEPTH][EB == 8 ? 1 : 2];
    int at[STAGE_DEPTH];  // the unit's byte in shared memory, or -1
#pragma unroll
    for (int k = 0; k < STAGE_DEPTH; ++k) {
      const int u = u0 + k * nt;
      at[k] = -1;
      if (u < nunits) {
        const int cl = chunk_of(u);
        const int ul = u - s_units[cl];
        const long long g = s_e0[cl] / PER_UNIT * PER_UNIT + (long long)ul * PER_UNIT;
        at[k] = cl * slot + 16 * ul;
        if constexpr (EB == 8) {
          if (g + 16 <= total) {
            v[k][0] = *reinterpret_cast<const uint4*>(in + g);
          } else {  // the stream's last unit: bytes past its end read as 0
            uint32_t w[4] = {0, 0, 0, 0};
            for (int b = 0; g + b < total; ++b) w[b >> 2] |= (uint32_t)in[g + b] << (8 * (b & 3));
            v[k][0] = make_uint4(w[0], w[1], w[2], w[3]);
          }
        } else {
          v[k][0] = *reinterpret_cast<const uint4*>(in + g);
          v[k][1] = *reinterpret_cast<const uint4*>(in + g + 4);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < STAGE_DEPTH; ++k) {
      if (at[k] < 0) continue;
      uint4* dst = reinterpret_cast<uint4*>(fire_smem + at[k]);
      if constexpr (EB == 8) {
        *dst = make_uint4(unzigzag4(v[k][0].x), unzigzag4(v[k][0].y), unzigzag4(v[k][0].z),
                          unzigzag4(v[k][0].w));
      } else {
        const uint4 lo = v[k][0], hi = v[k][1];
        *dst = make_uint4(unzigzag16(lo.x) | unzigzag16(lo.y) << 16,
                          unzigzag16(lo.z) | unzigzag16(lo.w) << 16,
                          unzigzag16(hi.x) | unzigzag16(hi.y) << 16,
                          unzigzag16(hi.z) | unzigzag16(hi.w) << 16);
      }
    }
  }
  __syncthreads();

  // 2. Chain: lane (chunk cl, dim d) over its chunk's blocks, two buffers of
  // errors in turn.
  if (tid < nc * ndims) {
    const int cl = tid / ndims, d = tid - cl * ndims;
    const long long e0 = s_e0[cl];
    const long long nblk = (s_e0[cl + 1] - e0) / row;
    T* p = reinterpret_cast<T*>(fire_smem + cl * slot) + (e0 % PER_UNIT) + d;
    const int32_t* st = states + (long long)(c0 + cl) * 3 * ndims + d;
    const int32_t prev_delta = st[ndims];
    uint32_t val = (uint32_t)st[0];
    int32_t counter = st[2 * ndims];
    uint32_t word = (uint32_t)prev_delta << EB;
    // a carried delta wider than EB bits (no encoder leaves one): what the
    // word cannot hold, times the first coefficient, joins the first addend
    uint32_t extra =
        (uint32_t)(prev_delta - F::delta_of(word)) * (uint32_t)F::template coef<TRUNC>(counter);
    // a block's rows' offsets, warp-uniform: each access is a register
    // plus a uniform register, with no address arithmetic of its own
    uint32_t row_off[BLOCK_SZ];
#pragma unroll
    for (int r = 0; r < BLOCK_SZ; ++r) row_off[r] = (uint32_t)(r * ndims);
    const uint32_t step = (uint32_t)ndims;
    auto load_block = [&](uint32_t (&e)[BLOCK_SZ], const T* q) {
#pragma unroll
      for (int r = 0; r < BLOCK_SZ; ++r) e[r] = q[row_off[r]];
    };
    // one block from its errors e, the values in place at q
    auto chain_block = [&](const uint32_t (&e)[BLOCK_SZ], T* q) {
      const int32_t cm = F::multiplier(F::template coef<TRUNC>(counter));
      uint32_t grad_sum = 0;
#pragma unroll
      for (int r = 0; r < BLOCK_SZ; ++r) {
        if (r & 1) {  // icopysign(err, prev_delta): the error's sign times prev_delta
          const int32_t err = sext<EB>(e[r]);
          const int32_t m = err == 0 ? 0 : (err < 0 ? (int32_t)0xffff0000u : 0x00010000);
          grad_sum = F::advance(word, m, grad_sum);
        }
        word = F::advance(word, cm, r == 0 ? (e[0] << EB) + extra : e[r] << EB);
        val = F::advance(word, F::multiplier(1), val);  // val += the delta
        q[row_off[r]] = (T)val;
      }
      extra = 0;
      counter = F::next_counter(counter, F::grad_shifted(grad_sum));
    };
    uint32_t ea[BLOCK_SZ], eb[BLOCK_SZ];
    if (nblk > 0) load_block(ea, p);
    for (long long b = 0; b < nblk; b += 2) {
      T* q = p + b * BLOCK_SZ * step;
      if (b + 1 < nblk) load_block(eb, q + BLOCK_SZ * step);
      chain_block(ea, q);
      if (b + 1 >= nblk) break;
      if (b + 2 < nblk) load_block(ea, q + 2 * BLOCK_SZ * step);
      chain_block(eb, q + BLOCK_SZ * step);
    }
  }
  __syncthreads();

  // 3. Store: unit u of chunk cl's image is out's bytes from its image's
  // first byte, lo & ~15 (its values are out's bytes [lo, hi)).
  unsigned char* out8 = reinterpret_cast<unsigned char*>(out);
  for (int u = tid; u < nunits; u += nt) {
    const int cl = chunk_of(u);
    const int ul = u - s_units[cl];
    const long long lo = s_e0[cl] * ES, hi = s_e0[cl + 1] * ES;
    const long long g = (lo & ~15LL) + 16LL * ul;
    const unsigned char* img = fire_smem + cl * slot + 16 * ul;
    if (g >= lo && g + 16 <= hi) {
      *reinterpret_cast<uint4*>(out8 + g) = *reinterpret_cast<const uint4*>(img);
    } else {
      for (int k = 0; k < 16; ++k) {
        if (g + k >= lo && g + k < hi) out8[g + k] = img[k];
      }
    }
  }
}

// One warp's loop of dependent integer multiply-adds (`paired`: each
// followed by the arithmetic shift that decode's chain has at EB 16):
// cycles and nanoseconds for `iters` steps, from the SM's clock and the
// card's global timer. The chain bound of the kernels above is counted in
// these.
__global__ void chain_probe_kernel(uint32_t a, uint32_t b, long long iters,
                                   int paired, unsigned long long* out) {
  uint32_t x = threadIdx.x;
  const unsigned long long ns0 = global_ns();
  const long long c0 = clock64();
  if (paired) {
    for (long long i = 0; i < iters; i += 16) {
#pragma unroll
      for (int k = 0; k < 16; ++k) x = (uint32_t)((int32_t)(x * a + b) >> 16);
    }
  } else {
    for (long long i = 0; i < iters; i += 16) {
#pragma unroll
      for (int k = 0; k < 16; ++k) x = x * a + b;
    }
  }
  const long long c1 = clock64();
  const unsigned long long ns1 = global_ns();
  if (threadIdx.x == 0) {
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = ns1 - ns0;
  }
  if (x == 0x9e3779b9u) out[2] = x;  // keeps the loop
}

template <typename Kernel>
cudaError_t allow_ring(Kernel kernel, int bytes = SMEM_BYTES) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int EB, bool TRUNC, bool STATES, bool XF = false>
cudaError_t launch_encode(const void* in, void* out, int32_t* states, const int32_t* init,
                          int32_t* fin, long long nb, int ndims, cudaStream_t s) {
  const unsigned groups = (unsigned)((ndims + GROUP - 1) / GROUP);
  const cudaError_t err = allow_ring(fire_encode_kernel<EB, TRUNC, STATES, XF>);
  if (err != cudaSuccess) return err;
  fire_encode_kernel<EB, TRUNC, STATES, XF><<<groups, 32 * WARPS, SMEM_BYTES, s>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), states, init, fin, nb,
      ndims);
  return cudaGetLastError();
}

template <int EB, bool TRUNC, bool XF = false>
cudaError_t launch_decode(const void* in, const int32_t* state, int32_t* fin, void* out,
                          const long long* first, int nchunks, long long nb, int ndims,
                          cudaStream_t s) {
  using F = Fire<EB, XF>;
  const int per = ndims < GROUP ? ndims : GROUP;
  // XF at EB 8: a CTA of 32 dims of one parity from each 64 (ChunkLane),
  // none where a parity has no dim
  const long long ctas =
      XF && EB == 8
          ? 2LL * (ndims / 64) + (ndims % 64 < 2 ? ndims % 64 : 2)
          : (long long)((nchunks + GROUP / per - 1) / (GROUP / per)) * ((ndims + per - 1) / per);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = allow_ring(fire_decode_kernel<EB, TRUNC, XF>);
  if (err != cudaSuccess) return err;
  fire_decode_kernel<EB, TRUNC, XF><<<(unsigned)ctas, 32 * WARPS, SMEM_BYTES, s>>>(
      static_cast<const typename F::errs_t*>(in), state, fin,
      static_cast<typename F::narrow_t*>(out), first, nchunks, nb, ndims);
  return cudaGetLastError();
}

template <int EB, bool TRUNC>
cudaError_t launch_short(const void* in, const int32_t* states, void* out,
                         const long long* first, int nchunks, const ShortPlan& p, long long nb,
                         int ndims, cudaStream_t s) {
  using F = Fire<EB>;
  const cudaError_t err = allow_ring(fire_decode_short_kernel<EB, TRUNC>, p.smem);
  if (err != cudaSuccess) return err;
  const unsigned ctas = (unsigned)((nchunks + p.cpc - 1) / p.cpc);
  fire_decode_short_kernel<EB, TRUNC><<<ctas, SHORT_THREADS, p.smem, s>>>(
      static_cast<const typename F::errs_t*>(in), states, static_cast<typename F::narrow_t*>(out),
      first, nchunks, nb, ndims, p.cpc, p.slot);
  return cudaGetLastError();
}

// sprintz_fire_scan's modes: the lowdim layout's full coefficient, the
// row-major layout's truncated one, the preprocessor's FIRE (XF)
constexpr int MODE_FULL = 0, MODE_TRUNC = 1, MODE_TRANSFORM = 2;

// state: decode's chunk states, or the serial scans' init carry (one chunk)
template <int EB>
cudaError_t launch(const void* in, const int32_t* state, int32_t* fin, void* out,
                   int32_t* states, const long long* first, int nchunks, long long nb,
                   int ndims, int decode, int trunc, cudaStream_t s) {
  if (trunc == MODE_TRANSFORM) {  // one chunk from the zero state
    if (state || fin || states || first) return cudaErrorInvalidValue;
    return decode ? launch_decode<EB, true, true>(in, nullptr, nullptr, out, nullptr, 1, nb,
                                                  ndims, s)
                  : launch_encode<EB, true, false, true>(in, out, nullptr, nullptr, nullptr, nb,
                                                         ndims, s);
  }
  if (trunc != MODE_FULL && trunc != MODE_TRUNC) return cudaErrorInvalidValue;
  if (decode)
    return trunc ? launch_decode<EB, true>(in, state, fin, out, first, nchunks, nb, ndims, s)
                 : launch_decode<EB, false>(in, state, fin, out, first, nchunks, nb, ndims, s);
  if (states)
    return trunc ? launch_encode<EB, true, true>(in, out, states, state, fin, nb, ndims, s)
                 : launch_encode<EB, false, true>(in, out, states, state, fin, nb, ndims, s);
  return trunc ? launch_encode<EB, true, false>(in, out, nullptr, state, fin, nb, ndims, s)
               : launch_encode<EB, false, false>(in, out, nullptr, state, fin, nb, ndims, s);
}

}  // namespace

extern "C" {

// The serial scans. encode (decode == 0): in (nb * 8, ndims) i32 values,
// out i32 zigzag errors; states null, or (nb, ndims, 4) i32, 16-byte
// aligned, whose words 0-2 receive the carry before each block. decode
// (decode != 0): in (nb * 8, ndims) zigzag errors, u8 at elem_bits 8 and
// i32 at 16, out u8/u16 values; states null. Both: init (3, ndims) i32,
// the carry entering the first block (prev value, prev delta, counter), or
// null (zeros); fin (3, ndims) i32, which receives the carry after the
// last block, or null. trunc, the mode: 1 (MODE_TRUNC) the row-major
// layout's truncated int16 coefficient, 0 (MODE_FULL) the lowdim layout's
// full one, 2 (MODE_TRANSFORM) the preprocessor's FIRE: encode writes raw
// errors (err & mask) as i32, decode reads the raw errors as stored, u8 or
// u16; init, fin and states must be null.
int sprintz_fire_scan(void* in, void* init, void* fin, void* states, void* out, long long nb,
                      int ndims, int elem_bits, int decode, int trunc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ini = static_cast<const int32_t*>(init);
  int32_t* f = static_cast<int32_t*>(fin);
  int32_t* st = static_cast<int32_t*>(states);
  if (nb < 1 || nb > MAX_BLOCKS || ndims < 1 || ndims > MAX_NDIMS || (decode && st))
    return (int)cudaErrorInvalidValue;
  if (elem_bits == 8)
    return (int)launch<8>(in, ini, f, out, st, nullptr, 1, nb, ndims, decode, trunc, s);
  if (elem_bits == 16)
    return (int)launch<16>(in, ini, f, out, st, nullptr, 1, nb, ndims, decode, trunc, s);
  return (int)cudaErrorInvalidValue;
}

// The chunked decode on the ring kernel: in and out as sprintz_fire_scan's
// decode; first (nchunks + 1) i64 block indices on the device, first[0] =
// 0, rising, and first[nchunks] = nb; states (nchunks, 3, ndims) i32,
// chunk c's state before its first block.
int sprintz_fire_decode_chunks(void* in, void* states, void* first, int nchunks, void* out,
                               long long nb, int ndims, int elem_bits, int trunc,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* st = static_cast<const int32_t*>(states);
  const long long* f = static_cast<const long long*>(first);
  if (nb < 1 || nb > MAX_BLOCKS || ndims < 1 || ndims > MAX_NDIMS || nchunks < 1 ||
      st == nullptr || f == nullptr)
    return (int)cudaErrorInvalidValue;
  if (elem_bits == 8)
    return (int)launch<8>(in, st, nullptr, out, nullptr, f, nchunks, nb, ndims, 1, trunc, s);
  if (elem_bits == 16)
    return (int)launch<16>(in, st, nullptr, out, nullptr, f, nchunks, nb, ndims, 1, trunc, s);
  return (int)cudaErrorInvalidValue;
}

// The chunked decode on the short-chunk kernel, with sprintz_fire_decode_chunks'
// arguments and most, the blocks of the longest chunk: most * 8 * ndims
// values of elem_bits must fit in SHORT_CHUNK_BYTES and ndims in
// SHORT_MAX_DIMS (else cudaErrorInvalidValue: the ring kernel's case). in,
// out and first 16-byte aligned.
int sprintz_fire_decode_short(void* in, void* states, void* first, int nchunks, long long most,
                              void* out, long long nb, int ndims, int elem_bits, int trunc,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* st = static_cast<const int32_t*>(states);
  const long long* f = static_cast<const long long*>(first);
  const ShortPlan p = short_plan(most, ndims, elem_bits);
  if (nb < 1 || nb > MAX_BLOCKS || ndims < 1 || nchunks < 1 || most < 0 || most > nb ||
      (trunc != MODE_FULL && trunc != MODE_TRUNC) ||
      st == nullptr || f == nullptr || p.cpc < 1 || ((uintptr_t)in | (uintptr_t)out) & 15)
    return (int)cudaErrorInvalidValue;
  if (elem_bits == 8)
    return (int)(trunc ? launch_short<8, true>(in, st, out, f, nchunks, p, nb, ndims, s)
                       : launch_short<8, false>(in, st, out, f, nchunks, p, nb, ndims, s));
  if (elem_bits == 16)
    return (int)(trunc ? launch_short<16, true>(in, st, out, f, nchunks, p, nb, ndims, s)
                       : launch_short<16, false>(in, st, out, f, nchunks, p, nb, ndims, s));
  return (int)cudaErrorInvalidValue;
}

// One warp runs `iters` (a multiple of 16) dependent integer multiply-adds,
// each followed by a shift if `paired`; out[0] = SM cycles, out[1] =
// nanoseconds (device u64 x 3).
int sprintz_fire_chain_probe(void* out, long long iters, int paired, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      0x9e3779b1u, 0x7f4a7c15u, iters, paired,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
