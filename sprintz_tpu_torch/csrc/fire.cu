// FIRE (xff) forecaster scan for Hopper (sm_90a), bound with ctypes.
//
// fire_encode_kernel<EB, TRUNC>, fire_decode_kernel<EB, TRUNC>
//   Replace the lax.scan of sprintz_tpu/models/forecasters.py:_fire_scan
//   (forecasters.py:303-339) over _fire_block_step (:247-300). TRUNC is
//   truncate_coeffs: true for the row-major layout's int16 coefficient
//   (the counter's bits above eb - 4, forecasters.py:234-238), false for
//   the lowdim layout's full-precision one (counter >> 1, :239-240). JAX
//   runs this pass outside Pallas; there is no TPU kernel behind it.
//   Encode: rows (N, D) i32 unsigned values -> zigzag errors (N, D) i32.
//   Decode: zigzag errors (N, D), u8 at EB 8 (K4's narrow mode) or i32 at
//   EB 16 -> values (N, D) u8/u16, from an optional (3, D) i32 init state
//   (prev value, prev delta, learning counter).
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
//   All arithmetic wraps as JAX's int32 does: products and sums are taken
//   in uint32_t and read back as int32_t. That holds for the full-precision
//   coefficient too, which at EB 16 reaches 2^30 (a 32-bit counter >> 1),
//   so that delta * coef wraps: the prediction reads only bits EB to
//   2 EB - 1 of the product, which the low 32 bits hold exactly. At EB 8
//   the full coefficient is an int16 counter >> 1 and still fits the 16-bit
//   half of decode's dot-product multiplier. A chunk-parallel decode from
//   sidecar states is the way past the chain; at D <= 4 (the lowdim layout)
//   one CTA runs 1 to 4 live lanes of it.

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

// ---- mbarriers (PTX)

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

template <int EB>
struct Fire {
  static constexpr int kCounterBits = EB == 8 ? 16 : 32;
  static constexpr int kShft = EB - 4;
  static constexpr uint32_t kMask = (1u << EB) - 1u;
  using narrow_t = typename std::conditional<EB == 8, uint8_t, uint16_t>::type;
  // decode reads u8 (EB 8) or i32 (EB 16) errors
  using errs_t = typename std::conditional<EB == 8, uint8_t, int32_t>::type;

  template <bool TRUNC>
  __device__ static __forceinline__ int32_t coef(int32_t counter) {
    if constexpr (TRUNC) {
      return sext<16>((uint32_t)(counter >> (LEARNING_SHIFT + kShft)) << kShft);
    } else {
      return counter >> LEARNING_SHIFT;
    }
  }
  __device__ static __forceinline__ int32_t prediction(int32_t prev_delta,
                                                        int32_t c) {
    return sext<EB>(
        (uint32_t)((int32_t)((uint32_t)prev_delta * (uint32_t)c) >> EB));
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
// slot t % STAGES; each role passes a slot once a round, so the parity to
// wait for is the round's.
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
  return left < TILE_BLOCKS ? (int)left : TILE_BLOCKS;
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
// them exist; else `left` of them do (none above when has_above is false).
template <int EB, bool FULL>
__device__ __forceinline__ void load_deltas(const int32_t* __restrict__ p,
                                            uint32_t ndims, bool has_above,
                                            long long left, uint4* cells, int b0) {
  int32_t v[LOAD_DEPTH + 1];
  v[0] = has_above && (FULL || left >= 0) ? *(p - ndims) : 0;
#pragma unroll
  for (int j = 0; j < LOAD_DEPTH; ++j)
    v[j + 1] = FULL || j < left ? p[(uint32_t)j * ndims] : 0;
  uint32_t dl[LOAD_DEPTH];
#pragma unroll
  for (int j = 0; j < LOAD_DEPTH; ++j)
    dl[j] = (uint32_t)sext<EB>((uint32_t)v[j + 1] - (uint32_t)v[j]);
#pragma unroll
  for (int q = 0; q < LOAD_BLOCKS; ++q) write_block(cells, b0 + q, dl + q * BLOCK_SZ);
}

template <int EB, bool TRUNC>
__global__ void __launch_bounds__(32 * WARPS)
    fire_encode_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                       long long nb, int ndims) {
  using F = Fire<EB>;
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
    int32_t counter = 0;
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
        coefs[b * GROUP * 4] = c;
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
  } else if (helper >= FINISHERS) {
    // values -> deltas: a team of TEAM_WARPS warps loads every LOAD_TEAMS-th
    // tile, each warp LOAD_BLOCKS of its blocks
    const int lw = helper - FINISHERS;
    const int b0 = (lw % TEAM_WARPS) * LOAD_BLOCKS;
    const int dsafe = active ? d : ndims - 1;  // loads stay in bounds
    for (int t = lw / TEAM_WARPS; t < ntiles; t += LOAD_TEAMS) {
      const int s = Ring::slot(t);
      mbar_wait(ring.free_ + s, Ring::round_parity(t) ^ 1u);
      const long long row0 = (long long)t * TILE_ROWS + b0 * BLOCK_SZ;
      const int32_t* p = in + (row0 * ndims + dsafe);
      if ((long long)(t + 1) * TILE_ROWS <= nrows)
        load_deltas<EB, true>(p, (uint32_t)ndims, row0 > 0, 0, ring.data(s, lane), b0);
      else
        load_deltas<EB, false>(p, (uint32_t)ndims, row0 > 0, nrows - row0,
                               ring.data(s, lane), b0);
      mbar_arrive(ring.loaded + s);
    }
  } else {
    // deltas and the block's coefficient -> zigzag errors, every
    // FINISHERS-th block
    const int f = helper;
    uint32_t halo = 0;  // the delta of the row above the tile
    for (int t = 0; t < ntiles; ++t) {
      const int s = Ring::slot(t);
      mbar_wait(ring.chained + s, Ring::round_parity(t));
      const uint4* cells = ring.data(s, lane);
      const int32_t* coefs = reinterpret_cast<const int32_t*>(ring.aux(s, lane));
      const int nblk = blocks_in_tile(nb, t);
      int32_t* tile_out = out + ((long long)t * TILE_ROWS * ndims + d);
      for (int b = f; b < nblk; b += FINISHERS) {
        const int32_t c = coefs[b * GROUP * 4];
        uint32_t x[BLOCK_SZ];
        read_block(cells, b, x);
        uint32_t prev = b ? cells[(2 * b - 1) * GROUP].w : halo;
        uint32_t zz[BLOCK_SZ];
#pragma unroll
        for (int r = 0; r < BLOCK_SZ; ++r) {
          const int32_t err =
              sext<EB>(x[r] - (uint32_t)F::prediction((int32_t)prev, c));
          zz[r] = (((uint32_t)err << 1) ^ (uint32_t)(err >> 31)) & F::kMask;
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
  }
}

// ------------------------------------------------------------------ decode

// LOAD_DEPTH rows of zigzag errors at p (row stride ndims) -> err << EB,
// the addend of the chain's multiply-add, in LOAD_BLOCKS blocks from block
// b0 of `cells`, and each block's four odd rows' signs << 16, the
// multipliers of its gradient terms, in its cell of `signs`. FULL: all rows
// exist; else `left` of them do.
template <int EB, bool FULL>
__device__ __forceinline__ void load_errors(
    const typename Fire<EB>::errs_t* __restrict__ p, uint32_t ndims, long long left,
    uint4* cells, uint4* signs, int b0) {
  uint32_t u[LOAD_DEPTH];
#pragma unroll
  for (int j = 0; j < LOAD_DEPTH; ++j)
    u[j] = FULL || j < left ? (uint32_t)p[(uint32_t)j * ndims] : 0u;
  uint32_t sg[LOAD_DEPTH / 2];
#pragma unroll
  for (int j = 0; j < LOAD_DEPTH; ++j) {
    const int32_t err = sext<EB>((u[j] >> 1) ^ (0u - (u[j] & 1u)));
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

template <int EB, bool TRUNC>
__global__ void __launch_bounds__(32 * WARPS)
    fire_decode_kernel(const typename Fire<EB>::errs_t* __restrict__ in,
                       const int32_t* __restrict__ state,
                       typename Fire<EB>::narrow_t* __restrict__ out, long long nb,
                       int ndims) {
  using F = Fire<EB>;
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
    // the delta, a multiply-add a row (Fire::advance), written in place of
    // the errors as the word that holds it; the counter once a block; and,
    // off the chain, the running value above each block, so that the
    // finishers' blocks do not depend on each other
    uint32_t word = 0, beyond = 0, val = 0;
    int32_t counter = 0;
    if (state != nullptr && active) {
      const int32_t prev_delta = state[ndims + d];
      val = (uint32_t)state[d];
      counter = state[2 * ndims + d];
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
      const int nblk = blocks_in_tile(nb, t);
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
  } else if (helper >= FINISHERS) {
    // a team of TEAM_WARPS warps loads every LOAD_TEAMS-th tile, each warp
    // LOAD_BLOCKS of its blocks
    const int lw = helper - FINISHERS;
    const int b0 = (lw % TEAM_WARPS) * LOAD_BLOCKS;
    const int dsafe = active ? d : ndims - 1;  // loads stay in bounds
    for (int t = lw / TEAM_WARPS; t < ntiles; t += LOAD_TEAMS) {
      const int s = Ring::slot(t);
      mbar_wait(ring.free_ + s, Ring::round_parity(t) ^ 1u);
      const long long row0 = (long long)t * TILE_ROWS + b0 * BLOCK_SZ;
      const typename F::errs_t* p = in + (row0 * ndims + dsafe);
      if ((long long)(t + 1) * TILE_ROWS <= nrows)
        load_errors<EB, true>(p, (uint32_t)ndims, 0, ring.data(s, lane),
                              ring.aux(s, lane), b0);
      else
        load_errors<EB, false>(p, (uint32_t)ndims, nrows - row0, ring.data(s, lane),
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
      const int nblk = blocks_in_tile(nb, t);
      typename F::narrow_t* tile_out = out + ((long long)t * TILE_ROWS * ndims + d);
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

// One warp's loop of dependent integer multiply-adds (`paired`: each
// followed by the arithmetic shift that decode's chain has at EB 16):
// cycles and nanoseconds for `iters` steps, from the SM's clock and the
// card's global timer. The chain bound of the kernels above is counted in
// these.
__global__ void chain_probe_kernel(uint32_t a, uint32_t b, long long iters,
                                   int paired, unsigned long long* out) {
  uint32_t x = threadIdx.x;
  unsigned long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
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
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  if (threadIdx.x == 0) {
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = ns1 - ns0;
  }
  if (x == 0x9e3779b9u) out[2] = x;  // keeps the loop
}

template <typename Kernel>
cudaError_t allow_ring(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

template <int EB, bool TRUNC>
cudaError_t launch_scan(const void* in, const int32_t* state, void* out, long long nb,
                        int ndims, int decode, cudaStream_t s) {
  using F = Fire<EB>;
  const unsigned groups = (unsigned)((ndims + GROUP - 1) / GROUP);
  if (decode) {
    const cudaError_t err = allow_ring(fire_decode_kernel<EB, TRUNC>);
    if (err != cudaSuccess) return err;
    fire_decode_kernel<EB, TRUNC><<<groups, 32 * WARPS, SMEM_BYTES, s>>>(
        static_cast<const typename F::errs_t*>(in), state,
        static_cast<typename F::narrow_t*>(out), nb, ndims);
  } else {
    const cudaError_t err = allow_ring(fire_encode_kernel<EB, TRUNC>);
    if (err != cudaSuccess) return err;
    fire_encode_kernel<EB, TRUNC><<<groups, 32 * WARPS, SMEM_BYTES, s>>>(
        static_cast<const int32_t*>(in), static_cast<int32_t*>(out), nb, ndims);
  }
  return cudaGetLastError();
}

template <int EB>
cudaError_t launch(const void* in, const int32_t* state, void* out, long long nb,
                   int ndims, int decode, int trunc, cudaStream_t s) {
  return trunc ? launch_scan<EB, true>(in, state, out, nb, ndims, decode, s)
               : launch_scan<EB, false>(in, state, out, nb, ndims, decode, s);
}

}  // namespace

extern "C" {

// encode (decode == 0): in (nb * 8, ndims) i32 values, out i32 zigzag errors,
// from the zero state. decode (decode != 0): in (nb * 8, ndims) zigzag
// errors, u8 at elem_bits 8 and i32 at 16, out u8/u16 values; state
// (3, ndims) i32 or null (zeros). trunc != 0: the row-major layout's
// truncated int16 coefficient; trunc == 0: the lowdim layout's full one.
int sprintz_fire_scan(const void* in, const void* state, void* out, long long nb,
                      int ndims, int elem_bits, int decode, int trunc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* st = static_cast<const int32_t*>(state);
  if (nb < 1 || nb > MAX_BLOCKS || ndims < 1 || ndims > MAX_NDIMS)
    return (int)cudaErrorInvalidValue;
  if (elem_bits == 8) return (int)launch<8>(in, st, out, nb, ndims, decode, trunc, s);
  if (elem_bits == 16) return (int)launch<16>(in, st, out, nb, ndims, decode, trunc, s);
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
