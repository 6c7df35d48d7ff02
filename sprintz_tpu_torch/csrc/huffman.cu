// Chunk-parallel canonical Huffman kernels for Hopper (sm_90a), bound with
// ctypes: the per-symbol passes of the +Huf entropy stage.
//
// huff_decode_kernel  (K6)
//   Replaces sprintz_tpu/entropy/pallas_huffman.py:_decode_kernel
//   (decode_device_pallas, with its fused permutation, FUSE_PERM=1) and the
//   XLA scan it stands in for (huffman.py:653-717). For each symbol:
//   v = rev12(the next 12 bits, LSB first); L = 1 + #{limits <= v};
//   idx = clip((v >> (12 - L)) + adj[L], 0, 255); symbol = perm[idx]; the
//   bit cursor advances by L. A chunk's bytes past its size read as zero,
//   the rule of the TPU version's spare zero word (huffman.py:517). New
//   beside the TPU version: a chunk whose cursor, after its own symbols,
//   lies past its payload is counted (the native host decoder's overrun
//   check, native/sprintz_host.cpp:711).
//   Bound on this card: bytes (each payload byte read once, one byte
//   written a symbol); in practice each chunk's serial bit cursor, which
//   the design cuts into pieces.
//   Design: a CTA of 128 threads takes an even share of the chunks (4096
//   symbols or more, no more CTAs than the card holds) and walks it a
//   window at a time. A window is 128 segments, each 512 bits of one chunk
//   (a chunk's last one shorter): a chunk of 128 symbols is one or two
//   segments, one of 4096 symbols some 8, one longer than a window spans
//   windows, so every chunk size takes the same path. Its payload (8 KB)
//   comes into shared memory in 16-byte loads, a pad word after each
//   segment's words so that lanes reading their own segments hit
//   different banks. Each thread decodes one segment through a
//   4096-entry peek table (symbol | length << 8, built in the prologue by
//   the formula above, so that it equals it for every peek): from the
//   chunk's start, exact; from the window's carried boundary, exact;
//   elsewhere speculatively, from 128 bits before the segment (not before
//   its chunk), to the first boundary at or past its end. Then, until no
//   exit changes, a segment whose start is not its predecessor's exit
//   decodes again from that exit; at worst the rounds walk the chunk
//   serially, so the result is always exact (Weissenberger and Schmidt,
//   ICPP 2018). Codes of 7-8 bits resynchronise slowly, hence the long
//   segments and the warm-up: one round (the check) settles most windows.
//   A segmented scan of the counts gives each symbol its index in its
//   chunk; symbols at or past the chunk's count (its zero padding's) are
//   dropped. A chunk's last segment decodes exactly the rest of its count,
//   reading zeros past its payload, and its end tells the overrun.
//   Symbols go to a shared-memory image of the window's output (a pad
//   word after every 128 bytes), which leaves in 16-byte stores (a byte at
//   a time at its two ends; symbols past the image's 12288, only where
//   codes average under about 5 bits, go out directly).
//   The container format is fixed: no gap array helps the speculation.
//
// huff_encode_sizes_kernel, huff_encode_emit_kernel
//   Replace the XLA append scan of sprintz_tpu/entropy/huffman.py:736-808
//   (encode_device; no Pallas kernel behind it), whose function is the
//   chunk payloads and sizes of _huff_compress_host (huffman.py:310-346):
//   each chunk's payload is the LSB-first concatenation of its symbols'
//   canonical codes, zero-padded to a byte. Pass 1 sums each chunk's code
//   lengths into its byte size; the wrapper's cumsum of the sizes gives
//   each chunk's end; pass 2 places every code at its bit and writes each
//   payload byte once.
//   Bound on this card: bytes (one symbol byte read a pass, under 1.5
//   bytes written a symbol).
//   Design: a CTA codes a tile of whole chunks, about 4096 symbols (one
//   chunk where chunks are longer), so chunk size 128 and 4096 share one
//   formulation. Each thread takes a run of 16 consecutive symbols a
//   16-byte load (neighbouring lanes on neighbouring addresses), looks
//   their codes and lengths up once in a shared table and keeps them in
//   registers for both walks of a pass, and sums the run's bits since its
//   last chunk start. A segmented scan across the CTA (warp shuffles, then
//   the 8 warps' sums) gives each run the bits of its chunk before it.
//   Where cs % 16 == 0 (GROUPED) chunks start and end only at the edges of
//   a group of 16 symbols, so the walks test for them once a group, and
//   pass 1 needs no second walk where a run is one group: the run lies in
//   one chunk. Pass 1 writes a chunk's size where its last symbol lies. Pass 2 has its own bit
//   offset for every symbol: each run appends its codes to a 64-bit
//   accumulator in registers and moves them out a 32-bit word at a time
//   into a zeroed shared-memory image of the tile's payload, with atomicOr
//   at the run's two end words (which a neighbour run may share) and a
//   plain store between them. The image leaves in 16-byte stores; the
//   partial 16-byte pieces at the tile's ends leave a byte at a time. One
//   writer a byte, and no host read between the passes: the wrapper
//   allocates the payload at its bound and reads the total afterwards.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_CODE_LEN = 12;

// ------------------------------------------------------------------ K6

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_SEG_BITS = 512;  // a segment: 512 bits of one chunk
// A speculative segment starts decoding this far before its first bit
// (not before its chunk's start), so that it has most often found the
// true code boundaries by then.
constexpr int DEC_WARM_BITS = 128;
constexpr int DEC_WINDOW = DEC_THREADS;  // segments a window, one a thread
// The payload a window stages: its segments' bytes, up to 15 below them to
// the 16-byte boundary, and the bytes that the exit of its last segment
// peeks past that segment's end (under 3).
constexpr int DEC_STAGE_UNITS = DEC_WINDOW * DEC_SEG_BITS / 128 + 2;
constexpr int DEC_STAGE_WORDS = DEC_STAGE_UNITS * 4;
// In shared memory a pad word follows every segment's worth of words, so
// that the lanes of a warp, each reading its own segment, DEC_SEG_WORDS
// words from the next, hit different banks.
constexpr int DEC_SEG_WORDS = DEC_SEG_BITS / 32;
constexpr int DEC_STAGE_SLOTS = DEC_STAGE_WORDS + DEC_STAGE_WORDS / DEC_SEG_WORDS + 1;
static_assert(DEC_SEG_WORDS % 4 == 0, "a segment holds whole 16-byte units");
__device__ __forceinline__ int stage_slot(int k) { return k + k / DEC_SEG_WORDS; }
constexpr int DEC_OUT_CAP = 12288;  // symbols a window stages; more go out directly
// The staged symbols: a pad word after every 128 bytes, so that lanes
// placing symbols cs = 128 (or a multiple) bytes apart hit different banks.
constexpr int DEC_OUT_WORDS = ((DEC_OUT_CAP + 16) / 128 + 1) * 33;
__device__ __forceinline__ int out_slot(int r) { return r + 4 * (r >> 7); }
constexpr int DEC_TILE_SYMBOLS = 4096;  // the least symbols a CTA takes
constexpr int DEC_NO_LIMIT = 0x7fffffff;

struct DecShared {
  uint16_t tab[1 << MAX_CODE_LEN];  // peek -> symbol | length << 8
  uint32_t stage[DEC_STAGE_SLOTS];  // the window's payload, padded
  uint32_t out[DEC_OUT_WORDS];      // the window's symbols, padded
  int64_t wc_off[DEC_WINDOW];       // the window's chunks: payload offset,
  int64_t wc_last[DEC_WINDOW];      //   last slot,
  int wc_size[DEC_WINDOW];          //   bytes,
  int wc_count[DEC_WINDOW];         //   symbols,
  int wc_sbeg[DEC_WINDOW];          //   first segment in the window
  int seg_exit[DEC_WINDOW];         // each segment's exit bit
  int warp_a[DEC_WARPS], warp_b[DEC_WARPS];
  int lim[MAX_CODE_LEN - 1], adj[MAX_CODE_LEN + 1];
  // the window's state, from one thread to all
  int64_t next_chunk, next_slot, carry_exit, o_end;
  int nwin_chunks, carry_cnt;
};

// Word k of the staged payload, zero at and past staged bit `end`.
__device__ __forceinline__ uint32_t stage_word(const uint32_t* st, int k, int end) {
  const int lo = k * 32;
  if (k < 0 || lo >= end) return 0u;
  const uint32_t w = st[stage_slot(k)];
  const int keep = end - lo;
  return keep >= 32 ? w : (w & ((1u << keep) - 1u));
}

// The staged payload read a code at a time from bit p: a 64-bit buffer
// refilled a word at a time whenever it holds fewer than 12 bits.
struct BitReader {
  const uint32_t* st;
  int end;
  int k;
  uint64_t buf;
  int nb;
  __device__ __forceinline__ BitReader(const uint32_t* st_, int end_, int p)
      : st(st_), end(end_), k((p >> 5) + 1),
        buf(stage_word(st_, p >> 5, end_) >> (p & 31)), nb(32 - (p & 31)) {}
  // The next code's table entry (symbol | length << 8); steps past it.
  __device__ __forceinline__ uint32_t next(const uint16_t* tab) {
    if (nb < MAX_CODE_LEN) {
      buf |= (uint64_t)stage_word(st, k++, end) << nb;
      nb += 32;
    }
    const uint32_t e = tab[buf & 0xFFFu];
    buf >>= e >> 8;
    nb -= (int)(e >> 8);
    return e;
  }
};

// Decodes from staged bit p while p < stop and fewer than max_cnt symbols
// are out, calling put(i, symbol) for the i-th; returns the bit after the
// last code and the count in cnt. Bits at and past `end` read as zero.
template <typename F>
__device__ __forceinline__ int decode_run(const uint32_t* st, const uint16_t* tab, int p,
                                          int stop, int max_cnt, int end, int& cnt,
                                          F&& put) {
  BitReader r(st, end, p);
  cnt = 0;
  while (p < stop && cnt < max_cnt) {
    const uint32_t e = r.next(tab);
    put(cnt, (uint8_t)e);
    p += (int)(e >> 8);
    ++cnt;
  }
  return p;
}

// Exclusive segmented scan of v across the CTA: the sum of v over the
// threads from the last one at or before this one whose f is set, up to
// this one, this one excluded (0 where this one's f is set). All threads
// call it.
__device__ __forceinline__ int seg_scan_excl(int f, int v, int* wa, int* wb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int fi = f, vi = v;  // inclusive
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int fo = __shfl_up_sync(0xffffffffu, fi, o);
    const int vo = __shfl_up_sync(0xffffffffu, vi, o);
    if (lane >= o && !fi) {
      vi += vo;
      fi |= fo;
    }
  }
  if (lane == 31) {
    wa[warp] = fi;
    wb[warp] = vi;
  }
  __syncthreads();
  int pv = 0;  // the warps before this one, inclusive
  for (int w = 0; w < warp; ++w) pv = wa[w] ? wb[w] : pv + wb[w];
  __syncthreads();  // wa, wb free again
  const int incl = fi ? vi : pv + vi;
  return f ? 0 : incl - v;
}

__global__ void __launch_bounds__(DEC_THREADS)
    huff_decode_kernel(const uint8_t* __restrict__ data, int64_t nbytes,
                       const int64_t* __restrict__ offsets,
                       const int32_t* __restrict__ sizes,
                       const int32_t* __restrict__ limits, const int32_t* __restrict__ adj,
                       const int32_t* __restrict__ perm, uint8_t* __restrict__ out,
                       int32_t* __restrict__ nbad, int cs, int64_t n) {
  __shared__ DecShared sh;
  const int t = threadIdx.x;
  if (t < MAX_CODE_LEN - 1) sh.lim[t] = limits[t];
  if (t < MAX_CODE_LEN + 1) sh.adj[t] = adj[t];
  __syncthreads();
  for (int e = t; e < (1 << MAX_CODE_LEN); e += DEC_THREADS) {
    const int v = (int)(__brev((uint32_t)e) >> 20);
    int len = 1;
#pragma unroll
    for (int l = 0; l < MAX_CODE_LEN - 1; ++l) len += v >= sh.lim[l];
    int idx = (v >> (MAX_CODE_LEN - len)) + sh.adj[len];
    idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
    sh.tab[e] = (uint16_t)((perm[idx] & 0xFF) | (len << 8));
  }
  const uint32_t* st = sh.stage;
  uint8_t* so = reinterpret_cast<uint8_t*>(sh.out);

  // this CTA's chunks: an even share of those that hold symbols
  const int64_t nc = (n + cs - 1) / cs;
  const int64_t c_end = nc * (blockIdx.x + 1) / gridDim.x;
  int64_t cur = nc * blockIdx.x / gridDim.x;  // the window's first chunk,
  int64_t cur_slot = 0;   // its first segment,
  int64_t carry_exit = 0; // where that segment starts, as a chunk bit, and
  int carry_cnt = 0;      // the chunk's symbols before it, where cur_slot > 0
  while (cur < c_end) {
    // (a) the window's chunks, one a thread, and its segments
    const int64_t c = cur + t;
    int nseg = 0, size = 0, count = 0;
    int64_t off = 0, last = 0;
    if (c < c_end) {
      off = offsets[c];
      size = sizes[c];
      count = (int)(n - c * cs < cs ? n - c * cs : cs);
      last = size > 0 ? (8LL * size + DEC_SEG_BITS - 1) / DEC_SEG_BITS - 1 : 0;
      const int64_t segs = last + 1 - (t == 0 ? cur_slot : 0);
      nseg = (int)(segs < DEC_WINDOW + 1 ? segs : DEC_WINDOW + 1);
    }
    const int sbeg = seg_scan_excl(t == 0, nseg, sh.warp_a, sh.warp_b);
    sh.wc_off[t] = off;
    sh.wc_last[t] = last;
    sh.wc_size[t] = size;
    sh.wc_count[t] = count;
    sh.wc_sbeg[t] = sbeg;
    if (nseg > 0 && sbeg <= DEC_WINDOW && sbeg + nseg > DEC_WINDOW) {
      // segment DEC_WINDOW, the next window's first, lies in this chunk
      sh.next_chunk = c;
      sh.next_slot = (t == 0 ? cur_slot : 0) + (DEC_WINDOW - sbeg);
    }
    if (nseg > 0 && (t == DEC_THREADS - 1 || c + 1 == c_end) && sbeg + nseg <= DEC_WINDOW) {
      sh.next_chunk = c + 1;  // the window ends with this chunk
      sh.next_slot = 0;
    }
    if (nseg > 0 && (t == DEC_THREADS - 1 || c + 1 == c_end)) sh.nwin_chunks = t + 1;
    __syncthreads();
    const int nwc = sh.nwin_chunks;
    const int ntot = sh.wc_sbeg[nwc - 1] + (int)(sh.wc_last[nwc - 1] + 1 -
                                                 (nwc == 1 ? cur_slot : 0));
    const int nseg_w = ntot < DEC_WINDOW ? ntot : DEC_WINDOW;

    // (b) this thread's segment: its chunk j and slot
    auto chunk_of = [&](int seg) {  // a binary search of the chunks' first segments
      int jj = 0;
      for (int step = DEC_WINDOW / 2; step > 0; step >>= 1) {
        if (jj + step < nwc && sh.wc_sbeg[jj + step] <= seg) jj += step;
      }
      return jj;
    };
    const int k = t;
    const int j = chunk_of(k);
    const int64_t slot = (j == 0 ? cur_slot : 0) + (k - sh.wc_sbeg[j]);
    const bool active = k < nseg_w;
    const bool is_last = active && slot == sh.wc_last[j];
    const int jsize = sh.wc_size[j];
    const int jcount = sh.wc_count[j];

    // (c) stage the window's payload: 16-byte loads where aligned and
    // inside the container, bytes elsewhere, zeros past its end
    const int64_t lo = sh.wc_off[0] + cur_slot * (DEC_SEG_BITS / 8);
    int64_t hi;
    {
      const int kl = nseg_w - 1;
      const int jl = chunk_of(kl);
      const int64_t sl = (jl == 0 ? cur_slot : 0) + (kl - sh.wc_sbeg[jl]);
      const int64_t slot_end = (sl + 1) * (DEC_SEG_BITS / 8);
      hi = sh.wc_off[jl] + (slot_end < sh.wc_size[jl] ? slot_end : sh.wc_size[jl]) + 3;
    }
    const int64_t lo16 = lo & ~(int64_t)15;
    int units = (int)((hi - lo16 + 15) >> 4);
    units = units < DEC_STAGE_UNITS ? units : DEC_STAGE_UNITS;
    for (int u = t; u < DEC_STAGE_UNITS; u += DEC_THREADS) {
      const int64_t a = lo16 + 16LL * u;
      uint4 q = make_uint4(0, 0, 0, 0);
      if (u < units) {
        if (a + 16 <= nbytes && (reinterpret_cast<uintptr_t>(data + a) & 15) == 0) {
          q = __ldg(reinterpret_cast<const uint4*>(data + a));
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          for (int b = 0; b < 16; ++b) {
            if (a + b < nbytes) w[b >> 2] |= (uint32_t)__ldg(data + a + b) << (8 * (b & 3));
          }
          q = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      uint32_t* dst = sh.stage + stage_slot(4 * u);
      dst[0] = q.x;
      dst[1] = q.y;
      dst[2] = q.z;
      dst[3] = q.w;
    }
    __syncthreads();

    // (d) decode each segment from its start: exact at a chunk's start and
    // at the carried start, speculative elsewhere; the chunk's last
    // segment waits for its quota. Bits past the chunk's payload, or past
    // the staging, read as zero.
    const int64_t cbit64 = (sh.wc_off[j] - lo16) * 8;  // the chunk's bit 0, staged
    const int64_t end64 = cbit64 + 8LL * jsize;
    const int end = (int)(end64 < 32LL * DEC_STAGE_WORDS ? (end64 > 0 ? end64 : 0)
                                                         : 32LL * DEC_STAGE_WORDS);
    const int s0 = (int)(cbit64 + slot * DEC_SEG_BITS);
    const int64_t s1_64 = cbit64 + ((slot + 1) * DEC_SEG_BITS < 8LL * jsize
                                        ? (slot + 1) * DEC_SEG_BITS : 8LL * jsize);
    const int s1 = (int)s1_64;
    const bool carried = k == 0 && cur_slot > 0;
    int start = carried ? (int)(cbit64 + carry_exit) : s0;
    const bool follows = active && slot > 0 && !carried;
    int ex = start, cnt = 0;
    auto drop = [](int, uint8_t) {};
    if (active && !is_last) {
      if (follows) {  // warm up: the first code start at or past s0
        const int64_t w = s0 - DEC_WARM_BITS > cbit64 ? s0 - DEC_WARM_BITS : cbit64;
        start = decode_run(st, sh.tab, (int)w, s0, DEC_NO_LIMIT, end, cnt, drop);
      }
      ex = decode_run(st, sh.tab, start, s1, DEC_NO_LIMIT, end, cnt, drop);
    }
    sh.seg_exit[k] = ex;
    __syncthreads();

    // (e) until no exit changes: a segment whose start is not its
    // predecessor's exit decodes again from that exit
    for (;;) {
      const int prev = follows ? sh.seg_exit[k - 1] : start;
      __syncthreads();
      bool changed = false;
      if (follows && prev != start) {
        start = prev;
        if (!is_last) {
          const int e2 = decode_run(st, sh.tab, start, s1, DEC_NO_LIMIT, end, cnt, drop);
          if (e2 != ex) {
            ex = e2;
            sh.seg_exit[k] = ex;
            changed = true;
          }
        }
      }
      if (!__syncthreads_or(changed)) break;
    }

    // (f) each symbol's index in its chunk, and the chunk's overrun
    const int carry_j = (j == 0 && cur_slot > 0) ? carry_cnt : 0;
    const int before =
        seg_scan_excl(!active || slot == 0 || carried, (active && !is_last) ? cnt : 0,
                      sh.warp_a, sh.warp_b) + carry_j;
    const int64_t o_begin = cur * cs + (cur_slot > 0 ? (carry_cnt < sh.wc_count[0]
                                                            ? carry_cnt
                                                            : sh.wc_count[0])
                                                      : 0);
    // the staged index of the segment's first symbol, the staging's room
    // past it, and the chunk's symbols left
    const int64_t sbase = (cur + j) * cs - o_begin + (o_begin & 15) + before;
    const int64_t room64 = DEC_OUT_CAP + (o_begin & 15) - sbase;
    const int room = room64 < 0 ? 0 : (room64 < DEC_NO_LIMIT ? (int)room64 : DEC_NO_LIMIT);
    const int keep = jcount - before;
    uint8_t* gout = out + (o_begin - (o_begin & 15)) + sbase;
    auto put = [&](int i, uint8_t sym) {
      if (i < room) {
        so[out_slot((int)sbase + i)] = sym;
      } else {
        gout[i] = sym;
      }
    };
    // one loop for both kinds of segment, so that a warp runs them together:
    // a chunk's last segment decodes exactly the rest of its count
    if (active) {
      int got = 0;
      const int p = decode_run(st, sh.tab, start, is_last ? DEC_NO_LIMIT : s1,
                               is_last ? keep : DEC_NO_LIMIT, end, got,
                               [&](int i, uint8_t sym) {
                                 if (i < keep) put(i, sym);
                               });
      if (is_last && keep >= 0 && (int64_t)p - cbit64 > 8LL * jsize) atomicAdd(nbad, 1);
    }
    if (k == nseg_w - 1) {
      const int done = before + cnt;
      sh.o_end = (cur + j) * cs + (is_last ? jcount : (done < jcount ? done : jcount));
      sh.carry_exit = (int64_t)ex - cbit64;
      sh.carry_cnt = done;
    }
    __syncthreads();

    // (g) the staged symbols leave in 16-byte stores where the window owns
    // the whole unit, a byte at a time at its two ends
    const int64_t o_end = sh.o_end;
    const int64_t base = o_begin & ~(int64_t)15;
    const int64_t o_lim = o_end < o_begin + DEC_OUT_CAP ? o_end : o_begin + DEC_OUT_CAP;
    const int nunits = (int)((o_lim - base + 15) >> 4);
    for (int u = t; u < nunits; u += DEC_THREADS) {
      const int64_t a = base + 16LL * u;
      if (a >= o_begin && a + 16 <= o_lim) {
        const uint32_t* w = sh.out + out_slot(16 * u) / 4;
        reinterpret_cast<uint4*>(out)[a >> 4] = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int b = 0; b < 16; ++b) {
          if (a + b >= o_begin && a + b < o_lim) out[a + b] = so[out_slot(16 * u + b)];
        }
      }
    }
    const int64_t nchunk = sh.next_chunk, nslot = sh.next_slot;
    carry_exit = sh.carry_exit;
    carry_cnt = sh.carry_cnt;
    __syncthreads();  // the window's shared state is free again
    cur = nchunk;
    cur_slot = nslot;
  }
}

constexpr int ENC_THREADS = 256;
constexpr int ENC_WARPS = ENC_THREADS / 32;
constexpr int SMEM_DEFAULT = 48 * 1024;  // above it the kernel must opt in
constexpr int SMEM_MAX = 227 * 1024;     // what a CTA may opt in to

// Symbols a thread of the encoder takes: 16 a load, as many loads as its
// share of a tile of tile_chunks chunks of cs symbols needs.
__host__ __device__ inline int enc_run(int cs, int tile_chunks) {
  const long long tile = (long long)cs * tile_chunks;
  return 16 * (int)((tile + 16 * ENC_THREADS - 1) / (16 * ENC_THREADS));
}

// 16-byte units of pass 2's staging image: a tile's payload (12 bits a
// symbol at most, and under a pad byte a chunk) and up to 15 bytes below
// it, to the 16-byte boundary.
__host__ __device__ inline int enc_stage_units(int cs, int tile_chunks) {
  const long long tile = (long long)cs * tile_chunks;
  return (int)(((tile * MAX_CODE_LEN + 7) / 8 + tile_chunks + 15 + 15) / 16);
}

// Pass 2's dynamic shared memory: the image, then each chunk's first bit
// in it.
__host__ __device__ inline long long enc_smem_bytes(int cs, int tile_chunks) {
  return 16LL * enc_stage_units(cs, tile_chunks) + 4LL * tile_chunks;
}

// 16 symbols from stream position p, zeros at and past `end`.
__device__ __forceinline__ uint4 load_syms(const uint8_t* __restrict__ syms,
                                           int64_t p, int64_t end) {
  if (p + 16 <= end && (reinterpret_cast<uintptr_t>(syms + p) & 15) == 0) {
    return __ldg(reinterpret_cast<const uint4*>(syms + p));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (p + k < end) w[k >> 2] |= (uint32_t)__ldg(syms + p + k) << (8 * (k & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int byte_of(const uint4& q, int k) {
  const uint32_t w = k < 4 ? q.x : (k < 8 ? q.y : (k < 12 ? q.z : q.w));
  return (int)((w >> (8 * (k & 3))) & 0xFFu);
}

// A CTA's tile: symbols [s0, s0 + len) = chunks chunk0 onwards; this
// thread's run: tile symbols [lp0, end).
struct EncTile {
  int64_t s0;
  int64_t chunk0;
  int len;
  int lp0;
  int end;
};

__device__ __forceinline__ EncTile enc_tile(int64_t n, int cs, int tile_chunks) {
  EncTile t;
  t.chunk0 = (int64_t)blockIdx.x * tile_chunks;
  t.s0 = t.chunk0 * cs;
  const int64_t left = n - t.s0;
  t.len = (int)(left < (int64_t)cs * tile_chunks ? left : (int64_t)cs * tile_chunks);
  const int run = enc_run(cs, tile_chunks);
  t.lp0 = threadIdx.x * run;
  t.end = t.lp0 + run < t.len ? t.lp0 + run : t.len;
  return t;
}

// The first 16 symbols of this thread's run, loaded before anything
// else.
__device__ __forceinline__ uint4 first_syms(const uint8_t* __restrict__ syms,
                                            const EncTile& t) {
  return t.lp0 < t.end ? load_syms(syms, t.s0 + t.lp0, t.s0 + t.end)
                       : make_uint4(0, 0, 0, 0);
}

// The table: code | length << 16, lengths clamped to 12 and codes to
// their lengths (memory safety only: the staging holds 12 bits a symbol).
// TAB_COPIES copies side by side; a lane reads copy lane % TAB_COPIES.
constexpr int TAB_COPIES = 1;

__device__ __forceinline__ void load_table(uint32_t* s_tab, const int32_t* codes,
                                           const int32_t* lengths) {
  for (int i = threadIdx.x; i < 256 * TAB_COPIES; i += ENC_THREADS) {
    const int t = i / TAB_COPIES;
    int len = lengths[t];
    len = len < 0 ? 0 : (len > MAX_CODE_LEN ? MAX_CODE_LEN : len);
    const uint32_t code = codes ? (uint32_t)codes[t] & ((1u << len) - 1u) : 0u;
    s_tab[i] = code | ((uint32_t)len << 16);
  }
}

// The table entries of 16 symbols.
__device__ __forceinline__ void lookup16(const uint32_t* s_tab, const uint4& q,
                                         uint32_t (&ent)[16]) {
  const int copy = (int)(threadIdx.x % TAB_COPIES);
#pragma unroll
  for (int k = 0; k < 16; ++k) ent[k] = s_tab[byte_of(q, k) * TAB_COPIES + copy];
}

// Calls f(lp, k, entry) for each symbol of this thread's run, in order: lp
// is its index in the tile, k its index in its group of 16 (a constant
// once unrolled). `head`: the entries of the run's first 16, looked up
// once for all walks.
template <typename F>
__device__ __forceinline__ void for_run(const uint8_t* __restrict__ syms,
                                        const EncTile& t, const uint32_t* s_tab,
                                        const uint32_t (&head)[16], F&& f) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (t.lp0 + k < t.end) f(t.lp0 + k, k, head[k]);
  }
  for (int g = t.lp0 + 16; g < t.end; g += 16) {
    uint32_t ent[16];
    lookup16(s_tab, load_syms(syms, t.s0 + g, t.s0 + t.end), ent);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (g + k < t.end) f(g + k, k, ent[k]);
    }
  }
}

// Whether symbol lp (k-th of its group) starts a chunk; `next` is the next
// chunk start at or after it, stepped past lp when it does. GROUPED: cs %
// 16 == 0, so chunks start only at a group's first symbol.
template <bool GROUPED>
__device__ __forceinline__ bool chunk_start(int lp, int k, int cs, int& next) {
  if ((!GROUPED || k == 0) && lp == next) {
    next += cs;
    return true;
  }
  return false;
}

// The run's bits since its last chunk start (or since its first symbol):
// the value of its (has a chunk start, bits) pair in the segmented scan.
template <bool GROUPED>
__device__ __forceinline__ void run_bits(const uint8_t* __restrict__ syms,
                                         const EncTile& t, const uint32_t* s_tab,
                                         const uint32_t (&head)[16], int cs,
                                         int& f, int& v) {
  int next = (t.lp0 + cs - 1) / cs * cs;  // the first chunk start in the run
  f = 0;
  v = 0;
  for_run(syms, t, s_tab, head, [&](int lp, int k, uint32_t e) {
    if (chunk_start<GROUPED>(lp, k, cs, next)) {
      f = 1;
      v = 0;
    }
    v += (int)(e >> 16);
  });
}

// Exclusive segmented scan of the runs' (f, v) across the CTA: the bits of
// this run's first chunk in the runs before it. All threads call it.
__device__ __forceinline__ int seg_scan_carry(int f, int v, int* s_f, int* s_v) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int fo = __shfl_up_sync(0xffffffffu, f, o);
    const int vo = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) {
      if (!f) v += vo;
      f |= fo;
    }
  }
  int fe = __shfl_up_sync(0xffffffffu, f, 1);
  int ve = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) fe = ve = 0;
  if (lane == 31) {
    s_f[warp] = f;
    s_v[warp] = v;
  }
  __syncthreads();
  int pv = 0;
  for (int w = 0; w < warp; ++w) pv = s_f[w] ? s_v[w] : pv + s_v[w];
  return fe ? ve : pv + ve;
}

template <bool GROUPED>
__global__ void __launch_bounds__(ENC_THREADS)
    huff_encode_sizes_kernel(const uint8_t* __restrict__ syms,
                             const int32_t* __restrict__ lengths,
                             int32_t* __restrict__ sizes, int64_t n, int cs,
                             int tile_chunks) {
  __shared__ uint32_t s_tab[256 * TAB_COPIES];
  __shared__ int s_f[ENC_WARPS], s_v[ENC_WARPS];
  const EncTile t = enc_tile(n, cs, tile_chunks);
  const uint4 q = first_syms(syms, t);
  load_table(s_tab, nullptr, lengths);
  __syncthreads();
  uint32_t head[16];
  lookup16(s_tab, q, head);
  int f, v;
  run_bits<GROUPED>(syms, t, s_tab, head, cs, f, v);
  int bits = seg_scan_carry(f, v, s_f, s_v);
  if (GROUPED && enc_run(cs, tile_chunks) == 16) {
    // the run lies in one chunk: its size is known if the chunk ends here
    if (t.lp0 < t.end && (t.end % cs == 0 || t.end == t.len)) {
      sizes[t.chunk0 + t.lp0 / cs] = ((f ? 0 : bits) + v + 7) >> 3;
    }
    return;
  }
  int cl = (t.lp0 + cs - 1) / cs - 1;  // the chunk of the run's first symbol
  int next = (cl + 1) * cs;             // ... when it is not a chunk start
  for_run(syms, t, s_tab, head, [&](int lp, int k, uint32_t e) {
    if (chunk_start<GROUPED>(lp, k, cs, next)) {
      bits = 0;
      ++cl;
    }
    bits += (int)(e >> 16);
    if (((!GROUPED || k == 15) && lp + 1 == next) || lp + 1 == t.len) {
      sizes[t.chunk0 + cl] = (bits + 7) >> 3;
    }
  });
}

template <bool GROUPED>
__global__ void __launch_bounds__(ENC_THREADS)
    huff_encode_emit_kernel(const uint8_t* __restrict__ syms,
                            const int32_t* __restrict__ codes,
                            const int32_t* __restrict__ lengths,
                            const int64_t* __restrict__ ends,
                            const int32_t* __restrict__ sizes,
                            uint8_t* __restrict__ out, int64_t n, int cs,
                            int tile_chunks) {
  extern __shared__ uint4 smem[];
  __shared__ uint32_t s_tab[256 * TAB_COPIES];
  __shared__ int s_f[ENC_WARPS], s_v[ENC_WARPS];
  const EncTile t = enc_tile(n, cs, tile_chunks);
  const uint4 q = first_syms(syms, t);
  load_table(s_tab, codes, lengths);
  const int64_t nchunks = (n + cs - 1) / cs;
  const int nc = (int)(t.chunk0 + tile_chunks < nchunks ? tile_chunks
                                                        : nchunks - t.chunk0);
  const int64_t g0 = ends[t.chunk0] - sizes[t.chunk0];  // the tile's payload
  const int64_t g1 = ends[t.chunk0 + nc - 1];           // bytes [g0, g1)
  const int64_t gbase = g0 & ~(int64_t)15;              // the image's first byte
  const int units = (int)((g1 - gbase + 15) >> 4);
  int* s_bit0 = reinterpret_cast<int*>(smem + enc_stage_units(cs, tile_chunks));
  for (int c = threadIdx.x; c < nc; c += ENC_THREADS) {
    const int64_t c0 = t.chunk0 + c;
    s_bit0[c] = (int)(ends[c0] - sizes[c0] - gbase) * 8;
  }
  for (int i = threadIdx.x; i < units; i += ENC_THREADS) smem[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  uint32_t head[16];
  lookup16(s_tab, q, head);
  int f, v;
  run_bits<GROUPED>(syms, t, s_tab, head, cs, f, v);
  const int carry = seg_scan_carry(f, v, s_f, s_v);  // syncs: the image is zero

  uint32_t* st = reinterpret_cast<uint32_t*>(smem);
  uint64_t acc = 0;  // the codes not yet out, from bit 0 of word wpos
  int nacc = 0;      // its bits (under 32 between symbols)
  int wpos = 0;
  bool first = true;  // the next word out is the run's first: shared
  auto begin = [&](int c, int bit) {  // the run goes on at this bit of tile chunk c
    const int b = s_bit0[c] + bit;
    wpos = b >> 5;
    nacc = b & 31;
    acc = 0;
    first = true;
  };
  auto finish = [&]() {  // the last word of a run: shared with the next
    if (nacc > 0 && (uint32_t)acc) atomicOr(st + wpos, (uint32_t)acc);
  };
  int cl = (t.lp0 + cs - 1) / cs - 1;
  int next = (cl + 1) * cs;
  if (t.lp0 < t.end && t.lp0 < next) begin(cl, carry);
  for_run(syms, t, s_tab, head, [&](int lp, int k, uint32_t e) {
    if (chunk_start<GROUPED>(lp, k, cs, next)) {
      finish();
      ++cl;
      begin(cl, 0);
    }
    acc |= (uint64_t)(e & 0xFFFFu) << nacc;
    nacc += (int)(e >> 16);
    if (nacc >= 32) {
      const uint32_t word = (uint32_t)acc;
      if (!first) {
        st[wpos] = word;
      } else if (word) {
        atomicOr(st + wpos, word);
      }
      first = false;
      ++wpos;
      acc >>= 32;
      nacc -= 32;
    }
  });
  if (t.lp0 < t.end) finish();
  __syncthreads();

  const int64_t q0 = gbase >> 4;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const uint8_t* st8 = reinterpret_cast<const uint8_t*>(smem);
  for (int u = threadIdx.x; u < units; u += ENC_THREADS) {
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

// The encoder's tiles: a CTA codes tile_chunks chunks of cs symbols.
bool enc_args_ok(long long n, int cs, int tile_chunks) {
  return n > 0 && cs > 0 && tile_chunks > 0 &&
         (long long)cs * tile_chunks <= (1LL << 20);
}

template <bool GROUPED>
int launch_emit(const void* syms, const void* codes, const void* lengths,
                const void* ends, const void* sizes, void* out, long long n, int cs,
                int tile_chunks, long long smem, void* stream) {
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err =
        cudaFuncSetAttribute(huff_encode_emit_kernel<GROUPED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nchunks = (n + cs - 1) / cs;
  const unsigned ntiles = (unsigned)((nchunks + tile_chunks - 1) / tile_chunks);
  huff_encode_emit_kernel<GROUPED><<<ntiles, ENC_THREADS, (size_t)smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(codes),
      static_cast<const int32_t*>(lengths), static_cast<const int64_t*>(ends),
      static_cast<const int32_t*>(sizes), static_cast<uint8_t*>(out), n, cs, tile_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// data (nbytes,) u8 container; offsets (nchunks,) i64, sizes (nchunks,) i32
// chunk payloads in it, each offset the one before plus its size; limits
// (11,), adj (13,), perm (256,) i32 -> out ((n + 3) & ~3) + 4 u8, 16-byte
// aligned: the n symbols, zeros up to a multiple of 4, then the number of
// overrun chunks as an i32.
int sprintz_huff_decode(const void* data, long long nbytes, const void* offsets,
                        const void* sizes, const void* limits, const void* adj,
                        const void* perm, void* out, long long nchunks, int cs, long long n,
                        void* stream) {
  const long long nc = cs > 0 ? (n + cs - 1) / cs : 0;
  if (cs <= 0 || n <= 0 || nc > nchunks || (reinterpret_cast<uintptr_t>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* tail = static_cast<uint8_t*>(out) + n;  // the pad bytes and the count
  int32_t* nbad = reinterpret_cast<int32_t*>(static_cast<uint8_t*>(out) + ((n + 3) & ~3LL));
  cudaError_t err = cudaMemsetAsync(tail, 0, (size_t)(((n + 3) & ~3LL) + 4 - n), s);
  if (err != cudaSuccess) return (int)err;
  // one CTA an even share of the chunks, DEC_TILE_SYMBOLS symbols or more,
  // and no more CTAs than the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, huff_decode_kernel,
                                                           DEC_THREADS, 0)) != cudaSuccess) {
    return (int)err;
  }
  const long long tile_chunks = cs < DEC_TILE_SYMBOLS ? DEC_TILE_SYMBOLS / cs : 1;
  long long grid = (nc + tile_chunks - 1) / tile_chunks;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  grid = grid < resident ? grid : resident;
  huff_decode_kernel<<<(unsigned)grid, DEC_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(data), nbytes, static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(sizes), static_cast<const int32_t*>(limits),
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(perm),
      static_cast<uint8_t*>(out), nbad, cs, n);
  return (int)cudaGetLastError();
}

// syms (n,) u8, lengths (256,) i32 -> sizes (ceil(n / cs),) i32 bytes.
int sprintz_huff_encode_sizes(const void* syms, const void* lengths, void* sizes,
                              long long n, int cs, int tile_chunks, void* stream) {
  if (!enc_args_ok(n, cs, tile_chunks)) return (int)cudaErrorInvalidValue;
  const long long nchunks = (n + cs - 1) / cs;
  const unsigned ntiles = (unsigned)((nchunks + tile_chunks - 1) / tile_chunks);
  const uint8_t* sy = static_cast<const uint8_t*>(syms);
  const int32_t* le = static_cast<const int32_t*>(lengths);
  int32_t* sz = static_cast<int32_t*>(sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cs % 16 == 0) {
    huff_encode_sizes_kernel<true><<<ntiles, ENC_THREADS, 0, s>>>(sy, le, sz, n, cs,
                                                                 tile_chunks);
  } else {
    huff_encode_sizes_kernel<false><<<ntiles, ENC_THREADS, 0, s>>>(sy, le, sz, n, cs,
                                                                  tile_chunks);
  }
  return (int)cudaGetLastError();
}

// syms (n,) u8, codes and lengths (256,) i32, ends (ceil(n / cs),) i64 the
// inclusive cumsum of sizes (ceil(n / cs),) i32 -> out (ends[-1],) u8, 16-byte
// aligned.
int sprintz_huff_encode_emit(const void* syms, const void* codes, const void* lengths,
                             const void* ends, const void* sizes, void* out, long long n,
                             int cs, int tile_chunks, void* stream) {
  if (!enc_args_ok(n, cs, tile_chunks) || (reinterpret_cast<uintptr_t>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = enc_smem_bytes(cs, tile_chunks);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return cs % 16 == 0 ? launch_emit<true>(syms, codes, lengths, ends, sizes, out, n,
                                          cs, tile_chunks, smem, stream)
                      : launch_emit<false>(syms, codes, lengths, ends, sizes, out, n,
                                           cs, tile_chunks, smem, stream);
}

}  // extern "C"
