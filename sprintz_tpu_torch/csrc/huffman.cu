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
//   the rule of the TPU version's spare zero word (huffman.py:517).
//   Bound on this card: neither bytes (about 1.5 bytes moved per symbol)
//   nor operations, but the serial bit cursor of each chunk: one thread
//   per chunk, chunk_symbols dependent steps each.
//   Design: one thread per chunk, which reads its own bytes from the
//   container uploaded once (offsets[c], guarded by sizes[c]), so the host
//   gathers nothing; a 64-bit bit buffer refilled a byte at a time to at
//   least 57 bits whenever fewer than 12 are banked, so no shift reaches
//   64 and each refill covers four or more symbols; the 11 limits, 13
//   adjustments and 256-byte permutation in shared memory. The TPU's
//   select chain over the chunk's words (its refill without a gather)
//   becomes a direct load. Stores are one byte per symbol, chunk_symbols
//   apart across a warp: the first suspect when this kernel is made fast.
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

constexpr int HUFF_THREADS = 128;
constexpr int MAX_CODE_LEN = 12;

__global__ void huff_decode_kernel(const uint8_t* __restrict__ data,
                                   const int64_t* __restrict__ offsets,
                                   const int32_t* __restrict__ sizes,
                                   const int32_t* __restrict__ limits,
                                   const int32_t* __restrict__ adj,
                                   const int32_t* __restrict__ perm,
                                   uint8_t* __restrict__ out, int64_t nchunks, int cs,
                                   int64_t n) {
  __shared__ int32_t s_lim[MAX_CODE_LEN - 1];
  __shared__ int32_t s_adj[MAX_CODE_LEN + 1];
  __shared__ uint8_t s_perm[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    s_perm[t] = (uint8_t)perm[t];
    if (t < MAX_CODE_LEN - 1) s_lim[t] = limits[t];
    if (t < MAX_CODE_LEN + 1) s_adj[t] = adj[t];
  }
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  const uint8_t* src = data + offsets[c];
  const int32_t size = sizes[c];
  const int64_t o0 = c * cs;
  const int64_t o1 = o0 + cs < n ? o0 + cs : n;
  uint64_t buf = 0;
  int nbits = 0;
  int32_t pos = 0;
  for (int64_t o = o0; o < o1; ++o) {
    if (nbits < MAX_CODE_LEN) {
      while (nbits <= 56) {
        const uint64_t byte = pos < size ? src[pos] : 0u;
        buf |= byte << nbits;
        nbits += 8;
        ++pos;
      }
    }
    const int32_t v = (int32_t)(__brev((uint32_t)buf & 0xFFFu) >> 20);
    int len = 1;
#pragma unroll
    for (int l = 0; l < MAX_CODE_LEN - 1; ++l) len += v >= s_lim[l];
    int idx = (v >> (MAX_CODE_LEN - len)) + s_adj[len];
    idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
    out[o] = s_perm[idx];
    buf >>= len;
    nbits -= len;
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

unsigned grid_for(long long nchunks) {
  return (unsigned)((nchunks + HUFF_THREADS - 1) / HUFF_THREADS);
}

}  // namespace

extern "C" {

// data (B,) u8 container; offsets (nchunks,) i64, sizes (nchunks,) i32 chunk
// payloads in it; limits (11,), adj (13,), perm (256,) i32 -> out (n,) u8.
int sprintz_huff_decode(const void* data, const void* offsets, const void* sizes,
                        const void* limits, const void* adj, const void* perm, void* out,
                        long long nchunks, int cs, long long n, void* stream) {
  if (cs <= 0) return (int)cudaErrorInvalidValue;
  huff_decode_kernel<<<grid_for(nchunks), HUFF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(sizes), static_cast<const int32_t*>(limits),
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(perm),
      static_cast<uint8_t*>(out), nchunks, cs, n);
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
