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
//   lengths into its byte size; the wrapper's exclusive cumsum of the sizes
//   gives each chunk's byte offset; pass 2 appends each chunk's codes into
//   a bit accumulator and writes each byte once at its offset.
//   Bound on this card: bytes in principle (one symbol byte read per pass,
//   under a byte written), in practice the serial append of each chunk.
//   Design: one thread per chunk in both passes, the 256-entry code and
//   length tables in shared memory; one writer per output byte, so no
//   atomics and no zeroed buffer.

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

__global__ void huff_encode_sizes_kernel(const uint8_t* __restrict__ syms,
                                         const int32_t* __restrict__ lengths,
                                         int32_t* __restrict__ sizes, int64_t n, int cs,
                                         int64_t nchunks) {
  __shared__ uint8_t s_len[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) s_len[t] = (uint8_t)lengths[t];
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  const int64_t o0 = c * cs;
  const int64_t o1 = o0 + cs < n ? o0 + cs : n;
  int64_t bits = 0;
  for (int64_t o = o0; o < o1; ++o) bits += s_len[syms[o]];
  sizes[c] = (int32_t)((bits + 7) >> 3);
}

__global__ void huff_encode_emit_kernel(const uint8_t* __restrict__ syms,
                                        const int32_t* __restrict__ codes,
                                        const int32_t* __restrict__ lengths,
                                        const int64_t* __restrict__ starts,
                                        uint8_t* __restrict__ out, int64_t n, int cs,
                                        int64_t nchunks) {
  __shared__ uint32_t s_code[256];
  __shared__ uint8_t s_len[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    s_code[t] = (uint32_t)codes[t];
    s_len[t] = (uint8_t)lengths[t];
  }
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  uint8_t* dst = out + starts[c];
  const int64_t o0 = c * cs;
  const int64_t o1 = o0 + cs < n ? o0 + cs : n;
  uint64_t acc = 0;
  int nbits = 0;  // < 8 between symbols, so a 12-bit code never overflows
  for (int64_t o = o0; o < o1; ++o) {
    const uint8_t s = syms[o];
    acc |= (uint64_t)s_code[s] << nbits;
    nbits += s_len[s];
    while (nbits >= 8) {
      *dst++ = (uint8_t)acc;
      acc >>= 8;
      nbits -= 8;
    }
  }
  if (nbits > 0) *dst = (uint8_t)acc;
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
                              long long n, int cs, void* stream) {
  if (cs <= 0) return (int)cudaErrorInvalidValue;
  const long long nchunks = (n + cs - 1) / cs;
  huff_encode_sizes_kernel<<<grid_for(nchunks), HUFF_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(lengths),
      static_cast<int32_t*>(sizes), n, cs, nchunks);
  return (int)cudaGetLastError();
}

// syms (n,) u8, codes and lengths (256,) i32, starts (ceil(n / cs),) i64
// byte offsets of the chunk payloads -> out (sum of sizes,) u8.
int sprintz_huff_encode_emit(const void* syms, const void* codes, const void* lengths,
                             const void* starts, void* out, long long n, int cs,
                             void* stream) {
  if (cs <= 0) return (int)cudaErrorInvalidValue;
  const long long nchunks = (n + cs - 1) / cs;
  huff_encode_emit_kernel<<<grid_for(nchunks), HUFF_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(codes),
      static_cast<const int32_t*>(lengths), static_cast<const int64_t*>(starts),
      static_cast<uint8_t*>(out), n, cs, nchunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
