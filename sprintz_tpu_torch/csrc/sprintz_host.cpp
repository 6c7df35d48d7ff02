// The port's host runtime: the per-block bookkeeping of the stream format,
// compiled with g++ at first use (native_host.py) and bound with ctypes.
//
// The stream's group headers reveal payload sizes only one group at a time,
// and the reference encoder's run-length control flow is a serial scan, so
// these loops stay on the host while the card runs the data path:
//
//   sprintz_walk_headers     the decode's header walk: per data block its
//                            widths, payload offset, first row, row bytes
//   sprintz_walk_headers_parallel
//                            the same walk split at a sidecar's checkpoints,
//                            its segments on threads
//   sprintz_gather_blocks    the decode's payload gather, row-major layout:
//                            8 rows of rb bytes a block -> (ndata, 8, maxb)
//   sprintz_gather_dims      the same, lowdim layout: D sections of w bytes
//                            a block -> (ndata, D, eb)
//   sprintz_build_plan       the encode's emission plan from zero flags
//   sprintz_assemble_stream  the encode's final byte stream, and on request
//                            each group's byte offset and first row (the
//                            group index a sidecar is built from)
//   sprintz_histogram        the +Huf table's byte counts
//   sprintz_copy             a copy of n bytes on threads (the decode's join
//                            into the array it returns)
//   sprintz_threads_started  the threads parallel_for has started, in all
//
// Semantics are those of the Python versions beside their callers
// (decoder._walk_headers_py, decoder._walk_headers_parallel_py,
// decoder._gather_payloads_py, planner._build_plan_py,
// encoder._assemble_stream_py, checkpoint._group_index_py, np.bincount), which
// the tests hold this library to; they replicate the reference encoder's
// consumption order (sprintz_delta_rle.cpp:214-312). Every entry point
// returns int64_t: a count, 0, or -1 where the input would be read or
// written out of bounds (a truncated or inconsistent stream for the walk
// and the gathers; an undersized buffer, a bug, for the assembler).
//
// Intrinsics are guarded (__BMI2__, __AVX2__, __SSE2__): built with
// -march=native the library uses what the host has, and it builds on any.

#include <cstdint>
#include <cstring>

#include <algorithm>
#include <array>
#include <atomic>
#include <thread>
#include <vector>

#if defined(__BMI2__) || defined(__AVX2__) || defined(__SSE2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kBlockSz = 8;
constexpr int kGroupSzBlocks = 2;
constexpr int kMaxRunNblocks = 0x7fff;

constexpr int8_t kKindData = 0;
constexpr int8_t kKindRun = 1;
constexpr int8_t kKindRun0 = 2;

#if defined(__AVX2__)
// Byte masks for the branchless gather: mask[w] keeps the first w of 64
// bytes. Rows load a full vector, AND with mask[w], store full width:
// no per-row branches or variable-length memcpy/memset pairs.
const auto kByteMask = [] {
  std::array<std::array<uint8_t, 64>, 65> m{};
  for (int w = 0; w <= 64; ++w)
    for (int i = 0; i < 64; ++i) m[(size_t)w][(size_t)i] = i < w ? 0xFF : 0;
  return m;
}();
#endif

// Copy one row-major block (kBlockSz rows of w valid bytes, maxb stride,
// zero tails). Masked vectors when the over-read past the last row stays
// inside the buffer; memcpy and memset otherwise.
inline void copy_block_rows(const uint8_t* buf, int64_t buf_len,
                            int64_t off, int64_t w, uint8_t* d,
                            int64_t maxb) {
  const uint8_t* s = buf + off;
#if defined(__AVX2__)
  if (maxb == 32 && off + (kBlockSz - 1) * w + 32 <= buf_len) {
    const __m256i m =
        _mm256_loadu_si256((const __m256i*)kByteMask[(size_t)w].data());
    for (int r = 0; r < kBlockSz; ++r)
      _mm256_storeu_si256(
          (__m256i*)(d + r * 32),
          _mm256_and_si256(
              _mm256_loadu_si256((const __m256i*)(s + r * w)), m));
    return;
  }
  if (maxb == 64 && off + (kBlockSz - 1) * w + 64 <= buf_len) {
    const __m256i m0 =
        _mm256_loadu_si256((const __m256i*)kByteMask[(size_t)w].data());
    const __m256i m1 = _mm256_loadu_si256(
        (const __m256i*)(kByteMask[(size_t)w].data() + 32));
    for (int r = 0; r < kBlockSz; ++r) {
      _mm256_storeu_si256(
          (__m256i*)(d + r * 64),
          _mm256_and_si256(
              _mm256_loadu_si256((const __m256i*)(s + r * w)), m0));
      _mm256_storeu_si256(
          (__m256i*)(d + r * 64 + 32),
          _mm256_and_si256(
              _mm256_loadu_si256((const __m256i*)(s + r * w + 32)), m1));
    }
    return;
  }
  if (maxb == 16 && off + (kBlockSz - 1) * w + 16 <= buf_len) {
    const __m128i m =
        _mm_loadu_si128((const __m128i*)kByteMask[(size_t)w].data());
    for (int r = 0; r < kBlockSz; ++r)
      _mm_storeu_si128(
          (__m128i*)(d + r * 16),
          _mm_and_si128(_mm_loadu_si128((const __m128i*)(s + r * w)), m));
    return;
  }
  if (maxb == 8 && off + (kBlockSz - 1) * w + 8 <= buf_len) {
    uint64_t m;
    memcpy(&m, kByteMask[(size_t)w].data(), 8);
    for (int r = 0; r < kBlockSz; ++r) {
      uint64_t v;
      memcpy(&v, s + r * w, 8);
      v &= m;
      memcpy(d + r * 8, &v, 8);
    }
    return;
  }
#endif
  for (int r = 0; r < kBlockSz; ++r) {
    memcpy(d + r * maxb, s + r * w, (size_t)w);
    memset(d + r * maxb + w, 0, (size_t)(maxb - w));
  }
}

// The copy loops below take their pointers as parameters, not from a
// closure: a store through a uint8_t pointer may alias any object, so
// pointers read from a lambda's captures would be reloaded after each
// store (3x slower, measured on the lowdim gather).

// Row-major blocks [lo, hi) of sprintz_gather_blocks.
void gather_blocks_range(const uint8_t* buf, int64_t buf_len,
                         const int64_t* offsets, const int32_t* rb,
                         int64_t maxb, uint8_t* out, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; ++i)
    copy_block_rows(buf, buf_len, offsets[i], rb[i],
                    out + i * kBlockSz * maxb, maxb);
}

// Lowdim blocks [lo, hi) of sprintz_gather_dims: each section's w <= eb
// bytes, zero up to eb. With EB (8 or 16; 0: eb at run time, any size),
// where EB bytes from the section's start lie inside the buffer, 8-byte
// words masked to w, with no library call a section; memcpy and memset
// otherwise.
template <int EB>
void gather_dims_range(const uint8_t* buf, const uint8_t* end,
                       const int64_t* offsets, const uint8_t* widths,
                       int32_t ndims, uint8_t* out, int64_t lo, int64_t hi,
                       int64_t eb = EB) {
  for (int64_t i = lo; i < hi; ++i) {
    const uint8_t* s = buf + offsets[i];
    uint8_t* d = out + i * ndims * eb;
    for (int32_t k = 0; k < ndims; ++k, d += eb) {
      const int64_t w = widths[i * ndims + k];
      if (EB && s + EB <= end) {
        for (int o = 0; o < EB; o += 8) {
          uint64_t v;
          memcpy(&v, s + o, 8);
          const int64_t keep = w - o;  // bytes of this word in the section
          v &= keep >= 8 ? ~0ULL : keep <= 0 ? 0 : (1ULL << (8 * keep)) - 1;
          memcpy(d + o, &v, 8);
        }
      } else {
        memcpy(d, s, (size_t)w);
        memset(d + w, 0, (size_t)(eb - w));
      }
      s += w;
    }
  }
}

// Bytes a thread takes at least, of the gathers' output and of the
// histogram's input: below them a thread's start-up costs more than it
// saves (an A/B on the host of an H100 machine, probes/host_ab.py: with
// 2 MiB pieces the histogram of a 2.3 MB stream was 1.5x slower than one
// thread's, and of a 37 MB stream 3.8x faster).
constexpr int64_t kThreadBytes = 2 << 20;
constexpr int64_t kHistogramBytes = 8 << 20;
// The same for the walk split at a sidecar's checkpoints, whose work a
// byte is less: on the host of an H100 machine 8 threads walked an 8 MiB
// u8 stream's 4.7 MB in 1.6 ms where one thread took 0.56 (chip_smoke.py's
// split), and the threads' first touches of fresh output pages contend.
constexpr int64_t kWalkBytes = 8 << 20;

// Threads that parallel_for has started since the library was loaded
// (sprintz_threads_started).
std::atomic<int64_t> g_threads_started{0};

// Run work(lo, hi) over [0, n) on up to the host's cores, one thread for
// every `grain` items at least.
template <typename F>
void parallel_for(int64_t n, int64_t grain, int max_threads, F&& work) {
  const int nthreads = (int)std::min<int64_t>(
      std::max<int64_t>(n / grain, 1),
      std::min<int64_t>(max_threads,
                        std::max(1u, std::thread::hardware_concurrency())));
  if (nthreads <= 1) {
    work((int64_t)0, n);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&work, lo, hi] { work(lo, hi); });
  }
  g_threads_started.fetch_add((int64_t)ts.size(), std::memory_order_relaxed);
  for (auto& th : ts) th.join();
}

// Counts of the bytes d[0, len) into out[256]. 4 sub-counters break the
// store-to-load dependency chain on repeated symbols.
void count_bytes(const uint8_t* d, int64_t len, int64_t* out) {
  int64_t c[4][256] = {};
  int64_t i = 0;
  for (; i + 4 <= len; i += 4) {
    c[0][d[i]]++;
    c[1][d[i + 1]]++;
    c[2][d[i + 2]]++;
    c[3][d[i + 3]]++;
  }
  for (; i < len; i++) c[0][d[i]]++;
  for (int s = 0; s < 256; s++) out[s] = c[0][s] + c[1][s] + c[2][s] + c[3][s];
}

// Pass 2 of sprintz_assemble_stream: groups [g0, g1) into their disjoint
// output ranges. Its pointers are parameters for the reason the gathers'
// are (stores through out may alias a closure's captures).
void emit_groups(const int8_t* kinds, const int32_t* values, int64_t nslots,
                 const uint8_t* widths, const uint8_t* hdrvals,
                 const uint8_t* dense, int64_t maxb, int32_t ndims,
                 int hdr_bits, int64_t total_header_bytes, int32_t lowdim,
                 const int64_t* group_off, const int64_t* slot_size,
                 uint8_t* out, int64_t g0, int64_t g1) {
  // Rows may be emitted with fixed-size 16- or 48-byte copies when the
  // whole block plus the overhang stays inside THIS thread's range
  // [group_off[g0], group_off[g1]): the next write overwrites the slack.
  const int64_t region_end = group_off[g1];
  for (int64_t g = g0; g < g1; g++) {
    // header: a streaming LSB-first bit writer (a word at a time); run
    // slots contribute ndims zero fields
    uint8_t* hd = out + group_off[g];
    const int64_t s1 = std::min(nslots, (g + 1) * kGroupSzBlocks);
    {
      uint64_t acc = 0;
      int nbits = 0;
      int64_t hp = 0;
      for (int64_t s = g * kGroupSzBlocks; s < s1; s++) {
        if (kinds[s] == kKindData) {
          const uint8_t* hv = hdrvals + (int64_t)values[s] * ndims;
          for (int d = 0; d < ndims; d++) {
            acc |= (uint64_t)hv[d] << nbits;
            nbits += hdr_bits;
            if (nbits >= 32) {
              memcpy(hd + hp, &acc, 4);
              hp += 4;
              acc >>= 32;
              nbits -= 32;
            }
          }
        } else {  // run/run0: zero header fields just advance the bitpos
          int64_t z = (int64_t)ndims * hdr_bits;
          while (z > 0) {
            const int take = (int)std::min<int64_t>(z, 32 - nbits);
            nbits += take;
            z -= take;
            if (nbits >= 32) {
              memcpy(hd + hp, &acc, 4);
              hp += 4;
              acc >>= 32;
              nbits -= 32;
            }
          }
        }
      }
      while (nbits > 0) {
        hd[hp++] = (uint8_t)acc;
        acc >>= 8;
        nbits -= 8;
      }
      if (hp < total_header_bytes)  // a group of fewer slots
        memset(hd + hp, 0, total_header_bytes - hp);
    }
    int64_t p = group_off[g] + total_header_bytes;
    for (int64_t s = g * kGroupSzBlocks; s < s1; s++) {
      const int8_t kind = kinds[s];
      if (kind == kKindData) {
        const int64_t b = values[s];
        if (lowdim) {
          const uint8_t* w = widths + b * ndims;
          const uint8_t* src = dense + b * ndims * maxb;
          for (int d = 0; d < ndims; d++) {
            memcpy(out + p, src + (int64_t)d * maxb, w[d]);
            p += w[d];
          }
        } else {
          const int64_t rb = slot_size[s] / kBlockSz;
          const uint8_t* src = dense + b * kBlockSz * maxb;
          // fixed-size reads of K bytes from a row start stay inside
          // dense iff K <= maxb (the next row begins there)
          if (rb <= 16 && maxb >= 16
              && p + kBlockSz * rb + 16 <= region_end) {
            for (int r = 0; r < kBlockSz; r++) {
              memcpy(out + p, src + (int64_t)r * maxb, 16);
              p += rb;
            }
          } else if (rb <= 48 && maxb >= 48
                     && p + kBlockSz * rb + 48 <= region_end) {
            for (int r = 0; r < kBlockSz; r++) {
              memcpy(out + p, src + (int64_t)r * maxb, 48);
              p += rb;
            }
          } else {
            for (int r = 0; r < kBlockSz; r++) {
              memcpy(out + p, src + (int64_t)r * maxb, rb);
              p += rb;
            }
          }
        }
      } else if (kind == kKindRun) {
        const int32_t run = values[s];
        if (run > 0x7f) {
          out[p++] = (uint8_t)((run & 0x7f) | 0x80);
          out[p++] = (uint8_t)(run >> 7);
        } else {
          out[p++] = (uint8_t)(run & 0x7f);
        }
      } else {  // kKindRun0 padding byte
        out[p++] = 0;
      }
    }
  }
}

}  // namespace

extern "C" {

// Derive the slot event sequence from per-block zero flags.
// kinds_out/values_out must hold >= 2 * nb_max + kGroupSzBlocks entries.
// out_meta: [nslots, ngroups, consumed_blocks, remaining_elems]
int64_t sprintz_build_plan(
    const uint8_t* zero_flags, int64_t n_elems, int32_t ndims,
    int32_t run_cmp_allows_equal,
    int8_t* kinds_out, int32_t* values_out, int64_t* out_meta) {
  const int64_t block_elems = (int64_t)kBlockSz * ndims;
  const int64_t group_sz = block_elems * kGroupSzBlocks;
  const int64_t last_start = n_elems - group_sz;

  int64_t nslots = 0;
  int64_t i = 0;
  int32_t run = 0;
  bool finished = false;

  while (i <= last_start && !finished) {
    int b = 0;
    while (b < kGroupSzBlocks) {
      const int64_t bidx = i / block_elems;
      const bool z = zero_flags[bidx] != 0;
      for (;;) {  // just_read_block
        if (z && run < kMaxRunNblocks) {
          run++;
          i += block_elems;
          const bool more =
              run_cmp_allows_equal ? (i <= last_start) : (i < last_start);
          if (more) break;  // read next block, same group position
          kinds_out[nslots] = kKindRun;
          values_out[nslots++] = run;
          run = 0;
          b++;
          while (b < kGroupSzBlocks) {
            kinds_out[nslots] = kKindRun0;
            values_out[nslots++] = 0;
            b++;
          }
          finished = true;
          break;
        }
        if (run > 0) {
          kinds_out[nslots] = kKindRun;
          values_out[nslots++] = run;
          run = 0;
          b++;
          if (b == kGroupSzBlocks) {
            b = 0;
            continue;  // same block becomes next group's first slot
          }
          if (z) continue;  // run cap hit on a zero block
        }
        kinds_out[nslots] = kKindData;
        values_out[nslots++] = (int32_t)bidx;
        i += block_elems;
        b++;
        break;
      }
      if (finished) break;
    }
  }

  out_meta[0] = nslots;
  out_meta[1] = nslots / kGroupSzBlocks;
  out_meta[2] = i / block_elems;
  out_meta[3] = n_elems - i;
  return nslots;
}

// Walk the group headers from byte `start` to index payloads and runs.
// widths_out: cap * ndims; offsets_out, out_rows_out, row_bytes_out: cap.
// row_bytes_out[i] = ceil(sum of block i's widths / 8), its payload row's
// bytes in the row-major layout. out_meta: [ndata, total_rows,
// tail_offset]. Returns ndata, or -1 when the declared structure would
// read past buf_len (the stream is truncated or its metadata lies: the
// format carries no checksum, so this is the only defense) or index more
// than cap data blocks.
//
//
// runs == 0: the non-RLE streams (sprintz_tpu_torch/simple.py): a block of
// all-zero widths is a data block of width 0 with no payload, not a run.
//
// No read passes buf_len - 1, so the stream needs no padded copy: a
// header's field loads read at most one byte past the header (2-byte
// loads in the scalar path, 4-byte loads of 3 header bytes in the BMI2
// one). With runs, a header that ends the buffer is refused before it is
// read, which changes no result: each of a group's blocks takes at least
// one byte after the header (a run varint or a payload of width > 0).
// Without runs a group of all-zero widths takes no byte after its header,
// so the stream's last group may end the buffer with its header (an empty
// tail): such a header is read from a zero-padded copy, and only a header
// that runs past the buffer is refused.
int64_t sprintz_walk_headers(
    const uint8_t* buf, int64_t buf_len, int64_t start, int64_t ngroups,
    int32_t ndims, int32_t elem_sz, int32_t lowdim, int32_t runs, int64_t cap,
    uint8_t* widths_out, int64_t* offsets_out, int64_t* out_rows_out,
    int32_t* row_bytes_out, int64_t* out_meta) {
  const int hdr_bits = elem_sz == 1 ? 3 : 4;
  const int elem_bits = 8 * elem_sz;
  const int64_t total_header_bytes =
      ((int64_t)ndims * hdr_bits * kGroupSzBlocks + 7) / 8;
  std::vector<uint8_t> padded;  // runs == 0: a header that ends the buffer

  int64_t pos = start;
  int64_t row = 0;
  int64_t ndata = 0;

#if defined(__BMI2__)
  // Vectorized width extraction: when ndims % 8 == 0 each block's fields
  // start byte-aligned, and PDEP expands 8 packed 3/4-bit fields into 8
  // bytes in one instruction. The elem_bits-1 -> elem_bits promotion and
  // the width sum run as SWAR on the same u64 (promoted bytes stay <= 16,
  // so the multiply-sum cannot carry; cross-byte shift leakage dies in
  // the 0x01 masks).
  const bool fast8 = (ndims % 8 == 0);
#endif

  for (int64_t g = 0; g < ngroups; g++) {
    const bool ends = pos + total_header_bytes >= buf_len;
    if (ends && (runs || pos + total_header_bytes > buf_len)) return -1;
    // the group advance is a serial pointer chase (pos depends on the
    // parsed widths), which defeats hardware prefetch across the group
    // stride: prefetch ahead in software
    __builtin_prefetch(buf + pos + 512);
    __builtin_prefetch(buf + pos + 1024);
    const uint8_t* hdr = buf + pos;
    if (ends) {
      padded.assign((size_t)total_header_bytes + 8, 0);
      memcpy(padded.data(), hdr, (size_t)total_header_bytes);
      hdr = padded.data();
    }
    pos += total_header_bytes;
    int64_t bitpos = 0;
    for (int b = 0; b < kGroupSzBlocks; b++) {
      if (ndata >= cap) return -1;
      int64_t wsum = 0;
      uint8_t* wrow = widths_out + ndata * ndims;
#if defined(__BMI2__)
      if (fast8) {
        const uint8_t* hb = hdr + (bitpos >> 3);
        if (hdr_bits == 3) {
          for (int k = 0; k < ndims / 8; k++) {
            uint32_t bits;
            memcpy(&bits, hb + 3 * k, 4);
            uint64_t w = _pdep_u64(bits, 0x0707070707070707ULL);
            w += w & (w >> 1) & (w >> 2) & 0x0101010101010101ULL;
            memcpy(wrow + 8 * k, &w, 8);
            wsum += (int64_t)((w * 0x0101010101010101ULL) >> 56);
          }
        } else {
          for (int k = 0; k < ndims / 8; k++) {
            uint32_t bits;
            memcpy(&bits, hb + 4 * k, 4);
            uint64_t w = _pdep_u64(bits, 0x0F0F0F0F0F0F0F0FULL);
            w += w & (w >> 1) & (w >> 2) & (w >> 3) & 0x0101010101010101ULL;
            memcpy(wrow + 8 * k, &w, 8);
            wsum += (int64_t)((w * 0x0101010101010101ULL) >> 56);
          }
        }
      } else
#endif
      {
        for (int d = 0; d < ndims; d++) {
          const int64_t bp = bitpos + (int64_t)d * hdr_bits;
          // a 3/4-bit field spans at most 2 bytes
          const uint32_t two =
              (uint32_t)hdr[bp >> 3] | ((uint32_t)hdr[(bp >> 3) + 1] << 8);
          int32_t h = (two >> (bp & 7)) & ((1u << hdr_bits) - 1);
          if (h == elem_bits - 1) h = elem_bits;
          wrow[d] = (uint8_t)h;
          wsum += h;
        }
      }
      bitpos += (int64_t)ndims * hdr_bits;
      if (wsum == 0 && runs) {
        if (pos >= buf_len) return -1;
        const uint8_t low = buf[pos++];
        int32_t length = low & 0x7f;
        if (low & 0x80) {
          if (pos >= buf_len) return -1;
          length |= (int32_t)buf[pos++] << 7;
        }
        row += (int64_t)length * kBlockSz;
        continue;
      }
      offsets_out[ndata] = pos;
      out_rows_out[ndata] = row;
      row_bytes_out[ndata] = (int32_t)((wsum + 7) / 8);
      if (lowdim) {
        pos += wsum;  // 8 * w bits == w bytes per dim
      } else {
        pos += (int64_t)kBlockSz * ((wsum + 7) / 8);
      }
      if (pos > buf_len) return -1;
      ndata++;
      row += kBlockSz;
    }
  }

  out_meta[0] = ndata;
  out_meta[1] = row;
  out_meta[2] = pos;
  return ndata;
}

// Segment-parallel header walk: segment s covers groups [s * every_groups,
// min((s + 1) * every_groups, ngroups)) and starts at byte byte_offsets[s]
// with first row row_offsets[s] (a checkpoint sidecar's). A group holds
// two data blocks at most, so segment s writes its blocks into the outputs
// from index 2 * (its first group) on, walked by the thread that owns it
// and its first rows shifted there; segments that hold runs leave gaps,
// which a serial pass then closes (a move to the left, in stream order).
// No scratch: a copy of every block through scratch, and its pages,
// took longer than the walk it split (on the host of an H100 machine).
// Outputs as sprintz_walk_headers (cap >= 2 * ngroups data blocks);
// out_meta [ndata, total_rows, tail_offset], the last two from the last
// segment. Returns ndata, -1 where a segment's walk would overrun the
// buffer or the outputs (or a byte offset lies outside the buffer), -2
// where a segment's rows do not end at the next segment's first row (the
// sidecar does not belong to the stream).
int64_t sprintz_walk_headers_parallel(
    const uint8_t* buf, int64_t buf_len, const int64_t* byte_offsets,
    const int64_t* row_offsets, int64_t nseg, int64_t every_groups,
    int64_t ngroups, int32_t ndims, int32_t elem_sz, int32_t lowdim,
    int64_t cap, uint8_t* widths_out, int64_t* offsets_out,
    int64_t* out_rows_out, int32_t* row_bytes_out, int64_t* out_meta) {
  if (nseg < 1 || every_groups < 1 || ngroups < 0 || 2 * ngroups > cap) return -1;
  for (int64_t s = 0; s < nseg; ++s)
    if (byte_offsets[s] < 0 || byte_offsets[s] >= buf_len) return -1;
  // segment s's first group and its groups; a segment past the last group
  // walks none (every is every_groups, which a segment cannot outgrow the
  // stream by, clamped so that no product overflows)
  const int64_t every = std::min(every_groups, std::max<int64_t>(ngroups, 1));
  auto first_group = [&](int64_t s) {
    return std::min(std::min(s, ngroups / every + 1) * every, ngroups);
  };
  std::vector<int64_t> nd(nseg), rows(nseg), tails(nseg);
  std::vector<char> bad((size_t)nseg, 0);
  // a thread takes runs of segments of kWalkBytes of stream at least
  const int64_t span = std::max<int64_t>(buf_len - byte_offsets[0], 1);
  parallel_for(nseg, std::max<int64_t>(kWalkBytes * nseg / span, 1), 64,
               [&](int64_t lo, int64_t hi) {
    for (int64_t s = lo; s < hi; ++s) {
      const int64_t g0 = first_group(s), g1 = first_group(s + 1);
      const int64_t at = 2 * g0;  // this segment's first output index
      int64_t meta[3];
      const int64_t n = sprintz_walk_headers(
          buf, buf_len, byte_offsets[s], std::max<int64_t>(g1 - g0, 0), ndims, elem_sz,
          lowdim, 1, 2 * (g1 - g0), widths_out + at * ndims, offsets_out + at,
          out_rows_out + at, row_bytes_out + at, meta);
      if (n < 0) {
        bad[(size_t)s] = 1;
        continue;
      }
      for (int64_t i = 0; i < n; ++i) out_rows_out[at + i] += row_offsets[s];
      nd[s] = n;
      rows[s] = meta[1];
      tails[s] = meta[2];
    }
  });
  for (char b : bad)
    if (b) return -1;
  for (int64_t s = 0; s + 1 < nseg; ++s)
    if (row_offsets[s] + rows[s] != row_offsets[s + 1]) return -2;
  int64_t ndata = 0;
  for (int64_t s = 0; s < nseg; ++s) {
    const int64_t at = 2 * first_group(s), n = nd[s];
    if (ndata != at) {  // close the gap runs left before this segment
      memmove(widths_out + ndata * ndims, widths_out + at * ndims, (size_t)(n * ndims));
      memmove(offsets_out + ndata, offsets_out + at, (size_t)n * 8);
      memmove(out_rows_out + ndata, out_rows_out + at, (size_t)n * 8);
      memmove(row_bytes_out + ndata, row_bytes_out + at, (size_t)n * 4);
    }
    ndata += n;
  }
  out_meta[0] = ndata;
  out_meta[1] = row_offsets[nseg - 1] + rows[nseg - 1];
  out_meta[2] = tails[nseg - 1];
  return ndata;
}

// Row-major payload gather: block i = kBlockSz rows of rb[i] bytes at
// offsets[i], landing at out[i * kBlockSz * maxb + r * maxb], zero past
// rb[i]; every byte of out[0, ndata * kBlockSz * maxb) is written, so out
// may come uninitialized. Threaded over blocks. Returns 0, or -1 if a
// block lies outside buf or out.
int64_t sprintz_gather_blocks(
    const uint8_t* buf, int64_t buf_len,
    const int64_t* offsets, const int32_t* rb, int64_t ndata,
    int64_t maxb, uint8_t* out, int64_t out_len) {
  if (ndata * kBlockSz * maxb > out_len) return -1;
  for (int64_t i = 0; i < ndata; ++i) {
    if (rb[i] < 0 || rb[i] > maxb || offsets[i] < 0 ||
        offsets[i] + kBlockSz * (int64_t)rb[i] > buf_len)
      return -1;
  }
  const int64_t grain = std::max<int64_t>(kThreadBytes / (kBlockSz * maxb), 1);
  parallel_for(ndata, grain, 64, [&](int64_t lo, int64_t hi) {
    gather_blocks_range(buf, buf_len, offsets, rb, maxb, out, lo, hi);
  });
  return 0;
}

// Lowdim payload gather: block i = ndims sections of widths[i * ndims + d]
// bytes each (a lowdim dim's 8 fields of w bits are w bytes), landing at
// out[(i * ndims + d) * eb], zero past w. Every byte of out[0, ndata *
// ndims * eb) is written. Returns 0, or -1 if a block lies outside buf or
// out or a width exceeds eb.
int64_t sprintz_gather_dims(
    const uint8_t* buf, int64_t buf_len,
    const int64_t* offsets, const uint8_t* widths, int64_t ndata,
    int32_t ndims, int64_t eb, uint8_t* out, int64_t out_len) {
  if (ndata * ndims * eb > out_len) return -1;
  for (int64_t i = 0; i < ndata; ++i) {
    int64_t tot = 0;
    for (int32_t d = 0; d < ndims; ++d) {
      const int32_t w = widths[i * ndims + d];
      if (w > eb) return -1;
      tot += w;
    }
    if (offsets[i] < 0 || offsets[i] + tot > buf_len) return -1;
  }
  const int64_t grain = std::max<int64_t>(kThreadBytes / (ndims * eb), 1);
  parallel_for(ndata, grain, 64, [&](int64_t lo, int64_t hi) {
    if (eb == 8)
      gather_dims_range<8>(buf, buf + buf_len, offsets, widths, ndims, out,
                           lo, hi);
    else if (eb == 16)
      gather_dims_range<16>(buf, buf + buf_len, offsets, widths, ndims, out,
                            lo, hi);
    else
      gather_dims_range<0>(buf, buf + buf_len, offsets, widths, ndims, out,
                           lo, hi, eb);
  });
  return 0;
}

// Byte histogram into counts[256]: one thread a piece of kHistogramBytes,
// each piece counted apart and the counts then summed. Returns 0.
int64_t sprintz_histogram(const uint8_t* data, int64_t n, int64_t* counts) {
  if (n <= kHistogramBytes) {
    count_bytes(data, n, counts);
    return 0;
  }
  const int64_t npieces = (n + kHistogramBytes - 1) / kHistogramBytes;
  std::vector<std::array<int64_t, 256>> part((size_t)npieces);
  parallel_for(npieces, 1, 64, [&](int64_t lo, int64_t hi) {
    for (int64_t p = lo; p < hi; ++p)
      count_bytes(data + p * kHistogramBytes,
                  std::min(kHistogramBytes, n - p * kHistogramBytes),
                  part[(size_t)p].data());
  });
  for (int s = 0; s < 256; s++) {
    counts[s] = 0;
    for (const auto& c : part) counts[s] += c[(size_t)s];
  }
  return 0;
}

// Final stream assembly: the 8-byte metadata, then for each group its
// header and its two slots (a data block's payload, a run varint, or a
// padding zero), then the verbatim tail. Returns the stream's length, or
// -1 if out_cap is too small. meta: null for the RLE metadata, else the
// meta_len bytes that take its place (a non-RLE stream's header, or none:
// sprintz_tpu_torch/simple.py). With group_index, pass 1 also writes each
// group's byte offset and first row, which it knows anyway: a sidecar's
// checkpoints are taken from them without a walk over the stream.
//
// Two passes so that emission parallelizes: pass 1 computes every group's
// byte offset, pass 2 emits groups into their disjoint output ranges,
// threaded over group ranges. Groups, not slots, are the parallel unit:
// the two blocks of a group share header bytes (their 3/4-bit fields are
// bit-packed back to back).
int64_t sprintz_assemble_stream(
    const int8_t* kinds, const int32_t* values, int64_t nslots,
    int64_t ngroups, int64_t remaining_elems,
    const uint8_t* widths,   // (nb, ndims) per-block field widths
    const uint8_t* hdrvals,  // (nb, ndims) stored header fields
    const uint8_t* dense,    // (nb, 8, maxb) row-major | (nb, ndims, maxb)
    int64_t maxb, int32_t ndims, int32_t elem_sz, int32_t lowdim,
    const uint8_t* tail, int64_t tail_nbytes,
    uint8_t* out, int64_t out_cap,
    const int32_t* wsums,  // optional (nb,) per-block width sums (the
                           // device pass computes them): skips the
                           // O(nslots * ndims) resum
    int64_t* group_index,  // optional (2, ng): each group's byte offset,
                           // then its first row
    const uint8_t* meta, int64_t meta_len) {
  const int hdr_bits = elem_sz == 1 ? 3 : 4;
  const int64_t total_header_bytes =
      ((int64_t)ndims * hdr_bits * kGroupSzBlocks + 7) / 8;

  const int64_t head = meta ? meta_len : 8;
  if (head < 0 || out_cap < head) return -1;
  if (meta) {
    memcpy(out, meta, (size_t)meta_len);
  } else {
    // metadata {u32 ngroups, u16 remaining, u16 ndims} LE
    out[0] = (uint8_t)(ngroups);
    out[1] = (uint8_t)(ngroups >> 8);
    out[2] = (uint8_t)(ngroups >> 16);
    out[3] = (uint8_t)(ngroups >> 24);
    out[4] = (uint8_t)(remaining_elems);
    out[5] = (uint8_t)(remaining_elems >> 8);
    out[6] = (uint8_t)(ndims);
    out[7] = (uint8_t)(ndims >> 8);
  }

  // ---- pass 1: per-slot payload sizes -> per-group output offsets
  const int64_t ng = (nslots + kGroupSzBlocks - 1) / kGroupSzBlocks;
  std::vector<int64_t> slot_size(nslots);
  for (int64_t s = 0; s < nslots; s++) {
    const int8_t kind = kinds[s];
    if (kind == kKindData) {
      int64_t wsum;
      if (wsums) {
        wsum = wsums[values[s]];
      } else {
        const uint8_t* w = widths + (int64_t)values[s] * ndims;
        wsum = 0;
        for (int d = 0; d < ndims; d++) wsum += w[d];
      }
      slot_size[s] = lowdim ? wsum : (int64_t)kBlockSz * ((wsum + 7) / 8);
    } else if (kind == kKindRun) {
      slot_size[s] = values[s] > 0x7f ? 2 : 1;
    } else {  // kKindRun0 padding byte
      slot_size[s] = 1;
    }
  }
  std::vector<int64_t> group_off(ng + 1);
  int64_t pos = head;
  for (int64_t g = 0; g < ng; g++) {
    group_off[g] = pos;
    pos += total_header_bytes;
    const int64_t s1 = std::min(nslots, (g + 1) * kGroupSzBlocks);
    for (int64_t s = g * kGroupSzBlocks; s < s1; s++) pos += slot_size[s];
  }
  group_off[ng] = pos;
  if (group_index) {
    // a data slot is one block, a run slot `value` blocks, padding none
    int64_t row = 0;
    for (int64_t g = 0; g < ng; g++) {
      group_index[g] = group_off[g];
      group_index[ng + g] = row;
      const int64_t s1 = std::min(nslots, (g + 1) * kGroupSzBlocks);
      for (int64_t s = g * kGroupSzBlocks; s < s1; s++) {
        if (kinds[s] == kKindData)
          row += kBlockSz;
        else if (kinds[s] == kKindRun)
          row += (int64_t)values[s] * kBlockSz;
      }
    }
  }
  if (pos + tail_nbytes > out_cap) return -1;

  // ---- pass 2: emit groups into their disjoint ranges
  auto emit = [&](int64_t g0, int64_t g1) {
    emit_groups(kinds, values, nslots, widths, hdrvals, dense, maxb, ndims,
                hdr_bits, total_header_bytes, lowdim, group_off.data(),
                slot_size.data(), out, g0, g1);
  };
  if (pos < (1 << 19)) {
    emit(0, ng);
  } else {
    parallel_for(ng, 64, 16, emit);
  }

  memcpy(out + pos, tail, tail_nbytes);
  return pos + tail_nbytes;
}

// dst[0, n) = src[0, n), the two apart: one thread for every kThreadBytes
// at least (the gathers' grain), up to max_threads, each on whole pages.
// The caller sets max_threads lower where dst's pages are fresh: their
// first touches contend (decoder.FRESH_COPY_THREADS). Returns 0.
int64_t sprintz_copy(uint8_t* dst, const uint8_t* src, int64_t n,
                     int32_t max_threads) {
  if (n <= 0) return 0;
  constexpr int64_t kPage = 4096;
  parallel_for((n + kPage - 1) / kPage, kThreadBytes / kPage,
               std::max(max_threads, 1), [&](int64_t lo, int64_t hi) {
    const int64_t a = lo * kPage, b = std::min(n, hi * kPage);
    memcpy(dst + a, src + a, (size_t)(b - a));
  });
  return 0;
}

// The threads parallel_for has started since the library was loaded.
int64_t sprintz_threads_started() {
  return g_threads_started.load(std::memory_order_relaxed);
}

}  // extern "C"
