// Encode kernels for Hopper (sm_90a), bound with ctypes: the row-major
// layout's bit-pack and the lowdim layout's encode pass.
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
// encode_lowdim_kernel<ES, ND, FROM_ROWS>  (the lowdim layout's encode pass)
//   Replaces the JAX package's fused lowdim delta encode,
//   sprintz_tpu/encoder.py:_encode_lowdim_grouped (encoder.py:132) and
//   _encode_lowdim_dmajor (encoder.py:76), chosen in _encode_pass
//   (encoder.py:239), and, for FIRE's errors (FROM_ROWS false), the width
//   and pack passes of _encode_pass's lowdim branch: the pack is
//   sprintz_tpu/ops/pack.py:pack_dims_lowdim (pack.py:251), an XLA pass of
//   one-hot matmuls or selects; JAX has no Pallas kernel here. The lowdim
//   layout (u8 ND <= 4, u16 ND <= 2) is column-major within a block: dim
//   d's 8 zigzag fields of w = widths[b, d] bits sit back to back at bits
//   r * w of the (block, dim) section, exactly w bytes, in a dense
//   (nb, ND, EB) buffer whose EB = 8 * ES bytes are zero past w.
//   From the rows (u8, or u16 sent as int16: the delta encode, each row
//   less the row before, 0 before row 0) or from FIRE's i32 zigzag errors,
//   it writes the encoder's whole device pass: widths (nb, ND) u8 (the bit
//   length of the block's largest error, only EB - 1 promoted to EB),
//   header fields (nb, ND) u8 (EB stored as EB - 1), the sections, and
//   each block's width sum (nb,) i32.
//   Bound on this card: bytes. It reads each row once and writes the
//   sections, widths, headers and sums once, with about a dozen integer
//   operations a field.
//   Design: a row of these widths is ND * EB <= 32 bits, so the kernel
//   keeps a row's ND values in one 32-bit word and works on them lane by
//   lane (vsub, vzigzag: SIMD operations on ND lanes of EB bits, borrows
//   kept in their lane). A thread owns K whole blocks (K = 4 / (ND * ES),
//   1 at u8 D 3: 24 or 32 bytes of rows in, as many bytes of sections out)
//   and a CTA of LD_THREADS threads a span of LD_THREADS * K blocks, so no
//   block straddles two threads or warps (at D 3 neither):
//   1. the span's rows, from the 16 bytes before its first (which end in
//      the row before it), go to shared memory in 16-byte cp.async copies
//      (stage_range); each thread reads its rows and the one before them
//      as 8-byte words and forms each row's zigzag delta from its
//      predecessor. FIRE's errors come straight from memory, 16 bytes a
//      load;
//   2. for each of its blocks, the OR of its rows' words gives every
//      dim's width at once (a bit length a lane); each section is packed
//      in registers (one 64-bit word, or two at u16, where a field at
//      r * w up to bit 112 may cross into the second) into a shared image
//      of the span's sections;
//   3. the widths, header fields and sums leave straight from registers
//      (a warp's are consecutive bytes), the sections' image in 16-byte
//      stores (store_range).

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

// ---- device helpers (PTX)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- end of device helpers

// Copy bytes [g0, g0 + len) of src (16-byte aligned, gtot bytes) into img,
// where img[0] stands for byte g0 & ~15: whole 16-byte units by cp.async
// (the caller waits), a unit that runs past gtot a byte at a time. Thread t
// of nt takes every nt-th unit. (decode.cu's, as are store_range and the
// lowdim shape.)
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
// whose other bytes belong to other CTAs, a byte at a time.
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

// ---- the lowdim layout: u8 ND <= 4, u16 ND <= 2, so a row is ND * EB <= 32 bits

constexpr int LD_THREADS = 256;

// A thread's share of a span: K whole blocks, 8K rows of RB bytes, CW 8-byte
// words of rows (and as many of sections); a span is LD_THREADS threads'.
template <int ES, int ND>
struct LowdimShape {
  static constexpr int RB = ND * ES;
  static constexpr int K = RB == 3 ? 1 : 4 / RB;
  static constexpr int NR = BLOCK_SZ * K;
  static constexpr int CW = K * RB;
  static constexpr int SPAN = LD_THREADS * K;
};

// Lane-wise a - b of rows of 8- or 16-bit lanes: each lane's top bit is set
// in a and cleared in b, so that no borrow leaves its lane, then fixed.
template <int EB>
__device__ __forceinline__ uint32_t vsub(uint32_t a, uint32_t b) {
  constexpr uint32_t H = EB == 8 ? 0x80808080u : 0x80008000u;
  return ((a | H) - (b & ~H)) ^ ((a ^ ~b) & H);
}

// Lane-wise zigzag of EB-bit two's complement lanes: (x << 1) ^ (x >> (EB - 1)).
template <int EB>
__device__ __forceinline__ uint32_t vzigzag(uint32_t x) {
  constexpr uint32_t H = EB == 8 ? 0x80808080u : 0x80008000u;
  constexpr uint32_t kLane = (1u << EB) - 1u;
  const uint32_t sign = (x & H) >> (EB - 1);  // 1 in each negative lane
  return ((x << 1) & ~(H >> (EB - 1))) ^ (sign * kLane);
}

// The RB bytes at byte `pos` of w (pos is known at compile time once the
// caller's loop is unrolled).
template <int RB>
__device__ __forceinline__ uint32_t row_at(const uint64_t* w, int pos) {
  const int q = pos >> 3, s = 8 * (pos & 7);
  uint64_t x = w[q] >> s;
  if (s + 8 * RB > 64) x |= w[q + 1] << (64 - s);
  return (uint32_t)x & (uint32_t)((1ull << (8 * RB)) - 1);
}

// N <= 4 bytes of v, little-endian, at dst (aligned to N where N is 2 or 4).
template <int N>
__device__ __forceinline__ void store_bytes(uint8_t* dst, uint32_t v) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(dst) = v;
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)v;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = (uint8_t)(v >> (8 * i));
  }
}

// Shared memory of the lowdim encode: the span's rows from the 16 bytes
// before its first, and its sections' image.
template <int ES, int ND>
struct EncodeLowdimSmem {
  static constexpr int kBytesA = 8 * LowdimShape<ES, ND>::CW * LD_THREADS;  // rows or sections
  static constexpr int kRows = 0;
  static constexpr int kImage = kRows + 16 + kBytesA + 16;
  static constexpr int kBytes = kImage + kBytesA;
};

template <int ES, int ND, bool FROM_ROWS>
__global__ void __launch_bounds__(LD_THREADS)
    encode_lowdim_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ widths,
                         uint8_t* __restrict__ hdr, uint8_t* __restrict__ dense,
                         int32_t* __restrict__ wsums, int64_t nb) {
  using S = LowdimShape<ES, ND>;
  using L = EncodeLowdimSmem<ES, ND>;
  constexpr int EB = 8 * ES, RB = S::RB, K = S::K, NR = S::NR, CW = S::CW, SPAN = S::SPAN;
  constexpr uint32_t kMask = (1u << EB) - 1u;
  extern __shared__ uint4 smem[];  // K3's declaration: one type a name
  uint8_t* s_rows = reinterpret_cast<uint8_t*>(smem) + L::kRows;  // [16]: the span's first row
  uint8_t* s_img = reinterpret_cast<uint8_t*>(smem) + L::kImage;
  const int tid = threadIdx.x;
  const int64_t b0 = (int64_t)blockIdx.x * SPAN;
  const int nbs = (int)(nb - b0 < SPAN ? nb - b0 : SPAN);
  const int64_t row0 = b0 * BLOCK_SZ;

  // 1. The thread's rows -> their zigzag errors, a row's ND errors in the
  // lanes of one word. Rows past nb are garbage that only blocks past nb
  // see.
  uint32_t zz[NR];
  if constexpr (FROM_ROWS) {
    const int64_t gtot = nb * BLOCK_SZ * RB;
    if (b0 == 0) {  // row 0's predecessor is 0
      if (tid < 2) reinterpret_cast<uint64_t*>(s_rows)[tid] = 0;
      stage_range(s_rows + 16, src, 0, nbs * BLOCK_SZ * RB, gtot, tid, LD_THREADS);
    } else {  // row0 * RB is a multiple of 16
      stage_range(s_rows, src, row0 * RB - 16, 16 + nbs * BLOCK_SZ * RB, gtot, tid, LD_THREADS);
    }
    cp_async_wait_all();
    __syncthreads();
    const uint64_t* sw = reinterpret_cast<const uint64_t*>(s_rows + 16) + tid * CW - 1;
    uint64_t w[CW + 1];  // the word that ends in the row before the thread's, then its rows
#pragma unroll
    for (int i = 0; i <= CW; ++i) w[i] = sw[i];
    uint32_t prev = row_at<RB>(w, 8 - RB);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const uint32_t cur = row_at<RB>(w, 8 + r * RB);
      zz[r] = vzigzag<EB>(vsub<EB>(cur, prev));
      prev = cur;
    }
  } else {
    constexpr int NV = NR * ND / 4;  // 16-byte loads of a thread's errors
    const int4* e4 = reinterpret_cast<const int4*>(src) + (row0 + (int64_t)tid * NR) * ND / 4;
    int4 v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {  // a block's errors are 2 * ND loads
      v[i] = tid * K + i / (2 * ND) < nbs ? __ldg(e4 + i) : make_int4(0, 0, 0, 0);
    }
    const int32_t* e = reinterpret_cast<const int32_t*>(v);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      zz[r] = 0;
#pragma unroll
      for (int d = 0; d < ND; ++d) zz[r] |= ((uint32_t)e[r * ND + d] & kMask) << (d * EB);
    }
  }

  // 2. Each block: its dims' widths from the OR of its rows, header
  // fields, width sum, and sections into the image.
  uint32_t wbytes = 0, hbytes = 0;  // the thread's K * ND widths and headers
  int32_t wsum[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t orw = 0;
#pragma unroll
    for (int r = 0; r < BLOCK_SZ; ++r) orw |= zz[k * BLOCK_SZ + r];
    wsum[k] = 0;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      int w = 32 - __clz((int)((orw >> (d * EB)) & kMask));
      w += w == EB - 1;  // the lowdim rule: only eb - 1 promotes
      wbytes |= (uint32_t)w << (8 * (k * ND + d));
      hbytes |= (uint32_t)(w - (w == EB)) << (8 * (k * ND + d));
      wsum[k] += w;
      uint64_t* sec = reinterpret_cast<uint64_t*>(s_img) + ((tid * K + k) * ND + d) * ES;
      if constexpr (ES == 1) {  // 8 fields of at most 8 bits: one word
        uint64_t x = 0;
#pragma unroll
        for (int r = 0; r < BLOCK_SZ; ++r) {
          x |= (uint64_t)((zz[k * BLOCK_SZ + r] >> (d * EB)) & kMask) << (r * w);
        }
        sec[0] = x;
      } else {  // at most 16 bits: a field at p < 64 spills its bits past 64 into hi
        uint64_t lo = 0, hi = 0;
#pragma unroll
        for (int r = 0; r < BLOCK_SZ; ++r) {
          const uint64_t f = (zz[k * BLOCK_SZ + r] >> (d * EB)) & kMask;
          const int p = r * w;
          if (p < 64) {
            lo |= f << p;
            if (p) hi |= f >> (64 - p);
          } else {
            hi |= f << (p - 64);
          }
        }
        sec[0] = lo;
        sec[1] = hi;
      }
    }
  }

  // 3. Widths, headers and sums from registers; the sections' image out.
  const int blk = tid * K;
  const int64_t gb = b0 + blk;
  if (blk + K <= nbs) {
    store_bytes<K * ND>(widths + gb * ND, wbytes);
    store_bytes<K * ND>(hdr + gb * ND, hbytes);
#pragma unroll
    for (int k = 0; k < K; ++k) wsums[gb + k] = wsum[k];
  } else {
    for (int k = 0; k < K && blk + k < nbs; ++k) {
      for (int d = 0; d < ND; ++d) {
        widths[(gb + k) * ND + d] = (uint8_t)(wbytes >> (8 * (k * ND + d)));
        hdr[(gb + k) * ND + d] = (uint8_t)(hbytes >> (8 * (k * ND + d)));
      }
      wsums[gb + k] = wsum[k];
    }
  }
  __syncthreads();
  store_range(dense, b0 * ND * EB, nbs * ND * EB, s_img, tid, LD_THREADS);
}

template <int ES, int ND, bool FROM_ROWS>
int launch_encode_lowdim(const uint8_t* src, uint8_t* widths, uint8_t* hdr, uint8_t* dense,
                         int32_t* wsums, long long nb, cudaStream_t s) {
  constexpr int span = LowdimShape<ES, ND>::SPAN;
  constexpr int smem = EncodeLowdimSmem<ES, ND>::kBytes;
  static_assert(smem <= SMEM_DEFAULT, "the lowdim encode stays in the default shared memory");
  encode_lowdim_kernel<ES, ND, FROM_ROWS><<<(unsigned)((nb + span - 1) / span), LD_THREADS,
                                            (size_t)smem, s>>>(src, widths, hdr, dense, wsums,
                                                               nb);
  return (int)cudaGetLastError();
}

template <bool FROM_ROWS>
int launch_encode_lowdim(const uint8_t* src, uint8_t* widths, uint8_t* hdr, uint8_t* dense,
                         int32_t* wsums, long long nb, int ndims, int elem_sz, cudaStream_t s) {
  switch (elem_sz * 8 + ndims) {
    case 8 + 1: return launch_encode_lowdim<1, 1, FROM_ROWS>(src, widths, hdr, dense, wsums, nb, s);
    case 8 + 2: return launch_encode_lowdim<1, 2, FROM_ROWS>(src, widths, hdr, dense, wsums, nb, s);
    case 8 + 3: return launch_encode_lowdim<1, 3, FROM_ROWS>(src, widths, hdr, dense, wsums, nb, s);
    case 8 + 4: return launch_encode_lowdim<1, 4, FROM_ROWS>(src, widths, hdr, dense, wsums, nb, s);
    case 16 + 1: return launch_encode_lowdim<2, 1, FROM_ROWS>(src, widths, hdr, dense, wsums, nb, s);
    case 16 + 2: return launch_encode_lowdim<2, 2, FROM_ROWS>(src, widths, hdr, dense, wsums, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// The lowdim layout's encode pass (ndims * elem_sz <= 4). src: the rows
// (nb * 8, ndims), u8 at elem_sz 1 and u16 at 2, with from_rows; else FIRE's
// (nb * 8, ndims) i32 zigzag errors, each below 2^(8 * elem_sz) -> widths
// (nb, ndims) u8 lowdim widths, hdr (nb, ndims) u8 header fields, dense
// (nb, ndims, 8 * elem_sz) u8 sections (each dim's 8 fields of w bits back
// to back, zero past w bytes), wsums (nb,) i32 width sums. Every pointer
// 16-byte aligned.
int sprintz_encode_lowdim(const void* src, void* widths, void* hdr, void* dense, void* wsums,
                          long long nb, int ndims, int elem_sz, int from_rows, void* stream) {
  if (nb < 1 || ((uintptr_t)src | (uintptr_t)widths | (uintptr_t)hdr | (uintptr_t)dense |
                 (uintptr_t)wsums) & 15) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(src);
  uint8_t* w = static_cast<uint8_t*>(widths);
  uint8_t* h = static_cast<uint8_t*>(hdr);
  uint8_t* d = static_cast<uint8_t*>(dense);
  int32_t* ws = static_cast<int32_t*>(wsums);
  return from_rows ? launch_encode_lowdim<true>(x, w, h, d, ws, nb, ndims, elem_sz, s)
                   : launch_encode_lowdim<false>(x, w, h, d, ws, nb, ndims, elem_sz, s);
}

}  // extern "C"
