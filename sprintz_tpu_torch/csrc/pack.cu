// Row-major bit-pack kernel for Hopper (sm_90a), bound with ctypes.
//
// pack_rows_kernel<ELEM_SZ>  (K3)
//   Replaces sprintz_tpu/ops/pallas_pack.py:_pack_kernel (pack_rows_pallas).
//   Each block row holds its dims' zigzag fields back to back, LSB first:
//   dim d's field starts at bit `off` = the exclusive prefix of the block's
//   widths. The row's maxb = ndims * ELEM_SZ bytes are written in full,
//   zero-filled past ceil(sum(w) / 8).
//   Bound on this card: bytes. It reads the i32 errors and widths once and
//   writes the dense payload once, with a few integer operations per field.
//   Design: one thread per (block, row) walks the dims in order with a
//   32-bit bit accumulator (at most 7 pending bits plus a 16-bit field) and
//   emits each byte as it fills, so the running offset needs no prefix
//   pass, no atomics and no byte-lane select over the row as on the TPU:
//   a single writer owns each row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SZ = 8;  // rows per block
constexpr int PACK_THREADS = 128;

template <int ELEM_SZ>
__global__ void pack_rows_kernel(const int32_t* __restrict__ errs,
                                 const int32_t* __restrict__ widths,
                                 uint8_t* __restrict__ out, int64_t nrows,
                                 int ndims) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nrows) return;
  constexpr int kMaxWidth = 8 * ELEM_SZ;
  const int maxb = ndims * ELEM_SZ;
  const int32_t* e = errs + row * ndims;
  const int32_t* w = widths + (row / BLOCK_SZ) * ndims;
  uint8_t* o = out + row * maxb;
  uint32_t acc = 0;
  int nbits = 0;
  int pos = 0;
  for (int d = 0; d < ndims; ++d) {
    int wd = w[d];
    wd = wd < 0 ? 0 : (wd > kMaxWidth ? kMaxWidth : wd);  // memory safety only
    acc |= ((uint32_t)e[d] & ((1u << wd) - 1u)) << nbits;
    nbits += wd;
    while (nbits >= 8) {
      o[pos++] = (uint8_t)acc;
      acc >>= 8;
      nbits -= 8;
    }
  }
  if (nbits > 0) o[pos++] = (uint8_t)acc;
  for (; pos < maxb; ++pos) o[pos] = 0;
}

}  // namespace

extern "C" {

// errs (nb, 8, ndims) i32 zigzag errors; widths (nb, ndims) i32 legal widths
// -> out (nb, 8, ndims * elem_sz) u8.
int sprintz_pack_rows(const void* errs, const void* widths, void* out,
                      long long nb, int ndims, int elem_sz, void* stream) {
  const long long nrows = nb * BLOCK_SZ;
  const unsigned nblocks = (unsigned)((nrows + PACK_THREADS - 1) / PACK_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* e = static_cast<const int32_t*>(errs);
  const int32_t* w = static_cast<const int32_t*>(widths);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (elem_sz == 1) {
    pack_rows_kernel<1><<<nblocks, PACK_THREADS, 0, s>>>(e, w, o, nrows, ndims);
  } else if (elem_sz == 2) {
    pack_rows_kernel<2><<<nblocks, PACK_THREADS, 0, s>>>(e, w, o, nrows, ndims);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
