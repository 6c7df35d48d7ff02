// FIRE (xff) forecaster scan for Hopper (sm_90a), bound with ctypes.
//
// fire_scan_kernel<EB, DECODE>
//   Replaces the lax.scan of sprintz_tpu/models/forecasters.py:_fire_scan
//   (forecasters.py:303-339) over _fire_block_step (:247-300) with
//   truncate_coeffs=True, the row-major layout's int16 coefficient. JAX
//   runs this pass outside Pallas; there is no TPU kernel behind it.
//   Encode: rows (N, D) i32 unsigned values -> zigzag errors (N, D) i32.
//   Decode: zigzag errors (N, D), u8 at EB 8 (K4's narrow mode) or i32 at
//   EB 16 -> values (N, D) u8/u16, from an optional (3, D) i32 init state
//   (prev value, prev delta, learning counter).
//   Bound on this card: neither bytes nor operations but the serial chain.
//   Each dim's state passes through every row in order, so the card runs
//   only D threads (64 on the headline stream), each a dependent chain of
//   about 20 integer operations per row; the byte and operation bounds
//   are microseconds, the chain milliseconds.
//   Design: one thread per dim walks all rows, so neighbouring threads load
//   and store neighbouring dims of one row (coalesced), and the loads of
//   later rows do not depend on the chain and can be issued ahead of it.
//   All arithmetic wraps as JAX's int32 does: products and sums are taken
//   in uint32_t and read back as int32_t, and every sign_extend of
//   _fire_block_step is kept. A chunk-parallel decode from sidecar states
//   is the way past the chain (a later slice).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SZ = 8;  // rows per block
constexpr int FIRE_THREADS = 64;
constexpr int LEARNING_SHIFT = 1;  // FIRE_LEARNING_SHIFT
constexpr int GRAD_SHIFT = 2;      // LOG2_BLOCK_SZ - FIRE_LOG2_LEARNING_DOWNSAMPLE

__device__ __forceinline__ int32_t sext(uint32_t x, int bits) {
  return (int32_t)(x << (32 - bits)) >> (32 - bits);
}

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

template <int EB, bool DECODE>
struct FireIO {  // encode: i32 values in, i32 errors out
  using in_t = int32_t;
  using out_t = int32_t;
};
template <int EB>
struct FireIO<EB, true> {  // decode: u8 (EB 8) or i32 (EB 16) errors in
  using in_t = typename std::conditional<EB == 8, uint8_t, int32_t>::type;
  using out_t = typename Narrow<EB>::type;
};

template <int EB, bool DECODE>
__global__ void fire_scan_kernel(const typename FireIO<EB, DECODE>::in_t* __restrict__ in,
                                 const int32_t* __restrict__ state,
                                 typename FireIO<EB, DECODE>::out_t* __restrict__ out,
                                 int64_t nb, int ndims) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= ndims) return;
  constexpr int kCounterBits = EB == 8 ? 16 : 32;
  constexpr int kShft = EB - 4;
  constexpr uint32_t kMask = (1u << EB) - 1u;
  int32_t prev_val = 0, prev_delta = 0, counter = 0;
  if (state != nullptr) {
    prev_val = state[d];
    prev_delta = state[ndims + d];
    counter = state[2 * ndims + d];
  }
  int64_t i = d;
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t coef =
        sext((uint32_t)(counter >> (LEARNING_SHIFT + kShft)) << kShft, 16);
    int32_t grad_sum = 0;
#pragma unroll
    for (int r = 0; r < BLOCK_SZ; ++r, i += ndims) {
      const int32_t prediction =
          sext((uint32_t)((int32_t)((uint32_t)prev_delta * (uint32_t)coef) >> EB), EB);
      int32_t err, delta, val;
      if constexpr (DECODE) {
        const uint32_t u = (uint32_t)in[i];
        err = sext((u >> 1) ^ (0u - (u & 1u)), EB);
        delta = sext((uint32_t)err + (uint32_t)prediction, EB);
        val = (int32_t)(((uint32_t)prev_val + (uint32_t)delta) & kMask);
        out[i] = (typename FireIO<EB, DECODE>::out_t)val;
      } else {
        val = in[i];
        delta = sext((uint32_t)val - (uint32_t)prev_val, EB);
        err = sext((uint32_t)delta - (uint32_t)prediction, EB);
        out[i] = (int32_t)((((uint32_t)err << 1) ^ (uint32_t)(err >> 31)) & kMask);
      }
      if (r & 1) {
        // icopysign(err, prev_delta) (util.h:63-74)
        const int32_t grad = err == 0 ? 0 : (err < 0 ? (int32_t)(0u - (uint32_t)prev_delta)
                                                     : prev_delta);
        grad_sum = sext((uint32_t)grad_sum + (uint32_t)grad, EB);
      }
      prev_val = val;
      prev_delta = delta;
    }
    counter = sext((uint32_t)counter + (uint32_t)(grad_sum >> GRAD_SHIFT), kCounterBits);
  }
}

template <int EB, bool DECODE>
void launch(const void* in, const int32_t* state, void* out, long long nb, int ndims,
            cudaStream_t s) {
  using IO = FireIO<EB, DECODE>;
  const unsigned nblocks = (unsigned)((ndims + FIRE_THREADS - 1) / FIRE_THREADS);
  fire_scan_kernel<EB, DECODE><<<nblocks, FIRE_THREADS, 0, s>>>(
      static_cast<const typename IO::in_t*>(in), state,
      static_cast<typename IO::out_t*>(out), nb, ndims);
}

}  // namespace

extern "C" {

// encode (decode == 0): in (nb * 8, ndims) i32 values, out i32 zigzag errors.
// decode (decode != 0): in (nb * 8, ndims) zigzag errors, u8 at elem_bits 8
// and i32 at 16, out u8/u16 values; state (3, ndims) i32 or null (zeros).
int sprintz_fire_scan(const void* in, const void* state, void* out, long long nb,
                      int ndims, int elem_bits, int decode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* st = static_cast<const int32_t*>(state);
  if (elem_bits == 8) {
    if (decode) launch<8, true>(in, st, out, nb, ndims, s);
    else launch<8, false>(in, st, out, nb, ndims, s);
  } else if (elem_bits == 16) {
    if (decode) launch<16, true>(in, st, out, nb, ndims, s);
    else launch<16, false>(in, st, out, nb, ndims, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
