// CUDA's names for a build of a kernel source on the host, with g++ (see
// host_build.py, which rewrites the sources' launches and device helpers
// before it includes this: decode.cu, pack.cu, fire.cu and query.cu). Each CUDA thread is a std::thread; the CTAs of
// a launch run `resident` at a time (over x, then y), their threads all at once. Shared
// memory is a buffer per CTA filled with garbage and followed by a canary;
// __syncthreads is a barrier of the CTA, a shuffle a barrier of its mask's
// lanes around a word per lane. Not part of the port.

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
using cudaError_t = int;
using cudaStream_t = void*;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
template <class K>
inline int cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline int cudaGetLastError() { return cudaSuccess; }
// a card of 2 SMs that holds 2 CTAs a SM: a one-wave grid of 4 CTAs, so that
// a kernel's loops over rows run more than once
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline int cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;
  return cudaSuccess;
}
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 2;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(int) { return "host shim"; }

constexpr int kCanary = 64;

struct Cta {
  explicit Cta(unsigned threads, size_t smem_bytes, std::mt19937& gen)
      : bar(threads), smem(smem_bytes + kCanary), xch(threads), lane_bar((threads + 31) / 32) {
    for (auto& b : smem) b = (uint8_t)gen();
    std::fill(smem.end() - kCanary, smem.end(), 0xA5);
  }
  // the barrier of the lanes of `mask` in warp w, made at its first use
  std::barrier<>& lanes(int w, unsigned mask) {
    std::lock_guard<std::mutex> lock(mu);
    auto& b = lane_bar[w][mask];
    if (!b) b.reset(new std::barrier<>(__builtin_popcount(mask)));
    return *b;
  }
  std::barrier<> bar;
  std::atomic<int> any{0};  // __syncthreads_or's
  std::vector<uint8_t> smem;
  std::vector<long long> xch;
  std::mutex mu;
  std::vector<std::map<unsigned, std::unique_ptr<std::barrier<>>>> lane_bar;
};

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local Cta* g_cta;
inline int g_resident = 1;
inline std::atomic<int> g_fault{0};  // a CTA wrote past its shared memory

inline uint8_t* shim_smem() { return g_cta->smem.data(); }
inline void __syncthreads() { g_cta->bar.arrive_and_wait(); }
// whether `pred` holds for any thread of the CTA, to each of them
inline int __syncthreads_or(int pred) {
  if (pred) g_cta->any.store(1);
  g_cta->bar.arrive_and_wait();
  const int r = g_cta->any.load();
  g_cta->bar.arrive_and_wait();
  if (threadIdx.x == 0) g_cta->any.store(0);
  g_cta->bar.arrive_and_wait();
  return r;
}
inline long long clock64() { return 0; }
// c + the products of a's signed 16-bit halves with b's signed bytes 0, 1
inline int __dp2a_lo(int a, int b, int c) {
  const uint32_t p0 = (uint32_t)(int32_t)(int16_t)(a & 0xffff) * (uint32_t)(int32_t)(int8_t)(b & 0xff);
  const uint32_t p1 = (uint32_t)(int32_t)(int16_t)((uint32_t)a >> 16) *
                      (uint32_t)(int32_t)(int8_t)((b >> 8) & 0xff);
  return (int)((uint32_t)c + p0 + p1);
}

// the high 32 bits of a * b
inline int __mulhi(int a, int b) { return (int)(((long long)a * b) >> 32); }

// Each lane of `mask` posts v; returns what lane src_lane posted (take), or
// v.
template <class T>
inline T shim_exchange(unsigned mask, T v, int src_lane, bool take) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  long long* x = g_cta->xch.data() + 32 * w;
  std::barrier<>& b = g_cta->lanes(w, mask);
  x[l] = (long long)v;
  b.arrive_and_wait();
  const T r = take ? (T)x[src_lane] : v;
  b.arrive_and_wait();
  return r;
}
template <class T>
inline T __shfl_up_sync(unsigned mask, T v, int d, int width = 32) {
  const int l = threadIdx.x % 32;
  return shim_exchange(mask, v, l - d, l % width >= d);
}
template <class T>
inline T __shfl_sync(unsigned mask, T v, int src, int width = 32) {
  const int l = threadIdx.x % 32;
  return shim_exchange(mask, v, l - l % width + src % width, true);
}

template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int m, int width = 32) {
  const int l = threadIdx.x % 32;
  return shim_exchange(mask, v, l ^ (m % width), true);
}

inline void __syncwarp(unsigned mask = 0xffffffffu) {
  g_cta->lanes(threadIdx.x / 32, mask).arrive_and_wait();
}

// The lanes of `mask` whose `pred` holds, to each of them.
inline unsigned __ballot_sync(unsigned mask, int pred) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  long long* x = g_cta->xch.data() + 32 * w;
  std::barrier<>& b = g_cta->lanes(w, mask);
  x[l] = pred ? 1 : 0;
  b.arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i) {
    if ((mask >> i & 1u) && x[i]) bits |= 1u << i;
  }
  b.arrive_and_wait();
  return bits;
}
inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }

// The sum of what the lanes of `mask` post, to each of them.
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  long long* x = g_cta->xch.data() + 32 * w;
  std::barrier<>& b = g_cta->lanes(w, mask);
  x[l] = (long long)v;
  b.arrive_and_wait();
  unsigned sum = 0;
  for (int i = 0; i < 32; ++i) {
    if (mask >> i & 1u) sum += (unsigned)x[i];
  }
  b.arrive_and_wait();
  return sum;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).exchange(v);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline unsigned atomicMin(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old > v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  return (unsigned)((((uint64_t)hi << 32) | lo) >> (s & 31));
}

template <class K, class... A>
void shim_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  std::mt19937 gen(grid.x * 7919u + block.x);
  const unsigned total = grid.x * grid.y;
  for (unsigned c0 = 0; c0 < total; c0 += g_resident) {
    const unsigned n = std::min<unsigned>(g_resident, total - c0);
    std::vector<std::unique_ptr<Cta>> ctas;
    for (unsigned i = 0; i < n; ++i) ctas.emplace_back(new Cta(block.x, smem, gen));
    std::vector<std::thread> threads;
    for (unsigned i = 0; i < n; ++i) {
      for (unsigned t = 0; t < block.x; ++t) {
        threads.emplace_back([&, i, t] {
          threadIdx = dim3(t);
          blockIdx = dim3((c0 + i) % grid.x, (c0 + i) / grid.x);
          blockDim = block;
          gridDim = grid;
          g_cta = ctas[i].get();
          kernel(args...);
        });
      }
    }
    for (auto& th : threads) th.join();
    for (auto& cta : ctas) {
      for (auto it = cta->smem.end() - kCanary; it != cta->smem.end(); ++it) {
        if (*it != 0xA5) g_fault = 1;
      }
    }
  }
}
