// A CPU stand-in for the CUDA runtime and the warp intrinsics, so that a
// warp-synchronous kernel source of `src/repro_torch/csrc/` compiles with a
// host C++ compiler and runs on the CPU (tests/test_torch_emulated.py).
//
// Every thread of a block is a std::thread; every warp-wide intrinsic is an
// exchange through the warp's buffer between two barriers, so a kernel whose
// lanes do not all reach the same intrinsics in the same order deadlocks
// here as it would misbehave on the card. Blocks run one after another and
// share one dynamic shared-memory buffer, filled with garbage before each
// block. Block-wide barriers (__syncthreads) are not provided: the kernels
// this runs synchronise within warps only (or not at all, as the ELLPACK
// packer). The vector types are plain structs of the card's alignment. The
// test rewrites what a host compiler cannot take: `cp.async` becomes a plain
// copy, `<<<...>>>` a call of `mock_launch`, and `extern __shared__` arrays
// point at `mock_smem`.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))

struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct __align__(8) int2 { int x, y; };
struct __align__(16) int4 { int x, y, z, w; };
struct __align__(8) uint2 { unsigned x, y; };
struct __align__(16) uint4 { unsigned x, y, z, w; };
inline int2 make_int2(int x, int y) { return int2{x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 4 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16,
       cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

struct MockWarp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};
inline thread_local MockWarp* t_warp = nullptr;
inline thread_local int t_lane = 0;
inline std::atomic<int> g_launch_error{0};

constexpr size_t kMockSmemBytes = 232448;   // an H100 block's opt-in limit
alignas(16) inline unsigned char mock_smem[kMockSmemBytes];
using std::max;
using std::min;

template <typename T>
inline uint64_t mock_bits(T v) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
template <typename T>
inline T mock_value(uint64_t b) {
  T v;
  std::memcpy(&v, &b, sizeof(T));
  return v;
}

inline void __syncwarp(unsigned = 0xffffffffu) { t_warp->bar.arrive_and_wait(); }

// every lane publishes v; `all` receives the 32 published words
template <typename T>
inline void mock_exchange(T v, uint64_t (&all)[32]) {
  t_warp->slot[t_lane] = mock_bits(v);
  t_warp->bar.arrive_and_wait();
  std::memcpy(all, t_warp->slot, sizeof(all));
  t_warp->bar.arrive_and_wait();
}

template <typename T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  uint64_t all[32];
  mock_exchange(v, all);
  return mock_value<T>(all[(t_lane & ~(width - 1)) | (src & (width - 1))]);
}
template <typename T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
  uint64_t all[32];
  mock_exchange(v, all);
  const int s = t_lane - (int)delta;
  return s < (t_lane & ~(width - 1)) ? v : mock_value<T>(all[s]);
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  uint64_t all[32];
  mock_exchange(v, all);
  const int s = t_lane ^ mask;
  return (s & ~(width - 1)) != (t_lane & ~(width - 1)) ? v
                                                        : mock_value<T>(all[s]);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  uint64_t all[32];
  mock_exchange(pred ? 1 : 0, all);
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (unsigned)(all[i] != 0) << i;
  return b;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }
inline int __all_sync(unsigned m, int pred) {
  return __ballot_sync(m, pred) == 0xffffffffu;
}
template <typename T>
inline unsigned __match_any_sync(unsigned, T v) {
  uint64_t all[32];
  mock_exchange(v, all);
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (unsigned)(all[i] == mock_bits(v)) << i;
  return b;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  uint64_t all[32];
  mock_exchange(v, all);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)all[i];
  return r;
}
inline int __reduce_max_sync(unsigned, int v) {
  uint64_t all[32];
  mock_exchange(v, all);
  int r = (int)(unsigned)all[0];
  for (int i = 1; i < 32; ++i) r = std::max(r, (int)(unsigned)all[i]);
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// a read through the read-only data path is a plain load here
template <typename T>
inline T __ldg(const T* p) { return *p; }

template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K,
                                                                 int, size_t) {
  *n = 4;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  return g_launch_error.exchange(0) ? cudaErrorLaunchFailure : cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? 132 : (int)kMockSmemBytes;
  return cudaSuccess;
}

// kern<<<grid, block, bytes, stream>>>(args...)
template <typename K, typename... A>
inline void mock_launch(K kern, unsigned grid, unsigned block, size_t bytes,
                        cudaStream_t, A... args) {
  if (bytes > kMockSmemBytes || block % 32 || block == 0) {
    g_launch_error = 1;
    return;
  }
  for (unsigned b = 0; b < grid; ++b) {
    std::memset(mock_smem, 0xAB, bytes);
    std::vector<MockWarp> warps(block / 32);
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < block; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = block;
        gridDim.x = grid;
        t_warp = &warps[t / 32];
        t_lane = t % 32;
        kern(args...);
        // a returned lane leaves the barrier so the others go on
        t_warp->bar.arrive_and_drop();
      });
    for (auto& l : lanes) l.join();
  }
}
