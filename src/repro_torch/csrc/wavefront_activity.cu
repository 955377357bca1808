// Active PEs per cycle of the skewed R x C weight-stationary wavefront, for
// a batch of folds or one fold, on NVIDIA Hopper.
//
// Replaces the Pallas kernel
// `repro.kernels.systolic.systolic.wavefront_activity` (body
// `_wavefront_kernel`). PE(r, c) fires for stream element t at cycle
// t + r + c, so for a fold of T stream elements active(n) is the number of
// points (t, r, c) of the T x R x C box with t + r + c = n, which the TPU
// kernel sums over rows:
//
//   active(n) = sum_r max(0, min(T - 1, n - r) - max(0, n - r - C + 1) + 1)
//
// Cycles n >= T + R + C - 2 come out 0, so one launch serves folds of any
// T within n_cycles; T < 0 counts as 0, as in the row sum.
//
// Design. The count in closed form, O(1) per (fold, cycle): inclusion-
// exclusion over the box's three upper faces, eight terms g(n - off) with
// g(x) = (x + 1)(x + 2) / 2 the non-negative triples summing to x (0 for
// x < 0). Grouped as F(n) - F(n - T), F(m) = g(m) - g(m - R) - g(m - C)
// + g(m - R - C) the (r, c) pairs with r + c <= m, and F(m) = 0 for m < 0,
// every offset stays in int32. A term passes int32 once its argument
// exceeds about 46,000 (long GEMMs reach such T), so each is formed from a
// 64-bit product and the terms are summed modulo 2^32: the sum is the
// count itself, which lies in [0, R C] (modulo 2^32 beyond, as the row sum
// wraps). Each thread writes 4 consecutive elements of the flat
// (B, n_cycles) output with one 16-byte store (scalar stores at the tail
// or for an unaligned output): the eight terms at its first element, then
// F(n) and F(n - T) each step by one diagonal's pair count per cycle (a
// clamp), starting afresh where a row ends and the next fold begins.
// Two entries: the batch reads each fold's T from an int32 array; one fold
// takes T as a kernel argument, the way the TPU kernel takes T as
// scalar-prefetched `meta`, so a single-fold caller builds no device
// tensor for it, and its threads skip the fold division.
//
// Bound on this card: 4 bytes written per (fold, cycle) against some 60
// integer operations for a thread's first cycle and 10 for each next one;
// a single fold's launch (a few hundred cycles) is
// shorter than the launch itself, whose floor the empty kernel below
// measures.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

typedef unsigned long long u64;

// g(x) modulo 2^32, 0 for x < 0 (x + 1 <= 2^31, so the product fits in 64
// bits before the exact halving)
__device__ __forceinline__ unsigned tri(int x) {
  const unsigned a = (unsigned)x + 1u;
  return x < 0 ? 0u : (unsigned)(((u64)a * (a + 1u)) >> 1);
}

// F(m): the (r, c) pairs of the R x C array with r + c <= m
__device__ __forceinline__ unsigned pairs(int m, int R, int C) {
  return m < 0 ? 0u : tri(m) - tri(m - R) - tri(m - C) + tri(m - R - C);
}

// F(m) - F(m - 1): the (r, c) pairs with r + c = m
__device__ __forceinline__ unsigned diagonal(int m, int R, int C) {
  return m < 0 || m > R + C - 2
      ? 0u : (unsigned)(min(min(m, R - 1), min(C - 1, R + C - 2 - m)) + 1);
}

// Elements [4 g, 4 g + 4) of the flat output for g < groups; fold b's T is
// Ts[b] in a batch (kBatch), else T0 and the output is one fold's row.
// active(n) = F(n) - F(n - T) at a thread's first cycle of a fold, then
// F steps by one diagonal per cycle.
template <bool kVec, bool kBatch>
__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const int* __restrict__ Ts, int T0, int* __restrict__ out,
                 long long total, int n_cycles, int R, int C) {
  const long long groups = (total + 3) / 4;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += step) {
    const long long i0 = 4 * g;
    long long b = 0;
    int n = (int)i0;                   // one fold: total = n_cycles < 2^31
    if (kBatch) {
      if (total <= 0xffffffffll) {
        const unsigned q = (unsigned)i0 / (unsigned)n_cycles;
        b = q;
        n = (int)((unsigned)i0 - q * (unsigned)n_cycles);
      } else {
        b = i0 / n_cycles;
        n = (int)(i0 - b * n_cycles);
      }
    }
    int T = max(0, kBatch ? Ts[b] : T0);
    unsigned hi = pairs(n, R, C), lo = pairs(n - T, R, C);
    int v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q > 0) {
        if (kBatch && ++n == n_cycles) {         // the next fold's cycle 0
          n = 0;
          ++b;
          if (i0 + q < total) T = max(0, Ts[b]);
          hi = 1;                                // F(0)
          lo = pairs(-T, R, C);
        } else {
          if (!kBatch) ++n;
          hi += diagonal(n, R, C);
          lo += diagonal(n - T, R, C);
        }
      }
      v[q] = (int)(hi - lo);
    }
    if (kVec && i0 + 3 < total) {
      *reinterpret_cast<int4*>(out + i0) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i0 + q < total) out[i0 + q] = v[q];
    }
  }
}

template <bool kBatch>
void launch_as(const int* Ts, int T0, int* out, long long total,
               int n_cycles, int R, int C, cudaStream_t stream) {
  long long blocks = ((total + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (((uintptr_t)out & 15) == 0)
    wavefront_kernel<true, kBatch><<<(unsigned)blocks, kThreads, 0, stream>>>(
        Ts, T0, out, total, n_cycles, R, C);
  else
    wavefront_kernel<false, kBatch><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(Ts, T0, out, total, n_cycles,
                                                R, C);
}

int launch(const int* Ts, int T0, int* out, long long B, int n_cycles, int R,
           int C, cudaStream_t stream) {
  const long long total = B * (long long)n_cycles;
  if (total <= 0) return 0;
  if (Ts)
    launch_as<true>(Ts, T0, out, total, n_cycles, R, C, stream);
  else
    launch_as<false>(Ts, T0, out, total, n_cycles, R, C, stream);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// Ts: (B,) int32; out: (B, n_cycles) int32, row-major and contiguous.
// Launches on `stream` and returns the CUDA error of the launch (0 = none).
extern "C" int wavefront_activity_launch(const int* Ts, int* out,
                                         long long B, int n_cycles, int R,
                                         int C, void* stream) {
  return launch(Ts, 0, out, B, n_cycles, R, C, (cudaStream_t)stream);
}

// One fold of T stream elements: out (n_cycles,) int32.
extern "C" int wavefront_activity_scalar_launch(int T, int* out, int n_cycles,
                                                int R, int C, void* stream) {
  return launch(nullptr, T, out, 1, n_cycles, R, C, (cudaStream_t)stream);
}

// One launch of an empty kernel from this library, on `stream`: the floor
// under any launch of the entries above, for measurements.
extern "C" int wavefront_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
