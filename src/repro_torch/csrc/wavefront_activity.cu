// Active PEs per cycle of the skewed R x C weight-stationary wavefront, for
// a batch of folds, on NVIDIA Hopper.
//
// Replaces the Pallas kernel
// `repro.kernels.systolic.systolic.wavefront_activity` (body
// `_wavefront_kernel`). PE(r, c) fires for stream element t at cycle
// t + r + c, so for a fold of T stream elements
//
//   active(n) = sum_r max(0, min(T - 1, n - r) - max(0, n - r - C + 1) + 1)
//
// in int32, exactly as the TPU kernel sums it. Cycles n >= T + R + C - 2
// come out 0, so one launch serves folds of any T within n_cycles.
//
// Design. Batched by construction: one thread per (fold b, cycle n) of the
// (B, n_cycles) output, grid-stride, with a loop over the R array rows; a
// fold's T is read once per thread (neighbouring threads share it, so the
// read is served from L1). The TPU kernel gets T as a scalar-prefetched
// runtime value; here it is an int32 array with one entry per fold.
//
// Bound on this card: 4 bytes written per (b, n) against about 8 integer
// operations per (b, n, r); at R = 128 the operations bound it, and the
// largest sweep launch (21 folds x 12,798 cycles) is a few microseconds of
// work, so a launch's own cost dominates.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const int* __restrict__ Ts, int* __restrict__ out,
                 long long B, int n_cycles, int R, int C) {
  const long long total = B * (long long)n_cycles;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += step) {
    const long long b = i / n_cycles;
    const int n = (int)(i - b * n_cycles);
    const int T = Ts[b];
    int acc = 0;
    for (int r = 0; r < R; ++r) {
      const int lo = max(0, n - r - (C - 1));
      const int hi = min(T - 1, n - r);
      acc += max(0, hi - lo + 1);
    }
    out[i] = acc;
  }
}

}  // namespace

// Ts: (B,) int32; out: (B, n_cycles) int32, row-major and contiguous.
// Launches on `stream` and returns the CUDA error of the launch (0 = none).
extern "C" int wavefront_activity_launch(const int* Ts, int* out,
                                         long long B, int n_cycles, int R,
                                         int C, void* stream) {
  const long long total = B * (long long)n_cycles;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  wavefront_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Ts, out, B, n_cycles, R, C);
  return (int)cudaGetLastError();
}
