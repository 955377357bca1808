// One weight-stationary fold's functional output, O = X @ W, for NVIDIA
// Hopper.
//
// Replaces the Pallas kernel `repro.kernels.systolic.systolic.systolic_matmul`
// (body `_matmul_kernel`): x (T, R) is the streamed operand, w (R, C) the
// stationary one, O (T, C) in the promoted dtype of the two. Inputs are
// float32, bfloat16 or float16 in any mix.
//
// Design. A plain tiled product on the CUDA cores: each block owns a 64 x 64
// tile of O, its 256 threads a 4 x 4 micro-tile each, strided by 16 rows and
// 16 columns so that shared-memory reads are conflict-free and the stores
// of a warp's 16 neighbouring threads hit neighbouring addresses. The
// reduction walks R in steps of 16: a 64 x 16 tile of x (stored transposed)
// and a 16 x 64 tile of w go to shared memory as float32, and every thread
// accumulates with float32 FMAs. The sum is rounded once, to O's dtype, at
// the store. No tensor cores: TF32 would keep about three decimal digits,
// outside the float32 contract of the fold plane.
//
// Bound on this card: a fold of the vit_base path (197 x 128 x 128) reads
// 0.26 MB and does 6.5 MFLOP, about 0.1 us at the float32 rate of the CUDA
// cores, far below a launch's cost; this simple form is bound by that
// launch and by the few blocks (8) such a fold has.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;      // O rows per block
constexpr int kBN = 64;      // O columns per block
constexpr int kBK = 16;      // reduction step
constexpr int kTM = 4;       // O rows per thread (strided by 16)
constexpr int kTN = 4;       // O columns per thread (strided by 16)
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);

// dtype codes of the C entry point (the wrapper's `_DTYPE_CODE`)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              TO* __restrict__ out, int T, int R, int C) {
  __shared__ float xs[kBK][kBM + 1];     // x tile, transposed
  __shared__ float ws[kBK][kBN];
  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
  const long long row0 = (long long)blockIdx.x * kBM;
  const long long col0 = (long long)blockIdx.y * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < R; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int m = e / kBK, k = e % kBK;
      const long long gr = row0 + m;
      const int gk = k0 + k;
      xs[k][m] = (gr < T && gk < R) ? to_f32(x[gr * R + gk]) : 0.0f;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      const int gk = k0 + k;
      const long long gc = col0 + n;
      ws[k][n] = (gk < R && gc < C) ? to_f32(w[(long long)gk * C + gc])
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const long long c = col0 + tx + 16 * j;
      if (c < C) out[r * C + c] = from_f32<TO>(acc[i][j]);
    }
  }
}

// promote_types(x, w) of the three dtypes: a pair of one dtype keeps it,
// any other pair is float32
template <typename TX, typename TW>
struct Promoted { using type = float; };
template <typename T>
struct Promoted<T, T> { using type = T; };

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int T, int R, int C,
           cudaStream_t stream) {
  using TO = typename Promoted<TX, TW>::type;
  const dim3 grid((unsigned)((T + kBM - 1) / kBM),
                  (unsigned)((C + kBN - 1) / kBN));
  matmul_kernel<TX, TW, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), T, R, C);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_w(const void* x, const void* w, void* out, int T, int R, int C,
             int w_dtype, cudaStream_t stream) {
  switch (w_dtype) {
    case kF32: return launch<TX, float>(x, w, out, T, R, C, stream);
    case kBF16: return launch<TX, __nv_bfloat16>(x, w, out, T, R, C, stream);
    case kF16: return launch<TX, __half>(x, w, out, T, R, C, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (T, R), w: (R, C), out: (T, C) in promote_types(x, w), all row-major
// and contiguous; dtype codes 0 = float32, 1 = bfloat16, 2 = float16. T
// and C must be >= 1 and (C + 63) / 64 at most 65,535. Launches on
// `stream` and returns the CUDA error of the launch (0 = none).
extern "C" int systolic_matmul_launch(const void* x, const void* w, void* out,
                                      int T, int R, int C, int x_dtype,
                                      int w_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case kF32: return launch_w<float>(x, w, out, T, R, C, w_dtype, s);
    case kBF16:
      return launch_w<__nv_bfloat16>(x, w, out, T, R, C, w_dtype, s);
    case kF16: return launch_w<__half>(x, w, out, T, R, C, w_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}
