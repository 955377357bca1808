// Blocked-ELLPACK packing of an N:M-sparse weight matrix (paper Fig. 6) for
// NVIDIA Hopper.
//
// Replaces the Pallas kernel `repro.kernels.ellpack.ellpack.ellpack_pack`
// (body `_pack_kernel`). w is (rows, K) with K % m == 0; in every block of m
// consecutive elements of a row, the nonzeros move to the front in their
// order, at most `keep` of them (a block with more keeps its first `keep`),
// each with its position in the block; the remaining slots hold 0 and -1.
// An element is zero when it compares equal to 0 (so -0.0 is zero).
//
// Design. One thread per (row, block), grid-stride: it walks the block's m
// elements once, keeps a running count of the nonzeros seen (the TPU
// kernel's exclusive-cumsum rank), writes each nonzero of rank < keep to
// slot `rank` with its position, and pads the slots left. Values are
// copied, never multiplied, so they are bit-exact. The TPU kernel selects
// through a one-hot contraction (`einsum` of the 0/1 selection with the
// block); for finite inputs that gives the same values, but a NaN or
// +-Inf in a block spreads NaN into every slot of that block there (0 *
// NaN), and not here: the contract is finite inputs.
//
// Bound on this card: every element is read once and (keep / m of it)
// written once with a 4-byte index; two integer operations per element.
// Bytes bound it. A thread reads m contiguous elements and its neighbours
// the next blocks, so a warp's loads cover contiguous memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

// dtype codes of the C entry point (the wrapper's `_DTYPE_CODE`)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

__device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }
__device__ __forceinline__ bool nonzero(__nv_bfloat16 v) {
  return __bfloat162float(v) != 0.0f;
}
__device__ __forceinline__ bool nonzero(__half v) {
  return __half2float(v) != 0.0f;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
template <>
__device__ __forceinline__ __half zero<__half>() {
  return __float2half_rn(0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ellpack_kernel(const T* __restrict__ w, T* __restrict__ vals,
               int* __restrict__ idx, long long nblocks, int m, int keep) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < nblocks; g += step) {
    const T* src = w + g * m;
    T* vdst = vals + g * keep;
    int* idst = idx + g * keep;
    int rank = 0;
    for (int p = 0; p < m; ++p) {
      const T v = src[p];
      if (nonzero(v)) {
        if (rank < keep) {
          vdst[rank] = v;
          idst[rank] = p;
        }
        ++rank;
      }
    }
    for (int s = min(rank, keep); s < keep; ++s) {
      vdst[s] = zero<T>();
      idst[s] = -1;
    }
  }
}

template <typename T>
int launch(const void* w, void* vals, int* idx, long long nblocks, int m,
           int keep, cudaStream_t stream) {
  long long blocks = (nblocks + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ellpack_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(vals), idx, nblocks, m,
      keep);
  return (int)cudaGetLastError();
}

}  // namespace

// w: (nblocks * m,) elements, i.e. (rows, K) with nblocks = rows * K / m;
// vals: (nblocks, keep) in w's dtype; idx: (nblocks, keep) int32; all
// contiguous. dtype codes 0 = float32, 1 = bfloat16, 2 = float16.
// Launches on `stream` and returns the CUDA error of the launch (0 = none).
extern "C" int ellpack_pack_launch(const void* w, void* vals, int* idx,
                                   long long nblocks, int m, int keep,
                                   int dtype, void* stream) {
  if (nblocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch<float>(w, vals, idx, nblocks, m, keep, s);
    case kBF16:
      return launch<__nv_bfloat16>(w, vals, idx, nblocks, m, keep, s);
    case kF16: return launch<__half>(w, vals, idx, nblocks, m, keep, s);
  }
  return (int)cudaErrorInvalidValue;
}
