// One weight-stationary fold's functional output, O = X @ W, for NVIDIA
// Hopper.
//
// Replaces the Pallas kernel `repro.kernels.systolic.systolic.systolic_matmul`
// (body `_matmul_kernel`): x (T, R) is the streamed operand, w (R, C) the
// stationary one, O (T, C) in the promoted dtype of the two. Inputs are
// float32, bfloat16, float16, int8, uint8, int16 or int32 in any mix.
//
// What bounds it on this card: latency. A fold of the vit_base path
// (197 x 128 x 128) reads 0.26 MB and does 6.5 MFLOP, about 0.1 us at the
// float32 rate of the CUDA cores; what a fold costs is the time to get
// its operands from memory into enough SMs and one dependent FMA chain of
// R steps per output. A 64 x 64 tiling gave such a fold 8 blocks, each
// walking R in 16-deep load-barrier-compute rounds with nothing in flight
// during the FMAs.
//
// Design. Many small output tiles: each block owns a 16 x 16 tile of O
// (a 197 x 128 fold gets 13 x 8 = 104 blocks), its 64 threads one row and
// four neighbouring columns each. A block stages the operand panels it
// needs, x rows (16 x R) and w columns (R x 16), in shared memory in the
// operands' own dtypes, 128 deep at a time: each stage is issued as
// 16-byte `cp.async` copies (zero-filled past the ragged edges), then one
// barrier, then the FMAs. At R <= 128 (every fold on a 128-row array) a
// block's whole panels arrive in one stage; a longer R runs a ring of two
// stages, the next stage's copies in flight during the current one's
// FMAs. Where an operand's base address or row pitch is not 16-byte
// aligned (a view offset into a larger tensor, R or C not a multiple of
// 16 bytes) that operand's panels are loaded element by element instead,
// into the same layout. Each output is one float32 accumulator, summed
// over k in ascending order with FMAs on the CUDA cores and rounded once,
// to O's dtype, at the store: TF32 tensor cores would keep about three
// decimal digits, outside the float32 contract of the fold plane, and at
// these sizes buy nothing.
//
// A pair with an integer operand takes `matmul_cast_kernel` instead, a
// plain 16 x 16 tiled kernel (one output a thread, 16-deep shared-memory
// stages): each operand element is first cast to O's dtype, as the
// reference's `jnp.dot` promotes it (an int32 to bfloat16 rounds), then
// summed in ascending k, in float32 with FMAs for a float O, and in
// 32-bit unsigned arithmetic for an integer O, narrowed at the store. The
// integer sums wrap modulo 2^32 and the narrowing keeps the low bits, so
// an integer O is the exact sum modulo 2^bits: the reference's int8 x int8
// wraps in int8 the same way (two's-complement arithmetic is a ring).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 16;      // O rows per block
constexpr int kBN = 16;      // O columns per block
constexpr int kBK = 128;     // reduction depth per stage
constexpr int kThreads = kBM * (kBN / 4);   // one row x 4 columns each

// dtype codes of the C entry point (the wrapper's `_DTYPE_CODE`)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kU8 = 4, kI16 = 5,
              kI32 = 6;

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

// four neighbouring w values of one stage row, as float32
__device__ __forceinline__ void load4(const float* p, float* b) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* b) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  b[0] = lo.x;
  b[1] = lo.y;
  b[2] = hi.x;
  b[3] = hi.y;
}
__device__ __forceinline__ void load4(const __half* p, float* b) {
  const __half2* q = reinterpret_cast<const __half2*>(p);
  const float2 lo = __half22float2(q[0]);
  const float2 hi = __half22float2(q[1]);
  b[0] = lo.x;
  b[1] = lo.y;
  b[2] = hi.x;
  b[3] = hi.y;
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (no read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename TX, typename TW>
struct Stage {
  static constexpr int kVX = 16 / sizeof(TX);      // x elements per 16 B
  static constexpr int kVW = 16 / sizeof(TW);
  static constexpr int kXP = kBK + kVX;            // x row pitch (padded)
  TX xs[2][kBM * kXP];     // x panel rows, k contiguous
  TW ws[2][kBK * kBN];     // w panel, one row of 16 columns per k
};

// Issue stage `st` (reduction rows k0 .. k0 + kBK) into buffer `b`.
template <typename TX, typename TW>
__device__ __forceinline__ void load_stage(Stage<TX, TW>& sm, int b,
                                           const TX* __restrict__ x,
                                           const TW* __restrict__ w,
                                           long long row0, long long col0,
                                           int k0, int T, int R, int C,
                                           bool vec_x, bool vec_w) {
  using S = Stage<TX, TW>;
  TX* xs = sm.xs[b];
  TW* ws = sm.ws[b];
  if (vec_x) {
    constexpr int per_row = kBK / S::kVX;
    for (int e = threadIdx.x; e < kBM * per_row; e += kThreads) {
      const int m = e / per_row, kc = (e % per_row) * S::kVX;
      const long long r = row0 + m;
      const bool ok = r < T && k0 + kc < R;
      cp_async16(xs + m * S::kXP + kc, ok ? x + r * R + k0 + kc : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int m = e / kBK, kk = e % kBK;
      const long long r = row0 + m;
      xs[m * S::kXP + kk] =
          (r < T && k0 + kk < R) ? x[r * R + k0 + kk] : from_f32<TX>(0.0f);
    }
  }
  if (vec_w) {
    constexpr int per_row = kBN / S::kVW;
    for (int e = threadIdx.x; e < kBK * per_row; e += kThreads) {
      const int kk = e / per_row, nc = (e % per_row) * S::kVW;
      const long long c = col0 + nc;
      const bool ok = k0 + kk < R && c < C;
      cp_async16(ws + kk * kBN + nc,
                 ok ? w + (long long)(k0 + kk) * C + c : w, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, n = e % kBN;
      const long long c = col0 + n;
      ws[kk * kBN + n] = (k0 + kk < R && c < C)
                             ? w[(long long)(k0 + kk) * C + c]
                             : from_f32<TW>(0.0f);
    }
  }
  cp_async_commit();
}

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              TO* __restrict__ out, int T, int R, int C, int col_tiles,
              bool vec_x, bool vec_w) {
  using S = Stage<TX, TW>;
  __shared__ __align__(16) unsigned char raw[sizeof(S)];
  S& sm = *reinterpret_cast<S*>(raw);
  const long long tile = blockIdx.x;
  const long long row0 = tile / col_tiles * kBM;
  const long long col0 = tile % col_tiles * kBN;
  const int tr = threadIdx.x >> 2;          // this thread's tile row
  const int tc = (threadIdx.x & 3) * 4;     // its first tile column
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  const int stages = (R + kBK - 1) / kBK;
  if (stages > 0)
    load_stage(sm, 0, x, w, row0, col0, 0, T, R, C, vec_x, vec_w);
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {   // the ring: next stage in flight during this one
      load_stage(sm, (st + 1) & 1, x, w, row0, col0, (st + 1) * kBK, T, R, C,
                 vec_x, vec_w);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TX* xr = sm.xs[st & 1] + tr * S::kXP;
    const TW* wc = sm.ws[st & 1] + tc;
    const int kmax = min(kBK, R - st * kBK);
#pragma unroll 8
    for (int k = 0; k < kmax; ++k) {
      const float a = to_f32(xr[k]);
      float b[4];
      load4(wc + k * kBN, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, b[j], acc[j]);
    }
    __syncthreads();           // before the ring overwrites this buffer
  }
  const long long r = row0 + tr;
  if (r >= T) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long c = col0 + tc + j;
    if (c < C) out[r * C + c] = from_f32<TO>(acc[j]);
  }
}

// promote_types(x, w) of the three dtypes: a pair of one dtype keeps it,
// any other pair is float32
template <typename TX, typename TW>
struct Promoted { using type = float; };
template <typename T>
struct Promoted<T, T> { using type = T; };

// 16-byte copies need the operand's base and row pitch 16-byte aligned
bool aligned16(const void* p, long long row_elems, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (row_elems * elem_bytes) % 16 == 0;
}

// one block per kBM x kBN tile of O
long long grid_blocks(int T, int C) {
  return ((long long)T + kBM - 1) / kBM * (((long long)C + kBN - 1) / kBN);
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int T, int R, int C,
           cudaStream_t stream) {
  using TO = typename Promoted<TX, TW>::type;
  const long long col_tiles = ((long long)C + kBN - 1) / kBN;
  const long long tiles = grid_blocks(T, C);
  if (T < 1 || C < 1 || R < 0 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  matmul_kernel<TX, TW, TO><<<(unsigned)tiles, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), T, R, C, (int)col_tiles,
      aligned16(x, R, sizeof(TX)), aligned16(w, C, sizeof(TW)));
  return (int)cudaGetLastError();
}

template <typename T>
constexpr bool kIsFloat = std::is_same_v<T, float> ||
                          std::is_same_v<T, __nv_bfloat16> ||
                          std::is_same_v<T, __half>;

// promote_types of two integer types (jnp's and torch's lattice): the
// wider, int16 for int8 with uint8
template <typename A, typename B>
using IntPromoted = std::conditional_t<
    std::is_same_v<A, B>, A,
    std::conditional_t<
        std::is_same_v<A, int32_t> || std::is_same_v<B, int32_t>, int32_t,
        int16_t>>;

// promote_types of a pair with an integer operand: the float operand's
// type, or the integers' promotion
template <typename A, typename B>
using CastPromoted = std::conditional_t<
    kIsFloat<A>, A, std::conditional_t<kIsFloat<B>, B, IntPromoted<A, B>>>;

// one operand element cast to O's dtype (rounding to nearest even), then
// to the accumulator: float32 for a float O, uint32 (two's complement)
// for an integer O
template <typename TO, typename T>
__device__ __forceinline__ auto cast_acc(T v) {
  if constexpr (kIsFloat<TO>) {
    if constexpr (std::is_same_v<T, TO>) {
      return to_f32(v);
    } else if constexpr (std::is_same_v<TO, float>) {
      return __int2float_rn((int)v);
    } else if constexpr (std::is_same_v<TO, __nv_bfloat16>) {
      return __bfloat162float(__int2bfloat16_rn((int)v));
    } else {
      return __half2float(__int2half_rn((int)v));
    }
  } else {
    return (uint32_t)(int32_t)(TO)v;
  }
}

constexpr int kCT = 16;       // O tile edge and stage depth of the cast path

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kCT * kCT)
matmul_cast_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TO* __restrict__ out, int T, int R, int C,
                   int col_tiles) {
  using TA = std::conditional_t<kIsFloat<TO>, float, uint32_t>;
  __shared__ TA xs[kCT][kCT + 1];
  __shared__ TA ws[kCT][kCT + 1];
  const long long row0 = (long long)(blockIdx.x / col_tiles) * kCT;
  const long long col0 = (long long)(blockIdx.x % col_tiles) * kCT;
  const int ty = threadIdx.x / kCT, tx = threadIdx.x % kCT;
  const long long r = row0 + ty, c = col0 + tx;
  TA acc = 0;
  for (int k0 = 0; k0 < R; k0 += kCT) {
    const int kx = k0 + tx, kw = k0 + ty;
    xs[ty][tx] = (r < T && kx < R) ? cast_acc<TO>(x[r * R + kx]) : TA(0);
    ws[ty][tx] = (kw < R && c < C) ? cast_acc<TO>(w[(long long)kw * C + c])
                                   : TA(0);
    __syncthreads();
    const int kmax = min(kCT, R - k0);
    for (int k = 0; k < kmax; ++k) {
      if constexpr (kIsFloat<TO>) acc = fmaf(xs[ty][k], ws[k][tx], acc);
      else acc += xs[ty][k] * ws[k][tx];
    }
    __syncthreads();
  }
  if (r >= T || c >= C) return;
  if constexpr (kIsFloat<TO>) out[r * C + c] = from_f32<TO>(acc);
  else out[r * C + c] = (TO)acc;
}

template <typename TX, typename TW>
int launch_cast(const void* x, const void* w, void* out, int T, int R,
                int C, cudaStream_t stream) {
  using TO = CastPromoted<TX, TW>;
  const long long col_tiles = ((long long)C + kCT - 1) / kCT;
  const long long tiles = ((long long)T + kCT - 1) / kCT * col_tiles;
  if (T < 1 || C < 1 || R < 0 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  matmul_cast_kernel<TX, TW, TO><<<(unsigned)tiles, kCT * kCT, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), T, R, C, (int)col_tiles);
  return (int)cudaGetLastError();
}

// the float pairs take the tiled kernel, every pair with an integer the
// cast kernel
template <typename TX, typename TW>
int launch_pair(const void* x, const void* w, void* out, int T, int R,
                int C, cudaStream_t stream) {
  if constexpr (kIsFloat<TX> && kIsFloat<TW>)
    return launch<TX, TW>(x, w, out, T, R, C, stream);
  else
    return launch_cast<TX, TW>(x, w, out, T, R, C, stream);
}

template <typename TX>
int launch_w(const void* x, const void* w, void* out, int T, int R, int C,
             int w_dtype, cudaStream_t stream) {
  switch (w_dtype) {
    case kF32: return launch_pair<TX, float>(x, w, out, T, R, C, stream);
    case kBF16:
      return launch_pair<TX, __nv_bfloat16>(x, w, out, T, R, C, stream);
    case kF16: return launch_pair<TX, __half>(x, w, out, T, R, C, stream);
    case kI8: return launch_pair<TX, int8_t>(x, w, out, T, R, C, stream);
    case kU8: return launch_pair<TX, uint8_t>(x, w, out, T, R, C, stream);
    case kI16: return launch_pair<TX, int16_t>(x, w, out, T, R, C, stream);
    case kI32: return launch_pair<TX, int32_t>(x, w, out, T, R, C, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (T, R), w: (R, C), out: (T, C) in promote_types(x, w), all row-major
// and contiguous; dtype codes 0 = float32, 1 = bfloat16, 2 = float16,
// 3 = int8, 4 = uint8, 5 = int16, 6 = int32. T and C must be >= 1 and
// ceil(T / 16) * ceil(C / 16) below 2^31; any alignment is taken.
// Launches on `stream` and returns the CUDA error of the launch (0 =
// none).
extern "C" int systolic_matmul_launch(const void* x, const void* w, void* out,
                                      int T, int R, int C, int x_dtype,
                                      int w_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case kF32: return launch_w<float>(x, w, out, T, R, C, w_dtype, s);
    case kBF16:
      return launch_w<__nv_bfloat16>(x, w, out, T, R, C, w_dtype, s);
    case kF16: return launch_w<__half>(x, w, out, T, R, C, w_dtype, s);
    case kI8: return launch_w<int8_t>(x, w, out, T, R, C, w_dtype, s);
    case kU8: return launch_w<uint8_t>(x, w, out, T, R, C, w_dtype, s);
    case kI16: return launch_w<int16_t>(x, w, out, T, R, C, w_dtype, s);
    case kI32: return launch_w<int32_t>(x, w, out, T, R, C, w_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of the tiled kernel's grid for a (T, C) output, as the launch
// counts them (a pair of float operands; the cast kernel's tiles are the
// same 16 x 16).
extern "C" long long systolic_matmul_blocks(int T, int C) {
  return grid_blocks(T, C);
}
