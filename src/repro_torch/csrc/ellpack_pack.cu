// Blocked-ELLPACK packing of an N:M-sparse weight matrix (paper Fig. 6) for
// NVIDIA Hopper.
//
// Replaces the Pallas kernel `repro.kernels.ellpack.ellpack.ellpack_pack`
// (body `_pack_kernel`). w is (rows, K) with K % m == 0; in every block of m
// consecutive elements of a row, the nonzeros move to the front in their
// order, at most `keep` of them (a block with more keeps its first `keep`),
// each with its position in the block; the remaining slots hold 0 and -1.
// A float element is zero when its bits other than the sign are 0 (so -0.0
// is zero); an integer element when all its bits are (the sign bit alone
// is the most negative value). Values are copied as bits, never
// multiplied, so they are bit-exact, and the kernel sees only element
// sizes and that one flag: float32 and int32 (4 bytes), bfloat16, float16
// and int16 (2 bytes; the floats' zeros share the one bit pattern), int8
// and uint8 (1 byte).
// The TPU kernel selects through a one-hot contraction (`einsum` of the 0/1
// selection with the block); for finite inputs that gives the same values,
// but a NaN or +-Inf in a block spreads NaN into every slot of that block
// there (0 * NaN), and not here: the contract is finite inputs.
//
// Bound on this card: every element is read once and (keep / m of it)
// written once with a 4-byte index, a few integer operations per element.
// Bytes bound it: the mlp2 weight (768 x 3072 float32, m = 4) moves 18.87 MB,
// 0.00563 ms at 3.35 TB/s.
//
// Design. Two instances; the C entry picks one from w's pointer, m, keep and
// the element size (`ellpack_path_for` reports the choice):
//  - `ellpack_vec<EB, M, KEEP>`, the vector path, when a block is 8 bytes
//    or a multiple of 16 (float32 m = 2, 4, 8, 16; 2-byte types m = 4, 8,
//    16), w's base is aligned to the load width and keep is 1, 2 or 4. A
//    lane loads whole blocks with 16-byte (8-byte for an 8-byte block)
//    read-only loads, so a warp's load covers 512 contiguous bytes (256
//    for 8-byte blocks). It loads its BPT blocks (2-4, one when a block is
//    64 bytes) before it uses any, for memory-level parallelism. Each
//    block's nonzero positions become an m-bit mask; slot j takes the mask's
//    lowest set bit (`__ffs`, which gives -1 once the mask is empty: the
//    padding index) and clears it, and selects its element by compares, so
//    the rank needs no running count and no branch per element. The keep
//    values go out as one 2-16 byte store and the keep indices as one 4-16
//    byte store. Consecutive lanes own consecutive blocks, so the stores of
//    a warp are contiguous too.
//  - `ellpack_scalar<U>`, the scalar path for everything else (a view whose
//    base is not aligned, keep = 3 or 6, m without a vector width, 1-byte
//    elements): one thread per (row, block), grid-stride, element loads, a
//    running count, a store per kept slot.
// Each instance has a float and an integer form (`INT`), which differ only
// in the zero test.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// CTAs per SM the vector path's grid covers before it strides (8 x 256
// threads fill an SM)
constexpr long long kMaxVecBlocks = 132 * 16;
constexpr long long kMaxScalarBlocks = 132 * 32;

// the element's bits that make it nonzero: all of an integer's, a float's
// but the sign
template <int EB, bool INT>
__device__ __forceinline__ bool nonzero_bits(unsigned v) {
  if constexpr (INT) return v != 0u;
  else return (v & (EB == 4 ? 0x7FFFFFFFu : 0x7FFFu)) != 0u;
}

// one element's bits, zero-extended, from the block's 32-bit words
template <int EB>
__device__ __forceinline__ unsigned element(const unsigned* wd, int q) {
  if constexpr (EB == 4) return wd[q];
  else return (wd[q >> 1] >> (16 * (q & 1))) & 0xFFFFu;
}

template <int BYTES>
__device__ __forceinline__ void load_block(const unsigned char* p,
                                           unsigned* wd) {
  if constexpr (BYTES == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    wd[0] = v.x;
    wd[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + c);
      wd[4 * c] = v.x;
      wd[4 * c + 1] = v.y;
      wd[4 * c + 2] = v.z;
      wd[4 * c + 3] = v.w;
    }
  }
}

// KEEP slot values of EB bytes each, as one store of EB * KEEP bytes
template <int EB, int KEEP>
__device__ __forceinline__ void store_values(unsigned char* p,
                                             const unsigned* s) {
  if constexpr (EB == 2 && KEEP == 1) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)s[0];
  } else if constexpr (EB == 2 && KEEP == 2) {
    *reinterpret_cast<unsigned*>(p) = s[0] | (s[1] << 16);
  } else if constexpr (EB == 2) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(s[0] | (s[1] << 16), s[2] | (s[3] << 16));
  } else if constexpr (KEEP == 1) {
    *reinterpret_cast<unsigned*>(p) = s[0];
  } else if constexpr (KEEP == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(s[0], s[1]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// KEEP slot indices as one store of 4 * KEEP bytes
template <int KEEP>
__device__ __forceinline__ void store_indices(int* p, const int* s) {
  if constexpr (KEEP == 1) {
    *p = s[0];
  } else if constexpr (KEEP == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(s[0], s[1]);
  } else {
    *reinterpret_cast<int4*>(p) = make_int4(s[0], s[1], s[2], s[3]);
  }
}

template <int EB, bool INT, int M, int KEEP>
__global__ void __launch_bounds__(kThreads)
ellpack_vec(const unsigned char* __restrict__ w,
            unsigned char* __restrict__ vals, int* __restrict__ idx,
            long long nblocks) {
  constexpr int BYTES = EB * M;
  constexpr int WORDS = BYTES / 4;
  constexpr int BPT = BYTES >= 64 ? 1 : BYTES >= 32 ? 2 : 4;
  constexpr long long TILE = 32LL * BPT;          // blocks per warp tile
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long tile = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
       tile * TILE < nblocks; tile += warps) {
    unsigned wd[BPT][WORDS];
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const long long b = tile * TILE + k * 32 + lane;
      if (b < nblocks) load_block<BYTES>(w + b * BYTES, wd[k]);
    }
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const long long b = tile * TILE + k * 32 + lane;
      if (b >= nblocks) break;
      unsigned e[M];
      unsigned mask = 0u;
#pragma unroll
      for (int q = 0; q < M; ++q) {
        e[q] = element<EB>(wd[k], q);
        mask |= (unsigned)nonzero_bits<EB, INT>(e[q]) << q;
      }
      unsigned sv[KEEP];
      int si[KEEP];
#pragma unroll
      for (int j = 0; j < KEEP; ++j) {
        const int p = __ffs(mask) - 1;            // -1 once the mask is empty
        mask &= mask - 1u;
        unsigned v = 0u;
#pragma unroll
        for (int q = 0; q < M; ++q) v = q == p ? e[q] : v;
        sv[j] = v;
        si[j] = p;
      }
      store_values<EB, KEEP>(vals + b * (EB * KEEP), sv);
      store_indices<KEEP>(idx + b * KEEP, si);
    }
  }
}

template <typename U, bool INT>
__global__ void __launch_bounds__(kThreads)
ellpack_scalar(const U* __restrict__ w, U* __restrict__ vals,
               int* __restrict__ idx, long long nblocks, int m, int keep) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < nblocks; g += step) {
    const U* src = w + g * m;
    U* vdst = vals + g * keep;
    int* idst = idx + g * keep;
    int rank = 0;
    for (int p = 0; p < m; ++p) {
      const U v = src[p];
      if (nonzero_bits<sizeof(U), INT>(v)) {
        if (rank < keep) {
          vdst[rank] = v;
          idst[rank] = p;
        }
        ++rank;
      }
    }
    for (int s = min(rank, keep); s < keep; ++s) {
      vdst[s] = U(0);
      idst[s] = -1;
    }
  }
}

template <int EB, bool INT, int M, int KEEP>
int launch_vec(const void* w, void* vals, int* idx, long long nblocks,
               cudaStream_t stream) {
  constexpr int BYTES = EB * M;
  constexpr long long per_cta =
      (long long)kThreads * (BYTES >= 64 ? 1 : BYTES >= 32 ? 2 : 4);
  long long blocks = (nblocks + per_cta - 1) / per_cta;
  if (blocks > kMaxVecBlocks) blocks = kMaxVecBlocks;
  ellpack_vec<EB, INT, M, KEEP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(w), static_cast<unsigned char*>(vals),
      idx, nblocks);
  return (int)cudaGetLastError();
}

using VecLaunch = int (*)(const void*, void*, int*, long long, cudaStream_t);

template <int EB, bool INT, int M>
VecLaunch vec_keep(int keep) {
  switch (keep) {
    case 1: return launch_vec<EB, INT, M, 1>;
    case 2: return launch_vec<EB, INT, M, 2>;
    case 4: return launch_vec<EB, INT, M, 4>;
  }
  return nullptr;
}

template <bool INT>
VecLaunch vec_instance(int m, int keep, int elem_bytes) {
  if (elem_bytes == 4) {
    switch (m) {
      case 2: return vec_keep<4, INT, 2>(keep);
      case 4: return vec_keep<4, INT, 4>(keep);
      case 8: return vec_keep<4, INT, 8>(keep);
      case 16: return vec_keep<4, INT, 16>(keep);
    }
  } else if (elem_bytes == 2) {
    switch (m) {
      case 4: return vec_keep<2, INT, 4>(keep);
      case 8: return vec_keep<2, INT, 8>(keep);
      case 16: return vec_keep<2, INT, 16>(keep);
    }
  }
  return nullptr;
}

// the vector instance for (elem_bytes, m, keep) when w's base is aligned to
// its load width (8 bytes for an 8-byte block, else 16); null otherwise
VecLaunch vec_path(const void* w, int m, int keep, int elem_bytes,
                   bool is_int) {
  VecLaunch f = is_int ? vec_instance<true>(m, keep, elem_bytes)
                       : vec_instance<false>(m, keep, elem_bytes);
  const uintptr_t align = elem_bytes * m == 8 ? 8 : 16;
  return reinterpret_cast<uintptr_t>(w) % align == 0 ? f : nullptr;
}

template <typename U, bool INT>
int launch_scalar(const void* w, void* vals, int* idx, long long nblocks,
                  int m, int keep, cudaStream_t stream) {
  long long blocks = (nblocks + kThreads - 1) / kThreads;
  if (blocks > kMaxScalarBlocks) blocks = kMaxScalarBlocks;
  ellpack_scalar<U, INT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(w), static_cast<U*>(vals), idx, nblocks, m, keep);
  return (int)cudaGetLastError();
}

template <bool INT>
int launch_scalar_bytes(const void* w, void* vals, int* idx,
                        long long nblocks, int m, int keep, int elem_bytes,
                        cudaStream_t s) {
  switch (elem_bytes) {
    case 4: return launch_scalar<uint32_t, INT>(w, vals, idx, nblocks, m,
                                                keep, s);
    case 2: return launch_scalar<uint16_t, INT>(w, vals, idx, nblocks, m,
                                                keep, s);
    case 1:
      if constexpr (INT)
        return launch_scalar<uint8_t, INT>(w, vals, idx, nblocks, m, keep,
                                           s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// 1 when ellpack_pack_launch takes the vector path for this w, m, keep and
// element size, 0 when it takes the scalar path (the same for a float and
// an integer type of one size).
extern "C" int ellpack_path_for(const void* w, int m, int keep,
                                int elem_bytes) {
  return vec_path(w, m, keep, elem_bytes, false) != nullptr;
}

// w: (nblocks * m,) elements of `elem_bytes` bytes, i.e. (rows, K) with
// nblocks = rows * K / m: with is_int = 0 float32 (4), bfloat16 or float16
// (2); with is_int = 1 int32 (4), int16 (2), int8 or uint8 (1). vals:
// (nblocks, keep) elements of the same size; idx: (nblocks, keep) int32;
// all contiguous, vals and idx aligned to their per-block stores (as a
// fresh allocation is). Takes the vector path where `ellpack_path_for`
// says so, else the scalar path. Launches on `stream` and returns the CUDA
// error of the launch (0 = none; cudaErrorInvalidValue for another element
// size).
extern "C" int ellpack_pack_launch(const void* w, void* vals, int* idx,
                                   long long nblocks, int m, int keep,
                                   int elem_bytes, int is_int,
                                   void* stream) {
  if (nblocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (VecLaunch f = vec_path(w, m, keep, elem_bytes, is_int != 0))
    return f(w, vals, idx, nblocks, s);
  return is_int ? launch_scalar_bytes<true>(w, vals, idx, nblocks, m, keep,
                                            elem_bytes, s)
                : launch_scalar_bytes<false>(w, vals, idx, nblocks, m, keep,
                                             elem_bytes, s);
}
