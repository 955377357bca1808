// Per-cycle SRAM bank-conflict slowdown (paper Sec. VI) for NVIDIA Hopper.
//
// Replaces the Pallas kernel `repro.kernels.conflict.conflict.conflict_slowdown`
// (body `_conflict_kernel`). For each row (one cycle) of k (line, bank) ids:
//
//     slowdown = max(1, max_b ceil(#distinct (bank, line) in bank b / ports))
//
// Bound on this card: the function reads 8 bytes per id pair and writes 4
// per row; a comparison sort needs about k log2 k compares per row, so at
// the layout stage's k = 128 the bytes bound it.
//
// Design: two instances in one source, chosen by k.
//
// * Register instances, k <= 256 (`conflict_regs<L>`): rows padded to
//   K = 32, 64, 128 or 256 ids, each held by L = K / 16 lanes, 16 ids a
//   lane, so a warp works on 32 / L rows at once, rows grid-stride (16-
//   byte loads when rows and bases allow, element loads otherwise; the
//   loads hide behind other warps: a prefetch of the next rows into
//   registers cost occupancy and ran slower). Ids past
//   k take element 0's key, which adds no distinct pair. Each (bank, line)
//   pair becomes one key, bank in the high bits, so equal pairs are equal
//   keys and a bank's keys are one run of the sorted order:
//     - 32-bit keys, bank << lbits | line, when the warp's ids are
//       non-negative and fit in 31 bits together (every row the layout
//       stage makes): half the shuffles and compares of
//     - 64-bit keys, (uint32)bank << 32 | (uint32)line, for any int32 ids.
//   A bitonic network in its one-direction form sorts each row's keys in
//   registers: merge distances below 16 inside each lane, where a
//   compare-exchange is one min and one max, the longer ones (log2 L of
//   the log2 K levels) by __shfl_xor_sync. Then a key is the first of its
//   pair if it differs from its predecessor; a scan over the row's lanes
//   counts firsts (P), a max-scan carries P at the start of each bank's
//   run (M), so P - M + 1 is the number of distinct pairs of the bank so
//   far, and its maximum over the row is the worst bank. No pass reads
//   shared memory. Why 16 ids a lane: an in-lane compare-exchange costs
//   about one instruction per key, an across-lane one about three (the
//   shuffle, the compare, the pick); at one row per warp (4 ids a lane at
//   K = 128) the across-lane steps are 15 of 28, at 16 ids a lane 6.
//
// * Shared-memory instance, any k (`conflict_smem`): the original kernel,
//   unchanged in its arithmetic. One warp per row with the row's ids in
//   its slice of shared memory; element j is first iff no j' < j holds
//   the same pair, and each first element counts the first elements of
//   its bank (two O(k^2) broadcast loops).
//
// No num_banks-sized table exists, so both take any bank count. An id whose
// bank lies outside [0, num_banks), negative included, is counted in no
// bank, as the Pallas kernel's one-hot against iota(num_banks) drops it:
// both instances mask it at load time (one unsigned compare per id) into
// the pair (num_banks, 0). All such ids share that one pair, which adds a
// bank of one distinct pair, below the floor of 1 the slowdown has anyway.
// The layout stage's `flat_ids` never makes such an id.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

// ---- register instances ----------------------------------------------------

constexpr int kE = 16;                  // ids per lane
constexpr int kRegThreads = 256;

// The ids of one row as this lane loaded them: elements l E + e of the row,
// l the lane's index within the row's L lanes; ids past k (and every id of
// a row past the last) come out 0, and `row_worst` replaces their keys.
// `vec`: k % 4 == 0 and both bases 16-byte aligned, so every 4-id group
// lies wholly inside or past an aligned row.
struct RowIds {
  int line[kE];
  int bank[kE];
};

// An id outside [0, num_banks) becomes the pair (num_banks, 0).
__device__ __forceinline__ void drop_out_of_range(int& line, int& bank,
                                                  int num_banks) {
  if ((unsigned)bank >= (unsigned)num_banks) {
    bank = num_banks;
    line = 0;
  }
}

__device__ __forceinline__ void load_row(const int* __restrict__ lr,
                                         const int* __restrict__ br, int k,
                                         int base, bool in_rows, bool vec,
                                         int num_banks, RowIds& ids) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kE; q += 4) {
      int4 l = make_int4(0, 0, 0, 0), b = l;
      if (in_rows && base + q < k) {
        l = *reinterpret_cast<const int4*>(lr + base + q);
        b = *reinterpret_cast<const int4*>(br + base + q);
      }
      ids.line[q] = l.x; ids.line[q + 1] = l.y;
      ids.line[q + 2] = l.z; ids.line[q + 3] = l.w;
      ids.bank[q] = b.x; ids.bank[q + 1] = b.y;
      ids.bank[q + 2] = b.z; ids.bank[q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const bool in = in_rows && base + e < k;
      ids.line[e] = in ? lr[base + e] : 0;
      ids.bank[e] = in ? br[base + e] : 0;
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e)
    drop_out_of_range(ids.line[e], ids.bank[e], num_banks);
}

template <typename Key>
__device__ __forceinline__ void order(Key& lo, Key& hi) {
  const Key a = lo, b = hi;
  lo = a < b ? a : b;
  hi = a < b ? b : a;
}

// Across lanes: keep the smaller key in the lower element of each pair.
template <typename Key>
__device__ __forceinline__ Key keep(Key mine, Key other, bool lower) {
  return lower ? (mine < other ? mine : other)
               : (mine < other ? other : mine);
}

// Sort the row's K = L E keys ascending, element l E + e in keys[e] of the
// row's lane l: the bitonic network in its one-direction form (each merge
// of blocks of s compares i with its mirror i ^ (s - 1), then i with
// i ^ j for j = s / 4 .. 1, the smaller key to the lower index), so a
// compare-exchange inside a lane is one min and one max with no select.
template <int L, typename Key>
__device__ __forceinline__ void bitonic_sort(Key (&keys)[kE], int l) {
  constexpr int K = L * kE;
#pragma unroll
  for (int s = 2; s <= K; s <<= 1) {
    if (s <= kE) {                               // mirror inside the lane
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (!(e & (s >> 1))) order(keys[e], keys[e ^ (s - 1)]);
    } else {                                     // mirror across lanes
      const int m = s / kE - 1;
      const bool lower = (l & (s / kE >> 1)) == 0;
#pragma unroll
      for (int e = 0; e < kE / 2; ++e) {
        const Key a = __shfl_xor_sync(kFull, keys[kE - 1 - e], m);
        const Key b = __shfl_xor_sync(kFull, keys[e], m);
        keys[e] = keep(keys[e], a, lower);
        keys[kE - 1 - e] = keep(keys[kE - 1 - e], b, lower);
      }
    }
#pragma unroll
    for (int j = s >> 2; j > 0; j >>= 1) {
      if (j < kE) {                              // partner in this lane
#pragma unroll
        for (int e = 0; e < kE; ++e)
          if (!(e & j)) order(keys[e], keys[e | j]);
      } else {                                   // partner lane l ^ j / E
        const bool lower = (l & (j / kE)) == 0;
#pragma unroll
        for (int e = 0; e < kE; ++e)
          keys[e] = keep(keys[e], __shfl_xor_sync(kFull, keys[e], j / kE),
                         lower);
      }
    }
  }
}

// The row's worst bank count, max_b #distinct pairs in bank b, from its
// sorted keys (bank = key >> shift), in every lane of the row: a key is
// the first of its pair if it differs from its predecessor; P counts
// firsts (inclusive scan over the row's lanes), M carries P at the start
// of each bank's run (max-scan), and P - M + 1 counts the bank's distinct
// pairs so far.
template <int L, typename Key>
__device__ __forceinline__ int worst_bank(const Key (&keys)[kE], int shift,
                                          int l) {
  const Key before = __shfl_up_sync(kFull, keys[kE - 1], 1, L);
  unsigned first = 0, start = 0;                 // bit e: element e is a
#pragma unroll                                   // first / a bank's first
  for (int e = 0; e < kE; ++e) {
    const bool head = l == 0 && e == 0;
    const Key p = e ? keys[e - 1] : before;
    first |= (unsigned)(head || keys[e] != p) << e;
    start |= (unsigned)(head || (keys[e] >> shift) != (p >> shift)) << e;
  }
  const int run = __popc(first);
  int incl = run;                                // P: firsts so far
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d, L);
    if (l >= d) incl += y;
  }
  const int off = incl - run;
  // M: P at the lane's last bank start, max-scanned over the row's lanes
  int mincl = start ? off + __popc(first & (2u << (31 - __clz(start))) - 1)
                    : 0;
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
    const int y = __shfl_up_sync(kFull, mincl, d, L);
    if (l >= d) mincl = max(mincl, y);
  }
  int m = __shfl_up_sync(kFull, mincl, 1, L);
  if (l == 0) m = 0;
  int p = off, worst = 0;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    p += (first >> e) & 1;
    if ((start >> e) & 1) m = p;                 // P never decreases
    worst = max(worst, p - m + 1);
  }
#pragma unroll
  for (int d = 1; d < L; d <<= 1)
    worst = max(worst, __shfl_xor_sync(kFull, worst, d));
  return worst;
}

// 32-bit keys (Key = unsigned, bank << lbits | line) or 64-bit keys
// (bank << 32 | line); ids past k take element 0's key, which adds no
// distinct pair.
template <int L, typename Key>
__device__ __forceinline__ int row_worst(const RowIds& ids, int k, int l,
                                         int lbits) {
  Key keys[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    if constexpr (sizeof(Key) == 4)
      keys[e] = ((unsigned)ids.bank[e] << lbits) | (unsigned)ids.line[e];
    else
      keys[e] = ((u64)(unsigned)ids.bank[e] << 32) | (unsigned)ids.line[e];
  }
  if (k < L * kE) {
    const Key k0 = __shfl_sync(kFull, keys[0], 0, L);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (l * kE + e >= k) keys[e] = k0;
  }
  bitonic_sort<L, Key>(keys, l);
  return worst_bank<L, Key>(keys, sizeof(Key) == 4 ? lbits : 32, l);
}

// One row per L lanes (32 / L rows per warp in flight), rows grid-stride.
template <int L>
__global__ void __launch_bounds__(kRegThreads)
conflict_regs(const int* __restrict__ line, const int* __restrict__ bank,
              int* __restrict__ out, long long rows, int k, int num_banks,
              int ports, bool vec) {
  constexpr int kRowsPerWarp = 32 / L;
  const int lane = threadIdx.x & 31;
  const int l = lane % L;
  const long long warp =
      ((long long)blockIdx.x * kRegThreads + threadIdx.x) >> 5;
  const long long step =
      (long long)gridDim.x * (kRegThreads / 32) * kRowsPerWarp;
  long long r = warp * kRowsPerWarp + lane / L;
  if (r - lane / L >= rows) return;              // the whole warp is past
  for (; r - lane / L < rows; r += step) {
    RowIds cur;
    load_row(line + r * k, bank + r * k, k, l * kE, r < rows, vec,
             num_banks, cur);
    // 32-bit keys when the warp's ids are non-negative and the bank and
    // line bits fit in 31 together (ids past k and past the last row are
    // 0, so they leave the test unchanged)
    unsigned lor = 0, bor = 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      lor |= (unsigned)cur.line[e];
      bor |= (unsigned)cur.bank[e];
    }
    lor = __reduce_or_sync(kFull, lor);
    bor = __reduce_or_sync(kFull, bor);
    const int lbits = 32 - __clz(lor), bbits = 32 - __clz(bor);
    const int worst = lbits + bbits <= 31
        ? row_worst<L, unsigned>(cur, k, l, lbits)
        : row_worst<L, u64>(cur, k, l, 0);
    if (l == 0 && r < rows) out[r] = max(1, (worst + ports - 1) / ports);
  }
}

// ---- shared-memory instance -------------------------------------------------

constexpr int kSmemWarps = 4;           // warps (rows in flight) per block

__global__ void __launch_bounds__(kSmemWarps * 32)
conflict_smem(const int* __restrict__ line, const int* __restrict__ bank,
              int* __restrict__ out, long long rows, int k, int num_banks,
              int ports) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* s_line = smem + warp * 3 * k;
  int* s_bank = s_line + k;
  int* s_first = s_bank + k;
  const long long step = (long long)gridDim.x * kSmemWarps;
  for (long long r = (long long)blockIdx.x * kSmemWarps + warp; r < rows;
       r += step) {
    const int* lr = line + r * k;
    const int* br = bank + r * k;
    for (int j = lane; j < k; j += 32) {
      int l = lr[j], b = br[j];
      drop_out_of_range(l, b, num_banks);
      s_line[j] = l;
      s_bank[j] = b;
    }
    __syncwarp();
    // 1. first occurrences
    for (int j = lane; j < k; j += 32) {
      const int l = s_line[j], b = s_bank[j];
      int first = 1;
      for (int jp = 0; jp < j; ++jp) {
        if (s_line[jp] == l && s_bank[jp] == b) {
          first = 0;
          break;
        }
      }
      s_first[j] = first;
    }
    __syncwarp();
    // 2. distinct lines per bank, seen from each first element
    int worst = 1;
    for (int j = lane; j < k; j += 32) {
      if (!s_first[j]) continue;
      const int b = s_bank[j];
      int cnt = 0;
      for (int jp = 0; jp < k; ++jp) cnt += s_first[jp] & (s_bank[jp] == b);
      worst = max(worst, (cnt + ports - 1) / ports);
    }
    worst = __reduce_max_sync(kFull, worst);
    if (lane == 0) out[r] = worst;
    __syncwarp();           // the next row overwrites this warp's slice
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int L>
int launch_regs(const int* line, const int* bank, int* out, long long rows,
                int k, int num_banks, int ports, cudaStream_t stream) {
  const bool vec = k % 4 == 0 && ((uintptr_t)line & 15) == 0
                   && ((uintptr_t)bank & 15) == 0;
  constexpr int kRowsPerBlock = kRegThreads / 32 * (32 / L);
  long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  int resident = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, conflict_regs<L>, kRegThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long cap = (long long)sm_count() * (resident > 0 ? resident : 1);
  if (blocks > cap) blocks = cap;
  conflict_regs<L><<<(unsigned)blocks, kRegThreads, 0, stream>>>(
      line, bank, out, rows, k, num_banks, ports, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The instance `conflict_slowdown_launch` runs for rows of k ids when its
// `instance` is 0: the smallest register width K in {32, 64, 128, 256}
// with k <= K, or -1 (shared memory) for k = 0 and k > 256.
extern "C" int conflict_slowdown_instance(int k) {
  if (k <= 0 || k > 256) return -1;
  int K = 32;
  while (K < k) K <<= 1;
  return K;
}

// line, bank: (rows, k) int32, row-major and contiguous; out: (rows,) int32.
// Ids whose bank lies outside [0, num_banks) count in no bank.
// `instance`: 0 picks by k (`conflict_slowdown_instance`); 32, 64, 128 or
// 256 runs that register instance (k must not exceed it); -1 runs the
// shared-memory instance. Launches on `stream` and returns the CUDA error
// of the launch (0 = none; cudaErrorInvalidValue for an instance that
// cannot take k).
extern "C" int conflict_slowdown_launch(const int* line, const int* bank,
                                        int* out, long long rows, int k,
                                        int num_banks, int ports,
                                        int instance, void* stream) {
  if (instance == 0) instance = conflict_slowdown_instance(k);
  if (instance > 0 && (k < 1 || k > instance))
    return (int)cudaErrorInvalidValue;
  if (num_banks < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (instance) {
    case 32:
      return launch_regs<32 / kE>(line, bank, out, rows, k, num_banks, ports,
                                   s);
    case 64:
      return launch_regs<64 / kE>(line, bank, out, rows, k, num_banks, ports,
                                   s);
    case 128:
      return launch_regs<128 / kE>(line, bank, out, rows, k, num_banks, ports,
                                   s);
    case 256:
      return launch_regs<256 / kE>(line, bank, out, rows, k, num_banks, ports,
                                   s);
    case -1: break;
    default: return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)kSmemWarps * 3 * k * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conflict_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (rows + kSmemWarps - 1) / kSmemWarps;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  conflict_smem<<<(unsigned)blocks, kSmemWarps * 32, smem, s>>>(
      line, bank, out, rows, k, num_banks, ports);
  return (int)cudaGetLastError();
}
