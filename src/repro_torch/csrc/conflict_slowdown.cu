// Per-cycle SRAM bank-conflict slowdown (paper Sec. VI) for NVIDIA Hopper.
//
// Replaces the Pallas kernel `repro.kernels.conflict.conflict.conflict_slowdown`
// (body `_conflict_kernel`). For each row (one cycle) of k (line, bank) ids:
//
//     slowdown = max(1, max_b ceil(#distinct (bank, line) in bank b / ports))
//
// Design. One warp owns one row at a time (grid-stride over rows), with the
// row's ids in the warp's slice of shared memory; lane l owns the elements
// j = l, l + 32, ... Two passes, each separated by __syncwarp:
//   1. element j is the first of its (bank, line) pair iff no j' < j holds
//      the same pair (the TPU kernel's O(k^2) earlier-equal test, without a
//      (k, k) mask: lanes walk j' together, so every shared-memory read is a
//      broadcast);
//   2. for each first element j, count the first elements that share its
//      bank; the row's slowdown is max(1, max_j ceil(count_j / ports)),
//      reduced over the warp with __reduce_max_sync.
// No num_banks-sized table exists, so the kernel takes any bank count.
//
// Bound on this card: the function reads 8 bytes per id pair and writes 4
// per row, against k(k-1)/2 pair tests per row; at the layout stage's k =
// 128 the bytes bound it, and this simple form is limited by its shared-
// memory instruction count instead (about k^2 / 32 loads per lane and row).
//
// Contract: bank ids lie in [0, num_banks) (the layout stage's `flat_ids`
// keeps them there); the kernel itself never indexes by a bank id.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // warps (rows in flight) per block
constexpr long long kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kWarps * 32)
conflict_kernel(const int* __restrict__ line, const int* __restrict__ bank,
                int* __restrict__ out, long long rows, int k, int ports) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* s_line = smem + warp * 3 * k;
  int* s_bank = s_line + k;
  int* s_first = s_bank + k;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += step) {
    const int* lr = line + r * k;
    const int* br = bank + r * k;
    for (int j = lane; j < k; j += 32) {
      s_line[j] = lr[j];
      s_bank[j] = br[j];
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
    worst = __reduce_max_sync(0xffffffffu, worst);
    if (lane == 0) out[r] = worst;
    __syncwarp();           // the next row overwrites this warp's slice
  }
}

}  // namespace

// line, bank: (rows, k) int32, row-major and contiguous; out: (rows,) int32.
// Launches on `stream` and returns the CUDA error of the launch (0 = none).
extern "C" int conflict_slowdown_launch(const int* line, const int* bank,
                                        int* out, long long rows, int k,
                                        int ports, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = (size_t)kWarps * 3 * k * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conflict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  conflict_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                    (cudaStream_t)stream>>>(line, bank, out, rows, k, ports);
  return (int)cudaGetLastError();
}
