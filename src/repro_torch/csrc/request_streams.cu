// Demand-request streams of a batch of GEMMs for NVIDIA Hopper: generate
// every slot, put it in its place in issue-time order and decode its
// address, in one launch.
//
// Replaces no Pallas kernel: the reference computes this layer in `jnp`
// (`repro.trace.generator.gemm_request_stream`, which orders a stream by
// its 4-way merge `_merge_sort_order`, then `repro.core.dram.
// decode_requests`). It was added because the port's version of that
// layer (dozens of elementwise passes over (streams, cap) float32 and
// int64 tensors, a segmented radix sort and its gathers) took 76 % of a
// vit_base trace-sweep pass at cap 65,536.
//
// Bound on this card: the function writes 18 bytes a slot (t float32;
// flat bank, channel and row int32; is_write and valid one byte each) and
// reads one 256-byte row of factors a stream; one vit_base group of
// 1,776 x 65,536 slots writes 2.10 GB, 0.63 ms at 3.35 TB/s. Its
// arithmetic (about 100 float32 operations a slot and the rank's probes,
// below) stays under that at the card's 67 TFLOP/s, so the bytes bound it.
//
// Design. The wrapper packs what depends only on a stream or on (stream,
// region) (`trace.generator.stream_prologue`) into one row of `kNP`
// floats a stream. One warp takes a task of `kSeg` consecutive slots of
// one stream, 32 at a time, with the stream's row in its slice of shared
// memory; a block holds 8 tasks, and the grid every task, so the card's
// scheduler balances tasks of unequal cost. Each lane computes its slot's
// region, within-region index, operand walk, layout index (row, col,
// tiled or strided), address, DRAM decode and issue time. Its place in
// the sorted stream, its rank, is the reference's merge: the slot's
// offset within its region plus, for each other region, the count of that
// region's slots that issue before it (at the same time counts for an
// earlier region, not for a later one: a stable sort). The issue time is
// non-decreasing within each region, so each count is a search; a probe
// recomputes the probed slot's issue time from the row, and no time goes
// to memory. Invalid slots (i >= n_model) keep rank i: they sort last, in
// stream order, as the generator's `_BIG_T` key puts them. Within 32 slots
// of one region the counts rise with the lane and with the slots before,
// so the warp starts from the previous 32 slots' count (or a 32-way
// search: one probe a lane, a ballot a round): the lanes probe the next
// 32 slots of the other region, and a lane whose count falls among them
// finds it by shuffles over those times; past them, the warp gallops to
// the last lane's count and each lane left bisects. A warp whose slots
// straddle a region boundary (at most three a stream) bisects each lane's
// counts over the whole region. Within a region, ranks rise with the
// slot, so a warp's stores fall in few lines.
//
// Bits. Every float32 operation is PyTorch's on the same values, one
// rounding each, in the generator's order: `__fmul_rn`, `__fadd_rn` and
// `__fsub_rn` where a product meets a sum (nvcc would contract them into
// an FMA); divisions by `__fdiv_rn`, never by a reciprocal, as a CUDA
// division by a device tensor is; `rem` is `torch.remainder`'s rule and
// `floordiv_host` PyTorch's CUDA floor division by a host scalar. The
// address guard keeps the least and greatest address of every slot,
// valid or not, in two words (`span`), as `core.dram.check_addresses`
// scans them; the decode's integer math is exact, so the int32 it writes
// equal `decode_requests`' (the int64 math for an address outside
// [0, 2^31), which the wrapper refuses).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNP = 64;                 // floats in a stream's row
constexpr long long kSeg = 512;         // slots of a warp's task
constexpr long long kMaxCap = 1LL << 24;  // float32 counts slots exactly
constexpr float kBigT = 1e15f;          // the generator's `_BIG_T`
constexpr long long kRegionSpan = 1LL << 25;
constexpr unsigned long long kSign = 0x8000000000000000ull;

// A stream's row, as the wrapper packs it (`streams.pack_rows`); (4) fields
// hold one float a region.
enum Field {
  F_NMODEL = 0,   // n_model
  F_EDGE = 1,     // edges[0..2] (3)
  F_START = 4,    // starts (4)
  F_Q = 8,        // q (4)
  F_NTM1 = 12,    // n_tiles - 1
  F_TCYC = 13,    // tile_cyc
  F_FAST = 14,    // fast_len (4)
  F_SLOW = 18,    // slow_len (4)
  F_FA1 = 22,     // the fast walk's `_modmul` factors (4, 4)
  F_FA64 = 26,
  F_SA1 = 30,     // the slow walk's (4, 4)
  F_SA64 = 34,
  F_ROWS = 38,    // operand rows (4)
  F_COLS = 42,    // operand columns (4)
  F_TPR = 46,     // tiles a tile row, tiled layout (4)
  F_XA1 = 50,     // the strided layout's `_modmul` factors
  F_XA64 = 51,
};

enum Layout { L_ROW = 0, L_COL = 1, L_TILED = 2, L_STRIDED = 3 };

struct Consts {
  long long n_streams, cap, seg;
  int os, layout, fast_row, wb;
  long long burst, channels, banks, bursts_per_row, row_div;
  float g_el, span, tile_r, tile_c, inv_tile_r, inv_tile_c, tile_rc;
};

// torch.remainder on float32: fmod, moved into the divisor's sign.
__device__ __forceinline__ float rem(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m = __fadd_rn(m, b);
  return m;
}

// PyTorch's CUDA floor division of a float32 tensor by a host scalar b
// (`x // tile` in `core.layout.operand_linear_index`): by b's reciprocal,
// then Python's floor rule.
__device__ __forceinline__ float floordiv_host(float a, float b,
                                               float inv_b) {
  const float mod = fmodf(a, b);
  float div = __fmul_rn(__fsub_rn(a, mod), inv_b);
  if (mod != 0.f && ((b < 0.f) != (mod < 0.f))) div = __fsub_rn(div, 1.f);
  if (div == 0.f) return copysignf(0.f, __fmul_rn(a, inv_b));
  float fl = floorf(div);
  if (__fsub_rn(div, fl) > 0.5f) fl = __fadd_rn(fl, 1.f);
  return fl;
}

// `trace.generator._modmul_apply`: mod(j * a, L) from a's factors.
__device__ __forceinline__ float modmul(float j, float a1, float a64,
                                        float L) {
  const float j_hi = floorf(__fmul_rn(j, 0.015625f));      // j / 64.0
  const float j_lo = __fsub_rn(j, __fmul_rn(64.f, j_hi));
  return rem(__fadd_rn(__fmul_rn(j_lo, a1), __fmul_rn(j_hi, a64)), L);
}

// The within-region index of slot fi of region r.
__device__ __forceinline__ float region_index(const float* P, int r,
                                              float fi) {
  return fmaxf(__fsub_rn(fi, P[F_START + r]), 0.f);
}

// Issue time of slot fi of region r: the double-buffered prefetch
// schedule of `trace.generator.stream_slots`.
__device__ __forceinline__ float issue_time(const float* P, int r, float fi,
                                            bool os) {
  const float j = region_index(P, r, fi);
  const float pos = __fdiv_rn(j, P[F_Q + r]);
  const float tau = fminf(fmaxf(floorf(pos), 0.f), P[F_NTM1]);
  const float tc = P[F_TCYC];
  if (r < 2) return __fmul_rn(fmaxf(__fsub_rn(tau, 1.f), 0.f), tc);
  if (r == 3 && os) return __fmul_rn(__fadd_rn(tau, 1.f), tc);
  const float frac = fminf(fmaxf(__fsub_rn(pos, tau), 0.f), 1.f);
  return __fmul_rn(__fadd_rn(tau, frac), tc);
}

// The byte address of slot fi of region r (int64, as the generator's).
__device__ __forceinline__ long long slot_address(const float* P,
                                                  const Consts& k, int r,
                                                  float fi) {
  const float j = region_index(P, r, fi);
  const float fl = P[F_FAST + r], sl = P[F_SLOW + r];
  const float j_b = floorf(__fdiv_rn(j, 64.f));            // run id
  const float j_i = __fsub_rn(j, __fmul_rn(64.f, j_b));    // granule in run
  const float gi = __fmul_rn(j_i, k.g_el);
  const float f = rem(__fadd_rn(modmul(j_b, P[F_FA1 + r], P[F_FA64 + r], fl),
                                gi), fl);
  const float lines = __fadd_rn(
      modmul(j_b, P[F_SA1 + r], P[F_SA64 + r], sl), __fdiv_rn(gi, fl));
  const float s = rem(floorf(lines), sl);
  const bool frow = (k.fast_row >> r) & 1;
  const float row = frow ? f : s, col = frow ? s : f;
  float idx;
  if (k.layout == L_ROW) {
    idx = rem(__fadd_rn(__fmul_rn(row, P[F_COLS + r]), col), k.span);
  } else if (k.layout == L_COL) {
    idx = rem(__fadd_rn(__fmul_rn(col, P[F_ROWS + r]), row), k.span);
  } else if (k.layout == L_TILED) {
    const float tile_id = __fadd_rn(
        __fmul_rn(floordiv_host(row, k.tile_r, k.inv_tile_r), P[F_TPR + r]),
        floordiv_host(col, k.tile_c, k.inv_tile_c));
    idx = __fadd_rn(__fadd_rn(__fmul_rn(tile_id, k.tile_rc),
                              __fmul_rn(rem(row, k.tile_r), k.tile_c)),
                    rem(col, k.tile_c));
    idx = rem(idx, k.span);
  } else {
    idx = modmul(j, P[F_XA1], P[F_XA64], k.span);
  }
  const long long ar = r < 2 ? r : 2;      // spill reads share the ofmap's
  return ar * kRegionSpan + (long long)floorf(idx) * k.wb;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// `core.dram.decode_requests`: (flat bank, channel, row). Addresses in
// [0, 2^31) take 32-bit math when the row divisor fits in 32 bits, which is
// exact there; others Python's floor rule in int64.
__device__ __forceinline__ void decode(const Consts& k, long long addr,
                                       int& fb, int& ch, int& row) {
  if (addr >= 0 && addr < (1LL << 31) && k.row_div <= 0xffffffffLL) {
    const unsigned b = (unsigned)addr / (unsigned)k.burst;
    const unsigned c = b % (unsigned)k.channels;
    const unsigned r = b / (unsigned)k.channels;
    const unsigned bank = (r / (unsigned)k.bursts_per_row) % (unsigned)k.banks;
    row = (int)(r / (unsigned)k.row_div);
    fb = (int)(c * (unsigned)k.banks + bank);
    ch = (int)c;
    return;
  }
  const long long b = floor_div(addr, k.burst);
  const long long c = b - floor_div(b, k.channels) * k.channels;
  const long long r = floor_div(b, k.channels);
  const long long q = floor_div(r, k.bursts_per_row);
  const long long bank = q - floor_div(q, k.banks) * k.banks;
  row = (int)floor_div(r, k.row_div);
  fb = (int)(c * k.banks + bank);
  ch = (int)c;
}

// Does a slot of issue time t of region r2 sort before a slot of key
// `key` of region r? `strict` when r2 comes later (an equal time sorts
// after), else <=.
__device__ __forceinline__ bool ahead(float t, float key, bool strict) {
  return strict ? t < key : t <= key;
}

// ... for valid slot s2 + idx of region r2.
__device__ __forceinline__ bool before(const float* P, int r2, int s2,
                                       int idx, float key, bool strict,
                                       bool os) {
  return ahead(issue_time(P, r2, (float)(s2 + idx), os), key, strict);
}

// Warp-wide: the count c in [lo, hi] of region r2's valid slots (indices
// [0, hi) past s2) that sort before `key`, given that the first lo do.
// Every lane probes one index a round and a ballot narrows the range
// 32-fold; `gallop` first widens a 32-slot window from lo 32-fold a round
// (a count near lo). Called by the whole warp with the same arguments.
__device__ int warp_count(const float* P, int r2, int s2, float key,
                          bool strict, int lo, int hi, bool gallop, bool os,
                          int lane) {
  int w = 32;                            // < 2^30: past hi - lo <= 2^24
  bool bisect = !gallop;                 // it stops growing
  while (lo < hi) {
    const int n = hi - lo;
    const int win = bisect || w > n ? n : w;
    if (win <= 32) {
      const bool ok = lane < win &&
                      before(P, r2, s2, lo + lane, key, strict, os);
      const int t = __popc(__ballot_sync(kFull, ok));
      lo += t;
      if (t < win) return lo;
      w <<= 5;
      continue;
    }
    const int p = lo + (win * (lane + 1)) / 32 - 1;
    const int t =
        __popc(__ballot_sync(kFull, before(P, r2, s2, p, key, strict, os)));
    if (t == 32) {                   // the whole window sorts before
      lo += win;
      w <<= 5;
      continue;
    }
    hi = lo + (win * (t + 1)) / 32 - 1;        // the first probe after
    lo = t > 0 ? lo + (win * t) / 32 : lo;     // one past the last before
    bisect = true;
  }
  return lo;
}

// One lane: the same count, bisected in [lo, hi].
__device__ __forceinline__ int lane_count(const float* P, int r2, int s2,
                                          float key, bool strict, int lo,
                                          int hi, bool os) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (before(P, r2, s2, mid, key, strict, os)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Warp-wide: lane m holds tm, the issue time of the m-th slot of a window
// of w <= 32 (times non-decreasing); each lane gets the count of the
// window's slots that sort before its own key, by halving steps over the
// lanes' times (shuffles, no probe).
__device__ __forceinline__ int window_count(float tm, float key, bool strict,
                                            int w) {
  int c = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1) {
    const int m = c + step - 1;
    const float tv = __shfl_sync(kFull, tm, m & 31);
    if (m < w && ahead(tv, key, strict)) c += step;
  }
  return c;
}

// #{i in [0, cap): (float)i < e}, for cap <= 2^24.
__device__ __forceinline__ int count_below(float e, int cap) {
  if (!(e > 0.f)) return 0;
  if (e >= (float)cap) return cap;
  return (int)ceilf(e);
}

// One warp a task: `seg` consecutive slots of one stream, 32 at a time.
__global__ void __launch_bounds__(kThreads)
request_streams(const float* __restrict__ params, Consts k,
                float* __restrict__ t_out, int* __restrict__ fb_out,
                int* __restrict__ ch_out, int* __restrict__ row_out,
                unsigned char* __restrict__ w_out,
                unsigned char* __restrict__ v_out,
                unsigned long long* __restrict__ span_out) {
  __shared__ float s_row[kWarps][kNP];
  __shared__ int s_int[kWarps][9];         // region starts (5), valid (4)
  __shared__ unsigned long long s_span[kWarps][2];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  float* P = s_row[wid];
  int* S = s_int[wid];                     // S[r]: first slot of region r
  int* NV = S + 5;                         // NV[r]: its valid slots
  const int cap = (int)k.cap;
  const bool os = k.os != 0;
  const long long per_stream = (k.cap + k.seg - 1) / k.seg;
  const long long task = (long long)blockIdx.x * kWarps + wid;
  unsigned long long amin = ~0ull, amax = 0ull;   // sign-flipped addresses

  if (task < k.n_streams * per_stream) {
    const long long stream = task / per_stream;
    const int base = (int)(task % per_stream * k.seg);
    const int end = (int)min(base + k.seg, k.cap);
    P[lane] = params[stream * kNP + lane];
    P[lane + 32] = params[stream * kNP + 32 + lane];
    __syncwarp();
    if (lane == 0) {
      S[0] = 0;
      S[1] = count_below(P[F_EDGE], cap);
      S[2] = count_below(P[F_EDGE + 1], cap);
      S[3] = count_below(P[F_EDGE + 2], cap);
      S[4] = cap;
      const int nv = count_below(P[F_NMODEL], cap);
      for (int r = 0; r < 4; ++r) NV[r] = max(0, min(S[r + 1], nv) - S[r]);
    }
    __syncwarp();
    const int nv = NV[0] + NV[1] + NV[2] + NV[3];
    const long long out = stream * k.cap;
    int hint_r = -1;                       // the region the hints are of
    int hint[4] = {0, 0, 0, 0};            // a lower bound of each count

    for (int c0 = base; c0 < end; c0 += 32) {
      const int i = c0 + lane;
      const bool active = i < end;
      const bool valid = active && i < nv;
      const int r = (i >= S[1]) + (i >= S[2]) + (i >= S[3]);
      const float fi = (float)i;
      float t = 0.f;
      long long addr = 0;
      int fb = 0, ch = 0, row = 0;
      if (active) {
        t = issue_time(P, r, fi, os);
        addr = slot_address(P, k, r, fi);
        decode(k, addr, fb, ch, row);
      }
      const float key = valid ? t : kBigT;

      int rank = i;                        // an invalid slot's
      const unsigned vm = __ballot_sync(kFull, valid);
      if (vm) {                            // valid lanes: a prefix
        const int last = 31 - __clz(vm);
        const int r0 = __shfl_sync(kFull, r, 0);
        const int rl = __shfl_sync(kFull, r, last);
        int own = i - S[r];
        if (r0 == rl) {                    // one region: counts rise with lane
          const bool fresh = r0 != hint_r;
          hint_r = r0;
          const float kA = __shfl_sync(kFull, key, 0);
          const float kB = __shfl_sync(kFull, key, last);
#pragma unroll
          for (int r2 = 0; r2 < 4; ++r2) {
            if (r2 == r0 || NV[r2] == 0) continue;
            const bool strict = r0 < r2;
            const int n = NV[r2], s2 = S[r2];
            const int lo = fresh ? warp_count(P, r2, s2, kA, strict, 0, n,
                                              false, os, lane)
                                 : hint[r2];
            // the next 32 slots from lo, one probe a lane: a lane whose
            // count falls among them finds it by shuffles over their times;
            // past them, the warp gallops to the last lane's count and each
            // lane left bisects
            const int w = min(32, n - lo);
            const float tm =
                lane < w ? issue_time(P, r2, (float)(s2 + lo + lane), os)
                         : 0.f;
            const int cw = window_count(tm, key, strict, w);
            int c = cw < w || lo + w == n ? lo + cw : -1;
            const int tB = __popc(
                __ballot_sync(kFull, lane < w && ahead(tm, kB, strict)));
            if (tB < w || lo + w == n) {
              hint[r2] = lo + tB;
            } else {
              const int b = warp_count(P, r2, s2, kB, strict, lo + w, n,
                                       true, os, lane);
              if (c < 0) c = lane_count(P, r2, s2, key, strict, lo + w, b, os);
              hint[r2] = b;
            }
            own += c;
          }
        } else {                           // a region boundary in the warp
          hint_r = -1;
          if (valid) {
            for (int r2 = 0; r2 < 4; ++r2)
              if (r2 != r)
                own += lane_count(P, r2, S[r2], key, r < r2, 0, NV[r2], os);
          }
        }
        if (valid) rank = own;
      }
      if (active) {
        const long long o = out + rank;
        t_out[o] = t;
        fb_out[o] = fb;
        ch_out[o] = ch;
        row_out[o] = row;
        w_out[o] = r == 3;
        v_out[o] = valid;
        const unsigned long long u = (unsigned long long)addr ^ kSign;
        amin = min(amin, u);
        amax = max(amax, u);
      }
    }
  }
  // the block's least and greatest address: one atomic pair a block
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    amin = min(amin, __shfl_xor_sync(kFull, amin, d));
    amax = max(amax, __shfl_xor_sync(kFull, amax, d));
  }
  if (lane == 0) {
    s_span[wid][0] = amin;
    s_span[wid][1] = amax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      amin = min(amin, s_span[w][0]);
      amax = max(amax, s_span[w][1]);
    }
    if (amin <= amax) {
      atomicMin(span_out, amin);
      atomicMax(span_out + 1, amax);
    }
  }
}

}  // namespace

// params: (n_streams, 64) float32 rows (`streams.pack_rows`); outputs
// (n_streams, cap): t float32, flat bank, channel, row int32, is_write and
// valid uint8 (torch.bool), each slot at its rank in issue-time order;
// span: 2 words, the least and greatest address of every slot, each as
// (uint64)addr ^ 2^63 (set here before the kernel runs). layout: 0 row,
// 1 col, 2 tiled, 3 strided; fast_row: bit r set when region r's fast
// walk runs down the operand's rows. Launches on `stream` and returns the
// CUDA error of the launch (0 = none; cudaErrorInvalidValue for a cap
// outside [1, 2^24] or a size below 1).
extern "C" int request_streams_launch(
    const float* params, float* t, int* fb, int* ch, int* row,
    unsigned char* is_write, unsigned char* valid, unsigned long long* span,
    long long n_streams, long long cap, int os, int layout, int fast_row,
    int wb, long long burst, long long channels, long long banks,
    long long bursts_per_row, float g_el, float span_el, float tile_r,
    float tile_c, float inv_tile_r, float inv_tile_c, float tile_rc,
    void* stream) {
  if (cap < 1 || cap > kMaxCap || n_streams < 0 || layout < 0 || layout > 3
      || wb < 1 || burst < 1 || channels < 1 || banks < 1
      || bursts_per_row < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(span, 0xff, sizeof(*span), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(span + 1, 0, sizeof(*span), s);
  if (e != cudaSuccess) return (int)e;
  if (n_streams == 0) return 0;
  Consts k;
  k.n_streams = n_streams;
  k.cap = cap;
  k.seg = cap < kSeg ? (cap + 31) / 32 * 32 : kSeg;
  k.os = os;
  k.layout = layout;
  k.fast_row = fast_row;
  k.wb = wb;
  k.burst = burst;
  k.channels = channels;
  k.banks = banks;
  k.bursts_per_row = bursts_per_row;
  k.row_div = bursts_per_row * banks;
  k.g_el = g_el;
  k.span = span_el;
  k.tile_r = tile_r;
  k.tile_c = tile_c;
  k.inv_tile_r = inv_tile_r;
  k.inv_tile_c = inv_tile_c;
  k.tile_rc = tile_rc;
  const long long tasks = n_streams * ((cap + k.seg - 1) / k.seg);
  const long long blocks = (tasks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  request_streams<<<(unsigned)blocks, kThreads, 0, s>>>(
      params, k, t, fb, ch, row, is_write, valid, span);
  return (int)cudaGetLastError();
}
