// Trace-replay megakernel for Hopper (sm_90a): replays a batch of decoded
// DRAM request streams through the banked timing model in one launch.
//
// Replaces the TPU kernel `repro.kernels.replay.megakernel.replay_megakernel`
// (src/repro/kernels/replay/megakernel.py; body `_megakernel_body`, chunk
// math in src/repro/kernels/replay/chunkmath.py). It computes what that
// body computes, with the same fixed-point contract:
//
//   inputs  (S, npad) per stream, npad = nc * C:
//           t f32 issue time; fb flat bank, ch channel, row, w write bit,
//           v valid bit, cid core id (all int32)
//   outputs done  (S, npad) f32  completion time, 0 where ~v
//           shift (S, n_cores) f32  queue backpressure per core
//           cnt   (S, 4) int32     row hits, empty-row misses, conflicts, 0
//
// What bounds it on this card: latency, not bytes or arithmetic. Each
// stream is a serial chain of about 64 chunks; each chunk needs at least
// two (usually two to four) fixed-point passes, and every pass is three
// O(C^2) masked max reductions separated by barriers. A stream's bytes
// (28 per request in, 4 out) are read once, so memory traffic is a rounding
// error next to the dependent chain of passes.
//
// The design answers that with parallelism across streams and nothing
// between them: one thread block per stream, blockDim == C, thread i owns
// request i of the current chunk. The chunk loop runs inside the block (on
// the TPU it was a sequential fori_loop over a grid step per stream); the
// architectural state -- bank_free / open_row per bank, bus_free per
// channel, the in-flight rings (n_qg x Q) with their counters, and the
// per-core shift -- lives in shared memory for the whole stream. Per chunk
// each thread builds its own row of the order-only tables (prev, pin,
// intra, lat_intra, the channel weight prefix W, the pruned gprev,
// rdx/wdx, ring survivors, the in-chunk queue head when Q < C) with O(C)
// loops over the chunk's inputs in shared memory: no (C, C) mask is ever
// materialized. Fixed-point passes are Jacobi-style (every pass reads the
// previous iterate from shared memory); the first two passes are
// unconditional, then the block iterates while any completion moved by
// more than tol (__syncthreads_or) and the pass count is below the cap.
// No host synchronization happens per chunk. Thousands of streams (the
// sweep's designs x ops) fill the 132 SMs with independent blocks.
//
// A later version would put a warp on each stream, several streams per
// block, and keep the tables in registers; this one is the simple,
// correct baseline.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Cfg {
  int nc, C;
  int ch_n, bk_n, n_banks;
  int tRCD, tRP, tCAS;
  int Qr, Qw;
  int n_cores, n_qg, cap;
  float busy, tol;
  int intra_heads;
};

__device__ __forceinline__ int row_latency(const Cfg& k, int open, int row,
                                           int* hit, int* empty) {
  *hit = open == row;
  *empty = open < 0;
  return *hit ? k.tCAS : (*empty ? k.tRCD + k.tCAS : k.tRP + k.tRCD + k.tCAS);
}

// One Jacobi pass of the closure operator for request i; reads the
// previous iterate from s_done and returns the new completion (0 where
// ~valid). Every thread of the block must call it (it holds barriers).
struct PassIn {
  float t, head0, shift0, bank0, bus0, lat, W, V;
  int valid, cid, ch, fb, ghead, gprev;
};

__device__ float one_pass(const Cfg& k, const PassIn& p, int i,
                          const int* s_v, const int* s_cid, const int* s_ch,
                          const int* s_fb, const float* s_done, float* s_g,
                          float* s_sw, float* s_uv) {
  const float NEG = -INFINITY;
  float dprev = s_done[i];
  float head = p.head0;
  if (k.intra_heads && p.ghead >= 0) head = fmaxf(p.head0, s_done[p.ghead]);
  s_g[i] = p.valid ? head - p.t : NEG;
  float bankp = p.bank0;
  if (p.gprev >= 0) bankp = fmaxf(p.bank0, s_done[p.gprev]);
  __syncthreads();
  float ss = NEG;
  for (int j = 0; j < i; ++j)
    if (s_v[j] && s_cid[j] == p.cid) ss = fmaxf(ss, s_g[j]);
  ss = fmaxf(p.shift0, ss);
  float issue_ok = fmaxf(p.t + ss, head);
  float s = fmaxf((fmaxf(issue_ok, bankp) + p.lat) + k.busy, dprev);
  s_sw[i] = p.valid ? s - p.W : NEG;
  __syncthreads();
  float mx = NEG;
  for (int j = 0; j <= i; ++j)
    if (s_v[j] && s_ch[j] == p.ch) mx = fmaxf(mx, s_sw[j]);
  float u = fmaxf(mx + p.W, p.bus0 + p.W);
  s_uv[i] = p.valid ? u - p.V : NEG;
  __syncthreads();
  float md = NEG;
  for (int j = 0; j <= i; ++j)
    if (s_v[j] && s_fb[j] == p.fb) md = fmaxf(md, s_uv[j]);
  return p.valid ? md + p.V : 0.0f;
}

__global__ void replay_megakernel(const float* __restrict__ t_in,
                                  const int* __restrict__ fb_in,
                                  const int* __restrict__ ch_in,
                                  const int* __restrict__ row_in,
                                  const int* __restrict__ w_in,
                                  const int* __restrict__ v_in,
                                  const int* __restrict__ cid_in,
                                  float* __restrict__ done_out,
                                  float* __restrict__ shift_out,
                                  int* __restrict__ cnt_out, Cfg k) {
  extern __shared__ float smem[];
  const int C = k.C;
  const int i = threadIdx.x;
  const long npad = (long)k.nc * C;
  const long sbase = (long)blockIdx.x * npad;

  // ---- shared memory: carried state, then per-chunk arrays -------------
  float* bank_free = smem;
  int* open_row = (int*)(bank_free + k.n_banks);
  float* bus_free = (float*)(open_row + k.n_banks);
  float* ring_r = bus_free + k.ch_n;
  float* ring_w = ring_r + k.n_qg * k.Qr;
  int* ir = (int*)(ring_w + k.n_qg * k.Qw);
  int* iw = ir + k.n_qg;
  float* shift = (float*)(iw + k.n_qg);
  int* s_cnt = (int*)(shift + k.n_cores);
  float* s_t = (float*)(s_cnt + 4);
  int* s_fb = (int*)(s_t + C);
  int* s_ch = s_fb + C;
  int* s_row = s_ch + C;
  int* s_w = s_row + C;
  int* s_v = s_w + C;
  int* s_cid = s_v + C;
  int* s_rdx = s_cid + C;
  int* s_wdx = s_rdx + C;
  float* s_we = (float*)(s_wdx + C);
  float* s_lb = s_we + C;
  float* s_W = s_lb + C;
  float* s_done = s_W + C;
  float* s_g = s_done + C;
  float* s_sw = s_g + C;
  float* s_uv = s_sw + C;

  for (int b = i; b < k.n_banks; b += C) {
    bank_free[b] = 0.0f;
    open_row[b] = -1;
  }
  for (int c = i; c < k.ch_n; c += C) bus_free[c] = 0.0f;
  for (int q = i; q < k.n_qg * k.Qr; q += C) ring_r[q] = 0.0f;
  for (int q = i; q < k.n_qg * k.Qw; q += C) ring_w[q] = 0.0f;
  for (int g = i; g < k.n_qg; g += C) {
    ir[g] = 0;
    iw[g] = 0;
  }
  for (int c = i; c < k.n_cores; c += C) shift[c] = 0.0f;
  for (int q = i; q < 4; q += C) s_cnt[q] = 0;
  int hits = 0, misses = 0, conflicts = 0;
  __syncthreads();

  for (int chunk = 0; chunk < k.nc; ++chunk) {
    const long at = sbase + (long)chunk * C + i;
    const float ti = t_in[at];
    const int fbi = fb_in[at], chi = ch_in[at], rowi = row_in[at];
    const int wi = w_in[at] != 0, vi = v_in[at] != 0, cidi = cid_in[at];
    s_t[i] = ti;
    s_fb[i] = fbi;
    s_ch[i] = chi;
    s_row[i] = rowi;
    s_w[i] = wi;
    s_v[i] = vi;
    s_cid[i] = cidi;
    __syncthreads();

    // ---- order-only tables: this thread's row ------------------------
    const int qgi = k.n_qg > 1 ? chi : 0;
    const int rmi = vi && !wi, wmi = vi && wi;
    int prev = -1, pin = -1, rdx = 0, wdx = 0, nr = 0, nw = 0;
    int last_b = vi, last_c = vi;
    for (int j = 0; j < C; ++j) {
      if (!s_v[j]) continue;
      const int qgj = k.n_qg > 1 ? s_ch[j] : 0;
      if (qgj == qgi) {
        if (s_w[j]) {
          ++nw;
          if (j < i) ++wdx;
        } else {
          ++nr;
          if (j < i) ++rdx;
        }
      }
      if (j < i) {
        if (s_fb[j] == fbi) prev = j;
        if (s_ch[j] == chi) pin = j;
      } else if (j > i) {
        if (s_fb[j] == fbi) last_b = 0;
        if (s_ch[j] == chi) last_c = 0;
      }
    }
    const int intra = prev >= 0;
    const int row_prev = intra ? s_row[prev] : -1;
    int hit, empty;
    // classify: intra-chunk links are order-only; the first request of a
    // bank in the chunk consults the carried open-row view
    const int seen = intra ? row_prev : (vi ? open_row[fbi] : 0);
    const int lat_i = row_latency(k, seen, rowi, &hit, &empty);
    if (vi) {
      hits += hit;
      misses += empty;
      conflicts += !hit && !empty;
    }
    const float lat = (float)lat_i;
    int h2, e2;
    const float lat_intra =
        intra ? (float)row_latency(k, row_prev, rowi, &h2, &e2) : 0.0f;
    const int linked = intra && pin >= 0 && s_fb[pin] == fbi;
    s_we[i] = vi ? k.busy + (linked ? lat_intra : 0.0f) : 0.0f;
    s_lb[i] = vi ? lat + k.busy : 0.0f;
    s_rdx[i] = rdx;
    s_wdx[i] = wdx;
    __syncthreads();

    float W = 0.0f, V = 0.0f;
    for (int j = 0; j <= i; ++j) {
      if (!s_v[j]) continue;
      if (s_ch[j] == chi) W += s_we[j];
      if (s_fb[j] == fbi) V += s_lb[j];
    }
    s_W[i] = W;
    int ghead = -1;
    if (k.intra_heads && (rmi || wmi)) {
      const int want = wmi ? wdx - k.Qw : rdx - k.Qr;
      for (int j = 0; j < C; ++j) {
        if (!s_v[j] || (s_w[j] != 0) != (wmi != 0)) continue;
        if ((k.n_qg > 1 ? s_ch[j] : 0) != qgi) continue;
        if ((wmi ? s_wdx[j] : s_rdx[j]) == want) ghead = j;
      }
    }
    __syncthreads();
    const float W_prev = intra ? s_W[prev] : 0.0f;
    // prune the iterated same-bank gather: links whose channel path
    // already outweighs their latency are provably dominated
    const int gprev = (intra && (lat_intra + k.busy > W - W_prev)) ? prev : -1;

    // ---- carried-state gathers ----------------------------------------
    PassIn p;
    p.t = ti;
    p.valid = vi;
    p.cid = cidi;
    p.ch = chi;
    p.fb = fbi;
    p.lat = lat;
    p.W = W;
    p.V = V;
    p.ghead = ghead;
    p.gprev = gprev;
    p.bank0 = vi ? bank_free[fbi] : 0.0f;
    p.bus0 = vi ? bus_free[chi] : 0.0f;
    p.shift0 = vi ? shift[cidi] : 0.0f;
    const int qg_safe = vi ? qgi : 0;
    const int sl_r = (rdx + (vi ? ir[qg_safe] : 0)) % k.Qr;
    const int sl_w = (wdx + (vi ? iw[qg_safe] : 0)) % k.Qw;
    p.head0 = wi ? ring_w[qg_safe * k.Qw + sl_w] : ring_r[qg_safe * k.Qr + sl_r];
    const int surv_r = rmi && rdx + k.Qr >= nr;
    const int surv_w = wmi && wdx + k.Qw >= nw;

    // ---- fixed point ---------------------------------------------------
    s_done[i] = 0.0f;
    __syncthreads();
    float d = one_pass(k, p, i, s_v, s_cid, s_ch, s_fb, s_done, s_g, s_sw,
                       s_uv);
    s_done[i] = d;
    __syncthreads();
    if (k.cap >= 2) {
      float before = d;
      d = one_pass(k, p, i, s_v, s_cid, s_ch, s_fb, s_done, s_g, s_sw, s_uv);
      s_done[i] = d;
      int moved = __syncthreads_or(d - before > k.tol);
      int passes = 2;
      while (k.cap > 2 && passes < k.cap && moved) {
        before = d;
        d = one_pass(k, p, i, s_v, s_cid, s_ch, s_fb, s_done, s_g, s_sw,
                     s_uv);
        s_done[i] = d;
        moved = __syncthreads_or(d - before > k.tol);
        ++passes;
      }
    }
    done_out[at] = d;

    // ---- advance the carried state -------------------------------------
    float head = p.head0;
    if (k.intra_heads && ghead >= 0) head = fmaxf(p.head0, s_done[ghead]);
    s_g[i] = vi ? head - ti : -INFINITY;
    __syncthreads();
    for (int c = i; c < k.n_cores; c += C) {
      float m = shift[c];
      for (int j = 0; j < C; ++j)
        if (s_v[j] && s_cid[j] == c) m = fmaxf(m, s_g[j]);
      shift[c] = m;
    }
    if (last_b) {
      bank_free[fbi] = d;
      open_row[fbi] = rowi;
    }
    if (last_c) bus_free[chi] = d;
    if (surv_r) ring_r[qgi * k.Qr + sl_r] = d;
    if (surv_w) ring_w[qgi * k.Qw + sl_w] = d;
    // the last read (write) of a group advances its counter by the
    // group's count in this chunk
    if (rmi && rdx == nr - 1) ir[qgi] += nr;
    if (wmi && wdx == nw - 1) iw[qgi] += nw;
    __syncthreads();
  }

  atomicAdd(&s_cnt[0], hits);
  atomicAdd(&s_cnt[1], misses);
  atomicAdd(&s_cnt[2], conflicts);
  __syncthreads();
  for (int c = i; c < k.n_cores; c += C)
    shift_out[(long)blockIdx.x * k.n_cores + c] = shift[c];
  for (int q = i; q < 4; q += C)
    cnt_out[(long)blockIdx.x * 4 + q] = q < 3 ? s_cnt[q] : 0;
}

}  // namespace

extern "C" size_t replay_megakernel_smem_bytes(int C, int n_banks, int ch_n,
                                               int n_qg, int Qr, int Qw,
                                               int n_cores) {
  return sizeof(float) * ((size_t)2 * n_banks + ch_n + (size_t)n_qg * Qr +
                          (size_t)n_qg * Qw + 2 * (size_t)n_qg + n_cores + 4 +
                          (size_t)16 * C);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int replay_megakernel_launch(
    const float* t, const int* fb, const int* ch, const int* row,
    const int* w, const int* v, const int* cid, float* done, float* shift,
    int* cnt, int S, int nc, int C, int channels, int banks_per_channel,
    int tRCD, int tRP, int tCAS, int read_queue, int write_queue,
    int n_cores, int n_qg, int max_passes, float busy, float tol,
    void* stream) {
  Cfg k;
  k.nc = nc;
  k.C = C;
  k.ch_n = channels;
  k.bk_n = banks_per_channel;
  k.n_banks = channels * banks_per_channel;
  k.tRCD = tRCD;
  k.tRP = tRP;
  k.tCAS = tCAS;
  k.Qr = read_queue;
  k.Qw = write_queue;
  k.n_cores = n_cores;
  k.n_qg = n_qg;
  k.cap = max_passes > 0 ? max_passes : C + 2;
  k.busy = busy;
  k.tol = tol;
  k.intra_heads = read_queue < C || write_queue < C;
  if (S <= 0 || nc <= 0) return (int)cudaSuccess;
  if (C < 1 || C > 1024) return (int)cudaErrorInvalidValue;
  size_t smem = replay_megakernel_smem_bytes(C, k.n_banks, channels, n_qg,
                                             read_queue, write_queue, n_cores);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        replay_megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  replay_megakernel<<<S, C, smem, (cudaStream_t)stream>>>(
      t, fb, ch, row, w, v, cid, done, shift, cnt, k);
  return (int)cudaGetLastError();
}
