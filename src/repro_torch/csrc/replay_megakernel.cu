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
//           v valid bit, cid core id (int32)
//   outputs done  (S, npad) f32       completion time, 0 where ~v
//           shift (S, n_cores) f32    queue backpressure per core
//           cnt   (S, 4) int32        row hits, empty-row misses, conflicts, 0
//
// A stream may merge n_cores cores (each request's issue shift is its
// core's) and keep n_qg in-flight queue groups per direction (1, or one per
// channel: the shared-DRAM contention path). n_cores = n_qg = 1 is the
// sweep's case and runs the single-core instance, which does not read cid.
//
// What bounds it on this card: the latency of a dependent chain, not bytes
// or arithmetic. Each stream is a serial chain of chunks (64 of 64
// requests on the sweep's path); each chunk needs two to four fixed-point
// passes, and each pass three keyed maxima over the chunk (over the
// earlier requests of the same core, along the same channel, along the
// same bank). A stream's bytes (six 4-byte words per request in, seven with
// the core id, one out) are read once. A block of C threads per stream that
// rebuilt every table and every maximum with O(C) loops over shared
// memory spent thousands of dependent shared loads per warp per chunk.
//
// Design. One warp per stream, several streams per block and no
// block-wide barrier. Each lane owns requests lane, lane + 32, ... of the
// chunk (ceil(C / 32) of them). The stream's carried state (bank_free /
// open_row per bank, bus_free per channel, the in-flight rings) lives
// in the warp's slice of shared memory; the ring counters and the shift
// in registers (one core, one group) or in that slice (per core, per
// group). Per chunk:
// - order-only tables from warp votes: `__match_any_sync` on the bank and
//   on the channel gives each request's peers within its 32-request
//   slot; the highest peer below it is `prev` (`pin`), and stamped
//   per-bank (per-channel) tables of the last request seen carry the link
//   across slots and mark the last request of each bank (channel).
//   `__ballot_sync` + `__popc` give the read and write ranks, and a
//   rank -> request table the in-chunk queue head `ghead`;
// - the channel and bank prefix sums W and V by pointer jumping along the
//   `pin` and `prev` links, ending as soon as every link has run out
//   (ceil(log2 C) rounds at most), each round's pointers kept;
// - each Jacobi pass: the maximum over earlier requests as a shuffle scan
//   per slot with a carry across slots; the maxima along the same channel
//   and the same bank as log-depth scans over the kept jump pointers. The
//   first two passes are unconditional, then the warp iterates while any
//   completion moved by more than tol (`__any_sync`) and the pass count is
//   below the cap, as before.
// That is O(C log C) work per chunk and no O(C^2) loop. Two instances of
// it: for C <= 64 (the sweep's chunk) a lane keeps its one or two
// requests' tables, iterates and jump pointers in registers and gathers
// another request's value with `__shfl_sync`, so a pass touches no memory;
// for larger C (up to 1024) the per-request arrays live in the warp's
// shared memory, the chunk's inputs arrive by `cp.async` into one of two
// staging buffers while the chunk before resolves, and gathers are shared
// loads. The per-request math (classification, queue heads, each step of
// a pass, the state update) is written once, in helpers both instances
// call; they differ only in where a request's values live and how another
// request's value is gathered. Sums along the links are taken in
// pointer-jumping order, not left to right: completions stay within the
// 1e-3 contract, and every count (order-only) is exact.
//
// Multi-core mode (template flag MC, both instances; the single-core
// instance is the code above, unchanged):
// - the shift becomes a keyed exclusive maximum: `__match_any_sync` on the
//   core id gives each request's highest same-core peer below it in its
//   slot (`plink`); the inclusive maximum along those links is taken by
//   pointer jumping inside the slot (at most 5 rounds of shuffles), and a
//   per-core carry table in shared memory, seeded each pass with the
//   carried per-core shift and advanced by each core's last request of the
//   slot, carries it across slots. The same scan, run on the final heads
//   against the shift table itself, advances the carried shift;
// - read and write ranks become ranks within (queue group, direction):
//   `__match_any_sync` on (group << 1) | w, `__popc` of the lower peers,
//   per-(group, direction) counters in shared memory carried across slots
//   (`gn`) and chunks (`gi`). The rank -> request table is laid out by
//   group: an exclusive scan of the chunk's counts gives each (group,
//   direction) its offset, so it still takes C entries;
// - rings take n_qg x (Qr + Qw) floats of the warp's slice (16 KB at 16
//   channels with 128-deep queues); the launch lowers the streams per
//   block until the slices fit the opt-in limit.
// With n_cores = n_qg = 1 the multi-core instance takes the same maxima of
// the same values and the same ranks, so it matches the single-core one
// bit for bit (the card tests hold the two against each other).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsMax = 4;          // streams per block, at most
// the multi-core mode's limits (`megakernel.py` states them as MAX_CORES
// and MAX_QUEUE_GROUPS): cores per merged stream, queue groups per
// direction (the group-offset scan takes two (group, direction) counters
// a lane)
constexpr int kMaxCores = 32;
constexpr int kMaxGroups = 32;
// bits of the per-request `info` word
constexpr int kValid = 1, kWrite = 2, kLastB = 4, kLastC = 8, kSurv = 16;

// Launch configuration and the layout of one warp's shared memory, in
// 4-byte words from the start of its slice.
struct Cfg {
  int S, nc, C, K, levels;
  int ch_n, n_banks;
  int tRCD, tRP, tCAS;
  int Qr, Qw, cap;
  float busy, tol;
  int intra_heads;
  int n_cores, n_qg;
  int n_in;                           // input arrays staged (6, or 7 with cid)
  int warp_words;
  // carried state, and the rank -> request table (both instances); the
  // rings hold n_qg groups of Qr (Qw) slots
  int o_bank_free, o_bus_free, o_ring_r, o_ring_w, o_open_row, o_last_b,
      o_last_c, o_rank;
  // the multi-core mode only: the carried per-core shift and its per-pass
  // carry table, and per (group, direction) the chunk's running count, the
  // requests issued before the chunk and the rank table's offset
  int o_shift, o_carry, o_gn, o_gi, o_goff;
  // the shared-memory instance only: two input stages of n_in x C words
  // (t, fb, ch, row, w, v[, cid]), then the per-request arrays; o_jc and
  // o_jb hold `levels` x C int16 jump pointers each; o_plink (multi-core)
  // the slot's core link and last-of-core flag
  int o_in, o_lat, o_head0, o_bank0, o_bus0, o_done, o_m0, o_m1, o_a0, o_a1,
      o_b0, o_b1, o_info, o_ghead, o_gprev, o_slot, o_p0, o_p1, o_q0, o_q1,
      o_plink, o_jc, o_jb;
};

// Fill the layout; `arrays` adds the shared-memory instance's per-request
// arrays, `mc` the multi-core mode's tables. Returns the words of one
// warp's slice (a multiple of 4).
int layout(Cfg& k, bool arrays, bool mc) {
  int at = 0;
  auto take = [&](int words) {
    const int o = at;
    at += words;
    return o;
  };
  const int C = k.C;
  k.o_bank_free = take(k.n_banks);
  k.o_bus_free = take(k.ch_n);
  k.o_ring_r = take(k.n_qg * k.Qr);
  k.o_ring_w = take(k.n_qg * k.Qw);
  k.o_open_row = take(k.n_banks);
  k.o_last_b = take(k.n_banks);
  k.o_last_c = take(k.ch_n);
  k.o_rank = take(C);
  k.n_in = mc ? 7 : 6;
  if (mc) {
    k.o_shift = take(k.n_cores);
    k.o_carry = take(k.n_cores);
    k.o_gn = take(2 * k.n_qg);
    k.o_gi = take(2 * k.n_qg);
    k.o_goff = take(2 * k.n_qg);
  }
  if (arrays) {
    k.o_in = take(2 * k.n_in * C);
    int* fs[] = {&k.o_lat, &k.o_head0, &k.o_bank0, &k.o_bus0, &k.o_done,
                 &k.o_m0, &k.o_m1, &k.o_a0, &k.o_a1, &k.o_b0, &k.o_b1,
                 &k.o_info, &k.o_ghead, &k.o_gprev, &k.o_slot, &k.o_p0,
                 &k.o_p1, &k.o_q0, &k.o_q1};
    for (int* o : fs) *o = take(C);
    if (mc) k.o_plink = take(C);
    k.o_jc = take((k.levels * C + 1) / 2);
    k.o_jb = take((k.levels * C + 1) / 2);
  }
  k.warp_words = (at + 3) / 4 * 4;
  return k.warp_words;
}

__device__ __forceinline__ int row_latency(const Cfg& k, int open, int row,
                                           int* hit, int* empty) {
  *hit = open == row;
  *empty = open < 0;
  return *hit ? k.tCAS : (*empty ? k.tRCD + k.tCAS : k.tRP + k.tRCD + k.tCAS);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Exclusive max-scan of x over the lanes; `total` gets the slot's max.
__device__ __forceinline__ float lane_excl_max(float x, int lane,
                                               float* total) {
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = fmaxf(x, y);
  }
  *total = __shfl_sync(kFull, x, 31);
  const float ex = __shfl_up_sync(kFull, x, 1);
  return lane == 0 ? -INFINITY : ex;
}

// Zero the carried state of one stream.
template <bool MC>
__device__ __forceinline__ void init_state(const Cfg& k, float* F, int lane) {
  int* I = reinterpret_cast<int*>(F);
  for (int b = lane; b < k.n_banks; b += 32) {
    F[k.o_bank_free + b] = 0.0f;
    I[k.o_open_row + b] = -1;
    I[k.o_last_b + b] = -1;
  }
  for (int c = lane; c < k.ch_n; c += 32) {
    F[k.o_bus_free + c] = 0.0f;
    I[k.o_last_c + c] = -1;
  }
  for (int q = lane; q < k.n_qg * k.Qr; q += 32) F[k.o_ring_r + q] = 0.0f;
  for (int q = lane; q < k.n_qg * k.Qw; q += 32) F[k.o_ring_w + q] = 0.0f;
  if (MC) {
    for (int c = lane; c < k.n_cores; c += 32) F[k.o_shift + c] = 0.0f;
    for (int g = lane; g < 2 * k.n_qg; g += 32) {
      I[k.o_gi + g] = 0;
      I[k.o_gn + g] = 0;
    }
  }
  __syncwarp();
}

// The queue group of a request: its channel when groups are per channel,
// else 0 (0 too for an invalid request, whose ids are never used).
__device__ __forceinline__ int queue_group(const Cfg& k, int v, int chi) {
  return v && k.n_qg > 1 ? chi : 0;
}

// Step 1 for one 32-request slot q: links to the highest same-bank
// (same-channel) valid request below, from the slot's votes or else the
// stamped tables; the direction rank; the rank -> request table. Updates
// the stamps and the running read/write counts. Multi-core (MC): the rank
// is within (queue group, direction), counted on from `gn` (the rank table
// is written later, by group), and `plink` / `klast` are the highest
// same-core valid lane below in the slot and whether none is above.
struct SlotLinks {
  int prev, pin, didx, plink, klast;
};
template <bool MC>
__device__ __forceinline__ SlotLinks slot_links(const Cfg& k, float* F,
                                                int q, int lane, int base,
                                                int v, int w, int fbi,
                                                int chi, int core, int* cr,
                                                int* cw) {
  int* I = reinterpret_cast<int*>(F);
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = ~below & ~(1u << lane);
  const int i = q * 32 + lane;
  const int kb = v ? fbi : -1, kc = v ? chi : -1;
  const unsigned vb = __ballot_sync(kFull, v);
  const unsigned mb = __match_any_sync(kFull, kb) & vb;
  const unsigned mc = __match_any_sync(kFull, kc) & vb;
  SlotLinks o{-1, -1, 0, -1, 0};
  if (v) {
    const unsigned lb = mb & below, lc = mc & below;
    if (lb) {
      o.prev = q * 32 + 31 - __clz(lb);
    } else {
      const int x = I[k.o_last_b + fbi];
      o.prev = x >= base ? x - base : -1;
    }
    if (lc) {
      o.pin = q * 32 + 31 - __clz(lc);
    } else {
      const int x = I[k.o_last_c + chi];
      o.pin = x >= base ? x - base : -1;
    }
  }
  if constexpr (MC) {
    const int gk = v ? (queue_group(k, v, chi) << 1 | w) : -1;
    const unsigned mg = __match_any_sync(kFull, gk) & vb;
    const int g0 = v ? I[k.o_gn + gk] : 0;
    o.didx = g0 + __popc(mg & below);
    const unsigned mk = __match_any_sync(kFull, v ? core : -1) & vb;
    const unsigned lk = mk & below;
    o.plink = v && lk ? 31 - __clz(lk) : -1;
    o.klast = v && !(mk & above);
    __syncwarp();
    if (v && !(mg & above)) I[k.o_gn + gk] = g0 + __popc(mg);
  } else {
    const unsigned br = __ballot_sync(kFull, v && !w);
    const unsigned bw = __ballot_sync(kFull, v && w);
    o.didx = w ? *cw + __popc(bw & below) : *cr + __popc(br & below);
    // rank -> request: reads from the front, writes from the back
    if (v) I[k.o_rank + (w ? k.C - 1 - o.didx : o.didx)] = i;
    *cr += __popc(br);
    *cw += __popc(bw);
    __syncwarp();
  }
  if (v && !(mb & above)) I[k.o_last_b + fbi] = base + i;
  if (v && !(mc & above)) I[k.o_last_c + chi] = base + i;
  __syncwarp();
  return o;
}

// Multi-core: each (group, direction)'s offset in the rank -> request
// table, an exclusive scan of the chunk's counts `gn` (two a lane).
__device__ __forceinline__ void group_offsets(const Cfg& k, float* F,
                                              int lane) {
  int* I = reinterpret_cast<int*>(F);
  const int n = 2 * k.n_qg, g = 2 * lane;
  const int a = g < n ? I[k.o_gn + g] : 0;
  const int b = g + 1 < n ? I[k.o_gn + g + 1] : 0;
  int incl = a + b;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int ex = incl - a - b;
  if (g < n) I[k.o_goff + g] = ex;
  if (g + 1 < n) I[k.o_goff + g + 1] = ex + a;
  __syncwarp();
}

// Multi-core: the rank -> request entry of request i.
__device__ __forceinline__ void put_rank(const Cfg& k, float* F, int v,
                                         int w, int chi, int didx, int i) {
  int* I = reinterpret_cast<int*>(F);
  if (v) I[k.o_rank + I[k.o_goff + (queue_group(k, v, chi) << 1 | w)] + didx]
      = i;
}

// Multi-core: the running (group, direction) counts become the issued
// counts for the next chunk; the chunk's counts restart at zero.
__device__ __forceinline__ void advance_groups(const Cfg& k, float* F,
                                               int lane) {
  int* I = reinterpret_cast<int*>(F);
  for (int g = lane; g < 2 * k.n_qg; g += 32) {
    I[k.o_gi + g] += I[k.o_gn + g];
    I[k.o_gn + g] = 0;
  }
  __syncwarp();
}

// Multi-core: the keyed exclusive maximum of the shift key over the slot.
// `x` is this lane's key (-inf where invalid), `plink` its highest same-core
// valid lane below; the inclusive maximum along those links comes by
// pointer jumping. `tab` is a per-core table (the carry of a pass, or the
// carried shift): the result is max(tab[core], the exclusive maximum), and
// each core's last valid lane of the slot raises tab[core] by the slot's
// maximum. Every lane calls it.
__device__ __forceinline__ float core_scan(float* tab, int v, int core,
                                           int plink, int klast, float x,
                                           int lane) {
  float incl = x;
  int p = plink;
  for (int r = 0; r < 5; ++r) {
    if (!__any_sync(kFull, p >= 0)) break;
    const int src = p >= 0 ? p : lane;
    const float xp = __shfl_sync(kFull, incl, src);
    const int pp = __shfl_sync(kFull, p, src);
    if (p >= 0) {
      incl = fmaxf(incl, xp);
      p = pp;
    }
  }
  const float ex = __shfl_sync(kFull, incl, plink >= 0 ? plink : lane);
  const float c0 = v ? tab[core] : -INFINITY;
  __syncwarp();
  if (klast) tab[core] = fmaxf(c0, incl);
  __syncwarp();
  return plink >= 0 ? fmaxf(c0, ex) : c0;
}

// Multi-core: seed a pass's carry table with the carried shift.
__device__ __forceinline__ void seed_carry(const Cfg& k, float* F,
                                           int lane) {
  for (int c = lane; c < k.n_cores; c += 32)
    F[k.o_carry + c] = F[k.o_shift + c];
  __syncwarp();
}

// ===== per-request math, shared by both instances ==========================
// Each helper computes one request's step from values its caller supplies:
// the register instance gathers another request's value with a shuffle,
// which every lane must take part in, and the shared-memory instance with
// a guarded load (`at`). Values of a missing link (index -1) are ignored.

// Step 2 for one request: its tables and its view of the carried state.
struct Req {
  float lat, we, lb;       // row latency; its W (channel) and V (bank) edge
  float head0, bank0, bus0;
  int info, gh, slot;      // kValid..kSurv bits; in-chunk queue head; its
                           // ring slot, as a word offset in the warp's slice
  int hit, empty;          // a row hit, an empty-row miss (valid only)
};

// Where a request's queue lives: the requests of its (group, direction)
// issued before the chunk and in the chunk, the rank table's entry of its
// rank 0 and the step between ranks, and its ring's word offset.
struct Queue {
  int issued, count, rank0, rstep, ring;
};

// One queue group per direction: reads fill the rank table from the front,
// writes from the back.
__device__ __forceinline__ Queue queue_single(const Cfg& k, int w, int ir,
                                              int iw, int nr, int nw) {
  return w ? Queue{iw, nw, k.C - 1, -1, k.o_ring_w}
           : Queue{ir, nr, 0, 1, k.o_ring_r};
}

// Multi-core: the request's (group, direction) tables.
__device__ __forceinline__ Queue queue_grouped(const Cfg& k, const float* F,
                                               int v, int w, int chi) {
  const int* I = reinterpret_cast<const int*>(F);
  const int grp = queue_group(k, v, chi), g = grp << 1 | w;
  return Queue{I[k.o_gi + g], I[k.o_gn + g], I[k.o_goff + g], 1,
               w ? k.o_ring_w + grp * k.Qw : k.o_ring_r + grp * k.Qr};
}


struct Counts {
  int hits = 0, misses = 0, conflicts = 0;
  __device__ __forceinline__ void add(const Req& r) {
    hits += r.hit;
    misses += r.empty;
    conflicts += (r.info & kValid) && !r.hit && !r.empty;
  }
};
// `stamp` is the request's index in the stream, `didx` its rank within its
// (group, direction), `qu` that queue's tables; `rp` is the row of request
// `prev`, `fp` the bank of request `pin`.
__device__ __forceinline__ Req request_tables(
    const Cfg& k, const float* F, int stamp, int v, int w, int fbi, int chi,
    int rowi, int prev, int pin, int didx, int rp, int fp, Queue qu) {
  const int* I = reinterpret_cast<const int*>(F);
  Req o;
  o.info = (v ? kValid : 0) | (w ? kWrite : 0);
  const int Q = w ? k.Qw : k.Qr;
  o.gh = -1;                          // the same-queue request Q back
  if (k.intra_heads && v && didx >= Q)
    o.gh = I[k.o_rank + qu.rank0 + qu.rstep * (didx - Q)];
  o.slot = qu.ring + (didx + qu.issued) % Q;
  if (v && didx + Q >= qu.count) o.info |= kSurv;
  o.head0 = F[o.slot];
  o.lat = o.we = o.lb = o.bank0 = o.bus0 = 0.0f;
  o.hit = o.empty = 0;
  if (v) {
    // classify: intra-chunk links are order-only; the first request of a
    // bank in the chunk consults the carried open-row view
    const int intra = prev >= 0;
    const int seen = intra ? rp : I[k.o_open_row + fbi];
    o.lat = (float)row_latency(k, seen, rowi, &o.hit, &o.empty);
    // channel max-plus edge: the bus burst, plus the row latency when the
    // previous channel request sits on the same bank
    const int linked = intra && pin >= 0 && fp == fbi;
    o.we = k.busy + (linked ? o.lat : 0.0f);
    o.lb = o.lat + k.busy;
    o.bank0 = F[k.o_bank_free + fbi];
    o.bus0 = F[k.o_bus_free + chi];
    if (I[k.o_last_b + fbi] == stamp) o.info |= kLastB;
    if (I[k.o_last_c + chi] == stamp) o.info |= kLastC;
  }
  return o;
}

// One pointer-jumping round of a sum along links: x += x[p], p = p[p]; `xp`
// and `pp` are request p's.
__device__ __forceinline__ void jump_step(float x, int p, float xp, int pp,
                                          float* nx, int* np) {
  *nx = p >= 0 ? x + xp : x;
  *np = p >= 0 ? pp : -1;
}

// Prune the iterated same-bank gather: a link whose channel path already
// outweighs its latency is provably dominated. `Wp` is request prev's W.
__device__ __forceinline__ int prune_link(const Cfg& k, int prev, float lat,
                                          float W, float Wp) {
  return prev >= 0 && lat + k.busy > W - Wp ? prev : -1;
}

// The queue head's free time, with the in-chunk head's iterate `dh`.
__device__ __forceinline__ float head_time(float head0, int gh, float dh) {
  return gh >= 0 ? fmaxf(head0, dh) : head0;
}

// The key of the shift's maximum over earlier requests.
__device__ __forceinline__ float scan_key(int info, float head, float t) {
  return (info & kValid) ? head - t : -INFINITY;
}

// A pass's value before the channel maxima: `ex` is the maximum key over
// the earlier requests of the slot, `carry` over the earlier slots; `dp`
// is request gp's iterate, `d` this request's.
__device__ __forceinline__ float pass_start(const Cfg& k, int info, float t,
                                            float head, float shift,
                                            float carry, float ex,
                                            float bank0, int gp, float dp,
                                            float lat, float d, float W) {
  const float ss = fmaxf(shift, fmaxf(carry, ex));
  const float issue_ok = fmaxf(t + ss, head);
  const float bankp = gp >= 0 ? fmaxf(bank0, dp) : bank0;
  const float sv = fmaxf((fmaxf(issue_ok, bankp) + lat) + k.busy, d);
  return (info & kValid) ? sv - W : -INFINITY;
}

// One round of a keyed maximum along jump pointers; `x` is request j's.
__device__ __forceinline__ float link_max(float m, int j, float x) {
  return j >= 0 ? fmaxf(m, x) : m;
}

// From the channel maxima to the bank maxima.
__device__ __forceinline__ float chan_to_bank(int info, float m, float W,
                                              float bus0, float V) {
  const float u = fmaxf(m + W, bus0 + W);
  return (info & kValid) ? u - V : -INFINITY;
}

// The pass's new iterate; returns whether it moved by more than tol.
__device__ __forceinline__ int settle(const Cfg& k, int info, float m,
                                      float V, float* d) {
  const float nd = (info & kValid) ? m + V : 0.0f;
  const int moved = nd - *d > k.tol;
  *d = nd;
  return moved;
}

// Two passes unconditionally (one under a cap of 1), then while a
// completion moved by more than tol, up to the cap. Warp-uniform.
__device__ __forceinline__ bool last_pass(const Cfg& k, int passes,
                                          int moved) {
  return passes == 1 ? k.cap < 2
                     : !(k.cap > 2 && passes < k.cap &&
                         __any_sync(kFull, moved));
}

// Advance the carried state by one resolved request.
__device__ __forceinline__ void commit(const Cfg& k, float* F, int info,
                                       int fbi, int chi, int rowi, int slot,
                                       float d) {
  int* I = reinterpret_cast<int*>(F);
  if (info & kLastB) {
    F[k.o_bank_free + fbi] = d;
    I[k.o_open_row + fbi] = rowi;
  }
  if (info & kLastC) F[k.o_bus_free + chi] = d;
  if (info & kSurv) F[slot] = d;
}

// The stream's shift (per core from the warp's slice when `F`, else the
// lane's `shift`) and counts.
__device__ __forceinline__ void write_stream(const Cfg& k, const float* F,
                                             long stream, int lane,
                                             float shift, Counts n,
                                             float* shift_out,
                                             int* cnt_out) {
  n.hits = warp_sum(n.hits);
  n.misses = warp_sum(n.misses);
  n.conflicts = warp_sum(n.conflicts);
  if (F)
    for (int c = lane; c < k.n_cores; c += 32)
      shift_out[stream * k.n_cores + c] = F[k.o_shift + c];
  if (lane == 0) {
    if (!F) shift_out[stream] = shift;
    cnt_out[stream * 4 + 0] = n.hits;
    cnt_out[stream * 4 + 1] = n.misses;
    cnt_out[stream * 4 + 2] = n.conflicts;
    cnt_out[stream * 4 + 3] = 0;
  }
}

// ===== C <= 64: a lane's requests in registers, gathers by shuffles =======

// x of request j (j >= 0) from the lane that owns it; every lane calls it
template <int K, typename T>
__device__ __forceinline__ T gather(const T (&x)[K], int j, int lane) {
  const int src = j >= 0 ? (j & 31) : lane;
  T r = __shfl_sync(kFull, x[0], src);
  if (K == 2) {
    const T hi = __shfl_sync(kFull, x[K - 1], src);
    if (j >= 32) r = hi;
  }
  return r;
}

// One chunk's inputs, a lane's K requests (invalid past C or nc); the core
// id only in the multi-core mode (0 where invalid).
template <int K, bool MC>
struct Inputs {
  float t[K];
  int fb[K], ch[K], row[K], w[K], v[K], cid[MC ? K : 1];
  __device__ __forceinline__ void load(
      const float* __restrict__ t_in, const int* __restrict__ fb_in,
      const int* __restrict__ ch_in, const int* __restrict__ row_in,
      const int* __restrict__ w_in, const int* __restrict__ v_in,
      const int* __restrict__ cid_in, long sbase, int c, int nc, int C,
      int lane) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      const bool in = i < C && c < nc;
      const long at = sbase + (long)c * C + i;
      t[q] = in ? t_in[at] : 0.0f;
      fb[q] = in ? fb_in[at] : 0;
      ch[q] = in ? ch_in[at] : 0;
      row[q] = in ? row_in[at] : 0;
      w[q] = in ? w_in[at] != 0 : 0;
      v[q] = in ? v_in[at] != 0 : 0;
      if constexpr (MC) cid[q] = in && v[q] ? cid_in[at] : 0;
    }
  }
};

template <int K, bool MC>
__global__ void __launch_bounds__(32 * kWarpsMax)
replay_regs(const float* __restrict__ t_in, const int* __restrict__ fb_in,
            const int* __restrict__ ch_in, const int* __restrict__ row_in,
            const int* __restrict__ w_in, const int* __restrict__ v_in,
            const int* __restrict__ cid_in, float* __restrict__ done_out,
            float* __restrict__ shift_out, int* __restrict__ cnt_out,
            Cfg k) {
  constexpr int L = K == 1 ? 5 : 6;   // jump levels for C <= 32 K
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long stream = (long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (stream >= k.S) return;          // a whole warp: no barrier follows
  float* F = reinterpret_cast<float*>(smem) + (size_t)wib * k.warp_words;
  const int C = k.C;
  const long sbase = stream * (long)k.nc * C;
  init_state<MC>(k, F, lane);
  Counts n;
  int ir = 0, iw = 0;                 // one queue group: counters here
  float shift = 0.0f;                 // one core: its shift here

  // this chunk's inputs in registers; the next chunk's loads are issued
  // a chunk ahead
  Inputs<K, MC> cur, nxt;
  cur.load(t_in, fb_in, ch_in, row_in, w_in, v_in, cid_in, sbase, 0, k.nc,
           C, lane);

  for (int c = 0; c < k.nc; ++c) {
    nxt.load(t_in, fb_in, ch_in, row_in, w_in, v_in, cid_in, sbase, c + 1,
             k.nc, C, lane);
    const float(&t)[K] = cur.t;
    const int(&fb)[K] = cur.fb;
    const int(&ch)[K] = cur.ch;
    const int(&row)[K] = cur.row;
    const int base = c * C;           // stamp of this chunk's request 0

    // ---- 1. links and ranks ---------------------------------------------
    int prev[K], pin[K], didx[K], plink[K], klast[K];
    int cr = 0, cw = 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const SlotLinks o = slot_links<MC>(k, F, q, lane, base, cur.v[q],
                                         cur.w[q], fb[q], ch[q],
                                         cur.cid[MC ? q : 0], &cr, &cw);
      prev[q] = o.prev;
      pin[q] = o.pin;
      didx[q] = o.didx;
      plink[q] = o.plink;
      klast[q] = o.klast;
    }
    const int nr = cr, nw = cw;
    if (MC) {                         // the rank table, laid out by group
      group_offsets(k, F, lane);
#pragma unroll
      for (int q = 0; q < K; ++q)
        put_rank(k, F, cur.v[q], cur.w[q], ch[q], didx[q], q * 32 + lane);
      __syncwarp();
    }

    // ---- 2. per-request tables and carried-state gathers ----------------
    Req rq[K];
    float wv[K], vv[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int rp = gather<K>(row, prev[q], lane);
      const int fp = gather<K>(fb, pin[q], lane);
      const Queue qu = MC ? queue_grouped(k, F, cur.v[q], cur.w[q], ch[q])
                          : queue_single(k, cur.w[q], ir, iw, nr, nw);
      rq[q] = request_tables(k, F, base + q * 32 + lane, cur.v[q], cur.w[q],
                             fb[q], ch[q], row[q], prev[q], pin[q], didx[q],
                             rp, fp, qu);
      n.add(rq[q]);
      wv[q] = rq[q].we;
      vv[q] = rq[q].lb;
    }

    // ---- 3. W, V: sums along the channel / bank links, pointer jumping --
    int jc[L][K], jb[L][K];
    int pc[K], pk[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      pc[q] = pin[q];
      pk[q] = prev[q];
    }
    int lc = 0, lbk = 0;              // rounds in use per chain
#pragma unroll
    for (int r = 0; r < L; ++r) {
      int anyc = 0, anyb = 0;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        jc[r][q] = pc[q];
        jb[r][q] = pk[q];
        anyc |= pc[q] >= 0;
        anyb |= pk[q] >= 0;
      }
      anyc = __any_sync(kFull, anyc);
      anyb = __any_sync(kFull, anyb);
      if (!anyc && !anyb) break;
      if (anyc) lc = r + 1;
      if (anyb) lbk = r + 1;
      float nwv[K], nvv[K];
      int npc[K], npk[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float gw = gather<K>(wv, pc[q], lane);
        const int gp = gather<K>(pc, pc[q], lane);
        const float gv = gather<K>(vv, pk[q], lane);
        const int gk = gather<K>(pk, pk[q], lane);
        jump_step(wv[q], pc[q], gw, gp, &nwv[q], &npc[q]);
        jump_step(vv[q], pk[q], gv, gk, &nvv[q], &npk[q]);
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        wv[q] = nwv[q];
        pc[q] = npc[q];
        vv[q] = nvv[q];
        pk[q] = npk[q];
      }
    }
    const float(&W)[K] = wv;
    const float(&V)[K] = vv;
    int gp[K];
#pragma unroll
    for (int q = 0; q < K; ++q)
      gp[q] = prune_link(k, prev[q], rq[q].lat, W[q],
                         gather<K>(W, prev[q], lane));

    // ---- 4. fixed point: Jacobi passes ----------------------------------
    float d[K];
#pragma unroll
    for (int q = 0; q < K; ++q) d[q] = 0.0f;
    for (int passes = 1;; ++passes) {
      float m[K];
      float carry = -INFINITY;        // max of the key over earlier slots
      if (MC) seed_carry(k, F, lane);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float head =
            head_time(rq[q].head0, rq[q].gh, gather<K>(d, rq[q].gh, lane));
        const float key = scan_key(rq[q].info, head, t[q]);
        float sh = shift, ex;         // multi-core: the core's, in `sh`
        float total = -INFINITY;
        if (MC)
          ex = core_scan(F + k.o_carry, cur.v[q], cur.cid[MC ? q : 0],
                         plink[q], klast[q], key, lane);
        else
          ex = lane_excl_max(key, lane, &total);
        if (MC) sh = -INFINITY;
        const float dp = gather<K>(d, gp[q], lane);
        m[q] = pass_start(k, rq[q].info, t[q], head, sh, carry, ex,
                          rq[q].bank0, gp[q], dp, rq[q].lat, d[q], W[q]);
        carry = fmaxf(carry, total);
      }
#pragma unroll
      for (int r = 0; r < L; ++r) {   // max along the channel links
        if (r >= lc) break;
        float nm[K];
#pragma unroll
        for (int q = 0; q < K; ++q)
          nm[q] = link_max(m[q], jc[r][q], gather<K>(m, jc[r][q], lane));
#pragma unroll
        for (int q = 0; q < K; ++q) m[q] = nm[q];
      }
#pragma unroll
      for (int q = 0; q < K; ++q)
        m[q] = chan_to_bank(rq[q].info, m[q], W[q], rq[q].bus0, V[q]);
#pragma unroll
      for (int r = 0; r < L; ++r) {   // max along the bank links
        if (r >= lbk) break;
        float nm[K];
#pragma unroll
        for (int q = 0; q < K; ++q)
          nm[q] = link_max(m[q], jb[r][q], gather<K>(m, jb[r][q], lane));
#pragma unroll
        for (int q = 0; q < K; ++q) m[q] = nm[q];
      }
      int moved = 0;
#pragma unroll
      for (int q = 0; q < K; ++q)
        moved |= settle(k, rq[q].info, m[q], V[q], &d[q]);
      if (last_pass(k, passes, moved)) break;
    }

    // ---- 5. outputs; advance the carried state --------------------------
    float gmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      const float head =
          head_time(rq[q].head0, rq[q].gh, gather<K>(d, rq[q].gh, lane));
      if (i < C) done_out[sbase + base + i] = d[q];
      const float key = scan_key(rq[q].info, head, t[q]);
      if (MC)                         // raises each core's carried shift
        core_scan(F + k.o_shift, cur.v[q], cur.cid[MC ? q : 0], plink[q],
                  klast[q], key, lane);
      else
        gmax = fmaxf(gmax, key);
      commit(k, F, rq[q].info, fb[q], ch[q], row[q], rq[q].slot, d[q]);
    }
    if (MC) {
      advance_groups(k, F, lane);
    } else {
      shift = fmaxf(shift, warp_max(gmax));
      ir += nr;
      iw += nw;
    }
    cur = nxt;
    __syncwarp();
  }
  write_stream(k, MC ? F : nullptr, stream, lane, shift, n, shift_out,
               cnt_out);
}

// ===== any C <= 1024: per-request arrays in shared memory =================

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

template <typename T>
__device__ __forceinline__ void swap_ptr(T*& a, T*& b) {
  T* t = a;
  a = b;
  b = t;
}

// a[j], or a zero that the caller ignores where j is a missing link
template <typename T>
__device__ __forceinline__ T at(const T* a, int j) {
  return j >= 0 ? a[j] : T(0);
}

template <bool MC>
__global__ void __launch_bounds__(32 * kWarpsMax)
replay_smem(const float* __restrict__ t_in, const int* __restrict__ fb_in,
            const int* __restrict__ ch_in, const int* __restrict__ row_in,
            const int* __restrict__ w_in, const int* __restrict__ v_in,
            const int* __restrict__ cid_in, float* __restrict__ done_out,
            float* __restrict__ shift_out, int* __restrict__ cnt_out,
            Cfg k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long stream = (long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (stream >= k.S) return;          // a whole warp: no barrier follows
  float* F = reinterpret_cast<float*>(smem) + (size_t)wib * k.warp_words;
  int* I = reinterpret_cast<int*>(F);
  const int C = k.C, K = k.K;
  const long sbase = stream * (long)k.nc * C;
  float* const lat = F + k.o_lat;
  float* const head0 = F + k.o_head0;
  float* const bank0 = F + k.o_bank0;
  float* const bus0 = F + k.o_bus0;
  float* const done = F + k.o_done;
  int* const info = I + k.o_info;
  int* const ghead = I + k.o_ghead;
  int* const gprev = I + k.o_gprev;
  int* const slot = I + k.o_slot;
  short* const jc = reinterpret_cast<short*>(I + k.o_jc);
  short* const jb = reinterpret_cast<short*>(I + k.o_jb);
  // multi-core: each request's slot core link + 1, and 64 if it is its
  // core's last request of the slot
  int* const plinks = I + k.o_plink;
  const int stage = k.n_in * C;
  init_state<MC>(k, F, lane);
  Counts n;
  int ir = 0, iw = 0;                 // one queue group: counters here
  float shift = 0.0f;                 // one core: its shift here

  // chunk `c`'s inputs -> staging buffer `b`, asynchronously
  auto prefetch = [&](int c, int b) {
    float* st = F + k.o_in + b * stage;
    const long at0 = sbase + (long)c * C;
    for (int i = lane; i < C; i += 32) {
      cp_async4(st + i, t_in + at0 + i);
      cp_async4(st + C + i, fb_in + at0 + i);
      cp_async4(st + 2 * C + i, ch_in + at0 + i);
      cp_async4(st + 3 * C + i, row_in + at0 + i);
      cp_async4(st + 4 * C + i, w_in + at0 + i);
      cp_async4(st + 5 * C + i, v_in + at0 + i);
      if (MC) cp_async4(st + 6 * C + i, cid_in + at0 + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  prefetch(0, 0);

  for (int c = 0; c < k.nc; ++c) {
    if (c + 1 < k.nc) prefetch(c + 1, (c + 1) & 1);
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const float* tt = F + k.o_in + (c & 1) * stage;
    const int* fb = I + k.o_in + (c & 1) * stage + C;
    const int* ch = fb + C;
    const int* row = ch + C;
    const int* ww = row + C;
    const int* vv = ww + C;
    const int* cc = vv + C;           // core ids (multi-core only)
    const int base = c * C;
    // a request's core, 0 where invalid (multi-core only)
    auto core_of = [&](int i, int v) { return MC && v ? cc[i] : 0; };

    // ---- 1. links and ranks, one 32-request slot at a time ---------------
    int cr = 0, cw = 0;
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      const bool in = i < C;
      const int v = in && vv[i] != 0, w = in && ww[i] != 0;
      const SlotLinks o = slot_links<MC>(k, F, q, lane, base, v, w,
                                         in ? fb[i] : 0, in ? ch[i] : 0,
                                         in ? core_of(i, v) : 0, &cr, &cw);
      if (in) {
        jb[i] = (short)o.prev;          // level 0 of the jump pointers
        jc[i] = (short)o.pin;
        slot[i] = o.didx;               // rank within its queue
        if (MC) plinks[i] = (o.plink + 1) | o.klast << 6;
      }
    }
    __syncwarp();
    const int nr = cr, nw = cw;
    if (MC) {                         // the rank table, laid out by group
      group_offsets(k, F, lane);
      for (int i = lane; i < C; i += 32)
        put_rank(k, F, vv[i] != 0, ww[i] != 0, ch[i], slot[i], i);
      __syncwarp();
    }

    // ---- 2. per-request tables and carried-state gathers ----------------
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      if (i >= C) break;
      const int prev = jb[i], pin = jc[i];
      const int v = vv[i] != 0, w = ww[i] != 0;
      const Queue qu = MC ? queue_grouped(k, F, v, w, ch[i])
                          : queue_single(k, w, ir, iw, nr, nw);
      const Req r = request_tables(k, F, base + i, v, w, fb[i], ch[i],
                                   row[i], prev, pin, slot[i], at(row, prev),
                                   at(fb, pin), qu);
      n.add(r);
      lat[i] = r.lat;
      head0[i] = r.head0;
      bank0[i] = r.bank0;
      bus0[i] = r.bus0;
      info[i] = r.info;
      ghead[i] = r.gh;
      slot[i] = r.slot;
      done[i] = 0.0f;
      F[k.o_a0 + i] = r.we;
      I[k.o_p0 + i] = pin;
      F[k.o_b0 + i] = r.lb;
      I[k.o_q0 + i] = prev;
    }
    __syncwarp();

    // ---- 3. W, V: sums along the channel / bank links, pointer jumping --
    float *wa = F + k.o_a0, *wb = F + k.o_a1, *va = F + k.o_b0,
          *vb = F + k.o_b1;
    int *pa = I + k.o_p0, *pb = I + k.o_p1, *qa = I + k.o_q0,
        *qb = I + k.o_q1;
    int lc = 0, lbk = 0;
    for (int r = 0; r < k.levels; ++r) {
      int anyc = 0, anyb = 0;
      for (int q = 0; q < K; ++q) {
        const int i = q * 32 + lane;
        if (i >= C) break;
        const int pc = pa[i], pk = qa[i];
        if (r > 0) {
          jc[r * C + i] = (short)pc;
          jb[r * C + i] = (short)pk;
        }
        anyc |= pc >= 0;
        anyb |= pk >= 0;
        jump_step(wa[i], pc, at(wa, pc), at(pa, pc), &wb[i], &pb[i]);
        jump_step(va[i], pk, at(va, pk), at(qa, pk), &vb[i], &qb[i]);
      }
      anyc = __any_sync(kFull, anyc);
      anyb = __any_sync(kFull, anyb);
      __syncwarp();
      swap_ptr(wa, wb);
      swap_ptr(pa, pb);
      swap_ptr(va, vb);
      swap_ptr(qa, qb);
      if (anyc) lc = r + 1;
      if (anyb) lbk = r + 1;
      if (!anyc && !anyb) break;
    }
    const float* W = wa;
    const float* V = va;
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      if (i >= C) break;
      const int prev = jb[i];
      gprev[i] = prune_link(k, prev, lat[i], W[i], at(W, prev));
    }
    __syncwarp();

    // ---- 4. fixed point: Jacobi passes (the iterate in `done`) ----------
    float* const m0 = F + k.o_m0;
    float* const m1 = F + k.o_m1;
    for (int passes = 1;; ++passes) {
      float carry = -INFINITY;
      if (MC) seed_carry(k, F, lane);
      for (int q = 0; q < K; ++q) {
        const int i = q * 32 + lane;
        const bool in = i < C;
        float key = -INFINITY, head = 0.0f;
        if (in) {
          head = head_time(head0[i], ghead[i], at(done, ghead[i]));
          key = scan_key(info[i], head, tt[i]);
        }
        float total = -INFINITY, ex;
        if (MC) {                     // the core's shift, carry and slot
          const int v = in && (info[i] & kValid), pl = in ? plinks[i] : 0;
          ex = core_scan(F + k.o_carry, v, in ? core_of(i, v) : 0,
                         (pl & 63) - 1, pl >> 6, key, lane);
        } else {
          ex = lane_excl_max(key, lane, &total);
        }
        if (in)
          m0[i] = pass_start(k, info[i], tt[i], head,
                             MC ? -INFINITY : shift, carry, ex, bank0[i],
                             gprev[i], at(done, gprev[i]), lat[i], done[i],
                             W[i]);
        carry = fmaxf(carry, total);
      }
      __syncwarp();
      float *cur = m0, *nxt = m1;
      for (int r = 0; r < lc; ++r) {    // max along the channel links
        for (int q = 0; q < K; ++q) {
          const int i = q * 32 + lane;
          if (i >= C) break;
          const int j = jc[r * C + i];
          nxt[i] = link_max(cur[i], j, at(cur, j));
        }
        __syncwarp();
        swap_ptr(cur, nxt);
      }
      for (int q = 0; q < K; ++q) {
        const int i = q * 32 + lane;
        if (i >= C) break;
        cur[i] = chan_to_bank(info[i], cur[i], W[i], bus0[i], V[i]);
      }
      __syncwarp();
      for (int r = 0; r < lbk; ++r) {   // max along the bank links
        for (int q = 0; q < K; ++q) {
          const int i = q * 32 + lane;
          if (i >= C) break;
          const int j = jb[r * C + i];
          nxt[i] = link_max(cur[i], j, at(cur, j));
        }
        __syncwarp();
        swap_ptr(cur, nxt);
      }
      int moved = 0;
      for (int q = 0; q < K; ++q) {
        const int i = q * 32 + lane;
        if (i >= C) break;
        moved |= settle(k, info[i], cur[i], V[i], &done[i]);
      }
      __syncwarp();
      if (last_pass(k, passes, moved)) break;
    }

    // ---- 5. outputs; advance the carried state --------------------------
    float gmax = -INFINITY;
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      const bool in = i < C;
      float key = -INFINITY;
      if (in) {
        const float head =
            head_time(head0[i], ghead[i], at(done, ghead[i]));
        done_out[sbase + base + i] = done[i];
        key = scan_key(info[i], head, tt[i]);
        commit(k, F, info[i], fb[i], ch[i], row[i], slot[i], done[i]);
      }
      if (MC) {                       // raises each core's carried shift
        const int v = in && (info[i] & kValid), pl = in ? plinks[i] : 0;
        core_scan(F + k.o_shift, v, in ? core_of(i, v) : 0, (pl & 63) - 1,
                  pl >> 6, key, lane);
      } else {
        gmax = fmaxf(gmax, key);
      }
    }
    if (MC) {
      advance_groups(k, F, lane);
    } else {
      shift = fmaxf(shift, warp_max(gmax));
      ir += nr;
      iw += nw;
    }
    __syncwarp();
  }
  write_stream(k, MC ? F : nullptr, stream, lane, shift, n, shift_out,
               cnt_out);
}

template <typename Kern>
int launch_kernel(Kern kern, const float* t, const int* fb, const int* ch,
                  const int* row, const int* w, const int* v, const int* cid,
                  float* done, float* shift, int* cnt, const Cfg& k, int sms,
                  int optin, cudaStream_t stream) {
  const size_t warp_bytes = (size_t)k.warp_words * 4;
  if (warp_bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  // streams per block: the fewest warps on the busiest SM (one wave of
  // blocks spread evenly), ties to the larger block; only as many as fit
  // the opt-in shared memory
  int warps = 1;
  long best = -1;
  for (int wpb = kWarpsMax; wpb >= 1; wpb >>= 1) {
    if ((size_t)wpb * warp_bytes > (size_t)optin) continue;
    const long blocks = (k.S + wpb - 1) / wpb;
    const long busiest = (blocks + sms - 1) / sms * wpb;
    if (best < 0 || busiest < best) {
      best = busiest;
      warps = wpb;
    }
  }
  const size_t smem = (size_t)warps * warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((k.S + warps - 1) / warps);
  kern<<<blocks, 32 * warps, smem, stream>>>(t, fb, ch, row, w, v, cid, done,
                                             shift, cnt, k);
  return (int)cudaGetLastError();
}

Cfg make_cfg(int S, int nc, int C, int channels, int banks_per_channel,
             int tRCD, int tRP, int tCAS, int read_queue, int write_queue,
             int n_cores, int n_qg, bool mc, int max_passes, float busy,
             float tol) {
  Cfg k{};
  k.S = S;
  k.nc = nc;
  k.C = C;
  k.K = (C + 31) / 32;
  k.levels = 1;
  while ((1 << k.levels) < C) ++k.levels;
  k.ch_n = channels;
  k.n_banks = channels * banks_per_channel;
  k.tRCD = tRCD;
  k.tRP = tRP;
  k.tCAS = tCAS;
  k.Qr = read_queue;
  k.Qw = write_queue;
  k.cap = max_passes > 0 ? max_passes : C + 2;
  k.busy = busy;
  k.tol = tol;
  k.intra_heads = read_queue < C || write_queue < C;
  k.n_cores = n_cores;
  k.n_qg = n_qg;
  layout(k, C > 64, mc);
  return k;
}

template <bool MC>
int launch_instance(const float* t, const int* fb, const int* ch,
                    const int* row, const int* w, const int* v,
                    const int* cid, float* done, float* shift, int* cnt,
                    const Cfg& k, int sms, int optin, cudaStream_t s) {
  if (k.C <= 32)
    return launch_kernel(replay_regs<1, MC>, t, fb, ch, row, w, v, cid, done,
                         shift, cnt, k, sms, optin, s);
  if (k.C <= 64)
    return launch_kernel(replay_regs<2, MC>, t, fb, ch, row, w, v, cid, done,
                         shift, cnt, k, sms, optin, s);
  return launch_kernel(replay_smem<MC>, t, fb, ch, row, w, v, cid, done,
                       shift, cnt, k, sms, optin, s);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// n_cores in [1, kMaxCores] cores per stream (core ids in cid) and n_qg
// queue groups per direction, 1 or the channel count, at most kMaxGroups;
// anything else is refused with cudaErrorInvalidValue. n_cores = n_qg = 1
// runs the single-core instance (cid is not read) unless `grouped` asks for
// the multi-core one.
extern "C" int replay_megakernel_launch(
    const float* t, const int* fb, const int* ch, const int* row,
    const int* w, const int* v, const int* cid, float* done, float* shift,
    int* cnt, int S, int nc, int C, int channels, int banks_per_channel,
    int tRCD, int tRP, int tCAS, int read_queue, int write_queue,
    int n_cores, int n_qg, int grouped, int max_passes, float busy,
    float tol, void* stream) {
  if (n_cores < 1 || n_cores > kMaxCores || n_qg < 1 || n_qg > kMaxGroups ||
      (n_qg != 1 && n_qg != channels))
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || nc <= 0) return (int)cudaSuccess;
  if (C < 1 || C > 1024 || (long)nc * C > 0x7fffffffL || channels < 1 ||
      banks_per_channel < 1 || read_queue < 1 || write_queue < 1)
    return (int)cudaErrorInvalidValue;
  const bool mc = grouped || n_cores > 1 || n_qg > 1;
  const Cfg k = make_cfg(S, nc, C, channels, banks_per_channel, tRCD, tRP,
                         tCAS, read_queue, write_queue, n_cores, n_qg, mc,
                         max_passes, busy, tol);
  int dev = 0, optin = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t s = (cudaStream_t)stream;
  if (mc)
    return launch_instance<true>(t, fb, ch, row, w, v, cid, done, shift, cnt,
                                 k, sms, optin, s);
  return launch_instance<false>(t, fb, ch, row, w, v, cid, done, shift, cnt,
                                k, sms, optin, s);
}
