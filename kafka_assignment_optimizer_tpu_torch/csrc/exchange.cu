// B4+B5+B6: one whole exchange sweep in one cooperative launch: one
// pair-exchange proposal per (chain, partition), the chain's thinning maps,
// the keep test, the apply and the leader-histogram update.
//
// Replaces kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424
// (_exchange_kernel, the per-partition half-deltas),
// kafka_assignment_optimizer_tpu/ops/thin_pallas.py:247 (_exch_maps_kernel,
// the max-priority maps over the leadership tokens) and
// kafka_assignment_optimizer_tpu/ops/thin_pallas.py:277 (_exch_finish_kernel,
// keep, apply and the lcnt delta). It computes exactly what
// sweep._exchange_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp) computes:
// a_new and lcnt' (replica and rack totals are exchange-invariant), bit for
// bit, and leaves the records s, b_other, tok_out, tok_in, prio [N, P] and
// the maps m_out, m_in [N, B+1] of sweep.exchange_propose in its scratch.
//
// Lanes: one launch runs the sweep of L lanes (the portfolio's configs or
// a batch's instances), each against its own tables (ModelTabs, lane
// stride 0 where they are shared), leader band and penalty scale (tables
// too), temperature temps[l] and key keys[l], all read from device memory;
// the grid-stride loops run over all L * N chains, and one grid.sync()
// serves every lane. The draws of a lane's sweep key that
// sweep.propose_exchange makes before its words (the stride d, the key of
// the words and the two keys of the phases: ten threefry words) are made
// in phase 0, from the lane's key, and kept in the scratch for the phases
// behind the barrier. So nothing of a sweep passes by value, and a launch
// captured in a CUDA graph serves every sweep of a fused group and every
// model of a bucket. A lane's outputs are what a launch on that lane alone
// writes.
//
// Design, for Hopper:
//
// - Three phases behind two grid-wide barriers (cooperative_groups'
//   this_grid().sync(), a cooperative launch). The keep test needs each
//   chain's finished maps, a dependency across the whole chain; a grid
//   barrier keeps it inside the launch, so an exchange sweep is one device
//   activity: no zero fills, no second launch, no separate lcnt add.
//     phase 0: zero the maps [2, N, B+1], copy lcnt into lcnt', make the
//              lanes' draws (a thread a chain; chain 0's keeps them in
//              the scratch [L]) and draw each chain's pairing phase once
//              into a scratch [N]; grid.sync()
//     phase 1: the proposals and the maps (below); grid.sync()
//     phase 2: the keep test for both sides of each pair (token B bypasses
//              its map), the apply into a fully written a_new, and +1/-1
//              atomics of the slot-0 difference straight into lcnt'.
//   A cooperative grid must be resident as a whole: the launcher launches
//   min(blocks needed, blocks resident) blocks (the occupancy API and the
//   SM count), and every phase covers its work with a grid-stride loop, so
//   every bucket size runs.
// - The pairing in the launch. The reference keeps the pairing, the
//   partner views and the combination of the halves in XLA because a TPU
//   gather is slow; here a partner's row is one load. The stride d is a
//   draw of phase 0 (the same words for every chain of a lane). Each
//   chain's phase is jax.random.randint(kph, (N, 1), 0, 2d): the randint's
//   two words at counter n (phase 0 splits kph) and its
//   uint32 arithmetic. Then partition p is on the lower side iff ((p + phase) / d)
//   is even, and pairs with p + d (lower) or p - d (upper).
// - Random words in registers. Word j of partition q is threefry2x32 of the
//   64-bit counter (n*P + q)*4 + j with the outputs xor-ed, as prng.bits
//   draws bits[N, P, 4]; a pair draws the words of its lower side. The
//   Metropolis word is hashed only where the pair is legal and its delta
//   negative, the priority word only where it is accepted. No bits tensor
//   exists.
// - One thread a pair in phase 1: the lower side's thread evaluates both
//   halves, writes both partitions' records (both sides carry the same
//   tokens and priority) to a global scratch and updates the maps once, an
//   order-free integer atomicMax of the priority's bit pattern (exact for
//   non-negative floats); the upper side's thread has nothing to do. Phase
//   2 reads the records back, one thread a partition.
// - Token B (no leadership moves: the pair swaps followers, or leaders for
//   leaders) bypasses its map in the keep test, but the reference's maps
//   hold its maximum too; the lanes of a warp reduce it first
//   (__reduce_max_sync), so one atomic a warp reaches the chain's entry B.
//   A block's tile of partitions lies in one chain, so a warp does too.
//
// What bounds it on Hopper: bytes (a read, a_new written, the records, the
// gathered weights) against INT32 operations (the threefry words, about 71
// instructions each). A partition whose partner falls off the end
// (pair_valid false) is never accepted, but its records still follow the
// reference's rolls: its b_other is the wrapped partner's slot value, drawn
// from that partner's own pairing.
//
// Arithmetic: built with --fmad=false; __fsub_rn/__fmul_rn/__fdiv_rn and
// expf keep the Metropolis test equal to the plain version on the card.
// An empty (padded) row draws slot -1, whose slot value is 0 (no wrap, as
// the reference's _slot_value).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// for timing (site_probe.py builds variants): the phases run (0: phase 0
// only; 1: phases 0-1; 2: the whole sweep), the proposal's stages (1: the
// pairing, the slots and the records of rejected proposals; 2: the whole
// proposal), and cheap stand-ins for the threefry words (wrong results)
#ifndef KAO_EXCH_PHASES
#define KAO_EXCH_PHASES 2
#endif
#ifndef KAO_EXCH_STAGES
#define KAO_EXCH_STAGES 2
#endif
#ifndef KAO_EXCH_FAKE_WORDS
#define KAO_EXCH_FAKE_WORDS 0
#endif

// a lane's scalars and the draws of its sweep key, made in phase 0
struct ExchLane {
  uint32_t k0, k1;          // the key of the bits [N, P, 4]
  uint32_t h0, h1, l0, l1;  // the phase randint's keys: higher, lower word
  float temp, lam;
  int d, llo, lhi;
};

// what the launch takes: every lane
struct ExchLaunch {
  ModelTabs t;
  const long long* keys;  // [L, 2] each lane's sweep key
  const float* temps;     // [L] each lane's sweep temperature
  ExchLane* lane;         // [L] scratch: each lane's draws (phase 0)
  const int* a;     // [L, N, P, R]
  const int* lcnt;  // [L, N, B1]
  int* a_new;       // [L, N, P, R], every element written
  int* lcnt_new;    // [L, N, B1]
  int* rec;    // [L, 5, N, P] scratch
  int* maps;   // [L, 2, N, B1] scratch
  int* phase;  // [L, N] scratch
  int L, N, P, R, B1;
  int nblk;  // partition tiles of KAO_THREADS a chain
};

// one lane's view of the launch
struct ExchArgs {
  const int* a;             // [N, P, R]
  const int* rf;            // [P]
  const uint8_t* valid;     // [P, R]
  const int* part_rack_hi;  // [P]
  const int* w_lead;        // [P, B1]
  const int* w_foll;        // [P, B1]
  const int* rack_of;       // [B1]
  const int* lcnt;          // [N, B1]
  int* a_new;     // [N, P, R], every element written
  int* lcnt_new;  // [N, B1]
  int* rec;    // [5, N, P] scratch: s, b_other, tok_out, tok_in, prio bits
  int* maps;   // [2, N, B1] scratch: m_out, m_in (float bits)
  int* phase;  // [N] scratch: each chain's pairing phase
  uint32_t k0, k1;          // the key of the bits [N, P, 4]
  uint32_t h0, h1, l0, l1;  // the phase randint's keys: higher, lower word
  float temp, lam;
  int d, llo, lhi;
  int N, P, R, B1;
  int nblk;  // partition tiles of KAO_THREADS a chain
};

__device__ __forceinline__ ExchArgs exch_view(const ExchLaunch& G, int l) {
  const ExchLane& x = G.lane[l];
  const size_t n0 = (size_t)l * G.N;
  const size_t rows = n0 * G.P * G.R;
  return ExchArgs{G.a + rows,
                  KAO_LANE(G.t, rf, l),
                  KAO_LANE(G.t, valid, l),
                  KAO_LANE(G.t, part_rack_hi, l),
                  KAO_LANE(G.t, w_lead, l),
                  KAO_LANE(G.t, w_foll, l),
                  KAO_LANE(G.t, rack_of, l),
                  G.lcnt + n0 * G.B1, G.a_new + rows,
                  G.lcnt_new + n0 * G.B1, G.rec + 5 * n0 * G.P,
                  G.maps + 2 * n0 * G.B1, G.phase + n0,
                  x.k0, x.k1, x.h0, x.h1, x.l0, x.l1, x.temp, x.lam,
                  x.d, x.llo, x.lhi, G.N, G.P, G.R, G.B1, G.nblk};
}

// the word at counter c under key (k0, k1), k2 = k0 ^ k1 ^ 0x1BD11BDA
__device__ __forceinline__ uint32_t word(uint32_t k0, uint32_t k1,
                                         uint32_t k2, uint64_t c) {
  return KAO_EXCH_FAKE_WORDS ? (uint32_t)c * 0x9E3779B9u ^ k0
                             : threefry_word(k0, k1, k2, c);
}

// a[n, p, s], 0 where s is outside [0, R)
__device__ __forceinline__ int slot_value(const int* row, int s, int R) {
  return (s >= 0 && s < R) ? row[s] : 0;
}

// the slot a partition draws from its OWN pairing (lower side: word 0 of
// its own words; upper side: word 1 of its wrapped partner p - d's words)
__device__ __forceinline__ int own_slot(const ExchArgs& g, uint32_t k2, int n,
                                        int p, int phase) {
  const bool low = ((p + phase) / g.d) % 2 == 0;
  const int src = low ? p : (p - g.d < 0 ? p - g.d + g.P : p - g.d);
  const uint32_t w =
      word(g.k0, g.k1, k2, ((uint64_t)n * g.P + src) * 4 + !low);
  return rand_idx(u01(w), g.rf[p]);
}

// one side's row: the replicas on the racks of the broker it gives (b_out)
// and takes (b_in), and whether b_in is in it already
struct RowScan {
  int c_out, c_in;
  bool in_row;
};

__device__ __forceinline__ RowScan scan_row(const ExchArgs& g, size_t i,
                                            int p, int r_out, int r_in,
                                            int b_in) {
  const int R = g.R, B = g.B1 - 1;
  const int* row = g.a + i * R;
  const uint8_t* vrow = g.valid + (size_t)p * R;
  RowScan s{0, 0, false};
  for (int r = 0; r < R; ++r) {
    const bool v = vrow[r] != 0;
    const int b = v ? row[r] : B;
    const int rk = g.rack_of[b];
    s.c_out += rk == r_out;
    s.c_in += rk == r_in;
    s.in_row |= v && b == b_in;
  }
  return s;
}

// the rack-diversity delta of one side (its racks differ)
__device__ __forceinline__ int div_delta(const RowScan& s, int cap) {
  return max(s.c_out - 1 - cap, 0) - max(s.c_out - cap, 0) +
         max(s.c_in + 1 - cap, 0) - max(s.c_in - cap, 0);
}

// the weight delta of one side: its slot's table at the broker it takes
// minus at the broker it gives
__device__ __forceinline__ int w_delta(const ExchArgs& g, int p, bool lead,
                                       int b_out, int b_in) {
  const int* t = (lead ? g.w_lead : g.w_foll) + (size_t)p * g.B1;
  return t[b_in] - t[b_out];
}

// the pair (lo, up = lo + d) of chain n, both in range
struct Pair {
  int s_lo, s_up, b_lo, b_up;
  int prio;  // float bits, 0 where rejected
};

__device__ __forceinline__ Pair eval_pair(const ExchArgs& g, uint32_t k2,
                                          int n, int lo) {
  const int up = lo + g.d, R = g.R;
  const size_t i_lo = (size_t)n * g.P + lo, i_up = i_lo + g.d;
  const uint64_t c = (uint64_t)i_lo * 4;
  const int rf_lo = g.rf[lo], rf_up = g.rf[up];
  Pair q;
  q.s_lo = rand_idx(u01(word(g.k0, g.k1, k2, c)), rf_lo);
  q.s_up = rand_idx(u01(word(g.k0, g.k1, k2, c + 1)), rf_up);
  q.b_lo = slot_value(g.a + i_lo * R, q.s_lo, R);
  q.b_up = slot_value(g.a + i_up * R, q.s_up, R);
  q.prio = 0;
  if (KAO_EXCH_STAGES < 2) return q;
  const int rk_lo = g.rack_of[q.b_lo], rk_up = g.rack_of[q.b_up];
  // lo gives b_lo and takes b_up; up the reverse
  const RowScan s_lo = scan_row(g, i_lo, lo, rk_lo, rk_up, q.b_up);
  const RowScan s_up = scan_row(g, i_up, up, rk_up, rk_lo, q.b_lo);
  // both sides must be live partitions (padded rows have no slot)
  if (s_lo.in_row || s_up.in_row || rf_lo <= 0 || rf_up <= 0) return q;

  const bool lead_lo = q.s_lo == 0, lead_up = q.s_up == 0;
  const int dw = w_delta(g, lo, lead_lo, q.b_lo, q.b_up) +
                 w_delta(g, up, lead_up, q.b_up, q.b_lo);
  const int ddiv = rk_lo != rk_up ? div_delta(s_lo, g.part_rack_hi[lo]) +
                                        div_delta(s_up, g.part_rack_hi[up])
                                  : 0;
  int dl = 0;
  if (lead_lo != lead_up) {  // one leadership unit moves, out -> in
    const int* lc = g.lcnt + (size_t)n * g.B1;
    const int lo_c = lc[lead_lo ? q.b_lo : q.b_up];
    const int li_c = lc[lead_lo ? q.b_up : q.b_lo];
    dl = band_pen(lo_c - 1, g.llo, g.lhi) - band_pen(lo_c, g.llo, g.lhi) +
         band_pen(li_c + 1, g.llo, g.lhi) - band_pen(li_c, g.llo, g.lhi);
  }
  const float delta = __fsub_rn((float)dw, __fmul_rn(g.lam, (float)(dl + ddiv)));
  // the Metropolis word only where it decides
  const bool accept =
      delta >= 0.f ||
      metropolis(delta, u01(word(g.k0, g.k1, k2, c + 2)), g.temp);
  if (accept)
    q.prio = __float_as_int(
        __fadd_rn(u01(word(g.k0, g.k1, k2, c + 3)), 1e-6f));
  return q;
}

// the records of partition i (flat n*P + p)
__device__ __forceinline__ void put(const ExchArgs& g, size_t i, int s,
                                    int b_other, int tok_out, int tok_in,
                                    int prio) {
  const size_t NP = (size_t)g.N * g.P;
  g.rec[i] = s;
  g.rec[NP + i] = b_other;
  g.rec[2 * NP + i] = tok_out;
  g.rec[3 * NP + i] = tok_in;
  g.rec[4 * NP + i] = prio;
}

// randint(kph, (N, 1), 0, 2d)[n], in uint32, from a lane's draws
__device__ __forceinline__ int draw_phase(const ExchLane& x, int n) {
  const uint32_t span = 2u * (uint32_t)x.d;
  uint32_t mul = (1u << 16) % span;
  mul = (mul * mul) % span;
  const uint32_t hi = word(x.h0, x.h1, x.h0 ^ x.h1 ^ 0x1BD11BDAu, n);
  const uint32_t lo = word(x.l0, x.l1, x.l0 ^ x.l1 ^ 0x1BD11BDAu, n);
  return (int)(((hi % span) * mul + lo % span) % span);
}

// phase 1 for partition p of chain n (p may be past the end: the lane
// still joins its warp's reduction of token B)
__device__ __forceinline__ void propose(const ExchArgs& g, uint32_t k2, int n,
                                        int p, int phase) {
  const int P = g.P, d = g.d, B = g.B1 - 1;
  int b_prio = 0;  // an accepted pair that moves no leadership: token B
  if (p < P) {
    const size_t i = (size_t)n * P + p;
    const bool low = ((p + phase) / d) % 2 == 0;
    const int q = low ? p + d : p - d;
    if (q >= 0 && q < P) {
      if (low) {  // the upper side's records come from its lower side
        const Pair r = eval_pair(g, k2, n, p);
        const bool hot = r.prio != 0 && (r.s_lo == 0) != (r.s_up == 0);
        const int t_out = hot ? (r.s_lo == 0 ? r.b_lo : r.b_up) : B;
        const int t_in = hot ? (r.s_lo == 0 ? r.b_up : r.b_lo) : B;
        put(g, i, r.s_lo, r.b_up, t_out, t_in, r.prio);
        put(g, i + d, r.s_up, r.b_lo, t_out, t_in, r.prio);
        if (hot) {
          atomicMax(&g.maps[(size_t)n * g.B1 + t_out], r.prio);
          atomicMax(&g.maps[((size_t)g.N + n) * g.B1 + t_in], r.prio);
        } else {
          b_prio = r.prio;
        }
      }
    } else {  // the partner is off the end: rejected; b_other wraps
      const int qw = q < 0 ? q + P : q - P;
      const int s_q = own_slot(g, k2, n, qw, phase);
      put(g, i, own_slot(g, k2, n, p, phase),
          slot_value(g.a + ((size_t)n * P + qw) * g.R, s_q, g.R), B, B, 0);
    }
  }
  const int top = (int)__reduce_max_sync(0xffffffffu, (unsigned)b_prio);
  if ((threadIdx.x & 31) == 0 && top != 0) {
    atomicMax(&g.maps[(size_t)n * g.B1 + B], top);
    atomicMax(&g.maps[((size_t)g.N + n) * g.B1 + B], top);
  }
}

// phase 2 for partition p of chain n: keep, apply, lcnt' update
__device__ __forceinline__ void finish(const ExchArgs& g, int n, int p) {
  const int P = g.P, R = g.R, B1 = g.B1, B = B1 - 1;
  const size_t NP = (size_t)g.N * P, i = (size_t)n * P + p;
  const int* row = g.a + i * R;
  int* out = g.a_new + i * R;
  // every load before the first store, so that they are in flight together
  const int pr = g.rec[4 * NP + i];
  const int to = g.rec[2 * NP + i], ti = g.rec[3 * NP + i];
  const int so = g.rec[i], bo = g.rec[NP + i];
  int v[KAO_MAX_R];
#pragma unroll
  for (int r = 0; r < KAO_MAX_R; ++r)
    if (r < R) v[r] = row[r];
  const bool keep =
      __int_as_float(pr) > 0.f &&
      (to == B || pr == g.maps[(size_t)n * B1 + to]) &&
      (ti == B || pr == g.maps[((size_t)g.N + n) * B1 + ti]);
#pragma unroll
  for (int r = 0; r < KAO_MAX_R; ++r)
    if (r < R) out[r] = (keep && r == so) ? bo : v[r];
  // exact leader-count delta: the slot-0 diff of the applied row
  if (keep && so == 0 && bo != v[0]) {
    atomicAdd(&g.lcnt_new[(size_t)n * B1 + bo], 1);
    atomicAdd(&g.lcnt_new[(size_t)n * B1 + v[0]], -1);
  }
}

// ---- the draws of one lane's sweep key --------------------------------------

// threefry2x32 of the count pair (x0, x1) under key (k0, k1), as
// prng._threefry2x32; out = the two output words
__host__ __device__ inline void threefry_pair(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1,
                                              uint32_t out[2]) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < 4; ++j) {
      const int r = rot[i % 2][j];
      x0 += x1;
      x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  out[0] = x0;
  out[1] = x1;
}

// jax.random.split(key)[i]
__host__ __device__ inline void split_key(const uint32_t key[2], uint32_t i,
                                          uint32_t out[2]) {
  threefry_pair(key[0], key[1], 0u, i, out);
}

// jax.random.bits(key, (), uint32)
__host__ __device__ inline uint32_t key_word(const uint32_t key[2]) {
  uint32_t o[2];
  threefry_pair(key[0], key[1], 0u, 0u, o);
  return o[0] ^ o[1];
}

// sweep.propose_exchange's draws from the sweep key (k0, k1), as
// exchange_cuda.host_keys makes them: out = (the key of the words, the
// stride d, the phase randint's higher and lower keys), 7 words
__host__ __device__ inline void exchange_draws(uint32_t k0, uint32_t k1,
                                               int P, uint32_t* out) {
  const uint32_t key[2] = {k0, k1};
  uint32_t kd[2], kbits[2], kr[2], kph[2], r1[2], r2[2], hi[2], lo[2];
  split_key(key, 0, kd);
  split_key(key, 1, kbits);
  // _pair_stride: d = randint(split(kd)[0], (), 1, max(P // 2, 2))
  split_key(kd, 0, kr);
  split_key(kd, 1, kph);
  split_key(kr, 0, r1);
  split_key(kr, 1, r2);
  const uint32_t top = (uint32_t)(P / 2 > 2 ? P / 2 : 2);
  const uint32_t span = top <= 1u ? 1u : top - 1u;
  uint32_t mul = (1u << 16) % span;
  mul = (mul * mul) % span;
  const uint32_t off = (key_word(r1) % span) * mul + key_word(r2) % span;
  split_key(kph, 0, hi);
  split_key(kph, 1, lo);
  out[0] = kbits[0];
  out[1] = kbits[1];
  out[2] = 1u + off % span;
  out[3] = hi[0];
  out[4] = hi[1];
  out[5] = lo[0];
  out[6] = lo[1];
}

// lane l's scalars and the draws of its sweep key keys[l]
__device__ __forceinline__ ExchLane lane_draws(const ExchLaunch& G, int l) {
  uint32_t k0, k1, w[7];
  lane_key(G.keys, l, k0, k1);
  exchange_draws(k0, k1, G.P, w);
  const int* lb = KAO_LANE(G.t, leader_band, l);
  return ExchLane{w[0], w[1], w[3], w[4], w[5], w[6], G.temps[l],
                  *KAO_LANE(G.t, lam, l), (int)w[2], lb[0], lb[1]};
}

// the draws of a host key (the card tests hold them to prng's)
extern "C" void kao_exchange_host_keys(uint32_t k0, uint32_t k1, int P,
                                       uint32_t* out) {
  exchange_draws(k0, k1, P, out);
}

__global__ void __launch_bounds__(KAO_THREADS)
    exchange_sweep(const ExchLaunch G) {
  cg::grid_group grid = cg::this_grid();
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const int chains = G.L * G.N;
  const size_t NB1 = (size_t)chains * G.B1;
  const int tiles = chains * G.nblk;

  // ---- phase 0: maps, lcnt', the lanes' draws, the chains' phases -----
  for (size_t j = tid; j < 2 * NB1; j += stride) G.maps[j] = 0;
  for (size_t j = tid; j < NB1; j += stride) G.lcnt_new[j] = G.lcnt[j];
  for (size_t j = tid; j < (size_t)chains; j += stride) {
    const int l = (int)(j / G.N), n = (int)(j % G.N);
    const ExchLane x = lane_draws(G, l);
    if (n == 0) G.lane[l] = x;  // read by every phase behind the barrier
    G.phase[j] = draw_phase(x, n);
  }
  if (KAO_EXCH_PHASES < 1) return;
  grid.sync();

  // ---- phase 1: proposals (B4) and the chains' maps (B5) --------------
  // a tile is one block's KAO_THREADS partitions of one chain, and its
  // loop is uniform over the block, so a warp lies in one chain
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int c = t / G.nblk, n = c % G.N;
    const ExchArgs g = exch_view(G, c / G.N);
    const uint32_t k2 = g.k0 ^ g.k1 ^ 0x1BD11BDAu;
    propose(g, k2, n, (t % g.nblk) * KAO_THREADS + threadIdx.x, g.phase[n]);
  }
  if (KAO_EXCH_PHASES < 2) return;
  grid.sync();

  // ---- phase 2: keep, apply, lcnt' (B6) --------------------------------
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int c = t / G.nblk, n = c % G.N;
    const ExchArgs g = exch_view(G, c / G.N);
    const int p = (t % g.nblk) * KAO_THREADS + threadIdx.x;
    if (p < g.P) finish(g, n, p);
  }
}

// One exchange sweep of L lanes: a cooperative launch of min(L * N *
// ceil(P / KAO_THREADS) tiles, the blocks resident on the card) blocks of
// KAO_THREADS threads, lane l from its tables (tabs), its key keys[l] and
// its temperature temps[l] (device memory), the draws of its key made in
// phase 0. a_new and lcnt_new are fully written; scratch holds the records
// [L, 5, N, P], the maps [L, 2, N, B1], the phases [L, N] and the lanes'
// draws [L, 11], in that order. Returns the CUDA error of the occupancy
// queries or the launch (0 on success).
extern "C" int kao_exchange_sweep(const ModelTabs* tabs,
                                  const long long* keys, const float* temps,
                                  int L, int N, int P, int R, int B1,
                                  const int* a,
                                  const int* lcnt, int* a_new, int* lcnt_new,
                                  int* scratch, cudaStream_t stream) {
  if (L < 1 || L > KAO_MAX_LANES) return (int)cudaErrorInvalidValue;
  const int nblk = (P + KAO_THREADS - 1) / KAO_THREADS;
  ExchLaunch g;
  g.t = *tabs;
  g.keys = keys, g.temps = temps;
  g.a = a, g.lcnt = lcnt, g.a_new = a_new, g.lcnt_new = lcnt_new;
  g.rec = scratch;
  g.maps = g.rec + (size_t)5 * L * N * P;
  g.phase = g.maps + (size_t)2 * L * N * B1;
  g.lane = reinterpret_cast<ExchLane*>(g.phase + (size_t)L * N);
  g.L = L, g.N = N, g.P = P, g.R = R, g.B1 = B1, g.nblk = nblk;
  // the resident grid, once per device
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, exchange_sweep, KAO_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(L * N * nblk, resident[dev]), 1, 1);
  cfg.blockDim = dim3(KAO_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, exchange_sweep, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
