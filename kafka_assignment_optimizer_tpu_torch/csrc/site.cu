// B2+B3: one whole site sweep in one launch — proposals, Metropolis
// accept, conflict thinning, apply and the exact carried-histogram update.
//
// Replaces kafka_assignment_optimizer_tpu/ops/propose_pallas.py:66
// (_propose_kernel) and kafka_assignment_optimizer_tpu/ops/thin_pallas.py:59
// (_site_finish_kernel), which the JAX package chains as
// thin_pallas.py:212 site_step_pallas. It computes exactly what
// sweep._site_sweep_delta(m, a, cnt, lcnt, rcnt, key, temp) computes:
// (a_new, cnt', lcnt', rcnt'), bit for bit.
//
// Lanes: one launch runs the sweep of L lanes (the portfolio's configs or
// a batch's instances), grid (C, N, L): each lane against its own tables
// (ModelTabs, lane stride 0 where they are shared), bands and penalty
// scale (tables too), temperature temps[l] and key keys[l]. Every
// per-lane value is read from device memory, none passed by value, so a
// launch captured in a CUDA graph serves every sweep of a fused group and
// every model of a bucket. A lane's outputs are what a launch on that
// lane alone writes.
//
// Design, for Hopper:
//
// - Random words in registers. The reference draws bits[N, P, 8] with
//   jax.random.bits (threefry2x32, partitionable counters). Each thread
//   hashes the seven words its partition reads (word 7 is never read):
//   counter c = (n*P + p)*8 + j in 64 bits, (x0, x1) = (c >> 32, c), key
//   schedule (k0, k1, k0^k1^0x1BD11BDA), 20 rounds with funnel-shift
//   rotations, word = o0 ^ o1. No bits tensor exists.
// - One cluster per chain. The keep test needs every partition's update
//   of the chain's priority maps first: a dependency across the whole
//   chain. Here a chain is one thread-block cluster of C CTAs (grid
//   (C, N, L)), and the dependency is a cluster barrier inside the launch.
//   The chain's maps and histogram counts are spread over the cluster's
//   distributed shared memory: token t lives in CTA t % C at index t / C,
//   so a CTA holds 4 * (4 * ceil((B+1)/C) + ceil((K+1)/C)) bytes.
//     phase 0: zero this CTA's share of the maps m_out/m_in; arrive at
//              the cluster barrier
//     phase 1: B2's arithmetic for the CTA's partitions; copy the row
//              into a_new; write the record (below); wait at the barrier
//              once, after the first proposal (so the proposals hide it);
//              atomicMax of an accepted proposal's priority bit pattern
//              (exact and order-free for non-negative floats) into the
//              owners of its two tokens. Then this CTA's share of the
//              counts starts from the carried cnt/lcnt/rcnt;
//              cluster.sync()
//     phase 2: B3's keep test against the owners' maps; patch a_new;
//              +1/-1 atomics of each kept move into the owners' counts;
//              cluster.sync()
//     phase 3: each CTA writes cnt', lcnt', rcnt' of the tokens it owns.
//   No global atomics, no zero-filled outputs, no separate adds.
// - The records: one int4 a partition (priority bits, outgoing token,
//   incoming token packed with the slot and the move type) in a global
//   scratch [N, P, 4] int32 that the wrapper allocates; the thread that
//   writes a record in phase 1 reads it back in phase 2. b_lead and
//   b_at_s are not kept: a leader swap's tokens are (b_lead, b_at_s) and
//   a replace's outgoing token is b_at_s, so the tokens are all the apply
//   needs. One code path serves every partition count; the only limit is
//   the CTA's share of the maps (above) against 232,448 bytes, which the
//   wrapper checks before the launch: about 116,000 brokers at C = 8, more
//   than the scoring kernel B1 takes.
//
// Arithmetic: built with --fmad=false; __fsub_rn/__fmul_rn/__fdiv_rn and
// expf keep the Metropolis test equal to the plain version on the card.
// An empty (padded) row draws slot -1, which the reference's gather wraps
// to the last slot: the kernel wraps too. A kept move implies rf > 0
// (prio > 0 needs a legal proposal), so the finish needs no rf guard.
//
// Sizes, chosen by site_probe.py's device times at the main path's shape
// (PERF.md, PR 3): C = 8 CTAs of at most 640 threads. Clusters of 16 do
// not all fit on the card at once at one CTA an SM, and at two CTAs an SM
// they run no faster than 8; CTAs of 640 threads (two partitions each,
// up to 102 registers) beat CTAs of 1,024 (64 registers). The build
// knobs below change nothing else; site_probe.py builds variants of them.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// CTAs per chain
#ifndef KAO_SITE_CLUSTER
#define KAO_SITE_CLUSTER 8
#endif
// largest CTA; a smaller partition share launches fewer threads
#ifndef KAO_SITE_THREADS
#define KAO_SITE_THREADS 640
#endif
// for timing only: the phases run (0 the barriers, 1 + proposals and
// maps, 2 + keep and apply, 3 the whole sweep), and cheap stand-ins for
// the threefry words (wrong results)
#ifndef KAO_SITE_PHASES
#define KAO_SITE_PHASES 3
#endif
#ifndef KAO_SITE_FAKE_WORDS
#define KAO_SITE_FAKE_WORDS 0
#endif

#define P_LSWAP 0.15f
#define P_RESTORE 0.5f

constexpr int C = KAO_SITE_CLUSTER;

// what the launch takes: every lane
struct SiteLaunch {
  ModelTabs t;
  const long long* keys;  // [L, 2] each lane's sweep key
  const float* temps;     // [L] each lane's sweep temperature
  const int* a;    // [L, N, P, R]
  const int* cnt;  // [L, N, B1]
  const int* lcnt;
  const int* rcnt;  // [L, N, K1]
  int* a_new;       // [L, N, P, R], every element written
  int* cnt_new;     // [L, N, B1]
  int* lcnt_new;
  int* rcnt_new;    // [L, N, K1]
  int4* rec;        // [L, N, P] scratch
  int N, P, R, B1, K1;
  int Pc;  // partitions per CTA
};

// one lane's view of the launch
struct SiteArgs {
  const int* a;             // [N, P, R]
  const int* a0;            // [P, R]
  const int* rf;            // [P]
  const uint8_t* valid;     // [P, R]
  const int* part_rack_hi;  // [P]
  const int* w_lead;        // [P, B1]
  const int* w_foll;        // [P, B1]
  const int* rack_of;       // [B1]
  const int* rack_lo;       // [K1]
  const int* rack_hi;       // [K1]
  const int* cnt;           // [N, B1]
  const int* lcnt;          // [N, B1]
  const int* rcnt;          // [N, K1]
  int* a_new;               // [N, P, R], every element written
  int* cnt_new;             // [N, B1]
  int* lcnt_new;            // [N, B1]
  int* rcnt_new;            // [N, K1]
  int4* rec;                // [N, P] scratch: prio bits, tok_out, meta, 0
  uint32_t k0, k1;
  float temp, lam;
  int blo, bhi, llo, lhi;
  int N, P, R, B1, K1;
  int Pc;  // partitions per CTA
};

__device__ __forceinline__ SiteArgs site_view(const SiteLaunch& G, int l) {
  uint32_t k0, k1;
  lane_key(G.keys, l, k0, k1);
  const int* bb = KAO_LANE(G.t, broker_band, l);
  const int* lb = KAO_LANE(G.t, leader_band, l);
  const size_t n0 = (size_t)l * G.N;
  const size_t rows = n0 * G.P * G.R;
  return SiteArgs{G.a + rows,
                  KAO_LANE(G.t, a0, l),
                  KAO_LANE(G.t, rf, l),
                  KAO_LANE(G.t, valid, l),
                  KAO_LANE(G.t, part_rack_hi, l),
                  KAO_LANE(G.t, w_lead, l),
                  KAO_LANE(G.t, w_foll, l),
                  KAO_LANE(G.t, rack_of, l),
                  KAO_LANE(G.t, rack_lo, l),
                  KAO_LANE(G.t, rack_hi, l),
                  G.cnt + n0 * G.B1, G.lcnt + n0 * G.B1,
                  G.rcnt + n0 * G.K1, G.a_new + rows,
                  G.cnt_new + n0 * G.B1, G.lcnt_new + n0 * G.B1,
                  G.rcnt_new + n0 * G.K1, G.rec + n0 * G.P,
                  k0, k1, G.temps[l], *KAO_LANE(G.t, lam, l), bb[0], bb[1],
                  lb[0], lb[1],
                  G.N, G.P, G.R, G.B1, G.K1, G.Pc};
}

__global__ void __launch_bounds__(KAO_SITE_THREADS)
    site_sweep(const SiteLaunch G) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const SiteArgs g = site_view(G, blockIdx.z);
  const int n = blockIdx.y;
  const int B1 = g.B1, K1 = g.K1, B = B1 - 1, R = g.R, P = g.P;
  const int Bc = (B1 + C - 1) / C, Kc = (K1 + C - 1) / C;
  // this CTA's share: tokens rank, rank + C, ... at indices 0, 1, ...
  int* m_out = smem;          // [Bc] maxima (float bit patterns)
  int* m_in = m_out + Bc;     // [Bc]
  int* d_cnt = m_in + Bc;     // [Bc] carried counts + kept-move deltas
  int* d_lcnt = d_cnt + Bc;   // [Bc]
  int* d_rcnt = d_lcnt + Bc;  // [Kc]
  const int* cn = g.cnt + (size_t)n * B1;
  const int* lc = g.lcnt + (size_t)n * B1;
  const int* rc = g.rcnt + (size_t)n * K1;
  const uint32_t k2 = g.k0 ^ g.k1 ^ 0x1BD11BDAu;
  const int p_lo = rank * g.Pc;
  const int p_hi = min(P, p_lo + g.Pc);
  // the owner's copy of token t in a map of this layout
  auto at = [&](int* base, int t) {
    return cluster.map_shared_rank(base + t / C, t % C);
  };

  // ---- phase 0: zero this CTA's share of the maps ---------------------
  for (int j = threadIdx.x; j < 2 * Bc; j += blockDim.x) smem[j] = 0;
  cluster_arrive();

  // ---- phase 1: proposals (B2) and the chain's maps ---------------------
  bool waited = false;
  for (int p = p_lo + threadIdx.x; KAO_SITE_PHASES >= 1 && p < p_hi;
       p += blockDim.x) {
    const size_t i = (size_t)n * P + p;
    const int* row = g.a + i * R;
    int* out = g.a_new + i * R;
    const uint8_t* vrow = g.valid + (size_t)p * R;
    const int* wl = g.w_lead + (size_t)p * B1;
    const int* wf = g.w_foll + (size_t)p * B1;
    const int rfp = g.rf[p];
    // loaded before the words, so that the a0 entry the proposal picks
    // (most often in the same sector) is cached by the time it is read
    const int a0_first = g.a0[(size_t)p * R];
    uint32_t bt[7];
#pragma unroll
    for (int j = 0; j < 7; ++j)
      bt[j] = KAO_SITE_FAKE_WORDS
                  ? (uint32_t)(i * 8 + j) * 0x9E3779B9u ^ g.k0
                  : threefry_word(g.k0, g.k1, k2, (uint64_t)i * 8 + j);

    // slot + move type + incoming broker
    const float u_slot = u01(bt[0]);
    const int s_rep = rand_idx(u_slot, rfp);
    const int s_lsw = 1 + rand_idx(u_slot, max(rfp - 1, 1));
    const bool is_lsw = u01(bt[1]) < P_LSWAP && rfp > 1;
    const int s = is_lsw ? s_lsw : s_rep;
    const int b_lead = row[0];
    const int b_at_s = row[s < 0 ? s + R : s];
    const int b_old = is_lsw ? b_lead : b_at_s;
    const int b_foll = b_at_s;
    const int b_uni = rand_idx(u01(bt[2]), B);
    const int s_orig = rand_idx(u01(bt[3]), R);
    const int b_orig = s_orig == 0 ? a0_first : g.a0[(size_t)p * R + s_orig];
    const int b_new = (u01(bt[4]) < P_RESTORE && b_orig < B) ? b_orig : b_uni;

    // the row: copied into a_new; for a replace (whose b_old is b_foll),
    // the replicas on the racks of b_foll and b_new, and whether b_new is
    // in it already
    const bool lead_slot = s == 0;
    const int r_old = g.rack_of[b_foll], r_new = g.rack_of[b_new];
    int c_old = 0, c_new = 0;
    bool in_row = false;
    for (int r = 0; r < R; ++r) {
      const int v = row[r];
      out[r] = v;  // a_new starts as a copy; phase 2 patches kept moves
      const bool ok = vrow[r] != 0;
      const int rk = g.rack_of[ok ? v : B];
      c_old += rk == r_old;
      c_new += rk == r_new;
      in_row |= ok && v == b_new;
    }

    // the deltas of the move, gathered only by the lanes that make it
    // (a legal one: an illegal proposal is rejected whatever its delta)
    int dw = 0, dpen = 0;
    if (is_lsw) {  // leader swap: promote slot s
      const int lc_l = lc[b_lead], lc_f = lc[b_foll];
      dw = wl[b_foll] + wf[b_lead] - wl[b_lead] - wf[b_foll];
      dpen = band_pen(lc_l - 1, g.llo, g.lhi) - band_pen(lc_l, g.llo, g.lhi) +
             band_pen(lc_f + 1, g.llo, g.lhi) - band_pen(lc_f, g.llo, g.lhi);
    } else if (!in_row && rfp > 0) {  // replace: slot s <- b_new
      const int* t = lead_slot ? wl : wf;
      dw = t[b_new] - t[b_foll];
      const int c_o = cn[b_foll], c_n = cn[b_new];
      dpen = band_pen(c_o - 1, g.blo, g.bhi) - band_pen(c_o, g.blo, g.bhi) +
             band_pen(c_n + 1, g.blo, g.bhi) - band_pen(c_n, g.blo, g.bhi);
      if (lead_slot) {
        const int l_o = lc[b_foll], l_n = lc[b_new];
        dpen += band_pen(l_o - 1, g.llo, g.lhi) -
                band_pen(l_o, g.llo, g.lhi) +
                band_pen(l_n + 1, g.llo, g.lhi) - band_pen(l_n, g.llo, g.lhi);
      }
      if (r_old != r_new) {
        const int rc_o = rc[r_old], rc_n = rc[r_new];
        const int lo_o = g.rack_lo[r_old], hi_o = g.rack_hi[r_old];
        const int lo_n = g.rack_lo[r_new], hi_n = g.rack_hi[r_new];
        const int cap = g.part_rack_hi[p];
        dpen += band_pen(rc_o - 1, lo_o, hi_o) - band_pen(rc_o, lo_o, hi_o) +
                band_pen(rc_n + 1, lo_n, hi_n) - band_pen(rc_n, lo_n, hi_n) +
                max(c_old - 1 - cap, 0) - max(c_old - cap, 0) +
                max(c_new + 1 - cap, 0) - max(c_new - cap, 0);
      }
    }
    const bool legal = (is_lsw ? rfp > 1 : !in_row) && rfp > 0;
    const float delta = __fsub_rn((float)dw, __fmul_rn(g.lam, (float)dpen));
    const bool accept = legal && metropolis(delta, u01(bt[5]), g.temp);
    const float prio = accept ? __fadd_rn(u01(bt[6]), 1e-6f) : 0.f;

    const int tok_in = is_lsw ? b_at_s : b_new;
    const int pr = __float_as_int(prio);
    g.rec[i] = make_int4(pr, b_old,
                         (tok_in << 5) | ((s & 15) << 1) | (int)is_lsw, 0);
    if (!waited) {  // every CTA's maps are zeroed
      cluster_wait();
      waited = true;
    }
    if (pr != 0) {
      atomicMax(at(m_out, b_old), pr);
      atomicMax(at(m_in, tok_in), pr);
    }
  }
  if (!waited) cluster_wait();
  // the deltas start from the carried counts of this CTA's tokens (no
  // other CTA touches them before the barrier below)
  for (int j = threadIdx.x; j < Bc; j += blockDim.x) {
    const int t = rank + C * j;
    d_cnt[j] = t < B1 ? cn[t] : 0;
    d_lcnt[j] = t < B1 ? lc[t] : 0;
  }
  for (int j = threadIdx.x; j < Kc; j += blockDim.x) {
    const int k = rank + C * j;
    d_rcnt[j] = k < K1 ? rc[k] : 0;
  }
  cluster.sync();

  // ---- phase 2: keep, apply, histogram deltas (B3) --------------------
  for (int p = p_lo + threadIdx.x; KAO_SITE_PHASES >= 2 && p < p_hi;
       p += blockDim.x) {
    const size_t i = (size_t)n * P + p;
    const int4 r4 = g.rec[i];
    const int pr = r4.x, to = r4.y, meta = r4.z;
    if (pr == 0) continue;
    const int ti = meta >> 5, s = (meta >> 1) & 15;
    const bool is_lsw = meta & 1;
    if (pr != *at(m_out, to) || pr != *at(m_in, ti)) continue;
    int* out = g.a_new + i * R;
    if (is_lsw) {
      out[0] = ti;  // b_at_s leads
      out[s] = to;  // the old leader takes slot s
    } else {
      out[s] = ti;
      atomicAdd(at(d_cnt, to), -1);
      atomicAdd(at(d_cnt, ti), 1);
      const int k_o = g.rack_of[to], k_i = g.rack_of[ti];
      atomicAdd(at(d_rcnt, k_o), -1);
      atomicAdd(at(d_rcnt, k_i), 1);
    }
    if (is_lsw || s == 0) {
      atomicAdd(at(d_lcnt, to), -1);
      atomicAdd(at(d_lcnt, ti), 1);
    }
  }
  cluster.sync();  // every kept move is counted; no remote access follows

  // ---- phase 3: the updated histograms of this CTA's tokens -----------
  for (int j = threadIdx.x; KAO_SITE_PHASES >= 3 && j < Bc; j += blockDim.x) {
    const int t = rank + C * j;
    if (t >= B1) break;
    g.cnt_new[(size_t)n * B1 + t] = d_cnt[j];
    g.lcnt_new[(size_t)n * B1 + t] = d_lcnt[j];
  }
  for (int j = threadIdx.x; KAO_SITE_PHASES >= 3 && j < Kc; j += blockDim.x) {
    const int k = rank + C * j;
    if (k >= K1) break;
    g.rcnt_new[(size_t)n * K1 + k] = d_rcnt[j];
  }
}

// One site sweep of L lanes: grid (C, N, L) in clusters of (C, 1, 1), lane
// l from its tables (tabs), its key keys[l] and its temperature temps[l]
// (device memory). Returns the CUDA error of the attribute calls or the
// launch (0 on success).
extern "C" int kao_site_sweep(const ModelTabs* tabs, const long long* keys,
                              const float* temps, int L, int N, int P,
                              int R, int B1, int K1,
                              const int* a, const int* cnt, const int* lcnt,
                              const int* rcnt, int* a_new, int* cnt_new,
                              int* lcnt_new, int* rcnt_new, int4* rec,
                              cudaStream_t stream) {
  if (L < 1 || L > KAO_MAX_LANES) return (int)cudaErrorInvalidValue;
  SiteLaunch g;
  g.t = *tabs;
  g.keys = keys, g.temps = temps;
  g.a = a, g.cnt = cnt, g.lcnt = lcnt, g.rcnt = rcnt;
  g.a_new = a_new, g.cnt_new = cnt_new, g.lcnt_new = lcnt_new;
  g.rcnt_new = rcnt_new, g.rec = rec;
  g.N = N, g.P = P, g.R = R, g.B1 = B1, g.K1 = K1;
  g.Pc = (P + C - 1) / C;
  const size_t smem = 4 * (size_t)(4 * ((B1 + C - 1) / C) + (K1 + C - 1) / C);
  cudaError_t err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        site_sweep, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        site_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, N, L);
  cfg.blockDim = dim3(min(KAO_SITE_THREADS, (g.Pc + 31) / 32 * 32), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, site_sweep, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
