// B2: single-site proposal evaluation, and B4: pair-exchange half-deltas.
//
// B2 replaces kafka_assignment_optimizer_tpu/ops/propose_pallas.py:66
// (_propose_kernel): one proposal per (chain, partition) from its eight
// random words — a leader swap or a replace, its exact weight and
// penalty deltas against the sweep-start histograms, row legality, the
// Metropolis accept and the thinning priority — plus the per-chain
// max-priority maps over the out/in broker tokens.
//
// B4 replaces kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424
// (_exchange_kernel): the per-partition half of a pair-exchange delta
// (own slot occupant, weight delta, leader-band delta when exactly one
// side holds the leader slot, rack-diversity delta, legality).
//
// What bounds them on Hopper: bytes and gather latency, not arithmetic.
// Each thread owns one (chain, partition): it reads its row, its random
// words and a few histogram and weight-table entries (gathers into
// tables small enough to stay in L2), and writes its records. The TPU
// kernels turned every lookup into a one-hot product over all brokers
// because the TPU has no fast vector gather; on Hopper a gather is one
// load, so the O(B) one-hots are gone. The priority maps of B2 are
// integer atomicMax on the float bit patterns (exact, order-free); the
// keep test that reads them needs every partition's update first, so it
// is a second launch (B3).
#include "common.cuh"

#define P_LSWAP 0.15f
#define P_RESTORE 0.5f

__global__ void propose_site(
    const int* __restrict__ a, const int* __restrict__ a0,
    const int* __restrict__ rf, const uint8_t* __restrict__ valid,
    const int* __restrict__ part_rack_hi, const int* __restrict__ w_lead,
    const int* __restrict__ w_foll, const int* __restrict__ rack_of,
    const int* __restrict__ rack_lo, const int* __restrict__ rack_hi,
    const int64_t* __restrict__ bits, const int* __restrict__ cnt,
    const int* __restrict__ lcnt, const int* __restrict__ rcnt, int blo,
    int bhi, int llo, int lhi, float temp, float lam, int N, int P, int R,
    int B1, int K1, int* __restrict__ o_islsw, int* __restrict__ o_s,
    int* __restrict__ o_bnew, int* __restrict__ o_blead,
    int* __restrict__ o_bats, float* __restrict__ o_prio,
    float* __restrict__ m_out, float* __restrict__ m_in) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= P) return;
  const int B = B1 - 1;
  const size_t i = (size_t)n * P + p;
  const int* row = a + i * R;
  const uint8_t* vrow = valid + (size_t)p * R;
  const int* wl = w_lead + (size_t)p * B1;
  const int* wf = w_foll + (size_t)p * B1;
  const int* cn = cnt + (size_t)n * B1;
  const int* lc = lcnt + (size_t)n * B1;
  const int* rc = rcnt + (size_t)n * K1;
  const int64_t* bt = bits + i * 8;
  const int rfp = rf[p];

  // ---- proposal: slot + move type + incoming broker -----------------
  const float u_slot = u01((uint32_t)bt[0]);
  const int s_rep = rand_idx(u_slot, rfp);
  const int s_lsw = 1 + rand_idx(u_slot, max(rfp - 1, 1));
  const bool is_lsw = u01((uint32_t)bt[1]) < P_LSWAP && rfp > 1;
  const int s = is_lsw ? s_lsw : s_rep;
  const int b_lead = row[0];
  // an empty (padded) row draws s = -1; the reference's gather wraps a
  // negative index to the last slot
  const int b_at_s = row[s < 0 ? s + R : s];
  const int b_old = is_lsw ? b_lead : b_at_s;
  const int b_foll = b_at_s;
  const int b_uni = rand_idx(u01((uint32_t)bt[2]), B);
  const int s_orig = rand_idx(u01((uint32_t)bt[3]), R);
  const int b_orig = a0[(size_t)p * R + s_orig];
  const int b_new =
      (u01((uint32_t)bt[4]) < P_RESTORE && b_orig < B) ? b_orig : b_uni;

  // ---- deltas (replace: slot s <- b_new) ----------------------------
  const bool lead_slot = s == 0;
  const int dw_rep = lead_slot ? wl[b_new] - wl[b_old] : wf[b_new] - wf[b_old];
  const int c_o = cn[b_old], c_n = cn[b_new];
  const int d_cnt = band_pen(c_o - 1, blo, bhi) - band_pen(c_o, blo, bhi) +
                    band_pen(c_n + 1, blo, bhi) - band_pen(c_n, blo, bhi);
  const int l_o = lc[b_old], l_n = lc[b_new];
  const int d_lcnt_rep =
      lead_slot ? band_pen(l_o - 1, llo, lhi) - band_pen(l_o, llo, lhi) +
                      band_pen(l_n + 1, llo, lhi) - band_pen(l_n, llo, lhi)
                : 0;
  const int r_old = rack_of[b_old], r_new = rack_of[b_new];
  const int rc_o = rc[r_old], rc_n = rc[r_new];
  const int d_rcnt =
      band_pen(rc_o - 1, rack_lo[r_old], rack_hi[r_old]) -
      band_pen(rc_o, rack_lo[r_old], rack_hi[r_old]) +
      band_pen(rc_n + 1, rack_lo[r_new], rack_hi[r_new]) -
      band_pen(rc_n, rack_lo[r_new], rack_hi[r_new]);
  int c_old = 0, c_new = 0;
  bool in_row = false;
  for (int r = 0; r < R; ++r) {
    const bool v = vrow[r] != 0;
    const int b = v ? row[r] : B;
    const int rk = rack_of[b];
    c_old += rk == r_old;
    c_new += rk == r_new;
    in_row |= v && b == b_new;
  }
  const int cap = part_rack_hi[p];
  const int d_div = max(c_old - 1 - cap, 0) - max(c_old - cap, 0) +
                    max(c_new + 1 - cap, 0) - max(c_new - cap, 0);
  const int dpen_rep =
      d_cnt + d_lcnt_rep + (r_old != r_new ? d_rcnt + d_div : 0);

  // ---- deltas (leader swap: promote slot s) --------------------------
  const int dw_lsw = wl[b_foll] + wf[b_lead] - wl[b_lead] - wf[b_foll];
  const int lc_l = lc[b_lead], lc_f = lc[b_foll];
  const int dpen_lsw = band_pen(lc_l - 1, llo, lhi) -
                       band_pen(lc_l, llo, lhi) +
                       band_pen(lc_f + 1, llo, lhi) -
                       band_pen(lc_f, llo, lhi);

  const int dw = is_lsw ? dw_lsw : dw_rep;
  const int dpen = is_lsw ? dpen_lsw : dpen_rep;
  const bool legal = (is_lsw ? rfp > 1 : !in_row) && rfp > 0;
  const float delta = __fsub_rn((float)dw, __fmul_rn(lam, (float)dpen));
  const bool accept = legal && metropolis(delta, u01((uint32_t)bt[5]), temp);
  const float prio = accept ? __fadd_rn(u01((uint32_t)bt[6]), 1e-6f) : 0.f;

  o_islsw[i] = is_lsw;
  o_s[i] = s;
  o_bnew[i] = b_new;
  o_blead[i] = b_lead;
  o_bats[i] = b_at_s;
  o_prio[i] = prio;
  if (prio > 0.f) {
    map_max(&m_out[(size_t)n * B1 + b_old], prio);
    map_max(&m_in[(size_t)n * B1 + (is_lsw ? b_at_s : b_new)], prio);
  }
}

extern "C" int kao_propose_site(
    const int* a, const int* a0, const int* rf, const uint8_t* valid,
    const int* part_rack_hi, const int* w_lead, const int* w_foll,
    const int* rack_of, const int* rack_lo, const int* rack_hi,
    const int64_t* bits, const int* cnt, const int* lcnt, const int* rcnt,
    int blo, int bhi, int llo, int lhi, float temp, float lam, int N, int P,
    int R, int B1, int K1, int* o_islsw, int* o_s, int* o_bnew, int* o_blead,
    int* o_bats, float* o_prio, float* m_out, float* m_in,
    cudaStream_t stream) {
  dim3 grid((P + KAO_THREADS - 1) / KAO_THREADS, N);
  propose_site<<<grid, KAO_THREADS, 0, stream>>>(
      a, a0, rf, valid, part_rack_hi, w_lead, w_foll, rack_of, rack_lo,
      rack_hi, bits, cnt, lcnt, rcnt, blo, bhi, llo, lhi, temp, lam, N, P, R,
      B1, K1, o_islsw, o_s, o_bnew, o_blead, o_bats, o_prio, m_out, m_in);
  return (int)cudaGetLastError();
}

__global__ void exchange_halves(
    const int* __restrict__ a, const uint8_t* __restrict__ valid,
    const int* __restrict__ part_rack_hi, const int* __restrict__ w_lead,
    const int* __restrict__ w_foll, const int* __restrict__ rack_of,
    const int* __restrict__ lcnt, const int* __restrict__ s_own,
    const int* __restrict__ lead_other, const int* __restrict__ b_other,
    int llo, int lhi, int N, int P, int R, int B1,
    int* __restrict__ o_bown, int* __restrict__ o_dw,
    int* __restrict__ o_ddiv, int* __restrict__ o_dlcnt,
    int* __restrict__ o_legal) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= P) return;
  const int B = B1 - 1;
  const size_t i = (size_t)n * P + p;
  const int* row = a + i * R;
  const uint8_t* vrow = valid + (size_t)p * R;
  const int* wl = w_lead + (size_t)p * B1;
  const int* wf = w_foll + (size_t)p * B1;
  const int* lc = lcnt + (size_t)n * B1;
  const int so = s_own[i];
  const int bo = b_other[i];

  int b_own = 0;  // a slot index outside [0, R) selects nothing
  for (int r = 0; r < R; ++r)
    if (so == r) b_own = row[r];

  const bool lead_own = so == 0;
  const int dw = lead_own ? wl[bo] - wl[b_own] : wf[bo] - wf[b_own];

  const bool xr = lead_own != (lead_other[i] != 0);
  const int l_out = lead_own ? b_own : bo;
  const int l_in = lead_own ? bo : b_own;
  const int lo_c = lc[l_out], li_c = lc[l_in];
  const int dl = xr ? band_pen(lo_c - 1, llo, lhi) - band_pen(lo_c, llo, lhi) +
                          band_pen(li_c + 1, llo, lhi) -
                          band_pen(li_c, llo, lhi)
                    : 0;

  const int r_out = rack_of[b_own], r_in = rack_of[bo];
  int c_out = 0, c_in = 0;
  bool in_row = false;
  for (int r = 0; r < R; ++r) {
    const bool v = vrow[r] != 0;
    const int b = v ? row[r] : B;
    const int rk = rack_of[b];
    c_out += rk == r_out;
    c_in += rk == r_in;
    in_row |= v && b == bo;
  }
  const int cap = part_rack_hi[p];
  const int ddiv = r_out != r_in
                       ? max(c_out - 1 - cap, 0) - max(c_out - cap, 0) +
                             max(c_in + 1 - cap, 0) - max(c_in - cap, 0)
                       : 0;
  o_bown[i] = b_own;
  o_dw[i] = dw;
  o_ddiv[i] = ddiv;
  o_dlcnt[i] = dl;
  o_legal[i] = !in_row;
}

extern "C" int kao_exchange_halves(
    const int* a, const uint8_t* valid, const int* part_rack_hi,
    const int* w_lead, const int* w_foll, const int* rack_of, const int* lcnt,
    const int* s_own, const int* lead_other, const int* b_other, int llo,
    int lhi, int N, int P, int R, int B1, int* o_bown, int* o_dw,
    int* o_ddiv, int* o_dlcnt, int* o_legal, cudaStream_t stream) {
  dim3 grid((P + KAO_THREADS - 1) / KAO_THREADS, N);
  exchange_halves<<<grid, KAO_THREADS, 0, stream>>>(
      a, valid, part_rack_hi, w_lead, w_foll, rack_of, lcnt, s_own,
      lead_other, b_other, llo, lhi, N, P, R, B1, o_bown, o_dw, o_ddiv,
      o_dlcnt, o_legal);
  return (int)cudaGetLastError();
}
