// B4: pair-exchange half-deltas.
//
// Replaces kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424
// (_exchange_kernel): the per-partition half of a pair-exchange delta
// (own slot occupant, weight delta, leader-band delta when exactly one
// side holds the leader slot, rack-diversity delta, legality).
//
// What bounds it on Hopper: bytes and gather latency, not arithmetic.
// Each thread owns one (chain, partition): it reads its row, its pairing
// inputs and a few histogram and weight-table entries (gathers into
// tables small enough to stay in L2), and writes its records. The TPU
// kernel turned every lookup into a one-hot product over all brokers
// because the TPU has no fast vector gather; on Hopper a gather is one
// load, so the O(B) one-hots are gone.
#include "common.cuh"

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
