// B6: exchange keep test, apply and leader-histogram delta.
//
// Replaces kafka_assignment_optimizer_tpu/ops/thin_pallas.py:277
// (_exch_finish_kernel): the exchange keep test (token B bypasses its
// map), the apply, and the leader-histogram delta (replica and rack
// totals are exchange-invariant). Its records and maps come from the
// fused exchange proposal (exchange.cu, B4+B5).
//
// What bounds it on Hopper: bytes — each thread reads one record and
// one row and writes one row; the rest is a few integer operations. The
// TPU kernel folded the histogram delta into 128-lane one-hot
// accumulators; here a kept move adds +1/-1 with integer atomics straight
// into [N, B+1] (exact, order-free), and only kept moves touch it. The
// keep test needs the chain's finished maps, a grid-wide dependency on the
// proposal launch, hence a launch of its own.
#include "common.cuh"

__global__ void exch_finish(const int* __restrict__ a,
                            const int* __restrict__ s_own,
                            const int* __restrict__ b_other,
                            const int* __restrict__ tok_out,
                            const int* __restrict__ tok_in,
                            const float* __restrict__ prio,
                            const float* __restrict__ m_out,
                            const float* __restrict__ m_in, int N, int P,
                            int R, int B1, int* __restrict__ a_new,
                            int* __restrict__ d_lcnt) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= P) return;
  const int B = B1 - 1;
  const size_t i = (size_t)n * P + p;
  const int* row = a + i * R;
  int* out = a_new + i * R;
  const float pr = prio[i];
  const int to = tok_out[i], ti = tok_in[i];
  const bool keep = pr > 0.f &&
                    (to == B || pr == m_out[(size_t)n * B1 + to]) &&
                    (ti == B || pr == m_in[(size_t)n * B1 + ti]);
  const int so = s_own[i], bo = b_other[i];
  for (int r = 0; r < R; ++r) out[r] = (keep && r == so) ? bo : row[r];
  // exact leader-count delta: the slot-0 diff of the applied row
  if (out[0] != row[0]) {
    atomicAdd(&d_lcnt[(size_t)n * B1 + out[0]], 1);
    atomicAdd(&d_lcnt[(size_t)n * B1 + row[0]], -1);
  }
}

// a_new is fully written; d_lcnt arrives zeroed
extern "C" int kao_exch_finish(const int* a, const int* s_own,
                               const int* b_other, const int* tok_out,
                               const int* tok_in, const float* prio,
                               const float* m_out, const float* m_in, int N,
                               int P, int R, int B1, int* a_new, int* d_lcnt,
                               cudaStream_t stream) {
  dim3 grid((P + KAO_THREADS - 1) / KAO_THREADS, N);
  exch_finish<<<grid, KAO_THREADS, 0, stream>>>(a, s_own, b_other, tok_out,
                                                 tok_in, prio, m_out, m_in, N,
                                                 P, R, B1, a_new, d_lcnt);
  return (int)cudaGetLastError();
}
