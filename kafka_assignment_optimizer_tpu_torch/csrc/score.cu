// B1: exact batched candidate scoring.
//
// Replaces kafka_assignment_optimizer_tpu/ops/score_pallas.py:55
// (_score_kernel): for candidates a[N, P, R] the preservation weight, the
// replica/leader/rack band penalties, the per-partition rack-diversity
// overflow, and the histograms cnt/lcnt [N, B+1] and rcnt [N, K+1].
//
// What bounds it on Hopper: bytes. It reads a[N, P, R] once and gathers
// R weights per (chain, partition) from the [P, B+1] tables; the work per
// element is a handful of integer operations. The TPU kernel streamed the
// whole weight tables as one-hot products (about 10 MB each at 256
// brokers x 10k partitions); here each thread gathers only the R entries
// it needs. Histograms accumulate in shared memory with integer atomics
// (exact and order-free) and are added to device memory once per block;
// the band penalties need the finished histograms, so they come from a
// second small launch with one block per chain.
#include "common.cuh"

__global__ void score_rows(const int* __restrict__ a,
                           const uint8_t* __restrict__ valid,
                           const int* __restrict__ w_lead,
                           const int* __restrict__ w_foll,
                           const int* __restrict__ rack_of,
                           const int* __restrict__ part_rack_hi, int P,
                           int R, int B1, int K1, int* __restrict__ out,
                           int* __restrict__ cnt, int* __restrict__ lcnt,
                           int* __restrict__ rcnt) {
  extern __shared__ int smem[];
  int* s_cnt = smem;          // [B1]
  int* s_lcnt = smem + B1;    // [B1]
  int* s_rcnt = smem + 2 * B1;  // [K1]
  __shared__ int scratch[32];
  const int n = blockIdx.y;
  const int B = B1 - 1;
  for (int i = threadIdx.x; i < 2 * B1 + K1; i += blockDim.x) smem[i] = 0;
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int w = 0, over = 0;
  if (p < P) {
    const int* row = a + ((size_t)n * P + p) * R;
    const uint8_t* vrow = valid + (size_t)p * R;
    const int* wl = w_lead + (size_t)p * B1;
    const int* wf = w_foll + (size_t)p * B1;
    const int cap = part_rack_hi[p];
    int rk[KAO_MAX_R];
    for (int r = 0; r < R; ++r) {
      const bool v = vrow[r] != 0;
      const int b = v ? row[r] : B;
      rk[r] = rack_of[b];
      atomicAdd(&s_cnt[b], 1);
      atomicAdd(&s_rcnt[rk[r]], 1);
      if (r == 0) atomicAdd(&s_lcnt[b], 1);
      if (v) {
        w += r == 0 ? wl[row[0]] : wf[row[r]];
        // diversity: slot r overflows when its same-rack rank among the
        // earlier slots reaches the partition's cap
        int rank = 0;
        for (int q = 0; q < r; ++q) rank += rk[q] == rk[r];
        over += rank >= cap;
      }
    }
  }
  w = block_sum(w, scratch);
  over = block_sum(over, scratch);
  if (threadIdx.x == 0) {
    if (w) atomicAdd(&out[n * 8 + 0], w);
    if (over) atomicAdd(&out[n * 8 + 4], over);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B1; i += blockDim.x) {
    if (s_cnt[i]) atomicAdd(&cnt[(size_t)n * B1 + i], s_cnt[i]);
    if (s_lcnt[i]) atomicAdd(&lcnt[(size_t)n * B1 + i], s_lcnt[i]);
  }
  for (int i = threadIdx.x; i < K1; i += blockDim.x)
    if (s_rcnt[i]) atomicAdd(&rcnt[(size_t)n * K1 + i], s_rcnt[i]);
}

__global__ void score_bands(const int* __restrict__ cnt,
                            const int* __restrict__ lcnt,
                            const int* __restrict__ rcnt,
                            const int* __restrict__ rack_lo,
                            const int* __restrict__ rack_hi, int blo,
                            int bhi, int llo, int lhi, int B1, int K1,
                            int* __restrict__ out) {
  __shared__ int scratch[32];
  const int n = blockIdx.x;
  int pb = 0, pl = 0, pr = 0;
  for (int b = threadIdx.x; b < B1 - 1; b += blockDim.x) {
    pb += band_pen(cnt[(size_t)n * B1 + b], blo, bhi);
    pl += band_pen(lcnt[(size_t)n * B1 + b], llo, lhi);
  }
  for (int k = threadIdx.x; k < K1 - 1; k += blockDim.x)
    pr += band_pen(rcnt[(size_t)n * K1 + k], rack_lo[k], rack_hi[k]);
  pb = block_sum(pb, scratch);
  pl = block_sum(pl, scratch);
  pr = block_sum(pr, scratch);
  if (threadIdx.x == 0) {
    out[n * 8 + 1] = pb;
    out[n * 8 + 2] = pl;
    out[n * 8 + 3] = pr;
  }
}

// out [N, 8] = (weight, pen_broker, pen_leader, pen_rack, pen_part_rack,
// 0, 0, 0); out, cnt, lcnt and rcnt arrive zeroed.
extern "C" int kao_score(const int* a, const uint8_t* valid,
                         const int* w_lead, const int* w_foll,
                         const int* rack_of, const int* part_rack_hi,
                         const int* rack_lo, const int* rack_hi, int blo,
                         int bhi, int llo, int lhi, int N, int P, int R,
                         int B1, int K1, int* out, int* cnt, int* lcnt,
                         int* rcnt, cudaStream_t stream) {
  const size_t shmem = (size_t)(2 * B1 + K1) * sizeof(int);
  if (shmem > 48 * 1024) {
    cudaFuncSetAttribute(score_rows,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)shmem);
  }
  dim3 grid((P + KAO_THREADS - 1) / KAO_THREADS, N);
  score_rows<<<grid, KAO_THREADS, shmem, stream>>>(
      a, valid, w_lead, w_foll, rack_of, part_rack_hi, P, R, B1, K1, out,
      cnt, lcnt, rcnt);
  score_bands<<<N, KAO_THREADS, 0, stream>>>(cnt, lcnt, rcnt, rack_lo,
                                             rack_hi, blo, bhi, llo, lhi, B1,
                                             K1, out);
  return (int)cudaGetLastError();
}
