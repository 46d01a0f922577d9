// B1: exact batched candidate scoring, one cooperative launch.
//
// Replaces kafka_assignment_optimizer_tpu/ops/score_pallas.py:55
// (_score_kernel): for candidates a[N, P, R] the preservation weight, the
// replica/leader/rack band penalties, the per-partition rack-diversity
// overflow, and the histograms cnt/lcnt [N, B+1] and rcnt [N, K+1]. It
// also writes out[n, 5], the chain's replica-move count (valid slots whose
// broker has no leader weight for the partition): the count the
// reference's XLA moves_batch (ops/score.py) computes beside the TPU
// kernel, whose columns 5-7 stay zero. The plain version is
// ops/score_cuda.py:score_plain.
//
// What bounds it on Hopper: bytes. It reads a[N, P, R] once and gathers
// the weights each valid slot needs from the [P, B+1] tables; the work per
// slot is a handful of integer operations. The TPU kernel streamed the
// whole weight tables as one-hot products; here each thread gathers only
// the entries it needs, each in a cache line of its own, and the kernel
// spreads the rows over every SM.
//
// Lanes: one launch scores a[L, N, P, R], the N chains of each of L lanes
// (the portfolio's configs or a batch's instances), every lane against its
// own tables (ModelTabs, lane stride 0 where they are shared) and bands.
// The grid-stride loops below run over all L * N chains; a lane's outputs
// are what a launch on that lane alone writes.
//
// Design, for Hopper: three phases behind two grid-wide barriers
// (cooperative_groups' this_grid().sync(), a cooperative launch), so a call
// is one device activity with no zero-filled outputs.
//   phase 0: zero out, cnt, lcnt and rcnt; grid.sync()
//   phase 1: a tile is KAO_THREADS partitions of one chain, one a thread.
//            The weight, the diversity overflow and the moves add up in
//            registers and reach out[n] with one atomic a block. cnt and
//            lcnt count into the block's shared memory and each nonzero
//            count reaches device memory with one atomic; where the two
//            histograms do not fit in shared memory (about 29,000
//            brokers), every slot adds straight into device memory.
//            Invalid slots are not counted one by one: the slot_valid
//            table is the same for every chain, so each warp adds its
//            count of them to the null buckets cnt[B] and lcnt[B] once.
//            grid.sync()
//   phase 2: a block a chain: rcnt from cnt (a rack's count is its
//            brokers' sum, the null bucket at rack_of[B] included), one
//            atomic a nonzero broker count, then the three band penalties
//            into out[n, 1:4].
// A cooperative grid must be resident as a whole: the launcher launches
// min(tiles, blocks resident) blocks (the occupancy API and the SM count),
// and every phase covers its work with a grid-stride loop.
//
// Measured against it (PERF.md, the kernel table): one thread-block
// cluster a chain with the counts in distributed shared memory (eight
// chains hold only 64 SMs; slower at one chain, at par at eight), and the
// same three phases as two launches beside one zero fill (at par).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// for timing only (site_probe.py builds variants): 0 leaves out phase 1's
// rows (the launch, the barriers and the outputs only; wrong results)
#ifndef KAO_SCORE_ROWS
#define KAO_SCORE_ROWS 1
#endif

// what the launch takes: every lane (each lane's bands in its tables)
struct ScoreLaunch {
  ModelTabs t;
  const int* a;  // [L, N, P, R]
  int L, N, P, R, B1, K1;
  int nblk;   // tiles of KAO_THREADS partitions a chain
  int local;  // count a tile into shared memory first (cnt and lcnt fit)
  int* out;   // [L, N, 8]
  int* cnt;   // [L, N, B1]
  int* lcnt;  // [L, N, B1]
  int* rcnt;  // [L, N, K1]
};

// one lane's view of the launch: its tables, bands and chains
struct ScoreArgs {
  const int* a;             // [N, P, R]
  const uint8_t* valid;     // [P, R]
  const int* w_lead;        // [P, B1]
  const int* w_foll;        // [P, B1]
  const int* rack_of;       // [B1]
  const int* part_rack_hi;  // [P]
  const int* rack_lo;       // [K1]
  const int* rack_hi;       // [K1]
  int blo, bhi, llo, lhi;
  int N, P, R, B1, K1;
  int nblk, local;
  int* out;   // [N, 8]
  int* cnt;   // [N, B1]
  int* lcnt;  // [N, B1]
  int* rcnt;  // [N, K1]
};

__device__ __forceinline__ ScoreArgs score_view(const ScoreLaunch& G, int l) {
  const int* bb = KAO_LANE(G.t, broker_band, l);
  const int* lb = KAO_LANE(G.t, leader_band, l);
  const size_t n0 = (size_t)l * G.N;
  return ScoreArgs{G.a + n0 * G.P * G.R,
                   KAO_LANE(G.t, valid, l),
                   KAO_LANE(G.t, w_lead, l),
                   KAO_LANE(G.t, w_foll, l),
                   KAO_LANE(G.t, rack_of, l),
                   KAO_LANE(G.t, part_rack_hi, l),
                   KAO_LANE(G.t, rack_lo, l),
                   KAO_LANE(G.t, rack_hi, l),
                   bb[0], bb[1], lb[0], lb[1],
                   G.N, G.P, G.R, G.B1, G.K1, G.nblk, G.local,
                   G.out + n0 * 8, G.cnt + n0 * G.B1, G.lcnt + n0 * G.B1,
                   G.rcnt + n0 * G.K1};
}

// RM: the most replica slots a row has (R <= RM), for the row's registers
template <int RM>
__global__ void __launch_bounds__(KAO_THREADS)
    score_grid(const ScoreLaunch G) {
  extern __shared__ int smem[];  // [2 * B1]: a tile's cnt, lcnt (local)
  __shared__ int scratch[32];
  __shared__ int tot[3];  // a tile's weight, overflow, moves
  cg::grid_group grid = cg::this_grid();
  const int B1 = G.B1, K1 = G.K1, B = B1 - 1, R = G.R;
  const int chains = G.L * G.N;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t NB1 = (size_t)chains * B1;

  // ---- phase 0 ----------------------------------------------------------
  for (size_t j = tid; j < (size_t)chains * 8; j += stride) G.out[j] = 0;
  for (size_t j = tid; j < NB1; j += stride) G.cnt[j] = G.lcnt[j] = 0;
  for (size_t j = tid; j < (size_t)chains * K1; j += stride) G.rcnt[j] = 0;
  grid.sync();

  // ---- phase 1: a tile a block; the loop is uniform over the block ------
  const int lane = threadIdx.x & 31;
  for (int t = blockIdx.x; KAO_SCORE_ROWS && t < chains * G.nblk;
       t += gridDim.x) {
    const int c = t / G.nblk;
    const ScoreArgs g = score_view(G, c / G.N);
    const int k_null = g.rack_of[B];
    const int n = c % G.N, p = (t % g.nblk) * KAO_THREADS + threadIdx.x;
    int* cnt_n = g.cnt + (size_t)n * B1;
    int* lcnt_n = g.lcnt + (size_t)n * B1;
    // +v at broker j of cnt (l = 0) or lcnt (l = 1): into shared memory or
    // device memory, each through its own kind of atomic
    auto add = [&](int l, int j, int v) {
      if (g.local)
        atomicAdd(&smem[l * B1 + j], v);
      else
        atomicAdd(&(l ? lcnt_n : cnt_n)[j], v);
    };
    if (threadIdx.x < 3) tot[threadIdx.x] = 0;
    if (g.local)
      for (int j = threadIdx.x; j < 2 * B1; j += blockDim.x) smem[j] = 0;
    __syncthreads();
    const bool live = p < g.P;
    const int* row = g.a + ((size_t)n * g.P + p) * R;
    const uint8_t* vrow = g.valid + (size_t)p * R;
    const int* wl = g.w_lead + (size_t)p * B1;
    const int* wf = g.w_foll + (size_t)p * B1;
    // every load of the row first, so that they are in flight together
    bool v[RM];
    int b[RM], k[RM], wt[RM], wlb[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const bool in = r < R && live;
      const int raw = in ? row[r] : B;
      v[r] = in && vrow[r] != 0;
      b[r] = v[r] ? raw : B;
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      k[r] = v[r] ? g.rack_of[b[r]] : k_null;
      wlb[r] = v[r] ? wl[b[r]] : 1;
      wt[r] = r == 0 ? wlb[r] : (v[r] ? wf[b[r]] : 0);
    }
    const int cap = live ? g.part_rack_hi[p] : 0;
    int w = 0, over = 0, mv = 0, inval = 0, inval_lead = 0;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (v[r]) {
        w += wt[r];
        mv += wlb[r] <= 0;
        // diversity: slot r overflows when its same-rack rank among the
        // earlier slots reaches the partition's cap
        int same = 0;
#pragma unroll
        for (int q = 0; q < r; ++q) same += k[q] == k[r];
        over += same >= cap;
        add(0, b[r], 1);
        if (r == 0) add(1, b[r], 1);
      } else if (r < R && live) {
        ++inval;
        inval_lead += r == 0;
      }
    }
    // the invalid slots into the null buckets, one atomic a warp
    inval = warp_sum(inval);
    inval_lead = warp_sum(inval_lead);
    if (lane == 0) {
      if (inval) add(0, B, inval);
      if (inval_lead) add(1, B, inval_lead);
    }
    // the weight, overflow and moves: a warp's sums into the block's, then
    // one device atomic each
    w = warp_sum(w);
    over = warp_sum(over);
    mv = warp_sum(mv);
    if (lane == 0) {
      if (w) atomicAdd(&tot[0], w);
      if (over) atomicAdd(&tot[1], over);
      if (mv) atomicAdd(&tot[2], mv);
    }
    __syncthreads();  // the block's counts and totals are final
    if (threadIdx.x < 3 && tot[threadIdx.x])
      atomicAdd(&g.out[n * 8 + (threadIdx.x == 0 ? 0 : 3 + threadIdx.x)],
                tot[threadIdx.x]);
    if (g.local) {
      for (int j = threadIdx.x; j < 2 * B1; j += blockDim.x) {
        const int h = smem[j];
        if (h) atomicAdd(j < B1 ? &cnt_n[j] : &lcnt_n[j - B1], h);
      }
    }
    __syncthreads();  // the next tile zeroes smem and tot
  }
  grid.sync();  // the counts are final

  // ---- phase 2: a block a chain ------------------------------------------
  for (int c = blockIdx.x; c < chains; c += gridDim.x) {
    const ScoreArgs g = score_view(G, c / G.N);
    const int n = c % G.N;
    const int* cnt_n = g.cnt + (size_t)n * B1;
    const int* lcnt_n = g.lcnt + (size_t)n * B1;
    int* rcnt_n = g.rcnt + (size_t)n * K1;
    int pb = 0, pl = 0, pr = 0;
    for (int j = threadIdx.x; j < B1; j += blockDim.x) {
      const int v = __ldcg(cnt_n + j);
      if (v) atomicAdd(&rcnt_n[g.rack_of[j]], v);
      if (j < B) {
        pb += band_pen(v, g.blo, g.bhi);
        pl += band_pen(__ldcg(lcnt_n + j), g.llo, g.lhi);
      }
    }
    __syncthreads();  // the block's rack atomics are done
    for (int k = threadIdx.x; k < K1 - 1; k += blockDim.x)
      pr += band_pen(__ldcg(rcnt_n + k), g.rack_lo[k], g.rack_hi[k]);
    pb = block_sum(pb, scratch);
    pl = block_sum(pl, scratch);
    pr = block_sum(pr, scratch);
    if (threadIdx.x == 0) {
      g.out[n * 8 + 1] = pb;
      g.out[n * 8 + 2] = pl;
      g.out[n * 8 + 3] = pr;
    }
  }
}

// out [L, N, 8] = (weight, pen_broker, pen_leader, pen_rack,
// pen_part_rack, moves, 0, 0), cnt/lcnt [L, N, B1], rcnt [L, N, K1]: every
// entry written, lane l from its tables and bands (tabs). A
// cooperative launch of min(L * N * ceil(P / KAO_THREADS) tiles, the
// blocks resident on the card) blocks of KAO_THREADS threads. Returns the
// CUDA error of the attribute and occupancy calls or the launch (0 on
// success).
extern "C" int kao_score(const ModelTabs* tabs, int L, int N, int P, int R,
                         int B1, int K1,
                         const int* a, int* out, int* cnt, int* lcnt,
                         int* rcnt, cudaStream_t stream) {
  if (L < 1 || L > KAO_MAX_LANES) return (int)cudaErrorInvalidValue;
  const int nblk = (P + KAO_THREADS - 1) / KAO_THREADS;
  // cnt and lcnt in shared memory where they fit beside the scratch
  const bool local = 8 * (size_t)B1 + 4 * 35 <= 232448;
  const size_t smem = local ? 8 * (size_t)B1 : 0;
  ScoreLaunch g;
  g.t = *tabs;
  g.a = a;
  g.L = L, g.N = N, g.P = P, g.R = R, g.B1 = B1, g.K1 = K1;
  g.nblk = nblk;
  g.local = local;
  g.out = out, g.cnt = cnt, g.lcnt = lcnt, g.rcnt = rcnt;
  void (*kernel)(const ScoreLaunch) =
      R <= 4 ? score_grid<4> : score_grid<KAO_MAX_R>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, per_sm = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      KAO_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(L * N * nblk, per_sm * sms), 1, 1);
  cfg.blockDim = dim3(KAO_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
