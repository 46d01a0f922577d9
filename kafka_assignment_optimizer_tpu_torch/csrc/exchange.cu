// B4+B5: one pair-exchange proposal per (chain, partition) and the chain's
// thinning maps, in one launch.
//
// Replaces kafka_assignment_optimizer_tpu/ops/propose_pallas.py:424
// (_exchange_kernel, the per-partition half-deltas) and
// kafka_assignment_optimizer_tpu/ops/thin_pallas.py:247 (_exch_maps_kernel,
// the max-priority maps over the leadership tokens). It computes exactly
// what sweep.exchange_propose(m, a, lcnt, key, temp) computes: the records
// s, b_other, tok_out, tok_in and prio [N, P] that B6 (thin.cu) reads, and
// the maps m_out, m_in [N, B+1], bit for bit.
//
// Design, for Hopper:
//
// - The pairing in the launch. The reference keeps the pairing, the
//   partner views and the combination of the halves in XLA because a TPU
//   gather is slow; here a partner's row is one load. The stride d stays a
//   host draw (a shift amount, known before the launch). Each chain's phase
//   is jax.random.randint(kph, (N, 1), 0, 2d): thread 0 of each block hashes
//   the randint's two words at counter n (the wrapper splits kph on the
//   host) and does its uint32 arithmetic. Then partition p is on the lower
//   side iff ((p + phase) / d) is even, and pairs with p + d (lower) or
//   p - d (upper).
// - Random words in registers. Word j of partition q is threefry2x32 of the
//   64-bit counter (n*P + q)*4 + j with the outputs xor-ed, as prng.bits
//   draws bits[N, P, 4]; a pair draws the words of its lower side. The
//   Metropolis word is hashed only where the pair is legal and its delta
//   negative, the priority word only where it is accepted. No bits tensor
//   exists.
// - No barrier. A pair's proposal depends only on its two rows, the carried
//   lcnt and the tables, and the maps are an order-free integer atomicMax
//   of the priority's bit pattern (exact for non-negative floats), so the
//   launch is a plain grid over (partition block, chain) that keeps every
//   SM busy. The keep test (B6) needs the finished maps and stays a second
//   launch.
// - One thread a pair: the lower side's thread evaluates both halves,
//   writes both partitions' records (both sides carry the same tokens and
//   priority) and updates the maps once; the upper side's thread has
//   nothing to do.
// - Token B (no leadership moves: the pair swaps followers, or leaders for
//   leaders) bypasses its map in the keep test, but the reference's maps
//   hold its maximum too; the lanes of a warp reduce it first
//   (__reduce_max_sync), so one atomic a warp reaches the chain's entry B.
//
// What bounds it on Hopper: INT32 operations (the threefry words, about 71
// instructions each) against its bytes (a, the records, the gathered
// weights). A partition whose partner falls off the end (pair_valid false)
// is never accepted, but its records still follow the reference's rolls:
// its b_other is the wrapped partner's slot value, drawn from that
// partner's own pairing.
//
// Arithmetic: built with --fmad=false; __fsub_rn/__fmul_rn/__fdiv_rn and
// expf keep the Metropolis test equal to the plain version on the card.
// An empty (padded) row draws slot -1, whose slot value is 0 (no wrap, as
// the reference's _slot_value).
#include "common.cuh"

// for timing (site_probe.py builds variants): the stages run (1: the
// pairing, the slots and the records of rejected proposals; 2: the whole
// proposal), and cheap stand-ins for the threefry words (wrong results)
#ifndef KAO_EXCH_STAGES
#define KAO_EXCH_STAGES 2
#endif
#ifndef KAO_EXCH_FAKE_WORDS
#define KAO_EXCH_FAKE_WORDS 0
#endif

struct ExchArgs {
  const int* a;             // [N, P, R]
  const int* rf;            // [P]
  const uint8_t* valid;     // [P, R]
  const int* part_rack_hi;  // [P]
  const int* w_lead;        // [P, B1]
  const int* w_foll;        // [P, B1]
  const int* rack_of;       // [B1]
  const int* lcnt;          // [N, B1]
  int* rec;    // [5, N, P]: s, b_other, tok_out, tok_in, prio (float bits)
  int* maps;   // [2, N, B1] zeroed: m_out, m_in (float bits)
  uint32_t k0, k1;          // the key of the bits [N, P, 4]
  uint32_t h0, h1, l0, l1;  // the phase randint's keys: higher, lower word
  float temp, lam;
  int d, llo, lhi;
  int N, P, R, B1;
};

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

__global__ void __launch_bounds__(KAO_THREADS)
    exchange_propose(const ExchArgs g) {
  __shared__ int s_phase;
  const int n = blockIdx.y, P = g.P, d = g.d, B = g.B1 - 1;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t k2 = g.k0 ^ g.k1 ^ 0x1BD11BDAu;
  if (threadIdx.x == 0) {  // randint(kph, (N, 1), 0, 2d)[n], in uint32
    const uint32_t span = 2u * (uint32_t)d;
    uint32_t mul = (1u << 16) % span;
    mul = (mul * mul) % span;
    const uint32_t hi = word(g.h0, g.h1, g.h0 ^ g.h1 ^ 0x1BD11BDAu, n);
    const uint32_t lo = word(g.l0, g.l1, g.l0 ^ g.l1 ^ 0x1BD11BDAu, n);
    s_phase = (int)(((hi % span) * mul + lo % span) % span);
  }
  __syncthreads();
  const int phase = s_phase;

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

// One exchange proposal: grid (ceil(P / 256), N). rec is fully written;
// maps arrive zeroed. Returns the CUDA error of the launch (0 on success).
extern "C" int kao_exchange_propose(
    const int* a, const int* rf, const uint8_t* valid, const int* part_rack_hi,
    const int* w_lead, const int* w_foll, const int* rack_of, const int* lcnt,
    uint32_t k0, uint32_t k1, uint32_t h0, uint32_t h1, uint32_t l0,
    uint32_t l1, float temp, float lam, int d, int llo, int lhi, int N, int P,
    int R, int B1, int* rec, int* maps, cudaStream_t stream) {
  const ExchArgs g{a,    rf,  valid, part_rack_hi, w_lead, w_foll, rack_of,
                   lcnt, rec, maps,  k0,           k1,     h0,     h1,
                   l0,   l1,  temp,  lam,          d,      llo,    lhi,
                   N,    P,   R,     B1};
  dim3 grid((P + KAO_THREADS - 1) / KAO_THREADS, N);
  exchange_propose<<<grid, KAO_THREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}
