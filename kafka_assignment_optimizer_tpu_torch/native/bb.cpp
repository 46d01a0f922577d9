// Native exact 0-1 solver for the Kafka partition-reassignment model.
//
// Role: the reference delegates its solve to lp_solve 5.5, an *external*
// native C branch-and-bound MILP solver (the upstream README.md:135-137).
// This file is the bundled equivalent: a specialized
// branch-and-bound over the replica-slot representation (models/instance.py)
// rather than the dense 0-1 variable matrix — the same model the LP emitter
// serializes (README.md:144-185), solved exactly, in-process, with no
// external dependency.
//
// Search design:
//   - one decision level per partition: choose (leader, follower set);
//     followers are enumerated as increasing positions in the partition's
//     weight-sorted broker permutation, so each combination is visited once
//     and in roughly best-first order (fast first incumbent, strong pruning)
//   - hard constraint forward-checking on every placement: per-broker total
//     and leader caps, per-rack caps, per-(partition,rack) diversity caps
//   - lower-bound deficits: unmet broker/rack/leader minimums must fit in
//     the remaining unassigned replica slots, else prune
//   - optimistic bound: suffix sum of per-partition unconstrained maxima
//     (leader best + top rf-1 follower weights), pruned against incumbent
//
// Exposed via a C ABI for ctypes (solvers/native.py). All arrays int32,
// row-major; broker index B is the shared null bucket for unused slots.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;

struct Problem {
  int P, B, K, R;
  const int32_t *rf;            // [P]
  const int32_t *rack_of;       // [B]
  const int32_t *wl;            // [P, B+1] leader-role weight
  const int32_t *wf;            // [P, B+1] follower-role weight
  int broker_lo, broker_hi, leader_lo, leader_hi;
  const int32_t *rack_lo;       // [K]
  const int32_t *rack_hi;       // [K]
  const int32_t *part_rack_hi;  // [P]

  int wcols() const { return B + 1; }
  int32_t wlead(int p, int b) const { return wl[p * wcols() + b]; }
  int32_t wfoll(int p, int b) const { return wf[p * wcols() + b]; }
};

struct Stats {
  int64_t nodes = 0;
  bool timed_out = false;
};

class Solver {
 public:
  Solver(const Problem &pr, double time_limit_s)
      : pr_(pr),
        deadline_(std::chrono::steady_clock::now() +
                  std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                      std::chrono::duration<double>(time_limit_s))) {
    const int P = pr_.P, B = pr_.B, K = pr_.K;
    cnt_.assign(B, 0);
    lcnt_.assign(B, 0);
    rcnt_.assign(K, 0);
    pr_rack_.assign((size_t)P * K, 0);
    cur_.assign((size_t)P * pr_.R, B);
    best_.assign((size_t)P * pr_.R, B);

    // process partitions most-constrained first (highest rf, then highest
    // unconstrained weight) — tightens caps early and finds the incumbent
    // near the root
    order_.resize(P);
    for (int p = 0; p < P; ++p) order_[p] = p;
    std::vector<int64_t> pmax(P);
    for (int p = 0; p < P; ++p) pmax[p] = partition_max(p);
    std::stable_sort(order_.begin(), order_.end(), [&](int a, int b) {
      if (pr_.rf[a] != pr_.rf[b]) return pr_.rf[a] > pr_.rf[b];
      return pmax[a] > pmax[b];
    });

    // suffix of per-partition optimistic maxima over the processing order
    suffix_ub_.assign(P + 1, 0);
    for (int i = P - 1; i >= 0; --i)
      suffix_ub_[i] = suffix_ub_[i + 1] + pmax[order_[i]];

    // remaining replica slots / partitions after level i
    rem_replicas_.assign(P + 1, 0);
    for (int i = P - 1; i >= 0; --i)
      rem_replicas_[i] = rem_replicas_[i + 1] + pr_.rf[order_[i]];

    // per-partition broker permutations sorted by weight descending:
    // one by leader weight (leader choice), one by follower weight
    lead_perm_.resize(P);
    foll_perm_.resize(P);
    for (int p = 0; p < P; ++p) {
      lead_perm_[p].resize(B);
      foll_perm_[p].resize(B);
      for (int b = 0; b < B; ++b) lead_perm_[p][b] = foll_perm_[p][b] = b;
      std::stable_sort(lead_perm_[p].begin(), lead_perm_[p].end(),
                       [&](int a, int b) { return pr_.wlead(p, a) > pr_.wlead(p, b); });
      std::stable_sort(foll_perm_[p].begin(), foll_perm_[p].end(),
                       [&](int a, int b) { return pr_.wfoll(p, a) > pr_.wfoll(p, b); });
    }

    // initial lower-bound deficits: everything unmet
    broker_deficit_ = (int64_t)pr_.broker_lo * B;
    leader_deficit_ = (int64_t)pr_.leader_lo * B;
    rack_deficit_ = 0;
    for (int k = 0; k < K; ++k) rack_deficit_ += pr_.rack_lo[k];
  }

  // Install a known-feasible warm start (verified by the caller) so the
  // optimistic bound prunes from the very first node — without it the
  // search is a pure feasibility CSP until the first leaf, which can
  // thrash exponentially under tight capacity bands.
  void warm_start(const int32_t *seed_a, int64_t seed_w) {
    std::memcpy(best_.data(), seed_a, best_.size() * sizeof(int32_t));
    best_w_ = seed_w;
    have_best_ = true;
  }

  // returns status: 0 optimal, 1 time limit w/ incumbent, 2 none found
  int run(int32_t *out_a, int64_t *out_obj, int64_t *out_nodes) {
    dfs(0, 0);
    *out_nodes = stats_.nodes;
    if (!have_best_) return stats_.timed_out ? 2 : 3;  // 3 = proven infeasible
    std::memcpy(out_a, best_.data(), best_.size() * sizeof(int32_t));
    *out_obj = best_w_;
    return stats_.timed_out ? 1 : 0;
  }

 private:
  int64_t partition_max(int p) const {
    // unconstrained per-partition optimum: best leader choice + top rf-1
    // follower weights among the others (mirrors instance.max_weight)
    const int B = pr_.B, rf = pr_.rf[p];
    int64_t best = 0;
    std::vector<int32_t> wfs;
    for (int lead = -1; lead < B; ++lead) {
      int64_t w = lead < 0 ? 0 : pr_.wlead(p, lead);
      if (lead >= 0 && w == 0) continue;  // unweighted leader == lead=-1 case
      wfs.clear();
      for (int b = 0; b < B; ++b)
        if (b != lead && pr_.wfoll(p, b) > 0) wfs.push_back(pr_.wfoll(p, b));
      std::sort(wfs.begin(), wfs.end(), std::greater<int32_t>());
      for (int i = 0; i < (int)wfs.size() && i < rf - 1; ++i) w += wfs[i];
      best = std::max(best, w);
    }
    return best;
  }

  bool time_up() {
    if ((++stats_.nodes & 0xFFF) == 0 &&
        std::chrono::steady_clock::now() >= deadline_)
      stats_.timed_out = true;
    return stats_.timed_out;
  }

  // --- incremental placement bookkeeping ----------------------------
  // Returns false (and leaves state untouched) if caps forbid it.
  bool place(int p, int b, bool leader) {
    const int k = pr_.rack_of[b];
    if (cnt_[b] >= pr_.broker_hi) return false;
    if (rcnt_[k] >= pr_.rack_hi[k]) return false;
    if (pr_rack_[(size_t)p * pr_.K + k] >= pr_.part_rack_hi[p]) return false;
    if (leader && lcnt_[b] >= pr_.leader_hi) return false;
    if (cnt_[b] < pr_.broker_lo) --broker_deficit_;
    ++cnt_[b];
    if (rcnt_[k] < pr_.rack_lo[k]) --rack_deficit_;
    ++rcnt_[k];
    ++pr_rack_[(size_t)p * pr_.K + k];
    if (leader) {
      if (lcnt_[b] < pr_.leader_lo) --leader_deficit_;
      ++lcnt_[b];
    }
    return true;
  }

  void unplace(int p, int b, bool leader) {
    const int k = pr_.rack_of[b];
    if (leader) {
      --lcnt_[b];
      if (lcnt_[b] < pr_.leader_lo) ++leader_deficit_;
    }
    --pr_rack_[(size_t)p * pr_.K + k];
    --rcnt_[k];
    if (rcnt_[k] < pr_.rack_lo[k]) ++rack_deficit_;
    --cnt_[b];
    if (cnt_[b] < pr_.broker_lo) ++broker_deficit_;
  }

  // deficits must be coverable by what is still to be placed
  bool deficits_ok(int next_level) const {
    const int64_t rem = rem_replicas_[next_level];
    const int64_t rem_parts = pr_.P - next_level;  // leaders still to place
    return broker_deficit_ <= rem && rack_deficit_ <= rem &&
           leader_deficit_ <= rem_parts;
  }

  void dfs(int level, int64_t w) {
    if (stats_.timed_out) return;
    if (level == pr_.P) {
      if (broker_deficit_ == 0 && rack_deficit_ == 0 && leader_deficit_ == 0 &&
          w > best_w_) {
        best_w_ = w;
        best_ = cur_;
        have_best_ = true;
      }
      return;
    }
    if (w + suffix_ub_[level] <= best_w_ && have_best_) return;  // bound
    const int p = order_[level];
    // leader-independent follower optimum: top rf-1 follower weights with
    // no broker excluded — an upper bound for ANY leader choice, so it is
    // monotone over the sorted leader scan and safe to break on
    const int64_t ub_f_all = follower_ub(p, /*bl=*/-1);
    // leader choices in descending leader-weight order
    for (int li = 0; li < pr_.B; ++li) {
      if (time_up()) return;
      const int bl = lead_perm_[p][li];
      const int64_t w_lead = pr_.wlead(p, bl);
      // leaders are sorted: once even the best completion with this (or any
      // later) leader can't beat the incumbent, stop scanning leaders
      if (have_best_ &&
          w + w_lead + ub_f_all + suffix_ub_[level + 1] <= best_w_)
        break;
      // exact bound for THIS leader (bl excluded from the follower pool)
      if (have_best_ &&
          w + w_lead + follower_ub(p, bl) + suffix_ub_[level + 1] <= best_w_)
        continue;
      if (!place(p, bl, /*leader=*/true)) continue;
      cur_[(size_t)p * pr_.R + 0] = bl;
      followers(level, p, /*slot=*/1, /*min_pos=*/0, bl, w + w_lead);
      cur_[(size_t)p * pr_.R + 0] = pr_.B;
      unplace(p, bl, true);
    }
  }

  // optimistic total follower weight for partition p given leader bl
  int64_t follower_ub(int p, int bl) const {
    int64_t ub = 0;
    int taken = 0;
    for (int i = 0; i < pr_.B && taken < pr_.rf[p] - 1; ++i) {
      const int b = foll_perm_[p][i];
      if (b == bl) continue;
      const int32_t wv = pr_.wfoll(p, b);
      if (wv <= 0) break;
      ub += wv;
      ++taken;
    }
    return ub;
  }

  // enumerate follower slots as increasing positions in foll_perm_[p]
  void followers(int level, int p, int slot, int min_pos, int bl, int64_t w) {
    if (stats_.timed_out) return;
    if (slot == pr_.rf[p]) {
      if (deficits_ok(level + 1)) dfs(level + 1, w);
      return;
    }
    const int remaining = pr_.rf[p] - slot;
    // not enough brokers left to fill remaining slots → dead end
    for (int pos = min_pos; pos <= pr_.B - remaining; ++pos) {
      if (time_up()) return;
      const int b = foll_perm_[p][pos];
      if (b == bl) continue;
      const int64_t wv = pr_.wfoll(p, b);
      // descending order ⇒ every later position is worth ≤ wv; bound the
      // whole remaining follower block by remaining * wv
      if (have_best_ &&
          w + (int64_t)remaining * wv + suffix_ub_[level + 1] <= best_w_)
        break;
      if (!place(p, b, /*leader=*/false)) continue;
      cur_[(size_t)p * pr_.R + slot] = b;
      followers(level, p, slot + 1, pos + 1, bl, w + wv);
      cur_[(size_t)p * pr_.R + slot] = pr_.B;
      unplace(p, b, false);
    }
  }

  const Problem &pr_;
  std::chrono::steady_clock::time_point deadline_;
  Stats stats_;
  std::vector<int> order_;
  std::vector<int64_t> suffix_ub_, rem_replicas_;
  std::vector<std::vector<int>> lead_perm_, foll_perm_;
  std::vector<int32_t> cnt_, lcnt_, rcnt_, pr_rack_, cur_, best_;
  int64_t broker_deficit_ = 0, leader_deficit_ = 0, rack_deficit_ = 0;
  int64_t best_w_ = -1;
  bool have_best_ = false;
};

}  // namespace

extern "C" {

// status: 0 = proven optimal, 1 = time limit (incumbent returned),
//         2 = time limit with no incumbent, 3 = proven infeasible
int kao_solve(int P, int B, int K, int R, const int32_t *rf,
              const int32_t *rack_of, const int32_t *w_leader,
              const int32_t *w_follower, int broker_lo, int broker_hi,
              int leader_lo, int leader_hi, const int32_t *rack_lo,
              const int32_t *rack_hi, const int32_t *part_rack_hi,
              const int32_t *seed_a, int64_t seed_w, int has_seed,
              double time_limit_s, int32_t *out_a, int64_t *out_objective,
              int64_t *out_nodes) {
  Problem pr{P,       B,         K,         R,         rf,
             rack_of, w_leader,  w_follower, broker_lo, broker_hi,
             leader_lo, leader_hi, rack_lo,  rack_hi,   part_rack_hi};
  Solver s(pr, time_limit_s);
  if (has_seed) s.warm_start(seed_a, seed_w);
  return s.run(out_a, out_objective, out_nodes);
}

}  // extern "C"
