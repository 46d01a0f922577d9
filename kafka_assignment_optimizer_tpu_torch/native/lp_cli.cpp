// lp_solve-compatible command-line solver (bundled work-alike).
//
// Role: the reference's entire solve path is "lp_solve is used behind the
// scene to solve the generated linear equation"
// (the upstream README.md:135-137, 200) — an external C binary reading
// LP-format text and printing the optimal 0/1 assignment. That binary is
// not installable in this environment (no network egress), so this file
// provides a genuine stand-in: it PARSES the same LP-format dialect the
// emitter produces (solvers/lp.py, mirroring README.md:144-185), solves
// the 0-1 integer program exactly with branch-and-bound + activity-bound
// propagation, and prints output in the `lp_solve -S4` layout the adapter
// parses. The subprocess path (emit -> exec -> parse) therefore executes
// for real, end to end, against a binary that is NOT the in-process
// HiGHS/B&B code paths it is used to cross-check.
//
// Supported input subset (everything the reference sample uses):
//   // line comments, /* block comments */
//   max: | min:  objective with integer coefficients;
//   [name:] rows of `c v + c v ...  <= | >= | = | < | >  rhs;`
//   bin | int declarations (all variables are treated as 0/1 regardless);
//   statements may span lines; ';' terminates.
//
// Flags: -S<n> verbosity accepted and ignored (output is always the -S4
// shape), -timeout <sec> caps the search (best-so-far printed, marked
// suboptimal). Last non-flag argument is the model file; '-' reads stdin.
//
// Exit codes follow lp_solve 5.5: 0 optimal, 1 suboptimal (timeout with
// an incumbent), 2 infeasible, 7 timeout before any incumbent,
// 255 parse/usage error.

#include <algorithm>
#include <cctype>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

constexpr int64_t kInf = INT64_C(1) << 60;

struct Term {
  int64_t coef;
  int var;
};

struct Row {
  std::vector<Term> terms;
  int64_t lo = -kInf;  // lo <= sum <= hi
  int64_t hi = kInf;
};

struct Model {
  bool maximize = true;
  std::vector<std::string> names;
  std::vector<int64_t> obj;  // per variable
  std::vector<Row> rows;
};

// ---------------------------------------------------------------- lexer --

struct Lexer {
  std::string text;
  size_t pos = 0;

  void skip_ws() {
    for (;;) {
      while (pos < text.size() && std::isspace((unsigned char)text[pos]))
        ++pos;
      if (pos + 1 < text.size() && text[pos] == '/' && text[pos + 1] == '/') {
        while (pos < text.size() && text[pos] != '\n') ++pos;
        continue;
      }
      if (pos + 1 < text.size() && text[pos] == '/' && text[pos + 1] == '*') {
        pos += 2;
        while (pos + 1 < text.size() &&
               !(text[pos] == '*' && text[pos + 1] == '/'))
          ++pos;
        pos = std::min(pos + 2, text.size());
        continue;
      }
      break;
    }
  }

  bool eof() {
    skip_ws();
    return pos >= text.size();
  }

  char peek() {
    skip_ws();
    return pos < text.size() ? text[pos] : '\0';
  }

  bool eat(char c) {
    skip_ws();
    if (pos < text.size() && text[pos] == c) {
      ++pos;
      return true;
    }
    return false;
  }

  // identifier: letter/_ then alnum/_ (the t{t}b{b}p{p}[_l] names and any
  // other lp-format identifier)
  std::string ident() {
    skip_ws();
    size_t s = pos;
    if (pos < text.size() &&
        (std::isalpha((unsigned char)text[pos]) || text[pos] == '_')) {
      ++pos;
      while (pos < text.size() && (std::isalnum((unsigned char)text[pos]) ||
                                   text[pos] == '_'))
        ++pos;
    }
    return text.substr(s, pos - s);
  }

  bool number(int64_t *out) {
    skip_ws();
    size_t s = pos;
    if (pos < text.size() && (text[pos] == '+' || text[pos] == '-')) ++pos;
    size_t d = pos;
    while (pos < text.size() && std::isdigit((unsigned char)text[pos])) ++pos;
    if (pos == d) {
      pos = s;
      return false;
    }
    // LP format allows decimals; the model family is integral, so reject
    // a fractional part loudly rather than mis-solving
    if (pos < text.size() && text[pos] == '.') {
      std::fprintf(stderr, "lp_cli: non-integer coefficient at offset %zu\n",
                   s);
      std::exit(255);
    }
    *out = std::strtoll(text.c_str() + s, nullptr, 10);
    return true;
  }
};

// --------------------------------------------------------------- parser --

struct Parser {
  Lexer lx;
  Model m;
  std::unordered_map<std::string, int> by_name;

  int var_id(const std::string &name) {
    auto it = by_name.find(name);
    if (it != by_name.end()) return it->second;
    int id = (int)m.names.size();
    by_name.emplace(name, id);
    m.names.push_back(name);
    m.obj.push_back(0);
    return id;
  }

  [[noreturn]] void fail(const std::string &what) {
    std::fprintf(stderr, "lp_cli: parse error: %s (near offset %zu)\n",
                 what.c_str(), lx.pos);
    std::exit(255);
  }

  // `c v + c v - v ...` until an operator/semicolon; returns terms
  std::vector<Term> linear_expr() {
    std::vector<Term> terms;
    int sign = 1;
    for (;;) {
      char c = lx.peek();
      if (c == '+') {
        lx.eat('+');
        sign = 1;
        continue;
      }
      if (c == '-') {
        lx.eat('-');
        sign = -1;
        continue;
      }
      int64_t coef = 1;
      bool had_num = lx.number(&coef);
      std::string v = lx.ident();
      if (v.empty()) {
        if (had_num) fail("coefficient without variable");
        break;
      }
      terms.push_back({sign * coef, var_id(v)});
      sign = 1;
    }
    return terms;
  }

  void parse(const std::string &text) {
    lx.text = text;
    bool saw_objective = false;
    while (!lx.eof()) {
      size_t save = lx.pos;
      std::string head = lx.ident();
      if (!saw_objective &&
          (head == "max" || head == "min" || head == "maximize" ||
           head == "minimize" || head == "maximise" || head == "minimise")) {
        if (!lx.eat(':')) fail("expected ':' after objective keyword");
        m.maximize = (head[0] == 'm' && head[1] == 'a');
        for (const Term &t : linear_expr()) m.obj[t.var] += t.coef;
        if (!lx.eat(';')) fail("expected ';' after objective");
        saw_objective = true;
        continue;
      }
      if (head == "bin" || head == "int" || head == "sec" || head == "sin") {
        // declarations: register names, treat everything as binary
        for (;;) {
          std::string v = lx.ident();
          if (v.empty()) break;
          var_id(v);
          if (!lx.eat(',')) break;
        }
        if (!lx.eat(';')) fail("expected ';' after declaration list");
        continue;
      }
      // optional row label `name:` — `head` may already be the first var
      if (!head.empty() && lx.eat(':')) {
        // it was a label; fall through to parse the row body
      } else {
        lx.pos = save;  // re-parse from the start of the row
      }
      Row row;
      row.terms = linear_expr();
      if (row.terms.empty()) fail("empty constraint row");
      std::string op;
      while (lx.peek() == '<' || lx.peek() == '>' || lx.peek() == '=') {
        op += lx.text[lx.pos];
        ++lx.pos;
      }
      int64_t rhs;
      if (!lx.number(&rhs)) fail("expected integer right-hand side");
      if (op == "<=" || op == "=<" || op == "<")
        row.hi = rhs;
      else if (op == ">=" || op == "=>" || op == ">")
        row.lo = rhs;
      else if (op == "=")
        row.lo = row.hi = rhs;
      else
        fail("unknown comparison operator '" + op + "'");
      if (!lx.eat(';')) fail("expected ';' after constraint");
      m.rows.push_back(std::move(row));
    }
    if (!saw_objective) fail("no objective found");
  }
};

// --------------------------------------------------------------- solver --
//
// Exact DFS branch-and-bound over 0/1 variables with activity-bound
// propagation per row (lo <= activity <= hi). Branch order: descending
// |objective| (the move-minimization weights concentrate on few vars),
// preferred value first (1 for positive weight under max).

struct Solver {
  const Model &m;
  int n;
  std::vector<int8_t> val;      // -1 unfixed, 0/1 fixed
  std::vector<int64_t> act_lo;  // row activity given fixed vars
  std::vector<int64_t> act_hi;
  std::vector<std::vector<std::pair<int, int64_t>>> var_rows;  // var -> (row, coef)
  std::vector<int> order;
  std::vector<int64_t> pos_suffix;  // max extra objective from order[i:]
  // cover bound: every positive-weight var is claimed by its tightest
  // finite-capacity row; a group of claimed vars can add at most the sum
  // of its top-(hi - current ones) weights. For the reassignment family
  // this caps each partition's leader gain at one var (C5 rows, hi=1)
  // and each partition's total gain at RF vars (C4 rows) — orders of
  // magnitude tighter than the plain positive-weight suffix.
  std::vector<int> group_row;                // group -> row
  std::vector<std::vector<int>> group_vars;  // weight-sorted claimed vars
  std::vector<int> ungrouped;                // positive vars in no finite row
  int64_t cur_obj = 0;
  int64_t best_obj = -kInf;
  std::vector<int8_t> best;
  bool have_best = false;
  uint64_t nodes = 0;
  double timeout_s;
  Clock::time_point t0 = Clock::now();
  bool timed_out = false;

  explicit Solver(const Model &model, double timeout)
      : m(model), n((int)model.names.size()), val(n, -1),
        var_rows(n), timeout_s(timeout) {
    act_lo.assign(m.rows.size(), 0);
    act_hi.assign(m.rows.size(), 0);
    for (size_t r = 0; r < m.rows.size(); ++r)
      for (const Term &t : m.rows[r].terms) {
        var_rows[t.var].push_back({(int)r, t.coef});
        if (t.coef > 0)
          act_hi[r] += t.coef;
        else
          act_lo[r] += t.coef;
      }
    // branch order: all weighted vars first (descending |weight|) — the
    // cover bound can then prune the zero-weight tail wholesale. (A
    // complete-one-partition-block-at-a-time order was tried and is far
    // worse: it front-loads unweighted branching before the bound bites.)
    order.resize(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return std::llabs(m.obj[a]) > std::llabs(m.obj[b]);
    });
    pos_suffix.assign(n + 1, 0);
    for (int i = n - 1; i >= 0; --i)
      pos_suffix[i] =
          pos_suffix[i + 1] + std::max<int64_t>(0, signed_obj(order[i]));

    std::unordered_map<int, int> row_to_group;
    for (int v = 0; v < n; ++v) {
      if (signed_obj(v) <= 0) continue;
      int best_r = -1;
      for (auto [r, c] : var_rows[v]) {
        if (c <= 0 || m.rows[r].hi >= kInf) continue;
        if (best_r == -1 || m.rows[r].hi < m.rows[best_r].hi) best_r = r;
      }
      if (best_r == -1) {
        ungrouped.push_back(v);
        continue;
      }
      auto [it, added] =
          row_to_group.emplace(best_r, (int)group_row.size());
      if (added) {
        group_row.push_back(best_r);
        group_vars.emplace_back();
      }
      group_vars[it->second].push_back(v);
    }
    for (auto &g : group_vars)
      std::sort(g.begin(), g.end(), [&](int a, int b) {
        return signed_obj(a) > signed_obj(b);
      });
  }

  // admissible overestimate of the objective still reachable from here
  int64_t bound_extra() const {
    int64_t extra = 0;
    for (size_t gi = 0; gi < group_row.size(); ++gi) {
      int r = group_row[gi];
      // coefficient-1 rows: act_lo is exactly the count of 1-fixed vars
      int64_t cap = m.rows[r].hi - act_lo[r];
      if (cap <= 0) continue;
      int64_t taken = 0;
      for (int v : group_vars[gi]) {
        if (taken >= cap) break;
        if (val[v] == -1) {
          extra += signed_obj(v);
          ++taken;
        }
      }
    }
    for (int v : ungrouped)
      if (val[v] == -1) extra += signed_obj(v);
    return extra;
  }

  // objective in "maximize" orientation
  int64_t signed_obj(int v) const { return m.maximize ? m.obj[v] : -m.obj[v]; }

  bool out_of_time() {
    if (timeout_s <= 0) return false;
    if ((nodes & 1023) == 0) {
      double el = std::chrono::duration<double>(Clock::now() - t0).count();
      if (el > timeout_s) timed_out = true;
    }
    return timed_out;
  }

  struct Trail {
    std::vector<int> fixed;  // vars fixed during this node (for undo)
  };

  // fix var to v, update activities; false on row violation. ALWAYS
  // applies every row update before reporting a violation — undo()
  // reverses all of them, so a partial update would corrupt activities.
  bool assign(int var, int8_t v, Trail &tr, std::vector<int> &dirty) {
    val[var] = v;
    tr.fixed.push_back(var);
    cur_obj += v ? signed_obj(var) : 0;
    bool ok = true;
    for (auto [r, c] : var_rows[var]) {
      // removing the unfixed contribution, adding the fixed one
      if (c > 0) {
        if (v)
          act_lo[r] += c;
        else
          act_hi[r] -= c;
      } else {
        if (v)
          act_hi[r] += c;
        else
          act_lo[r] -= c;
      }
      if (act_lo[r] > m.rows[r].hi || act_hi[r] < m.rows[r].lo) {
        if (ok) fail_row = r;  // first culprit: restart weighting
        ok = false;
      }
      dirty.push_back(r);
    }
    return ok;
  }

  // conflict weighting (dom/wdeg-lite): rows that keep killing dives
  // rise to the front of later restarts' demand order
  int fail_row = -1;
  std::vector<uint64_t> row_weight;

  void bump_fail_row() {
    if (fail_row < 0) return;
    if (row_weight.size() != m.rows.size())
      row_weight.assign(m.rows.size(), 0);
    ++row_weight[fail_row];
    fail_row = -1;
  }

  void undo(Trail &tr) {
    for (auto it = tr.fixed.rbegin(); it != tr.fixed.rend(); ++it) {
      int var = *it;
      int8_t v = val[var];
      cur_obj -= v ? signed_obj(var) : 0;
      for (auto [r, c] : var_rows[var]) {
        if (c > 0) {
          if (v)
            act_lo[r] -= c;
          else
            act_hi[r] += c;
        } else {
          if (v)
            act_hi[r] -= c;
          else
            act_lo[r] += c;
        }
      }
      val[var] = -1;
    }
    tr.fixed.clear();
  }

  // unit-style propagation over a worklist of dirty rows: a row whose
  // slack forces a remaining var to one value fixes it and enqueues that
  // var's rows in turn. Coefficient-1 rows (this model family) are
  // handled exactly; general coefs use the same activity-bound logic.
  // reused across propagate() calls (twice per node on the hot path):
  // generation-stamped dedup instead of an O(rows) memset per call
  std::vector<uint32_t> queued_gen_;
  uint32_t gen_ = 0;
  std::vector<int> dirty_buf_;

  bool propagate(Trail &tr, std::vector<int> &work) {
    if (queued_gen_.size() != m.rows.size())
      queued_gen_.assign(m.rows.size(), 0);
    ++gen_;
    auto queued = [&](int r) { return queued_gen_[r] == gen_; };
    auto mark = [&](int r) { queued_gen_[r] = gen_; };
    for (int r : work) mark(r);
    std::vector<int> &dirty = dirty_buf_;
    while (!work.empty()) {
      int r = work.back();
      work.pop_back();
      queued_gen_[r] = gen_ - 1;  // unmark
      const Row &row = m.rows[r];
      for (const Term &t : row.terms) {
        if (val[t.var] != -1) continue;
        // forcing test: would fixing this var to 1 (resp. 0) make the
        // row's reachable activity interval miss [lo, hi]? (act_lo
        // already counts negative coefs of unfixed vars, act_hi the
        // positive ones)
        int64_t c = t.coef, lo1, hi1, lo0, hi0;
        if (c > 0) {
          lo1 = act_lo[r] + c; hi1 = act_hi[r];
          lo0 = act_lo[r];     hi0 = act_hi[r] - c;
        } else {
          lo1 = act_lo[r];     hi1 = act_hi[r] + c;
          lo0 = act_lo[r] - c; hi0 = act_hi[r];
        }
        int8_t force = -1;
        if (lo1 > row.hi || hi1 < row.lo) force = 0;       // can't be 1
        else if (lo0 > row.hi || hi0 < row.lo) force = 1;  // can't be 0
        if (force != -1) {
          dirty.clear();
          if (!assign(t.var, force, tr, dirty)) return false;
          for (int d : dirty)
            if (!queued(d)) {
              mark(d);
              work.push_back(d);
            }
        }
      }
    }
    return true;
  }

  int next_unfixed(int from) const {
    while (from < n && val[order[from]] != -1) ++from;
    return from;
  }

  // Phase-1 search controls: stop at the first feasible leaf, and cap
  // the node budget so a hopeless dive hands over to the exact phase.
  bool first_feasible_only = false;
  bool phase_aborted = false;
  uint64_t node_cap = 0;
  std::vector<int> feas_rows;  // demand rows (lo > 0), variant order
  uint64_t rng_state = 1;

  uint64_t rnd() {  // splitmix64: deterministic per-variant stream
    uint64_t z = (rng_state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }

  void recompute_suffix() {
    for (int i = n - 1; i >= 0; --i)
      pos_suffix[i] =
          pos_suffix[i + 1] + std::max<int64_t>(0, signed_obj(order[i]));
  }

  // Feasibility-first variable order: complete one demand row (lo > 0
  // — the RF / one-leader equalities of this model family) at a time.
  // Propagation then keeps each dive's backtracking local to a
  // partition block. The objective-major order is the right one for
  // PRUNING but can thrash for hours on tight capacity bands before
  // reaching ANY feasible leaf (fuzz-found: RF=4 clusters with
  // 1-broker racks gave rc=7 at 120 s while the incumbent-seeded
  // search proves optimality in milliseconds).
  //
  // A single row order is not enough on extreme exact-band instances
  // (perfect-packing feasibility problems the generator produces):
  // whichever fixed order is chosen, some instance packs the early
  // rows in a way no completion can finish, and chronological
  // backtracking cannot climb back out within any node budget. run()
  // therefore tries a LADDER of orders until one lands an incumbent:
  //   variant 0: demand rows in file order (fast common case)
  //   variant 1: tightest band first (hi-lo asc; exact rows lead)
  //   variant 2: widest demand first (reverse of 1)
  //   variant 3+: deterministic shuffles (splitmix64-seeded)
  void use_feasibility_order(int variant = 0) {
    std::vector<int> rows_idx;
    for (size_t r = 0; r < m.rows.size(); ++r)
      if (m.rows[r].lo > 0) rows_idx.push_back((int)r);
    if (variant == -1 && !row_weight.empty()) {
      // conflict-weighted: the rows that killed previous dives lead
      std::stable_sort(rows_idx.begin(), rows_idx.end(),
                       [&](int a, int b) {
                         if (row_weight[a] != row_weight[b])
                           return row_weight[a] > row_weight[b];
                         return (m.rows[a].hi - m.rows[a].lo) <
                                (m.rows[b].hi - m.rows[b].lo);
                       });
    } else if (variant == 1 || variant == 2) {
      std::stable_sort(rows_idx.begin(), rows_idx.end(),
                       [&](int a, int b) {
                         int64_t sa = m.rows[a].hi - m.rows[a].lo;
                         int64_t sb = m.rows[b].hi - m.rows[b].lo;
                         if (sa != sb)
                           return variant == 1 ? sa < sb : sa > sb;
                         return a < b;
                       });
    } else if (variant >= 3) {
      // rng_state is seeded per variant by run(): the shuffle stream
      // is deterministic and distinct per restart
      for (size_t i = rows_idx.size(); i > 1; --i)
        std::swap(rows_idx[i - 1], rows_idx[rnd() % i]);
    }
    std::vector<int> neworder;
    neworder.reserve(n);
    std::vector<uint8_t> seen(n, 0);
    for (int r : rows_idx)
      for (const Term &t : m.rows[r].terms)
        if (!seen[t.var]) {
          seen[t.var] = 1;
          neworder.push_back(t.var);
        }
    for (int v = 0; v < n; ++v)
      if (!seen[v]) neworder.push_back(v);
    order = std::move(neworder);
    feas_rows = std::move(rows_idx);
    recompute_suffix();
  }

  // Dynamic least-constraining dive: the fixed-order dives above pack
  // early demand rows greedily and chronological backtracking cannot
  // climb out of a bad early packing — tiny (300-var) exact-band
  // instances timed out down EVERY fixed order (in a fuzz run). This
  // dive instead walks the demand rows and, inside the first
  // unsatisfied one, sets the variable whose tightest remaining
  // capacity row has the MOST slack (least-constraining value,
  // randomized tie-break per variant). Once every demand row is met,
  // remaining variables zero-fill under propagation.
  int pick_feas_var() {
    for (int r : feas_rows) {
      if (act_lo[r] >= m.rows[r].lo) continue;
      int best = -1;
      uint64_t best_key = 0;
      for (const Term &t : m.rows[r].terms) {
        if (t.coef <= 0 || val[t.var] != -1) continue;
        int64_t slack = kInf;
        for (auto [r2, c2] : var_rows[t.var]) {
          if (c2 <= 0 || m.rows[r2].hi >= kInf) continue;
          slack = std::min(slack, m.rows[r2].hi - act_lo[r2]);
        }
        if (slack > (int64_t)1e6) slack = (int64_t)1e6;
        if (slack < 0) slack = 0;
        uint64_t key = ((uint64_t)slack << 4) | (rnd() & 15);
        if (best == -1 || key > best_key) {
          best = t.var;
          best_key = key;
        }
      }
      if (best != -1) return best;
    }
    return -1;  // every demand row satisfied
  }

  int dive_depth = 0;
  // stack guard: one frame per assigned variable, each holding a Trail
  // and a dirty vector — tens of thousands of frames approach the
  // default 8 MB stack. Abort the phase (the exact dfs takes over)
  // instead of letting a huge aggregated instance kill the process.
  static constexpr int kMaxDiveDepth = 20000;

  void dive() {
    if (out_of_time() || have_best) return;
    if (node_cap && nodes >= node_cap) {
      phase_aborted = true;
      return;
    }
    if (dive_depth >= kMaxDiveDepth) {
      phase_aborted = true;
      return;
    }
    ++nodes;
    int var = pick_feas_var();
    if (var == -1) {
      // demands met: zero-fill the rest (propagation may force 1s
      // for remaining lower bands; any violation unwinds the fill)
      Trail tr;
      bool ok = true;
      for (int v = 0; v < n && ok; ++v) {
        if (val[v] != -1) continue;
        std::vector<int> dirty;
        ok = assign(v, 0, tr, dirty) && propagate(tr, dirty);
      }
      if (ok)
        record_if_better();
      else
        bump_fail_row();
      undo(tr);
      return;
    }
    for (int8_t v : {(int8_t)1, (int8_t)0}) {
      Trail tr;
      std::vector<int> dirty;
      if (assign(var, v, tr, dirty) && propagate(tr, dirty)) {
        ++dive_depth;
        dive();
        --dive_depth;
      } else {
        bump_fail_row();
      }
      undo(tr);
      if (timed_out || phase_aborted || have_best) return;
    }
  }

  void record_if_better() {
    if (cur_obj > best_obj) {
      best_obj = cur_obj;
      best.assign(val.begin(), val.end());
      have_best = true;
    }
  }

  void dfs(int depth) {
    if (out_of_time()) return;
    if (first_feasible_only && have_best) return;
    if (node_cap && nodes >= node_cap) {
      phase_aborted = true;
      return;
    }
    ++nodes;
    // bound: cheap suffix first, then the row-capacity cover bound
    if (have_best && cur_obj + pos_suffix[depth] <= best_obj) return;
    if (have_best && cur_obj + bound_extra() <= best_obj) return;
    int i = next_unfixed(depth);
    if (i >= n) {
      record_if_better();
      return;
    }
    int var = order[i];
    // prefer keeping weighted (currently-assigned) vars and LEAVING OUT
    // unweighted ones — flooding zero-weight vars with 1s only violates
    // capacity bands and thrashes the feasibility search. In the
    // feasibility phase the preference is demand-driven instead: a var
    // that can still lift an unsatisfied >=-row (a leader/replica
    // lower band) goes in — without this, lower-band violations
    // surface only at the bottom of the dive, where chronological
    // backtracking cannot escape them (fuzz-found: exact rack bands +
    // per-broker leader floors).
    int8_t pref = signed_obj(var) > 0 ? 1 : 0;
    if (first_feasible_only && pref == 0) {
      for (auto [r, c] : var_rows[var])
        if (c > 0 && act_lo[r] < m.rows[r].lo) {
          pref = 1;
          break;
        }
    }
    for (int8_t v : {pref, (int8_t)(1 - pref)}) {
      Trail tr;
      std::vector<int> dirty;
      if (assign(var, v, tr, dirty) && propagate(tr, dirty)) dfs(i + 1);
      undo(tr);
      if (timed_out || phase_aborted ||
          (first_feasible_only && have_best))
        return;
    }
  }

  // returns lp_solve-style exit code
  int run() {
    Trail root;
    std::vector<int> all(m.rows.size());
    for (size_t r = 0; r < m.rows.size(); ++r) all[r] = (int)r;
    if (!propagate(root, all)) return 2;  // infeasible at the root
    // phase 1: feasibility dives to seed an incumbent (node-capped;
    // root-propagation fixes persist, each dive's trail unwinds
    // fully). A ladder of row orders runs until one lands a feasible
    // leaf — a single fixed order leaves rc=7 holes on exact-band
    // perfect-packing instances (see use_feasibility_order). Phase 2
    // re-proves/improves the incumbent exactly, so a failed dive
    // costs nothing but its node budget.
    const std::vector<int> obj_order = order;
    first_feasible_only = true;
    for (int variant = 0; variant < 24 && !have_best && !out_of_time();
         ++variant) {
      phase_aborted = false;
      rng_state = 0x9E3779B97F4A7C15ull * (uint64_t)(variant + 1);
      if (variant < 2) {
        // fixed-order dives: instant on the common case
        use_feasibility_order(variant);
        node_cap = nodes + (variant == 0 ? 1000000 : 200000);
        dfs(0);
      } else {
        // dynamic least-constraining dives over varied row orders —
        // tightest-band-first (exact rack totals lead), widest,
        // shuffles, alternating with conflict-weighted restarts
        // (rows that killed earlier dives lead); small caps with many
        // restarts beat one deep dive on perfect-packing instances
        use_feasibility_order(
            variant >= 4 && variant % 2 == 0 ? -1 : variant - 1
        );
        node_cap = nodes + 200000;
        dive();
      }
    }
    first_feasible_only = false;
    phase_aborted = false;
    node_cap = 0;
    order = obj_order;
    recompute_suffix();
    // phase 2: exact objective-major branch-and-bound
    if (!timed_out) dfs(0);
    if (!have_best) return timed_out ? 7 : 2;  // 7: no incumbent in time
    return timed_out ? 1 : 0;
  }
};

}  // namespace

int main(int argc, char **argv) {
  std::string path;
  double timeout = 0;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "-timeout" && i + 1 < argc) {
      timeout = std::atof(argv[++i]);
    } else if (!a.empty() && a[0] == '-' && a != "-") {
      // -S4 etc: verbosity flags accepted and ignored
    } else {
      path = a;
    }
  }
  if (path.empty()) {
    std::fprintf(stderr, "usage: lp_cli [-S4] [-timeout sec] model.lp\n");
    return 255;
  }
  std::string text;
  if (path == "-") {
    std::ostringstream ss;
    ss << std::cin.rdbuf();
    text = ss.str();
  } else {
    std::ifstream f(path);
    if (!f) {
      std::fprintf(stderr, "lp_cli: cannot open %s\n", path.c_str());
      return 255;
    }
    std::ostringstream ss;
    ss << f.rdbuf();
    text = ss.str();
  }

  Parser parser;
  parser.parse(text);
  Solver solver(parser.m, timeout);
  int rc = solver.run();
  if (rc == 2) {
    std::printf("\nThis problem is infeasible\n");
    return 2;
  }
  if (rc == 7) {
    std::printf("\nTimeout before any integer solution was found\n");
    return 7;
  }
  // lp_solve -S4 output layout (the adapter's parser reads the
  // name/value pairs; the objective line matches lp_solve's phrasing)
  int64_t printed_obj =
      parser.m.maximize ? solver.best_obj : -solver.best_obj;
  std::printf("\nValue of objective function: %lld\n\n",
              (long long)printed_obj);
  std::printf("Actual values of the variables:\n");
  for (int v = 0; v < (int)parser.m.names.size(); ++v)
    std::printf("%-24s%15d\n", parser.m.names[v].c_str(),
                (int)solver.best[v]);
  return rc;
}
