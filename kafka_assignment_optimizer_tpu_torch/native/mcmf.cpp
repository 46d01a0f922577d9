// Min-cost max-flow (primal-dual / successive shortest paths with
// Johnson potentials) with a plain C ABI for ctypes binding.
//
// Native runtime component of this package (the reference's only native
// piece is the external lp_solve C solver it shells out to,
// the upstream README.md:135-137). Used by the plan constructor
// (solvers/lp_round.py) for LEADER-AWARE completion: placing new
// replicas is a transportation problem, and partitions left without a
// kept leader must receive one of their new replicas on a broker with
// leadership headroom — encoded as negative-cost arcs, so the min-cost
// max-flow simultaneously (a) places every vacancy and (b) maximizes
// the number of lead-capable placements. Two sequential max-flows
// cannot do this: the first stage's blind choices strand the second
// (observed: 3 of 197 vacancies unplaceable on the 50k-partition jumbo
// instance).
//
// Algorithm: ONE initial SPFA pass absorbs the negative input costs
// into node potentials (and carries the defensive negative-cycle
// guard); every subsequent augmentation runs Dijkstra on the reduced
// costs (cost + pi[u] - pi[v] >= 0, the standard primal-dual
// invariant — reverse arcs created by an augmentation have reduced
// cost exactly 0, and nodes unreachable from s stay unreachable, so
// their stale potentials are never read from a settled node).
// SPFA-per-augmentation was the previous implementation; with ~300
// negative-cost augmentations over ~1.7e5 arcs its requeue-heavy
// passes cost 2.6 s of the 50k-partition jumbo's constructor wall
// — the heap-based reruns settle each node once.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

namespace {

struct Arc {
    int32_t to;      // head node
    int32_t next;    // next arc out of the same tail (linked list)
    int32_t cap;     // residual capacity
    int32_t cost;    // per-unit cost
};

struct Graph {
    std::vector<Arc> arcs;        // paired: arc i ^ 1 is the reverse
    std::vector<int32_t> head;    // head[v] = first arc index of v, -1 end

    explicit Graph(int n) : head(n, -1) {}

    void add(int32_t u, int32_t v, int32_t cap, int32_t cost) {
        arcs.push_back({v, head[u], cap, cost});
        head[u] = static_cast<int32_t>(arcs.size()) - 1;
        arcs.push_back({u, head[v], 0, -cost});
        head[v] = static_cast<int32_t>(arcs.size()) - 1;
    }
};

}  // namespace

extern "C" {

// Computes min-cost max-flow from s to t.
//
//   n_nodes, n_arcs: graph size; arcs given as parallel arrays
//   src/dst/cap/cost (int32). s, t: terminal node ids.
//   out_arc_flow[i]: flow pushed on input arc i (int32).
//   out_flow/out_cost: totals (int64).
//
// Returns 0 on success, -1 on invalid input, -2 when a negative-cost
// cycle is reachable in the residual graph (successive shortest paths
// is undefined there; the caller's networks are DAG-layered so this is
// purely a defensive guard — without it SPFA never settles and the
// queue grows until the process aborts).
int kao_mcmf(int32_t n_nodes, int32_t n_arcs,
             const int32_t* src, const int32_t* dst,
             const int32_t* cap, const int32_t* cost,
             int32_t s, int32_t t,
             int32_t* out_arc_flow,
             int64_t* out_flow, int64_t* out_cost) {
    if (n_nodes <= 0 || n_arcs < 0 || s < 0 || s >= n_nodes || t < 0 ||
        t >= n_nodes || s == t) {
        return -1;
    }
    Graph g(n_nodes);
    g.arcs.reserve(static_cast<size_t>(n_arcs) * 2);
    for (int32_t i = 0; i < n_arcs; ++i) {
        if (src[i] < 0 || src[i] >= n_nodes || dst[i] < 0 ||
            dst[i] >= n_nodes || cap[i] < 0) {
            return -1;
        }
        g.add(src[i], dst[i], cap[i], cost[i]);
    }

    const int64_t INF = INT64_C(0x3fffffffffffffff);
    std::vector<int64_t> dist(n_nodes);
    std::vector<int64_t> pi(n_nodes, 0);  // Johnson potentials
    // initial SPFA: absorbs the negative input costs into pi and keeps
    // the defensive negative-cycle guard (the caller's networks are
    // DAG-layered, so the guard should never fire)
    {
        std::vector<uint8_t> in_queue(n_nodes, 0);
        std::vector<int32_t> enq(n_nodes, 0);
        std::vector<int32_t> queue;
        queue.reserve(n_nodes);
        std::fill(dist.begin(), dist.end(), INF);
        dist[s] = 0;
        queue.push_back(s);
        in_queue[s] = 1;
        for (size_t qi = 0; qi < queue.size(); ++qi) {
            int32_t u = queue[qi];
            in_queue[u] = 0;
            for (int32_t e = g.head[u]; e != -1; e = g.arcs[e].next) {
                const Arc& a = g.arcs[e];
                if (a.cap <= 0) continue;
                int64_t nd = dist[u] + a.cost;
                if (nd < dist[a.to]) {
                    dist[a.to] = nd;
                    if (!in_queue[a.to]) {
                        // a node settling > n_nodes times means a
                        // negative cycle is relaxing forever
                        if (++enq[a.to] > n_nodes) return -2;
                        queue.push_back(a.to);
                        in_queue[a.to] = 1;
                    }
                }
            }
        }
        for (int32_t v = 0; v < n_nodes; ++v) {
            if (dist[v] < INF) pi[v] = dist[v];
        }
    }

    using HeapItem = std::pair<int64_t, int32_t>;  // (dist, node)
    std::priority_queue<HeapItem, std::vector<HeapItem>,
                        std::greater<HeapItem>> heap;
    std::vector<uint8_t> reached(n_nodes);
    std::vector<uint8_t> dead(n_nodes);     // DFS-retreated this round
    std::vector<uint8_t> onpath(n_nodes);   // on the current DFS stack
    std::vector<int32_t> cur(n_nodes);      // current-arc pointers
    std::vector<int32_t> path_arc;          // DFS stack (arc into node)
    path_arc.reserve(n_nodes);

    int64_t total_flow = 0, total_cost = 0;
    for (;;) {
        // full Dijkstra on reduced costs (lazy-deletion heap): settle
        // every reachable node — the whole zero-reduced-cost DAG is
        // needed below, so there is no early exit at t
        std::fill(dist.begin(), dist.end(), INF);
        std::fill(reached.begin(), reached.end(), 0);
        dist[s] = 0;
        heap = {};
        heap.push({0, s});
        while (!heap.empty()) {
            auto [du, u] = heap.top();
            heap.pop();
            if (reached[u]) continue;
            reached[u] = 1;
            for (int32_t e = g.head[u]; e != -1; e = g.arcs[e].next) {
                const Arc& a = g.arcs[e];
                if (a.cap <= 0 || reached[a.to]) continue;
                int64_t nd = du + a.cost + pi[u] - pi[a.to];
                if (nd < dist[a.to]) {
                    dist[a.to] = nd;
                    heap.push({nd, a.to});
                }
            }
        }
        if (!reached[t]) break;  // no augmenting path left
        // fold the distances into the potentials; unreachable nodes
        // keep their stale pi (they stay unreachable in later rounds —
        // augmentations never add residual capacity out of the
        // reachable set — so no settled node ever reads them)
        for (int32_t v = 0; v < n_nodes; ++v) {
            if (reached[v]) pi[v] += dist[v];
        }
        // blocking flow over the admissible arcs (cap > 0 and reduced
        // cost 0 under the updated pi): every augmenting path through
        // them costs exactly pi[t] - pi[s] = pi[t], so the costs of
        // {0, -1, -1000} collapse the run into a handful of Dijkstra
        // rounds — one per DISTINCT path cost — instead of one per
        // augmentation (measured: 2.6 s -> the SPFA floor of ~0.2 s
        // on the 50k-partition jumbo completion). DFS with current-arc
        // pointers; a zero-cost cycle cannot trap it because retreat
        // marks the node dead for the rest of the round.
        const int64_t round_cost = pi[t];
        std::copy(g.head.begin(), g.head.end(), cur.begin());
        std::fill(dead.begin(), dead.end(), 0);
        std::fill(onpath.begin(), onpath.end(), 0);
        for (;;) {
            // one DFS descent from s with persistent arc pointers; the
            // onpath guard keeps zero-cost cycles (admissible reverse
            // arcs) from revisiting the stack
            path_arc.clear();
            int32_t v = s;
            onpath[s] = 1;
            bool found = false;
            for (;;) {
                if (v == t) {
                    found = true;
                    break;
                }
                int32_t e = cur[v];
                for (; e != -1; e = g.arcs[e].next) {
                    const Arc& a = g.arcs[e];
                    if (a.cap <= 0 || dead[a.to] || onpath[a.to] ||
                        !reached[a.to]) {
                        continue;
                    }
                    if (a.cost + pi[v] - pi[a.to] != 0) continue;
                    break;
                }
                cur[v] = e;
                if (e == -1) {
                    // no admissible way forward: retreat
                    onpath[v] = 0;
                    if (v == s) break;  // blocking flow complete
                    dead[v] = 1;
                    v = g.arcs[path_arc.back() ^ 1].to;
                    path_arc.pop_back();
                } else {
                    path_arc.push_back(e);
                    v = g.arcs[e].to;
                    onpath[v] = 1;
                }
            }
            if (!found) break;
            int32_t push = INT32_MAX;
            for (int32_t e : path_arc) {
                push = std::min(push, g.arcs[e].cap);
            }
            for (int32_t e : path_arc) {
                g.arcs[e].cap -= push;
                g.arcs[e ^ 1].cap += push;
            }
            total_flow += push;
            total_cost += static_cast<int64_t>(push) * round_cost;
            // next descent restarts from s with the SAME cur pointers:
            // exhausted arcs stay skipped, saturated arcs fail the cap
            // check and advance their tail's pointer. Clear the path
            // markers (the onpath guard is per-descent).
            onpath[s] = 0;
            for (int32_t e : path_arc) onpath[g.arcs[e].to] = 0;
        }
    }

    for (int32_t i = 0; i < n_arcs; ++i) {
        // forward arc 2i: flow = reverse residual
        out_arc_flow[i] = g.arcs[2 * i + 1].cap;
    }
    *out_flow = total_flow;
    *out_cost = total_cost;
    return 0;
}

}  // extern "C"
