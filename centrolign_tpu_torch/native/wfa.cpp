// Native WFA-style graph-graph aligners — behavioral twins of the reference's
// wfa_po_poa / pwfa_po_poa (reference alignment.hpp:1714-2035, 2300-2339) and
// deletion_wfa_po_poa (alignment.hpp:2037-2283): Dijkstra-like bucket queues
// over (node1, node2, component) states with greedy match extension. The
// queue discipline (FIFO within a score bucket, exact enqueue order) encodes
// the reference's tie-breaking and is replicated operation-for-operation.

#include <cstdint>
#include <cstring>
#include <vector>
#include <deque>
#include <unordered_map>
#include <unordered_set>
#include <algorithm>
#include <limits>

namespace {

using i64 = int64_t;
using u64 = uint64_t;

struct Graph {
    i64 V;
    const uint8_t* labels;
    const i64* nptr;
    const i64* nind;
    const i64* pptr;
    const i64* pind;
    std::vector<i64> next_of(i64 v) const {
        return std::vector<i64>(nind + nptr[v], nind + nptr[v + 1]);
    }
};

struct WfaParams {
    i64 mismatch;
    std::vector<i64> go, ge;
    i64 factor;
    i64 match_orig;
};

static i64 gcd_u(i64 a, i64 b) {
    while (b) { i64 t = a % b; a = b; b = t; }
    return a;
}

static WfaParams to_wfa_params(i64 match, i64 mismatch, int npw,
                               const i64* go, const i64* ge) {
    WfaParams w;
    w.match_orig = match;
    w.mismatch = 2 * (match + mismatch);
    i64 factor = w.mismatch;
    w.go.resize(npw);
    w.ge.resize(npw);
    for (int i = 0; i < npw; ++i) {
        w.go[i] = 2 * go[i];
        w.ge[i] = 2 * ge[i] + match;
        factor = gcd_u(std::max(factor, w.go[i]), std::min(factor, w.go[i]));
        factor = gcd_u(std::max(factor, w.ge[i]), std::min(factor, w.ge[i]));
    }
    w.factor = factor;
    if (factor != 1) {
        w.mismatch /= factor;
        for (int i = 0; i < npw; ++i) { w.go[i] /= factor; w.ge[i] /= factor; }
    }
    return w;
}

// (node1, node2, comp) key; comp in [-npw, npw]
struct Key {
    i64 n1, n2;
    int comp;
    bool operator==(const Key& o) const {
        return n1 == o.n1 && n2 == o.n2 && comp == o.comp;
    }
};
struct KeyHash {
    size_t operator()(const Key& k) const {
        u64 h = (u64)k.n1 * 0x9e3779b97f4a7c15ULL
              ^ ((u64)k.n2 * 0xc2b2ae3d27d4eb4fULL)
              ^ ((u64)(k.comp + 8) << 56);
        return (size_t)h;
    }
};

struct BackMap {
    std::unordered_map<Key, Key, KeyHash> m;
    bool count(const Key& k) const { return m.count(k) != 0; }
    Key& operator[](const Key& k) { return m[k]; }
    Key at(const Key& k) const { return m.at(k); }
};

struct QItem {
    i64 f1, f2;
    int fc;
    i64 t1, t2;
    int tc;
};

struct BucketQueue {
    std::deque<std::deque<QItem>> buckets;
    i64 min_score = 0;
    void enqueue(i64 penalty, const QItem& it) {
        while ((i64)buckets.size() <= penalty) buckets.emplace_back();
        buckets[penalty].push_back(it);
    }
};

// one WFA iteration (reference wfa_iteration, alignment.hpp:1714-1877).
// Returns true + (end1, end2) when the stop condition fires.
template <bool Forward, class PruneF, class UpdateF, class NextF1,
          class NextF2, class StopF, class GreedyF>
static bool wfa_iteration(BucketQueue& q, BackMap& backpointer,
                          const Graph& g1, const Graph& g2,
                          const WfaParams& wp, int npw,
                          const PruneF& prune, const UpdateF& update,
                          const NextF1& next1, const NextF2& next2,
                          const StopF& stop, const GreedyF& greedy,
                          i64* end1, i64* end2) {
    while (q.buckets.front().empty()) {
        q.buckets.pop_front();
        ++q.min_score;
    }
    QItem it = q.buckets.front().front();
    q.buckets.front().pop_front();

    Key key{it.t1, it.t2, it.tc};
    if (prune(key, q.min_score) || backpointer.count(key)) return false;
    update(key, q.min_score);
    backpointer[key] = Key{it.f1, it.f2, it.fc};
    if (stop(it.t1, it.t2, it.tc)) { *end1 = it.t1; *end2 = it.t2; return true; }

    auto enq = [&](i64 t1, i64 t2, int tc, i64 penalty) {
        q.enqueue(penalty, QItem{it.t1, it.t2, it.tc, t1, t2, tc});
    };

    if (Forward) {
        if (it.tc == 0) {
            if (greedy(it.t1, it.t2)) {
                enq(next1(it.t1).front(), next2(it.t2).front(), 0, 0);
            } else {
                for (i64 nx1 : next1(it.t1)) {
                    for (i64 nx2 : next2(it.t2)) {
                        i64 pen = g1.labels[nx1] == g2.labels[nx2]
                                      ? 0 : wp.mismatch;
                        enq(nx1, nx2, 0, pen);
                    }
                    for (int i = 0; i < npw; ++i)
                        enq(nx1, it.t2, i + 1, wp.go[i] + wp.ge[i]);
                }
                for (i64 nx2 : next2(it.t2))
                    for (int i = 0; i < npw; ++i)
                        enq(it.t1, nx2, -i - 1, wp.go[i] + wp.ge[i]);
            }
        } else {
            enq(it.t1, it.t2, 0, 0);  // gap close
            if (it.tc > 0) {
                for (i64 nx1 : next1(it.t1))
                    enq(nx1, it.t2, it.tc, wp.ge[it.tc - 1]);
            } else {
                for (i64 nx2 : next2(it.t2))
                    enq(it.t1, nx2, it.tc, wp.ge[-it.tc - 1]);
            }
        }
    } else {
        if (it.tc == 0) {
            if (it.t1 < g1.V && it.t2 < g2.V) {
                i64 pen = g1.labels[it.t1] == g2.labels[it.t2]
                              ? 0 : wp.mismatch;
                for (i64 nx1 : next1(it.t1))
                    for (i64 nx2 : next2(it.t2))
                        enq(nx1, nx2, 0, pen);
            }
            for (int i = 0; i < npw; ++i) {
                enq(it.t1, it.t2, i + 1, 0);
                enq(it.t1, it.t2, -i - 1, 0);
            }
        } else if (it.tc > 0) {
            if (it.t1 < g1.V) {
                for (i64 nx1 : next1(it.t1)) {
                    enq(nx1, it.t2, it.tc, wp.ge[it.tc - 1]);
                    enq(nx1, it.t2, 0, wp.go[it.tc - 1] + wp.ge[it.tc - 1]);
                }
            }
        } else {
            if (it.t2 < g2.V) {
                for (i64 nx2 : next2(it.t2)) {
                    enq(it.t1, nx2, it.tc, wp.ge[-it.tc - 1]);
                    enq(it.t1, nx2, 0, wp.go[-it.tc - 1] + wp.ge[-it.tc - 1]);
                }
            }
        }
    }
    return false;
}

// forward traceback (reference wfa_traceback, alignment.hpp:1895-1925)
static i64 wfa_traceback(const BackMap& bp, i64 t1, i64 t2,
                         const Graph& g1, const Graph& g2, i64* out) {
    std::vector<std::pair<i64, i64>> aln;
    int tc = 0;
    while (t1 != g1.V || t2 != g2.V) {
        Key nxt = bp.at(Key{t1, t2, tc});
        if (nxt.n1 != t1 && nxt.n2 != t2) aln.emplace_back(t1, t2);
        else if (nxt.n1 != t1) aln.emplace_back(t1, -1);
        else if (nxt.n2 != t2) aln.emplace_back(-1, t2);
        t1 = nxt.n1;
        t2 = nxt.n2;
        tc = nxt.comp;
    }
    std::reverse(aln.begin(), aln.end());
    for (size_t i = 0; i < aln.size(); ++i) {
        out[2 * i] = aln[i].first;
        out[2 * i + 1] = aln[i].second;
    }
    return (i64)aln.size();
}

// reverse traceback (reference wfa_traceback_rev, alignment.hpp:1927-1958)
static i64 wfa_traceback_rev(const BackMap& bp, i64 t1, i64 t2,
                             const Graph& g1, const Graph& g2, i64* out) {
    std::vector<std::pair<i64, i64>> aln;
    int tc = 0;
    Key nxt = bp.at(Key{t1, t2, tc});
    while (nxt.n1 != -1 && nxt.n2 != -1) {
        if (nxt.n1 != t1 && nxt.n2 != t2) aln.emplace_back(nxt.n1, nxt.n2);
        else if (nxt.n1 != t1) aln.emplace_back(nxt.n1, -1);
        else if (nxt.n2 != t2) aln.emplace_back(-1, nxt.n2);
        t1 = nxt.n1;
        t2 = nxt.n2;
        tc = nxt.comp;
        nxt = bp.at(Key{t1, t2, tc});
    }
    for (size_t i = 0; i < aln.size(); ++i) {
        out[2 * i] = aln[i].first;
        out[2 * i + 1] = aln[i].second;
    }
    return (i64)aln.size();
}

static i64 convert_wfa_score(const i64* pairs, i64 len, i64 wfa_score,
                             i64 match, i64 factor) {
    i64 total_len = 0;
    for (i64 i = 0; i < len; ++i) {
        if (pairs[2 * i] != -1) ++total_len;
        if (pairs[2 * i + 1] != -1) ++total_len;
    }
    return (match * total_len - wfa_score * factor) / 2;
}

// reference minmax_distance.hpp semantics: unreachable = -1
static void minmax_dist(const Graph& g, const std::vector<i64>& sources,
                        std::vector<i64>& mind, std::vector<i64>& maxd) {
    const i64 IMAX = std::numeric_limits<i64>::max();
    const i64 IMIN = std::numeric_limits<i64>::min();
    mind.assign(g.V, IMAX);
    maxd.assign(g.V, IMIN);
    for (i64 s : sources) { mind[s] = 0; maxd[s] = 0; }
    // Kahn topological order
    std::vector<i64> indeg(g.V), order;
    order.reserve(g.V);
    std::vector<i64> stack;
    for (i64 v = 0; v < g.V; ++v) {
        indeg[v] = g.pptr[v + 1] - g.pptr[v];
        if (indeg[v] == 0) stack.push_back(v);
    }
    size_t head = 0;
    while (head < stack.size()) {
        i64 v = stack[head++];
        order.push_back(v);
        for (i64 k = g.nptr[v]; k < g.nptr[v + 1]; ++k)
            if (--indeg[g.nind[k]] == 0) stack.push_back(g.nind[k]);
    }
    for (i64 v : order) {
        if (maxd[v] == IMIN) continue;
        for (i64 k = g.nptr[v]; k < g.nptr[v + 1]; ++k) {
            i64 nx = g.nind[k];
            if (mind[v] + 1 < mind[nx]) mind[nx] = mind[v] + 1;
            if (maxd[nx] == IMIN || maxd[v] + 1 > maxd[nx]) maxd[nx] = maxd[v] + 1;
        }
    }
    for (i64 v = 0; v < g.V; ++v)
        if (maxd[v] == IMIN) { mind[v] = -1; maxd[v] = -1; }
}

static std::vector<bool> target_reach(const Graph& g,
                                      const std::vector<i64>& targets) {
    std::vector<bool> reach(g.V, false);
    for (i64 t : targets) reach[t] = true;
    std::vector<i64> indeg(g.V), order;
    order.reserve(g.V);
    std::vector<i64> stack;
    for (i64 v = 0; v < g.V; ++v) {
        indeg[v] = g.pptr[v + 1] - g.pptr[v];
        if (indeg[v] == 0) stack.push_back(v);
    }
    size_t head = 0;
    while (head < stack.size()) {
        i64 v = stack[head++];
        order.push_back(v);
        for (i64 k = g.nptr[v]; k < g.nptr[v + 1]; ++k)
            if (--indeg[g.nind[k]] == 0) stack.push_back(g.nind[k]);
    }
    for (auto it = order.rbegin(); it != order.rend(); ++it) {
        i64 v = *it;
        for (i64 k = g.nptr[v]; k < g.nptr[v + 1]; ++k)
            if (reach[g.nind[k]]) { reach[v] = true; break; }
    }
    return reach;
}

}  // namespace

extern "C" {

// mode 0: wfa_po_poa; mode 1: pwfa_po_poa with prune_limit.
// Returns alignment length (pairs into out, GAP=-1); score via out_score.
i64 wfa_po_poa_native(
        i64 V1, const uint8_t* lab1, const i64* n1ptr, const i64* n1ind,
        const i64* p1ptr, const i64* p1ind,
        i64 V2, const uint8_t* lab2, const i64* n2ptr, const i64* n2ind,
        const i64* p2ptr, const i64* p2ind,
        i64 ns1, const i64* sources1, i64 ns2, const i64* sources2,
        i64 nk1, const i64* sinks1, i64 nk2, const i64* sinks2,
        i64 match, i64 mismatch, int npw, const i64* go, const i64* ge,
        int mode, i64 prune_limit, i64* out, i64* out_score) {
    Graph g1{V1, lab1, n1ptr, n1ind, p1ptr, p1ind};
    Graph g2{V2, lab2, n2ptr, n2ind, p2ptr, p2ind};
    std::vector<i64> src1(sources1, sources1 + ns1);
    std::vector<i64> src2(sources2, sources2 + ns2);
    std::vector<i64> snk1(sinks1, sinks1 + nk1);
    std::vector<i64> snk2(sinks2, sinks2 + nk2);
    WfaParams wp = to_wfa_params(match, mismatch, npw, go, ge);

    BackMap backpointer;
    BucketQueue q;
    q.enqueue(0, QItem{-1, -1, 0, V1, V2, 0});

    auto next1 = [&](i64 v) -> const std::vector<i64> {
        return v == V1 ? src1 : g1.next_of(v);
    };
    auto next2 = [&](i64 v) -> const std::vector<i64> {
        return v == V2 ? src2 : g2.next_of(v);
    };
    std::unordered_set<i64> sink_set1(snk1.begin(), snk1.end());
    std::unordered_set<i64> sink_set2(snk2.begin(), snk2.end());
    auto stop = [&](i64 n1, i64 n2, int comp) {
        return (sink_set1.empty() || sink_set1.count(n1)) &&
               (sink_set2.empty() || sink_set2.count(n2)) && comp == 0;
    };
    auto greedy = [&](i64 n1, i64 n2) -> bool {
        auto nx1 = next1(n1);
        auto nx2 = next2(n2);
        if (nx1.size() == 1 && nx2.size() == 1 && !sink_set1.count(n1) &&
            !sink_set2.count(n2))
            return g1.labels[nx1.front()] == g2.labels[nx2.front()];
        return false;
    };

    // pwfa pruning machinery (reference alignment.hpp:2300-2339)
    std::vector<i64> mind1, maxd1, mind2, maxd2;
    std::vector<bool> reach1, reach2;
    i64 furthest = std::numeric_limits<i64>::min() + prune_limit;
    if (mode == 1) {
        minmax_dist(g1, src1, mind1, maxd1);
        minmax_dist(g2, src2, mind2, maxd2);
        reach1 = target_reach(g1, snk1);
        reach2 = target_reach(g2, snk2);
    }
    auto prune = [&](const Key& k, i64 s) -> bool {
        if (mode != 1) return false;
        if ((k.n1 < V1 && !reach1[k.n1]) || (k.n2 < V2 && !reach2[k.n2]))
            return true;
        i64 d1 = k.n1 != V1 ? maxd1[k.n1] : -1;
        i64 d2 = k.n2 != V2 ? maxd2[k.n2] : -1;
        return d1 + d2 < furthest - prune_limit;
    };
    auto update = [&](const Key& k, i64 s) {
        if (mode != 1) return;
        if ((k.n1 == V1 || reach1[k.n1]) && (k.n2 == V2 || reach2[k.n2])) {
            i64 d1 = k.n1 != V1 ? mind1[k.n1] : -1;
            i64 d2 = k.n2 != V2 ? mind2[k.n2] : -1;
            furthest = std::max(furthest, d1 + d2);
        }
    };

    i64 e1 = -1, e2 = -1;
    while (e1 == -1 && e2 == -1) {
        wfa_iteration<true>(q, backpointer, g1, g2, wp, npw, prune, update,
                            next1, next2, stop, greedy, &e1, &e2);
    }
    i64 len = wfa_traceback(backpointer, e1, e2, g1, g2, out);
    *out_score = convert_wfa_score(out, len, q.min_score, match, wp.factor);
    return len;
}

// deletion_wfa_po_poa (reference alignment.hpp:2037-2283). graph1 = short,
// graph2 = long. min-distance queries on the long graph are answered with a
// memoized per-source topological DP (exact, like the reference's
// SuperbubbleDistanceOracle — values must match; the structure needn't).
i64 deletion_wfa_po_poa_native(
        i64 V1, const uint8_t* lab1, const i64* n1ptr, const i64* n1ind,
        const i64* p1ptr, const i64* p1ind,
        i64 V2, const uint8_t* lab2, const i64* n2ptr, const i64* n2ind,
        const i64* p2ptr, const i64* p2ind,
        i64 ns1, const i64* sources1, i64 ns2, const i64* sources2,
        i64 nk1, const i64* sinks1, i64 nk2, const i64* sinks2,
        i64 match, i64 mismatch, int npw, const i64* go, const i64* ge,
        i64* out, i64* out_score) {
    Graph g1{V1, lab1, n1ptr, n1ind, p1ptr, p1ind};
    Graph g2{V2, lab2, n2ptr, n2ind, p2ptr, p2ind};
    std::vector<i64> src1(sources1, sources1 + ns1);
    std::vector<i64> src2(sources2, sources2 + ns2);
    std::vector<i64> snk1(sinks1, sinks1 + nk1);
    std::vector<i64> snk2(sinks2, sinks2 + nk2);
    WfaParams wp = to_wfa_params(match, mismatch, npw, go, ge);

    i64 scope = wp.mismatch;
    for (int i = 0; i < npw; ++i)
        scope = std::max(scope, wp.go[i] + wp.ge[i]);

    // memoized min distances from a node over the long graph (unit labels)
    std::unordered_map<i64, std::vector<i64>> dist_memo;
    auto min_distance = [&](i64 u, i64 v) -> i64 {
        auto it = dist_memo.find(u);
        if (it == dist_memo.end()) {
            std::vector<i64> d(V2, -1);
            // BFS (unit edge lengths == label size 1)
            std::vector<i64> bfs;
            bfs.push_back(u);
            d[u] = 0;
            size_t head = 0;
            while (head < bfs.size()) {
                i64 x = bfs[head++];
                for (i64 k = g2.nptr[x]; k < g2.nptr[x + 1]; ++k) {
                    i64 nx = g2.nind[k];
                    if (d[nx] == -1) { d[nx] = d[x] + 1; bfs.push_back(nx); }
                }
            }
            it = dist_memo.emplace(u, std::move(d)).first;
        }
        return it->second[v];
    };

    BackMap bp_fwd, bp_rev;
    BucketQueue q_fwd, q_rev;
    q_fwd.enqueue(0, QItem{-1, -1, 0, V1, V2, 0});
    {
        // seed reverse queue with all sink pairs (nested loop order)
        for (i64 a = 0; a < nk1; ++a)
            for (i64 b = 0; b < nk2; ++b)
                q_rev.enqueue(0, QItem{-1, -1, 0, snk1[a], snk2[b], 0});
    }

    std::unordered_set<i64> src_set1(src1.begin(), src1.end());
    std::unordered_set<i64> src_set2(src2.begin(), src2.end());
    auto next_short = [&](i64 v) -> const std::vector<i64> {
        return v == V1 ? src1 : g1.next_of(v);
    };
    auto next_long = [&](i64 v) -> const std::vector<i64> {
        return v == V2 ? src2 : g2.next_of(v);
    };
    auto prev_short = [&](i64 v) -> const std::vector<i64> {
        std::vector<i64> prev(g1.pind + g1.pptr[v], g1.pind + g1.pptr[v + 1]);
        if (src_set1.count(v)) prev.push_back(V1);
        return prev;
    };
    auto prev_long = [&](i64 v) -> const std::vector<i64> {
        std::vector<i64> prev(g2.pind + g2.pptr[v], g2.pind + g2.pptr[v + 1]);
        if (src_set2.count(v)) prev.push_back(V2);
        return prev;
    };
    auto no_prune = [](const Key&, i64) { return false; };
    auto no_greedy = [](i64, i64) { return false; };

    // short node -> [(long node, score)] meeting records, insertion-ordered
    std::unordered_map<i64, std::vector<std::pair<i64, i64>>> fwd_score,
        rev_score;
    i64 stop_score = std::numeric_limits<i64>::max();

    auto update_fwd = [&](const Key& k, i64 s) {
        if (k.comp == 0) fwd_score[k.n1].emplace_back(k.n2, s);
        if (stop_score == std::numeric_limits<i64>::max()) {
            auto it = rev_score.find(k.n1);
            if (it != rev_score.end()) {
                for (const auto& rp : it->second) {
                    if (k.n2 == rp.first ||
                        (k.n2 != V2 && rp.first != V2 &&
                         min_distance(k.n2, rp.first) != -1)) {
                        stop_score = s + scope;
                    }
                }
            }
        }
    };
    auto update_rev = [&](const Key& k, i64 s) {
        if (k.comp == 0) rev_score[k.n1].emplace_back(k.n2, s);
        if (stop_score == std::numeric_limits<i64>::max()) {
            auto it = fwd_score.find(k.n1);
            if (it != fwd_score.end()) {
                for (const auto& fp : it->second) {
                    if (k.n2 == fp.first ||
                        (k.n2 != V2 && fp.first != V2 &&
                         min_distance(fp.first, k.n2) != -1)) {
                        stop_score = s + scope;
                    }
                }
            }
        }
    };
    auto stop = [&](i64, i64, int) {
        return q_fwd.min_score >= stop_score && q_rev.min_score >= stop_score;
    };

    i64 ef1 = -1, ef2 = -1, er1 = -1, er2 = -1;
    while (ef1 == -1 && ef2 == -1 && er1 == -1 && er2 == -1) {
        if (q_fwd.min_score <= q_rev.min_score) {
            wfa_iteration<true>(q_fwd, bp_fwd, g1, g2, wp, npw, no_prune,
                                update_fwd, next_short, next_long, stop,
                                no_greedy, &ef1, &ef2);
        } else {
            wfa_iteration<false>(q_rev, bp_rev, g1, g2, wp, npw, no_prune,
                                 update_rev, prev_short, prev_long, stop,
                                 no_greedy, &er1, &er2);
        }
    }

    // find the best meet combo (reference alignment.hpp:2196-2240). NOTE:
    // ties broken by map iteration order — validated empirically vs the
    // reference binary (see tests).
    i64 opt_score = std::numeric_limits<i64>::max();
    i64 opt_short = -1, opt_lf = -1, opt_lr = -1;
    for (const auto& fwd_rec : fwd_score) {
        auto it = rev_score.find(fwd_rec.first);
        if (it == rev_score.end()) continue;
        for (const auto& fp : fwd_rec.second) {
            if (fp.first == V2) continue;
            for (const auto& rp : it->second) {
                if (rp.first == V2) continue;
                i64 dist = min_distance(fp.first, rp.first);
                if (dist == -1) continue;
                i64 score = wp.go[0] + wp.ge[0] * dist;
                for (int i = 1; i < npw; ++i)
                    score = std::min(score, wp.go[i] + wp.ge[i] * dist);
                score += fp.second + rp.second;
                if (score < opt_score) {
                    opt_score = score;
                    opt_short = fwd_rec.first;
                    opt_lf = fp.first;
                    opt_lr = rp.first;
                }
            }
        }
    }

    i64 len = wfa_traceback(bp_fwd, opt_short, opt_lf, g1, g2, out);

    // shortest path in the long graph between the meet points (reference
    // shortest_path.hpp: topological DP, first-prev tie-break)
    {
        std::vector<i64> dp(V2, std::numeric_limits<i64>::max());
        dp[opt_lf] = 0;
        std::vector<i64> indeg(V2), stack;
        for (i64 v = 0; v < V2; ++v) {
            indeg[v] = g2.pptr[v + 1] - g2.pptr[v];
            if (indeg[v] == 0) stack.push_back(v);
        }
        std::vector<i64> order;
        order.reserve(V2);
        size_t head = 0;
        while (head < stack.size()) {
            i64 v = stack[head++];
            order.push_back(v);
            for (i64 k = g2.nptr[v]; k < g2.nptr[v + 1]; ++k)
                if (--indeg[g2.nind[k]] == 0) stack.push_back(g2.nind[k]);
        }
        // NOTE: the reference uses a LIFO stack for topological_order; DP
        // results are order-independent, so BFS order is fine here.
        for (i64 v : order) {
            if (dp[v] == std::numeric_limits<i64>::max()) continue;
            for (i64 k = g2.nptr[v]; k < g2.nptr[v + 1]; ++k) {
                i64 nx = g2.nind[k];
                dp[nx] = std::min(dp[nx], dp[v] + 1);
            }
        }
        std::vector<i64> path;
        path.push_back(opt_lr);
        while (dp[path.back()] != 0) {
            i64 v = path.back();
            for (i64 k = g2.pptr[v]; k < g2.pptr[v + 1]; ++k) {
                i64 pv = g2.pind[k];
                if (dp[pv] != std::numeric_limits<i64>::max() &&
                    dp[pv] + 1 == dp[v]) {
                    path.push_back(pv);
                    break;
                }
            }
        }
        std::reverse(path.begin(), path.end());
        for (size_t i = 1; i < path.size(); ++i) {
            out[2 * len] = -1;
            out[2 * len + 1] = path[i];
            ++len;
        }
    }

    len += wfa_traceback_rev(bp_rev, opt_short, opt_lr, g1, g2, out + 2 * len);
    *out_score = convert_wfa_score(out, len, opt_score, match, wp.factor);
    return len;
}

}  // extern "C"
