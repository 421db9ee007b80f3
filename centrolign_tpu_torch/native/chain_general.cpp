// General sparse anchor-chaining DP over path-covered DAGs.
//
// Semantics follow the reference's sparse(-affine) chain DP (reference
// anchorer.hpp:1511-2470): a sweep over graph1's topological order in which
// an anchor is *inserted* when the sweep passes its walk1 end (keyed by the
// canonical chain/index of its walk2 end) and *queried* when the sweep
// passes, for each chain c1, the last node of c1 that reaches the anchor's
// walk1 start (the reference's "forward edges"); a query against (c1, c2)
// accepts inserted anchors with canonical end chains (c1, c2) and index2 <=
// predecessor_index(start2, c2). With affine gap costs, an edge costs the
// best scaled piecewise-affine component of |query_shift - insert_shift|,
// where insert_shift = idx1(end1 on c1) - idx2(end2 on c2) and query_shift =
// (T1[start1,c1] + D1[c1][start1]) - (T2[start2,c2] + D2[c2][start2]) with
// the post-switch D arrays — the same separable measure as the reference's
// edge_weight (anchorer.hpp:2551-2581).
//
// Instead of online orthogonal search trees, the implementation runs an
// offline divide-and-conquer over the sweep-event order; each cross step
// resolves (index2 dominance x shift split) per (c1, c2) pair with sorted
// sweeps and Fenwick maxima over compressed shift ranks. O(E log^2 E).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <limits>
#include <cmath>
#include <cstring>

namespace {

constexpr double NEG_INF = -std::numeric_limits<double>::infinity();

struct PairFenwick {
    std::vector<double> v;
    std::vector<int64_t> id;
    void reset_size(int64_t n) {
        v.assign(n + 1, NEG_INF);
        id.assign(n + 1, -1);
    }
    void update(int64_t i, double val, int64_t which) {
        for (int64_t x = i + 1; x < (int64_t)v.size(); x += x & (-x)) {
            if (v[x] < val) { v[x] = val; id[x] = which; }
        }
    }
    std::pair<double, int64_t> query(int64_t i) const {
        double out = NEG_INF;
        int64_t who = -1;
        for (int64_t x = i + 1; x > 0; x -= x & (-x)) {
            if (v[x] > out) { out = v[x]; who = id[x]; }
        }
        return {out, who};
    }
    void clear_rank(int64_t i) {
        for (int64_t x = i + 1; x < (int64_t)v.size(); x += x & (-x)) {
            v[x] = NEG_INF;
            id[x] = -1;
        }
    }
};

// one insert or query event in sweep order
struct Event {
    int64_t anchor;   // anchor index
    int32_t c1, c2;   // chain pair
    int64_t key2;     // insert: canonical idx2; query: bound on idx2 (inclusive)
    int64_t shift;    // insert/query shift (affine only)
    bool is_query;
};

struct General {
    int64_t n;
    const double *w, *init_w, *fin_w;
    int use_gap, npw;
    const double *go, *ge;
    double scale;

    std::vector<Event> events;     // in sweep order
    std::vector<double> dp;        // best predecessor contribution
    std::vector<int64_t> bp;
    std::vector<double> dp_final;
    std::vector<uint8_t> finalized;

    int32_t C1, C2;
    // per (c1,c2): compressed shift keys
    std::vector<std::vector<int64_t>> pair_shifts;
    std::vector<PairFenwick> fwd, bwd;  // [pair * npw + c]

    int64_t pair_of(int32_t c1, int32_t c2) const { return (int64_t)c1 * C2 + c2; }

    void finalize(int64_t a) {
        if (!finalized[a]) {
            double best = std::max(dp[a], init_w[a]);
            if (init_w[a] >= dp[a]) bp[a] = -1;
            dp_final[a] = best + w[a];
            finalized[a] = 1;
        }
    }

    void solve(int64_t lo, int64_t hi, std::vector<std::pair<int64_t, int64_t>>& touched);
    void cross(int64_t lo, int64_t mid, int64_t hi,
               std::vector<std::pair<int64_t, int64_t>>& touched);
};

void General::cross(int64_t lo, int64_t mid, int64_t hi,
                    std::vector<std::pair<int64_t, int64_t>>& touched) {
    // group left inserts and right queries by pair
    std::vector<int64_t> ins, qrs;
    for (int64_t k = lo; k < mid; ++k) {
        if (!events[k].is_query) ins.push_back(k);
    }
    for (int64_t k = mid; k < hi; ++k) {
        if (events[k].is_query) qrs.push_back(k);
    }
    if (ins.empty() || qrs.empty()) return;

    auto pair_key = [&](int64_t ev) {
        return pair_of(events[ev].c1, events[ev].c2);
    };
    std::sort(ins.begin(), ins.end(), [&](int64_t a, int64_t b) {
        int64_t pa = pair_key(a), pb = pair_key(b);
        if (pa != pb) return pa < pb;
        return events[a].key2 < events[b].key2;
    });
    std::sort(qrs.begin(), qrs.end(), [&](int64_t a, int64_t b) {
        int64_t pa = pair_key(a), pb = pair_key(b);
        if (pa != pb) return pa < pb;
        return events[a].key2 < events[b].key2;
    });

    size_t ii = 0, qi = 0;
    while (ii < ins.size() && qi < qrs.size()) {
        int64_t p_i = pair_key(ins[ii]);
        int64_t p_q = pair_key(qrs[qi]);
        if (p_i < p_q) { ++ii; continue; }
        if (p_q < p_i) { ++qi; continue; }
        // same pair: [ii, i_end), [qi, q_end)
        size_t i_end = ii, q_end = qi;
        while (i_end < ins.size() && pair_key(ins[i_end]) == p_i) ++i_end;
        while (q_end < qrs.size() && pair_key(qrs[q_end]) == p_q) ++q_end;

        const auto& shifts = use_gap ? pair_shifts[p_i] : pair_shifts[0];
        int64_t R = use_gap ? (int64_t)shifts.size() : 0;

        if (!use_gap) {
            // prefix max by key2 (index2 dominance, inclusive bound)
            double run = NEG_INF;
            int64_t run_bp = -1;
            size_t a = ii;
            for (size_t q = qi; q < q_end; ++q) {
                const auto& Q = events[qrs[q]];
                while (a < i_end && events[ins[a]].key2 <= Q.key2) {
                    int64_t u = events[ins[a]].anchor;
                    if (dp_final[u] > run) { run = dp_final[u]; run_bp = u; }
                    ++a;
                }
                if (run > dp[Q.anchor]) {
                    dp[Q.anchor] = run;
                    bp[Q.anchor] = run_bp;
                }
            }
        } else {
            auto rank_of = [&](int64_t s) {
                return std::lower_bound(shifts.begin(), shifts.end(), s) - shifts.begin();
            };
            // pass 1: Fenwicks over shift rank with key2 sweep
            size_t a = ii;
            for (size_t q = qi; q < q_end; ++q) {
                const auto& Q = events[qrs[q]];
                while (a < i_end && events[ins[a]].key2 <= Q.key2) {
                    const auto& U = events[ins[a]];
                    int64_t u = U.anchor;
                    int64_t r = rank_of(U.shift);
                    touched.emplace_back(p_i, r);
                    for (int c = 0; c < npw; ++c) {
                        fwd[p_i * npw + c].update(
                            r, dp_final[u] + scale * ge[c] * (double)U.shift, u);
                        bwd[p_i * npw + c].update(
                            R - 1 - r, dp_final[u] - scale * ge[c] * (double)U.shift, u);
                    }
                    ++a;
                }
                int64_t qr = rank_of(Q.shift);
                bool exact = qr < R && shifts[qr] == Q.shift;
                for (int c = 0; c < npw; ++c) {
                    auto A = fwd[p_i * npw + c].query(qr - (exact ? 0 : 1));
                    double av = A.first - scale * (go[c] + ge[c] * (double)Q.shift);
                    auto B = bwd[p_i * npw + c].query(R - 1 - qr - (exact ? 0 : 1));
                    double bv = B.first - scale * (go[c] - ge[c] * (double)Q.shift);
                    if (av > dp[Q.anchor]) { dp[Q.anchor] = av; bp[Q.anchor] = A.second; }
                    if (bv > dp[Q.anchor]) { dp[Q.anchor] = bv; bp[Q.anchor] = B.second; }
                }
            }
            // pass 2: equal-shift, zero gap cost
            std::vector<int64_t> ins2(ins.begin() + ii, ins.begin() + i_end);
            std::vector<int64_t> qrs2(qrs.begin() + qi, qrs.begin() + q_end);
            std::sort(ins2.begin(), ins2.end(), [&](int64_t x, int64_t y) {
                if (events[x].shift != events[y].shift) return events[x].shift < events[y].shift;
                return events[x].key2 < events[y].key2;
            });
            std::sort(qrs2.begin(), qrs2.end(), [&](int64_t x, int64_t y) {
                if (events[x].shift != events[y].shift) return events[x].shift < events[y].shift;
                return events[x].key2 < events[y].key2;
            });
            size_t xi = 0, yj = 0;
            while (yj < qrs2.size()) {
                int64_t sq = events[qrs2[yj]].shift;
                while (xi < ins2.size() && events[ins2[xi]].shift < sq) ++xi;
                size_t x_end = xi;
                while (x_end < ins2.size() && events[ins2[x_end]].shift == sq) ++x_end;
                size_t xj = xi;
                double run = NEG_INF;
                int64_t run_bp = -1;
                while (yj < qrs2.size() && events[qrs2[yj]].shift == sq) {
                    const auto& Q = events[qrs2[yj]];
                    while (xj < x_end && events[ins2[xj]].key2 <= Q.key2) {
                        int64_t u = events[ins2[xj]].anchor;
                        if (dp_final[u] > run) { run = dp_final[u]; run_bp = u; }
                        ++xj;
                    }
                    if (run > dp[Q.anchor]) {
                        dp[Q.anchor] = run;
                        bp[Q.anchor] = run_bp;
                    }
                    ++yj;
                }
            }
        }
        ii = i_end;
        qi = q_end;
    }
}

void General::solve(int64_t lo, int64_t hi,
                    std::vector<std::pair<int64_t, int64_t>>& touched) {
    if (hi - lo <= 1) {
        if (hi > lo && !events[lo].is_query) {
            finalize(events[lo].anchor);
        }
        return;
    }
    int64_t mid = (lo + hi) / 2;
    solve(lo, mid, touched);
    cross(lo, mid, hi, touched);
    for (auto& t : touched) {
        int64_t p = t.first, r = t.second;
        int64_t R = (int64_t)pair_shifts[p].size();
        for (int c = 0; c < npw; ++c) {
            fwd[p * npw + c].clear_rank(r);
            bwd[p * npw + c].clear_rank(R - 1 - r);
        }
    }
    touched.clear();
    solve(mid, hi, touched);
}

}  // namespace

extern "C" {

// Build post-switch distances ("D array", reference
// post_switch_distances.hpp:16-80) in the reference's exact semantics,
// including its 0-means-unset bookkeeping. distances_out is (C, V),
// row-major; 0 encodes "none".
void psd_build(int64_t V, int64_t C,
               const int64_t* topo_order,
               const int64_t* prev_indptr, const int64_t* prev_indices,
               const int64_t* index_on,   // (C, V) row-major, -1 if off
               const int64_t* table,      // (V, C) row-major, -1 missing
               int64_t* distances_out) {
    std::memset(distances_out, 0, sizeof(int64_t) * V * C);
    for (int64_t oi = 0; oi < V; ++oi) {
        int64_t v = topo_order[oi];
        for (int64_t p = 0; p < C; ++p) {
            int64_t pred = table[v * C + p];
            int64_t* row = distances_out + p * V;
            for (int64_t k = prev_indptr[v]; k < prev_indptr[v + 1]; ++k) {
                int64_t u = prev_indices[k];
                if (index_on[p * V + u] == pred) {
                    row[v] = 1;
                    break;
                } else if (table[u * C + p] == pred) {
                    int64_t thru = row[u] + 1;  // label_size == 1
                    if (row[v] == 0 || row[v] > thru) row[v] = thru;
                }
            }
        }
    }
}

// General chaining. Arrays:
//   graph1: V1 nodes; topo1 (V1); chain1/idx1: canonical chain and index per
//     node; T1 (V1, C1) row-major predecessor table; D1 (C1, V1) post-switch
//     (only if use_gap); chain1_nodes / chain1_offsets: concatenated node
//     lists per chain (for forward-edge firing positions)
//   graph2: chain2/idx2 (V2), T2 (V2, C2), D2 (C2, V2)
//   anchors: s1,e1,s2,e2 node ids; w/init_w/fin_w
// Returns best anchor id or -1.
int64_t chain_dp_general(
    int64_t n,
    const int64_t* s1, const int64_t* e1, const int64_t* s2, const int64_t* e2,
    const double* w, const double* init_w, const double* fin_w,
    int64_t V1, int64_t C1, const int64_t* topo1,
    const int64_t* chain1, const int64_t* idx1, const int64_t* T1, const int64_t* D1,
    const int64_t* chain1_nodes, const int64_t* chain1_offsets,
    int64_t V2, int64_t C2, const int64_t* chain2, const int64_t* idx2,
    const int64_t* T2, const int64_t* D2,
    int use_gap, int npw, const double* go, const double* ge,
    double scale, double min_score,
    int64_t* backptr_out, double* dp_out) {

    General G;
    G.n = n;
    G.w = w; G.init_w = init_w; G.fin_w = fin_w;
    G.use_gap = use_gap; G.npw = npw; G.go = go; G.ge = ge; G.scale = scale;
    G.C1 = (int32_t)C1; G.C2 = (int32_t)C2;
    G.dp.assign(n, NEG_INF);
    G.bp.assign(n, -1);
    G.dp_final.assign(n, NEG_INF);
    G.finalized.assign(n, 0);

    // position of each node in the topological order
    std::vector<int64_t> topo_pos(V1);
    for (int64_t i = 0; i < V1; ++i) topo_pos[topo1[i]] = i;

    const int64_t HUGE_D = (int64_t)1 << 61;
    auto d1_at = [&](int64_t c, int64_t v) -> int64_t {
        if (!use_gap) return 0;
        int64_t d = D1[c * V1 + v];
        return d == 0 ? HUGE_D : d;
    };
    auto d2_at = [&](int64_t c, int64_t v) -> int64_t {
        if (!use_gap) return 0;
        int64_t d = D2[c * V2 + v];
        return d == 0 ? HUGE_D : d;
    };

    // build events: insert at (topo_pos(e1), phase 0); queries at
    // (topo_pos(firing node for (s1, c1)), phase 1)
    struct RawEvent {
        int64_t time;
        int32_t phase;
        Event ev;
    };
    std::vector<RawEvent> raw;
    raw.reserve(n * (1 + C1));
    for (int64_t a = 0; a < n; ++a) {
        Event ins;
        ins.anchor = a;
        ins.c1 = (int32_t)chain1[e1[a]];
        ins.c2 = (int32_t)chain2[e2[a]];
        ins.key2 = idx2[e2[a]];
        ins.shift = use_gap ? (idx1[e1[a]] - idx2[e2[a]]) : 0;
        ins.is_query = false;
        raw.push_back({topo_pos[e1[a]], 0, ins});

        for (int64_t c1 = 0; c1 < C1; ++c1) {
            int64_t pred1 = T1[s1[a] * C1 + c1];
            if (pred1 < 0) continue;
            int64_t fire_node = chain1_nodes[chain1_offsets[c1] + pred1];
            for (int64_t c2 = 0; c2 < C2; ++c2) {
                int64_t pred2 = T2[s2[a] * C2 + c2];
                if (pred2 < 0) continue;
                Event q;
                q.anchor = a;
                q.c1 = (int32_t)c1;
                q.c2 = (int32_t)c2;
                q.key2 = pred2;  // inclusive bound on idx2
                q.shift = use_gap
                    ? ((pred1 + d1_at(c1, s1[a])) - (pred2 + d2_at(c2, s2[a])))
                    : 0;
                q.is_query = true;
                raw.push_back({topo_pos[fire_node], 1, q});
            }
        }
    }
    std::stable_sort(raw.begin(), raw.end(), [](const RawEvent& a, const RawEvent& b) {
        if (a.time != b.time) return a.time < b.time;
        return a.phase < b.phase;
    });
    G.events.reserve(raw.size());
    for (auto& r : raw) G.events.push_back(r.ev);

    // compress shift keys per pair
    G.pair_shifts.assign(use_gap ? C1 * C2 : 1, {});
    if (use_gap) {
        for (const auto& ev : G.events) {
            G.pair_shifts[G.pair_of(ev.c1, ev.c2)].push_back(ev.shift);
        }
        G.fwd.resize((int64_t)C1 * C2 * npw);
        G.bwd.resize((int64_t)C1 * C2 * npw);
        for (int64_t p = 0; p < (int64_t)C1 * C2; ++p) {
            auto& s = G.pair_shifts[p];
            std::sort(s.begin(), s.end());
            s.erase(std::unique(s.begin(), s.end()), s.end());
            for (int c = 0; c < npw; ++c) {
                G.fwd[p * npw + c].reset_size((int64_t)s.size());
                G.bwd[p * npw + c].reset_size((int64_t)s.size());
            }
        }
    }

    std::vector<std::pair<int64_t, int64_t>> touched;
    G.solve(0, (int64_t)G.events.size(), touched);
    for (int64_t a = 0; a < n; ++a) G.finalize(a);

    int64_t best = -1;
    double best_score = min_score;
    for (int64_t i = 0; i < n; ++i) {
        if (dp_out) dp_out[i] = G.dp_final[i];
        if (fin_w[i] != NEG_INF && G.dp_final[i] + fin_w[i] > best_score) {
            best = i;
            best_score = G.dp_final[i] + fin_w[i];
        }
    }
    std::memcpy(backptr_out, G.bp.data(), n * sizeof(int64_t));
    return best;
}

}  // extern "C"
