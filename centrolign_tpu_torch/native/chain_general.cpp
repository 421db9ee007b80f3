// General free-gap anchor-chaining DP over path-covered DAGs.
//
// Semantics follow the reference's sparse chain DP (reference
// anchorer.hpp:1511-2470): a sweep over graph1's topological order in which
// an anchor is *inserted* when the sweep passes its walk1 end (keyed by the
// canonical chain/index of its walk2 end) and *queried* when the sweep
// passes, for each chain c1, the last node of c1 that reaches the anchor's
// walk1 start (the reference's "forward edges"); a query against (c1, c2)
// accepts inserted anchors with canonical end chains (c1, c2) and index2 <=
// predecessor_index(start2, c2), at no cost. The empty chain scores 0.
//
// Instead of online orthogonal search trees, the implementation runs an
// offline divide-and-conquer over the sweep-event order; each cross step
// resolves the index2 dominance per (c1, c2) pair with sorted sweeps and a
// prefix max. O(E log^2 E).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <limits>
#include <cstring>

namespace {

constexpr double NEG_INF = -std::numeric_limits<double>::infinity();

// one insert or query event in sweep order
struct Event {
    int64_t anchor;   // anchor index
    int32_t c1, c2;   // chain pair
    int64_t key2;     // insert: canonical idx2; query: bound on idx2 (inclusive)
    bool is_query;
};

struct General {
    int64_t n;
    const double *w, *init_w, *fin_w;

    std::vector<Event> events;     // in sweep order
    std::vector<double> dp;        // best predecessor contribution
    std::vector<int64_t> bp;
    std::vector<double> dp_final;
    std::vector<uint8_t> finalized;

    int32_t C1, C2;

    int64_t pair_of(int32_t c1, int32_t c2) const { return (int64_t)c1 * C2 + c2; }

    void finalize(int64_t a) {
        if (!finalized[a]) {
            double best = std::max(dp[a], init_w[a]);
            if (init_w[a] >= dp[a]) bp[a] = -1;
            dp_final[a] = best + w[a];
            finalized[a] = 1;
        }
    }

    void solve(int64_t lo, int64_t hi);
    void cross(int64_t lo, int64_t mid, int64_t hi);
};

void General::cross(int64_t lo, int64_t mid, int64_t hi) {
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
        ii = i_end;
        qi = q_end;
    }
}

void General::solve(int64_t lo, int64_t hi) {
    if (hi - lo <= 1) {
        if (hi > lo && !events[lo].is_query) {
            finalize(events[lo].anchor);
        }
        return;
    }
    int64_t mid = (lo + hi) / 2;
    solve(lo, mid);
    cross(lo, mid, hi);
    solve(mid, hi);
}

}  // namespace

extern "C" {

// General chaining. Arrays:
//   graph1: V1 nodes; topo1 (V1); chain1: canonical chain per node; T1
//     (V1, C1) row-major predecessor table; chain1_nodes / chain1_offsets:
//     concatenated node lists per chain (for forward-edge firing positions)
//   graph2: chain2/idx2: canonical chain and index per node, T2 (., C2)
//   anchors: s1,e1,s2,e2 node ids; w/init_w/fin_w
// Returns best anchor id or -1.
int64_t chain_dp_general(
    int64_t n,
    const int64_t* s1, const int64_t* e1, const int64_t* s2, const int64_t* e2,
    const double* w, const double* init_w, const double* fin_w,
    int64_t V1, int64_t C1, const int64_t* topo1,
    const int64_t* chain1, const int64_t* T1,
    const int64_t* chain1_nodes, const int64_t* chain1_offsets,
    int64_t C2, const int64_t* chain2, const int64_t* idx2,
    const int64_t* T2,
    int64_t* backptr_out, double* dp_out) {

    General G;
    G.n = n;
    G.w = w; G.init_w = init_w; G.fin_w = fin_w;
    G.C1 = (int32_t)C1; G.C2 = (int32_t)C2;
    G.dp.assign(n, NEG_INF);
    G.bp.assign(n, -1);
    G.dp_final.assign(n, NEG_INF);
    G.finalized.assign(n, 0);

    // position of each node in the topological order
    std::vector<int64_t> topo_pos(V1);
    for (int64_t i = 0; i < V1; ++i) topo_pos[topo1[i]] = i;

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

    G.solve(0, (int64_t)G.events.size());
    for (int64_t a = 0; a < n; ++a) G.finalize(a);

    int64_t best = -1;
    double best_score = 0.0;
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
