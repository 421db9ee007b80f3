// Free-gap anchor-chaining DP for sequence (chain-graph) problems.
//
// Semantics equal to the reference's sparse_chain_dp restricted to
// single-chain graphs (reference anchorer.hpp:1511-2470): each anchor may
// chain onto any predecessor with end1 < start1 and end2 < start2, at no
// cost, and may start or end a chain at no cost. The empty chain scores 0.
//
// Algorithm: offline divide-and-conquer (CDQ) over the graph1 axis. Events
// are (query at start1) and (update at end1), sorted by (position,
// query-before-update) so updates only serve strictly later queries. The
// cross step answers 2D dominance max queries with a prefix max over end2
// order. Complexity O(n log^2 n).
//
// Build: plain C ABI, loaded via ctypes (see native/__init__.py).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <limits>
#include <cstring>

namespace {

constexpr double NEG_INF = -std::numeric_limits<double>::infinity();

struct Problem {
    int64_t n;
    const int64_t *s1, *e1, *s2, *e2;
    const double *w;

    std::vector<double> dp;        // best predecessor value, 0 at a chain start
    std::vector<int64_t> bp;
    std::vector<double> dp_final;  // dp after adding w (valid once finalized)
    std::vector<int64_t> order;    // event order: 2n events
    // event encoding: idx < n -> query for anchor idx; else update anchor idx-n

    void solve(int64_t lo, int64_t hi);
    void cross(int64_t lo, int64_t mid, int64_t hi);
};

void Problem::cross(int64_t lo, int64_t mid, int64_t hi) {
    // updates in [lo, mid), queries in [mid, hi)
    std::vector<int64_t> ups, qs;
    ups.reserve(mid - lo);
    qs.reserve(hi - mid);
    for (int64_t k = lo; k < mid; ++k) {
        if (order[k] >= n) ups.push_back(order[k] - n);
    }
    for (int64_t k = mid; k < hi; ++k) {
        if (order[k] < n) qs.push_back(order[k]);
    }
    if (ups.empty() || qs.empty()) return;

    // sort by the end2/start2 dominance axis
    std::sort(ups.begin(), ups.end(), [&](int64_t a, int64_t b) { return e2[a] < e2[b]; });
    std::sort(qs.begin(), qs.end(), [&](int64_t a, int64_t b) { return s2[a] < s2[b]; });

    // running prefix max over updates with e2 < s2
    double run = NEG_INF;
    int64_t run_bp = -1;
    size_t ui = 0;
    for (int64_t q : qs) {
        while (ui < ups.size() && e2[ups[ui]] < s2[q]) {
            if (dp_final[ups[ui]] > run) {
                run = dp_final[ups[ui]];
                run_bp = ups[ui];
            }
            ++ui;
        }
        if (run > dp[q]) {
            dp[q] = run;
            bp[q] = run_bp;
        }
    }
}

void Problem::solve(int64_t lo, int64_t hi) {
    if (hi - lo <= 1) {
        if (hi > lo && order[lo] < n) {
            int64_t q = order[lo];
            dp_final[q] = dp[q] + w[q];
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

// Returns the index of the best chain end (or -1 for the empty chain).
// backptr[j]: index of predecessor anchor, -1 if chain starts at j,
//             -2 should not remain (resolved during finalization).
int64_t chain_dp_seq(int64_t n,
                     const int64_t* s1, const int64_t* e1,
                     const int64_t* s2, const int64_t* e2,
                     const double* w,
                     int64_t* backptr_out, double* dp_out) {
    Problem P;
    P.n = n;
    P.s1 = s1; P.e1 = e1; P.s2 = s2; P.e2 = e2;
    P.w = w;
    P.dp.assign(n, 0.0);
    P.bp.assign(n, -1);
    P.dp_final.assign(n, NEG_INF);

    // events sorted by (graph1 position, query-before-update, anchor index)
    P.order.resize(2 * n);
    for (int64_t i = 0; i < n; ++i) {
        P.order[i] = i;          // query at s1[i]
        P.order[n + i] = n + i;  // update at e1[i]
    }
    std::sort(P.order.begin(), P.order.end(), [&](int64_t a, int64_t b) {
        int64_t pa = a < n ? s1[a] : e1[a - n];
        int64_t pb = b < n ? s1[b] : e1[b - n];
        if (pa != pb) return pa < pb;
        int qa = a < n ? 0 : 1;  // queries first
        int qb = b < n ? 0 : 1;
        if (qa != qb) return qa < qb;
        return a < b;
    });

    P.solve(0, 2 * n);

    // choose the best chain end
    int64_t best = -1;
    double best_score = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        if (dp_out) dp_out[i] = P.dp_final[i];
        if (P.dp_final[i] > best_score) {
            best = i;
            best_score = P.dp_final[i];
        }
    }

    std::memcpy(backptr_out, P.bp.data(), n * sizeof(int64_t));
    return best;
}

}  // extern "C"
