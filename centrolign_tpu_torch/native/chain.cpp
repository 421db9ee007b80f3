// Sparse anchor-chaining DP for sequence (chain-graph) problems.
//
// Semantics equal to the reference's sparse_chain_dp / sparse_affine_chain_dp
// restricted to single-chain graphs (reference anchorer.hpp:1511-2470): each
// anchor may chain onto any predecessor with end1 < start1 and end2 < start2;
// with gap costs, an edge costs the best piecewise-affine component of
// |diag_j - diag_i| (diag = pos1 - pos2), scaled; boundary (source/sink)
// weights are supplied per anchor.
//
// Algorithm: offline divide-and-conquer (CDQ) over the graph1 axis. Events
// are (query at start1) and (update at end1), sorted by (position,
// query-before-update) so updates only serve strictly later queries. The
// cross step answers 2D dominance max-plus queries:
//   - no-gap-cost mode: prefix max over end2 order
//   - affine mode: per-component Fenwick maxima over diagonal rank in both
//     directions, plus an equal-diagonal pass (gap == 0 costs nothing)
// Complexity O(n log^2 n); this is also the sort/scan shape of the planned
// on-device chaining kernel.
//
// Build: plain C ABI, loaded via ctypes (see native/__init__.py).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <limits>
#include <cmath>
#include <cstring>

namespace {

constexpr double NEG_INF = -std::numeric_limits<double>::infinity();

struct Fenwick {
    // prefix-max Fenwick tree over ranks [0, n), values carry their anchor id
    std::vector<double> v;
    std::vector<int64_t> id;
    explicit Fenwick(int64_t n) : v(n + 1, NEG_INF), id(n + 1, -1) {}
    void update(int64_t i, double val, int64_t which) {
        for (int64_t x = i + 1; x < (int64_t)v.size(); x += x & (-x)) {
            if (v[x] < val) { v[x] = val; id[x] = which; }
        }
    }
    std::pair<double, int64_t> query(int64_t i) const {
        // max over ranks [0, i]
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

struct Problem {
    int64_t n;
    const int64_t *s1, *e1, *s2, *e2;
    const double *w, *init_w, *fin_w;
    int use_gap;
    int npw;
    const double *go, *ge;
    double scale;

    std::vector<double> dp;        // accumulated best predecessor value
    std::vector<int64_t> bp;
    std::vector<double> dp_final;  // dp after adding w (valid once finalized)
    std::vector<int64_t> diag;     // e-side diag for updates, s-side for queries
    std::vector<int64_t> diag_rank_e; // rank of (e1-e2) among all diags
    std::vector<int64_t> order;    // event order: 2n events
    // event encoding: idx < n -> query for anchor idx; else update anchor idx-n

    std::vector<int64_t> all_diags; // sorted unique diag values

    int64_t diag_rank(int64_t d) const {
        return std::lower_bound(all_diags.begin(), all_diags.end(), d) - all_diags.begin();
    }

    void solve(int64_t lo, int64_t hi,
               std::vector<Fenwick>& fwd, std::vector<Fenwick>& bwd,
               std::vector<int64_t>& touched_ranks);
    void cross(int64_t lo, int64_t mid, int64_t hi,
               std::vector<Fenwick>& fwd, std::vector<Fenwick>& bwd,
               std::vector<int64_t>& touched_ranks);
};

void Problem::cross(int64_t lo, int64_t mid, int64_t hi,
                    std::vector<Fenwick>& fwd, std::vector<Fenwick>& bwd,
                    std::vector<int64_t>& touched_ranks) {
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

    if (!use_gap) {
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
        return;
    }

    // affine mode: per-component Fenwicks keyed by diag rank.
    // fwd[c]: value dp_i + scale*ge[c]*diag_i, query prefix (diag_i <= diag_j)
    // bwd[c]: value dp_i - scale*ge[c]*diag_i, query prefix over reversed rank
    // equal-diag zero-cost handled by a (diag, e2)-sorted pass.
    size_t ui = 0;
    int64_t R = (int64_t)all_diags.size();
    for (int64_t q : qs) {
        while (ui < ups.size() && e2[ups[ui]] < s2[q]) {
            int64_t u = ups[ui];
            int64_t dr = diag_rank(e1[u] - e2[u]);
            touched_ranks.push_back(dr);
            for (int c = 0; c < npw; ++c) {
                fwd[c].update(dr, dp_final[u] + scale * ge[c] * (double)(e1[u] - e2[u]), u);
                bwd[c].update(R - 1 - dr, dp_final[u] - scale * ge[c] * (double)(e1[u] - e2[u]), u);
            }
            ++ui;
        }
        int64_t dq = s1[q] - s2[q];
        int64_t qr = diag_rank(dq);
        bool has_exact = qr < R && all_diags[qr] == dq;
        for (int c = 0; c < npw; ++c) {
            // diag_i <= diag_j: cost = -scale*(go + ge*(dq - diag_i))
            auto a = fwd[c].query(qr - (has_exact ? 0 : 1));
            double av = a.first - scale * (go[c] + ge[c] * (double)dq);
            // diag_i >= diag_j
            auto b = bwd[c].query(R - 1 - qr - (has_exact ? 0 : 1));
            double bv = b.first - scale * (go[c] - ge[c] * (double)dq);
            // note: at diag_i == diag_j both give dp_i - scale*go, strictly
            // worse than the exact-equality 0 cost handled below, so
            // including equality here is safe
            if (av > dp[q]) { dp[q] = av; bp[q] = a.second; }
            if (bv > dp[q]) { dp[q] = bv; bp[q] = b.second; }
        }
    }

    // equal-diagonal zero-cost pass: group by diag value
    std::vector<int64_t> ups2(ups), qs2(qs);
    std::sort(ups2.begin(), ups2.end(), [&](int64_t a, int64_t b) {
        int64_t da = e1[a] - e2[a], db = e1[b] - e2[b];
        return da != db ? da < db : e2[a] < e2[b];
    });
    std::sort(qs2.begin(), qs2.end(), [&](int64_t a, int64_t b) {
        int64_t da = s1[a] - s2[a], db = s1[b] - s2[b];
        return da != db ? da < db : s2[a] < s2[b];
    });
    size_t i = 0, j = 0;
    while (j < qs2.size()) {
        int64_t dq = s1[qs2[j]] - s2[qs2[j]];
        // advance update groups below dq
        while (i < ups2.size() && e1[ups2[i]] - e2[ups2[i]] < dq) ++i;
        size_t i_end = i;
        while (i_end < ups2.size() && e1[ups2[i_end]] - e2[ups2[i_end]] == dq) ++i_end;
        // sweep queries in this diag group against updates in [i, i_end)
        size_t jj = j;
        size_t ii = i;
        double run = NEG_INF;
        int64_t run_bp = -1;
        while (jj < qs2.size() && s1[qs2[jj]] - s2[qs2[jj]] == dq) {
            while (ii < i_end && e2[ups2[ii]] < s2[qs2[jj]]) {
                if (dp_final[ups2[ii]] > run) {
                    run = dp_final[ups2[ii]];
                    run_bp = ups2[ii];
                }
                ++ii;
            }
            if (run > dp[qs2[jj]]) {
                dp[qs2[jj]] = run;
                bp[qs2[jj]] = run_bp;
            }
            ++jj;
        }
        j = jj;
    }
}

void Problem::solve(int64_t lo, int64_t hi,
                    std::vector<Fenwick>& fwd, std::vector<Fenwick>& bwd,
                    std::vector<int64_t>& touched) {
    if (hi - lo <= 1) {
        if (hi > lo && order[lo] < n) {
            int64_t q = order[lo];
            double best = std::max(dp[q], init_w[q]);
            if (init_w[q] >= dp[q]) bp[q] = -1;
            dp_final[q] = best + w[q];
        }
        return;
    }
    int64_t mid = (lo + hi) / 2;
    solve(lo, mid, fwd, bwd, touched);
    cross(lo, mid, hi, fwd, bwd, touched);
    if (use_gap) {
        // clear only the touched entries (keeps total cost O(n log^2 n))
        for (auto r : touched) {
            int64_t rr = (int64_t)all_diags.size() - 1 - r;
            for (int c = 0; c < npw; ++c) {
                fwd[c].clear_rank(r);
                bwd[c].clear_rank(rr);
            }
        }
        touched.clear();
    }
    solve(mid, hi, fwd, bwd, touched);
}

}  // namespace

extern "C" {

// Returns the index of the best chain end (or -1 for the empty chain).
// backptr[j]: index of predecessor anchor, -1 if chain starts at j,
//             -2 should not remain (resolved during finalization).
int64_t chain_dp_seq(int64_t n,
                     const int64_t* s1, const int64_t* e1,
                     const int64_t* s2, const int64_t* e2,
                     const double* w, const double* init_w, const double* fin_w,
                     int use_gap, int npw, const double* go, const double* ge,
                     double scale, double min_score,
                     int64_t* backptr_out, double* dp_out) {
    Problem P;
    P.n = n;
    P.s1 = s1; P.e1 = e1; P.s2 = s2; P.e2 = e2;
    P.w = w; P.init_w = init_w; P.fin_w = fin_w;
    P.use_gap = use_gap; P.npw = npw; P.go = go; P.ge = ge; P.scale = scale;
    P.dp.assign(n, NEG_INF);
    P.bp.assign(n, -1);
    P.dp_final.assign(n, NEG_INF);

    if (use_gap) {
        P.all_diags.reserve(2 * n);
        for (int64_t i = 0; i < n; ++i) {
            P.all_diags.push_back(e1[i] - e2[i]);
            P.all_diags.push_back(s1[i] - s2[i]);
        }
        std::sort(P.all_diags.begin(), P.all_diags.end());
        P.all_diags.erase(std::unique(P.all_diags.begin(), P.all_diags.end()),
                          P.all_diags.end());
    }

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

    int64_t R = use_gap ? (int64_t)P.all_diags.size() : 1;
    std::vector<Fenwick> fwd, bwd;
    if (use_gap) {
        for (int c = 0; c < npw; ++c) {
            fwd.emplace_back(R);
            bwd.emplace_back(R);
        }
    }
    std::vector<int64_t> touched;

    P.solve(0, 2 * n, fwd, bwd, touched);

    // choose the best chain end
    int64_t best = -1;
    double best_score = min_score;
    for (int64_t i = 0; i < n; ++i) {
        if (dp_out) dp_out[i] = P.dp_final[i];
        if (fin_w[i] != NEG_INF && P.dp_final[i] + fin_w[i] > best_score) {
            best = i;
            best_score = P.dp_final[i] + fin_w[i];
        }
    }

    std::memcpy(backptr_out, P.bp.data(), n * sizeof(int64_t));
    return best;
}

}  // extern "C"
