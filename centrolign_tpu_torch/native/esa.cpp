// Native suffix-array match finding: SA-IS suffix array, Kasai LCP, and the
// LCP-interval-tree minimal-rare-match enumeration (behavioral equivalent of
// the reference PathESA/ESA machinery, reference path_esa.hpp:204-409 [SA-IS],
// path_esa.hpp:172-201 [Kasai], esa.hpp:196-491 [minimal rare matches]).
//
// The traversal, match conditions, and emission order mirror
// centrolign_tpu/match_finder.py (the pure-numpy oracle), which was validated
// against the reference's output. Distinct-start counts over SA intervals are
// answered offline with a Fenwick sweep over prev-occurrence positions
// (distinct(c, b, e) = #{i in [b,e] : comp[i]=c, prev_occ[i] < b}).

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#include <unordered_set>

namespace {

using i64 = int64_t;

// ---------------------------------------------------------------- SA-IS ---

// SA-IS over an integer alphabet. text values in [0, K); text[n-1] must be
// the unique minimum (sentinel 0).
static void sais_core(const i64* text, i64* sa, i64 n, i64 K) {
    if (n == 0) return;
    if (n == 1) { sa[0] = 0; return; }

    std::vector<bool> is_s(n);
    is_s[n - 1] = true;
    for (i64 i = n - 2; i >= 0; --i) {
        is_s[i] = text[i] < text[i + 1] ||
                  (text[i] == text[i + 1] && is_s[i + 1]);
    }
    auto is_lms = [&](i64 i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

    std::vector<i64> bkt(K + 1, 0);
    for (i64 i = 0; i < n; ++i) bkt[text[i] + 1]++;
    for (i64 i = 0; i < K; ++i) bkt[i + 1] += bkt[i];

    std::vector<i64> cur(K);
    auto induce = [&](const std::vector<i64>& lms) {
        std::fill(sa, sa + n, -1);
        // place LMS suffixes at bucket ends (reverse order)
        for (i64 i = 0; i < K; ++i) cur[i] = bkt[i + 1] - 1;
        for (i64 k = (i64)lms.size() - 1; k >= 0; --k) {
            i64 p = lms[k];
            sa[cur[text[p]]--] = p;
        }
        // induce L from left
        for (i64 i = 0; i < K; ++i) cur[i] = bkt[i];
        for (i64 i = 0; i < n; ++i) {
            i64 p = sa[i];
            if (p > 0 && !is_s[p - 1]) sa[cur[text[p - 1]]++] = p - 1;
        }
        // induce S from right
        for (i64 i = 0; i < K; ++i) cur[i] = bkt[i + 1] - 1;
        for (i64 i = n - 1; i >= 0; --i) {
            i64 p = sa[i];
            if (p > 0 && is_s[p - 1]) sa[cur[text[p - 1]]--] = p - 1;
        }
    };

    std::vector<i64> lms_pos;
    for (i64 i = 1; i < n; ++i) if (is_lms(i)) lms_pos.push_back(i);

    induce(lms_pos);

    // name LMS substrings in SA order
    i64 m = (i64)lms_pos.size();
    std::vector<i64> name_of(n, -1), sorted_lms;
    sorted_lms.reserve(m);
    for (i64 i = 0; i < n; ++i) if (is_lms(sa[i])) sorted_lms.push_back(sa[i]);
    i64 names = 0;
    i64 prev = -1;
    for (i64 k = 0; k < m; ++k) {
        i64 p = sorted_lms[k];
        bool same = false;
        if (prev >= 0) {
            same = true;
            for (i64 d = 0;; ++d) {
                bool lp = is_lms(prev + d), lq = is_lms(p + d);
                if (d > 0 && lp && lq) break;  // both ended
                if (text[prev + d] != text[p + d] || (d > 0 && (lp != lq))) {
                    same = false;
                    break;
                }
                if (prev + d + 1 >= n || p + d + 1 >= n) { same = false; break; }
            }
        }
        if (!same) ++names;
        name_of[p] = names - 1;
        prev = p;
    }

    if (names < m) {
        std::vector<i64> sub(m), sub_sa(m);
        for (i64 k = 0; k < m; ++k) sub[k] = name_of[lms_pos[k]];
        sais_core(sub.data(), sub_sa.data(), m, names);
        std::vector<i64> ordered(m);
        for (i64 k = 0; k < m; ++k) ordered[k] = lms_pos[sub_sa[k]];
        induce(ordered);
    } else {
        // already unique: sorted_lms is the right order
        induce(sorted_lms);
    }
}

struct Fenwick {
    std::vector<i64> t;
    i64 n;
    explicit Fenwick(i64 n_) : t(n_ + 1, 0), n(n_) {}
    void add(i64 i) { for (++i; i <= n; i += i & (-i)) t[i]++; }
    i64 prefix(i64 i) const {  // count of inserted values < i
        i64 s = 0;
        for (; i > 0; i -= i & (-i)) s += t[i];
        return s;
    }
};

struct SparseMin {
    std::vector<std::vector<i64>> lev;
    void build(const i64* a, i64 n) {
        lev.clear();
        lev.emplace_back(a, a + n);
        for (i64 k = 1; (i64(1) << k) <= n; ++k) {
            i64 m = n - (i64(1) << k) + 1;
            std::vector<i64> row(m);
            const auto& p = lev.back();
            i64 half = i64(1) << (k - 1);
            for (i64 i = 0; i < m; ++i) row[i] = std::min(p[i], p[i + half]);
            lev.push_back(std::move(row));
        }
    }
    // min over a[l:r), r > l
    i64 query(i64 l, i64 r) const {
        int k = 63 - __builtin_clzll((unsigned long long)(r - l));
        return std::min(lev[k][l], lev[k][r - (i64(1) << k)]);
    }
};

}  // namespace

extern "C" {

// Suffix array + ISA + LCP over text (values >= 0; text[n-1] unique min 0).
void esa_build(i64 n, const i64* text, i64 K, i64* sa, i64* isa, i64* lcp) {
    sais_core(text, sa, n, K);
    for (i64 i = 0; i < n; ++i) isa[sa[i]] = i;
    // Kasai
    i64 h = 0;
    for (i64 i = 0; i < n; ++i) {
        if (isa[i] > 0) {
            i64 j = sa[isa[i] - 1];
            while (i + h < n && j + h < n && text[i + h] == text[j + h]) ++h;
            lcp[isa[i]] = h;
            if (h > 0) --h;
        } else {
            lcp[0] = 0;
            h = 0;
        }
    }
}

// Minimal-rare-match enumeration (2 components). Inputs are per-SA-position
// component and start-node-id arrays. Output: up to max_out rows of
// (sa_begin, sa_end, length, cnt0, cnt1) written to out (row-major, 5 cols);
// returns the number of matches (may exceed max_out — caller re-allocs).
i64 esa_minimal_rare_matches(
        i64 n, const i64* sa, const i64* isa, const i64* lcp,
        const int8_t* start_comp,   // component per SA position
        const i64* start_id,        // start node id per SA position
        i64 max_count, i64 max_out, i64* out) {
    const bool timing = getenv("ESA_DEBUG") != nullptr;
    auto tick = std::chrono::steady_clock::now();
    auto lap = [&](const char* what) {
        if (!timing) return;
        auto now = std::chrono::steady_clock::now();
        fprintf(stderr, "[esa] %s: %.2fs\n", what,
                std::chrono::duration<double>(now - tick).count());
        tick = now;
    };
    // prev same-(comp,id) occurrence in SA order: one linear pass with a
    // flat last-seen table per component (ids are node ids, dense)
    std::vector<i64> prev_occ(n, -1);
    {
        i64 max_id = -1;
        for (i64 i = 0; i < n; ++i)
            if (start_id[i] > max_id) max_id = start_id[i];
        std::vector<i64> last0(max_id + 1, -1), last1(max_id + 1, -1);
        for (i64 i = 0; i < n; ++i) {
            i64* last = (start_comp[i] == 0) ? last0.data() : last1.data();
            prev_occ[i] = last[start_id[i]];
            last[start_id[i]] = i;
        }
    }
    lap("prev_occ");

    // link-interval requests are resolved OFFLINE after the sweep (union-
    // find over descending lcp thresholds), so no RMQ structure is needed
    struct LinkReq { i64 qid, q, thr; };  // maximal [lo,hi] ∋ q, lcp >= thr
    std::vector<LinkReq> link_reqs;

    // ---------------- pass A: sweep, enumerate nodes, collect queries ----
    struct Node {
        i64 b, e, depth;
        i64 own_q;                    // query id of own-interval count
        std::vector<i64> child_node;  // indices into nodes, in order
        std::vector<i64> child_linkq; // per child: link-interval query or -1
    };
    std::vector<Node> nodes;          // in pop order
    struct Q { i64 b, e; };
    std::vector<Q> queries;
    auto add_query = [&](i64 b, i64 e) {
        queries.push_back({b, e});
        return (i64)queries.size() - 1;
    };

    auto link_interval = [&](i64 cb, i64 thr, i64 qid) {
        if (thr <= 1) {
            queries[qid] = {0, n - 1};
            return;
        }
        link_reqs.push_back({qid, isa[sa[cb] + 1], thr - 1});
    };

    // stack entries: depth, left boundary, children node ids (in order)
    struct SE { i64 depth, left; std::vector<i64> children; };
    std::vector<SE> stack;
    stack.push_back({0, 0, {}});

    auto close_node = [&](i64 b, i64 e, i64 depth, std::vector<i64>&& children) {
        Node nd;
        nd.b = b; nd.e = e; nd.depth = depth;
        nd.own_q = add_query(b, e);
        nd.child_node = std::move(children);
        nd.child_linkq.resize(nd.child_node.size(), -1);
        i64 L = depth + 1;  // children's unique length uses *this* node's depth
        for (size_t k = 0; k < nd.child_node.size(); ++k) {
            const Node& c = nodes[nd.child_node[k]];
            // link query needed only when L > 1 (cheap enough to always emit)
            if (L > 1) {
                nd.child_linkq[k] = add_query(0, 0);  // filled offline below
                link_interval(c.b, L, nd.child_linkq[k]);
            }
        }
        nodes.push_back(std::move(nd));
        return (i64)nodes.size() - 1;
    };

    for (i64 i = 1; i < n; ++i) {
        i64 last = -1;
        i64 left = i - 1;
        while (stack.back().depth > lcp[i]) {
            SE top = std::move(stack.back());
            stack.pop_back();
            i64 id = close_node(top.left, i - 1, top.depth,
                                std::move(top.children));
            last = id;
            left = top.left;
            if (stack.back().depth >= lcp[i]) {
                stack.back().children.push_back(last);
                last = -1;
            }
        }
        if (stack.back().depth < lcp[i]) {
            SE se;
            se.depth = lcp[i];
            se.left = left;
            if (last != -1) se.children.push_back(last);
            stack.push_back(std::move(se));
        }
    }
    while (!stack.empty()) {
        SE top = std::move(stack.back());
        stack.pop_back();
        i64 id = close_node(top.left, n - 1, top.depth,
                            std::move(top.children));
        if (!stack.empty()) stack.back().children.push_back(id);
    }
    lap("lcp-tree sweep");

    // ---------------- offline link intervals ----------------------------
    // request: maximal [lo, hi] containing SA position q whose internal
    // boundaries all have lcp >= thr. Process thresholds descending,
    // union-merging adjacent positions as their boundary lcp becomes
    // active; each root tracks its interval (replaces per-request binary
    // searches over an RMQ — O(n a(n)) total).
    if (!link_reqs.empty()) {
        std::vector<i64> uf(n), lo_of(n), hi_of(n);
        for (i64 i = 0; i < n; ++i) uf[i] = lo_of[i] = hi_of[i] = i;
        auto find = [&](i64 x) {
            while (uf[x] != x) {
                uf[x] = uf[uf[x]];
                x = uf[x];
            }
            return x;
        };
        // bucket boundaries by lcp value and requests by threshold
        i64 maxv = 0;
        for (i64 b = 1; b < n; ++b) maxv = std::max(maxv, lcp[b]);
        for (const auto& r : link_reqs) maxv = std::max(maxv, r.thr);
        std::vector<std::vector<i64>> bnd_at(maxv + 1);
        for (i64 b = 1; b < n; ++b)
            if (lcp[b] >= 1 && lcp[b] <= maxv) bnd_at[lcp[b]].push_back(b);
        std::vector<std::vector<i64>> req_at(maxv + 1);
        for (size_t r = 0; r < link_reqs.size(); ++r) {
            // thr > maxv can only return the singleton [q, q]
            if (link_reqs[r].thr <= maxv)
                req_at[link_reqs[r].thr].push_back((i64)r);
            else
                queries[link_reqs[r].qid] = {link_reqs[r].q, link_reqs[r].q};
        }
        for (i64 t = maxv; t >= 1; --t) {
            for (i64 b : bnd_at[t]) {
                i64 ra = find(b - 1), rb = find(b);
                if (ra != rb) {
                    uf[rb] = ra;
                    lo_of[ra] = std::min(lo_of[ra], lo_of[rb]);
                    hi_of[ra] = std::max(hi_of[ra], hi_of[rb]);
                }
            }
            for (i64 r : req_at[t]) {
                i64 root = find(link_reqs[r].q);
                queries[link_reqs[r].qid] = {lo_of[root], hi_of[root]};
            }
        }
    }
    lap("link intervals");

    // ---------------- offline distinct counts ---------------------------
    // distinct(c, b, e) = F_c(e, b) - F_c(b - 1, b),
    // F_c(x, thr) = #{ i <= x : comp[i] = c, prev_occ[i] < thr }
    i64 nq = (i64)queries.size();
    std::vector<i64> ans0(nq), ans1(nq);
    {
        struct Ev { i64 x, thr, qid; int sign; };
        std::vector<Ev> evs;
        evs.reserve(2 * nq);
        for (i64 q = 0; q < nq; ++q) {
            evs.push_back({queries[q].e, queries[q].b, q, +1});
            evs.push_back({queries[q].b - 1, queries[q].b, q, -1});
        }
        // counting sort by x (keys are SA positions in [-1, n)): the
        // comparator sort was the hot spot of this pass
        {
            std::vector<i64> cnt(n + 2, 0);
            for (const Ev& ev : evs) ++cnt[ev.x + 1];
            i64 run = 0;
            for (i64 x = 0; x <= n + 1; ++x) {
                i64 c = cnt[x];
                cnt[x] = run;
                run += c;
            }
            std::vector<Ev> sorted(evs.size());
            for (const Ev& ev : evs) sorted[cnt[ev.x + 1]++] = ev;
            evs.swap(sorted);
        }
        Fenwick f0(n + 1), f1(n + 1);
        i64 i = 0;
        for (const Ev& ev : evs) {
            while (i <= ev.x && i < n) {
                if (start_comp[i] == 0) f0.add(prev_occ[i] + 1);
                else f1.add(prev_occ[i] + 1);
                ++i;
            }
            // prev_occ < thr  <=>  stored value prev_occ+1 < thr+1
            ans0[ev.qid] += ev.sign * f0.prefix(ev.thr + 1);
            ans1[ev.qid] += ev.sign * f1.prefix(ev.thr + 1);
        }
    }
    lap("fenwick counts");

    // ---------------- pass B: replay decisions, emit matches ------------
    std::vector<uint8_t> flag(nodes.size(), 0);
    i64 n_matches = 0;
    for (size_t pi = 0; pi < nodes.size(); ++pi) {
        const Node& P = nodes[pi];
        bool any = false;
        i64 L = P.depth + 1;
        for (size_t k = 0; k < P.child_node.size(); ++k) {
            i64 ci = P.child_node[k];
            if (flag[ci]) { any = true; continue; }
            const Node& C = nodes[ci];
            i64 c0 = ans0[C.own_q], c1 = ans1[C.own_q];
            if (c0 == 0 || c1 == 0) continue;
            if (c0 * c1 > max_count) { any = true; continue; }
            bool emit;
            if (L == 1) {
                emit = true;
            } else {
                i64 p0 = ans0[P.own_q], p1 = ans1[P.own_q];
                i64 l0 = ans0[P.child_linkq[k]], l1 = ans1[P.child_linkq[k]];
                emit = (l0 > c0 || l1 > c1) && (p0 > c0 || p1 > c1);
            }
            if (emit) {
                if (n_matches < max_out) {
                    i64* row = out + 5 * n_matches;
                    row[0] = C.b; row[1] = C.e; row[2] = L;
                    row[3] = c0; row[4] = c1;
                }
                ++n_matches;
            }
        }
        flag[pi] = any ? 1 : 0;
    }
    lap("replay");
    return n_matches;
}

}  // extern "C"

extern "C" {

// Walk out match occurrences into node-id paths, deduplicated by
// (component, start id), in SA order (reference esa.hpp:613-665). rows is
// (M, 5): (sa_begin, sa_end, length, cnt0, cnt1); the walks of match m are
// written contiguously (comp-0 walks first, then comp-1), each of length
// rows[m][2], into out_walks at out_offsets[m] (given in units of i64).
// Caller sizes out_walks as sum((cnt0+cnt1) * length).
void esa_walk_matches(
        i64 n_rows, const i64* rows,
        const i64* sa, const i64* ids, const int8_t* comp,
        const i64* out_offsets, i64* out_walks) {
    std::unordered_set<i64> seen;
    for (i64 m = 0; m < n_rows; ++m) {
        i64 b = rows[5 * m], e = rows[5 * m + 1], L = rows[5 * m + 2];
        i64 c0 = rows[5 * m + 3];
        i64* w0 = out_walks + out_offsets[m];           // comp-0 walks
        i64* w1 = w0 + c0 * L;                          // comp-1 walks
        i64 k0 = 0, k1 = 0;
        seen.clear();
        for (i64 q = b; q <= e; ++q) {
            i64 p = sa[q];
            i64 ck = ((i64)comp[p] << 56) | ids[p];
            if (!seen.insert(ck).second) continue;
            i64* dst = comp[p] == 0 ? w0 + (k0++) * L : w1 + (k1++) * L;
            for (i64 t = 0; t < L; ++t) dst[t] = ids[p + t];
        }
    }
}

}  // extern "C"
