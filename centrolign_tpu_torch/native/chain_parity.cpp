// Parity-exact sparse chaining: behavioral twins of the reference's
// sparse_chain_dp (reference anchorer.hpp:1511-1750) and
// sparse_affine_chain_dp (anchorer.hpp:1812-2470), including:
//  - float32 DP values with the reference's operation order,
//  - MaxSearchTree / OrthogonalMaxSearchTree replicas (identical static
//    layout, subtree-max tie rules, and range_max traversal order,
//    max_search_tree.hpp / orthogonal_max_search_tree.hpp),
//  - MatchBank iteration / starts_on / ends_on order (match_bank.hpp),
//  - ForwardEdges construction order (forward_edges.hpp:36-70),
//  - the reference's LIFO-stack topological order (topological_order.hpp:12),
//  - first-writer-wins update_dp ties (match_bank.hpp:171-183).
// These encode the tie-breaking that byte-identical CIGAR output depends on
// (repetitive DNA produces many equal-scoring chains).

#include <cstdint>
#include <malloc.h>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>
#include <cmath>
#include <unordered_set>
#include <array>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <deque>

namespace {

using i64 = int64_t;
using u64 = uint64_t;
using u32 = uint32_t;
using f32 = float;

constexpr f32 MININF = std::numeric_limits<f32>::lowest();
constexpr u64 ID_MAX = std::numeric_limits<u64>::max();

// ------------------------------------------------------------------ graph

struct CsrGraph {
    i64 V;
    const i64* nptr;
    const i64* nind;
    const i64* pptr;
    const i64* pind;
};

// reference topological_order.hpp:12 — LIFO stack Kahn: initial sources
// pushed ascending, successors pushed in adjacency order, popped from back.
static std::vector<i64> ref_topo_order(const CsrGraph& g) {
    std::vector<i64> order;
    order.reserve(g.V);
    std::vector<i64> stack, indeg(g.V);
    for (i64 v = 0; v < g.V; ++v) {
        indeg[v] = g.pptr[v + 1] - g.pptr[v];
        if (indeg[v] == 0) stack.push_back(v);
    }
    while (!stack.empty()) {
        i64 v = stack.back();
        stack.pop_back();
        order.push_back(v);
        for (i64 k = g.nptr[v]; k < g.nptr[v + 1]; ++k) {
            if (--indeg[g.nind[k]] == 0) stack.push_back(g.nind[k]);
        }
    }
    return order;
}

// ------------------------------------------------------------------ xmerge

// unified PathMerge/ChainMerge view over caller-provided arrays.
// TI is the storage width of the big (V x C) tables — int32 below 2^31
// nodes (the reference's uint32 tier, core.hpp:296-357), int64 beyond;
// accessors promote to i64 so the engines are width-agnostic.
template <typename TI>
struct XMergeView {
    i64 V, C;
    const TI* table;      // (V, C) last-to-reach index, -1 = none
    const TI* index_on_;  // (C, V) index of node on chain, -1 = not on it
    const i64* chain_id;   // (V,) primary chain (PathMerge: path_head)
    const i64* chain_off;  // (C+1,) offsets into chain_nodes
    const i64* chain_nodes;

    inline i64 predecessor_index(i64 v, i64 p) const { return table[v * C + p]; }
    inline i64 index_on(i64 v, i64 p) const { return index_on_[p * V + v]; }
    inline i64 node_at(i64 p, i64 idx) const {
        return chain_nodes[chain_off[p] + idx];
    }
    inline i64 chain_size(i64 p) const { return chain_off[p + 1] - chain_off[p]; }
    inline void chain(i64 v, i64* c, i64* idx) const {
        *c = chain_id[v];
        *idx = (*c == -1) ? -1 : index_on(v, *c);
    }
    inline bool reachable(i64 from, i64 to) const {
        i64 cf = chain_id[from];
        if (cf == -1) return false;
        i64 last = table[to * C + cf];
        return last != -1 && index_on(from, cf) <= last;
    }
    // chains containing v, in the reference PathMerge linked-list order:
    // descending chain id (path_head = last path to register the node)
    inline void chains_on(i64 v, std::vector<i64>& out) const {
        out.clear();
        for (i64 p = C - 1; p >= 0; --p) {
            if (index_on(v, p) != -1) out.push_back(p);
        }
    }
};

// ------------------------------------------------------------------ bank

struct MatchSetView {
    i64 n1, n2, L;
    const i64* walks1;  // (n1, L)
    const i64* walks2;  // (n2, L)
    i64 count1, count2, full_length;
    f32 weight;         // anchor weight (precomputed by caller, f64->f32)
};

struct MatchBankP {
    const std::vector<MatchSetView>* sets;
    i64 num_sets;  // only the first num_sets participate
    std::vector<u64> set_base;    // global pair-id base per set
    u64 total_pairs = 0;
    std::vector<f32> dp;
    std::vector<u64> bp;
    // per node: (set, walk1) lists in insertion order (set-major, then walk1)
    std::vector<std::vector<std::pair<i64, i64>>> starts, ends;
    const std::unordered_set<u64>* masked;  // packed (set<<40)|(i<<20)|j or null

    static inline u64 mask_key(i64 s, i64 i, i64 j) {
        return (u64(s) << 40) | (u64(i) << 20) | u64(j);
    }

    MatchBankP(i64 V1, const std::vector<MatchSetView>& sets_, i64 num_sets_,
               const std::unordered_set<u64>* masked_)
        : sets(&sets_), num_sets(num_sets_), starts(V1), ends(V1),
          masked(masked_) {
        set_base.resize(num_sets + 1, 0);
        for (i64 s = 0; s < num_sets; ++s) {
            const auto& ms = sets_[s];
            set_base[s + 1] = set_base[s] + u64(ms.n1) * ms.n2;
            for (i64 j = 0; j < ms.n1; ++j) {
                starts[ms.walks1[j * ms.L]].emplace_back(s, j);
                ends[ms.walks1[j * ms.L + ms.L - 1]].emplace_back(s, j);
            }
        }
        total_pairs = set_base[num_sets];
        dp.assign(total_pairs, MININF);
        bp.assign(total_pairs, ID_MAX);
    }

    inline u64 id_of(i64 s, i64 i, i64 j) const {
        return set_base[s] + u64(i) * (*sets)[s].n2 + j;
    }
    inline void indexes_of(u64 id, i64* s, i64* i, i64* j) const {
        i64 lo = 0, hi = num_sets;
        while (lo + 1 < hi) {
            i64 mid = (lo + hi) / 2;
            if (set_base[mid] <= id) lo = mid;
            else hi = mid;
        }
        *s = lo;
        u64 off = id - set_base[lo];
        *i = off / (*sets)[lo].n2;
        *j = off % (*sets)[lo].n2;
    }
    inline const i64* walk1(u64 id, i64* L) const {
        i64 s, i, j;
        indexes_of(id, &s, &i, &j);
        const auto& ms = (*sets)[s];
        *L = ms.L;
        return ms.walks1 + i * ms.L;
    }
    inline const i64* walk2(u64 id, i64* L) const {
        i64 s, i, j;
        indexes_of(id, &s, &i, &j);
        const auto& ms = (*sets)[s];
        *L = ms.L;
        return ms.walks2 + j * ms.L;
    }
    // first-writer-wins on exact ties (match_bank.hpp:177)
    inline void update_dp(u64 id, f32 value, u64 traceback) {
        if (value > dp[id]) {
            dp[id] = value;
            bp[id] = traceback;
        }
    }
    template <class F>
    inline void for_each(const F& f) const {  // begin()..end() order
        for (i64 s = 0; s < num_sets; ++s) {
            const auto& ms = (*sets)[s];
            for (i64 i = 0; i < ms.n1; ++i) {
                for (i64 j = 0; j < ms.n2; ++j) {
                    if (masked && masked->count(mask_key(s, i, j))) continue;
                    f(id_of(s, i, j), s, i, j);
                }
            }
        }
    }
    template <class F>
    inline void for_starts_on(i64 node, const F& f) const {
        for (const auto& se : starts[node]) {
            const auto& ms = (*sets)[se.first];
            for (i64 k = 0; k < ms.n2; ++k) {
                if (masked && masked->count(mask_key(se.first, se.second, k)))
                    continue;
                f(id_of(se.first, se.second, k), se.first, se.second, k);
            }
        }
    }
    template <class F>
    inline void for_ends_on(i64 node, const F& f) const {
        for (const auto& se : ends[node]) {
            const auto& ms = (*sets)[se.first];
            for (i64 k = 0; k < ms.n2; ++k) {
                if (masked && masked->count(mask_key(se.first, se.second, k)))
                    continue;
                f(id_of(se.first, se.second, k), se.first, se.second, k);
            }
        }
    }
};

// ------------------------------------------------------- max search tree

// Replica of MaxSearchTree (max_search_tree.hpp): complete binary tree in
// heap layout, keys assigned by in-order traversal over the sorted data;
// subtree_max and range_max use strict > everywhere. V is a comparable
// value type (float, or (float, idx) pair for cross trees).
template <typename K, typename V>
struct MaxTreeP {
    std::vector<K> key;
    std::vector<V> value;
    std::vector<u32> submax;  // tree sizes are < 2^32 by construction

    static inline i64 left(i64 x) { return 2 * x + 1; }
    static inline i64 right(i64 x) { return 2 * x + 2; }
    static inline i64 parent(i64 x) { return (x - 1) / 2; }
    inline i64 size() const { return (i64)key.size(); }
    inline bool empty() const { return key.empty(); }

    void build(std::vector<std::pair<K, V>>& data) {
        key.resize(data.size());
        value.resize(data.size());
        submax.resize(data.size());
        if (data.empty()) return;
        std::stable_sort(data.begin(), data.end(),
                         [](const std::pair<K, V>& a, const std::pair<K, V>& b) {
                             return a.first < b.first;
                         });
        i64 vec_idx = 0;
        std::vector<std::pair<i64, bool>> stack;
        stack.emplace_back(0, false);
        while (!stack.empty()) {
            auto& top = stack.back();
            if (!top.second) {
                top.second = true;
                i64 l = left(top.first);
                if (l < size()) stack.emplace_back(l, false);
            } else {
                key[top.first] = data[vec_idx].first;
                value[top.first] = data[vec_idx].second;
                submax[top.first] = (u32)top.first;
                ++vec_idx;
                i64 r = right(top.first);
                stack.pop_back();
                if (r < size()) stack.emplace_back(r, false);
            }
        }
        for (i64 i = size() - 1; i > 0; --i) {
            i64 par = parent(i);
            if (value[submax[i]] > value[submax[par]]) submax[par] = submax[i];
        }
    }

    i64 find(const K& k) const {
        i64 cursor = 0;
        while (cursor < size()) {
            if (key[cursor] == k) return cursor;
            cursor = (key[cursor] > k) ? left(cursor) : right(cursor);
        }
        return size();
    }

    void reidentify(i64 x) {
        i64 nm = x;
        i64 l = left(x), r = right(x);
        if (l < size() && value[submax[l]] > value[nm]) nm = submax[l];
        if (r < size() && value[submax[r]] > value[nm]) nm = submax[r];
        submax[x] = (u32)nm;
    }

    void update(i64 i, const V& nv) {
        if (nv > value[submax[i]]) {
            submax[i] = (u32)i;
            i64 here = i;
            while (here != 0) {
                here = parent(here);
                if (nv > value[submax[here]]) submax[here] = (u32)i;
                else break;
            }
            value[i] = nv;
        } else {
            value[i] = nv;
            if (submax[i] == (u32)i) {
                reidentify(i);
                i64 here = i;
                while (here != 0) {
                    here = parent(here);
                    if (submax[here] != i) break;
                    reidentify(here);
                }
            }
        }
    }

    // max over [lo, hi); returns node index or size() if empty range
    // (max_search_tree.hpp:361-445)
    i64 range_max(const K& lo, const K& hi) const {
        i64 cursor = 0;
        while (cursor < size() && (key[cursor] < lo || key[cursor] >= hi)) {
            cursor = (key[cursor] >= lo) ? left(cursor) : right(cursor);
        }
        if (cursor >= size()) return size();
        i64 max_idx = cursor;
        i64 rc = right(cursor), lc = left(cursor);
        while (lc < size()) {
            if (key[lc] >= lo) {
                if (value[lc] > value[max_idx]) max_idx = lc;
                i64 r = right(lc);
                if (r < size() && value[submax[r]] > value[max_idx])
                    max_idx = submax[r];
                lc = left(lc);
            } else {
                lc = right(lc);
            }
        }
        while (rc < size()) {
            if (key[rc] < hi) {
                if (value[rc] > value[max_idx]) max_idx = rc;
                i64 l = left(rc);
                if (l < size() && value[submax[l]] > value[max_idx])
                    max_idx = submax[l];
                rc = right(rc);
            } else {
                rc = left(rc);
            }
        }
        return max_idx;
    }
};

// ------------------------------------- multi-channel max/ortho trees
// The 2*NumPW piecewise trees share keys, layout, and update positions; only
// their values diverge. One structure with NCH value channels preserves the
// per-channel semantics of 6 independent reference trees while building the
// static structure once.

template <typename K, int NCH>
struct MultiMaxTreeP {
    // Value semantics are the reference's (f32 value, i64 outer-index)
    // pairs compared lexicographically — but the outer index of a tree
    // position NEVER changes after build (updates always re-install the
    // same index), so it is stored once (`ident`, u32) instead of once per
    // channel, and per-channel storage is a bare f32 + u32 submax. This
    // shrinks a hot entry from 160 B to ~60 B; every comparison below
    // reproduces the (value, index) lexicographic order exactly.
    using CrossVal = std::pair<f32, i64>;
    std::vector<K> key;
    std::vector<u32> ident;
    // Entry values are NOT copied into the cross tree: `ident` indexes the
    // owning ortho tree's per-node channel blocks (`ov`), which the caller
    // updates BEFORE the cross submax fix. This halves the dominant memory
    // term of the affine chain DP (cross occurrences are O(E log E); at the
    // 50-seq root join the stored-value variant exceeded 115 GB).
    const std::array<f32, NCH>* ov = nullptr;
    std::vector<std::array<u32, NCH>> sm;

    inline f32 value_at(int c, i64 i) const { return ov[ident[i]][c]; }

    static inline i64 left(i64 x) { return 2 * x + 1; }
    static inline i64 right(i64 x) { return 2 * x + 2; }
    static inline i64 parent(i64 x) { return (x - 1) / 2; }
    inline i64 size() const { return (i64)key.size(); }
    inline bool empty() const { return key.empty(); }

    // (value[c][a], ident[a]) > (value[c][b], ident[b]) lexicographically
    inline bool gtr(int c, i64 a, i64 b) const {
        f32 va = ov[ident[a]][c], vb = ov[ident[b]][c];
        return va > vb || (va == vb && ident[a] > ident[b]);
    }
    // (v, id) > (value[c][b], ident[b])
    inline bool gtr_vi(int c, f32 v, u32 id, i64 b) const {
        f32 vb = ov[ident[b]][c];
        return v > vb || (v == vb && id > ident[b]);
    }

    // build from data ALREADY sorted by key (ties in caller's stable
    // order): skips the sort, computes channel 0's submax spine once and
    // copies it — every channel starts from the identical (value, ident)
    // entries, so their built states are identical by construction.
    template <typename KIn>
    void build_from_sorted(const std::vector<std::pair<KIn, CrossVal>>& data,
                           const std::array<f32, NCH>* outer_vals) {
        ov = outer_vals;
        key.resize(data.size());
        ident.resize(data.size());
        sm.resize(data.size());
        if (data.empty()) return;
        i64 vec_idx = 0;
        std::vector<std::pair<i64, bool>> stack;
        stack.emplace_back(0, false);
        while (!stack.empty()) {
            auto& top = stack.back();
            if (!top.second) {
                top.second = true;
                i64 l = left(top.first);
                if (l < size()) stack.emplace_back(l, false);
            } else {
                key[top.first] = (K)data[vec_idx].first;
                ident[top.first] = (u32)data[vec_idx].second.second;
                sm[top.first][0] = (u32)top.first;
                ++vec_idx;
                i64 r = right(top.first);
                stack.pop_back();
                if (r < size()) stack.emplace_back(r, false);
            }
        }
        for (i64 i = size() - 1; i > 0; --i) {
            i64 par = parent(i);
            if (gtr(0, sm[i][0], sm[par][0]))
                sm[par][0] = sm[i][0];
        }
        for (i64 i = 0; i < size(); ++i) {
            for (int c = 1; c < NCH; ++c) {
                sm[i][c] = sm[i][0];
            }
        }
    }

    void reidentify(int c, i64 x) {
        i64 nm = x;
        i64 l = left(x), r = right(x);
        if (l < size() && gtr(c, sm[l][c], nm)) nm = sm[l][c];
        if (r < size() && gtr(c, sm[r][c], nm)) nm = sm[r][c];
        sm[x][c] = (u32)nm;
    }

    // The caller has ALREADY written v into ov[id][c]; old_self is the
    // value it replaced. Comparisons against this same entry (the only one
    // whose stored value changed) use old_self — reproducing exactly the
    // value-carrying variant, which wrote its copy only after the compare.
    void update(int c, i64 i, f32 v, u32 id, f32 old_self) {
        auto beats = [&](i64 node_pos) {
            if (ident[node_pos] == id)
                return v > old_self;  // (v,id) vs (old_self,id)
            return gtr_vi(c, v, id, node_pos);
        };
        if (beats(sm[i][c])) {
            sm[i][c] = (u32)i;
            i64 here = i;
            while (here != 0) {
                here = parent(here);
                if (beats(sm[here][c])) sm[here][c] = (u32)i;
                else break;
            }
        } else {
            if (sm[i][c] == (u32)i) {
                reidentify(c, i);
                i64 here = i;
                while (here != 0) {
                    here = parent(here);
                    if (sm[here][c] != (u32)i) break;
                    reidentify(c, here);
                }
            }
        }
    }

    i64 range_max(int c, const K& lo, const K& hi) const {
        i64 cursor = 0;
        while (cursor < size() && (key[cursor] < lo || key[cursor] >= hi)) {
            cursor = (key[cursor] >= lo) ? left(cursor) : right(cursor);
        }
        if (cursor >= size()) return size();
        i64 max_idx = cursor;
        i64 rc = right(cursor), lc = left(cursor);
        while (lc < size()) {
            if (key[lc] >= lo) {
                if (gtr(c, lc, max_idx)) max_idx = lc;
                i64 r = right(lc);
                if (r < size() && gtr(c, sm[r][c], max_idx))
                    max_idx = sm[r][c];
                lc = left(lc);
            } else {
                lc = right(lc);
            }
        }
        while (rc < size()) {
            if (key[rc] < hi) {
                if (gtr(c, rc, max_idx)) max_idx = rc;
                i64 l = left(rc);
                if (l < size() && gtr(c, sm[l][c], max_idx))
                    max_idx = sm[l][c];
                rc = right(rc);
            } else {
                rc = left(rc);
            }
        }
        return max_idx;
    }

    // Batched variant: one traversal answers `m` channels at once. The
    // walk depends only on keys (shared by every channel), and each
    // channel performs exactly the comparison sequence of its
    // single-channel range_max — including the lexicographic CrossVal
    // tie-breaking — so per-channel results are identical, at ~1/m of
    // the pointer-chasing.
    void range_max_multi(int m, const int* chans, const K& lo, const K& hi,
                         i64* out) const {
        i64 cursor = 0;
        while (cursor < size() && (key[cursor] < lo || key[cursor] >= hi)) {
            cursor = (key[cursor] >= lo) ? left(cursor) : right(cursor);
        }
        if (cursor >= size()) {
            for (int k = 0; k < m; ++k) out[k] = size();
            return;
        }
        i64 max_idx[8];
        for (int k = 0; k < m; ++k) max_idx[k] = cursor;
        i64 rc = right(cursor), lc = left(cursor);
        while (lc < size()) {
            if (key[lc] >= lo) {
                for (int k = 0; k < m; ++k) {
                    if (gtr(chans[k], lc, max_idx[k])) max_idx[k] = lc;
                }
                i64 r = right(lc);
                if (r < size()) {
                    for (int k = 0; k < m; ++k) {
                        i64 smr = sm[r][chans[k]];
                        if (gtr(chans[k], smr, max_idx[k])) max_idx[k] = smr;
                    }
                }
                lc = left(lc);
            } else {
                lc = right(lc);
            }
        }
        while (rc < size()) {
            if (key[rc] < hi) {
                for (int k = 0; k < m; ++k) {
                    if (gtr(chans[k], rc, max_idx[k])) max_idx[k] = rc;
                }
                i64 l = left(rc);
                if (l < size()) {
                    for (int k = 0; k < m; ++k) {
                        i64 sml = sm[l][chans[k]];
                        if (gtr(chans[k], sml, max_idx[k])) max_idx[k] = sml;
                    }
                }
                rc = right(rc);
            } else {
                rc = left(rc);
            }
        }
        for (int k = 0; k < m; ++k) out[k] = max_idx[k];
    }
};

// ------------------------------------------- orthogonal max search tree

// Replica of OrthogonalMaxSearchTree: outer tree over (key1, key2) with
// per-node cross trees over key2 holding (value, outer index) pairs.
template <typename K1, typename K2>
struct OrthoTreeP {
    using CrossVal = std::pair<f32, i64>;  // lexicographic value compare
    std::vector<K1> key1;
    std::vector<K2> key2;
    std::vector<f32> value;
    std::vector<MaxTreeP<K2, CrossVal>> cross;
    // for update: per outer node, its entry position in each ancestor's
    // cross tree (root-downward order not needed; we walk i -> root)
    std::vector<std::vector<std::pair<i64, i64>>> cross_pos;  // (ancestor, pos)

    static inline i64 left(i64 x) { return 2 * x + 1; }
    static inline i64 right(i64 x) { return 2 * x + 2; }
    static inline i64 parent(i64 x) { return (x - 1) / 2; }
    inline i64 size() const { return (i64)key1.size(); }

    void build(std::vector<std::tuple<K1, K2, f32>>& data) {
        i64 n = (i64)data.size();
        key1.resize(n);
        key2.resize(n);
        value.resize(n);
        cross.resize(n);
        cross_pos.assign(n, {});
        if (!n) return;
        std::stable_sort(data.begin(), data.end());
        std::vector<i64> indexes(n);
        {
            i64 vec_idx = 0;
            std::vector<std::pair<i64, bool>> stack;
            stack.emplace_back(0, false);
            while (!stack.empty()) {
                auto& top = stack.back();
                if (!top.second) {
                    top.second = true;
                    i64 l = left(top.first);
                    if (l < n) stack.emplace_back(l, false);
                } else {
                    indexes[vec_idx] = top.first;
                    key1[top.first] = std::get<0>(data[vec_idx]);
                    key2[top.first] = std::get<1>(data[vec_idx]);
                    value[top.first] = std::get<2>(data[vec_idx]);
                    ++vec_idx;
                    i64 r = right(top.first);
                    stack.pop_back();
                    if (r < n) stack.emplace_back(r, false);
                }
            }
        }
        // outer spines never get queried; no cross trees there
        std::vector<bool> make_cross(n, true);
        for (i64 c = 0; c < n; c = left(c)) make_cross[c] = false;
        for (i64 c = right(0); c < n; c = right(c)) make_cross[c] = false;

        // depth-first divvy (orthogonal_max_search_tree.hpp:186-240)
        struct Frame {
            i64 node;
            std::vector<std::tuple<K1, K2, f32>> vals;
            std::vector<i64> idxs;
        };
        std::vector<Frame> stack;
        stack.push_back({0, data, std::move(indexes)});
        while (!stack.empty()) {
            Frame fr = std::move(stack.back());
            stack.pop_back();
            i64 nno = fr.node;
            std::tuple<K1, K2, f32> pivot(key1[nno], key2[nno], value[nno]);
            std::vector<std::tuple<K1, K2, f32>> lv, rv;
            std::vector<i64> li, ri;
            std::vector<std::pair<K2, CrossVal>> cvals;
            cvals.reserve(fr.vals.size());
            for (size_t i = 0; i < fr.vals.size(); ++i) {
                const auto& val = fr.vals[i];
                cvals.emplace_back(std::get<1>(val),
                                   CrossVal(std::get<2>(val), fr.idxs[i]));
                if (val < pivot) {
                    lv.push_back(val);
                    li.push_back(fr.idxs[i]);
                } else if (val > pivot) {
                    rv.push_back(val);
                    ri.push_back(fr.idxs[i]);
                }
            }
            if (make_cross[nno]) {
                cross[nno].build(cvals);
                // record each member's position for O(1) update lookups
                for (i64 pos = 0; pos < cross[nno].size(); ++pos) {
                    cross_pos[cross[nno].value[pos].second].emplace_back(nno,
                                                                         pos);
                }
            }
            i64 l = left(nno);
            if (l < n) {
                stack.push_back({l, std::move(lv), std::move(li)});
                i64 r = right(nno);
                if (r < n) stack.push_back({r, std::move(rv), std::move(ri)});
            }
        }
    }

    i64 find(const K1& k1, const K2& k2) const {
        i64 cursor = 0;
        while (cursor < size()) {
            if (key1[cursor] == k1 && key2[cursor] == k2) return cursor;
            if (std::pair<K1, K2>(key1[cursor], key2[cursor]) >
                std::pair<K1, K2>(k1, k2))
                cursor = left(cursor);
            else
                cursor = right(cursor);
        }
        return size();
    }

    void update(i64 i, f32 nv) {
        value[i] = nv;
        for (const auto& ap : cross_pos[i]) {
            cross[ap.first].update(ap.second, CrossVal(nv, i));
        }
    }

    // returns (found, outer_index_of_max) over [lo1,hi1) x [lo2,hi2)
    // (orthogonal_max_search_tree.hpp:343-545)
    bool range_max(const K1& lo1, const K1& hi1, const K2& lo2, const K2& hi2,
                   i64* out_idx) const {
        i64 cursor = 0;
        while (cursor < size() && (key1[cursor] < lo1 || key1[cursor] >= hi1)) {
            cursor = (key1[cursor] >= hi1) ? left(cursor) : right(cursor);
        }
        if (cursor >= size()) return false;
        bool max_at_idx = false, max_at_iter = false;
        i64 max_idx = -1;
        const MaxTreeP<K2, CrossVal>* max_tree = nullptr;
        i64 max_iter = -1;
        if (key2[cursor] >= lo2 && key2[cursor] < hi2) {
            max_at_idx = true;
            max_idx = cursor;
        }
        auto is_opt = [&](const CrossVal& val) -> bool {
            if (max_at_idx)
                return val > CrossVal(value[max_idx],
                                      std::numeric_limits<i64>::lowest());
            if (max_at_iter) return val > max_tree->value[max_iter];
            return true;
        };
        auto is_opt_f = [&](f32 v, i64 outer) -> bool {
            // outer-node comparisons in the reference compare raw values
            // with strict >, not (value, index) pairs
            if (max_at_idx) return v > value[max_idx];
            if (max_at_iter) return CrossVal(v, outer).first >
                                    max_tree->value[max_iter].first
                                ? true
                                : (v > max_tree->value[max_iter].first);
            return true;
        };
        (void)is_opt_f;
        i64 rc = right(cursor), lc = left(cursor);
        while (lc < size()) {
            if (key1[lc] >= lo1) {
                if (key2[lc] >= lo2 && key2[lc] < hi2) {
                    // reference: is_opt(value[lc]) with V=float
                    bool better;
                    if (max_at_idx) better = value[lc] > value[max_idx];
                    else if (max_at_iter)
                        better = value[lc] > max_tree->value[max_iter].first;
                    else better = true;
                    if (better) {
                        max_idx = lc;
                        max_at_idx = true;
                        max_at_iter = false;
                    }
                }
                i64 r = right(lc);
                if (r < size() && !cross[r].empty()) {
                    i64 it = cross[r].range_max(lo2, hi2);
                    if (it != cross[r].size()) {
                        bool better;
                        f32 v = cross[r].value[it].first;
                        if (max_at_idx) better = v > value[max_idx];
                        else if (max_at_iter)
                            better = v > max_tree->value[max_iter].first;
                        else better = true;
                        if (better) {
                            max_tree = &cross[r];
                            max_iter = it;
                            max_at_idx = false;
                            max_at_iter = true;
                        }
                    }
                }
                lc = left(lc);
            } else {
                lc = right(lc);
            }
        }
        while (rc < size()) {
            if (key1[rc] < hi1) {
                if (key2[rc] >= lo2 && key2[rc] < hi2) {
                    bool better;
                    if (max_at_idx) better = value[rc] > value[max_idx];
                    else if (max_at_iter)
                        better = value[rc] > max_tree->value[max_iter].first;
                    else better = true;
                    if (better) {
                        max_idx = rc;
                        max_at_idx = true;
                        max_at_iter = false;
                    }
                }
                i64 l = left(rc);
                if (l < size() && !cross[l].empty()) {
                    i64 it = cross[l].range_max(lo2, hi2);
                    if (it != cross[l].size()) {
                        bool better;
                        f32 v = cross[l].value[it].first;
                        if (max_at_idx) better = v > value[max_idx];
                        else if (max_at_iter)
                            better = v > max_tree->value[max_iter].first;
                        else better = true;
                        if (better) {
                            max_tree = &cross[l];
                            max_iter = it;
                            max_at_idx = false;
                            max_at_iter = true;
                        }
                    }
                }
                rc = right(rc);
            } else {
                rc = left(rc);
            }
        }
        if (max_at_idx) {
            *out_idx = max_idx;
            return true;
        }
        if (max_at_iter) {
            *out_idx = max_tree->value[max_iter].second;
            return true;
        }
        return false;
    }
};

// multi-channel orthogonal tree: shared keys/layout/positions, NCH values
template <typename K1, typename K2, int NCH>
struct MultiOrthoTreeP {
    using CrossVal = std::pair<f32, i64>;
    std::vector<K1> key1;
    std::vector<K2> key2;
    std::vector<std::array<f32, NCH>> value;  // per-node channel block
    std::vector<MultiMaxTreeP<u32, NCH>> cross;  // key2 offsets < 2^31
    // per outer node, its positions in each cross-bearing ancestor's tree
    // (CSR, bottom-up x -> root order). The ancestors themselves are NOT
    // stored — they are the parent chain of x filtered by make_cross (mc),
    // recovered arithmetically during updates.
    std::vector<std::vector<i64>> cross_pos;
    std::vector<u32> cp_ptr, cp_pos;
    std::vector<uint8_t> mc;

    static inline i64 left(i64 x) { return 2 * x + 1; }
    static inline i64 right(i64 x) { return 2 * x + 2; }
    static inline i64 parent(i64 x) { return (x - 1) / 2; }
    inline i64 size() const { return (i64)key1.size(); }

    void build(std::vector<std::tuple<K1, K2, f32>>& data) {
        i64 n = (i64)data.size();
        key1.resize(n);
        key2.resize(n);
        value.resize(n);
        cross.resize(n);
        cross_pos.assign(n, {});
        if (!n) return;
        std::stable_sort(data.begin(), data.end());
        std::vector<i64> indexes(n);
        {
            i64 vec_idx = 0;
            std::vector<std::pair<i64, bool>> stack;
            stack.emplace_back(0, false);
            while (!stack.empty()) {
                auto& top = stack.back();
                if (!top.second) {
                    top.second = true;
                    i64 l = left(top.first);
                    if (l < n) stack.emplace_back(l, false);
                } else {
                    indexes[vec_idx] = top.first;
                    key1[top.first] = std::get<0>(data[vec_idx]);
                    key2[top.first] = std::get<1>(data[vec_idx]);
                    for (int c = 0; c < NCH; ++c)
                        value[top.first][c] = std::get<2>(data[vec_idx]);
                    ++vec_idx;
                    i64 r = right(top.first);
                    stack.pop_back();
                    if (r < n) stack.emplace_back(r, false);
                }
            }
        }
        mc.assign(n, 1);
        for (i64 c = 0; c < n; c = left(c)) mc[c] = 0;
        for (i64 c = right(0); c < n; c = right(c)) mc[c] = 0;

        // Each node's subtree is a CONTIGUOUS RANGE of the sorted data (the
        // in-order fill above guarantees it), so the reference's downward
        // divvy-by-pivot is replaced with range recursion: no element
        // copies, and each node's key2-sorted cross input is produced by
        // stably merging its children's lists around the pivot. Ties in
        // key2 resolve by sorted position — exactly the order the
        // reference's per-node stable_sort of the (position-ordered)
        // frame produces — so every cross tree is built from the
        // identical entry sequence.
        std::vector<i64> cnt(n, 1);
        for (i64 i = n - 1; i >= 1; --i) cnt[parent(i)] += cnt[i];
        _divvy(0, 0, n, data, indexes, cnt);
        // flatten memberships to CSR and free the nested vectors
        cp_ptr.assign(n + 1, 0);
        for (i64 i = 0; i < n; ++i) cp_ptr[i + 1] = cp_ptr[i] + (u32)cross_pos[i].size();
        cp_pos.resize(cp_ptr[n]);
        for (i64 i = 0; i < n; ++i) {
            u32 base = cp_ptr[i];
            for (size_t t = 0; t < cross_pos[i].size(); ++t) {
                cp_pos[base + t] = (u32)cross_pos[i][t];
            }
        }
        cross_pos.clear();
        cross_pos.shrink_to_fit();
    }

    // key2-sorted subtree list of node x (sorted range [lo, hi)); builds
    // the cross tree at x on the way up. Recursion depth = tree height
    // (the layout is a complete binary tree: <= ~21 for the reference's
    // 1.25M match-pair budget).
    std::vector<std::pair<K2, CrossVal>> _divvy(
            i64 x, i64 lo, i64 hi,
            const std::vector<std::tuple<K1, K2, f32>>& data,
            const std::vector<i64>& indexes,
            const std::vector<i64>& cnt) {
        i64 n = size();
        i64 l = left(x), r = right(x);
        i64 p = lo + (l < n ? cnt[l] : 0);
        std::vector<std::pair<K2, CrossVal>> lv, rv;
        if (l < n) lv = _divvy(l, lo, p, data, indexes, cnt);
        if (r < n) rv = _divvy(r, p + 1, hi, data, indexes, cnt);
        std::pair<K2, CrossVal> piv(
            std::get<1>(data[p]),
            CrossVal(std::get<2>(data[p]), indexes[p]));
        std::vector<std::pair<K2, CrossVal>> out;
        out.reserve(hi - lo);
        size_t i = 0, j = 0;
        bool piv_in = false;
        // 3-way stable merge by key2; ties keep position order, which is
        // lv (positions < p), then piv, then rv (positions > p)
        while (i < lv.size() || j < rv.size() || !piv_in) {
            if (i < lv.size()
                && (piv_in || !(piv.first < lv[i].first))
                && (j >= rv.size() || !(rv[j].first < lv[i].first))) {
                out.push_back(lv[i++]);
            } else if (!piv_in
                       && (j >= rv.size() || !(rv[j].first < piv.first))) {
                out.push_back(piv);
                piv_in = true;
            } else {
                out.push_back(rv[j++]);
            }
        }
        if (mc[x]) {
            cross[x].build_from_sorted(out, value.data());
            for (i64 pos = 0; pos < cross[x].size(); ++pos) {
                cross_pos[cross[x].ident[pos]].push_back(pos);
            }
        }
        return out;
    }

    i64 find(const K1& k1, const K2& k2) const {
        i64 cursor = 0;
        while (cursor < size()) {
            if (key1[cursor] == k1 && key2[cursor] == k2) return cursor;
            if (std::pair<K1, K2>(key1[cursor], key2[cursor]) >
                std::pair<K1, K2>(k1, k2))
                cursor = left(cursor);
            else
                cursor = right(cursor);
        }
        return size();
    }

    void update(int c, i64 i, f32 nv) {
        int chans[1] = {c};
        f32 nvs[1] = {nv};
        update_multi(1, chans, i, nvs);
    }

    bool range_max(int ch, const K1& lo1, const K1& hi1, const K2& lo2,
                   const K2& hi2, i64* out_idx) const {
        auto val = [&](i64 i) -> f32 { return value[i][ch]; };
        i64 cursor = 0;
        while (cursor < size() && (key1[cursor] < lo1 || key1[cursor] >= hi1)) {
            cursor = (key1[cursor] >= hi1) ? left(cursor) : right(cursor);
        }
        if (cursor >= size()) return false;
        bool max_at_idx = false, max_at_iter = false;
        i64 max_idx = -1;
        const MultiMaxTreeP<u32, NCH>* max_tree = nullptr;
        i64 max_iter = -1;
        if (key2[cursor] >= lo2 && key2[cursor] < hi2) {
            max_at_idx = true;
            max_idx = cursor;
        }
        auto cur_val = [&]() -> f32 {
            return max_at_idx ? val(max_idx)
                              : max_tree->value_at(ch, max_iter);
        };
        i64 rc = right(cursor), lc = left(cursor);
        while (lc < size()) {
            if (key1[lc] >= lo1) {
                if (key2[lc] >= lo2 && key2[lc] < hi2) {
                    bool better = (!max_at_idx && !max_at_iter) ||
                                  val(lc) > cur_val();
                    if (better) {
                        max_idx = lc;
                        max_at_idx = true;
                        max_at_iter = false;
                    }
                }
                i64 r = right(lc);
                if (r < size() && !cross[r].empty()) {
                    i64 it = cross[r].range_max(ch, (u32)lo2, (u32)hi2);
                    if (it != cross[r].size()) {
                        f32 v = cross[r].value_at(ch, it);
                        bool better = (!max_at_idx && !max_at_iter) ||
                                      v > cur_val();
                        if (better) {
                            max_tree = &cross[r];
                            max_iter = it;
                            max_at_idx = false;
                            max_at_iter = true;
                        }
                    }
                }
                lc = left(lc);
            } else {
                lc = right(lc);
            }
        }
        while (rc < size()) {
            if (key1[rc] < hi1) {
                if (key2[rc] >= lo2 && key2[rc] < hi2) {
                    bool better = (!max_at_idx && !max_at_iter) ||
                                  val(rc) > cur_val();
                    if (better) {
                        max_idx = rc;
                        max_at_idx = true;
                        max_at_iter = false;
                    }
                }
                i64 l = left(rc);
                if (l < size() && !cross[l].empty()) {
                    i64 it = cross[l].range_max(ch, (u32)lo2, (u32)hi2);
                    if (it != cross[l].size()) {
                        f32 v = cross[l].value_at(ch, it);
                        bool better = (!max_at_idx && !max_at_iter) ||
                                      v > cur_val();
                        if (better) {
                            max_tree = &cross[l];
                            max_iter = it;
                            max_at_idx = false;
                            max_at_iter = true;
                        }
                    }
                }
                rc = right(rc);
            } else {
                rc = left(rc);
            }
        }
        if (max_at_idx) {
            *out_idx = max_idx;
            return true;
        }
        if (max_at_iter) {
            *out_idx = max_tree->ident[max_iter];
            return true;
        }
        return false;
    }

    // Batched variant of range_max over `m` channels sharing one (key1,
    // key2) rectangle: the outer walk and the inner cross-tree walks are
    // key-only (identical across channels), so they run once; each channel
    // replays exactly its single-channel comparison sequence against the
    // shared visit order, yielding bit-identical winners per channel.
    // found[k]/out_idx[k] mirror the single-channel return/out parameter.
    void range_max_multi(int m, const int* chans, const K1& lo1,
                         const K1& hi1, const K2& lo2, const K2& hi2,
                         bool* found, i64* out_idx) const {
        i64 cursor = 0;
        while (cursor < size() && (key1[cursor] < lo1 || key1[cursor] >= hi1)) {
            cursor = (key1[cursor] >= hi1) ? left(cursor) : right(cursor);
        }
        if (cursor >= size()) {
            for (int k = 0; k < m; ++k) found[k] = false;
            return;
        }
        bool at_idx[8] = {false}, at_iter[8] = {false};
        i64 max_idx[8];
        const MultiMaxTreeP<u32, NCH>* max_tree[8];
        i64 max_iter[8];
        i64 its[8];
        if (key2[cursor] >= lo2 && key2[cursor] < hi2) {
            for (int k = 0; k < m; ++k) {
                at_idx[k] = true;
                max_idx[k] = cursor;
            }
        }
        auto consider_node = [&](i64 node) {
            if (key2[node] >= lo2 && key2[node] < hi2) {
                for (int k = 0; k < m; ++k) {
                    f32 v = value[node][chans[k]];
                    bool better = (!at_idx[k] && !at_iter[k]) ||
                                  v > (at_idx[k]
                                       ? value[max_idx[k]][chans[k]]
                                       : max_tree[k]->value_at(
                                             chans[k], max_iter[k]));
                    if (better) {
                        max_idx[k] = node;
                        at_idx[k] = true;
                        at_iter[k] = false;
                    }
                }
            }
        };
        auto consider_cross = [&](i64 sub) {
            if (sub < size() && !cross[sub].empty()) {
                cross[sub].range_max_multi(m, chans, (u32)lo2, (u32)hi2, its);
                for (int k = 0; k < m; ++k) {
                    if (its[k] == cross[sub].size()) continue;
                    f32 v = cross[sub].value_at(chans[k], its[k]);
                    bool better = (!at_idx[k] && !at_iter[k]) ||
                                  v > (at_idx[k]
                                       ? value[max_idx[k]][chans[k]]
                                       : max_tree[k]->value_at(
                                             chans[k], max_iter[k]));
                    if (better) {
                        max_tree[k] = &cross[sub];
                        max_iter[k] = its[k];
                        at_idx[k] = false;
                        at_iter[k] = true;
                    }
                }
            }
        };
        i64 rc = right(cursor), lc = left(cursor);
        while (lc < size()) {
            if (key1[lc] >= lo1) {
                consider_node(lc);
                consider_cross(right(lc));
                lc = left(lc);
            } else {
                lc = right(lc);
            }
        }
        while (rc < size()) {
            if (key1[rc] < hi1) {
                consider_node(rc);
                consider_cross(left(rc));
                rc = right(rc);
            } else {
                rc = left(rc);
            }
        }
        for (int k = 0; k < m; ++k) {
            if (at_idx[k]) {
                found[k] = true;
                out_idx[k] = max_idx[k];
            } else if (at_iter[k]) {
                found[k] = true;
                out_idx[k] = max_tree[k]->ident[max_iter[k]];
            } else {
                found[k] = false;
            }
        }
    }

    // Batched update: one cross_pos walk applies every channel's
    // single-channel update at each ancestor (channels are independent, so
    // per-channel results are unchanged; the ancestor chain is only walked
    // once instead of once per channel).
    void update_multi(int m, const int* chans, i64 i, const f32* nv) {
        f32 old[NCH];
        for (int k = 0; k < m; ++k) {
            old[k] = value[i][chans[k]];
            value[i][chans[k]] = nv[k];
        }
        // memberships ride the parent chain bottom-up, filtered by mc —
        // the same order _divvy recorded the positions in
        u32 t = cp_ptr[i];
        for (i64 a = i;; a = parent(a)) {
            if (mc[a]) {
                auto& ct = cross[a];
                i64 pos = cp_pos[t++];
                for (int k = 0; k < m; ++k)
                    ct.update(chans[k], pos, nv[k], (u32)i, old[k]);
            }
            if (a == 0) break;
        }
    }
};

// -------------------------------------------------------- forward edges

// reference forward_edges.hpp:36-70 + generate_forward_edge_masks
// (anchorer.hpp:1752-1810)
template <typename TI>
static std::vector<std::vector<std::pair<i64, i64>>> build_forward_edges(
        const CsrGraph& g1, const XMergeView<TI>& xm1,
        const std::vector<MatchSetView>& sets, i64 num_sets) {
    std::vector<bool> have_start(g1.V, false), follow_end(g1.V, false);
    for (i64 s = 0; s < num_sets; ++s) {
        const auto& ms = sets[s];
        for (i64 j = 0; j < ms.n1; ++j)
            have_start[ms.walks1[j * ms.L]] = true;
    }
    for (i64 s = 0; s < num_sets; ++s) {
        const auto& ms = sets[s];
        for (i64 j = 0; j < ms.n1; ++j)
            follow_end[ms.walks1[j * ms.L + ms.L - 1]] = true;
    }
    std::vector<i64> queue;
    for (i64 v = 0; v < g1.V; ++v) {
        if (!follow_end[v]) continue;
        queue.push_back(v);
        while (!queue.empty()) {
            i64 here = queue.back();
            queue.pop_back();
            for (i64 k = g1.nptr[here]; k < g1.nptr[here + 1]; ++k) {
                i64 nx = g1.nind[k];
                if (!follow_end[nx]) {
                    follow_end[nx] = true;
                    queue.push_back(nx);
                }
            }
        }
    }
    std::vector<std::vector<std::pair<i64, i64>>> fwd(g1.V);
    for (i64 v = 0; v < g1.V; ++v) {
        if (!have_start[v]) continue;
        for (i64 p = 0; p < xm1.C; ++p) {
            i64 idx = xm1.predecessor_index(v, p);
            if (idx != -1) {
                i64 from = xm1.node_at(p, idx);
                if (follow_end[from]) fwd[from].emplace_back(v, p);
            }
        }
    }
    return fwd;
}

// ---------------------------------------------------------------- output

struct ChainOut {
    i64* rows;      // (cap, 5): set, idx1, idx2, gap_before, gap_after
    double* fvals;  // (cap, 3): score, gap_score_before, gap_score_after
    i64 cap;
};

}  // namespace

// Shared argument pack helpers live in Python; these entry points
// take fully flattened arrays.

// Sparse (free-gap) chaining, reference sparse_chain_dp.
// Returns chain length; rows get (set, idx1, idx2, 0, 0).
template <typename TI>
static i64 sparse_parity_impl(
        // graph1
        i64 V1, const i64* n1ptr, const i64* n1ind, const i64* p1ptr,
        const i64* p1ind, i64 V2,
        // match sets, flattened
        i64 num_sets_total, i64 num_sets, const i64* set_n1, const i64* set_n2,
        const i64* set_L, const i64* set_count1, const i64* set_count2,
        const i64* set_full_length, const double* set_weight,
        const i64* walks1_off, const i64* walks1_flat,
        const i64* walks2_off, const i64* walks2_flat,
        // xmerge views
        i64 C1, const TI* table1, const TI* index_on1, const i64* chainid1,
        const i64* choff1, const i64* chnodes1,
        i64 C2, const TI* table2, const TI* index_on2, const i64* chainid2,
        const i64* choff2, const i64* chnodes2,
        // sources/sinks (global anchoring); n<0 means null
        i64 ns1, const i64* sources1, i64 ns2, const i64* sources2,
        i64 nk1, const i64* sinks1, i64 nk2, const i64* sinks2,
        // masked matches (m, 3) or m=0
        i64 n_masked, const i64* masked_rows,
        i64 out_cap, i64* out_rows, double* out_fvals) {
    CsrGraph g1{V1, n1ptr, n1ind, p1ptr, p1ind};
    XMergeView<TI> xm1{V1, C1, table1, index_on1, chainid1, choff1, chnodes1};
    XMergeView<TI> xm2{V2, C2, table2, index_on2, chainid2, choff2, chnodes2};

    std::vector<MatchSetView> sets(num_sets_total);
    for (i64 s = 0; s < num_sets_total; ++s) {
        sets[s] = MatchSetView{
            set_n1[s], set_n2[s], set_L[s],
            walks1_flat + walks1_off[s], walks2_flat + walks2_off[s],
            set_count1[s], set_count2[s], set_full_length[s],
            f32(set_weight[s])};
        sets[s].walks1 = walks1_flat + walks1_off[s];
        sets[s].walks2 = walks2_flat + walks2_off[s];
    }
    std::unordered_set<u64> masked;
    for (i64 m = 0; m < n_masked; ++m) {
        masked.insert(MatchBankP::mask_key(
            masked_rows[3 * m], masked_rows[3 * m + 1], masked_rows[3 * m + 2]));
    }

    MatchBankP bank(V1, sets, num_sets, n_masked ? &masked : nullptr);

    using key_t = std::pair<i64, u64>;  // (chain2 index, match id)
    std::vector<std::vector<std::pair<key_t, f32>>> tree_data(C2);

    bank.for_each([&](u64 id, i64 s, i64 i, i64 j) {
        const auto& ms = sets[s];
        i64 end2 = ms.walks2[j * ms.L + ms.L - 1];
        i64 c2, idx2;
        xm2.chain(end2, &c2, &idx2);
        tree_data[c2].emplace_back(key_t(idx2, id), MININF);
        f32 weight = ms.weight;
        if (ns1 >= 0) {
            bool found1 = false, found2 = false;
            i64 st1 = ms.walks1[i * ms.L];
            i64 st2 = ms.walks2[j * ms.L];
            for (i64 a = 0; a < ns1 && !found1; ++a)
                if (sources1[a] == st1 || xm1.reachable(sources1[a], st1))
                    found1 = true;
            for (i64 a = 0; a < ns2 && !found2; ++a)
                if (sources2[a] == st2 || xm2.reachable(sources2[a], st2))
                    found2 = true;
            if (!found1 || !found2) weight = MININF;
        }
        bank.update_dp(id, weight, ID_MAX);
    });

    // one tree per (chain1, chain2); built once per chain2 and copied
    // (identical contents — all values start at mininf)
    std::vector<std::vector<MaxTreeP<key_t, f32>>> trees(C1);
    {
        std::vector<MaxTreeP<key_t, f32>> protos(C2);
        for (i64 b = 0; b < C2; ++b) protos[b].build(tree_data[b]);
        for (i64 a = 0; a < C1; ++a) trees[a] = protos;
    }

    auto fwd = build_forward_edges(g1, xm1, sets, num_sets);

    for (i64 node_id : ref_topo_order(g1)) {
        i64 chain1 = xm1.chain_id[node_id];
        bank.for_ends_on(node_id, [&](u64 id, i64 s, i64 i, i64 j) {
            const auto& ms = sets[s];
            i64 end2 = ms.walks2[j * ms.L + ms.L - 1];
            i64 c2, idx2;
            xm2.chain(end2, &c2, &idx2);
            auto& tree = trees[chain1][c2];
            i64 it = tree.find(key_t(idx2, id));
            f32 dp_val = bank.dp[id];
            if (tree.value[it] < dp_val) tree.update(it, dp_val);
        });
        for (const auto& edge : fwd[node_id]) {
            i64 fwd_id = edge.first;
            i64 echain1 = edge.second;
            bank.for_starts_on(fwd_id, [&](u64 id, i64 s, i64 i, i64 j) {
                const auto& ms = sets[s];
                f32 weight = ms.weight;
                i64 st2 = ms.walks2[j * ms.L];
                for (i64 c2 = 0; c2 < C2; ++c2) {
                    i64 pred2 = xm2.predecessor_index(st2, c2);
                    if (pred2 == -1) continue;
                    const auto& tree = trees[echain1][c2];
                    i64 it = tree.range_max(key_t(0, 0),
                                            key_t(pred2 + 1, 0));
                    if (it == tree.size()) continue;
                    f32 dp_weight = tree.value[it] + weight;
                    bank.update_dp(id, dp_weight, tree.key[it].second);
                }
            });
        }
    }

    // traceback (reference traceback_sparse_dp with final term)
    f32 opt_value = MININF;
    u64 opt_match = ID_MAX;
    bank.for_each([&](u64 id, i64 s, i64 i, i64 j) {
        f32 dp_val = bank.dp[id];
        f32 final_term = 0.0f;
        if (nk1 >= 0) {
            const auto& ms = sets[s];
            i64 l1 = ms.walks1[i * ms.L + ms.L - 1];
            i64 l2 = ms.walks2[j * ms.L + ms.L - 1];
            bool ok = false;
            for (i64 a = 0; a < nk1 && !ok; ++a)
                for (i64 b = 0; b < nk2 && !ok; ++b)
                    if ((sinks1[a] == l1 || xm1.reachable(l1, sinks1[a])) &&
                        (sinks2[b] == l2 || xm2.reachable(l2, sinks2[b])))
                        ok = true;
            final_term = ok ? 0.0f : MININF;
        }
        if (final_term == MININF) dp_val = final_term;
        else dp_val += final_term;
        if (dp_val > opt_value && dp_val > 0.0f) {
            opt_value = dp_val;
            opt_match = id;
        }
    });

    i64 n_out = 0;
    std::vector<u64> rev;
    for (u64 here = opt_match; here != ID_MAX; here = bank.bp[here])
        rev.push_back(here);
    std::reverse(rev.begin(), rev.end());
    for (u64 id : rev) {
        if (n_out >= out_cap) break;
        i64 s, i, j;
        bank.indexes_of(id, &s, &i, &j);
        i64* row = out_rows + 5 * n_out;
        row[0] = s; row[1] = i; row[2] = j; row[3] = 0; row[4] = 0;
        double* fv = out_fvals + 3 * n_out;
        fv[0] = set_weight[s];  // annotate_scores stores the double weight
        fv[1] = 0.0; fv[2] = 0.0;
        ++n_out;
    }
    return (i64)rev.size();
}

extern "C" {

// width-dispatched entry: table_width selects the (V x C) table storage
// (4 = int32, 8 = int64); all other arrays are int64
i64 chain_sparse_parity(
        i64 V1, const i64* n1ptr, const i64* n1ind, const i64* p1ptr,
        const i64* p1ind, i64 V2,
        i64 num_sets_total, i64 num_sets, const i64* set_n1, const i64* set_n2,
        const i64* set_L, const i64* set_count1, const i64* set_count2,
        const i64* set_full_length, const double* set_weight,
        const i64* walks1_off, const i64* walks1_flat,
        const i64* walks2_off, const i64* walks2_flat,
        i64 C1, const void* table1, const void* index_on1, const i64* chainid1,
        const i64* choff1, const i64* chnodes1,
        i64 C2, const void* table2, const void* index_on2, const i64* chainid2,
        const i64* choff2, const i64* chnodes2,
        i64 ns1, const i64* sources1, i64 ns2, const i64* sources2,
        i64 nk1, const i64* sinks1, i64 nk2, const i64* sinks2,
        i64 n_masked, const i64* masked_rows,
        int table_width,
        i64 out_cap, i64* out_rows, double* out_fvals) {
    if (table_width == 4) {
        return sparse_parity_impl<int32_t>(
            V1, n1ptr, n1ind, p1ptr, p1ind, V2,
            num_sets_total, num_sets, set_n1, set_n2, set_L, set_count1,
            set_count2, set_full_length, set_weight, walks1_off, walks1_flat,
            walks2_off, walks2_flat,
            C1, (const int32_t*)table1, (const int32_t*)index_on1, chainid1,
            choff1, chnodes1,
            C2, (const int32_t*)table2, (const int32_t*)index_on2, chainid2,
            choff2, chnodes2,
            ns1, sources1, ns2, sources2, nk1, sinks1, nk2, sinks2,
            n_masked, masked_rows, out_cap, out_rows, out_fvals);
    }
    return sparse_parity_impl<i64>(
        V1, n1ptr, n1ind, p1ptr, p1ind, V2,
        num_sets_total, num_sets, set_n1, set_n2, set_L, set_count1,
        set_count2, set_full_length, set_weight, walks1_off, walks1_flat,
        walks2_off, walks2_flat,
        C1, (const i64*)table1, (const i64*)index_on1, chainid1,
        choff1, chnodes1,
        C2, (const i64*)table2, (const i64*)index_on2, chainid2,
        choff2, chnodes2,
        ns1, sources1, ns2, sources2, nk1, sinks1, nk2, sinks2,
        n_masked, masked_rows, out_cap, out_rows, out_fvals);
}

}  // extern "C"

namespace {

// post-switch D arrays (reference post_switch_distances.hpp:16-76):
// stored value 0 = no distance; otherwise distance + offsets per the
// reference DP (value 1 when switching immediately)
template <typename TI>
static std::vector<std::vector<i64>> build_psd(const CsrGraph& g,
                                               const XMergeView<TI>& xm) {
    std::vector<std::vector<i64>> dist(xm.C, std::vector<i64>(g.V, 0));
    for (i64 node_id : ref_topo_order(g)) {
        for (i64 p = 0; p < xm.C; ++p) {
            auto& row = dist[p];
            i64 pred = xm.predecessor_index(node_id, p);
            for (i64 k = g.pptr[node_id]; k < g.pptr[node_id + 1]; ++k) {
                i64 prev_id = g.pind[k];
                if (xm.index_on(prev_id, p) == pred) {
                    row[node_id] = 1;
                    break;
                } else if (xm.predecessor_index(prev_id, p) == pred) {
                    i64 dist_thru = row[prev_id] + 1;  // label size 1
                    if (row[node_id] == 0 || row[node_id] > dist_thru)
                        row[node_id] = dist_thru;
                }
            }
        }
    }
    return dist;
}

// distance(): 0 -> size_t(-1) (post_switch_distances.hpp:79-82)
static inline u64 psd_distance(const std::vector<std::vector<i64>>& d,
                               i64 node, i64 path) {
    i64 v = d[path][node];
    return v == 0 ? ~u64(0) : u64(v);
}

template <typename IntShiftT, typename TI>
struct AffineEngine {
    static constexpr int NumPW = 3;

    const CsrGraph& g1;
    const XMergeView<TI>& xm1;
    const XMergeView<TI>& xm2;
    const std::vector<std::vector<i64>>& psd1;
    const std::vector<std::vector<i64>>& psd2;
    const double* gap_open;
    const double* gap_extend;
    double local_scale;
    // PathMerge instantiation width for the wrap semantics of
    // predecessor_index arithmetic (reference core.hpp:296-357 picks
    // uint32 tables below ~4e9 nodes; we mirror with the same u32 wrap)

    inline IntShiftT to_shift(u64 x) const { return (IntShiftT)x; }

    inline IntShiftT basic_source_shift(i64 s1, i64 s2, i64 p1, i64 p2) const {
        return to_shift(u64(xm1.index_on(s1, p1)) - u64(xm2.index_on(s2, p2)));
    }
    inline IntShiftT basic_query_shift(i64 q1, i64 q2, i64 p1, i64 p2) const {
        u64 a = u64(xm1.predecessor_index(q1, p1));
        u64 b = u64(xm2.predecessor_index(q2, p2));
        u64 c = psd_distance(psd1, q1, p1);
        u64 d = psd_distance(psd2, q2, p2);
        return to_shift(a - b + c - d);
    }
    inline f32 score_gap(IntShiftT gap) const {
        f32 score = MININF;
        if (gap == 0) {
            score = 0.0f;
        } else if (gap != std::numeric_limits<IntShiftT>::max()) {
            for (int pw = 0; pw < NumPW; ++pw) {
                double cand = -local_scale *
                    (gap_open[pw] + gap_extend[pw] * std::abs((double)gap));
                score = std::max<f32>(score, cand);
            }
        }
        return score;
    }
    inline IntShiftT measure_gap(i64 prev1, i64 prev2, i64 cur1,
                                 i64 cur2, std::vector<i64>& scratch1,
                                 std::vector<i64>& scratch2) const {
        IntShiftT gap = std::numeric_limits<IntShiftT>::max();
        if ((prev1 == cur1 || xm1.reachable(prev1, cur1)) &&
            (prev2 == cur2 || xm2.reachable(prev2, cur2))) {
            xm1.chains_on(prev1, scratch1);
            xm2.chains_on(prev2, scratch2);
            for (i64 p1 : scratch1) {
                for (i64 p2 : scratch2) {
                    IntShiftT here = basic_source_shift(prev1, prev2, p1, p2) -
                                     basic_query_shift(cur1, cur2, p1, p2);
                    if (std::abs((long long)here) < std::abs((long long)gap))
                        gap = here;
                }
            }
        }
        return gap;
    }
    // NOTE: the set variants compare abs(gap_here) against the SIGNED
    // current value — a reference quirk replicated deliberately
    // (anchorer.hpp:1946-1995).
    template <class It1, class It2>
    std::pair<IntShiftT, f32> measure_gap_sn(It1 prev1b, It1 prev1e,
                                             It2 prev2b, It2 prev2e,
                                             i64 cur1, i64 cur2,
                                             std::vector<i64>& s1,
                                             std::vector<i64>& s2) const {
        std::pair<IntShiftT, f32> rv(std::numeric_limits<IntShiftT>::max(),
                                     MININF);
        for (It1 a = prev1b; a != prev1e; ++a) {
            for (It2 b = prev2b; b != prev2e; ++b) {
                IntShiftT here = measure_gap(*a, *b, cur1, cur2, s1, s2);
                if (std::abs((long long)here) < rv.first) rv.first = here;
            }
        }
        rv.second = score_gap(rv.first);
        return rv;
    }
    template <class It1, class It2>
    std::pair<IntShiftT, f32> measure_gap_ns(i64 prev1, i64 prev2,
                                             It1 cur1b, It1 cur1e,
                                             It2 cur2b, It2 cur2e,
                                             std::vector<i64>& s1,
                                             std::vector<i64>& s2) const {
        std::pair<IntShiftT, f32> rv(std::numeric_limits<IntShiftT>::max(),
                                     MININF);
        for (It1 a = cur1b; a != cur1e; ++a) {
            for (It2 b = cur2b; b != cur2e; ++b) {
                IntShiftT here = measure_gap(prev1, prev2, *a, *b, s1, s2);
                if (std::abs((long long)here) < rv.first) rv.first = here;
            }
        }
        rv.second = score_gap(rv.first);
        return rv;
    }
};

}  // namespace

namespace {

// full affine DP (reference sparse_affine_chain_dp, anchorer.hpp:1812-2470)
template <typename IntShiftT, typename TI>
static i64 affine_impl(
        const CsrGraph& g1, const CsrGraph& g2,
        const XMergeView<TI>& xm1, const XMergeView<TI>& xm2,
        const std::vector<MatchSetView>& sets, i64 num_sets,
        const std::unordered_set<u64>* masked,
        const double* gap_open, const double* gap_extend, double local_scale,
        i64 ns1, const i64* sources1, i64 ns2, const i64* sources2,
        i64 nk1, const i64* sinks1, i64 nk2, const i64* sinks2,
        i64 out_cap, i64* out_rows, double* out_fvals) {
    constexpr int NumPW = 3;
    const i64 C1 = xm1.C, C2 = xm2.C;
    const bool timing = getenv("CHAIN_PARITY_DEBUG") != nullptr;
    auto tick = std::chrono::steady_clock::now();
    auto lap = [&](const char* what) {
        if (!timing) return;
        auto now = std::chrono::steady_clock::now();
        fprintf(stderr, "[affine] %s: %.2fs\n", what,
                std::chrono::duration<double>(now - tick).count());
        tick = now;
    };

    auto psd1 = build_psd(g1, xm1);
    auto psd2 = build_psd(g2, xm2);
    AffineEngine<IntShiftT, TI> eng{g1, xm1, xm2, psd1, psd2,
                                    gap_open, gap_extend, local_scale};

    lap("psd");
    MatchBankP bank(g1.V, sets, num_sets, masked);

    using key_t = std::pair<IntShiftT, u64>;    // (shift, match id)
    using gf_key_t = std::pair<u64, u64>;       // (offset, match id)

    // flat per-pair endpoint arrays (avoid per-query index decoding)
    std::vector<i64> e1v(bank.total_pairs), e2v(bank.total_pairs),
        s1v(bank.total_pairs), s2v(bank.total_pairs);
    for (i64 s = 0; s < num_sets; ++s) {
        const auto& ms = sets[s];
        for (i64 i = 0; i < ms.n1; ++i) {
            for (i64 j = 0; j < ms.n2; ++j) {
                u64 id = bank.id_of(s, i, j);
                s1v[id] = ms.walks1[i * ms.L];
                e1v[id] = ms.walks1[i * ms.L + ms.L - 1];
                s2v[id] = ms.walks2[j * ms.L];
                e2v[id] = ms.walks2[j * ms.L + ms.L - 1];
            }
        }
    }
    auto end1_of = [&](u64 id) { return e1v[id]; };
    auto end2_of = [&](u64 id) { return e2v[id]; };
    auto start1_of = [&](u64 id) { return s1v[id]; };
    auto start2_of = [&](u64 id) { return s2v[id]; };

    auto source_shift = [&](u64 id, i64 p1, i64 p2) -> IntShiftT {
        return eng.basic_source_shift(end1_of(id), end2_of(id), p1, p2);
    };
    auto query_shift = [&](u64 id, i64 p1, i64 p2) -> IntShiftT {
        return eng.basic_query_shift(start1_of(id), start2_of(id), p1, p2);
    };
    auto key_offset = [&](u64 id, i64 p2) -> u64 {
        return u64(xm2.index_on(end2_of(id), p2));
    };
    auto query_offset = [&](u64 id, i64 p2) -> u64 {
        // -1 wraps to 0 at the PathMerge's unsigned width; low bits agree
        // for every in-range value, and (u32)(-1)+1 == (u64)(-1)+1 == 0
        return u64(xm2.predecessor_index(start2_of(id), p2)) + 1;
    };

    // ------------- bookkeeping pass (anchorer.hpp:2010-2049)
    std::vector<std::vector<std::vector<std::tuple<key_t, u64, f32>>>>
        tree_data(C1);
    for (i64 a = 0; a < C1; ++a) tree_data[a].resize(C2);

    std::vector<i64> sc1, sc2;  // chains_on scratch
    bank.for_each([&](u64 id, i64 s, i64 i, i64 j) {
        const auto& ms = sets[s];
        f32 weight = ms.weight;
        if (ns1 >= 0) {
            f32 lead = eng.measure_gap_sn(
                sources1, sources1 + ns1, sources2, sources2 + ns2,
                ms.walks1[i * ms.L], ms.walks2[j * ms.L], sc1, sc2).second;
            if (lead == MININF) weight = MININF;
            else weight += lead;
        }
        bank.update_dp(id, weight, ID_MAX);
        xm1.chains_on(ms.walks1[i * ms.L + ms.L - 1], sc1);
        xm2.chains_on(ms.walks2[j * ms.L + ms.L - 1], sc2);
        for (i64 p1 : sc1) {
            for (i64 p2 : sc2) {
                tree_data[p1][p2].emplace_back(
                    key_t(source_shift(id, p1, p2), id),
                    key_offset(id, p2), MININF);
            }
        }
    });

    lap("bookkeeping");
    // ------------- ortho trees: one multi-channel tree per (p1, p2) with
    // 2*NumPW value channels (shared keys/layout; independent values)
    using OrthoT = MultiOrthoTreeP<key_t, u64, 2 * NumPW>;
    std::vector<std::vector<OrthoT>> search_trees(C1);
    for (i64 a = 0; a < C1; ++a) {
        search_trees[a].resize(C2);
        for (i64 b = 0; b < C2; ++b) {
            search_trees[a][b].build(tree_data[a][b]);
            tree_data[a][b].clear();
            tree_data[a][b].shrink_to_fit();
        }
    }

    lap("ortho build");
    // ------------- gap-free trees per (p1, p2, shift)
    // per (p1,p2): min_shift + vector of per-shift entry lists. The
    // reference builds each list with emplace_front (LIFO), then copies —
    // we append and reverse.
    std::vector<std::vector<std::deque<std::vector<std::pair<gf_key_t, f32>>>>>
        gf_data(C1);
    std::vector<std::vector<IntShiftT>> min_shift(
        C1, std::vector<IntShiftT>(C2, 0));
    for (i64 a = 0; a < C1; ++a) gf_data[a].resize(C2);

    bank.for_each([&](u64 id, i64 s, i64 i, i64 j) {
        const auto& ms = sets[s];
        xm1.chains_on(ms.walks1[i * ms.L + ms.L - 1], sc1);
        xm2.chains_on(ms.walks2[j * ms.L + ms.L - 1], sc2);
        for (i64 p1 : sc1) {
            for (i64 p2 : sc2) {
                IntShiftT shift = source_shift(id, p1, p2);
                auto& dq = gf_data[p1][p2];
                auto& mn = min_shift[p1][p2];
                if (dq.empty()) {
                    mn = shift;
                    dq.emplace_back();
                    dq.back().emplace_back(gf_key_t(key_offset(id, p2), id),
                                           MININF);
                } else {
                    while (mn > shift) {
                        dq.emplace_front();
                        --mn;
                    }
                    while (mn + (IntShiftT)dq.size() <= shift)
                        dq.emplace_back();
                    dq[shift - mn].emplace_back(
                        gf_key_t(key_offset(id, p2), id), MININF);
                }
            }
        }
    });

    std::vector<std::vector<std::vector<MaxTreeP<gf_key_t, f32>>>> gf_trees(C1);
    for (i64 a = 0; a < C1; ++a) {
        gf_trees[a].resize(C2);
        for (i64 b = 0; b < C2; ++b) {
            auto& bankk = gf_trees[a][b];
            bankk.resize(gf_data[a][b].size());
            for (size_t t = 0; t < gf_data[a][b].size(); ++t) {
                auto lst = gf_data[a][b][t];
                std::reverse(lst.begin(), lst.end());  // forward_list order
                bankk[t].build(lst);
            }
            gf_data[a][b].clear();
            gf_data[a][b].shrink_to_fit();
        }
    }

    lap("gf build");
    auto fwd = build_forward_edges(g1, xm1, sets, num_sets);
    lap("fwd edges");

    // ------------- main sweep (anchorer.hpp:2290-2420)
    double t_ends = 0.0, t_starts = 0.0;
    i64 n_ends = 0, n_starts = 0;
    auto swnow = std::chrono::steady_clock::now;
    for (i64 node_id : ref_topo_order(g1)) {
        auto tn0 = timing ? swnow() : std::chrono::steady_clock::time_point();
        bank.for_ends_on(node_id, [&](u64 id, i64 s, i64 i, i64 j) {
            ++n_ends;
            f32 dp_val = bank.dp[id];
            const auto& ms = sets[s];
            xm1.chains_on(ms.walks1[i * ms.L + ms.L - 1], sc1);
            xm2.chains_on(ms.walks2[j * ms.L + ms.L - 1], sc2);
            for (i64 p1 : sc1) {
                for (i64 p2 : sc2) {
                    key_t key1(source_shift(id, p1, p2), id);
                    u64 key2 = key_offset(id, p2);
                    IntShiftT shift = key1.first;
                    {
                        auto& tree = gf_trees[p1][p2][shift - min_shift[p1][p2]];
                        i64 it = tree.find(gf_key_t(key2, id));
                        if (it >= tree.size()) {
                            fprintf(stderr, "GF FIND FAIL id=%llu p1=%lld p2=%lld shift=%lld key2=%llu treesz=%lld\n",
                                    (unsigned long long)id, (long long)p1, (long long)p2, (long long)shift, (unsigned long long)key2, (long long)tree.size());
                            abort();
                        }
                        tree.update(it, dp_val);
                    }
                    {
                        auto& tree = search_trees[p1][p2];
                        i64 node = tree.find(key1, key2);
                        if (node >= tree.size()) {
                            fprintf(stderr, "ORTHO FIND FAIL id=%llu\n",
                                    (unsigned long long)id);
                            abort();
                        }
                        // all improving channels in one ancestor walk
                        int chans[2 * NumPW];
                        f32 vals[2 * NumPW];
                        int m = 0;
                        for (int pw = 0; pw < 2 * NumPW; ++pw) {
                            f32 value;
                            if (pw % 2 == 1) {
                                value = f32(dp_val + local_scale *
                                            gap_extend[pw / 2] * (double)shift);
                            } else {
                                value = f32(dp_val - local_scale *
                                            gap_extend[pw / 2] * (double)shift);
                            }
                            if (value > tree.value[node][pw]) {
                                chans[m] = pw;
                                vals[m] = value;
                                ++m;
                            }
                        }
                        if (m) tree.update_multi(m, chans, node, vals);
                    }
                }
            }
        });

        if (timing) {
            auto tn1 = swnow();
            t_ends += std::chrono::duration<double>(tn1 - tn0).count();
            tn0 = tn1;
        }
        for (const auto& edge : fwd[node_id]) {
            i64 fwd_id = edge.first;
            i64 chain1 = edge.second;
            bank.for_starts_on(fwd_id, [&](u64 id, i64 s, i64 i, i64 j) {
                ++n_starts;
                const auto& ms = sets[s];
                f32 weight = ms.weight;
                for (i64 chain2 = 0; chain2 < C2; ++chain2) {
                    IntShiftT query = query_shift(id, chain1, chain2);
                    u64 offset = query_offset(id, chain2);
                    if (query >= min_shift[chain1][chain2] &&
                        u64(query - min_shift[chain1][chain2]) <
                            gf_trees[chain1][chain2].size()) {
                        const auto& tree =
                            gf_trees[chain1][chain2][query -
                                                     min_shift[chain1][chain2]];
                        if (!tree.empty()) {
                            i64 it = tree.range_max(gf_key_t(0, 0),
                                                    gf_key_t(offset, 0));
                            if (it != tree.size()) {
                                f32 value = tree.value[it] + weight;
                                bank.update_dp(id, value, tree.key[it].second);
                            }
                        }
                    }
                    auto& tree = search_trees[chain1][chain2];
                    // the 3 odd channels share one key rectangle and the 3
                    // even channels another: answer each trio in a single
                    // batched traversal, then apply update_dp in the
                    // original pw order (its first-writer-wins tie rule
                    // depends on application order, not query order)
                    static const int odd_ch[NumPW] = {1, 3, 5};
                    static const int even_ch[NumPW] = {0, 2, 4};
                    bool ofound[NumPW], efound[NumPW];
                    i64 oidx[NumPW], eidx[NumPW];
                    tree.range_max_multi(
                        NumPW, odd_ch,
                        key_t(std::numeric_limits<IntShiftT>::min(), 0),
                        key_t(query, 0), 0, offset, ofound, oidx);
                    tree.range_max_multi(
                        NumPW, even_ch,
                        key_t(IntShiftT(
                            (typename std::make_unsigned<IntShiftT>::type)
                                query + 1), 0),
                        key_t(std::numeric_limits<IntShiftT>::max(), ID_MAX),
                        0, offset, efound, eidx);
                    for (int pw = 0; pw < 2 * NumPW; ++pw) {
                        int k = pw / 2;
                        if (pw % 2 == 1) {
                            if (ofound[k]) {
                                i64 oi = oidx[k];
                                f32 value = f32(
                                    (double)f32(tree.value[oi][pw] + weight) -
                                    local_scale * (gap_open[pw / 2] +
                                                   gap_extend[pw / 2] *
                                                       (double)query));
                                bank.update_dp(id, value, tree.key1[oi].second);
                            }
                        } else {
                            if (efound[k]) {
                                i64 oi = eidx[k];
                                f32 value = f32(
                                    (double)f32(tree.value[oi][pw] + weight) -
                                    local_scale * (gap_open[pw / 2] -
                                                   gap_extend[pw / 2] *
                                                       (double)query));
                                bank.update_dp(id, value, tree.key1[oi].second);
                            }
                        }
                    }
                }
            });
        }
        if (timing)
            t_starts += std::chrono::duration<double>(swnow() - tn0).count();
    }

    if (timing)
        fprintf(stderr,
                "[affine] sweep detail: ends=%lld (%.2fs) starts=%lld "
                "(%.2fs)\n",
                (long long)n_ends, t_ends, (long long)n_starts, t_starts);
    lap("main sweep");
    // debug hook: dump per-anchor dp/bp in MatchBank id order (used by the
    // CDQ engine's validation mode, anchorer.py::_chain_affine_cdq)
    if (const char* dumpp = getenv("CHAIN_DP_DUMP")) {
        FILE* df = fopen(dumpp, "wb");
        if (!df) {
            fprintf(stderr, "[affine] CHAIN_DP_DUMP: cannot open %s for "
                    "writing; dump skipped\n", dumpp);
        } else {
            i64 N = (i64)bank.total_pairs;
            size_t wrote = fwrite(&N, sizeof(i64), 1, df);
            wrote += fwrite(bank.dp.data(), sizeof(f32), (size_t)N, df);
            wrote += fwrite(bank.bp.data(), sizeof(u64), (size_t)N, df);
            if (fclose(df) != 0 || wrote != (size_t)(1 + 2 * N))
                fprintf(stderr, "[affine] CHAIN_DP_DUMP: short write to %s "
                        "(%zu of %lld records); dump is truncated\n",
                        dumpp, wrote, (long long)(1 + 2 * N));
        }
    }
    // ------------- traceback
    f32 min_score = 0.0f;
    if (ns1 >= 0 && nk1 >= 0) {
        // measure_gap_ss: curr loops outer, prev loops inner
        IntShiftT g = std::numeric_limits<IntShiftT>::max();
        for (i64 c = 0; c < nk1; ++c)
            for (i64 d = 0; d < nk2; ++d)
                for (i64 a = 0; a < ns1; ++a)
                    for (i64 b = 0; b < ns2; ++b) {
                        IntShiftT here = eng.measure_gap(
                            sources1[a], sources2[b], sinks1[c], sinks2[d],
                            sc1, sc2);
                        if (std::abs((long long)here) < g) g = here;
                    }
        min_score = eng.score_gap(g);
    }

    f32 opt_value = MININF;
    u64 opt_match = ID_MAX;
    bank.for_each([&](u64 id, i64 s, i64 i, i64 j) {
        f32 dp_val = bank.dp[id];
        f32 final_term = 0.0f;
        if (nk1 >= 0) {
            final_term = eng.measure_gap_ns(
                end1_of(id), end2_of(id), sinks1, sinks1 + nk1,
                sinks2, sinks2 + nk2, sc1, sc2).second;
        }
        if (final_term == MININF) dp_val = final_term;
        else dp_val += final_term;
        if (dp_val > opt_value && dp_val > min_score) {
            opt_value = dp_val;
            opt_match = id;
        }
    });

    std::vector<u64> rev;
    for (u64 here = opt_match; here != ID_MAX; here = bank.bp[here])
        rev.push_back(here);
    std::reverse(rev.begin(), rev.end());

    // gap annotations (anchorer.hpp:2423-2462)
    i64 n_out = std::min<i64>((i64)rev.size(), out_cap);
    std::vector<i64> gap_before(rev.size(), 0), gap_after(rev.size(), 0);
    std::vector<double> gs_before(rev.size(), 0.0), gs_after(rev.size(), 0.0);
    for (size_t t = 0; t < rev.size(); ++t) {
        u64 id = rev[t];
        if (t == 0) {
            if (ns1 >= 0) {
                auto gp = eng.measure_gap_sn(
                    sources1, sources1 + ns1, sources2, sources2 + ns2,
                    start1_of(id), start2_of(id), sc1, sc2);
                gap_before[t] = gp.first;
                gs_before[t] = gp.second;
            }
        } else {
            u64 prev = rev[t - 1];
            IntShiftT g = eng.measure_gap(end1_of(prev), end2_of(prev),
                                          start1_of(id), start2_of(id),
                                          sc1, sc2);
            f32 gsc = eng.score_gap(g);
            gap_after[t - 1] = g;
            gs_after[t - 1] = gsc;
            gap_before[t] = g;
            gs_before[t] = gsc;
        }
        if (t + 1 == rev.size() && nk1 >= 0) {
            auto gp = eng.measure_gap_ns(end1_of(id), end2_of(id),
                                         sinks1, sinks1 + nk1,
                                         sinks2, sinks2 + nk2, sc1, sc2);
            gap_after[t] = gp.first;
            gs_after[t] = gp.second;
        }
    }

    for (i64 t = 0; t < n_out; ++t) {
        i64 s, i, j;
        bank.indexes_of(rev[t], &s, &i, &j);
        i64* row = out_rows + 5 * t;
        row[0] = s; row[1] = i; row[2] = j;
        row[3] = gap_before[t]; row[4] = gap_after[t];
        double* fv = out_fvals + 3 * t;
        // annotate_scores stores the double anchor weight
        fv[0] = 0.0;  // filled by caller from set weights
        fv[1] = gs_before[t];
        fv[2] = gs_after[t];
    }
    return (i64)rev.size();
}

}  // namespace


extern "C" {

// SparseAffine chaining with reference-exact semantics. use_small selects
// the int32 shift width (the reference's Small instantiation conditions);
// table_width (4|8) selects the (V x C) reachability-table storage.
i64 chain_affine_parity(
        i64 V1, const i64* n1ptr, const i64* n1ind, const i64* p1ptr,
        const i64* p1ind,
        i64 V2, const i64* n2ptr, const i64* n2ind, const i64* p2ptr,
        const i64* p2ind,
        i64 num_sets_total, i64 num_sets, const i64* set_n1, const i64* set_n2,
        const i64* set_L, const i64* set_count1, const i64* set_count2,
        const i64* set_full_length, const double* set_weight,
        const i64* walks1_off, const i64* walks1_flat,
        const i64* walks2_off, const i64* walks2_flat,
        i64 C1, const void* table1, const void* index_on1, const i64* chainid1,
        const i64* choff1, const i64* chnodes1,
        i64 C2, const void* table2, const void* index_on2, const i64* chainid2,
        const i64* choff2, const i64* chnodes2,
        const double* gap_open, const double* gap_extend, double local_scale,
        i64 ns1, const i64* sources1, i64 ns2, const i64* sources2,
        i64 nk1, const i64* sinks1, i64 nk2, const i64* sinks2,
        i64 n_masked, const i64* masked_rows, int use_small, int table_width,
        i64 out_cap, i64* out_rows, double* out_fvals) {
    CsrGraph g1{V1, n1ptr, n1ind, p1ptr, p1ind};
    CsrGraph g2{V2, n2ptr, n2ind, p2ptr, p2ind};

    std::vector<MatchSetView> sets(num_sets_total);
    for (i64 s = 0; s < num_sets_total; ++s) {
        sets[s] = MatchSetView{
            set_n1[s], set_n2[s], set_L[s],
            walks1_flat + walks1_off[s], walks2_flat + walks2_off[s],
            set_count1[s], set_count2[s], set_full_length[s],
            f32(set_weight[s])};
    }
    std::unordered_set<u64> masked;
    for (i64 m = 0; m < n_masked; ++m) {
        masked.insert(MatchBankP::mask_key(
            masked_rows[3 * m], masked_rows[3 * m + 1], masked_rows[3 * m + 2]));
    }
    const std::unordered_set<u64>* mp = n_masked ? &masked : nullptr;

    i64 n;
    if (table_width == 4) {
        XMergeView<int32_t> xm1{V1, C1, (const int32_t*)table1,
                                (const int32_t*)index_on1, chainid1, choff1,
                                chnodes1};
        XMergeView<int32_t> xm2{V2, C2, (const int32_t*)table2,
                                (const int32_t*)index_on2, chainid2, choff2,
                                chnodes2};
        n = use_small
            ? affine_impl<int32_t, int32_t>(
                  g1, g2, xm1, xm2, sets, num_sets, mp,
                  gap_open, gap_extend, local_scale,
                  ns1, sources1, ns2, sources2, nk1, sinks1, nk2, sinks2,
                  out_cap, out_rows, out_fvals)
            : affine_impl<int64_t, int32_t>(
                  g1, g2, xm1, xm2, sets, num_sets, mp,
                  gap_open, gap_extend, local_scale,
                  ns1, sources1, ns2, sources2, nk1, sinks1, nk2, sinks2,
                  out_cap, out_rows, out_fvals);
    } else {
        XMergeView<i64> xm1{V1, C1, (const i64*)table1, (const i64*)index_on1,
                            chainid1, choff1, chnodes1};
        XMergeView<i64> xm2{V2, C2, (const i64*)table2, (const i64*)index_on2,
                            chainid2, choff2, chnodes2};
        n = use_small
            ? affine_impl<int32_t, i64>(
                  g1, g2, xm1, xm2, sets, num_sets, mp,
                  gap_open, gap_extend, local_scale,
                  ns1, sources1, ns2, sources2, nk1, sinks1, nk2, sinks2,
                  out_cap, out_rows, out_fvals)
            : affine_impl<int64_t, i64>(
                  g1, g2, xm1, xm2, sets, num_sets, mp,
                  gap_open, gap_extend, local_scale,
                  ns1, sources1, ns2, sources2, nk1, sinks1, nk2, sinks2,
                  out_cap, out_rows, out_fvals);
    }
    // annotate_scores: double anchor weight per row
    for (i64 t = 0; t < std::min(n, out_cap); ++t) {
        out_fvals[3 * t] = set_weight[out_rows[5 * t]];
    }
    return n;
}

}  // extern "C"

// PathMerge table construction (reference path_merge.hpp:96-165): index_on,
// path_head, and the last-to-reach table over the given paths (+ optional
// sentinel pseudo-path).
template <typename TI>
static void path_merge_build_impl(
        i64 V, const i64* nptr, const i64* nind, const i64* pptr,
        const i64* pind,
        i64 P, const i64* path_off, const i64* path_nodes,
        i64 src_id, i64 snk_id,  // -1 -> no tableau
        TI* index_on,  // (C, V) out, pre-filled -1
        i64* path_head,  // (V,) out, pre-filled -1
        TI* table) {    // (V, C) out, pre-filled -1
    i64 C = P + (src_id >= 0 ? 1 : 0);
    for (i64 p = 0; p < P; ++p) {
        i64 index = 0;
        for (i64 k = path_off[p]; k < path_off[p + 1]; ++k) {
            i64 v = path_nodes[k];
            for (i64 e = nptr[v]; e < nptr[v + 1]; ++e) {
                table[nind[e] * C + p] = index;  // increasing: last wins
            }
            index_on[p * V + v] = index;
            path_head[v] = p;
            ++index;
        }
    }
    CsrGraph g{V, nptr, nind, pptr, pind};
    for (i64 v : ref_topo_order(g)) {
        TI* row = table + v * C;
        for (i64 e = pptr[v]; e < pptr[v + 1]; ++e) {
            const TI* prow = table + pind[e] * C;
            for (i64 p = 0; p < P; ++p) {
                if (row[p] < prow[p]) row[p] = prow[p];
            }
        }
    }
    if (src_id >= 0) {
        index_on[P * V + src_id] = 0;
        index_on[P * V + snk_id] = 1;
        path_head[src_id] = P;
        path_head[snk_id] = P;
        for (i64 v = 0; v < V; ++v) {
            if (v != src_id) table[v * C + P] = 0;
        }
    }
}

extern "C" {

void path_merge_build(
        i64 V, const i64* nptr, const i64* nind, const i64* pptr,
        const i64* pind,
        i64 P, const i64* path_off, const i64* path_nodes,
        i64 src_id, i64 snk_id,
        void* index_on, i64* path_head, void* table, int table_width) {
    if (table_width == 4) {
        path_merge_build_impl<int32_t>(
            V, nptr, nind, pptr, pind, P, path_off, path_nodes,
            src_id, snk_id, (int32_t*)index_on, path_head, (int32_t*)table);
    } else {
        path_merge_build_impl<i64>(
            V, nptr, nind, pptr, pind, P, path_off, path_nodes,
            src_id, snk_id, (i64*)index_on, path_head, (i64*)table);
    }
}

}  // extern "C"

extern "C" {

// the reference's LIFO-stack Kahn order (topological_order.hpp:12)
void ref_topological_order(i64 V, const i64* nptr, const i64* nind,
                           const i64* pptr, const i64* pind, i64* out) {
    CsrGraph g{V, nptr, nind, pptr, pind};
    auto order = ref_topo_order(g);
    std::copy(order.begin(), order.end(), out);
}

}  // extern "C"

extern "C" {

// Bonder::longest_deviation_constrained_partition (reference
// src/bonder.cpp:802-920): O(n^2) DP over shared segments with score,
// deviation-drift, and separation constraints. separation[i] < 0 encodes
// the reference's "skip this i" (-1 oracle misses) — mininf otherwise
// computed by the caller. Returns number of intervals written to out (pairs).
i64 bonder_dev_constrained_partition(
        i64 n, const double* shared,        // (n, 3) len, opt, sec
        const double* intervening,          // (n-1, 3)
        const i64* deviation,               // (n-1, 2)
        const double* separation,           // (n,) or null
        int use_separation,
        double min_opt_proportion, double min_length,
        double deviation_drift_factor, double separation_drift_factor,
        i64* out_pairs) {
    const double mininf = std::numeric_limits<double>::lowest();
    std::vector<std::pair<double, double>> dp(n + 1,
                                              {mininf, mininf});
    dp.front() = {0.0, 0.0};
    std::vector<i64> backpointer(n + 1, -1);
    i64 tb_idx = 0;
    for (i64 i = 1; i <= n; ++i) {
        dp[i].first = std::max(dp[i - 1].first, dp[i - 1].second);
        double sep = mininf;
        if (use_separation) {
            if (separation[i - 1] < 0) continue;  // oracle found no distance
            sep = separation[i - 1];
        }
        double running_length = 0.0, running_opt = 0.0, running_sec = 0.0;
        i64 run_opt_dev = 0, run_sec_dev = 0, min_dd = 0, max_dd = 0;
        for (i64 j = i - 1; j >= 0; --j) {
            running_length += shared[3 * j];
            running_opt += shared[3 * j + 1];
            running_sec += shared[3 * j + 2];
            if (j + 1 != i) {
                running_length += intervening[3 * j];
                running_opt += intervening[3 * j + 1];
                running_sec += intervening[3 * j + 2];
                run_opt_dev += deviation[2 * j];
                run_sec_dev += deviation[2 * j + 1];
            }
            min_dd = std::min(min_dd, run_opt_dev - run_sec_dev);
            max_dd = std::max(max_dd, run_opt_dev - run_sec_dev);
            double root_length = sqrt(running_length);
            if (running_sec >= min_opt_proportion * running_opt &&
                max_dd - min_dd <= root_length * deviation_drift_factor &&
                (!use_separation ||
                 sep >= running_length - root_length * separation_drift_factor)) {
                double score = dp[j].first + running_length - min_length;
                if (score > dp[i].second) {
                    dp[i].second = score;
                    backpointer[i] = j;
                }
            }
        }
        if (dp[i].second > dp[tb_idx].second) tb_idx = i;
    }
    // PartitionClient::traceback (partition_client.hpp:30-53)
    std::vector<std::pair<i64, i64>> intervals;
    i64 i = tb_idx;
    bool in_interval = true;
    while (i > 0) {
        if (in_interval) {
            i64 j = backpointer[i];
            intervals.emplace_back(j, i);
            i = j;
            in_interval = false;
        } else {
            in_interval = (dp[i].first == dp[i - 1].second);
            --i;
        }
    }
    std::reverse(intervals.begin(), intervals.end());
    for (size_t k = 0; k < intervals.size(); ++k) {
        out_pairs[2 * k] = intervals[k].first;
        out_pairs[2 * k + 1] = intervals[k].second;
    }
    return (i64)intervals.size();
}

}  // extern "C"

extern "C" {

// ChainMerge construction (reference chain_merge.hpp:96-178): chain
// assignment by first covering path, then last-to-reach DP over the
// reference topological order.
void chain_merge_build(
        i64 V, const i64* nptr, const i64* nind, const i64* pptr,
        const i64* pind,
        i64 P, const i64* path_off, const i64* path_nodes,
        i64 src_id, i64 snk_id,  // -1 -> no tableau
        i64* chain_id, i64* chain_index, i64* table /* (V, C) pre -1 */) {
    i64 C = P + (src_id >= 0 ? 1 : 0);
    for (i64 v = 0; v < V; ++v) { chain_id[v] = -1; chain_index[v] = -1; }
    for (i64 p = 0; p < P; ++p) {
        i64 index = 0;
        for (i64 k = path_off[p]; k < path_off[p + 1]; ++k) {
            i64 v = path_nodes[k];
            if (chain_id[v] == -1) {
                chain_id[v] = p;
                chain_index[v] = index++;
            }
        }
    }
    if (src_id >= 0) {
        chain_id[src_id] = P;
        chain_index[src_id] = 0;
        chain_id[snk_id] = P;
        chain_index[snk_id] = 1;
    }
    CsrGraph g{V, nptr, nind, pptr, pind};
    for (i64 v : ref_topo_order(g)) {
        i64 c = chain_id[v];
        if (c == -1) continue;
        i64 idx = chain_index[v];
        const i64* row = table + v * C;
        for (i64 k = nptr[v]; k < nptr[v + 1]; ++k) {
            i64 nx = nind[k];
            if (chain_id[nx] == -1) continue;
            i64* nrow = table + nx * C;
            for (i64 cc = 0; cc < C; ++cc) {
                i64 cand = (cc == c) ? idx : row[cc];
                if (cand > nrow[cc]) nrow[cc] = cand;
            }
        }
    }
}

}  // extern "C"

extern "C" {
// release freed malloc arenas back to the OS between subproblems: the chain
// DP's tree structures allocate many small blocks whose retention otherwise
// stacks across the big late-tree joins (observed: +50 GB RSS carried into
// the root join of a 50-sequence MSA)
void native_malloc_trim() {
#if defined(__GLIBC__)
    malloc_trim(0);
#endif
}
}  // extern "C"
