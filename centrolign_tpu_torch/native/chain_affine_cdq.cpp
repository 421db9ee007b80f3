// SparseAffine chaining VALUES via offline CDQ divide-and-conquer — a flat
// sort/scan/Fenwick replacement for the reference's per-(path1,path2)
// OrthogonalMaxSearchTree sweep (reference sparse_affine_chain_dp,
// anchorer.hpp:1812-2470). chain_cdq_core.h states the timeline; this file
// holds the core that solves it and the chain x chain entry. On chain x
// chain graphs (every leaf-level subproblem and every pairwise run) there
// is exactly one real (path1, path2) family and the timeline is:
//
//   insert of anchor i  at time 2*e1(i):    publishes 6 piecewise channel
//       values f32(f64(dp_i) +/- scale*ge[k]*shift_i) keyed by
//       (shift_i = e1-e2, offset_i = e2), plus dp_i on the gap-free
//       (shift-equality) channel  (anchorer.hpp:2290-2345)
//   query of anchor j   at time 2*s1(j)-1:  max over inserts with
//       shift < / == / > qshift_j and offset < s2(j), folded per channel
//       with the reference's exact f32/f64 rounding sequence
//       (anchorer.hpp:2352-2420)
//
// The graph x graph entry (chain_parity.cpp::chain_affine_graph_cdq) builds
// the same timeline over every family from the tree engine's bookkeeping.
//
// DP VALUES are f32 maxima and therefore order-independent — only
// backpointers depend on the search trees' tie resolution, and only on the
// traceback path. The core computes bit-identical dp values plus, per
// anchor, the winning structure / its max stored value / a TIE flag;
// anchors whose winning structure had a unique achiever get their exact
// backpointer here, and the (rare) tied steps are re-resolved by the
// caller with a host-side replica of the tree visit order (chain_ties.py).
//
// Complexity O(E log^2 E) over E events: CDQ over the timeline with stable
// partitions of a globally (family, shift, offset, kind)-sorted index (no
// per-cross sorting); each cross does two pointer+Fenwick sweeps per
// family (ascending for the "d1 < d2" channels, descending for "d1 > d2")
// and an equal-shift run pass for the gap-free channel; segments of at
// most BASE events compare their pairs directly. The device realization
// of the chain x chain case in ops/chain_cdq.py consumes the same offline
// timeline and is bit-identical (tests/test_torch_chain_cdq.py).

#include "chain_cdq_core.h"

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>
#include <chrono>
#include <cstdio>
#include <cstdlib>

namespace {

typedef int64_t i64;
typedef int32_t i32;
typedef uint8_t u8;
typedef uint32_t u32;
typedef float f32;

constexpr f32 MININF = std::numeric_limits<f32>::lowest();
constexpr int NPW = 3;
constexpr i64 BASE = 32;  // segments this small compare pairs directly

struct Cand {
    f32 v;
    i32 who;   // anchor id, -1 = none
    u8 tie;    // >= 2 distinct achievers of v among the dominated set
};

constexpr Cand NONE{MININF, -1, 0};

static inline void cand_merge(Cand& a, const Cand& b) {
    if (b.who < 0) return;
    if (a.who < 0 || b.v > a.v) {
        a = b;
    } else if (b.v == a.v) {
        a.tie = 1;
    }
}

static inline void cand_add(Cand& a, f32 v, i32 who) {
    if (a.who < 0 || v > a.v) {
        a.v = v;
        a.who = who;
        a.tie = 0;
    } else if (v == a.v) {
        a.tie = 1;
    }
}

// A candidate packed for branch-free maxima: the value's bits in an order-
// preserving u32 above the anchor id, twice — once with the id, once with
// its complement — so that one max of each gives the value, the largest
// and the smallest achiever; two achievers differ exactly when the value
// is tied. 0 is none.
struct Packed {
    uint64_t hi, lo;
};

static inline uint64_t value_key(f32 v) {
    uint32_t b;
    std::memcpy(&b, &v, 4);
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return (uint64_t)b << 32;
}

static inline f32 key_value(uint64_t k) {
    uint32_t b = (uint32_t)(k >> 32);
    b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
    f32 v;
    std::memcpy(&v, &b, 4);
    return v;
}

static inline Packed pack(f32 v, i32 who) {
    uint64_t k = value_key(v);
    return Packed{k | (uint32_t)who, k | (uint32_t)~(uint32_t)who};
}

static inline void packed_max(Packed& a, const Packed& b) {
    a.hi = std::max(a.hi, b.hi);
    a.lo = std::max(a.lo, b.lo);
}

// merge a packed maximum into a candidate
static inline void cand_merge(Cand& a, const Packed& p) {
    if (p.hi == 0) return;
    Cand b{key_value(p.hi), (i32)(uint32_t)p.hi,
           (u8)((uint32_t)p.hi != ~(uint32_t)p.lo)};
    cand_merge(a, b);
}

// prefix-max Fenwick over offset ranks, 3 channels, lazy epoch reset
struct Fenwick3 {
    i64 n;
    std::vector<u32> epoch;
    std::vector<Packed> c;  // 3 per node
    u32 cur = 0;

    void init(i64 n_) {
        n = n_;
        epoch.assign(n + 1, 0);
        c.assign(3 * (n + 1), Packed{0, 0});
        cur = 0;
    }
    void reset() { ++cur; }
    inline Packed* node(i64 x) {
        if (epoch[x] != cur) {
            epoch[x] = cur;
            c[3 * x] = c[3 * x + 1] = c[3 * x + 2] = Packed{0, 0};
        }
        return &c[3 * x];
    }
    inline void update(i64 rank, const f32 v[3], i32 who) {
        Packed p[3] = {pack(v[0], who), pack(v[1], who), pack(v[2], who)};
        for (i64 x = rank + 1; x <= n; x += x & (-x)) {
            Packed* nd = node(x);
            for (int k = 0; k < 3; ++k) packed_max(nd[k], p[k]);
        }
    }
    // max over ranks [0, hi)   (hi = exclusive prefix count)
    inline void query(i64 hi, Packed out[3]) {
        for (int k = 0; k < 3; ++k) out[k] = Packed{0, 0};
        for (i64 x = hi; x > 0; x -= x & (-x)) {
            Packed* nd = node(x);
            for (int k = 0; k < 3; ++k) packed_max(out[k], nd[k]);
        }
    }
};

// one event, carried whole through the CDQ partitions so that the cross
// passes read their events in sequence
struct Ev {
    i64 skey;   // shift for inserts, qshift for queries
    i32 t;      // time rank (the CDQ index)
    i32 orank;  // insert: Fenwick rank of its offset; query: the number of
                // distinct insert offsets below its bound
    i32 fam;
    i32 aid;
    i32 slot;   // index among the events of its kind
    u8 kind;    // 0 = query, 1 = insert
};

// the global order of a cross step's halves: family, shift, offset, then
// queries before inserts (an insert at a query's offset bound is outside
// it), then time
static inline bool key_less(const Ev& a, const Ev& b) {
    if (a.fam != b.fam) return a.fam < b.fam;
    if (a.skey != b.skey) return a.skey < b.skey;
    if (a.orank != b.orank) return a.orank < b.orank;
    if (a.kind != b.kind) return a.kind < b.kind;
    return a.t < b.t;
}

struct Engine {
    i64 n;                 // anchors
    i64 E;                 // events
    const f32* w;
    double ck[NPW];        // scale * gap_extend[k]
    double go_[NPW], ge_[NPW];
    double scale;
    centrolign_cdq::Outputs out;

    std::vector<f32> dp;
    std::vector<i64> orig;      // creation index by time rank
    std::vector<f32> stored;    // 6 per insert: [2k]=even(d1<d2), [2k+1]=odd
    std::vector<Cand> qacc;     // 7 per query: [0]=gf, [1+pw] pw=0..5

    std::vector<Ev> byshift;    // CDQ working order over events
    std::vector<Ev> scratch;    // partition scratch
    std::vector<Ev> left_buf;   // per-depth copies of left halves
    std::vector<i64> left_base; // offset of each depth's copy in left_buf
    Fenwick3 fen;

    // ---- exact reference arithmetic -------------------------------
    inline void store_channels(const Ev& e) {
        double d = (double)dp[e.aid];
        i64 sh = e.skey;
        f32* st = &stored[6 * (i64)e.slot];
        for (int k = 0; k < NPW; ++k) {
            st[2 * k] = (f32)(d - ck[k] * (double)sh);      // pw even: d1<d2
            st[2 * k + 1] = (f32)(d + ck[k] * (double)sh);  // pw odd: d1>d2
        }
    }

    // fold one query's candidates into its anchor in the reference's
    // update_dp order: gf, then pw = 0..5 (anchorer.hpp:2381-2420), strict
    // >, after the anchor's earlier queries
    void finalize_query(const Ev& e) {
        i64 a = e.aid;
        f32 best = dp[a];
        const Cand* acc = &qacc[7 * (i64)e.slot];
        double q = (double)e.skey;
        f32 ww = w[a];
        for (int c = 0; c < 7; ++c) {
            const Cand& cd = acc[c];
            if (cd.who < 0) continue;
            f32 value;
            if (c == 0) {
                value = cd.v + ww;
            } else {
                int pw = c - 1;
                int k = pw / 2;
                double inner = (pw % 2 == 1) ? (go_[k] + ge_[k] * q)
                                             : (go_[k] - ge_[k] * q);
                value = (f32)((double)(f32)(cd.v + ww) - scale * inner);
            }
            if (value > best) {
                best = value;
                out.bp[a] = cd.who;
                out.tie[a] = cd.tie;
                out.strct[a] = (u8)c;
                out.stored[a] = cd.v;
                out.win[a] = orig[e.t];
            }
        }
        dp[a] = best;
    }

    // ---- CDQ -------------------------------------------------------
    // byshift[lo:hi) holds the events of time range [lo,hi) in key_less
    // order
    void solve(i64 lo, i64 hi, int depth) {
        if (hi - lo <= BASE) {
            brute(lo, hi);
            return;
        }
        i64 mid = (lo + hi) / 2;
        // stable partition byshift[lo:hi) by time (< mid left)
        i64 nl = 0, nr = 0;
        for (i64 k = lo; k < hi; ++k) {
            const Ev& e = byshift[k];
            if (e.t < mid) scratch[lo + nl++] = e;
            else scratch[mid + nr++] = e;
        }
        std::memcpy(&byshift[lo], &scratch[lo], (hi - lo) * sizeof(Ev));
        // keep the left half's key order for the cross step (the left
        // recursion below re-partitions it)
        Ev* lb = &left_buf[left_base[depth]];
        std::memcpy(lb, &byshift[lo], (mid - lo) * sizeof(Ev));
        solve(lo, mid, depth + 1);
        cross(lb, mid - lo, &byshift[mid], hi - mid);
        solve(mid, hi, depth + 1);
    }

    // a segment of time ranks [lo, hi) whose queries already hold every
    // insert before lo: its own pairs, in time order
    void brute(i64 lo, i64 hi) {
        Ev* seg = &scratch[lo];
        i64 m = hi - lo;
        for (i64 k = 0; k < m; ++k) seg[byshift[lo + k].t - lo] = byshift[lo + k];
        for (i64 t = 0; t < m; ++t) {
            const Ev& e = seg[t];
            if (e.kind == 1) {
                store_channels(e);
                continue;
            }
            Cand* acc = &qacc[7 * (i64)e.slot];
            for (i64 s = 0; s < t; ++s) {
                const Ev& d = seg[s];
                if (d.kind != 1 || d.fam != e.fam || d.orank >= e.orank)
                    continue;
                const f32* st = &stored[6 * (i64)d.slot];
                if (d.skey < e.skey) {
                    for (int k = 0; k < NPW; ++k)
                        cand_add(acc[2 + 2 * k], st[2 * k + 1], d.aid);
                } else if (d.skey > e.skey) {
                    for (int k = 0; k < NPW; ++k)
                        cand_add(acc[1 + 2 * k], st[2 * k], d.aid);
                } else {
                    cand_add(acc[0], dp[d.aid], d.aid);
                }
            }
            finalize_query(e);
        }
    }

    void cross(const Ev* L, i64 nl, const Ev* R, i64 nr) {
        // L: left-half events in key order — inserts have finalized
        // stored values; R: right-half events, same order.
        if (nl == 0 || nr == 0) return;

        // ascending pass: pw odd channels (shift_i < qshift) + gap-free
        // (shift_i == qshift, walked inline as equal-skey runs), one
        // family at a time
        {
            i64 li = 0;
            i64 gi = 0;  // gf pointer over L
            i32 cur_fam = -1;
            i64 run_key = 0;
            bool run_open = false;
            Cand run = NONE;
            Packed fres[3];
            for (i64 ri = 0; ri < nr; ++ri) {
                const Ev& e = R[ri];
                if (e.kind != 0) continue;
                i64 q = e.skey;
                if (e.fam != cur_fam) {
                    fen.reset();
                    cur_fam = e.fam;
                    while (li < nl && L[li].fam < cur_fam) ++li;
                    gi = li;
                    run_open = false;
                }
                // flush the family's inserts with skey < q into the Fenwick
                for (; li < nl; ++li) {
                    const Ev& d = L[li];
                    if (d.fam != cur_fam || d.skey >= q) break;
                    if (d.kind != 1) continue;
                    const f32* st = &stored[6 * (i64)d.slot];
                    f32 v[3] = {st[1], st[3], st[5]};
                    fen.update(d.orank, v, d.aid);
                }
                Cand* acc = &qacc[7 * (i64)e.slot];
                fen.query(e.orank, fres);
                cand_merge(acc[1 + 1], fres[0]);  // pw1 (odd k0)
                cand_merge(acc[1 + 3], fres[1]);  // pw3
                cand_merge(acc[1 + 5], fres[2]);  // pw5
                // gap-free: advance gf pointer through the family's
                // inserts with (skey, orank, kind) < (q, orank_query, 1);
                // queries sort before inserts at equal (skey, orank), so
                // inserts at the offset bound are correctly excluded
                if (!run_open || run_key != q) {
                    // (re)scan: runs are visited in ascending q order by
                    // both sides, so gi never moves backwards
                    run = NONE;
                    run_open = true;
                    run_key = q;
                }
                for (; gi < nl; ++gi) {
                    const Ev& d = L[gi];
                    if (d.fam != cur_fam || d.skey > q ||
                        (d.skey == q && d.orank >= e.orank)) break;
                    if (d.kind == 1 && d.skey == q)
                        cand_add(run, dp[d.aid], d.aid);
                }
                cand_merge(acc[0], run);
            }
        }
        // descending pass: pw even channels (shift_i > qshift)
        {
            i64 li = nl - 1;
            i32 cur_fam = -1;
            Packed fres[3];
            for (i64 ri = nr - 1; ri >= 0; --ri) {
                const Ev& e = R[ri];
                if (e.kind != 0) continue;
                i64 q = e.skey;
                if (e.fam != cur_fam) {
                    fen.reset();
                    cur_fam = e.fam;
                    while (li >= 0 && L[li].fam > cur_fam) --li;
                }
                for (; li >= 0; --li) {
                    const Ev& d = L[li];
                    if (d.fam != cur_fam || d.skey <= q) break;
                    if (d.kind != 1) continue;
                    const f32* st = &stored[6 * (i64)d.slot];
                    f32 v[3] = {st[0], st[2], st[4]};
                    fen.update(d.orank, v, d.aid);
                }
                Cand* acc = &qacc[7 * (i64)e.slot];
                fen.query(e.orank, fres);
                cand_merge(acc[1 + 0], fres[0]);  // pw0 (even k0)
                cand_merge(acc[1 + 2], fres[1]);  // pw2
                cand_merge(acc[1 + 4], fres[2]);  // pw4
            }
        }
    }
};

}  // namespace

namespace centrolign_cdq {

bool affine_values(Timeline& tl, i64 n, const f32* w, const f32* init,
                   const double* gap_open, const double* gap_extend,
                   double scale, Outputs out) {
    std::fill(out.bp, out.bp + n, (i64)-1);
    std::fill(out.tie, out.tie + n, (u8)0);
    std::fill(out.strct, out.strct + n, (u8)255);
    std::fill(out.stored, out.stored + n, MININF);
    std::fill(out.win, out.win + n, (i64)-1);
    if (n >= (i64)std::numeric_limits<i32>::max() ||
        tl.size() >= (i64)std::numeric_limits<i32>::max())
        return false;
    std::memcpy(out.dp, init, n * sizeof(f32));
    if (n == 0) return true;
    const bool timing = getenv("CHAIN_PARITY_DEBUG") != nullptr;
    auto t_setup = std::chrono::steady_clock::now();
    Engine eng;
    eng.n = n;
    eng.w = w;
    eng.out = out;
    eng.scale = scale;
    for (int k = 0; k < NPW; ++k) {
        eng.ck[k] = scale * gap_extend[k];
        eng.go_[k] = gap_open[k];
        eng.ge_[k] = gap_extend[k];
    }
    eng.dp.assign(init, init + n);
    const i64 E = tl.size();
    eng.E = E;

    // offset ranks over the distinct insert offsets (Fenwick domain);
    // query prefix bound = #distinct insert offsets < its exclusive bound
    // (offsets are node indices: a dense table unless they are far apart)
    i64 omin = 0, omax = -1;
    for (i64 i = 0; i < E; ++i) {
        omin = std::min(omin, tl.okey[i]);
        omax = std::max(omax, tl.okey[i]);
    }
    std::vector<i32> dense;
    std::vector<i64> offs;
    if (omin >= 0 && omax < 8 * E + (1 << 20)) {
        dense.assign(omax + 2, 0);
        for (i64 i = 0; i < E; ++i)
            if (tl.kind[i] == 1) dense[tl.okey[i] + 1] = 1;
        for (i64 o = 1; o < (i64)dense.size(); ++o) dense[o] += dense[o - 1];
        eng.fen.init(dense.back());
    } else {
        for (i64 i = 0; i < E; ++i)
            if (tl.kind[i] == 1) offs.push_back(tl.okey[i]);
        std::sort(offs.begin(), offs.end());
        offs.erase(std::unique(offs.begin(), offs.end()), offs.end());
        eng.fen.init((i64)offs.size());
    }
    auto orank = [&](i64 o) -> i32 {
        if (!dense.empty()) return dense[std::min(o, omax + 1)];
        return (i32)(std::lower_bound(offs.begin(), offs.end(), o) -
                     offs.begin());
    };

    // time order: a stable sort of the events by time (same-time events
    // are mutually independent; an anchor's same-time queries keep their
    // creation order, which is the fold order), by counting when the
    // times are dense
    std::vector<i64> by_time(E);
    i64 tmin = E ? tl.time[0] : 0, tmax = tmin;
    for (i64 i = 0; i < E; ++i) {
        tmin = std::min(tmin, tl.time[i]);
        tmax = std::max(tmax, tl.time[i]);
    }
    if (tmax - tmin < 8 * E + (1 << 20)) {
        std::vector<i64> start(tmax - tmin + 2, 0);
        for (i64 i = 0; i < E; ++i) ++start[tl.time[i] - tmin + 1];
        for (i64 k = 1; k < (i64)start.size(); ++k) start[k] += start[k - 1];
        for (i64 i = 0; i < E; ++i) by_time[start[tl.time[i] - tmin]++] = i;
    } else {
        for (i64 i = 0; i < E; ++i) by_time[i] = i;
        std::stable_sort(by_time.begin(), by_time.end(), [&](i64 a, i64 b) {
            return tl.time[a] < tl.time[b];
        });
    }
    eng.byshift.resize(E);
    i32 nq = 0, ni = 0;
    for (i64 t = 0; t < E; ++t) {
        i64 i = by_time[t];
        Ev& e = eng.byshift[t];
        e.skey = tl.skey[i];
        e.t = (i32)t;
        e.orank = orank(tl.okey[i]);
        e.fam = tl.fam[i];
        e.aid = tl.aid[i];
        e.kind = tl.kind[i];
        e.slot = e.kind == 1 ? ni++ : nq++;
    }
    tl = Timeline();
    eng.orig.swap(by_time);
    eng.stored.assign(6 * (i64)ni, MININF);
    eng.qacc.assign(7 * (i64)nq, NONE);
    std::sort(eng.byshift.begin(), eng.byshift.end(), key_less);
    eng.scratch.resize(E);
    // the left half at depth d is at most half the longest segment there
    for (i64 seg = E, base = 0;; seg -= seg / 2) {
        eng.left_base.push_back(base);
        base += seg / 2;
        if (seg <= 1) {
            eng.left_buf.resize(base + 1);
            break;
        }
    }

    auto t_solve = std::chrono::steady_clock::now();
    eng.solve(0, E, 0);
    if (timing)
        fprintf(stderr, "[cdq] %lld events, set-up %.2fs, solve %.2fs\n",
                (long long)E,
                std::chrono::duration<double>(t_solve - t_setup).count(),
                std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t_solve).count());

    std::memcpy(out.dp, eng.dp.data(), n * sizeof(f32));
    return true;
}

}  // namespace centrolign_cdq

extern "C" {

// dp/bp/tie for SparseAffine chaining on chain x chain inputs.
// s1/e1/s2/e2: per-anchor chain indices of walk endpoints (index_on the
// single real chain). init_dp: f32 initial DP (anchor weight + lead indel,
// MININF-gated). Returns 0 on success.
i64 chain_affine_cdq(
        i64 n, const i64* s1, const i64* e1, const i64* s2, const i64* e2,
        const float* w, const float* init_dp,
        const double* gap_open, const double* gap_extend, double scale,
        float* out_dp, i64* out_bp, u8* out_tie, u8* out_struct,
        float* out_stored, i64* out_qshift) {
    // events: inserts always; queries only when the start has a chain
    // predecessor (reference predecessor_index != -1, forward_edges.hpp:45)
    centrolign_cdq::Timeline tl;
    tl.kind.reserve(2 * n);
    tl.aid.reserve(2 * n);
    tl.fam.reserve(2 * n);
    tl.skey.reserve(2 * n);
    tl.okey.reserve(2 * n);
    tl.time.reserve(2 * n);
    for (i64 a = 0; a < n; ++a) {
        tl.add(1, a, 0, e1[a] - e2[a], e2[a], 2 * e1[a]);
        i64 q = s1[a] - s2[a];
        out_qshift[a] = q;
        if (s1[a] >= 1) tl.add(0, a, 0, q, s2[a], 2 * s1[a] - 1);
    }
    std::vector<i64> win(n);
    centrolign_cdq::Outputs out{out_dp, out_bp, out_tie, out_struct,
                                out_stored, win.data()};
    bool ok = centrolign_cdq::affine_values(tl, n, w, init_dp, gap_open,
                                            gap_extend, scale, out);
    return ok ? 0 : 1;
}

}  // extern "C"
