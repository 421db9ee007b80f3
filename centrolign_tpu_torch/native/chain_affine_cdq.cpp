// SparseAffine chaining VALUES on chain x chain graphs via offline CDQ
// divide-and-conquer — a flat sort/scan/Fenwick replacement for the
// reference's per-(path1,path2) OrthogonalMaxSearchTree sweep
// (reference sparse_affine_chain_dp, anchorer.hpp:1812-2470), valid when
// both graphs are single chains (every leaf-level subproblem and every
// pairwise run): there is exactly one real (path1, path2) combination, the
// topological sweep linearizes to an event timeline, and the whole DP
// becomes a 3-D dominance problem over (time, shift, offset):
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
// DP VALUES are f32 maxima and therefore order-independent — only
// backpointers depend on the search trees' tie resolution, and only on the
// traceback path. This engine computes bit-identical dp values plus, per
// anchor, the winning structure / its max stored value / a TIE flag;
// anchors whose winning structure had a unique achiever get their exact
// backpointer here, and the (rare) tied steps are re-resolved by the
// caller with a host-side replica of the tree visit order
// (anchorer.py::_AffineTieResolver).
//
// Complexity O(n log^2 n): CDQ over the timeline with stable partitions of
// a globally (shift, offset, kind)-sorted index (no per-cross sorting);
// each cross does two pointer+Fenwick sweeps (ascending for the "d1 < d2"
// channels, descending for "d1 > d2") and an equal-shift run pass for the
// gap-free channel. The device (jnp) realization in ops/chain_cdq.py
// consumes the same offline timeline (start-sorted lax.scan with dense
// masked channel maxima in place of the Fenwick sweeps) and is
// bit-identical on f64-capable backends (tests/test_chain_cdq.py).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

typedef int64_t i64;
typedef int32_t i32;
typedef uint8_t u8;
typedef uint32_t u32;
typedef float f32;

constexpr f32 MININF = std::numeric_limits<f32>::lowest();
constexpr int NPW = 3;

struct Cand {
    f32 v;
    i64 who;   // anchor id, -1 = none
    u8 tie;    // >= 2 distinct achievers of v among the dominated set
};

static inline void cand_merge(Cand& a, const Cand& b) {
    if (b.who < 0) return;
    if (a.who < 0 || b.v > a.v) {
        a = b;
    } else if (b.v == a.v) {
        a.tie = 1;
    }
}

static inline void cand_add(Cand& a, f32 v, i64 who) {
    if (a.who < 0 || v > a.v) {
        a.v = v;
        a.who = who;
        a.tie = 0;
    } else if (v == a.v) {
        a.tie = 1;
    }
}

// prefix-max Fenwick over offset ranks, 3 channels, lazy epoch reset
struct Fenwick3 {
    i64 n;
    std::vector<u32> epoch;
    std::vector<Cand> c;  // 3 per node
    u32 cur = 0;

    void init(i64 n_) {
        n = n_;
        epoch.assign(n + 1, 0);
        c.assign(3 * (n + 1), Cand{MININF, -1, 0});
        cur = 0;
    }
    void reset() { ++cur; }
    inline Cand* node(i64 x) {
        if (epoch[x] != cur) {
            epoch[x] = cur;
            c[3 * x] = c[3 * x + 1] = c[3 * x + 2] = Cand{MININF, -1, 0};
        }
        return &c[3 * x];
    }
    inline void update(i64 rank, const f32 v[3], i64 who) {
        for (i64 x = rank + 1; x <= n; x += x & (-x)) {
            Cand* nd = node(x);
            for (int k = 0; k < 3; ++k) cand_add(nd[k], v[k], who);
        }
    }
    // max over ranks [0, hi)   (hi = exclusive prefix count)
    inline void query(i64 hi, Cand out[3]) {
        for (int k = 0; k < 3; ++k) out[k] = Cand{MININF, -1, 0};
        for (i64 x = hi; x > 0; x -= x & (-x)) {
            Cand* nd = node(x);
            for (int k = 0; k < 3; ++k) cand_merge(out[k], nd[k]);
        }
    }
};

struct Engine {
    i64 n;                 // anchors
    i64 E;                 // events
    // per anchor
    const i64 *s1, *e1, *s2, *e2;
    const f32 *w, *init_dp;
    double ck[NPW];        // scale * gap_extend[k]
    double go_[NPW], ge_[NPW];
    double scale;

    std::vector<f32> dp;
    std::vector<i64> qs;       // query shift per anchor
    std::vector<Cand> qacc;    // 7 per anchor: [0]=gf, [1+pw] pw=0..5
    std::vector<u8> has_query;

    // events by time rank: ev_time-sorted identity; per event:
    std::vector<i32> ev_kind;   // 0 = query, 1 = insert
    std::vector<i64> ev_aid;
    std::vector<i64> ev_skey;   // shift_i for inserts, qshift for queries
    std::vector<i64> ev_okey;   // offset_i / query offset bound
    std::vector<i64> ev_orank;  // insert: Fenwick rank; query: prefix count
    // stored channel values of inserts (filled at leaf finalization)
    std::vector<f32> stored;    // (E, 6): [2k]=even(d1<d2), [2k+1]=odd

    std::vector<i64> byshift;   // CDQ working permutation over events
    std::vector<i64> scratch;   // partition scratch (per call, reused)
    std::vector<i64> left_buf;  // per-level copies of left halves
    Fenwick3 fen;

    // ---- exact reference arithmetic -------------------------------
    inline void store_channels(i64 ev) {
        i64 a = ev_aid[ev];
        double d = (double)dp[a];
        i64 sh = ev_skey[ev];
        f32* st = &stored[6 * ev];
        for (int k = 0; k < NPW; ++k) {
            st[2 * k] = (f32)(d - ck[k] * (double)sh);      // pw even: d1<d2
            st[2 * k + 1] = (f32)(d + ck[k] * (double)sh);  // pw odd: d1>d2
        }
    }

    void finalize_query(i64 ev) {
        i64 a = ev_aid[ev];
        // fold candidates in the reference's update_dp order:
        // gf, then pw = 0..5  (anchorer.hpp:2381-2420); strict >
        f32 best = dp[a];  // init weight (or MININF)
        i64 bp = -1;
        u8 tie = 0, strct = 255;
        f32 stored_v = MININF;
        const Cand* acc = &qacc[7 * a];
        double q = (double)qs[a];
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
                bp = cd.who;
                tie = cd.tie;
                strct = (u8)c;
                stored_v = cd.v;
            }
        }
        dp[a] = best;
        out_bp[a] = bp;
        out_tie[a] = tie;
        out_struct[a] = strct;
        out_stored[a] = stored_v;
    }

    i64 *out_bp;
    u8 *out_tie, *out_struct;
    f32* out_stored;

    // ---- CDQ -------------------------------------------------------
    // byshift[lo:hi) holds the event ids of time range [lo,hi) sorted by
    // (skey, okey, kind) with kind: query(0) before insert(1)
    void solve(i64 lo, i64 hi, int depth) {
        if (hi - lo == 1) {
            i64 ev = byshift[lo];
            if (ev_kind[ev] == 0) finalize_query(ev);
            else store_channels(ev);
            return;
        }
        i64 mid = (lo + hi) / 2;
        // stable partition byshift[lo:hi) by time (< mid left)
        i64 nl = 0, nr = 0;
        for (i64 k = lo; k < hi; ++k) {
            i64 ev = byshift[k];
            if (ev < mid) scratch[lo + nl++] = ev;
            else scratch[hi - (hi - lo) + (mid - lo) + nr++] = ev;
        }
        std::memcpy(&byshift[lo], &scratch[lo], (hi - lo) * sizeof(i64));
        // keep the left half's shift order for the cross step (the left
        // recursion below re-partitions it)
        i64 base = depth * (E / 2 + 1);
        std::memcpy(&left_buf[base], &byshift[lo], (mid - lo) * sizeof(i64));
        solve(lo, mid, depth + 1);
        cross(&left_buf[base], mid - lo, &byshift[mid], hi - mid);
        solve(mid, hi, depth + 1);
    }

    void cross(const i64* L, i64 nl, const i64* R, i64 nr) {
        // L: left-half events sorted by (skey, okey, kind) — inserts have
        // finalized stored values; R: right-half events, same order.
        if (nl == 0 || nr == 0) return;

        // ascending pass: pw odd channels (shift_i < qshift) + gap-free
        // (shift_i == qshift, walked inline as equal-skey runs)
        {
            fen.reset();
            i64 li = 0;
            // gap-free run state: inserts from L with skey == run_key and
            // okey <= current position (strictly less enforced by order)
            i64 run_key = 0;
            bool run_open = false;
            Cand run{MININF, -1, 0};
            i64 gi = 0;  // gf pointer over L
            Cand fres[3];
            for (i64 ri = 0; ri < nr; ++ri) {
                i64 ev = R[ri];
                if (ev_kind[ev] != 0) continue;
                i64 q = ev_skey[ev];
                // flush inserts with skey < q into the Fenwick
                while (li < nl) {
                    i64 le = L[li];
                    if (ev_kind[le] != 1) { ++li; continue; }
                    if (ev_skey[le] >= q) break;
                    f32 v[3] = {stored[6 * le + 1], stored[6 * le + 3],
                                stored[6 * le + 5]};
                    fen.update(ev_orank[le], v, ev_aid[le]);
                    ++li;
                }
                i64 a = ev_aid[ev];
                fen.query(ev_orank[ev], fres);
                Cand* acc = &qacc[7 * a];
                cand_merge(acc[1 + 1], fres[0]);  // pw1 (odd k0)
                cand_merge(acc[1 + 3], fres[1]);  // pw3
                cand_merge(acc[1 + 5], fres[2]);  // pw5
                // gap-free: advance gf pointer through inserts with
                // (skey, okey, kind) < (q, okey_query, 1); queries sort
                // before inserts at equal (skey, okey), so equal-offset
                // inserts are correctly excluded
                if (!run_open || run_key != q) {
                    // (re)scan: runs are visited in ascending q order by
                    // both sides, so gi never moves backwards
                    run = Cand{MININF, -1, 0};
                    run_open = true;
                    run_key = q;
                }
                while (gi < nl) {
                    i64 le = L[gi];
                    if (ev_kind[le] != 1) { ++gi; continue; }
                    i64 ls = ev_skey[le];
                    if (ls > q ||
                        (ls == q && ev_okey[le] >= ev_okey[ev])) break;
                    if (ls == q)
                        cand_add(run, dp[ev_aid[le]], ev_aid[le]);
                    ++gi;
                }
                cand_merge(acc[0], run);
            }
        }
        // descending pass: pw even channels (shift_i > qshift)
        {
            fen.reset();
            i64 li = nl - 1;
            Cand fres[3];
            for (i64 ri = nr - 1; ri >= 0; --ri) {
                i64 ev = R[ri];
                if (ev_kind[ev] != 0) continue;
                i64 q = ev_skey[ev];
                while (li >= 0) {
                    i64 le = L[li];
                    if (ev_kind[le] != 1) { --li; continue; }
                    if (ev_skey[le] <= q) break;
                    f32 v[3] = {stored[6 * le + 0], stored[6 * le + 2],
                                stored[6 * le + 4]};
                    fen.update(ev_orank[le], v, ev_aid[le]);
                    --li;
                }
                i64 a = ev_aid[ev];
                fen.query(ev_orank[ev], fres);
                Cand* acc = &qacc[7 * a];
                cand_merge(acc[1 + 0], fres[0]);  // pw0 (even k0)
                cand_merge(acc[1 + 2], fres[1]);  // pw2
                cand_merge(acc[1 + 4], fres[2]);  // pw4
            }
        }
    }
};

}  // namespace

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
    if (n == 0) return 0;
    Engine eng;
    eng.n = n;
    eng.s1 = s1; eng.e1 = e1; eng.s2 = s2; eng.e2 = e2;
    eng.w = w; eng.init_dp = init_dp;
    eng.scale = scale;
    for (int k = 0; k < NPW; ++k) {
        eng.ck[k] = scale * gap_extend[k];
        eng.go_[k] = gap_open[k];
        eng.ge_[k] = gap_extend[k];
    }
    eng.dp.assign(init_dp, init_dp + n);
    eng.qacc.assign(7 * n, Cand{MININF, -1, 0});
    eng.qs.resize(n);
    eng.out_bp = out_bp;
    eng.out_tie = out_tie;
    eng.out_struct = out_struct;
    eng.out_stored = out_stored;
    std::fill(out_bp, out_bp + n, (i64)-1);
    std::fill(out_tie, out_tie + n, (u8)0);
    std::fill(out_struct, out_struct + n, (u8)255);
    std::fill(out_stored, out_stored + n, MININF);

    // events: inserts always; queries only when the start has a chain
    // predecessor (reference predecessor_index != -1, forward_edges.hpp:45)
    std::vector<i64> times;
    times.reserve(2 * n);
    eng.ev_kind.reserve(2 * n);
    eng.ev_aid.reserve(2 * n);
    eng.ev_skey.reserve(2 * n);
    eng.ev_okey.reserve(2 * n);
    for (i64 a = 0; a < n; ++a) {
        eng.ev_kind.push_back(1);
        eng.ev_aid.push_back(a);
        eng.ev_skey.push_back(e1[a] - e2[a]);
        eng.ev_okey.push_back(e2[a]);
        times.push_back(2 * e1[a]);
        i64 q = s1[a] - s2[a];
        eng.qs[a] = q;
        out_qshift[a] = q;
        if (s1[a] >= 1) {
            eng.ev_kind.push_back(0);
            eng.ev_aid.push_back(a);
            eng.ev_skey.push_back(q);
            eng.ev_okey.push_back(s2[a]);  // exclusive offset bound
            times.push_back(2 * s1[a] - 1);
        }
    }
    i64 E = (i64)times.size();
    eng.E = E;
    eng.stored.assign(6 * E, MININF);

    // time order: stable sort event ids by time (same-time events are
    // mutually independent)
    std::vector<i64> by_time(E);
    for (i64 i = 0; i < E; ++i) by_time[i] = i;
    std::stable_sort(by_time.begin(), by_time.end(),
                     [&](i64 a, i64 b) { return times[a] < times[b]; });
    // remap events into time-rank identity so CDQ indices ARE times
    std::vector<i64> rank(E);
    for (i64 i = 0; i < E; ++i) rank[by_time[i]] = i;
    {
        auto remap_i64 = [&](std::vector<i64>& v) {
            std::vector<i64> nv(E);
            for (i64 i = 0; i < E; ++i) nv[rank[i]] = v[i];
            v.swap(nv);
        };
        std::vector<i32> nk(E);
        for (i64 i = 0; i < E; ++i) nk[rank[i]] = eng.ev_kind[i];
        eng.ev_kind.assign(nk.begin(), nk.end());
        remap_i64(eng.ev_aid);
        remap_i64(eng.ev_skey);
        remap_i64(eng.ev_okey);
    }

    // offset ranks over the distinct insert offsets (Fenwick domain);
    // query prefix bound = #distinct insert offsets < its exclusive bound
    std::vector<i64> offs;
    offs.reserve(n);
    for (i64 i = 0; i < E; ++i)
        if (eng.ev_kind[i] == 1) offs.push_back(eng.ev_okey[i]);
    std::sort(offs.begin(), offs.end());
    offs.erase(std::unique(offs.begin(), offs.end()), offs.end());
    eng.ev_orank.resize(E);
    for (i64 i = 0; i < E; ++i) {
        eng.ev_orank[i] = std::lower_bound(offs.begin(), offs.end(),
                                           eng.ev_okey[i]) - offs.begin();
    }
    eng.fen.init((i64)offs.size());

    // global (skey, okey, kind) order with queries before inserts
    eng.byshift.resize(E);
    for (i64 i = 0; i < E; ++i) eng.byshift[i] = i;
    std::sort(eng.byshift.begin(), eng.byshift.end(), [&](i64 a, i64 b) {
        if (eng.ev_skey[a] != eng.ev_skey[b])
            return eng.ev_skey[a] < eng.ev_skey[b];
        if (eng.ev_okey[a] != eng.ev_okey[b])
            return eng.ev_okey[a] < eng.ev_okey[b];
        if (eng.ev_kind[a] != eng.ev_kind[b])
            return eng.ev_kind[a] < eng.ev_kind[b];
        return a < b;
    });
    eng.scratch.resize(E);
    int levels = 1;
    while (((i64)1 << levels) < E) ++levels;
    eng.left_buf.resize((i64)(levels + 2) * (E / 2 + 1));

    eng.solve(0, E, 0);

    std::memcpy(out_dp, eng.dp.data(), n * sizeof(f32));
    return 0;
}

}  // extern "C"
