// Native partial-order x partial-order Gotoh alignment — behavioral twin of
// the reference po_poa (reference include/centrolign/alignment.hpp:753-1150)
// and a direct port of centrolign_tpu/ops/popoa_ref.py (the validated numpy
// oracle): identical fill recurrence and identical traceback tie-breaking.
//
// Also exports graph utility sweeps that are host-latency-bound in Python:
// topological order (Kahn) and source min/max walk distances.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

using i64 = int64_t;
using i32 = int32_t;

constexpr i32 MININF32 = std::numeric_limits<i32>::min() / 2;

static void kahn_topo(i64 V, const i64* nptr, const i64* nind,
                      const i64* pptr, i64* order) {
    std::vector<i64> indeg(V);
    for (i64 v = 0; v < V; ++v) indeg[v] = pptr[v + 1] - pptr[v];
    i64 head = 0, tail = 0;
    for (i64 v = 0; v < V; ++v) if (indeg[v] == 0) order[tail++] = v;
    while (head < tail) {
        i64 v = order[head++];
        for (i64 k = nptr[v]; k < nptr[v + 1]; ++k) {
            if (--indeg[nind[k]] == 0) order[tail++] = nind[k];
        }
    }
}

}  // namespace

extern "C" {

void topological_order_native(i64 V, const i64* nptr, const i64* nind,
                              const i64* pptr, i64* order) {
    kahn_topo(V, nptr, nind, pptr, order);
}

// min/max walk distance (in nodes) from the given sources; unreachable = -1.
void minmax_distance_native(i64 V, const i64* nptr, const i64* nind,
                            const i64* pptr, const i64* pind,
                            i64 n_sources, const i64* sources,
                            i64* mind, i64* maxd) {
    std::vector<i64> order(V);
    kahn_topo(V, nptr, nind, pptr, order.data());
    const i64 IMAX = std::numeric_limits<i64>::max();
    const i64 IMIN = std::numeric_limits<i64>::min();
    for (i64 v = 0; v < V; ++v) { mind[v] = IMAX; maxd[v] = IMIN; }
    for (i64 s = 0; s < n_sources; ++s) { mind[sources[s]] = 0; maxd[sources[s]] = 0; }
    for (i64 oi = 0; oi < V; ++oi) {
        i64 v = order[oi];
        for (i64 k = pptr[v]; k < pptr[v + 1]; ++k) {
            i64 p = pind[k];
            if (maxd[p] != IMIN) {
                if (mind[p] + 1 < mind[v]) mind[v] = mind[p] + 1;
                if (maxd[p] + 1 > maxd[v]) maxd[v] = maxd[p] + 1;
            }
        }
    }
    for (i64 v = 0; v < V; ++v) {
        if (maxd[v] == IMIN) { mind[v] = -1; maxd[v] = -1; }
    }
}

// PO-POA fill + traceback. Returns alignment length; out_pairs must have
// room for 2*(V1+V2+2) entries; score written to *out_score. GAP = -1.
i64 popoa_align_native(
        i64 V1, const uint8_t* lab1,
        const i64* n1ptr, const i64* n1ind,
        const i64* p1ptr, const i64* p1ind,
        i64 V2, const uint8_t* lab2,
        const i64* n2ptr, const i64* n2ind,
        const i64* p2ptr, const i64* p2ind,
        i64 ns1, const i64* sources1, i64 ns2, const i64* sources2,
        i64 nk1, const i64* sinks1, i64 nk2, const i64* sinks2,
        i32 match, i32 mismatch, i32 npw, const i32* go, const i32* ge,
        i64* out_pairs, i64* out_score) {

    const i64 W = V2 + 1;
    const i64 R = V1 + 1;
    std::vector<i32> M((size_t)R * W, MININF32);
    std::vector<i32> I((size_t)npw * R * W, MININF32);
    std::vector<i32> D((size_t)npw * R * W, MININF32);
    auto Mi = [&](i64 i, i64 j) -> i32& { return M[(size_t)i * W + j]; };
    auto Ii = [&](i32 pw, i64 i, i64 j) -> i32& {
        return I[((size_t)pw * R + i) * W + j]; };
    auto Di = [&](i32 pw, i64 i, i64 j) -> i32& {
        return D[((size_t)pw * R + i) * W + j]; };

    std::vector<i64> order1(V1), order2(V2);
    kahn_topo(V1, n1ptr, n1ind, p1ptr, order1.data());
    kahn_topo(V2, n2ptr, n2ind, p2ptr, order2.data());

    std::vector<uint8_t> is_src1(V1, 0), is_src2(V2, 0);
    for (i64 s = 0; s < ns1; ++s) is_src1[sources1[s]] = 1;
    for (i64 s = 0; s < ns2; ++s) is_src2[sources2[s]] = 1;

    // corner inits (reference alignment.hpp:813-830)
    for (i64 a = 0; a < ns1; ++a) {
        i64 s1 = sources1[a];
        for (i64 b = 0; b < ns2; ++b) {
            i64 s2 = sources2[b];
            i32 sc = (lab1[s1] == lab2[s2]) ? match : -mismatch;
            if (sc > Mi(s1, s2)) Mi(s1, s2) = sc;
        }
        for (i32 pw = 0; pw < npw; ++pw) Ii(pw, s1, V2) = -go[pw] - ge[pw];
    }
    for (i64 b = 0; b < ns2; ++b) {
        i64 s2 = sources2[b];
        for (i32 pw = 0; pw < npw; ++pw) Di(pw, V1, s2) = -go[pw] - ge[pw];
    }

    // boundary row: lead deletions along graph2 (alignment.hpp:861-895)
    for (i64 oi = 0; oi < V2; ++oi) {
        i64 n2 = order2[oi];
        i32 dmax = MININF32;
        for (i32 pw = 0; pw < npw; ++pw) dmax = std::max(dmax, Di(pw, V1, n2));
        if (dmax > Mi(V1, n2)) Mi(V1, n2) = dmax;
        for (i64 k = n2ptr[n2]; k < n2ptr[n2 + 1]; ++k) {
            i64 nx = n2ind[k];
            for (i32 pw = 0; pw < npw; ++pw) {
                i32 cand = Di(pw, V1, n2) - ge[pw];
                if (cand > Di(pw, V1, nx)) Di(pw, V1, nx) = cand;
            }
        }
    }

    // interior + boundary column, row-sweep in graph1 topo order
    std::vector<i64> pull_rows;
    std::vector<i32> Pmax(W);
    for (i64 oi = 0; oi < V1; ++oi) {
        i64 n1 = order1[oi];
        pull_rows.clear();
        for (i64 k = p1ptr[n1]; k < p1ptr[n1 + 1]; ++k)
            pull_rows.push_back(p1ind[k]);
        if (is_src1[n1]) pull_rows.push_back(V1);

        if (!pull_rows.empty()) {
            // I pull: open from M (not in boundary column), extend from I
            for (i32 pw = 0; pw < npw; ++pw) {
                i32 goge = go[pw] + ge[pw];
                i32* In1 = &Ii(pw, n1, 0);
                for (i64 p : pull_rows) {
                    const i32* Mp = &Mi(p, 0);
                    const i32* Ip = &Ii(pw, p, 0);
                    for (i64 j = 0; j < V2; ++j) {
                        i32 c = std::max(Mp[j] - goge, Ip[j] - ge[pw]);
                        if (c > In1[j]) In1[j] = c;
                    }
                    i32 c = Ip[V2] - ge[pw];  // boundary column extends only
                    if (c > In1[V2]) In1[V2] = c;
                }
            }
            // diagonal pull
            for (i64 j = 0; j <= V2; ++j) {
                i32 best = MININF32;
                for (i64 p : pull_rows) best = std::max(best, Mi(p, j));
                Pmax[j] = best;
            }
            for (i64 j = 0; j < V2; ++j) {
                i32 q = MININF32;
                for (i64 k = p2ptr[j]; k < p2ptr[j + 1]; ++k)
                    q = std::max(q, Pmax[p2ind[k]]);
                if (is_src2[j]) q = std::max(q, Pmax[V2]);
                if (q > MININF32 / 2) {
                    i32 sc = (lab1[n1] == lab2[j]) ? match : -mismatch;
                    if (q + sc > Mi(n1, j)) Mi(n1, j) = q + sc;
                }
            }
        }

        // fold I into M in the boundary column
        {
            i32 imax = MININF32;
            for (i32 pw = 0; pw < npw; ++pw)
                imax = std::max(imax, Ii(pw, n1, V2));
            if (imax > Mi(n1, V2)) Mi(n1, V2) = imax;
        }

        // within-row D propagation in graph2 topo order
        if (Mi(n1, V2) > MININF32 / 2) {
            for (i64 b = 0; b < ns2; ++b) {
                i64 s2 = sources2[b];
                for (i32 pw = 0; pw < npw; ++pw) {
                    i32 c = Mi(n1, V2) - go[pw] - ge[pw];
                    if (c > Di(pw, n1, s2)) Di(pw, n1, s2) = c;
                }
            }
        }
        for (i64 oj = 0; oj < V2; ++oj) {
            i64 n2 = order2[oj];
            i32 m = Mi(n1, n2);
            for (i32 pw = 0; pw < npw; ++pw) {
                m = std::max(m, Ii(pw, n1, n2));
                m = std::max(m, Di(pw, n1, n2));
            }
            Mi(n1, n2) = m;
            for (i64 k = n2ptr[n2]; k < n2ptr[n2 + 1]; ++k) {
                i64 nx = n2ind[k];
                for (i32 pw = 0; pw < npw; ++pw) {
                    i32 cand = std::max(m - go[pw] - ge[pw],
                                        Di(pw, n1, n2) - ge[pw]);
                    if (cand > Di(pw, n1, nx)) Di(pw, n1, nx) = cand;
                }
            }
        }
    }

    // --- traceback (alignment.hpp:1010-1145; popoa_ref.py popoa_traceback)
    i64 tb1 = -1, tb2 = -1;
    if (V1 && V2) {
        for (i64 a = 0; a < nk1; ++a)
            for (i64 b = 0; b < nk2; ++b) {
                i64 s1 = sinks1[a], s2 = sinks2[b];
                if (tb1 == -1 || Mi(s1, s2) > Mi(tb1, tb2)) { tb1 = s1; tb2 = s2; }
            }
    } else if (V1) {
        for (i64 a = 0; a < nk1; ++a) {
            i64 s1 = sinks1[a];
            if (tb1 == -1 || Mi(s1, 0) > Mi(tb1, 0)) { tb1 = s1; tb2 = 0; }
        }
    } else if (V2) {
        for (i64 b = 0; b < nk2; ++b) {
            i64 s2 = sinks2[b];
            if (tb2 == -1 || Mi(0, s2) > Mi(0, tb2)) { tb1 = 0; tb2 = s2; }
        }
    }

    *out_score = (tb1 != -1) ? (i64)Mi(tb1, tb2) : 0;

    i64 len = 0;
    i32 tb_comp = 0;
    std::vector<i64> prev1v, prev2v;
    while (tb1 != -1 && tb2 != -1) {
        i64 here1 = tb1, here2 = tb2;
        tb1 = tb2 = -1;
        if (tb_comp == 0) {
            for (i32 pw = 0; pw < npw; ++pw) {
                if (Mi(here1, here2) == Ii(pw, here1, here2)) { tb_comp = pw + 1; break; }
                if (Mi(here1, here2) == Di(pw, here1, here2)) { tb_comp = -pw - 1; break; }
            }
        }
        prev1v.clear(); prev2v.clear();
        if (here1 < V1)
            for (i64 k = p1ptr[here1]; k < p1ptr[here1 + 1]; ++k)
                prev1v.push_back(p1ind[k]);
        if (here2 < V2)
            for (i64 k = p2ptr[here2]; k < p2ptr[here2 + 1]; ++k)
                prev2v.push_back(p2ind[k]);
        if (here1 < V1 && is_src1[here1]) prev1v.push_back(V1);
        if (here1 == V1) { /* boundary row has no prev1 */ }
        if (here2 < V2 && is_src2[here2]) prev2v.push_back(V2);

        if (tb_comp == 0) {
            out_pairs[2 * len] = here1; out_pairs[2 * len + 1] = here2; ++len;
            i32 a = (lab1[here1] == lab2[here2]) ? match : -mismatch;
            i32 target = Mi(here1, here2);
            for (i64 p1 : prev1v) {
                for (i64 p2 : prev2v) {
                    if (Mi(p1, p2) + a == target) { tb1 = p1; tb2 = p2; break; }
                }
                // last prev1 with a matching (first) prev2 wins: keep looping
            }
        } else if (tb_comp > 0) {
            i32 pw = tb_comp - 1;
            out_pairs[2 * len] = here1; out_pairs[2 * len + 1] = -1; ++len;
            i32 v = Ii(pw, here1, here2);
            for (i64 p1 : prev1v) {
                if (v == Mi(p1, here2) - go[pw] - ge[pw]) {
                    tb_comp = 0; tb1 = p1; tb2 = here2; break;
                }
                if (v == Ii(pw, p1, here2) - ge[pw]) { tb1 = p1; tb2 = here2; break; }
            }
        } else {
            i32 pw = -tb_comp - 1;
            out_pairs[2 * len] = -1; out_pairs[2 * len + 1] = here2; ++len;
            i32 v = Di(pw, here1, here2);
            for (i64 p2 : prev2v) {
                if (v == Mi(here1, p2) - go[pw] - ge[pw]) {
                    tb_comp = 0; tb1 = here1; tb2 = p2; break;
                }
                if (v == Di(pw, here1, p2) - ge[pw]) { tb1 = here1; tb2 = p2; break; }
            }
        }
    }

    // reverse pairs in place
    for (i64 k = 0; k < len / 2; ++k) {
        std::swap(out_pairs[2 * k], out_pairs[2 * (len - 1 - k)]);
        std::swap(out_pairs[2 * k + 1], out_pairs[2 * (len - 1 - k) + 1]);
    }
    return len;
}

}  // extern "C"
