// Native fill-in anchoring: the whole Anchorer fill-in loop
// (reference anchorer.hpp:619-800 + src/anchorer.cpp:136-230) in ONE call —
// per-gap subgraph extraction, path projection, match divvying, budget
// assignment, per-gap PathMerge construction, per-gap parity chaining, and
// the chain merge — so a pairwise subproblem costs one native round trip
// instead of thousands (the per-gap chains themselves call the parity
// engines in chain_parity.cpp in-memory).
//
// Behavioral-twin notes (what byte parity depends on):
//  - extraction DFS order == extractor.py extract_connecting_graph
//    (reference subgraph_extraction.hpp:35-118),
//  - projection first-encounter path order over the reference LIFO-Kahn
//    topological order (anchorer.hpp:588-616),
//  - divvy walk-endpoint mapping incl. the last-gap-wins fwd overwrite
//    (anchorer.hpp:700-800),
//  - per-gap budget_matches stable ordering + swap compaction
//    (anchorer.hpp:1108-1173),
//  - the graph1/graph2 memory switch (anchorer.hpp:1175-1210),
//  - merge gap/gap-score stitching (src/anchorer.cpp:156-230).
//
// Per-gap chains are independent; they run under OpenMP when enabled
// (the reference is single-threaded — host parallelism is free speedup).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>
#include <limits>
#include <unordered_set>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
using i64 = int64_t;
using u64 = uint64_t;
}

// engines from chain_parity.cpp (same shared object)
extern "C" {
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
    i64 out_cap, i64* out_rows, double* out_fvals);

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
    i64 out_cap, i64* out_rows, double* out_fvals);

void path_merge_build(
    i64 V, const i64* nptr, const i64* nind, const i64* pptr,
    const i64* pind,
    i64 P, const i64* path_off, const i64* path_nodes,
    i64 src_id, i64 snk_id,
    void* index_on, i64* path_head, void* table, int table_width);
}

namespace {

// ---------------------------------------------------------------- helpers

// reference LIFO-stack Kahn order (topological_order.hpp:12)
static void lifo_topo(i64 V, const i64* nptr, const i64* nind,
                      const i64* pptr, i64* out) {
    std::vector<i64> stack, indeg(V);
    i64 n = 0;
    for (i64 v = 0; v < V; ++v) {
        indeg[v] = pptr[v + 1] - pptr[v];
        if (indeg[v] == 0) stack.push_back(v);
    }
    while (!stack.empty()) {
        i64 v = stack.back();
        stack.pop_back();
        out[n++] = v;
        for (i64 k = nptr[v]; k < nptr[v + 1]; ++k) {
            if (--indeg[nind[k]] == 0) stack.push_back(nind[k]);
        }
    }
}

// stable counting-sort CSR from an edge list (matches BaseGraph._build_csr)
static void build_csr(i64 V, const std::vector<i64>& ef,
                      const std::vector<i64>& et,
                      std::vector<i64>& indptr, std::vector<i64>& ind) {
    indptr.assign(V + 1, 0);
    for (i64 f : ef) ++indptr[f + 1];
    for (i64 v = 0; v < V; ++v) indptr[v + 1] += indptr[v];
    ind.resize(ef.size());
    std::vector<i64> cursor(indptr.begin(), indptr.end() - 1);
    for (size_t e = 0; e < ef.size(); ++e) ind[cursor[ef[e]]++] = et[e];
}

template <typename TI>
struct ParentGraph {
    i64 V;
    const i64* nptr;
    const i64* nind;
    // xmerge view pieces used by extraction reachability
    i64 C;
    const TI* table;     // (V, C)
    const TI* index_on;  // (C, V)
    const i64* chain_id;  // (V,)
};

// one extracted subgraph (reference SubGraphInfo)
struct Extraction {
    std::vector<i64> back;          // sub id -> parent id
    std::vector<i64> ef, et;        // edge list in discovery order
    std::vector<i64> sources, sinks;
    i64 V() const { return (i64)back.size(); }
};

// extract_connecting_graph DFS (reference subgraph_extraction.hpp:35-118);
// epoch-tagged scratch shared across gaps of the same parent graph
template <typename TI>
static void extract_connecting(const ParentGraph<TI>& g, i64 from_id,
                               i64 to_id,
                               std::vector<i64>& fwd, std::vector<i64>& epoch,
                               i64 cur, Extraction& out) {
    auto reachable = [&](i64 a, i64 b) -> bool {
        i64 cf = g.chain_id[a];
        if (cf == -1) return false;
        i64 last = g.table[b * g.C + cf];
        return last != -1 && g.index_on[cf * g.V + a] <= last;
    };
    std::vector<i64> stack;
    stack.push_back(from_id);
    while (!stack.empty()) {
        i64 node_id = stack.back();
        stack.pop_back();
        for (i64 k = g.nptr[node_id]; k < g.nptr[node_id + 1]; ++k) {
            i64 next_id = g.nind[k];
            if (next_id == to_id && node_id != from_id) {
                out.sinks.push_back(fwd[node_id]);
                continue;
            }
            if (!reachable(next_id, to_id)) continue;
            i64 sub_id;
            if (epoch[next_id] == cur) {
                sub_id = fwd[next_id];
            } else {
                sub_id = (i64)out.back.size();
                out.back.push_back(next_id);
                fwd[next_id] = sub_id;
                epoch[next_id] = cur;
                stack.push_back(next_id);
            }
            if (node_id != from_id) {
                out.ef.push_back(fwd[node_id]);
                out.et.push_back(sub_id);
            } else {
                out.sources.push_back(sub_id);
            }
        }
    }
}

// anchor weight (score_function.py / reference score_function.hpp:51-75)
struct ScoreFn {
    int kind;
    double pair_count_power, length_intercept, length_decay_power;

    double weight(i64 count1, i64 count2, i64 length, i64 full_length) const {
        double count = double(count1 * count2);
        double fraction = double(length) / double(full_length);
        double len = double(length);
        switch (kind) {
            case 0:  // InverseCount
                return fraction / std::pow(count, pair_count_power);
            case 1:  // LengthScaleInverseCount
                return fraction * len / std::pow(count, pair_count_power);
            case 2:  // ConcaveLengthScaleInverseCount
                return fraction * (len / std::pow(count, pair_count_power)
                    - std::pow(len / length_intercept, length_decay_power)
                      * length_intercept);
            default:  // ConcaveLengthScaleCountDifference
                return fraction * (len - count
                    * std::pow(len / length_intercept, length_decay_power)
                      * length_intercept);
        }
    }
};

// one divvied match set within a gap, plus its origin bookkeeping
struct GapSet {
    i64 orig_set;
    i64 count1, count2, full_length, L;
    std::vector<i64> w1s, w2s;          // original walk indices
    std::vector<i64> walks1, walks2;    // (n, L) mapped sub-node walks, flat
    i64 n1() const { return (i64)w1s.size(); }
    i64 n2() const { return (i64)w2s.size(); }
};

static inline u64 mask_key3(i64 s, i64 i, i64 j) {
    // only used for local hashing here (collision-free packing)
    return (u64(s) << 40) ^ (u64(i) << 20) ^ u64(j);
}

}  // namespace

// Full fill-in pass. Returns the merged chain length; writes at most out_cap
// rows (caller retries with a bigger cap if the return exceeds it).
// out_rows (cap, 5): orig_set, idx1, idx2, gap_before, gap_after
// out_fvals (cap, 3): score, gap_score_before, gap_score_after
template <typename TI>
static i64 anchor_fill_in_impl(
        // parent graphs
        i64 V1, const i64* n1ptr, const i64* n1ind, const i64* p1ptr,
        const i64* p1ind,
        i64 V2, const i64* n2ptr, const i64* n2ind, const i64* p2ptr,
        const i64* p2ind,
        // parent paths for projection
        i64 P1, const i64* path_off1, const i64* path_nodes1,
        i64 P2, const i64* path_off2, const i64* path_nodes2,
        // parent xmerge views (extraction reachability)
        i64 C1, const TI* table1, const TI* index_on1, const i64* chainid1,
        i64 C2, const TI* table2, const TI* index_on2, const i64* chainid2,
        // flattened match sets (current, post top-level-budget order)
        i64 num_sets_total, const i64* set_n1, const i64* set_n2,
        const i64* set_L, const i64* set_count1, const i64* set_count2,
        const i64* set_full_length,
        const i64* walks1_off, const i64* walks1_flat,
        const i64* walks2_off, const i64* walks2_flat,
        // top-level chain
        i64 A, const i64* top_rows, const double* top_fvals,
        // sentinel endpoints
        i64 src1, i64 snk1, i64 src2, i64 snk2,
        // config
        int algorithm, double scale,
        const double* gap_open, const double* gap_extend,
        int sf_kind, double sf_pcp, double sf_li, double sf_ldp,
        i64 max_num_match_pairs,
        i64 n_masked, const i64* masked_rows,
        int n_threads,
        i64 out_cap, i64* out_rows, double* out_fvals) {
    if (A == 0) return 0;
    const i64 G = A + 1;  // gaps incl. leading + trailing
    ScoreFn sf{sf_kind, sf_pcp, sf_li, sf_ldp};

    auto walk1_node = [&](i64 s, i64 i, i64 t) {
        return walks1_flat[walks1_off[s] + i * set_L[s] + t];
    };
    auto walk2_node = [&](i64 s, i64 j, i64 t) {
        return walks2_flat[walks2_off[s] + j * set_L[s] + t];
    };
    auto anchor_first1 = [&](i64 a) {
        const i64* r = top_rows + 5 * a;
        return walk1_node(r[0], r[1], 0);
    };
    auto anchor_last1 = [&](i64 a) {
        const i64* r = top_rows + 5 * a;
        return walk1_node(r[0], r[1], set_L[r[0]] - 1);
    };
    auto anchor_first2 = [&](i64 a) {
        const i64* r = top_rows + 5 * a;
        return walk2_node(r[0], r[2], 0);
    };
    auto anchor_last2 = [&](i64 a) {
        const i64* r = top_rows + 5 * a;
        return walk2_node(r[0], r[2], set_L[r[0]] - 1);
    };

    // ---------------- 1. extraction (reference anchorer.hpp:432-495)
    ParentGraph<TI> pg1{V1, n1ptr, n1ind, C1, table1, index_on1, chainid1};
    ParentGraph<TI> pg2{V2, n2ptr, n2ind, C2, table2, index_on2, chainid2};
    std::vector<Extraction> sub1(G), sub2(G);
    {
        std::vector<i64> fwd(V1, 0), epoch(V1, -1);
        std::vector<i64> fwd2v(V2, 0), epoch2(V2, -1);
        for (i64 g = 0; g < G; ++g) {
            i64 f1 = (g == 0) ? src1 : anchor_last1(g - 1);
            i64 t1 = (g == A) ? snk1 : anchor_first1(g);
            i64 f2 = (g == 0) ? src2 : anchor_last2(g - 1);
            i64 t2 = (g == A) ? snk2 : anchor_first2(g);
            extract_connecting(pg1, f1, t1, fwd, epoch, g, sub1[g]);
            extract_connecting(pg2, f2, t2, fwd2v, epoch2, g, sub2[g]);
        }
    }

    // ---------------- 2. divvy fwd maps (anchorer.hpp:700-733)
    // later gaps overwrite earlier ones, exactly like the python/reference
    std::vector<i64> gap_of1(V1, -1), sub_of1(V1, -1);
    std::vector<i64> gap_of2(V2, -1), sub_of2(V2, -1);
    for (i64 g = 0; g < G; ++g) {
        for (i64 k = 0; k < sub1[g].V(); ++k) {
            gap_of1[sub1[g].back[k]] = g;
            sub_of1[sub1[g].back[k]] = k;
        }
        for (i64 k = 0; k < sub2[g].V(); ++k) {
            gap_of2[sub2[g].back[k]] = g;
            sub_of2[sub2[g].back[k]] = k;
        }
    }

    // ---------------- 3. divvy matches (anchorer.hpp:735-800)
    std::unordered_set<u64> masked;
    for (i64 m = 0; m < n_masked; ++m) {
        masked.insert(mask_key3(masked_rows[3 * m], masked_rows[3 * m + 1],
                                masked_rows[3 * m + 2]));
    }
    std::vector<std::vector<GapSet>> gap_sets(G);
    {
        std::vector<i64> touched;  // gap indices initialized for this set
        for (i64 s = 0; s < num_sets_total; ++s) {
            touched.clear();
            const i64 L = set_L[s];
            for (i64 j = 0; j < set_n1[s]; ++j) {
                i64 first = walk1_node(s, j, 0);
                i64 last = walk1_node(s, j, L - 1);
                i64 gi = gap_of1[first];
                if (gi == -1 || gi != gap_of1[last]) continue;
                auto& lst = gap_sets[gi];
                if (lst.empty() || lst.back().orig_set != s) {
                    lst.push_back(GapSet{s, set_count1[s], set_count2[s],
                                         set_full_length[s], L, {}, {}, {}, {}});
                    touched.push_back(gi);
                }
                lst.back().w1s.push_back(j);
                for (i64 t = 0; t < L; ++t)
                    lst.back().walks1.push_back(sub_of1[walk1_node(s, j, t)]);
            }
            for (i64 k = 0; k < set_n2[s]; ++k) {
                i64 first = walk2_node(s, k, 0);
                i64 last = walk2_node(s, k, L - 1);
                i64 gi = gap_of2[first];
                if (gi == -1 || gi != gap_of2[last]) continue;
                auto& lst = gap_sets[gi];
                if (lst.empty() || lst.back().orig_set != s) continue;
                lst.back().w2s.push_back(k);
                for (i64 t = 0; t < L; ++t)
                    lst.back().walks2.push_back(sub_of2[walk2_node(s, k, t)]);
            }
            for (i64 gi : touched) {
                if (gap_sets[gi].back().w2s.empty()) gap_sets[gi].pop_back();
            }
        }
    }

    // ---------------- 4. budgets (src/anchorer.cpp:136-154)
    std::vector<i64> budgets(G);
    {
        double total = 0.0;
        std::vector<double> sizes(G);
        for (i64 g = 0; g < G; ++g) {
            sizes[g] = double((sub1[g].V() + 1)) * double((sub2[g].V() + 1));
            total += sizes[g];
        }
        for (i64 g = 0; g < G; ++g) {
            budgets[g] = (i64)std::ceil(
                double(max_num_match_pairs) * sizes[g] / total);
        }
    }

    // ---------------- 5. parent step indexes for projection
    // node -> path ids, in (path id asc, step asc) order, with multiplicity
    auto build_stepidx = [](i64 V, i64 P, const i64* off, const i64* nodes,
                            std::vector<i64>& indptr, std::vector<i64>& pids) {
        indptr.assign(V + 1, 0);
        for (i64 p = 0; p < P; ++p)
            for (i64 k = off[p]; k < off[p + 1]; ++k) ++indptr[nodes[k] + 1];
        for (i64 v = 0; v < V; ++v) indptr[v + 1] += indptr[v];
        pids.resize(off[P]);
        std::vector<i64> cursor(indptr.begin(), indptr.end() - 1);
        for (i64 p = 0; p < P; ++p)
            for (i64 k = off[p]; k < off[p + 1]; ++k)
                pids[cursor[nodes[k]]++] = p;
    };
    std::vector<i64> si1_ptr, si1_pid, si2_ptr, si2_pid;
    build_stepidx(V1, P1, path_off1, path_nodes1, si1_ptr, si1_pid);
    build_stepidx(V2, P2, path_off2, path_nodes2, si2_ptr, si2_pid);

    // ---------------- 6. per-gap chains (independent; OpenMP)
    struct GapResult {
        std::vector<i64> rows;     // (n, 5) in per-gap set coords
        std::vector<double> fvals; // (n, 3)
        i64 n = 0;
        std::vector<i64> order;    // per-gap set order after budget
        bool switched = false;
    };
    std::vector<GapResult> results(G);

#ifdef _OPENMP
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(dynamic)
#endif
    for (i64 g = 0; g < G; ++g) {
        auto& res = results[g];
        auto& e1 = sub1[g];
        auto& e2 = sub2[g];
        // subgraph CSR/CSC (stable insertion order, BaseGraph._build_csr)
        std::vector<i64> s1nptr, s1nind, s1pptr, s1pind;
        std::vector<i64> s2nptr, s2nind, s2pptr, s2pind;
        build_csr(e1.V(), e1.ef, e1.et, s1nptr, s1nind);
        build_csr(e1.V(), e1.et, e1.ef, s1pptr, s1pind);
        build_csr(e2.V(), e2.ef, e2.et, s2nptr, s2nind);
        build_csr(e2.V(), e2.et, e2.ef, s2pptr, s2pind);

        // path projection (extractor.py _project_one)
        auto project = [](i64 Vs, const std::vector<i64>& nptr,
                          const std::vector<i64>& nind,
                          const std::vector<i64>& pptr,
                          const std::vector<i64>& back,
                          const std::vector<i64>& si_ptr,
                          const std::vector<i64>& si_pid,
                          std::vector<i64>& p_off, std::vector<i64>& p_nodes) {
            p_off.assign(1, 0);
            p_nodes.clear();
            if (Vs == 0) return;
            std::vector<i64> order(Vs);
            lifo_topo(Vs, nptr.data(), nind.data(), pptr.data(), order.data());
            // first-encounter rank of each parent path over the traversal
            std::vector<i64> rank;           // dense ranks in encounter order
            std::vector<std::pair<i64, i64>> occ;  // (rank, sub node)
            std::vector<i64> rank_of;        // parent pid -> rank, lazy
            std::vector<i64> enc;            // encounter-ordered pids
            for (i64 t = 0; t < Vs; ++t) {
                i64 v = order[t];
                i64 pv = back[v];
                for (i64 k = si_ptr[pv]; k < si_ptr[pv + 1]; ++k) {
                    i64 pid = si_pid[k];
                    if ((i64)rank_of.size() <= pid) rank_of.resize(pid + 1, -1);
                    if (rank_of[pid] == -1) {
                        rank_of[pid] = (i64)enc.size();
                        enc.push_back(pid);
                    }
                    occ.emplace_back(rank_of[pid], v);
                }
            }
            // bucket by rank, preserving traversal order
            std::vector<i64> counts(enc.size() + 1, 0);
            for (auto& pr : occ) ++counts[pr.first + 1];
            for (size_t r = 1; r < counts.size(); ++r) counts[r] += counts[r - 1];
            p_nodes.resize(occ.size());
            std::vector<i64> cursor(counts.begin(), counts.end() - 1);
            for (auto& pr : occ) p_nodes[cursor[pr.first]++] = pr.second;
            p_off.assign(counts.begin(), counts.end());
        };
        std::vector<i64> p1off, p1nodes, p2off, p2nodes;
        project(e1.V(), s1nptr, s1nind, s1pptr, e1.back, si1_ptr, si1_pid,
                p1off, p1nodes);
        project(e2.V(), s2nptr, s2nind, s2pptr, e2.back, si2_ptr, si2_pid,
                p2off, p2nodes);
        const i64 Psub1 = (i64)p1off.size() - 1;
        const i64 Psub2 = (i64)p2off.size() - 1;

        // per-gap PathMerge (no tableau -> C == P)
        std::vector<i64> io1(std::max<i64>(Psub1 * e1.V(), 1), -1);
        std::vector<i64> ph1(std::max<i64>(e1.V(), 1), -1);
        std::vector<i64> tb1(std::max<i64>(e1.V() * Psub1, 1), -1);
        path_merge_build(e1.V(), s1nptr.data(), s1nind.data(), s1pptr.data(),
                         s1pind.data(), Psub1, p1off.data(), p1nodes.data(),
                         -1, -1, io1.data(), ph1.data(), tb1.data(), 8);
        std::vector<i64> io2(std::max<i64>(Psub2 * e2.V(), 1), -1);
        std::vector<i64> ph2(std::max<i64>(e2.V(), 1), -1);
        std::vector<i64> tb2(std::max<i64>(e2.V() * Psub2, 1), -1);
        path_merge_build(e2.V(), s2nptr.data(), s2nind.data(), s2pptr.data(),
                         s2pind.data(), Psub2, p2off.data(), p2nodes.data(),
                         -1, -1, io2.data(), ph2.data(), tb2.data(), 8);

        // per-gap masked coordinates (anchorer.py chain_one)
        std::unordered_set<u64> fi_masked;
        auto& sets = gap_sets[g];
        if (!masked.empty()) {
            for (size_t fset = 0; fset < sets.size(); ++fset) {
                const auto& gs = sets[fset];
                for (size_t a = 0; a < gs.w1s.size(); ++a) {
                    for (size_t b = 0; b < gs.w2s.size(); ++b) {
                        if (masked.count(mask_key3(gs.orig_set, gs.w1s[a],
                                                   gs.w2s[b]))) {
                            fi_masked.insert(mask_key3(fset, a, b));
                        }
                    }
                }
            }
        }

        // budget (anchorer.py _budget_matches / anchorer.hpp:1108-1173)
        const i64 ns = (i64)sets.size();
        std::vector<i64> order(ns);
        for (i64 i = 0; i < ns; ++i) order[i] = i;
        i64 num_sets = ns, num_anchors = 0, max_match_size = 0;
        {
            i64 total = 0;
            for (auto& gs : sets) total += gs.n1() * gs.n2();
            if (total <= budgets[g]) {
                num_anchors = total;
            } else {
                std::stable_sort(order.begin(), order.end(),
                    [&](i64 a, i64 b) {
                        return sf.weight(sets[a].count1, sets[a].count2,
                                         sets[a].full_length,
                                         sets[a].full_length)
                             > sf.weight(sets[b].count1, sets[b].count2,
                                         sets[b].full_length,
                                         sets[b].full_length);
                    });
                i64 removed = 0, pairs_left = budgets[g];
                for (i64 pos = 0; pos < ns; ++pos) {
                    const auto& m = sets[order[pos]];
                    if (sf.weight(m.count1, m.count2, m.L, m.L) < 0.0) {
                        removed += ns - pos;
                        break;
                    }
                    i64 pc = m.n1() * m.n2();
                    if (pairs_left >= pc) {
                        max_match_size = std::max(
                            max_match_size, std::max(m.n1(), m.n2()));
                        pairs_left -= pc;
                        std::swap(order[pos - removed], order[pos]);
                    } else {
                        ++removed;
                    }
                }
                num_sets = ns - removed;
                num_anchors = budgets[g] - pairs_left;
                if (!fi_masked.empty()) {
                    std::vector<i64> index(ns);
                    for (i64 np = 0; np < ns; ++np) index[order[np]] = np;
                    std::unordered_set<u64> remapped;
                    for (i64 f0 = 0; f0 < ns; ++f0) {
                        const auto& gs = sets[f0];
                        for (i64 a = 0; a < gs.n1(); ++a)
                            for (i64 b = 0; b < gs.n2(); ++b)
                                if (fi_masked.count(mask_key3(f0, a, b)))
                                    remapped.insert(
                                        mask_key3(index[f0], a, b));
                    }
                    fi_masked.swap(remapped);
                }
            }
        }
        res.order = order;

        // flatten per-gap sets in budget order
        std::vector<i64> fn1(ns), fn2(ns), fL(ns), fc1(ns), fc2(ns), ffl(ns);
        std::vector<i64> fw1off(ns), fw2off(ns);
        std::vector<double> fweight(ns, 0.0);
        std::vector<i64> fw1, fw2;
        {
            i64 o1 = 0, o2 = 0;
            for (i64 p = 0; p < ns; ++p) {
                const auto& gs = sets[order[p]];
                fn1[p] = gs.n1(); fn2[p] = gs.n2(); fL[p] = gs.L;
                fc1[p] = gs.count1; fc2[p] = gs.count2; ffl[p] = gs.full_length;
                fw1off[p] = o1; fw2off[p] = o2;
                o1 += (i64)gs.walks1.size();
                o2 += (i64)gs.walks2.size();
            }
            fw1.reserve(o1); fw2.reserve(o2);
            for (i64 p = 0; p < ns; ++p) {
                const auto& gs = sets[order[p]];
                fw1.insert(fw1.end(), gs.walks1.begin(), gs.walks1.end());
                fw2.insert(fw2.end(), gs.walks2.begin(), gs.walks2.end());
            }
            for (i64 p = 0; p < num_sets; ++p) {
                const auto& gs = sets[order[p]];
                fweight[p] = sf.weight(gs.count1, gs.count2,
                                       gs.n1() ? gs.L : 0, gs.full_length);
            }
        }

        // memory switch (anchorer.py _chain_parity / anchorer.hpp:1175-1210)
        bool sw = e1.V() * Psub1 > e2.V() * Psub2;
        res.switched = sw;
        std::vector<i64> mrows;
        if (!fi_masked.empty()) {
            for (i64 p = 0; p < ns; ++p) {
                const auto& gs = sets[order[p]];
                for (i64 a = 0; a < gs.n1(); ++a)
                    for (i64 b = 0; b < gs.n2(); ++b)
                        if (fi_masked.count(mask_key3(p, a, b))) {
                            if (sw) {
                                mrows.push_back(p); mrows.push_back(b);
                                mrows.push_back(a);
                            } else {
                                mrows.push_back(p); mrows.push_back(a);
                                mrows.push_back(b);
                            }
                        }
            }
        }

        i64 cap = 1;
        for (i64 p = 0; p < num_sets; ++p) cap += fn1[p] * fn2[p];
        res.rows.resize(cap * 5);
        res.fvals.resize(cap * 3);

        // arguments with optional swap
        struct Side {
            i64 V; const i64* nptr; const i64* nind; const i64* pptr;
            const i64* pind; i64 C; const i64* tb; const i64* io;
            const i64* ph; std::vector<i64> choff; const i64* chnodes;
            const i64* srcs; i64 nsrc; const i64* snks; i64 nsnk;
        };
        Side a{e1.V(), s1nptr.data(), s1nind.data(), s1pptr.data(),
               s1pind.data(), Psub1, tb1.data(), io1.data(), ph1.data(),
               {}, p1nodes.data(),
               e1.sources.data(), (i64)e1.sources.size(),
               e1.sinks.data(), (i64)e1.sinks.size()};
        a.choff = p1off;
        Side b{e2.V(), s2nptr.data(), s2nind.data(), s2pptr.data(),
               s2pind.data(), Psub2, tb2.data(), io2.data(), ph2.data(),
               {}, p2nodes.data(),
               e2.sources.data(), (i64)e2.sources.size(),
               e2.sinks.data(), (i64)e2.sinks.size()};
        b.choff = p2off;
        const Side& s1 = sw ? b : a;
        const Side& s2 = sw ? a : b;
        const i64* W1off = sw ? fw2off.data() : fw1off.data();
        const i64* W1 = sw ? fw2.data() : fw1.data();
        const i64* W2off = sw ? fw1off.data() : fw2off.data();
        const i64* W2 = sw ? fw1.data() : fw2.data();
        const i64* N1 = sw ? fn2.data() : fn1.data();
        const i64* N2 = sw ? fn1.data() : fn2.data();
        const i64* Cc1 = sw ? fc2.data() : fc1.data();
        const i64* Cc2 = sw ? fc1.data() : fc2.data();

        if (algorithm == 1) {  // Sparse
            res.n = chain_sparse_parity(
                s1.V, s1.nptr, s1.nind, s1.pptr, s1.pind, s2.V,
                ns, num_sets, N1, N2, fL.data(), Cc1, Cc2, ffl.data(),
                fweight.data(), W1off, W1, W2off, W2,
                s1.C, s1.tb, s1.io, s1.ph, s1.choff.data(), s1.chnodes,
                s2.C, s2.tb, s2.io, s2.ph, s2.choff.data(), s2.chnodes,
                s1.nsrc, s1.srcs, s2.nsrc, s2.srcs,
                s1.nsnk, s1.snks, s2.nsnk, s2.snks,
                (i64)(mrows.size() / 3), mrows.data(), 8,
                cap, res.rows.data(), res.fvals.data());
        } else {  // SparseAffine
            i64 max_diag_diff = s1.V + s2.V;
            int use_small = (num_sets < (i64(1) << 32) - 1)
                && (max_match_size < (i64(1) << 16) - 1)
                && (max_diag_diff < (i64(1) << 31) - 1)
                && (num_anchors < (i64(1) << 32) - 1);
            res.n = chain_affine_parity(
                s1.V, s1.nptr, s1.nind, s1.pptr, s1.pind,
                s2.V, s2.nptr, s2.nind, s2.pptr, s2.pind,
                ns, num_sets, N1, N2, fL.data(), Cc1, Cc2, ffl.data(),
                fweight.data(), W1off, W1, W2off, W2,
                s1.C, s1.tb, s1.io, s1.ph, s1.choff.data(), s1.chnodes,
                s2.C, s2.tb, s2.io, s2.ph, s2.choff.data(), s2.chnodes,
                gap_open, gap_extend, scale,
                s1.nsrc, s1.srcs, s2.nsrc, s2.srcs,
                s1.nsnk, s1.snks, s2.nsnk, s2.snks,
                (i64)(mrows.size() / 3), mrows.data(), use_small, 8,
                cap, res.rows.data(), res.fvals.data());
        }
    }

    // ---------------- 7. merge (src/anchorer.cpp:156-230)
    // rows carry (orig_set, orig_idx1, orig_idx2, gap_before, gap_after)
    i64 n_out = 0;
    i64 last_written = -1;  // index of previous emitted row (for gap fixups)
    auto emit = [&](i64 s, i64 i1, i64 i2, i64 gb, i64 ga,
                    double sc, double gsb, double gsa) {
        if (n_out < out_cap) {
            i64* r = out_rows + 5 * n_out;
            r[0] = s; r[1] = i1; r[2] = i2; r[3] = gb; r[4] = ga;
            double* f = out_fvals + 3 * n_out;
            f[0] = sc; f[1] = gsb; f[2] = gsa;
            last_written = n_out;
        }
        ++n_out;
    };
    for (i64 g = 0; g < G; ++g) {
        if (g != 0) {
            const i64* r = top_rows + 5 * (g - 1);
            const double* f = top_fvals + 3 * (g - 1);
            i64 gb = r[3];
            double gsb = f[1];
            if (last_written >= 0) {
                gb = out_rows[5 * last_written + 4];
                gsb = out_fvals[3 * last_written + 2];
            }
            emit(r[0], r[1], r[2], gb, r[4], f[0], gsb, f[2]);
        }
        const auto& res = results[g];
        const auto& sets = gap_sets[g];
        i64 n = std::min(res.n, (i64)(res.rows.size() / 5));
        for (i64 j = 0; j < n; ++j) {
            const i64* rr = res.rows.data() + 5 * j;
            const double* ff = res.fvals.data() + 3 * j;
            i64 fset = rr[0], i1 = rr[1], i2 = rr[2];
            i64 gb = rr[3], ga = rr[4];
            if (res.switched) {
                std::swap(i1, i2);
                gb = -gb;
                ga = -ga;
            }
            const auto& gs = sets[res.order[fset]];
            if (j == 0 && last_written >= 0) {
                out_rows[5 * last_written + 4] = gb;
                out_fvals[3 * last_written + 2] = ff[1];
            }
            emit(gs.orig_set, gs.w1s[i1], gs.w2s[i2], gb, ga,
                 ff[0], ff[1], ff[2]);
        }
    }
    return n_out;
}

// Total fill-in length between chained anchors for score-scale estimation
// (reference anchorer.hpp:1018-1045): per gap, the min source->sink walk
// distance of each extraction, combined exactly like the python oracle in
// anchorer.py estimate_score_scale.
template <typename TI>
static i64 chain_fill_length_impl(
        i64 V1, const i64* n1ptr, const i64* n1ind,
        i64 C1, const TI* table1, const TI* index_on1, const i64* chainid1,
        i64 V2, const i64* n2ptr, const i64* n2ind,
        i64 C2, const TI* table2, const TI* index_on2, const i64* chainid2,
        i64 G, const i64* endpoints /* (G, 4): from1, to1, from2, to2 */) {
    ParentGraph<TI> pg1{V1, n1ptr, n1ind, C1, table1, index_on1, chainid1};
    ParentGraph<TI> pg2{V2, n2ptr, n2ind, C2, table2, index_on2, chainid2};
    std::vector<i64> fwd1(V1, 0), epoch1(V1, -1);
    std::vector<i64> fwd2(V2, 0), epoch2(V2, -1);
    const i64 I64MAX = std::numeric_limits<i64>::max();
    const i64 I64MIN = std::numeric_limits<i64>::min();

    auto min_src_snk = [&](const Extraction& e) -> i64 {
        // graph_algs.minmax_distance + extractor.source_sink_minmax semantics
        i64 Vs = e.V();
        std::vector<i64> nptr, nind, pptr, pind;
        build_csr(Vs, e.ef, e.et, nptr, nind);
        build_csr(Vs, e.et, e.ef, pptr, pind);
        std::vector<i64> order(Vs);
        lifo_topo(Vs, nptr.data(), nind.data(), pptr.data(), order.data());
        std::vector<i64> mind(Vs, I64MAX), maxd(Vs, I64MIN);
        for (i64 s : e.sources) { mind[s] = 0; maxd[s] = 0; }
        for (i64 v : order) {
            for (i64 k = pptr[v]; k < pptr[v + 1]; ++k) {
                i64 p = pind[k];
                if (maxd[p] != I64MIN) {
                    if (mind[p] + 1 < mind[v]) mind[v] = mind[p] + 1;
                    if (maxd[p] + 1 > maxd[v]) maxd[v] = maxd[p] + 1;
                }
            }
        }
        i64 lo = I64MAX;
        for (i64 s : e.sinks) {
            i64 d = (maxd[s] == I64MIN) ? -1 : mind[s];  // censored like
            lo = std::min(lo, d);                        // the numpy path
        }
        return lo;
    };

    i64 total = 0;
    for (i64 g = 0; g < G; ++g) {
        const i64* ep = endpoints + 4 * g;
        Extraction e1, e2;
        extract_connecting(pg1, ep[0], ep[1], fwd1, epoch1, g, e1);
        extract_connecting(pg2, ep[2], ep[3], fwd2, epoch2, g, e2);
        i64 fill_len;
        if (e1.V() == 0) {
            fill_len = 0;
        } else {
            fill_len = min_src_snk(e1);
            if (e2.V() == 0) {
                fill_len = 0;
            } else {
                fill_len = std::min(fill_len, min_src_snk(e2));
            }
        }
        total += fill_len;
    }
    return total;
}

extern "C" {

i64 anchor_fill_in_native(
        i64 V1, const i64* n1ptr, const i64* n1ind, const i64* p1ptr,
        const i64* p1ind,
        i64 V2, const i64* n2ptr, const i64* n2ind, const i64* p2ptr,
        const i64* p2ind,
        i64 P1, const i64* path_off1, const i64* path_nodes1,
        i64 P2, const i64* path_off2, const i64* path_nodes2,
        i64 C1, const void* table1, const void* index_on1,
        const i64* chainid1,
        i64 C2, const void* table2, const void* index_on2,
        const i64* chainid2,
        int table_width,
        i64 num_sets_total, const i64* set_n1, const i64* set_n2,
        const i64* set_L, const i64* set_count1, const i64* set_count2,
        const i64* set_full_length,
        const i64* walks1_off, const i64* walks1_flat,
        const i64* walks2_off, const i64* walks2_flat,
        i64 A, const i64* top_rows, const double* top_fvals,
        i64 src1, i64 snk1, i64 src2, i64 snk2,
        int algorithm, double scale,
        const double* gap_open, const double* gap_extend,
        int sf_kind, double sf_pcp, double sf_li, double sf_ldp,
        i64 max_num_match_pairs,
        i64 n_masked, const i64* masked_rows,
        int n_threads,
        i64 out_cap, i64* out_rows, double* out_fvals) {
    if (table_width == 4) {
        return anchor_fill_in_impl<int32_t>(
            V1, n1ptr, n1ind, p1ptr, p1ind, V2, n2ptr, n2ind, p2ptr, p2ind,
            P1, path_off1, path_nodes1, P2, path_off2, path_nodes2,
            C1, (const int32_t*)table1, (const int32_t*)index_on1, chainid1,
            C2, (const int32_t*)table2, (const int32_t*)index_on2, chainid2,
            num_sets_total, set_n1, set_n2, set_L, set_count1, set_count2,
            set_full_length, walks1_off, walks1_flat, walks2_off, walks2_flat,
            A, top_rows, top_fvals, src1, snk1, src2, snk2,
            algorithm, scale, gap_open, gap_extend,
            sf_kind, sf_pcp, sf_li, sf_ldp, max_num_match_pairs,
            n_masked, masked_rows, n_threads, out_cap, out_rows, out_fvals);
    }
    return anchor_fill_in_impl<i64>(
        V1, n1ptr, n1ind, p1ptr, p1ind, V2, n2ptr, n2ind, p2ptr, p2ind,
        P1, path_off1, path_nodes1, P2, path_off2, path_nodes2,
        C1, (const i64*)table1, (const i64*)index_on1, chainid1,
        C2, (const i64*)table2, (const i64*)index_on2, chainid2,
        num_sets_total, set_n1, set_n2, set_L, set_count1, set_count2,
        set_full_length, walks1_off, walks1_flat, walks2_off, walks2_flat,
        A, top_rows, top_fvals, src1, snk1, src2, snk2,
        algorithm, scale, gap_open, gap_extend,
        sf_kind, sf_pcp, sf_li, sf_ldp, max_num_match_pairs,
        n_masked, masked_rows, n_threads, out_cap, out_rows, out_fvals);
}

i64 chain_fill_length_native(
        i64 V1, const i64* n1ptr, const i64* n1ind,
        i64 C1, const void* table1, const void* index_on1,
        const i64* chainid1,
        i64 V2, const i64* n2ptr, const i64* n2ind,
        i64 C2, const void* table2, const void* index_on2,
        const i64* chainid2,
        int table_width,
        i64 G, const i64* endpoints) {
    if (table_width == 4) {
        return chain_fill_length_impl<int32_t>(
            V1, n1ptr, n1ind, C1, (const int32_t*)table1,
            (const int32_t*)index_on1, chainid1,
            V2, n2ptr, n2ind, C2, (const int32_t*)table2,
            (const int32_t*)index_on2, chainid2, G, endpoints);
    }
    return chain_fill_length_impl<i64>(
        V1, n1ptr, n1ind, C1, (const i64*)table1, (const i64*)index_on1,
        chainid1,
        V2, n2ptr, n2ind, C2, (const i64*)table2, (const i64*)index_on2,
        chainid2, G, endpoints);
}

}  // extern "C"
