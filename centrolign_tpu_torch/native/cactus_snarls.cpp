// Cactus graph / cactus tree / snarl decomposition — behavioral twins of the
// reference's CompactedGraph (compacted_graph.hpp:57-92), AdjacencyGraph
// (adjacency_graph.hpp:61-112), ChainCycleGraph (chain_cycle_graph.hpp),
// CactusGraph + CactusTree (cactus.hpp:137-635), and SnarlTree's snarl
// enumeration (snarls.hpp:135-193), with the same traversal orders so the
// snarl boundary list matches the reference's exactly. The snarl/chain tree
// structure over the boundary pairs is formed by the same pass as the
// superbubble tree (structure_tree.hpp:156-272).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <tuple>
#include <unordered_map>
#include <functional>

namespace {
using i64 = int64_t;
constexpr i64 NONE = -1;
}

extern "C" i64 three_edge_connected_components(
    i64 V, const i64* nptr, const i64* nind, const i64* pptr,
    const i64* pind, i64* out_comp);

namespace {

struct Csr {
    std::vector<i64> ptr, ind;
    template <class Adj>
    static Csr from_adj(const Adj& adj) {
        Csr c;
        c.ptr.resize(adj.size() + 1, 0);
        for (size_t v = 0; v < adj.size(); ++v)
            c.ptr[v + 1] = c.ptr[v] + adj[v].size();
        c.ind.reserve(c.ptr.back());
        for (const auto& row : adj)
            for (i64 x : row) c.ind.push_back(x);
        return c;
    }
};

// unipath compaction (compacted_graph.hpp:61-92); nodes in the reference's
// creation order (ascending front node id)
struct Compacted {
    std::vector<i64> front, back, size;
    std::vector<std::vector<i64>> next, prev;

    Compacted(i64 V, const i64* nptr, const i64* nind, const i64* pptr,
              const i64* pind) {
        std::unordered_map<i64, i64> front_trans;
        for (i64 v = 0; v < V; ++v) {
            i64 pdeg = pptr[v + 1] - pptr[v];
            bool is_front = pdeg != 1;
            if (!is_front) {
                i64 p = pind[pptr[v]];
                is_front = (nptr[p + 1] - nptr[p]) != 1;
            }
            if (is_front) {
                i64 sz = 1;
                i64 b = v;
                while (nptr[b + 1] - nptr[b] == 1) {
                    i64 nx = nind[nptr[b]];
                    if (pptr[nx + 1] - pptr[nx] != 1) break;
                    b = nx;
                    ++sz;
                }
                front_trans[v] = (i64)front.size();
                front.push_back(v);
                back.push_back(b);
                size.push_back(sz);
            }
        }
        next.resize(front.size());
        prev.resize(front.size());
        for (i64 c = 0; c < (i64)front.size(); ++c) {
            i64 b = back[c];
            for (i64 k = nptr[b]; k < nptr[b + 1]; ++k) {
                i64 nc = front_trans[nind[k]];
                next[c].push_back(nc);
                prev[nc].push_back(c);
            }
        }
    }
};

}  // namespace

extern "C" {

// Snarl boundary enumeration for a (possibly cyclic) graph with sentinels
// (SnarlTree::find_2_disc_structures_impl). Writes (s, t) pairs to out
// (cap rows); returns the count.
i64 snarl_boundaries(
        i64 V, const i64* nptr, const i64* nind, const i64* pptr,
        const i64* pind, i64 src_id, i64 snk_id,
        i64 cap, i64* out) {
    Compacted cg(V, nptr, nind, pptr, pind);
    i64 C = (i64)cg.front.size();

    // locate compacted source/sink
    i64 csrc = NONE, csnk = NONE;
    for (i64 c = 0; c < C; ++c) {
        if (cg.front[c] == src_id) csrc = c;
        if (cg.back[c] == snk_id) csnk = c;
    }

    // ChainCycleGraph: compacted graph with snk->src edge
    std::vector<std::vector<i64>> cyc_next(C), cyc_prev(C);
    for (i64 c = 0; c < C; ++c) {
        if (c == csnk) cyc_next[c] = {csrc};
        else cyc_next[c] = cg.next[c];
        if (c == csrc) cyc_prev[c] = {csnk};
        else cyc_prev[c] = cg.prev[c];
    }

    // AdjacencyGraph over node sides (adjacency_graph.hpp:61-112)
    std::vector<i64> adj_comp(2 * C, NONE);
    i64 n_adj = 0;
    for (i64 i = 0; i < 2 * C; ++i) {
        if (adj_comp[i] != NONE) continue;
        adj_comp[i] = n_adj;
        std::vector<std::pair<i64, bool>> stack(
            1, {i / 2, (bool)(i % 2)});
        while (!stack.empty()) {
            auto [v, left] = stack.back();
            stack.pop_back();
            const auto& edges = left ? cyc_prev[v] : cyc_next[v];
            for (i64 nx : edges) {
                i64 j = 2 * nx + (left ? 0 : 1);
                if (adj_comp[j] == NONE) {
                    adj_comp[j] = n_adj;
                    stack.emplace_back(nx, !left);
                }
            }
        }
        ++n_adj;
    }
    // adjacency multigraph: edge from left-comp to right-comp per compacted
    // node, labeled by the compacted node
    std::vector<std::vector<std::pair<i64, i64>>> anext(n_adj), aprev(n_adj);
    for (i64 c = 0; c < C; ++c) {
        i64 right = adj_comp[2 * c];
        i64 left = adj_comp[2 * c + 1];
        anext[left].emplace_back(right, c);
        aprev[right].emplace_back(left, c);
    }

    // 3ECC over the adjacency graph
    std::vector<std::vector<i64>> an(n_adj), ap(n_adj);
    for (i64 v = 0; v < n_adj; ++v) {
        for (auto& e : anext[v]) an[v].push_back(e.first);
        for (auto& e : aprev[v]) ap[v].push_back(e.first);
    }
    Csr ancsr = Csr::from_adj(an), apcsr = Csr::from_adj(ap);
    std::vector<i64> node_to_comp(n_adj);
    i64 n_cact = three_edge_connected_components(
        n_adj, ancsr.ptr.data(), ancsr.ind.data(), apcsr.ptr.data(),
        apcsr.ind.data(), node_to_comp.data());

    // CactusGraph (cactus.hpp:137-215): nodes = 3ECC comps, edges in
    // adjacency-graph node order with origin tracking
    struct CNode {
        std::vector<i64> next, prev;
        std::vector<std::tuple<i64, i64, i64>> next_origin;  // adj node, edge idx, rev idx
        std::vector<i64> prev_origin;
    };
    std::vector<CNode> cn(n_cact);
    i64 origin = NONE;
    for (i64 v = 0; v < n_adj; ++v) {
        i64 comp1 = node_to_comp[v];
        for (size_t i = 0; i < anext[v].size(); ++i) {
            i64 comp2 = node_to_comp[anext[v][i].first];
            cn[comp1].next.push_back(comp2);
            cn[comp1].next_origin.emplace_back(v, (i64)i,
                                               (i64)cn[comp2].prev.size());
            cn[comp2].prev.push_back(comp1);
            cn[comp2].prev_origin.push_back((i64)cn[comp1].next.size() - 1);
            if (anext[v][i].second == csrc) origin = comp1;
        }
    }

    auto prev_reverse_edge_index = [&](i64 node, i64 edge_idx) -> i64 {
        return cn[node].prev_origin[edge_idx];
    };
    auto edge_to_compacted = [&](i64 node, bool next, i64 edge_idx) -> i64 {
        if (!next) {
            i64 n2 = cn[node].prev[edge_idx];
            edge_idx = cn[node].prev_origin[edge_idx];
            node = n2;
        }
        const auto& eo = cn[node].next_origin[edge_idx];
        return anext[std::get<0>(eo)][std::get<1>(eo)].second;
    };

    // CactusTree (cactus.hpp:313-635)
    using CycleEdge = std::tuple<i64, bool, i64>;  // (target, is_next, idx)
    std::vector<std::vector<CycleEdge>> cycles;
    {
        std::vector<bool> stacked(n_cact, false);
        std::vector<std::vector<bool>> edge_traversed(n_cact);
        for (i64 v = 0; v < n_cact; ++v)
            edge_traversed[v].resize(cn[v].next.size(), false);
        std::vector<std::pair<std::vector<CycleEdge>, size_t>> stack;
        stack.emplace_back();
        stack.front().first.emplace_back(origin, false, NONE);
        stack.front().second = 0;
        while (!stack.empty()) {
            auto& top = stack.back();
            if (top.second == top.first.size()) {
                stack.pop_back();
                continue;
            }
            CycleEdge next_edge = top.first[top.second++];
            i64 next_id = std::get<0>(next_edge);
            if (stack.size() != 1) {
                auto& below = stack[stack.size() - 2];
                i64 prev_id = std::get<0>(below.first[below.second - 1]);
                i64 edge_src, edge_idx;
                if (std::get<1>(next_edge)) {
                    edge_src = prev_id;
                    edge_idx = std::get<2>(next_edge);
                } else {
                    edge_src = next_id;
                    edge_idx = prev_reverse_edge_index(prev_id,
                                                       std::get<2>(next_edge));
                }
                if (edge_traversed[edge_src][edge_idx]) continue;
                edge_traversed[edge_src][edge_idx] = true;
            }
            if (!stacked[next_id]) {
                stack.emplace_back(std::vector<CycleEdge>(), 0);
                auto& rec = stack.back();
                for (bool nx : {false, true}) {
                    const auto& edges = nx ? cn[next_id].next
                                           : cn[next_id].prev;
                    for (size_t i = 0; i < edges.size(); ++i)
                        rec.first.emplace_back(edges[i], nx, (i64)i);
                }
                stacked[next_id] = true;
            } else {
                cycles.emplace_back();
                auto& cycle = cycles.back();
                size_t i = stack.size() - 1;
                while (true) {
                    const auto& curr_edge = stack[i].first[stack[i].second - 1];
                    const auto& prev_edge =
                        stack[i - 1].first[stack[i - 1].second - 1];
                    cycle.emplace_back(std::get<0>(prev_edge),
                                       std::get<1>(curr_edge),
                                       std::get<2>(curr_edge));
                    if (std::get<0>(prev_edge) == next_id) break;
                    --i;
                }
                std::reverse(cycle.begin(), cycle.end());
            }
        }
    }

    // edge -> cycle lookup + root cycle
    std::vector<std::vector<i64>> assigned_cycle(n_cact);
    for (i64 v = 0; v < n_cact; ++v)
        assigned_cycle[v].resize(cn[v].next.size(), NONE);
    i64 root_cycle = NONE;
    for (size_t i = 0; i < cycles.size(); ++i) {
        if (std::get<0>(cycles[i].front()) == origin) root_cycle = (i64)i;
        for (const auto& ce : cycles[i]) {
            i64 node, edge_idx;
            if (std::get<1>(ce)) {
                node = std::get<0>(ce);
                edge_idx = std::get<2>(ce);
            } else {
                node = cn[std::get<0>(ce)].prev[std::get<2>(ce)];
                edge_idx = prev_reverse_edge_index(std::get<0>(ce),
                                                   std::get<2>(ce));
            }
            assigned_cycle[node][edge_idx] = (i64)i;
        }
    }

    // tree: adjacency-component nodes [0, n_cact) + cycle nodes
    i64 n_tree = n_cact + (i64)cycles.size();
    std::vector<std::vector<i64>> children(n_tree);
    std::vector<i64> parent(n_tree, NONE);
    i64 root = n_cact + root_cycle;
    {
        std::vector<bool> stacked(n_tree, false);
        std::vector<i64> stack(1, root);
        stacked[root] = true;
        while (!stack.empty()) {
            i64 node = stack.back();
            stack.pop_back();
            if (node >= n_cact) {
                for (const auto& ce : cycles[node - n_cact]) {
                    i64 nx = std::get<0>(ce);
                    if (stacked[nx]) continue;
                    children[node].push_back(nx);
                    parent[nx] = node;
                    stack.push_back(nx);
                    stacked[nx] = true;
                }
            } else {
                for (bool nxdir : {true, false}) {
                    const auto& edges = nxdir ? cn[node].next : cn[node].prev;
                    for (size_t i = 0; i < edges.size(); ++i) {
                        i64 edge_node, edge_idx;
                        if (nxdir) {
                            edge_node = node;
                            edge_idx = (i64)i;
                        } else {
                            edge_node = edges[i];
                            edge_idx = prev_reverse_edge_index(node, (i64)i);
                        }
                        i64 cyc = assigned_cycle[edge_node][edge_idx];
                        i64 nx = (cyc == NONE) ? edges[i] : n_cact + cyc;
                        if (stacked[nx]) continue;
                        children[node].push_back(nx);
                        parent[nx] = node;
                        stack.push_back(nx);
                        stacked[nx] = true;
                    }
                }
            }
        }
    }
    // rotate cycles to start at the parent (root: at origin)
    for (size_t c = 0; c < cycles.size(); ++c) {
        i64 node_id = n_cact + (i64)c;
        i64 first_id = (node_id == root) ? origin : parent[node_id];
        auto& cyc = cycles[c];
        size_t i = 0;
        while (std::get<0>(cyc[i]) != first_id) ++i;
        std::rotate(cyc.begin(), cyc.begin() + i, cyc.end());
    }

    // snarl boundary pairs (snarls.hpp:135-193)
    i64 n_out = 0;
    auto emit = [&](i64 a, i64 b) {
        if (n_out < cap) {
            out[2 * n_out] = a;
            out[2 * n_out + 1] = b;
        }
        ++n_out;
    };
    auto get_edge_walk = [&](const CycleEdge& e) -> std::pair<i64, i64> {
        // returns (front, back) of the walk and emits trivial snarls; the
        // walk through a compacted node visits consecutive unipath nodes
        i64 cpct = edge_to_compacted(std::get<0>(e), std::get<1>(e),
                                     std::get<2>(e));
        // walk the unipath emitting (prev, next) pairs
        i64 here = cg.front[cpct];
        i64 last = cg.back[cpct];
        while (here != last) {
            i64 nx = nind[nptr[here]];  // unipath: unique next
            emit(here, nx);
            here = nx;
        }
        return {cg.front[cpct], cg.back[cpct]};
    };

    std::vector<i64> stack(1, root);
    while (!stack.empty()) {
        i64 node = stack.back();
        stack.pop_back();
        if (node >= n_cact) {
            const auto& chain = cycles[node - n_cact];
            auto prev_walk = get_edge_walk(chain.front());
            for (size_t i = 1; i < chain.size(); ++i) {
                auto walk = get_edge_walk(chain[i]);
                if (std::get<1>(chain[i - 1]) == std::get<1>(chain[i])) {
                    if (std::get<1>(chain[i])) {
                        emit(prev_walk.second, walk.first);
                    } else {
                        emit(walk.second, prev_walk.first);
                    }
                }
                prev_walk = walk;
            }
        }
        for (i64 nx : children[node]) stack.push_back(nx);
    }
    return n_out;
}

}  // extern "C"

extern "C" {

// Full SnarlTree build: boundaries via snarl_boundaries, then the
// structure/chain tree pass (structure_tree.hpp:156-272) and per-snarl
// acyclicity flags (snarls.hpp:57-123: net-graph acyclicity via the
// NetGraph DFS construction + contained-chain acyclicity).
// Outputs (caller-allocated, capacity 2*V rows where needed):
//   node_begin/node_end (V,), bounds (cap,2), chain_of (cap,),
//   chain_parent (cap,), snarl_acyclic (cap,), net_acyclic (cap,),
//   chain_acyclic (cap,), trivial_chain (cap,) [all snarls' start has
//   next_size == 1 -- the simplify_bubbles "chain_is_trivial" test],
//   n_chains_out (1,)
// Returns S, or -1 if cap was insufficient.
i64 snarl_tree_build(
        i64 V, const i64* nptr, const i64* nind, const i64* pptr,
        const i64* pind, i64 src_id, i64 snk_id, i64 cap,
        i64* node_begin, i64* node_end, i64* bounds,
        i64* chain_of, i64* chain_parent,
        i64* snarl_acyclic, i64* net_acyclic, i64* chain_acyclic,
        i64* trivial_chain, i64* n_chains_out) {
    std::vector<i64> raw(2 * cap);
    i64 n_raw = snarl_boundaries(V, nptr, nind, pptr, pind, src_id, snk_id,
                                 cap, raw.data());
    if (n_raw > cap) return -1;

    for (i64 v = 0; v < V; ++v) { node_begin[v] = -1; node_end[v] = -1; }
    i64 S = 0;
    for (i64 r = 0; r < n_raw; ++r) {
        i64 a = raw[2 * r], b = raw[2 * r + 1];
        if (src_id >= 0 && (a == src_id || b == snk_id || a == snk_id ||
                            b == src_id)) {
            continue;
        }
        node_begin[a] = S;
        node_end[b] = S;
        bounds[2 * S] = a;
        bounds[2 * S + 1] = b;
        ++S;
    }

    // chains (structure_tree.hpp:181-228)
    std::vector<i64> parent_chain(S, -1);
    std::vector<std::vector<i64>> chain_structs;
    for (i64 sid = 0; sid < S; ++sid) {
        if (parent_chain[sid] != -1) continue;
        i64 cid = (i64)chain_structs.size();
        chain_structs.emplace_back();
        auto& chain = chain_structs.back();
        chain.push_back(sid);
        parent_chain[sid] = cid;
        i64 here = node_end[bounds[2 * sid]];
        while (here != -1) {
            chain.push_back(here);
            parent_chain[here] = cid;
            here = node_end[bounds[2 * here]];
        }
        std::reverse(chain.begin(), chain.end());
        here = node_begin[bounds[2 * sid + 1]];
        while (here != -1) {
            chain.push_back(here);
            parent_chain[here] = cid;
            here = node_begin[bounds[2 * here + 1]];
        }
    }
    i64 C = (i64)chain_structs.size();
    for (i64 s = 0; s < S; ++s) chain_of[s] = parent_chain[s];

    // chain parents + chains inside each snarl via the in-structure DFS
    std::vector<std::vector<i64>> chains_inside(S);
    for (i64 c = 0; c < C; ++c) chain_parent[c] = -1;
    {
        std::vector<bool> traversed(V, false);
        std::vector<i64> stack;
        for (i64 sid = 0; sid < S; ++sid) {
            stack.assign(1, bounds[2 * sid]);
            while (!stack.empty()) {
                i64 v = stack.back();
                stack.pop_back();
                for (i64 k = nptr[v]; k < nptr[v + 1]; ++k) {
                    i64 nx = nind[k];
                    if (nx == bounds[2 * sid + 1] || traversed[nx]) continue;
                    traversed[nx] = true;
                    i64 nsid = node_begin[nx];
                    if (nsid != -1) {
                        i64 cid = parent_chain[nsid];
                        chain_parent[cid] = sid;
                        chains_inside[sid].push_back(cid);
                        i64 final_sid = chain_structs[cid].back();
                        i64 final_node = bounds[2 * final_sid + 1];
                        traversed[final_node] = true;
                        stack.push_back(final_node);
                    } else {
                        stack.push_back(nx);
                    }
                }
            }
        }
    }

    // per-snarl net graph + acyclicity (NetGraph ctor semantics,
    // structure_tree.hpp:321-408; acyclicity = Kahn completes)
    auto net_acyclic_of = [&](i64 sid) -> bool {
        i64 start = bounds[2 * sid], end = bounds[2 * sid + 1];
        std::unordered_map<i64, i64> fwd;   // graph node -> net node
        std::vector<std::vector<i64>> net_next;
        auto add_node = [&]() {
            net_next.emplace_back();
            return (i64)net_next.size() - 1;
        };
        fwd[start] = add_node();
        std::vector<i64> stack(1, start);
        std::vector<std::pair<i64, i64>> edges;
        while (!stack.empty()) {
            i64 v = stack.back();
            stack.pop_back();
            if (v == end) continue;
            for (i64 k = nptr[v]; k < nptr[v + 1]; ++k) {
                i64 nx = nind[k];
                auto it = fwd.find(nx);
                if (it != fwd.end()) {
                    net_next[fwd[v]].push_back(it->second);
                } else {
                    i64 nsid = node_begin[nx];
                    if (nsid != -1 && nx != end) {
                        i64 cid = parent_chain[nsid];
                        i64 net_id = add_node();
                        i64 final_sid = chain_structs[cid].back();
                        i64 final_node = bounds[2 * final_sid + 1];
                        fwd[nx] = net_id;
                        fwd[final_node] = net_id;
                        net_next[fwd[v]].push_back(net_id);
                        stack.push_back(final_node);
                    } else {
                        i64 net_id = add_node();
                        fwd[nx] = net_id;
                        net_next[fwd[v]].push_back(net_id);
                        stack.push_back(nx);
                    }
                }
            }
        }
        // Kahn acyclicity
        i64 n = (i64)net_next.size();
        std::vector<i64> indeg(n, 0);
        for (i64 v = 0; v < n; ++v)
            for (i64 nx : net_next[v]) ++indeg[nx];
        std::vector<i64> q;
        for (i64 v = 0; v < n; ++v)
            if (indeg[v] == 0) q.push_back(v);
        i64 seen = 0;
        while (!q.empty()) {
            i64 v = q.back();
            q.pop_back();
            ++seen;
            for (i64 nx : net_next[v])
                if (--indeg[nx] == 0) q.push_back(nx);
        }
        return seen == n;
    };

    // postorder acyclicity flags (snarls.hpp:70-123): process chains after
    // their snarls; a chain is acyclic iff all its snarls are; a snarl is
    // acyclic iff its net graph is and all contained chains are
    // (postorder = children-first over the snarl/chain tree)
    std::vector<i64> snarl_ac(S, -1), chain_ac(C, -1), net_ac(S, -1);
    // process in dependency order: repeat until settled (tree depth passes)
    {
        std::function<void(i64)> eval_chain;
        std::function<void(i64)> eval_snarl = [&](i64 sid) {
            if (snarl_ac[sid] != -1) return;
            for (i64 cid : chains_inside[sid]) eval_chain(cid);
            bool net = net_acyclic_of(sid);
            net_ac[sid] = net ? 1 : 0;
            bool ac = net;
            if (ac) {
                for (i64 cid : chains_inside[sid]) {
                    if (!chain_ac[cid]) { ac = false; break; }
                }
            }
            snarl_ac[sid] = ac ? 1 : 0;
        };
        eval_chain = [&](i64 cid) {
            if (chain_ac[cid] != -1) return;
            bool ac = true;
            for (i64 sid : chain_structs[cid]) {
                eval_snarl(sid);
                if (!snarl_ac[sid]) ac = false;
            }
            chain_ac[cid] = ac ? 1 : 0;
        };
        for (i64 c = 0; c < C; ++c) eval_chain(c);
    }
    for (i64 s = 0; s < S; ++s) {
        snarl_acyclic[s] = snarl_ac[s];
        net_acyclic[s] = net_ac[s];
    }
    for (i64 c = 0; c < C; ++c) chain_acyclic[c] = chain_ac[c];

    // simplify_bubbles' chain triviality: all snarls in the chain have
    // next_size(start) == 1 (modify_graph.cpp:174-182)
    for (i64 c = 0; c < C; ++c) {
        i64 trivial = 1;
        for (i64 sid : chain_structs[c]) {
            i64 st = bounds[2 * sid];
            if (nptr[st + 1] - nptr[st] != 1) {
                trivial = 0;
                break;
            }
        }
        trivial_chain[c] = trivial;
    }

    *n_chains_out = C;
    return S;
}

}  // extern "C"
