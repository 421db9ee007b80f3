// Superbubble decomposition — behavioral twin of the reference's
// SuperbubbleTree (reference superbubbles.hpp:12-175, Gartner et al. 2018
// DAG sweep over the LIFO-Kahn topological order), the chain-forming pass of
// TwoDisconnectedStructureTree::initialize (structure_tree.hpp:156-272), and
// SuperbubbleDistances (structure_distances.hpp:22-175): min/max walk
// distance through each structure (node count inclusive of both boundaries)
// and each chain (sum minus shared-boundary overlaps).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <limits>
#include <stdexcept>

namespace {
using i64 = int64_t;

static std::vector<i64> ref_topo(i64 V, const i64* nptr, const i64* nind,
                                 const i64* pptr) {
    std::vector<i64> order, stack, indeg(V);
    order.reserve(V);
    for (i64 v = 0; v < V; ++v) {
        indeg[v] = pptr[v + 1] - pptr[v];
        if (indeg[v] == 0) stack.push_back(v);
    }
    while (!stack.empty()) {
        i64 v = stack.back();
        stack.pop_back();
        order.push_back(v);
        for (i64 k = nptr[v]; k < nptr[v + 1]; ++k)
            if (--indeg[nind[k]] == 0) stack.push_back(nind[k]);
    }
    return order;
}
}  // namespace

extern "C" {

// Returns S (number of structures; -1 on error: not single-source/sink).
// Output arrays are caller-allocated with capacity V (or (V,2)):
//   node_begin/node_end: structure beginning/ending at node, or -1
//   bounds: (S, 2) boundaries; sdist: (S, 2) min/max node-count dists
//   chain_of: (S,) chain id per structure
//   chain_parent: (V,) parent structure of chain, -1 = top level
//   chain_dist: (V, 2) chain min/max dists
//   n_chains_out: (1,)
i64 superbubbles_build(
        i64 V, const i64* nptr, const i64* nind, const i64* pptr,
        const i64* pind, i64 src_id, i64 snk_id,
        i64* node_begin, i64* node_end, i64* bounds, i64* sdist,
        i64* chain_of, i64* chain_parent, i64* chain_dist,
        i64* n_chains_out) {
    auto order = ref_topo(V, nptr, nind, pptr);
    std::vector<i64> index(V);
    i64 n_src = 0, n_snk = 0;
    for (i64 i = 0; i < V; ++i) {
        index[order[i]] = i;
        if (pptr[i + 1] - pptr[i] == 0) ++n_src;
        if (nptr[i + 1] - nptr[i] == 0) ++n_snk;
    }
    if (n_src != 1 || n_snk != 1) return -1;

    // Gartner et al. sweep (superbubbles.hpp:66-172)
    std::vector<std::pair<i64, i64>> raw;
    {
        std::vector<i64> candidate_stack;
        std::vector<i64> backward_reach(V, std::numeric_limits<i64>::max());
        for (i64 i = V - 1; i >= 0; --i) {
            i64 fwd = -1;
            i64 v = order[i];
            for (i64 k = nptr[v]; k < nptr[v + 1]; ++k)
                fwd = std::max(fwd, index[nind[k]]);
            if (fwd == i + 1) candidate_stack.push_back(i + 1);
            while (!candidate_stack.empty() && fwd > candidate_stack.back()) {
                i64 invalid = candidate_stack.back();
                candidate_stack.pop_back();
                if (!candidate_stack.empty()) {
                    backward_reach[candidate_stack.back()] = std::min(
                        backward_reach[candidate_stack.back()],
                        backward_reach[invalid]);
                }
            }
            if (!candidate_stack.empty() &&
                backward_reach[candidate_stack.back()] == i) {
                i64 confirmed = candidate_stack.back();
                raw.emplace_back(order[i], order[confirmed]);
                candidate_stack.pop_back();
                if (!candidate_stack.empty()) {
                    backward_reach[candidate_stack.back()] = std::min(
                        backward_reach[candidate_stack.back()],
                        backward_reach[confirmed]);
                }
            }
            for (i64 k = pptr[v]; k < pptr[v + 1]; ++k)
                backward_reach[i] = std::min(backward_reach[i],
                                             index[pind[k]]);
            if (!candidate_stack.empty()) {
                backward_reach[candidate_stack.back()] = std::min(
                    backward_reach[candidate_stack.back()],
                    backward_reach[i]);
            }
        }
    }

    // record structures, skipping ones that touch the sentinels
    // (structure_tree.hpp:164-179)
    for (i64 v = 0; v < V; ++v) { node_begin[v] = -1; node_end[v] = -1; }
    i64 S = 0;
    for (const auto& sb : raw) {
        if (src_id >= 0 && (sb.first == src_id || sb.second == snk_id ||
                            sb.first == snk_id || sb.second == src_id)) {
            continue;
        }
        node_begin[sb.first] = S;
        node_end[sb.second] = S;
        bounds[2 * S] = sb.first;
        bounds[2 * S + 1] = sb.second;
        ++S;
    }

    // form chains (structure_tree.hpp:181-228)
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

    // chain parents via DFS inside each structure (structure_tree.hpp:233-272)
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

    // structure min/max distances: node-count inclusive of both boundaries,
    // DP over the topological interval of the bubble (values equal the
    // reference's net-graph DP, structure_distances.hpp:126-175)
    {
        std::vector<i64> dmin(V), dmax(V);
        for (i64 sid = 0; sid < S; ++sid) {
            i64 s = bounds[2 * sid], t = bounds[2 * sid + 1];
            i64 lo = index[s], hi = index[t];
            for (i64 p = lo; p <= hi; ++p) {
                dmin[order[p]] = std::numeric_limits<i64>::max();
                dmax[order[p]] = -1;
            }
            dmin[s] = 1;
            dmax[s] = 1;
            for (i64 p = lo; p <= hi; ++p) {
                i64 v = order[p];
                if (dmax[v] == -1) continue;
                for (i64 k = nptr[v]; k < nptr[v + 1]; ++k) {
                    i64 nx = nind[k];
                    if (index[nx] > hi) continue;
                    dmin[nx] = std::min(dmin[nx], dmin[v] + 1);
                    dmax[nx] = std::max(dmax[nx], dmax[v] + 1);
                }
            }
            sdist[2 * sid] = dmin[t];
            sdist[2 * sid + 1] = dmax[t];
        }
    }

    // chain distances: sum minus shared boundaries
    // (structure_distances.hpp:75-98)
    for (i64 c = 0; c < C; ++c) {
        i64 mn = 0, mx = 0;
        const auto& links = chain_structs[c];
        for (size_t i = 0; i < links.size(); ++i) {
            mn += sdist[2 * links[i]];
            mx += sdist[2 * links[i] + 1];
            if (i != 0) {
                mn -= 1;  // label size of the shared boundary node
                mx -= 1;
            }
        }
        chain_dist[2 * c] = mn;
        chain_dist[2 * c + 1] = mx;
    }

    *n_chains_out = C;
    return S;
}

}  // extern "C"
