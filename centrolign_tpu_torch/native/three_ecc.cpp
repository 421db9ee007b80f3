// Three-edge-connected components, implemented from the algorithm in
// Y. H. Tsin, "A simple 3-edge-connected component algorithm" (Theory
// Comput. Syst. 40, 2007) / Norouzi & Tsin (2014): one DFS with
// absorb-eject path merging.
//
// The result this function must match (reference
// three_edge_connected_components.hpp as used by cactus.hpp) is CANONICAL:
// the 3ECC partition of a multigraph is unique, and the reference numbers
// components by the rank of their smallest member node id (its final
// connected-components pass starts from ascending node ids). So no
// structural mirroring of any other implementation is needed — this file
// expresses the paper's algorithm directly:
//
//  - the DFS runs on CSR arc cursors in forward order (no materialized
//    neighbor lists; the absorb-eject invariants are order-independent),
//  - per-vertex state is flat SoA arrays (pre/post order, low point,
//    effective degree, w-path successor, on-path flag),
//  - component merges go straight into a union-find (the paper's "absorb"
//    is exactly a union plus a degree transfer), and the canonical
//    numbering falls out of a single ascending scan at the end.
//
// Bridge edges are censored (a bridge endpoint pair can never be
// 3-edge-connected), self-loop arcs are skipped outright (they contribute
// +1/-1 to the effective degree in the paper's accounting, i.e. nothing).

#include <cstdint>
#include <vector>

namespace {

using i64 = int64_t;
constexpr i64 NONE = -1;

struct UnionFind {
    std::vector<i64> parent;
    explicit UnionFind(i64 n) : parent(n) {
        for (i64 i = 0; i < n; ++i) parent[i] = i;
    }
    i64 find(i64 x) {
        i64 root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            i64 up = parent[x];
            parent[x] = root;
            x = up;
        }
        return root;
    }
    void unite(i64 a, i64 b) { parent[find(b)] = find(a); }
};

}  // namespace

extern "C" {

// graph as directed CSRs (next + previous adjacency, multigraph allowed).
// out_comp: (V,) component id per node, numbered by ascending minimum
// member id (the canonical order). Returns the number of components.
i64 three_edge_connected_components(
        i64 V, const i64* nptr, const i64* nind, const i64* pptr,
        const i64* pind, i64* out_comp) {
    if (V == 0) return 0;

    std::vector<i64> pre(V, 0);       // DFS entry order, 1-based; 0 = new
    std::vector<i64> post(V, 0);      // DFS exit stamp
    std::vector<i64> low(V, 0);       // low point (pre-order value)
    std::vector<i64> deg(V, 0);       // effective degree
    std::vector<i64> wnext(V, NONE);  // w-path successor
    std::vector<char> onpath(V, 0);
    UnionFind uf(V);

    // absorb every on-path vertex of the path [start, past_end) into
    // `into` (or into the first on-path vertex when `into` is NONE),
    // transferring effective degrees (paper's absorption rule)
    auto absorb = [&](i64 into, i64 start, i64 past_end) {
        for (i64 v = start; v != past_end && v != NONE; v = wnext[v]) {
            if (!onpath[v]) continue;
            if (into == NONE) {
                into = v;
            } else {
                deg[into] += deg[v] - 2;
                uf.unite(into, v);
            }
        }
    };

    // iterative DFS over arc cursors: each vertex's incident arcs are the
    // concatenation of its previous- and next-CSR rows, visited in forward
    // order. cursor k in [0, pdeg+ndeg).
    struct Frame {
        i64 v;
        i64 parent;        // DFS tree parent (NONE at a root)
        i64 k;             // next arc cursor
        i64 child;         // set while a child call is outstanding
        bool parent_skipped;  // exactly one parent arc is the tree edge
    };
    std::vector<Frame> stack;

    i64 clock = 1;
    for (i64 root = 0; root < V; ++root) {
        if (pre[root]) continue;
        stack.push_back({root, NONE, 0, NONE, false});
        while (!stack.empty()) {
            Frame& fr = stack.back();
            i64 w = fr.v;
            if (pre[w] == 0) {
                pre[w] = clock++;
                low[w] = pre[w];
                onpath[w] = 1;
            }

            if (fr.child != NONE) {
                // returning from tree-edge child u
                i64 u = fr.child;
                fr.child = NONE;
                if (low[u] == pre[u]) {
                    // (w, u) is a bridge: censor it on both sides
                    --deg[u];
                    --deg[w];
                } else {
                    if (deg[u] == 2) onpath[u] = 0;  // eject u
                    if (low[w] <= low[u]) {
                        absorb(w, u, NONE);
                    } else {
                        low[w] = low[u];
                        absorb(NONE, w, NONE);
                        onpath[w] = 1;
                        wnext[w] = u;
                    }
                }
            }

            i64 pdeg = pptr[w + 1] - pptr[w];
            i64 arcs = pdeg + (nptr[w + 1] - nptr[w]);
            bool descended = false;
            while (fr.k < arcs) {
                i64 k = fr.k;
                i64 u = (k < pdeg) ? pind[pptr[w] + k]
                                   : nind[nptr[w] + (k - pdeg)];
                if (u == w) {  // self loop: +1 then -1 in the paper
                    ++fr.k;
                    continue;
                }
                if (pre[u] == 0) {
                    // tree edge: child counts it on its side below
                    ++deg[w];
                    ++fr.k;
                    fr.child = u;
                    stack.push_back({u, w, 0, NONE, false});
                    descended = true;
                    break;
                }
                if (u == fr.parent && !fr.parent_skipped) {
                    // the one parent arc that is the DFS tree edge
                    // (counted at this end when the parent descended)
                    fr.parent_skipped = true;
                    ++deg[w];
                    ++fr.k;
                    continue;
                }
                if (pre[u] < pre[w]) {
                    // outgoing back edge w -> ancestor u
                    ++deg[w];
                    if (pre[u] < low[w]) {
                        absorb(NONE, w, NONE);
                        low[w] = pre[u];
                        onpath[w] = 1;
                        wnext[w] = NONE;
                    }
                } else {
                    // incoming back edge from the (finished) descendant u:
                    // the w-path prefix of u's ancestors collapses into w
                    --deg[w];  // paper: +1 for the arc, -2 for absorption
                    i64 last = w;
                    i64 cand = wnext[last];
                    while (cand != NONE && pre[cand] <= pre[u] &&
                           post[cand] >= post[u]) {
                        last = cand;
                        cand = wnext[last];
                    }
                    absorb(NONE, w, wnext[last]);
                    wnext[w] = wnext[last];
                }
                ++fr.k;
            }
            if (descended) continue;
            if (fr.k >= arcs) {
                post[w] = clock;
                stack.pop_back();
            }
        }
    }

    // canonical numbering: component id = rank of its smallest member
    std::vector<i64> comp_id(V, NONE);
    i64 n_comp = 0;
    for (i64 v = 0; v < V; ++v) {
        i64 r = uf.find(v);
        if (comp_id[r] == NONE) comp_id[r] = n_comp++;
        out_comp[v] = comp_id[r];
    }
    return n_comp;
}

}  // extern "C"
