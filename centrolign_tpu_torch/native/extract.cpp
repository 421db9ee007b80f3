// Native subgraph extraction between anchors — port of
// centrolign_tpu/extractor.py extract_connecting_graph (reference
// subgraph_extraction.hpp:35-118). The LIFO stack walk and first-encounter
// id assignment are preserved exactly: downstream alignment traceback
// tie-breaking depends on the adjacency-order node numbering.

#include <cstdint>
#include <vector>

namespace {
using i64 = int64_t;
}

// Scratch arrays `fwd` and `epoch` are caller-owned (size V) and reused
// across calls: valid iff epoch[v] == cur_epoch. counts out:
// [n_nodes, n_edges, n_sources, n_sinks]. TI = reachability-table width.
template <typename TI>
static void extract_connecting_impl(
        i64 V, const i64* nptr, const i64* nind, const uint8_t* labels,
        i64 from_id, i64 to_id,
        i64 C, const TI* table,      // (V, C) row-major
        const i64* path_head,          // (V,)
        const TI* index_on,           // (C, V) row-major
        i64* fwd, i64* epoch, i64 cur_epoch,
        uint8_t* out_labels, i64* out_back,
        i64* out_ef, i64* out_et,
        i64* out_sources, i64* out_sinks,
        i64* counts) {
    i64 n_nodes = 0, n_edges = 0, n_src = 0, n_snk = 0;

    auto reachable = [&](i64 a, i64 b) -> bool {
        i64 cf = path_head[a];
        if (cf == -1) return false;
        i64 last = table[b * C + cf];
        return last != -1 && index_on[cf * V + a] <= last;
    };

    std::vector<i64> stack;
    stack.push_back(from_id);
    while (!stack.empty()) {
        i64 node_id = stack.back();
        stack.pop_back();
        for (i64 k = nptr[node_id]; k < nptr[node_id + 1]; ++k) {
            i64 next_id = nind[k];
            if (next_id == to_id && node_id != from_id) {
                out_sinks[n_snk++] = fwd[node_id];
                continue;
            }
            if (!reachable(next_id, to_id)) continue;
            i64 sub_id;
            if (epoch[next_id] == cur_epoch) {
                sub_id = fwd[next_id];
            } else {
                sub_id = n_nodes++;
                out_labels[sub_id] = labels[next_id];
                out_back[sub_id] = next_id;
                fwd[next_id] = sub_id;
                epoch[next_id] = cur_epoch;
                stack.push_back(next_id);
            }
            if (node_id != from_id) {
                out_ef[n_edges] = fwd[node_id];
                out_et[n_edges] = sub_id;
                ++n_edges;
            } else {
                out_sources[n_src++] = sub_id;
            }
        }
    }
    counts[0] = n_nodes;
    counts[1] = n_edges;
    counts[2] = n_src;
    counts[3] = n_snk;
}

extern "C" {

void extract_connecting_native(
        i64 V, const i64* nptr, const i64* nind, const uint8_t* labels,
        i64 from_id, i64 to_id,
        i64 C, const void* table, const i64* path_head, const void* index_on,
        int table_width,
        i64* fwd, i64* epoch, i64 cur_epoch,
        uint8_t* out_labels, i64* out_back,
        i64* out_ef, i64* out_et,
        i64* out_sources, i64* out_sinks,
        i64* counts) {
    if (table_width == 4) {
        extract_connecting_impl<int32_t>(
            V, nptr, nind, labels, from_id, to_id, C,
            (const int32_t*)table, path_head, (const int32_t*)index_on,
            fwd, epoch, cur_epoch, out_labels, out_back, out_ef, out_et,
            out_sources, out_sinks, counts);
    } else {
        extract_connecting_impl<i64>(
            V, nptr, nind, labels, from_id, to_id, C,
            (const i64*)table, path_head, (const i64*)index_on,
            fwd, epoch, cur_epoch, out_labels, out_back, out_ef, out_et,
            out_sources, out_sinks, counts);
    }
}

}  // extern "C"
