// The offline CDQ value core of SparseAffine chaining, shared by the
// chain x chain entry (chain_affine_cdq.cpp) and the graph x graph entry
// (chain_parity.cpp::chain_affine_graph_cdq).
//
// The reference's sweep (sparse_affine_chain_dp, anchorer.hpp:2290-2420)
// keeps one OrthogonalMaxSearchTree (six piecewise channels) and one
// MaxSearchTree per shift (the gap-free channel) for every (path1, path2)
// family. Its DP values are f32 maxima, which do not depend on the order
// they are taken in, so they follow from a timeline of events:
//
//   insert (anchor a, family f, shift, offset)  at the sweep's time of
//       a's end: publishes dp_a on the gap-free channel and
//       f32(f64(dp_a) -/+ scale*ge[k]*shift) on the six channels
//   query  (anchor a, family f, qshift, qoffset) at the sweep's time of
//       one of a's forward edges: max over the family's earlier inserts
//       with offset < qoffset and shift < / == / > qshift, folded per
//       channel with the sweep's f32/f64 rounding, into dp_a
//
// A 3-D dominance problem over (time, shift, offset) per family, solved
// offline by CDQ divide and conquer over time with the family as the
// major sort key: a left-half insert reaches only right-half queries of
// its own family. An anchor's queries fold into its dp in the sweep's
// update_dp order (query time, then creation order, then the gap-free
// channel before channels 0-5) with first-writer-wins ties, so the
// winning (query, channel) is the sweep's; the anchor is flagged tied
// only when that channel's max had two or more achievers, whose choice
// depends on the trees' visit order (chain_ties.py replays it).
#pragma once

#include <cstdint>
#include <vector>

namespace centrolign_cdq {

// Events in creation order. `time` orders them; events of equal time must
// be mutually independent, and their creation order is the fold order of
// an anchor's queries. Every query of an anchor precedes its inserts.
struct Timeline {
    std::vector<uint8_t> kind;   // 0 = query, 1 = insert
    std::vector<int32_t> aid;    // anchor id
    std::vector<int32_t> fam;    // family
    std::vector<int64_t> skey;   // insert: shift; query: query shift
    std::vector<int64_t> okey;   // insert: offset; query: exclusive bound
    std::vector<int64_t> time;

    void add(uint8_t k, int64_t a, int64_t f, int64_t s, int64_t o,
             int64_t t) {
        kind.push_back(k);
        aid.push_back((int32_t)a);
        fam.push_back((int32_t)f);
        skey.push_back(s);
        okey.push_back(o);
        time.push_back(t);
    }
    int64_t size() const { return (int64_t)kind.size(); }
};

// Per-anchor outputs (n each): dp; bp (-1 = none); tie (the winning
// channel's max had >= 2 achievers); struct (0 = gap-free, 1 + pw = channel
// pw, 255 = none won); stored (the winning channel's max); win (creation
// index of the winning query event, -1 = none).
struct Outputs {
    float* dp;
    int64_t* bp;
    uint8_t* tie;
    uint8_t* strct;
    float* stored;
    int64_t* win;
};

// Runs the value pass over `ev` (consumed) for n anchors with weights w
// and initial dp init. Returns false when n does not fit the core's
// 32-bit anchor ids.
bool affine_values(Timeline& ev, int64_t n, const float* w,
                   const float* init, const double* gap_open,
                   const double* gap_extend, double scale, Outputs out);

}  // namespace centrolign_cdq
