// Dependency levels of the device-chaining scans (ops/chain_cdq.py and
// ops/chain_scan.py), made on the host for their level-synchronous kernels
// (csrc/chain_cdq.cu, csrc/chain_scan.cu). The JAX package runs both scans
// one step per anchor or event; a step's level is one more than the largest
// level among the steps whose results it may read, and every step of a
// level can run at once.
//
// cdq_row_levels: rows sorted by ps1 (non-decreasing). The level of row j
// is 1 + the largest level of a row i < j with pe1[i] < ps1[j], 1 when
// there is none. Levels never fall in this order, so that largest level is
// the level of the LATEST such row. That row is a strict suffix minimum of
// pe1 over [0, j) (every later row has pe1 >= ps1[j] > pe1[i]), so a stack
// of those minima (pe1 and index increasing from the bottom) holds every
// candidate, and a binary search finds the latest one below ps1[j].
// O(n log n).
//
// chain_event_levels: an event stream of (kind: 0 query / 1 insert, slot,
// qhi, weight bits) rows. The level of a query with qhi > 0 is 1 + the
// largest level of an insert before it. An insert takes the level of its
// slot's query when that query came first (it stores that query's result),
// else 0 (it stores the slot's initial dp). Queries with qhi <= 0 read
// nothing and get level 0. One pass, O(E). Returns the number of levels,
// or -1 when a slot is out of range, inserted or queried twice, or an
// event has another kind: the level-synchronous kernel does not take such
// a stream.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" void cdq_row_levels(int64_t n, const int64_t* ps1,
                               const int64_t* pe1, int64_t* level) {
  std::vector<int64_t> stack;  // indices; pe1 strictly increasing upwards
  stack.reserve(n);
  for (int64_t j = 0; j < n; ++j) {
    // the first stack entry with pe1 >= ps1[j]; the one below it is the
    // latest row with pe1 < ps1[j]
    const auto it = std::lower_bound(
        stack.begin(), stack.end(), ps1[j],
        [pe1](int64_t i, int64_t x) { return pe1[i] < x; });
    level[j] = it == stack.begin() ? 1 : level[*(it - 1)] + 1;
    while (!stack.empty() && pe1[stack.back()] >= pe1[j]) stack.pop_back();
    stack.push_back(j);
  }
}

extern "C" int64_t chain_event_levels(int64_t E, const int32_t* ev,
                                      int64_t n, int32_t* level) {
  std::vector<int32_t> query_level(n, -1);  // -1: not queried yet
  std::vector<uint8_t> inserted(n, 0), queried(n, 0);
  int32_t top = 0;  // the largest level of an insert so far
  int32_t depth = 0;
  for (int64_t e = 0; e < E; ++e) {
    const int32_t kind = ev[4 * e], slot = ev[4 * e + 1],
                  qhi = ev[4 * e + 2];
    if (slot < 0 || slot >= n) return -1;
    level[e] = 0;
    if (kind == 1) {
      if (inserted[slot]) return -1;
      inserted[slot] = 1;
      top = std::max(top, query_level[slot]);
    } else if (kind == 0) {
      if (queried[slot]) return -1;
      queried[slot] = 1;
      if (qhi > 0) {
        level[e] = top + 1;
        query_level[slot] = top + 1;
        depth = std::max(depth, top + 1);
      }
    } else {
      return -1;
    }
  }
  return depth;
}
