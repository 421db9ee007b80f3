"""Behavioral replica of libstdc++'s binary-heap algorithms.

The reference iterates `std::vector`s that are maintained with
`std::make_heap`/`push_heap`/`pop_heap` in their raw layout order (e.g. the
active-interval sweep in induced_match_finder.hpp:255-344 emits walks in heap
layout order, and inconsistency_identifier.hpp:330-345 mutates the frame at
`heap.back()` after `pop_heap`). To reproduce those orders byte-for-byte we
replicate the exact GNU libstdc++ sift strategy (top-down to a leaf along the
larger child, then sift up) rather than using Python's `heapq` (which uses a
different layout).

`less(a, b)` is the C++ comparator: the heap is a max-heap w.r.t. `less`.

Copy of centrolign_tpu/utils/cpp_heap.py.
"""

from __future__ import annotations


def _sift_up(heap, hole, top, value, less):
    # __push_heap(first, holeIndex, topIndex, value)
    parent = (hole - 1) // 2
    while hole > top and less(heap[parent], value):
        heap[hole] = heap[parent]
        hole = parent
        parent = (hole - 1) // 2
    heap[hole] = value


def _adjust_heap(heap, hole, length, value, less):
    # __adjust_heap(first, holeIndex, len, value)
    top = hole
    second_child = hole
    while second_child < (length - 1) // 2:
        second_child = 2 * (second_child + 1)
        if less(heap[second_child], heap[second_child - 1]):
            second_child -= 1
        heap[hole] = heap[second_child]
        hole = second_child
    if length % 2 == 0 and second_child == (length - 2) // 2:
        second_child = 2 * (second_child + 1)
        heap[hole] = heap[second_child - 1]
        hole = second_child - 1
    _sift_up(heap, hole, top, value, less)


def push_heap(heap, less):
    """std::push_heap(first, last): heap[-1] is the newly appended element."""
    if len(heap) > 1:
        _sift_up(heap, len(heap) - 1, 0, heap[-1], less)


def pop_heap(heap, less):
    """std::pop_heap(first, last): moves the top to heap[-1], restores the
    heap on heap[:-1]. Does NOT shrink the list."""
    if len(heap) > 1:
        value = heap[-1]
        heap[-1] = heap[0]
        _adjust_heap(heap, 0, len(heap) - 1, value, less)


def pop_heap_range(heap, last, less):
    """std::pop_heap(first, first + last): operates on the prefix heap[:last]."""
    if last > 1:
        value = heap[last - 1]
        heap[last - 1] = heap[0]
        _adjust_heap(heap, 0, last - 1, value, less)


def make_heap(heap, less):
    """std::make_heap(first, last)."""
    n = len(heap)
    if n < 2:
        return
    parent = (n - 2) // 2
    while True:
        value = heap[parent]
        _adjust_heap(heap, parent, n, value, less)
        if parent == 0:
            return
        parent -= 1
