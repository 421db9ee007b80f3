"""Subproblem table and scheduler for the progressive MSA.

Equivalent of the reference Execution (reference execution.hpp:19-99,
src/execution.cpp): leaf subproblems are chain graphs with sentinels; the
execution order is the smallest-subtree-first postorder of the internal guide
tree nodes. The reference runs strictly serially; sibling subproblems are
independent, which is the data-parallel axis the distributed scheduler in
parallel/ exploits.

Copy of centrolign_tpu/execution.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from .graph import BaseGraph
from .modify_graph import SentinelTableau, make_base_graph, add_sentinels
from .tree import Tree
from . import logging as logmod


@dataclass
class Subproblem:
    graph: BaseGraph = None
    tableau: SentinelTableau = None
    alignment: np.ndarray = None
    name: str = ""
    complete: bool = False


class Execution:
    def __init__(self, names_and_sequences, tree: Tree, suppress_logging=False):
        sequences = list(names_and_sequences)
        self.tree = tree
        name_to_idx = {}
        for i, (name, _) in enumerate(sequences):
            if name in name_to_idx:
                raise ValueError(f"FASTA contains duplicate name {name}")
            name_to_idx[name] = i

        leaf_ids = []
        for name, _ in sequences:
            if not tree.has_label(name):
                raise ValueError(f"Guide tree does not include sequence {name}")
            node_id = tree.get_id(name)
            if not tree.is_leaf(node_id):
                raise ValueError(f"Sequence {name} is not a leaf in the guide tree")
            leaf_ids.append(node_id)
        tree.prune(leaf_ids)
        tree.compact()
        tree.binarize()

        logmod.log(logmod.Basic if not suppress_logging else logmod.Debug,
                   "Initializing leaf subproblems.")

        self.subproblems = [Subproblem() for _ in range(tree.node_size)]
        for node_id in range(tree.node_size):
            if tree.is_leaf(node_id):
                name = tree.label(node_id)
                seq = sequences[name_to_idx[name]][1]
                sub = self.subproblems[node_id]
                sub.graph = make_base_graph(name, seq)
                sub.tableau = add_sentinels(sub.graph, 5, 6)
                sub.name = name
                sub.complete = True

        self.execution_order = [
            t for t in tree.small_first_postorder() if not tree.is_leaf(t)]
        self.next_subproblem = 0
        from .utils.memory import log_memory_usage
        log_memory_usage(logmod.Debug)

    def finished(self) -> bool:
        return self.next_subproblem >= len(self.execution_order)

    def next(self):
        node_id = self.execution_order[self.next_subproblem]
        self.next_subproblem += 1
        if logmod.level >= logmod.Verbose:
            names = "\n".join("\t" + n
                              for n in self.leaf_descendents(node_id))
            logmod.log(logmod.Verbose,
                       "Next subproblem contains sequences:\n" + names)
        children = self.tree.get_children(node_id)
        if len(children) != 2:
            raise RuntimeError("Attempting execution with a tree that is not binary")
        return (self.subproblems[node_id],
                self.subproblems[children[0]],
                self.subproblems[children[-1]])

    def leaf_subproblems(self):
        return [self.subproblems[t] for t in range(self.tree.node_size)
                if self.tree.is_leaf(t)]

    def root_subproblem(self) -> Subproblem:
        return self.subproblems[self.tree.get_root()]

    def leaf_subproblem(self, name: str) -> Subproblem:
        return self.subproblems[self.tree.get_id(name)]

    def leaf_descendents(self, node_id: int):
        names = []
        stack = [node_id]
        while stack:
            v = stack.pop()
            if self.tree.is_leaf(v):
                names.append(self.tree.label(v))
            else:
                stack.extend(self.tree.get_children(v))
        return names

    def subproblem_hash(self, node_id: int) -> int:
        """The reference's digest of the sorted contained sequence names
        (src/execution.cpp:190-203; hash_combine from utility.hpp:357-360
        with libstdc++ identity integer hashing), so checkpoint filenames
        interoperate with reference-produced checkpoints."""
        M = (1 << 64) - 1

        def combine(seed: int, v: int) -> int:
            return (seed ^ ((v + 0x9e3779b9 + ((seed << 6) & M)
                             + (seed >> 2)) & M)) & M

        h = 660422875706093811
        for name in sorted(self.leaf_descendents(node_id)):
            h = combine(h, 2110260111091729000)
            for c in name.encode():
                # std::hash<char> of a (signed) char value
                cv = c if c < 128 else c - 256
                h = combine(h, cv & M)
            # note: negative chars wrap to 2^64 like size_t conversion
        return h

    def independent_layers(self):
        """Group the execution order into dependency layers: all subproblems
        in one layer have completed children and are mutually independent —
        the data-parallel unit for multi-host scheduling (the reference is
        strictly serial; see SURVEY §2.8)."""
        depth = {}
        for t in self.tree.postorder():
            if self.tree.is_leaf(t):
                depth[t] = 0
            else:
                depth[t] = 1 + max(depth[c] for c in self.tree.get_children(t))
        layers: dict[int, list[int]] = {}
        for t in self.execution_order:
            layers.setdefault(depth[t], []).append(t)
        return [layers[d] for d in sorted(layers)]
