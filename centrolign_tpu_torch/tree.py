"""Guide tree: Newick parse/serialize, prune/compact/binarize/polytomize,
traversal orders.

Behavior matches the reference Tree (reference include/centrolign/tree.hpp:19,
src/tree.cpp): double-quoted labels, '#'-forbidden labels, binarize() expands
polytomies into right-leaning caterpillars with '#i'-suffixed labels,
small_first_postorder() stable-sorts all nodes by (subtree leaf count,
postorder index). postorder() is the reference's stack order (children
visited last-to-first), which subproblem scheduling parity depends on.

Copy of centrolign_tpu/tree.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

_NO_DIST = math.inf


@dataclass
class _Node:
    label: str = ""
    parent: int = -1
    distance: float = _NO_DIST
    children: list[int] = field(default_factory=list)


def in_order_newick_string(sequence_names: list[str]) -> str:
    """Left-leaning caterpillar over the names in input order (used when no
    guide tree is given; reference src/tree.cpp:17-37)."""
    for name in sequence_names:
        if '"' in name:
            raise ValueError(f"Sequence names cannot have internal quotation marks: {name}")
    parts = ["(" * (len(sequence_names) - 1)]
    if sequence_names:
        parts.append(f'"{sequence_names[0]}"')
        for name in sequence_names[1:]:
            parts.append(f',"{name}")')
    parts.append(";")
    return "".join(parts)


def _find_skipping_quotes(s: str, start: int, end: int, values: str) -> int:
    in_quote = False
    for i in range(start, end):
        c = s[i]
        if c == '"':
            in_quote = not in_quote
        elif not in_quote and c in values:
            return i
    return end


class Tree:
    def __init__(self, newick: str | None = None):
        self.nodes: list[_Node] = []
        self.root: int = -1
        self._label_map: dict[str, int] = {}
        if newick is not None:
            self._parse(newick)

    # ------------- parsing -------------

    def _parse(self, newick: str) -> None:
        n = len(newick)
        semi = _find_skipping_quotes(newick, 0, n, ";")
        if semi == n:
            raise ValueError("Newick string is missing a terminating ';'")
        if any(not ch.isspace() for ch in newick[semi + 1:]):
            raise ValueError("Newick string includes characters after the terminating ';'")
        if newick.count('"') % 2 == 1:
            raise ValueError("Newick string has an odd number of quotation marks")
        if "'" in newick:
            raise ValueError("Newick string parser does not support single quotes (')")

        if _find_skipping_quotes(newick, 0, n, "()") == n:
            self.nodes.append(_Node())
            self._parse_label(0, newick[:semi])
            self.root = 0
        else:
            stack: list[int] = []
            cursor = 0
            ascending = -1
            while cursor < n:
                nxt = _find_skipping_quotes(newick, cursor, n, ",();")
                ch = newick[nxt] if nxt < n else ";"
                tok = newick[cursor:nxt]
                if ch == ";":
                    if ascending != -1:
                        self._parse_label(ascending, tok)
                    break
                elif ch == "(":
                    if not stack:
                        if self.root != -1 or self.nodes:
                            raise ValueError("Newick string encodes a disconnected tree")
                        self.nodes.append(_Node())
                        node_id = 0
                        self.root = 0
                    else:
                        node_id = self._add_child(stack[-1])
                    stack.append(node_id)
                    ascending = -1
                elif ch == ",":
                    if ascending == -1:
                        node_id = self._add_child(stack[-1])
                        self._parse_label(node_id, tok)
                    else:
                        self._parse_label(ascending, tok)
                    ascending = -1
                elif ch == ")":
                    if ascending == -1:
                        node_id = self._add_child(stack[-1])
                        self._parse_label(node_id, tok)
                    else:
                        self._parse_label(ascending, tok)
                    ascending = stack.pop()
                cursor = nxt + 1

        for node_id, node in enumerate(self.nodes):
            if "#" in node.label:
                raise ValueError(f"Tree labels may not include '#': {node.label}")
            if node.label:
                if node.label in self._label_map:
                    raise ValueError(f"Duplicate label {node.label} in guide tree")
                self._label_map[node.label] = node_id

    def _add_child(self, parent_id: int) -> int:
        node_id = len(self.nodes)
        self.nodes.append(_Node(parent=parent_id))
        self.nodes[parent_id].children.append(node_id)
        return node_id

    def _parse_label(self, node_id: int, token: str) -> None:
        node = self.nodes[node_id]
        div = _find_skipping_quotes(token, 0, len(token), ":")
        lab = token[:div].strip()
        if lab.startswith('"'):
            if len(lab) == 1:
                raise ValueError("Newick string label consists of only one quotation mark")
            if not lab.endswith('"'):
                raise ValueError(f"Newick string label has unmatched quotation mark: {lab}")
            lab = lab[1:-1]
        if '"' in lab:
            raise ValueError(f"Newick string label has internal quotation mark: {lab}")
        node.label = lab
        if div != len(token):
            dist_str = token[div + 1:].strip()
            if not dist_str:
                raise ValueError("Newick string has ':' without a distance following it")
            try:
                node.distance = float(dist_str)
            except ValueError:
                # strtod semantics: parse the leading float prefix
                import re
                m = re.match(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", dist_str)
                node.distance = float(m.group(0)) if m else 0.0

    # ------------- queries -------------

    @property
    def node_size(self) -> int:
        return len(self.nodes)

    def has_label(self, label: str) -> bool:
        return label in self._label_map

    def get_id(self, label: str) -> int:
        return self._label_map[label]

    def get_root(self) -> int:
        return self.root

    def get_parent(self, node_id: int) -> int:
        return self.nodes[node_id].parent

    def get_children(self, node_id: int) -> list[int]:
        return self.nodes[node_id].children

    def label(self, node_id: int) -> str:
        return self.nodes[node_id].label

    def distance(self, node_id: int) -> float:
        return self.nodes[node_id].distance

    def is_leaf(self, node_id: int) -> bool:
        return not self.nodes[node_id].children

    # ------------- transforms -------------

    def binarize(self) -> None:
        """Expand each polytomy into a right-leaning caterpillar of binary
        nodes; an original label L becomes L#0, L#1, ... down the spine
        (reference src/tree.cpp:288-333)."""
        for node_id in range(len(self.nodes)):
            node = self.nodes[node_id]
            if len(node.children) > 2:
                label = node.label
                label_num = 0
                if label:
                    node.label = f"{label}#{label_num}"
                    label_num += 1
                children = node.children
                node.children = [children[0]]
                prev_id = node_id
                for i in range(2, len(children)):
                    new_id = len(self.nodes)
                    new_node = _Node(distance=0.0, parent=prev_id)
                    if label:
                        new_node.label = f"{label}#{label_num}"
                        label_num += 1
                    self.nodes.append(new_node)
                    self.nodes[prev_id].children.append(new_id)
                    new_node.children.append(children[i - 1])
                    self.nodes[children[i - 1]].parent = new_id
                    prev_id = new_id
                self.nodes[prev_id].children.append(children[-1])
                self.nodes[children[-1]].parent = prev_id
        self._rebuild_label_map()

    def polytomize(self) -> None:
        """Convert 0-distance children into polytomies and drop internal
        nodes without original-leaf descendants (reference src/tree.cpp:335)."""
        has_leaf_desc = [False] * len(self.nodes)
        for node_id in self.preorder():
            has_leaf_desc[node_id] = self.is_leaf(node_id)
            if node_id == self.root:
                continue
            node = self.nodes[node_id]
            i = 0
            while i < len(node.children):
                child_id = node.children[i]
                child = self.nodes[child_id]
                if child.distance == 0.0:
                    child.parent = node.parent
                    child.distance = node.distance
                    self.nodes[node.parent].children.append(child_id)
                    node.children[i] = node.children[-1]
                    node.children.pop()
                else:
                    i += 1
        for node_id in self.postorder():
            if node_id == self.root:
                continue
            p = self.get_parent(node_id)
            has_leaf_desc[p] = has_leaf_desc[p] or has_leaf_desc[node_id]
        self._filter(has_leaf_desc)

    def prune(self, node_ids: list[int]) -> None:
        """Keep only the given nodes, their ancestors below their LCA, and the
        LCA itself (reference src/tree.cpp:383-421)."""
        keep = [False] * len(self.nodes)
        for node_id in node_ids:
            here = node_id
            while here != -1 and not keep[here]:
                keep[here] = True
                here = self.get_parent(here)

        def keep_children(nid):
            return [c for c in self.nodes[nid].children if keep[c]]

        here = self.root
        while here != -1 and keep[here] and len(keep_children(here)) == 1:
            keep[here] = False
            here = keep_children(here)[0]
        if node_ids:
            keep[node_ids[0]] = True
        self._filter(keep)
        if self.nodes:
            self.nodes[self.root].distance = _NO_DIST

    def compact(self) -> None:
        """Remove unary nodes, summing distances down compacted chains
        (reference src/tree.cpp:423-460; the reference's distance-summing loop
        is buggy/non-advancing — we implement the evident intent)."""
        keep = [True] * len(self.nodes)
        for node_id, node in enumerate(self.nodes):
            if len(node.children) == 1:
                keep[node_id] = False
                if node_id == self.root:
                    self.root = node.children[0]
                    self.nodes[node.children[0]].parent = -1
                else:
                    self.nodes[node.parent].children.append(node.children[0])
                    self.nodes[node.children[0]].parent = node.parent
        for node_id, node in enumerate(self.nodes):
            if keep[node_id]:
                here = node.parent
                while here != -1 and not keep[here] and node.distance != _NO_DIST:
                    if self.nodes[here].distance != _NO_DIST:
                        node.distance += self.nodes[here].distance
                    else:
                        node.distance = _NO_DIST
                    here = self.nodes[here].parent
        self._filter(keep)

    def _filter(self, keep: list[bool]) -> None:
        """Compact node storage to the kept nodes (reference src/tree.cpp:472)."""
        new_id = {}
        new_nodes = []
        for node_id, node in enumerate(self.nodes):
            if keep[node_id]:
                new_id[node_id] = len(new_nodes)
                new_nodes.append(node)
        if len(new_nodes) == len(self.nodes):
            return
        for node in new_nodes:
            node.children = [new_id[c] for c in node.children if keep[c]]
            node.parent = -1
        self.nodes = new_nodes
        for node_id, node in enumerate(self.nodes):
            for c in node.children:
                self.nodes[c].parent = node_id
        self.root = -1
        for node_id, node in enumerate(self.nodes):
            if node.parent == -1:
                self.root = node_id
                break
        self._rebuild_label_map()

    def _rebuild_label_map(self) -> None:
        self._label_map = {}
        for node_id, node in enumerate(self.nodes):
            if node.label:
                self._label_map[node.label] = node_id

    # ------------- orders -------------

    def preorder(self) -> list[int]:
        order = []
        if self.root != -1:
            stack = [self.root]
            while stack:
                top = stack.pop()
                order.append(top)
                stack.extend(self.nodes[top].children)
        return order

    def postorder(self) -> list[int]:
        """Stack-based postorder; children subtrees are visited in reverse
        child order, matching the reference (src/tree.cpp:531-560)."""
        order = []
        if self.root != -1:
            stack: list[tuple[int, bool]] = [(self.root, False)]
            while stack:
                node_id, expanded = stack[-1]
                if expanded:
                    order.append(node_id)
                    stack.pop()
                else:
                    stack[-1] = (node_id, True)
                    for c in self.nodes[node_id].children:
                        stack.append((c, False))
        return order

    def small_first_postorder(self) -> list[int]:
        """All node ids stably sorted by (subtree leaf count, postorder
        position) (reference src/tree.cpp:562-591)."""
        priority = [[0, 0] for _ in range(len(self.nodes))]
        for p, node_id in enumerate(self.postorder()):
            if self.is_leaf(node_id):
                priority[node_id][0] = 1
            else:
                priority[node_id][0] = sum(
                    priority[c][0] for c in self.nodes[node_id].children)
            priority[node_id][1] = p
        return sorted(range(len(self.nodes)), key=lambda i: tuple(priority[i]))

    # ------------- serialize -------------

    def to_newick(self) -> str:
        parts = []

        def fmt_float(d: float) -> str:
            # C++ ostream default formatting: 6 significant digits
            s = f"{d:.6g}"
            return s

        def recurse(node_id: int):
            node = self.nodes[node_id]
            if node.children:
                parts.append("(")
                for i, c in enumerate(node.children):
                    if i:
                        parts.append(",")
                    recurse(c)
                parts.append(")")
            if node.label:
                parts.append(f'"{node.label}"')
            if node.distance != _NO_DIST:
                parts.append(f":{fmt_float(node.distance)}")

        if self.root != -1:
            recurse(self.root)
        parts.append(";")
        return "".join(parts)
