"""B+tree container store — the enterprise-tier Containers alternative.

Equivalent of the reference's enterprise/b/btree.go + containers_btree.go
(~1.2k LoC, swapped in via `roaring.NewFileBitmap = b.NewBTreeBitmap`,
enterprise/enterprise.go:29-32): an ordered container map that keeps keys
sorted for O(log n) point ops and cheap in-order iteration, better than a
hash map when a bitmap holds very many containers. Exposed as a
MutableMapping so the host Bitmap can use either backend unchanged; enable
globally with storage.bitmap.set_container_factory(BTreeContainers).
"""

from __future__ import annotations

import bisect
from collections.abc import MutableMapping
from typing import Iterator, List, Optional

ORDER = 64  # max keys per node


class _Node:
    __slots__ = ("keys", "values", "children")

    def __init__(self, leaf: bool):
        self.keys: List[int] = []
        self.values: Optional[List] = [] if leaf else None
        self.children: Optional[List["_Node"]] = None if leaf else []

    @property
    def leaf(self) -> bool:
        return self.children is None


class BTreeContainers(MutableMapping):
    def __init__(self, items=None):
        self._root = _Node(leaf=True)
        self._len = 0
        if items:
            for k, v in (items.items() if isinstance(items, (dict, MutableMapping)) else items):
                self[k] = v

    # ------------------------------------------------------------ internal

    def _find_leaf(self, key: int, path: Optional[list] = None) -> _Node:
        node = self._root
        while not node.leaf:
            i = bisect.bisect_right(node.keys, key)
            if path is not None:
                path.append((node, i))
            node = node.children[i]
        return node

    def _split_child(self, parent: _Node, i: int) -> None:
        child = parent.children[i]
        mid = len(child.keys) // 2
        right = _Node(leaf=child.leaf)
        if child.leaf:
            right.keys = child.keys[mid:]
            right.values = child.values[mid:]
            child.keys = child.keys[:mid]
            child.values = child.values[:mid]
            sep = right.keys[0]
        else:
            sep = child.keys[mid]
            right.keys = child.keys[mid + 1 :]
            right.children = child.children[mid + 1 :]
            child.keys = child.keys[:mid]
            child.children = child.children[: mid + 1]
        parent.keys.insert(i, sep)
        parent.children.insert(i + 1, right)

    # ----------------------------------------------------------- mapping API

    def __setitem__(self, key: int, value) -> None:
        root = self._root
        if len(root.keys) >= ORDER:
            new_root = _Node(leaf=False)
            new_root.children = [root]
            self._split_child(new_root, 0)
            self._root = new_root
        node = self._root
        while True:
            if node.leaf:
                i = bisect.bisect_left(node.keys, key)
                if i < len(node.keys) and node.keys[i] == key:
                    node.values[i] = value
                else:
                    node.keys.insert(i, key)
                    node.values.insert(i, value)
                    self._len += 1
                return
            i = bisect.bisect_right(node.keys, key)
            if len(node.children[i].keys) >= ORDER:
                self._split_child(node, i)
                if key >= node.keys[i]:
                    i += 1
            node = node.children[i]

    def __getitem__(self, key: int):
        node = self._find_leaf(key)
        i = bisect.bisect_left(node.keys, key)
        if i < len(node.keys) and node.keys[i] == key:
            return node.values[i]
        raise KeyError(key)

    def __delitem__(self, key: int) -> None:
        # Lazy deletion: remove from leaf; underflow merging is skipped
        # (containers churn is modest and keys re-fill; same trade the
        # reference's btree makes with lazy rebalancing thresholds).
        node = self._find_leaf(key)
        i = bisect.bisect_left(node.keys, key)
        if i < len(node.keys) and node.keys[i] == key:
            node.keys.pop(i)
            node.values.pop(i)
            self._len -= 1
            return
        raise KeyError(key)

    def __len__(self) -> int:
        return self._len

    def __iter__(self) -> Iterator[int]:
        yield from self._iter_node(self._root)

    def _iter_node(self, node: _Node) -> Iterator[int]:
        if node.leaf:
            yield from node.keys
            return
        for i, child in enumerate(node.children):
            yield from self._iter_node(child)

    def __contains__(self, key) -> bool:
        node = self._find_leaf(key)
        i = bisect.bisect_left(node.keys, key)
        return i < len(node.keys) and node.keys[i] == key

    # ------------------------------------------------------- roaring extras

    def last(self):
        """Highest (key, container) — reference Containers.Last()."""
        node = self._root
        while not node.leaf:
            node = node.children[-1]
        while not node.keys:
            raise KeyError("empty")
        return node.keys[-1], node.values[-1]

    def iterate_from(self, key: int):
        """In-order (key, value) pairs starting at the first key >= key."""
        for k in self:
            if k >= key:
                yield k, self[k]
