"""Token-sequence radix tree (prefix index for RTC and the JE global
prompt trees — §5.2's ``select_tes_prefix_match`` shares this structure).

Each edge is labeled with a token run; each node stores an opaque payload
(page run for RTC, TE ids for the global tree) plus LRU metadata.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_counter = itertools.count()


@dataclass
class RadixNode:
    key: Tuple[int, ...] = ()               # edge label from parent
    children: Dict[int, "RadixNode"] = field(default_factory=dict)
    payload: Any = None
    last_access: float = 0.0
    node_id: int = field(default_factory=lambda: next(_counter))
    parent: Optional["RadixNode"] = None

    def touch(self) -> None:
        self.last_access = time.monotonic()


def _common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixTree:
    def __init__(self):
        self.root = RadixNode()

    def insert(self, tokens, payload: Any) -> RadixNode:
        """Insert `tokens`, splitting edges as needed; sets payload on the
        terminal node and returns it."""
        node = self.root
        tokens = tuple(tokens)
        while tokens:
            head = tokens[0]
            child = node.children.get(head)
            if child is None:
                new = RadixNode(key=tokens, parent=node)
                node.children[head] = new
                new.payload = payload
                new.touch()
                return new
            cp = _common_prefix(child.key, tokens)
            if cp == len(child.key):
                node = child
                node.touch()
                tokens = tokens[cp:]
                continue
            # split the edge
            mid = RadixNode(key=child.key[:cp], parent=node)
            child.key = child.key[cp:]
            child.parent = mid
            mid.children[child.key[0]] = child
            node.children[head] = mid
            mid.touch()
            node = mid
            tokens = tokens[cp:]
        node.payload = payload if tokens == () or node.payload is None else node.payload
        node.payload = payload
        node.touch()
        return node

    def match_prefix(self, tokens) -> Tuple[int, List[RadixNode]]:
        """Longest-prefix match, counting partial-edge matches. Returns
        (#matched tokens, node path). On a partial edge the edge's child is
        appended to the path: every payload in its subtree shares the first
        `matched` tokens with the query, so a caller can reuse that many
        tokens of any descendant entry (SGLang-style partial reuse)."""
        node = self.root
        tokens = tuple(tokens)
        matched = 0
        path: List[RadixNode] = []
        while tokens:
            child = node.children.get(tokens[0])
            if child is None:
                break
            cp = _common_prefix(child.key, tokens)
            matched += cp
            if cp < len(child.key):
                child.touch()
                path.append(child)
                break
            tokens = tokens[cp:]
            node = child
            node.touch()
            path.append(node)
        return matched, path

    def any_payload(self, node: RadixNode):
        """Any payload in `node`'s subtree (shallowest-first)."""
        stack = [node]
        while stack:
            n = stack.pop(0)
            if n.payload is not None:
                return n.payload
            stack.extend(n.children.values())
        return None

    def remove(self, node: RadixNode) -> None:
        """Remove a leaf node (payload eviction). Inner nodes keep structure."""
        if node.children or node.parent is None:
            node.payload = None
            return
        parent = node.parent
        parent.children.pop(node.key[0], None)
        # merge a now-single-child pass-through parent with its child
        if (parent.parent is not None and parent.payload is None
                and len(parent.children) == 1):
            (only,) = parent.children.values()
            only.key = parent.key + only.key
            only.parent = parent.parent
            parent.parent.children[parent.key[0]] = only

    def leaves_by_lru(self) -> List[RadixNode]:
        out: List[RadixNode] = []

        def walk(n: RadixNode):
            if not n.children and n.payload is not None:
                out.append(n)
            for c in n.children.values():
                walk(c)

        walk(self.root)
        out.sort(key=lambda n: n.last_access)
        return out

    def size(self) -> int:
        count = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            count += 1
            stack.extend(n.children.values())
        return count - 1  # exclude root
