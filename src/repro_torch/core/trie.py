"""Coconut-Trie (Sec. 4.2) and the iSAX 2.0-style top-down baseline (Sec. 3).

Coconut-Trie bulk-loads a *prefix-split* index bottom-up over z-order-sorted
summarizations: because the data is sorted on the interleaved key, every
prefix-group is a contiguous range, so the trie is built in one linear pass
(the paper's insertBottomUp + CompactSubtree collapse into a recursive range
split that stops as soon as a range fits a leaf).  It isolates the effect of
*contiguity* without median splits: leaves are contiguous but sparsely filled.

The iSAX top-down baseline reproduces the state of the art the paper compares
against: entry-at-a-time inserts through the root, prefix-bit node splits
("segment whose next unprefixed bit divides the resident series most"),
random-I/O accounting per the paper's cost model.  It is the *unsortable
summarization* strawman: identical pruning power, dreadful build cost and
leaf occupancy.

Both are host structures, as in the reference.  :func:`build_trie` takes
the tree's key column where it lives (the port holds key words as int64
in ``[0, 2**32)``, on the card by default), copies it to the host once
and runs the range split in numpy: every node's split reads one bit
column of its range, which on the card would cost a host sync a node.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import summarization as S
from .metrics import IOStats, fill_factor

__all__ = ["CoconutTrie", "build_trie", "ISaxIndex"]


@dataclasses.dataclass
class TrieLeaf:
    start: int        # range in the sorted arrays
    end: int
    depth: int        # number of interleaved prefix bits fixed

    @property
    def count(self) -> int:
        return self.end - self.start


@dataclasses.dataclass
class CoconutTrie:
    """Prefix-split index over z-order sorted data (host-side structure;
    the payloads live in the backing CoconutTree's columns)."""
    leaves: List[TrieLeaf]
    n: int
    leaf_size: int
    internal_nodes: int

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)

    @property
    def fill(self) -> float:
        return fill_factor([l.count for l in self.leaves], self.leaf_size)


def build_trie(sorted_keys: np.ndarray, *, w: int, b: int,
               leaf_size: int = 256,
               io: Optional[IOStats] = None) -> CoconutTrie:
    """Bottom-up prefix-split build over sorted z-order keys (Algorithm 2).

    ``sorted_keys``: ``[N, n_words]`` key words sorted ascending — a
    tensor on any device (copied to the host once) or a host array, uint32
    or int64-held words.  A node at
    ``depth`` owns a contiguous range sharing the top ``depth`` interleaved
    bits; it becomes a leaf iff its range fits ``leaf_size`` (CompactSubtree's
    fixed point), else it splits on the next interleaved bit — which is, by
    construction, "the segment whose next unprefixed bit divides most" in
    round-robin z-order.
    """
    if isinstance(sorted_keys, torch.Tensor):
        sorted_keys = sorted_keys.detach().cpu().numpy()
    keys = np.asarray(sorted_keys)
    n = keys.shape[0]
    total_bits = w * b
    leaves: List[TrieLeaf] = []
    internal = 0

    def bit_at(rows: np.ndarray, depth: int) -> np.ndarray:
        word, bit = divmod(depth, 32)
        return (keys[rows[0]:rows[1], word] >> np.uint32(31 - bit)) & 1

    stack: List[Tuple[int, int, int]] = [(0, n, 0)]
    while stack:
        s, e, d = stack.pop()
        if e - s <= leaf_size or d >= total_bits:
            if e > s:
                leaves.append(TrieLeaf(s, e, d))
            continue
        internal += 1
        bits = bit_at((s, e), d)
        # sorted order => all zeros precede all ones at this depth
        split = s + int(np.searchsorted(bits, 1))
        stack.append((split, e, d + 1))
        stack.append((s, split, d + 1))
    leaves.sort(key=lambda l: l.start)
    if io is not None:
        io.seq_read(n)    # one pass to emit leaves
        io.seq_write(n)
    return CoconutTrie(leaves=leaves, n=n, leaf_size=leaf_size,
                       internal_nodes=internal)


# ---------------------------------------------------------------------------
# iSAX 2.0-style top-down baseline (the paper's point of comparison)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Node:
    prefix: np.ndarray         # [w] uint8 code prefix values
    plen: np.ndarray           # [w] uint8 number of fixed bits per segment
    entries: List[int]         # indices into the dataset (leaf only)
    children: Optional[Dict[int, "_Node"]] = None
    split_seg: int = -1

    @property
    def is_leaf(self) -> bool:
        return self.children is None


class ISaxIndex:
    """Entry-at-a-time iSAX index with prefix-bit splits + I/O accounting.

    Models the paper's "current approach" (Sec. 3.1): each insert costs O(1)
    random I/O; splits rewrite two leaves; leaves end up sparsely populated
    because only common-prefix series may cohabit (Sec. 3.2).
    """

    def __init__(self, cfg: S.SummaryConfig, leaf_size: int = 256,
                 io: Optional[IOStats] = None):
        self.cfg = cfg
        self.leaf_size = leaf_size
        self.io = io if io is not None else IOStats(leaf_size)
        w = cfg.segments
        self.root = _Node(prefix=np.zeros(w, np.uint8),
                          plen=np.zeros(w, np.uint8),
                          entries=[], children={})
        self.codes: List[np.ndarray] = []   # per-entry SAX words
        self.n = 0

    # -- helpers -------------------------------------------------------------
    def _child_key(self, node: _Node, code: np.ndarray) -> int:
        """First-level children are keyed by the top bit of every segment;
        deeper nodes by the next bit of the split segment."""
        b = self.cfg.bits
        if node is self.root:
            bits = (code.astype(np.int64) >> (b - 1)) & 1
            return int(bits @ (1 << np.arange(len(code), dtype=np.int64)))
        seg = node.split_seg
        depth = int(node.plen[seg])
        return int((code[seg] >> (b - 1 - depth)) & 1)

    def _descend(self, code: np.ndarray) -> _Node:
        node = self.root
        while not node.is_leaf:
            key = self._child_key(node, code)
            nxt = node.children.get(key)
            if nxt is None:
                nxt = self._make_child(node, code, key)
            node = nxt
        return node

    def _make_child(self, node: _Node, code: np.ndarray, key: int) -> _Node:
        b = self.cfg.bits
        prefix = node.prefix.copy()
        plen = node.plen.copy()
        if node is self.root:
            for seg in range(self.cfg.segments):
                plen[seg] = 1
                top = (code[seg] >> (b - 1)) & 1
                prefix[seg] = top << (b - 1)
        else:
            seg = node.split_seg
            d = int(node.plen[seg])
            plen[seg] = d + 1
            bit = (code[seg] >> (b - 1 - d)) & 1
            prefix[seg] = prefix[seg] | (bit << (b - 1 - d))
        child = _Node(prefix=prefix, plen=plen, entries=[])
        node.children[key] = child
        return child

    def _split(self, leaf: _Node) -> None:
        """Split on the segment whose next unprefixed bit divides most."""
        b = self.cfg.bits
        codes = np.stack([self.codes[i] for i in leaf.entries])
        best_seg, best_balance = -1, -1.0
        for seg in range(self.cfg.segments):
            d = int(leaf.plen[seg])
            if d >= b:
                continue
            bits = (codes[:, seg] >> (b - 1 - d)) & 1
            ones = int(bits.sum())
            balance = min(ones, len(bits) - ones)
            if balance > best_balance:
                best_balance, best_seg = balance, seg
        if best_seg < 0:      # cannot split further: oversized leaf
            return
        leaf.split_seg = best_seg
        leaf.children = {}
        entries, leaf.entries = leaf.entries, []
        self.io.rand_write(2)          # two new leaves written
        for idx in entries:
            child = self._descend_from(leaf, self.codes[idx])
            child.entries.append(idx)
        for child in leaf.children.values():
            if child.is_leaf and len(child.entries) > self.leaf_size:
                self._split(child)

    def _descend_from(self, node: _Node, code: np.ndarray) -> _Node:
        while not node.is_leaf:
            key = self._child_key(node, code)
            nxt = node.children.get(key)
            if nxt is None:
                nxt = self._make_child(node, code, key)
            node = nxt
        return node

    # -- public API -----------------------------------------------------------
    def insert(self, code: np.ndarray) -> int:
        """Insert one SAX word; returns entry id.  O(1) random I/O (paper)."""
        idx = self.n
        self.codes.append(np.asarray(code, np.uint8))
        self.n += 1
        leaf = self._descend(self.codes[idx])
        leaf.entries.append(idx)
        self.io.rand_read(1)     # read target leaf
        self.io.rand_write(1)    # rewrite it
        if len(leaf.entries) > self.leaf_size:
            self._split(leaf)
        return idx

    def bulk_insert(self, codes: np.ndarray) -> None:
        for row in np.asarray(codes, np.uint8):
            self.insert(row)

    def leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            if node.is_leaf:
                out.append(node)
            else:
                stack.extend(node.children.values())
        return out

    @property
    def fill(self) -> float:
        sizes = [len(l.entries) for l in self.leaves() if len(l.entries)]
        return fill_factor(sizes, self.leaf_size)

    @property
    def n_leaves(self) -> int:
        return sum(1 for l in self.leaves() if len(l.entries))

    # -- node-level lower bound (for query comparisons) ----------------------
    def node_mindist_sq(self, q_paa: np.ndarray, node: _Node) -> float:
        """iSAX node mindist from per-segment prefix regions."""
        b = self.cfg.bits
        lower, upper = (x.numpy() for x in S.region_bounds(b, device="cpu"))
        d = 0.0
        for seg in range(self.cfg.segments):
            dseg = int(node.plen[seg])
            if dseg == 0:
                continue
            lo_code = int(node.prefix[seg])
            hi_code = lo_code | ((1 << (b - dseg)) - 1)
            lb, ub = lower[lo_code], upper[hi_code]
            v = float(q_paa[seg])
            if v < lb:
                d += (lb - v) ** 2
            elif v > ub:
                d += (v - ub) ** 2
        return d * (self.cfg.series_len / self.cfg.segments)
