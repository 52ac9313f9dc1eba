"""Port parity: the Coconut-Trie (paper Sec. 4.2, prefix splits) and the
iSAX top-down baseline, PyTorch port vs the JAX reference.

The port's trie is built over the port's own sorted key column (int64-held
32-bit words, a tensor), the reference's over the same words as uint32.
Both packages' iSAX indexes take the same SAX codes.  Tolerances: trie
leaves (start, end, depth), internal node counts, fill factors, iSAX
leaves, entries and IOStats exact; ``node_mindist_sq`` at rtol 1e-6
(float32 region bounds summed in float64 in both).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import summarization as RS
from repro.core import trie as RTrie
from repro.core.metrics import IOStats as RIOStats
from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.core import CoconutTrie, ISaxIndex, build_trie
from repro_torch.core import tree as T
from repro_torch.core.metrics import IOStats

N = 3000
RCFG = RS.SummaryConfig(CFG.series_len, CFG.segments, CFG.bits)


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def tree():
    raw = _walks(np.random.default_rng(3), N, CFG.series_len)
    return T.build(raw, CFG, leaf_size=64, device="cpu")


def _leaves(trie):
    return [(lf.start, lf.end, lf.depth) for lf in trie.leaves]


@pytest.mark.parametrize("leaf_size", [16, 64, 200])
def test_build_trie_equals_reference(tree, leaf_size):
    kw = dict(w=CFG.segments, b=CFG.bits, leaf_size=leaf_size)
    pio, rio = IOStats(leaf_size), RIOStats(leaf_size)
    got = build_trie(tree.keys, io=pio, **kw)
    want = RTrie.build_trie(tree.keys.numpy().astype(np.uint32), io=rio,
                            **kw)
    assert isinstance(got, CoconutTrie)
    assert _leaves(got) == _leaves(want)
    assert got.internal_nodes == want.internal_nodes
    assert got.n_leaves == want.n_leaves and got.n == want.n == N
    assert got.fill == want.fill
    assert dict(pio.counters) == dict(rio.counters) == {
        "seq_read_blocks": -(-N // leaf_size),
        "seq_write_blocks": -(-N // leaf_size)}
    # host words, uint32 or int64-held, give the same trie
    for keys in (tree.keys.numpy(), tree.keys.numpy().astype(np.uint32)):
        assert _leaves(build_trie(keys, **kw)) == _leaves(got)


def test_trie_leaves_are_prefix_groups(tree):
    """Leaves tile [0, N) contiguously, hold at most a leaf of rows, and
    every leaf's rows share its top ``depth`` interleaved bits; prefix
    splitting leaves them sparser than the tree's median split."""
    trie = build_trie(tree.keys, w=CFG.segments, b=CFG.bits, leaf_size=64)
    keys = tree.keys.numpy()
    bits = ((keys[:, :, None] >> np.arange(31, -1, -1)) & 1).reshape(N, -1)
    assert trie.leaves[0].start == 0 and trie.leaves[-1].end == N
    for a, b in zip(trie.leaves, trie.leaves[1:]):
        assert a.end == b.start
    for lf in trie.leaves:
        assert 0 < lf.count <= 64
        grp = bits[lf.start:lf.end, :lf.depth]
        assert (grp == grp[0]).all()
    assert trie.fill < 0.95 < tree.n / (tree.n_leaves * tree.leaf_size)


@pytest.mark.parametrize("leaf_size", [16, 64])
def test_isax_equals_reference(tree, leaf_size):
    codes = tree.codes.numpy()[np.argsort(tree.offsets.numpy())]
    port = ISaxIndex(CFG, leaf_size=leaf_size)
    ref = RTrie.ISaxIndex(RCFG, leaf_size=leaf_size)
    port.bulk_insert(codes)
    ref.bulk_insert(codes)
    assert port.n == ref.n == N
    assert port.n_leaves == ref.n_leaves and port.fill == ref.fill

    def shape(idx):
        return sorted((tuple(lf.prefix), tuple(lf.plen), tuple(lf.entries))
                      for lf in idx.leaves())
    assert shape(port) == shape(ref)
    assert dict(port.io.counters) == dict(ref.io.counters)
    assert port.io.random_blocks >= 2 * N       # O(1) random I/O an insert
    assert port.fill < 0.9
    assert sum(len(lf.entries) for lf in port.leaves()) == N


def test_isax_node_mindist_equals_reference_and_bounds(tree):
    raw = tree.raw.numpy()
    order = np.argsort(tree.offsets.numpy())
    codes, paas = tree.codes.numpy()[order], tree.paas.numpy()[order]
    port = ISaxIndex(CFG, leaf_size=64)
    ref = RTrie.ISaxIndex(RCFG, leaf_size=64)
    port.bulk_insert(codes)
    ref.bulk_insert(codes)
    rng = np.random.default_rng(5)
    qi = rng.integers(0, N, 4)
    x = raw[order]
    pleaves = sorted(port.leaves(), key=lambda lf: tuple(lf.entries))
    rleaves = sorted(ref.leaves(), key=lambda lf: tuple(lf.entries))
    for i in qi:
        q_paa = paas[i] + 0.05
        for pl, rl in zip(pleaves, rleaves):
            got = port.node_mindist_sq(q_paa, pl)
            np.testing.assert_allclose(got, ref.node_mindist_sq(q_paa, rl),
                                       rtol=1e-6)
            if pl.entries:                   # a lower bound of the node
                q = x[i] + 0.05
                ed = ((x[pl.entries] - q) ** 2).sum(1).min()
                assert got <= ed * (1 + 1e-5) + 1e-5
