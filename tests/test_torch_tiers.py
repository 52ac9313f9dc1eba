"""Port parity: the tiered leaf store and its caches, PyTorch port vs the
JAX reference.

The first seven cases of ``tests/test_tiers.py`` (clock cache, result
cache, tiered store) run the same operations on both packages' objects;
every observable (membership, eviction order, counters, stats) must be
equal, and must equal the values those reference tests pin.  A promoted
block is a ``jax.Array`` in the reference and a torch tensor on the asking
partition's device in the port (the CPU here).  Finally a tiered segment
search must answer bit for bit like the untiered one.  No tolerances: the
caches are exact bookkeeping.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.storage.cache import ClockCache as RClockCache
from repro.storage.cache import QueryResultCache as RQueryResultCache
from repro.storage.tiers import TieredLeafStore as RTieredLeafStore
from repro_torch.configs import SMOKE_INDEX
from repro_torch.core import tree as T
from repro_torch.core.metrics import IOStats
from repro_torch.query import Partition, exact_knn
from repro_torch.storage import (ClockCache, QueryResultCache,
                                 TieredLeafStore, exact_search_mmap,
                                 write_segment)
from repro_torch.storage.segment import Segment

IMPLS = {"reference": (RClockCache, RQueryResultCache, RTieredLeafStore),
         "port": (ClockCache, QueryResultCache, TieredLeafStore)}


def _blk(nbytes, fill=1):
    return np.full(nbytes, fill, np.uint8)


def _both(scenario):
    """Run ``scenario(classes)`` on both packages; return both traces."""
    return {name: scenario(*cls) for name, cls in IMPLS.items()}


def _clock_budget(Clock, _r, _t):
    evicted = []
    c = Clock(300, on_evict=lambda k, e: evicted.append(k))
    for i in range(3):
        c.put(("s", i), _blk(100), 100)
    trace = [len(c), c.resident_bytes]
    c.put(("s", 3), _blk(100), 100)
    trace += [("s", 0) in c, list(evicted)]
    trace.append(c.get(("s", 2)) is not None)
    c.put(("s", 4), _blk(100), 100)
    trace += [list(evicted), ("s", 2) in c, c.resident_bytes, c.evictions]
    c.put(("s", 4), _blk(100, fill=7), 100)
    trace += [c.resident_bytes, int(c.get(("s", 4)).value[0])]
    return trace


def test_clock_cache_budget_and_second_chance():
    got = _both(_clock_budget)
    assert got["port"] == got["reference"] == [
        3, 300, False, [("s", 0)], True, [("s", 0), ("s", 1)], True, 300, 2,
        300, 7]


def _clock_oversized(Clock, _r, _t):
    c = Clock(100)
    trace = [c.put(("s", 0), _blk(101), 101) is None]
    ent = c.put(("s", 1), _blk(10), 10)
    trace.append(ent.touches)
    for _ in range(3):
        c.get(("s", 1))
    trace.append(c.get(("s", 1)).touches)
    return trace


def test_clock_cache_refuses_oversized_and_counts_touches():
    got = _both(_clock_oversized)
    assert got["port"] == got["reference"] == [True, 1, 5]


def _clock_groups(Clock, _r, _t):
    evicted = []
    c = Clock(1 << 20, on_evict=lambda k, e: evicted.append(k))
    for seg in ("a", "b"):
        for li in range(4):
            c.put((seg, "codes", li), _blk(8), 8)
    trace = [c.invalidate_group("a"), len(c), sorted(evicted),
             ("b", "codes", 0) in c, c.invalidate_group("a")]
    c.clear()
    return trace + [len(c), c.resident_bytes]


def test_clock_cache_group_invalidation():
    got = _both(_clock_groups)
    assert got["port"] == got["reference"]
    assert got["port"][:2] == [4, 4] and got["port"][3:] == [True, 0, 0, 0]
    assert all(k[0] == "a" for k in got["port"][2])


def _result_lru(_c, Result, _t):
    rc = Result(max_entries=2)
    rc.put(("a",), 1)
    rc.put(("b",), 2)
    trace = [rc.get(("a",))]
    rc.put(("c",), 3)
    trace += [rc.get(("b",)), rc.get(("a",)), rc.get(("c",)), rc.hits,
              rc.misses, len(rc)]
    return trace


def test_query_result_cache_lru_bound():
    got = _both(_result_lru)
    assert got["port"] == got["reference"] == [1, None, 1, 3, 3, 1, 2]


def _store_hits(_c, _r, Tiered):
    t = Tiered(1 << 20)
    trace = [t.get("seg1", "codes", 0, stored_nbytes=64) is None]
    t.admit("seg1", "codes", 0, _blk(256), stored_nbytes=64)
    blk = t.get("seg1", "codes", 0, stored_nbytes=64)
    st = t.stats()
    trace += [int(blk.nbytes), t.hits, t.misses, t.bytes_saved,
              st["hit_rate"], st["entries"], st["resident_bytes"]]
    t.invalidate("seg1")
    return trace + [t.get("seg1", "codes", 0, stored_nbytes=64) is None]


def test_tiered_store_hit_miss_and_bytes_saved():
    got = _both(_store_hits)
    assert got["port"] == got["reference"] == [True, 256, 1, 1, 64, 0.5, 1,
                                               256, True]


def _store_promotes(_c, _r, Tiered, device_type):
    kw = {} if device_type is None else {"device": "cpu"}
    t = Tiered(1 << 20, device_capacity_bytes=300, promote_touches=2)
    t.admit("seg1", "codes", 0, _blk(256), stored_nbytes=256)
    t.admit("seg1", "codes", 1, _blk(256), stored_nbytes=256)
    t.admit("seg1", "keys", 0, _blk(256), stored_nbytes=256)
    t.get("seg1", "codes", 0, 256, **kw)
    blk = t.get("seg1", "codes", 0, 256, **kw)
    trace = [isinstance(blk, device_type or jnp.ndarray), t.promotions,
             t.device_bytes]
    t.get("seg1", "codes", 1, 256, **kw)
    blk2 = t.get("seg1", "codes", 1, 256, **kw)
    trace += [isinstance(blk2, np.ndarray), t.promotions, t.device_bytes]
    for _ in range(5):
        t.get("seg1", "keys", 0, 256, **kw)
    trace.append(isinstance(t.get("seg1", "keys", 0, 256, **kw), np.ndarray))
    t.invalidate("seg1")
    return trace + [t.device_bytes, t.stats()["entries"],
                    np.asarray(blk).tolist() == [1] * 256]


def test_tiered_store_promotes_hot_code_blocks_within_budget():
    ref = _store_promotes(*IMPLS["reference"], None)
    port = _store_promotes(*IMPLS["port"], torch.Tensor)
    assert port == ref == [True, 1, 256, True, 1, 256, True, 0, 0, True]


def _store_clear(_c, _r, Tiered):
    t = Tiered(1 << 20)
    t.admit("seg1", "codes", 0, _blk(64), 64)
    t.result_put(("k",), (1, 2, {}))
    trace = [t.result_get(("k",)) is not None]
    t.clear()
    return trace + [t.get("seg1", "codes", 0, 64) is None,
                    t.result_get(("k",)) is None]


def test_tiered_store_clear_resets_both_caches():
    got = _both(_store_clear)
    assert got["port"] == got["reference"] == [True, True, True]


# ------------------------------------------------ tiered == untiered search

def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def segment(tmp_path_factory):
    rng = np.random.default_rng(5)
    x = _walks(rng, 1500, SMOKE_INDEX.series_len)
    q = _walks(rng, 8, SMOKE_INDEX.series_len)
    q[::2] = x[:4] + 0.1 * rng.standard_normal(
        (4, SMOKE_INDEX.series_len)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("tiers") / "seg.coco")
    write_segment(path, T.build(x, SMOKE_INDEX, leaf_size=64, device="cpu"))
    return Segment.open(path), q


@pytest.mark.parametrize("promote_touches", [1, 4])
def test_tiered_segment_search_bitwise_equals_untiered(segment,
                                                       promote_touches):
    seg, q = segment
    want_d, want_o, want_st = exact_search_mmap(seg, q, k=5, device="cpu")
    tiers = TieredLeafStore(1 << 20, device_capacity_bytes=1 << 16,
                            promote_touches=promote_touches)
    part = Partition.from_segment(seg, tiers=tiers, device="cpu")
    for rnd in range(4):
        io = IOStats()
        d, o, st = exact_knn([part], q, seg.cfg, k=5, io=io)
        np.testing.assert_array_equal(o, want_o)
        np.testing.assert_array_equal(d.view(np.uint32), want_d.view(np.uint32))
        assert st.leaves_scanned == want_st.leaves_scanned
        if rnd:       # every block is cached after the first round
            assert io.bytes_read == st.candidates * seg.cfg.series_len * 4 \
                + len(q) * 2 * seg.leaf_size * seg.cfg.series_len * 4
    assert tiers.hits > 0 and tiers.bytes_saved > 0
    assert tiers.promotions > 0
    assert 0 < tiers.device_bytes <= 1 << 16
