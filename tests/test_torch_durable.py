"""Port parity: the durable Coconut-LSM — write-ahead log, segment store,
``CoconutLSM.open``/``checkpoint``, tiers over committed segments —
PyTorch (CPU twins) vs the JAX reference.

Both packages get the same numpy batches (the smoke config: L=64, w=8,
b=4, leaf 64; 1,200 random walks).  Tolerances: WAL files, records,
``MANIFEST.json`` and ``SHARDS.json`` byte for byte; run structure, clock,
row counts, replayed arrays, answer ids, recovery reports and counters
exact; answer distances across packages at rtol 1e-6 with atol 1e-6
(float32 sums ordered differently by XLA and torch); within the port,
reopened == before the crash and tiered == untiered bit for bit; against
a float64 numpy brute force, distances at rtol 1e-5.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsm as RL
from repro.core import summarization as RS
from repro.core import tree as RT
from repro.ingest import wal as RW
from repro.storage import store as RStore
from repro.storage.tiers import TieredLeafStore as RTiers
from repro_torch.configs import SMOKE_INDEX as CFG
from repro_torch.configs import SMOKE_LEAF as LEAF
from repro_torch.core import tree as T
from repro_torch.core.lsm import CoconutLSM
from repro_torch.core.windows import window_engine
from repro_torch.ingest import FSYNC_POLICIES, WALCorruptionError
from repro_torch.ingest import wal as PW
from repro_torch.obs import get_registry
from repro_torch.storage import (Segment, SegmentStore, ShardDirectory,
                                 TieredLeafStore, write_segment)
from repro_torch.storage import store as PStore

N = 1200
NQ = 5
L = CFG.series_len
RCFG = RS.SummaryConfig(CFG.series_len, CFG.segments, CFG.bits)
TOL = dict(rtol=1e-6, atol=1e-6)
PKGS = {"port": (CoconutLSM, SegmentStore), "ref": (RL.CoconutLSM,
                                                    RStore.SegmentStore)}


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    raw = _walks(rng, N, L)
    q = _walks(rng, NQ, L)
    q[::2] = raw[rng.integers(0, N, (NQ + 1) // 2)] + 0.1 * \
        rng.standard_normal(((NQ + 1) // 2, L)).astype(np.float32)
    return raw, q


def _batches(raw, size):
    for s in range(0, len(raw), size):
        yield raw[s: s + size]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _engine(pkg, root, **kw):
    """A durable engine of either package over a fresh store at ``root``."""
    cls, store_cls = PKGS[pkg]
    kw.setdefault("leaf_size", LEAF)
    if pkg == "port":
        return cls(CFG, store=store_cls(root), device="cpu", **kw)
    return cls(RCFG, store=store_cls(root), **kw)


def _open(pkg, root, **kw):
    if pkg == "port":
        return CoconutLSM.open(root, device="cpu", **kw)
    return RL.CoconutLSM.open(root, **kw)


def _structure(eng):
    return ([(r.n, r.level, r.t_min, r.t_max) for r in eng.runs],
            eng.merges, eng._buf_count, eng.clock, eng.n)


def _brute(q, rows, k):
    d = ((rows[None].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, 1), idx


def _same(p, r):
    np.testing.assert_array_equal(p[1], r[1])
    np.testing.assert_allclose(p[0], r[0], **TOL)


def _stream(eng, raw, size=100):
    for b in _batches(raw, size):
        eng.insert(b)


def _files(root):
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}


# ------------------------------------------------------------ WAL records

@pytest.mark.parametrize("with_ids", [False, True])
def test_wal_record_bytes_equal_reference(data, with_ids):
    raw, _ = data
    ts = np.arange(40, 77, dtype=np.int64)
    ids = np.arange(1000, 1037, dtype=np.int64) if with_ids else None
    rec = PW.WriteAheadLog._encode(40, raw[40:77], ts, ids)
    assert rec == RW.WriteAheadLog._encode(40, raw[40:77], ts, ids)
    # a batch handed over as a tensor is copied to the host first
    assert rec == PW.WriteAheadLog._encode(
        40, torch.from_numpy(raw[40:77]), torch.from_numpy(ts),
        None if ids is None else torch.from_numpy(ids))


@pytest.mark.parametrize("fsync", FSYNC_POLICIES)
def test_wal_files_byte_identical(tmp_path, data, fsync):
    raw, _ = data
    for pkg, mod in (("port", PW), ("ref", RW)):
        root = str(tmp_path / pkg)
        os.makedirs(root)
        wal = mod.WriteAheadLog(root, fsync=fsync)
        wal.append(raw[:100], np.arange(100, dtype=np.int64), 0)
        wal.append(raw[100:130], np.arange(100, 130, dtype=np.int64), 100,
                   ids=np.arange(500, 530, dtype=np.int64))
        wal.rotate([(120, raw[120:130], np.arange(120, 130, dtype=np.int64),
                     np.arange(520, 530, dtype=np.int64))])
        wal.append(raw[130:150], np.arange(130, 150, dtype=np.int64), 130)
        wal.close()
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "ref"))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_wal_replays_across_packages(tmp_path, data, writer):
    """Each package replays the other's log: the same arrays, and the same
    skip of a committed prefix in the middle of a record."""
    raw, _ = data
    root = str(tmp_path)
    w_mod, r_mod = (PW, RW) if writer == "port" else (RW, PW)
    wal = w_mod.WriteAheadLog(root, fsync="always")
    wal.append(raw[:100], np.arange(100, dtype=np.int64), 0)
    wal.append(raw[100:250], np.arange(100, 250, dtype=np.int64), 100,
               ids=np.arange(7, 157, dtype=np.int64))
    wal.close()
    for start in (0, 130):
        got = r_mod.WriteAheadLog.replay(root, start)
        want = w_mod.WriteAheadLog.replay(root, start)
        assert len(got) == len(want)
        for (gr, gt, gi), (wr, wt, wi) in zip(got, want):
            np.testing.assert_array_equal(gr, wr)
            np.testing.assert_array_equal(gt, wt)
            assert (gi is None) == (wi is None)
            if gi is not None:
                np.testing.assert_array_equal(gi, wi)
    got = PW.WriteAheadLog.replay(root, 130)
    np.testing.assert_array_equal(got[0][0], raw[130:250])
    np.testing.assert_array_equal(got[0][2], np.arange(37, 157))


def test_wal_torn_tail_discarded_gap_raises(tmp_path, data):
    raw, _ = data
    root = str(tmp_path)
    wal = PW.WriteAheadLog(root, fsync="always")
    wal.append(raw[:64], np.arange(64, dtype=np.int64), 0)
    wal.close()
    with open(wal.active_path, "ab") as f:
        f.write(b"\x01\x02torn-half-record")     # interrupted append
    got = PW.WriteAheadLog.replay(root, 0)
    assert sum(len(r) for r, *_ in got) == 64
    assert sum(len(r) for r, *_ in RW.WriteAheadLog.replay(root, 0)) == 64
    with pytest.raises(WALCorruptionError, match="gap"):
        PW.WriteAheadLog.replay(root, -10)


def test_wal_bad_record_before_the_newest_file_raises(tmp_path, data):
    """A torn record is forgiven only at the tail of the newest file."""
    raw, _ = data
    root = str(tmp_path)
    wal = PW.WriteAheadLog(root, fsync="never")
    wal.append(raw[:64], np.arange(64, dtype=np.int64), 0)
    wal.close()
    with open(wal.active_path, "ab") as f:
        f.write(b"\x01\x02torn-half-record")
    newer = PW.WriteAheadLog(root, fsync="never")   # a later file
    newer.append(raw[64:80], np.arange(64, 80, dtype=np.int64), 64)
    newer.close()
    with pytest.raises(WALCorruptionError, match="corrupt record"):
        PW.WriteAheadLog.replay(root, 0)
    with pytest.raises(RW.WALCorruptionError, match="corrupt record"):
        RW.WriteAheadLog.replay(root, 0)


def test_wal_rotation_supersedes(tmp_path, data):
    raw, _ = data
    root = str(tmp_path)
    wal = PW.WriteAheadLog(root, fsync="commit")
    wal.append(raw[:300], np.arange(300, dtype=np.int64), 0)
    first = wal.active_path
    wal.rotate([(256, raw[256:300], np.arange(256, 300, dtype=np.int64),
                 None)])
    wal.close()
    logs = [f for f in os.listdir(root) if f.startswith("wal-")]
    assert logs == [os.path.basename(wal.active_path)]
    assert not os.path.exists(first)
    got = PW.WriteAheadLog.replay(root, 256)
    assert sum(len(r) for r, *_ in got) == 44
    np.testing.assert_array_equal(got[0][0], raw[256:300])
    assert PW.WriteAheadLog.wal_bytes(root) == os.path.getsize(
        wal.active_path)


@pytest.mark.parametrize("fsync", FSYNC_POLICIES)
def test_fsync_policy_matches_reference(tmp_path, data, monkeypatch, fsync):
    """Every policy makes the reference's fsyncs, file and directory, at
    the same steps: appends, rotation, close."""
    raw, _ = data
    counts = {}
    real = os.fsync

    def counting(fd):
        counts[pkg] = counts.get(pkg, 0) + 1
        real(fd)

    monkeypatch.setattr(os, "fsync", counting)
    steps = {}
    for pkg, mod in (("port", PW), ("ref", RW)):
        root = str(tmp_path / pkg)
        os.makedirs(root)
        seen = []
        wal = mod.WriteAheadLog(root, fsync=fsync)
        seen.append(counts.get(pkg, 0))
        for s in (0, 50, 100):
            wal.append(raw[s:s + 50], np.arange(s, s + 50, dtype=np.int64),
                       s)
        seen.append(counts.get(pkg, 0))
        wal.rotate([(100, raw[100:150], np.arange(100, 150,
                                                  dtype=np.int64), None)])
        seen.append(counts.get(pkg, 0))
        wal.close()
        seen.append(counts.get(pkg, 0))
        steps[pkg] = seen
    assert steps["port"] == steps["ref"]
    appends = steps["port"][1] - steps["port"][0]
    assert appends == (3 if fsync == "always" else 0)
    # rotation always makes the new file durable before the old goes
    assert steps["port"][2] - steps["port"][1] >= 3
    with pytest.raises(ValueError, match="fsync"):
        PW.WriteAheadLog(str(tmp_path / "port"), fsync="sometimes")


# ------------------------------------------------ store: manifest and shards

@pytest.mark.parametrize("mode", ["pp", "tp", "btp"])
def test_store_files_byte_identical(tmp_path, data, mode):
    """The same stream into both packages leaves byte-identical
    ``MANIFEST.json``, WAL files and segment files."""
    raw, _ = data
    for pkg in PKGS:
        eng = _engine(pkg, str(tmp_path / pkg), buffer_capacity=256,
                      mode=mode)
        _stream(eng, raw[:900])
        eng.close()
    port, ref = _files(str(tmp_path / "port")), _files(str(tmp_path / "ref"))
    assert sorted(port) == sorted(ref)
    assert port["MANIFEST.json"] == ref["MANIFEST.json"]
    for name in port:
        assert port[name] == ref[name], name
    m = json.loads(port["MANIFEST.json"])
    assert m["wal_start"] == 768 and m["mode"] == mode


def test_manifest_helpers_equal_reference(tmp_path):
    runs = [{"file": "seg-000004.coco", "level": 1, "t_min": 0, "t_max": 9}]
    extra = dict(clock=10, mode="btp", buffer_capacity=4, leaf_size=2,
                 size_ratio=2, materialized=True, merges=1, wal_start=10)
    pm = PStore.SegmentStore.manifest_for(CFG, runs, **extra)
    rm = RStore.SegmentStore.manifest_for(RCFG, runs, **extra)
    assert json.dumps(pm) == json.dumps(rm)
    assert PStore.SegmentStore.cfg_from_manifest(pm) == CFG
    for pkg, mod in (("port", PStore), ("ref", RStore)):
        st = mod.SegmentStore(str(tmp_path / pkg))
        st.commit_manifest(pm)
        assert st.live_files() == ["seg-000004.coco"]
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "ref"))
    assert PStore.MANIFEST_NAME == RStore.MANIFEST_NAME
    assert PStore.SHARDS_NAME == RStore.SHARDS_NAME


def test_shard_directory_matches_reference(tmp_path):
    meta = {"shards": 2, "boundaries": [[1, 2, 3, 4]],
            "dirs": ["shard-000-g1", "shard-001-g1"], "generation": 1}
    for pkg, mod in (("port", PStore), ("ref", RStore)):
        d = mod.ShardDirectory(str(tmp_path / pkg))
        assert not d.exists() and "uncommitted" in d.describe()
        for name in ("shard-000-g0", "shard-000-g1", "shard-001-g1",
                     "shard-002-g0"):
            d.shard_store(name)
        d.commit(meta)
        with open(d.meta_path + ".tmp", "w") as f:
            f.write("{torn")
    port = PStore.ShardDirectory(str(tmp_path / "port"))
    ref = RStore.ShardDirectory(str(tmp_path / "ref"))
    assert (open(port.meta_path, "rb").read()
            == open(ref.meta_path, "rb").read())
    assert port.load() == ref.load()
    assert port.shard_dir_name(3, 2) == ref.shard_dir_name(3, 2)
    assert port.cleanup() == ref.cleanup() == [
        "SHARDS.json.tmp", "shard-000-g0", "shard-002-g0"]
    assert port.shard_dirs_on_disk() == ["shard-000-g1", "shard-001-g1"]
    assert port.describe() == ref.describe().replace(
        str(tmp_path / "ref"), str(tmp_path / "port"))


# ------------------------------------------------------ crash, reopen, replay

def test_crash_replay_recovers_acked_inserts(tmp_path, data):
    """Kill after ack: every inserted row — two flushed runs AND the
    188-row unflushed buffer — comes back on reopen, with the answers of
    the reference reopened over the same files."""
    raw, q = data
    root = str(tmp_path / "lsm")
    lsm = _engine("port", root, buffer_capacity=256, wal_fsync="always")
    _stream(lsm, raw[:700])
    assert lsm._buf_count == 188
    del lsm                             # crash: no flush, no close
    shutil.copytree(root, str(tmp_path / "copy"))
    re = _open("port", root)
    ref = _open("ref", str(tmp_path / "copy"))
    assert _structure(re) == _structure(ref)
    assert re.n == 700 and re.clock == 700
    assert re.ingest.snapshot()["wal_replayed_rows"] == 188
    re.flush()
    ref.flush()
    re.check_invariants()
    got = re.search_exact_batch(q, k=3)
    _same(got, ref.search_exact_batch(q, k=3))
    bd, bi = _brute(q, raw[:700], 3)
    np.testing.assert_array_equal(got[1], bi)
    np.testing.assert_allclose(got[0], bd, rtol=1e-5)
    # the reopened index keeps ingesting and stays crash-safe
    re.insert(raw[700:750])
    del re                              # crash again, buffer only
    re2 = _open("port", root)
    assert re2.n == 750
    re2.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_reopen_across_packages(tmp_path, data, writer):
    """Each package opens the other's crashed store: every acked row, the
    writer's run structure and clock, and the writer's answers."""
    raw, q = data
    reader = "ref" if writer == "port" else "port"
    root = str(tmp_path / "lsm")
    eng = _engine(writer, root, buffer_capacity=256)
    _stream(eng, raw[:1000], size=90)
    before = _structure(eng)
    want = eng.snapshot(include_buffer=True).search_exact_batch(
        q, k=4, window=600)
    del eng                             # crash
    shutil.copytree(root, str(tmp_path / "copy"))
    got_eng = _open(reader, root)
    own = _open(writer, str(tmp_path / "copy"))
    assert _structure(got_eng) == _structure(own) == before
    for e in (got_eng, own):
        np.testing.assert_array_equal(np.sort(_all_ids(e)), np.arange(1000))
    got = got_eng.snapshot(include_buffer=True).search_exact_batch(
        q, k=4, window=600)
    _same(got, want)
    got_eng.flush()
    own.flush()
    _same(got_eng.search_exact_batch(q, k=4),
          own.search_exact_batch(q, k=4))


def _all_ids(eng):
    parts = [np.asarray(r.tree.ids) for r in eng.runs]
    parts += [np.asarray(i) for i in eng._buf_ids]
    return np.concatenate(parts)


def test_reopen_is_bit_identical_and_windowed(tmp_path, data):
    """Within the port a reopened engine answers with the bits the
    committed engine gave, whole and windowed, single and batched."""
    raw, q = data
    root = str(tmp_path / "lsm")
    eng = _engine("port", root, buffer_capacity=256)
    _stream(eng, raw[:1024], size=128)
    runs_before = [(r.level, r.t_min, r.t_max, r.n) for r in eng.runs]
    before = [eng.search_exact_batch(q, k=3, window=w) for w in (None, 300)]
    single = eng.search_exact(q[1], k=3)
    del eng
    re = _open("port", root)
    assert [(r.level, r.t_min, r.t_max, r.n) for r in re.runs] == runs_before
    assert all(r.segment is not None and r.seg_handle is None
               for r in re.runs)
    for w, (d0, o0, _) in zip((None, 300), before):
        d1, o1, _ = re.search_exact_batch(q, k=3, window=w)
        np.testing.assert_array_equal(_bits(d1), _bits(d0))
        np.testing.assert_array_equal(o1, o0)
    d1, o1, _ = re.search_exact(q[1], k=3)
    np.testing.assert_array_equal(_bits(d1), _bits(single[0]))
    np.testing.assert_array_equal(o1, single[1])
    bd, bi = _brute(q, raw[1024 - 300:1024], 3)
    np.testing.assert_array_equal(before[1][1], bi + 1024 - 300)


def test_replay_survives_torn_tail(tmp_path, data):
    raw, _ = data
    root = str(tmp_path / "lsm")
    lsm = _engine("port", root, buffer_capacity=256)
    lsm.insert(raw[:200])
    del lsm
    wals = sorted(f for f in os.listdir(root) if f.startswith("wal-"))
    with open(os.path.join(root, wals[-1]), "ab") as f:
        f.write(b"\xde\xadinterrupted")
    assert _open("port", root).n == 200


def test_recover_drops_orphans_and_temps(tmp_path, data):
    """A crash between segment write and manifest commit: the orphan, a
    half-written segment and the torn manifest temp go; the reference
    reports the same recovery on a copy; answers replay unchanged."""
    raw, q = data
    root = str(tmp_path / "lsm")
    lsm = _engine("port", root, buffer_capacity=256)
    _stream(lsm, raw[:800])
    lsm.flush()
    d0, o0, _ = lsm.search_exact_batch(q, k=2)
    committed = set(lsm.store.live_files())
    orphan = lsm.store.write_tree(lsm.runs[0].tree)     # never committed
    del lsm
    store = SegmentStore(root)
    half = store.new_segment_path()
    with open(half, "wb") as f:
        f.write(b"\0" * 100)
    with open(store.manifest_path + ".tmp", "w") as f:
        f.write('{"version": 1, "torn": ')
    shutil.copytree(root, str(tmp_path / "copy"))
    report = store.recover()
    assert report == RStore.SegmentStore(str(tmp_path / "copy")).recover()
    assert orphan in report["removed"] and "MANIFEST.json.tmp" in \
        report["removed"]
    assert set(store.segment_files()) == committed == set(report["kept"])
    re = _open("port", root)
    d1, o1, _ = re.search_exact_batch(q, k=2)
    np.testing.assert_array_equal(_bits(d1), _bits(d0))
    np.testing.assert_array_equal(o1, o0)


def test_store_refuses_silent_overwrite(tmp_path, data):
    root = str(tmp_path / "lsm")
    eng = _engine("port", root, buffer_capacity=256)
    eng.insert(data[0][:300])
    eng.close()
    with pytest.raises(ValueError, match="reopen"):
        CoconutLSM(CFG, store=SegmentStore(root), device="cpu")
    with pytest.raises(ValueError, match="reopen"):
        window_engine("btp", CFG, store=SegmentStore(root), device="cpu")
    with pytest.raises(FileNotFoundError, match="no committed manifest"):
        CoconutLSM.open(str(tmp_path / "empty"), device="cpu")


def test_pre_ids_store_upgrades_on_open(tmp_path, data):
    """A store written before the ids column (a tree without ids) reopens
    with the reference's synthesized ids, and keeps them through merges."""
    raw, q = data
    half = N // 2
    for pkg, mod in (("port", PStore), ("ref", RStore)):
        store = mod.SegmentStore(str(tmp_path / pkg))
        if pkg == "port":
            old = T.build(raw[:half], CFG, leaf_size=LEAF,
                          timestamps=np.arange(half), device="cpu")
        else:
            old = RT.build(jnp.asarray(raw[:half]), RCFG, leaf_size=LEAF,
                           timestamps=jnp.arange(half))
        assert old.ids is None
        f = store.write_tree(old)
        store.commit_manifest(mod.SegmentStore.manifest_for(
            CFG, [{"file": f, "level": 3, "t_min": 0, "t_max": half - 1}],
            clock=half, mode="btp", buffer_capacity=256, leaf_size=LEAF,
            size_ratio=2, materialized=True, merges=0, wal_start=half))
    re = _open("port", str(tmp_path / "port"))
    ref = _open("ref", str(tmp_path / "ref"))
    np.testing.assert_array_equal(re.runs[0].tree.ids.numpy(),
                                  np.asarray(ref.runs[0].tree.ids))
    for e in (re, ref):
        _stream(e, raw[half:], size=200)
        e.flush()
        e.check_invariants()
    assert _structure(re) == _structure(ref)
    assert all(r.tree.ids is not None for r in re.runs)
    ids = _all_ids(re)
    assert len(np.unique(ids)) == len(ids) == N
    _same(re.search_exact_batch(q, k=2), ref.search_exact_batch(q, k=2))


def test_mixed_version_store_compacts_to_v3(tmp_path, data):
    """A committed v2 segment serves the right answers after reopen, and
    the first merge that consumes it rewrites everything as v3."""
    raw, q = data
    half = N // 2
    store = SegmentStore(str(tmp_path / "lsm"))
    old = T.build(raw[:half], CFG, leaf_size=LEAF,
                  timestamps=np.arange(half), ids=np.arange(half),
                  device="cpu")
    path = store.new_segment_path()
    write_segment(path, old, version=2)
    f = os.path.basename(path)
    store.commit_manifest(SegmentStore.manifest_for(
        CFG, [{"file": f, "level": 0, "t_min": 0, "t_max": half - 1}],
        clock=half, mode="btp", buffer_capacity=half, leaf_size=LEAF,
        size_ratio=2, materialized=True, merges=0, wal_start=half))
    re = _open("port", str(tmp_path / "lsm"))
    d0, o0, _ = re.search_exact_batch(q, k=1)
    bd, bi = _brute(q, raw[:half], 1)
    np.testing.assert_array_equal(o0, bi)
    np.testing.assert_allclose(d0, bd, rtol=1e-5)
    re.insert(raw[half:])
    re.flush()
    re.check_invariants()
    assert re.n == N and f not in store.segment_files()
    for name in store.segment_files():
        seg = Segment.open(os.path.join(store.root, name))
        assert seg.version == 3
        seg.close()
    d1, o1, _ = re.search_exact_batch(q, k=1)
    bd, bi = _brute(q, raw, 1)
    np.testing.assert_array_equal(o1, bi)
    np.testing.assert_allclose(d1, bd, rtol=1e-5)


def test_nonmaterialized_roundtrip(tmp_path, data):
    raw, q = data
    root = str(tmp_path / "lsm")
    lsm = _engine("port", root, buffer_capacity=512, materialized=False)
    lsm.insert(raw)
    lsm.flush()
    d0, o0, _ = lsm.search_exact_batch(q, k=2)
    del lsm
    shutil.copytree(root, str(tmp_path / "copy"))
    re = _open("port", root)
    assert not re.runs[0].tree.materialized
    d1, o1, _ = re.search_exact_batch(q, k=2)
    np.testing.assert_array_equal(_bits(d1), _bits(d0))
    np.testing.assert_array_equal(o1, o0)
    _same((d1, o1), _open("ref", str(tmp_path / "copy")).search_exact_batch(
        q, k=2))


def test_restart_then_keep_ingesting(tmp_path, data):
    raw, q = data
    root = str(tmp_path / "lsm")
    lsm = _engine("port", root, buffer_capacity=256)
    lsm.insert(raw[: N // 2])
    lsm.flush()
    lsm.close()
    re = CoconutLSM.open(SegmentStore(root), device="cpu")
    re.insert(raw[N // 2:])
    re.flush()
    re.check_invariants()
    assert re.n == N
    d, o, _ = re.search_exact_batch(q, k=1)
    bd, bi = _brute(q, raw, 1)
    np.testing.assert_array_equal(o, bi)
    np.testing.assert_allclose(d, bd, rtol=1e-5)


# ------------------------------------------- checkpoint, close, counters

@pytest.mark.parametrize("concurrent", [False, True])
def test_checkpoint_commits_and_bounds_replay(tmp_path, data, concurrent):
    raw, _ = data
    root = str(tmp_path / "lsm")
    eng = _engine("port", root, buffer_capacity=256, concurrent=concurrent)
    _stream(eng, raw[:600])
    eng.checkpoint()
    if concurrent:
        eng.flush()                     # wait for the nudged commit
    m = SegmentStore(root).load_manifest()
    assert m["wal_start"] == 600 and eng.ingest_lag() == 0
    eng.close()
    re = _open("port", root)
    assert re.n == 600 and re.ingest.snapshot().get(
        "wal_replayed_rows", 0) == 0
    re.close()


def test_counters_match_reference(tmp_path, data):
    """The WAL and commit counters carry the reference's names and counts
    (``wal_bytes`` included: the records are the same bytes), and every
    commit is timed into ``compact.commit_ms``."""
    raw, _ = data
    h = get_registry().histogram("compact.commit_ms")
    c0 = h.count
    snaps = {}
    for pkg in PKGS:
        eng = _engine(pkg, str(tmp_path / pkg), buffer_capacity=256)
        _stream(eng, raw[:1000], size=90)
        eng.flush()
        eng.insert(raw[1000:1100])
        eng.close()
        re = _open(pkg, str(tmp_path / pkg))
        snaps[pkg] = (eng.ingest.snapshot(), re.ingest.snapshot())
        re.close()
    assert snaps["port"] == snaps["ref"]
    made, reopened = snaps["port"]
    assert made["wal_appends"] == 13 and made["commits"] == 5
    assert reopened["wal_replayed_rows"] == 100
    assert h.count - c0 == 5
    for name in ("open.recover_ms", "open.load_ms", "open.replay_ms"):
        assert get_registry().histogram(name).count >= 1


@pytest.mark.concurrency
@pytest.mark.timeout(120)
def test_concurrent_close_is_durable(tmp_path, data):
    """close() without a flush: acked rows survive through the WAL and
    the drain the compactor runs on shutdown."""
    raw, q = data
    root = str(tmp_path / "lsm")
    with _engine("port", root, buffer_capacity=128,
                 concurrent=True) as lsm:
        _stream(lsm, raw[:500], size=90)
    shutil.copytree(root, str(tmp_path / "copy"))
    re = _open("port", root)
    ref = _open("ref", str(tmp_path / "copy"))
    assert re.n == ref.n == 500
    assert _structure(re) == _structure(ref)
    re.flush()
    ref.flush()
    _same(re.search_exact_batch(q, k=2), ref.search_exact_batch(q, k=2))


def test_window_engine_store_passes_through(tmp_path, data):
    raw, q = data
    root = str(tmp_path / "lsm")
    eng = window_engine("tp", CFG, buffer_capacity=256, leaf_size=LEAF,
                        store=SegmentStore(root), wal_fsync="commit",
                        device="cpu")
    assert eng.store is not None and eng.wal.fsync == "commit"
    _stream(eng, raw[:600])
    eng.close()
    re = _open("port", root)
    assert re.mode == "tp" and re.n == 600


# ------------------------------------------------------------------- tiers

def test_tiers_over_committed_segments_same_bits(tmp_path, data):
    """Opened with ``tiers=``, each run is read off its segment file
    through the cache; its answers keep the tree view's bits, and the
    repeated probe comes from the result cache."""
    raw, q = data
    root = str(tmp_path / "lsm")
    eng = _engine("port", root, buffer_capacity=256)
    _stream(eng, raw[:1024], size=128)
    plain = [eng.search_exact_batch(q, k=3, window=w) for w in (None, 400)]
    eng.close()
    tiers = TieredLeafStore(1 << 20, promote_touches=1,
                            device_capacity_bytes=1 << 20)
    re = _open("port", root, tiers=tiers)
    assert all(r.seg_handle is not None for r in re.runs)
    for w, (d0, o0, _) in zip((None, 400), plain):
        for _ in range(2):                  # fill, then hot
            d1, o1, _ = re.search_exact_batch(q, k=3, window=w)
            np.testing.assert_array_equal(_bits(d1), _bits(d0))
            np.testing.assert_array_equal(o1, o0)
    hits = tiers.result_cache.hits
    assert hits >= 2
    assert tiers.stats()["hits"] > 0
    # tiers on a new durable engine, whose runs get their handles at commit
    eng2 = _engine("port", str(tmp_path / "fresh"), buffer_capacity=256,
                   tiers=TieredLeafStore(1 << 20))
    _stream(eng2, raw[:1024], size=128)
    assert all(r.seg_handle is not None for r in eng2.runs)
    d2, o2, _ = eng2.search_exact_batch(q, k=3)
    np.testing.assert_array_equal(_bits(d2), _bits(plain[0][0]))
    np.testing.assert_array_equal(o2, plain[0][1])


def test_result_cache_key_matches_reference(tmp_path, data, monkeypatch):
    """The port keys a whole exact probe as the reference does: query
    bytes and shape, window, k, radius, epoch, mode and scope."""
    raw, q = data
    keys = {}
    for pkg, cls in (("port", TieredLeafStore), ("ref", RTiers)):
        tiers = cls(1 << 20)
        got = keys.setdefault(pkg, [])
        orig = tiers.result_put
        monkeypatch.setattr(tiers, "result_put",
                            lambda k, v, got=got, orig=orig:
                            (got.append(k), orig(k, v)))
        root = str(tmp_path / "st")
        eng = _engine(pkg, root, buffer_capacity=256, tiers=tiers)
        _stream(eng, raw[:600])
        eng.search_exact_batch(q, k=2, window=300)
        eng.search_exact_batch(q[:2], k=1)
        eng.search_exact_batch(q[:2], k=1, budget=4)   # never cached
        eng.close()
        shutil.rmtree(root)
    assert keys["port"] == keys["ref"]
    assert len(keys["port"]) == 2 and keys["port"][0][-1] == str(
        tmp_path / "st")


@pytest.mark.concurrency
@pytest.mark.timeout(180)
def test_result_cache_never_serves_stale_under_ingest(tmp_path, data):
    """Plant a row identical to the probe, flush (merges included) and
    probe again: the answer is 0 at once, every round, while two threads
    hammer the same query (their replays are the ones a broken epoch key
    would poison)."""
    raw, _ = data
    rng = np.random.default_rng(99)
    tiers = TieredLeafStore(16 << 20)
    probe = rng.standard_normal((1, L)).astype(np.float32)
    errors = []
    stop = threading.Event()

    def hammer(eng):
        try:
            while not stop.is_set():
                d, _, _ = eng.search_exact_batch(probe, k=1)
                assert d.shape == (1, 1)
        except Exception as e:           # pragma: no cover
            errors.append(e)

    with _engine("port", str(tmp_path / "lsm"), buffer_capacity=256,
                 concurrent=True, max_debt=64, tiers=tiers) as eng:
        eng.insert(raw[:512])
        eng.flush()
        threads = [threading.Thread(target=hammer, args=(eng,))
                   for _ in range(2)]
        for th in threads:
            th.start()
        try:
            d0, _, _ = eng.search_exact_batch(probe, k=1)
            assert float(d0[0, 0]) > 1e-3
            eng.insert(rng.standard_normal((256, L)).astype(np.float32))
            eng.insert(probe)
            eng.flush()
            d1, _, _ = eng.search_exact_batch(probe, k=1)
            assert float(d1[0, 0]) <= 1e-6
            for i in range(1, 3):
                eng.insert(raw[512 + 256 * i: 768 + 256 * i])
                eng.flush()
                d2, _, _ = eng.search_exact_batch(probe, k=1)
                assert float(d2[0, 0]) <= 1e-6
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
    assert not errors
    assert tiers.result_cache.hits > 0
