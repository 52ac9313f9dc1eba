"""Port parity: the on-disk storage path, PyTorch port vs the JAX reference.

Both packages get the same numpy inputs.  What must agree, and how:

* codecs (bit-packed codes, delta+varint keys) and ``write_segment`` from
  the same columns: byte for byte;
* a segment written by either package opens in the other with identical
  columns; legacy v1/v2 files written by the reference open in the port;
  truncated and corrupt files are refused;
* ``build_external``: every column equal to the reference's file except
  ``paas`` (rtol 1e-6: the reference takes ``jnp.mean``, the port an
  index-order sum) on data where no PAA lies within 4 ulp of a breakpoint
  (asserted), and bit for bit equal to the port's in-memory
  ``tree.build``; the build's ``IOStats`` equal the reference's;
* ``exact_search_mmap``: ids exact, distances at rtol 1e-6, ``SearchStats``
  leaf counts and ``IOStats`` exact (first and second query);
* within the port, segment answers equal ``exact_search_batch`` on the
  tree bit for bit, and ``save`` / ``load`` round-trips.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import summarization as RS
from repro.core import tree as RT
from repro.core.metrics import IOStats as RIOStats
from repro.storage import build_external as r_build_external
from repro.storage import exact_search_mmap as r_exact_search_mmap
from repro.storage import packing as RP
from repro.storage import segment as RSeg
from repro_torch.configs import SMOKE_INDEX
from repro_torch.core import keys as K
from repro_torch.core import tree as T
from repro_torch.core.metrics import IOStats
from repro_torch.query import Partition
from repro_torch.storage import (Segment, SegmentFormatError, SegmentWriter,
                                 build_external, exact_search_mmap,
                                 write_segment)
from repro_torch.storage import packing as P

CFG = SMOKE_INDEX
RCFG = RS.SummaryConfig(CFG.series_len, CFG.segments, CFG.bits)
LEAF = 64
N = 2500


def _walks(rng, n, length):
    x = np.cumsum(rng.standard_normal((n, length)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


def _far_from_breakpoints(x):
    """Rows whose PAA lies more than 4 ulp from every breakpoint, so no
    code can differ between the two packages' PAA orders."""
    paa = x.reshape(len(x), CFG.segments, -1).mean(-1)
    bps = RS._breakpoints_np(CFG.bits)
    near = (np.abs(paa[..., None] - bps)
            <= 4 * np.spacing(np.abs(bps))).any(axis=(-1, -2))
    return x[~near]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = _far_from_breakpoints(_walks(rng, N + 50, CFG.series_len))[:N]
    assert len(x) == N
    q = _walks(rng, 64, CFG.series_len)
    q[::2] = x[rng.integers(0, N, 32)] + 0.1 * rng.standard_normal(
        (32, CFG.series_len)).astype(np.float32)
    ts = rng.permutation(N).astype(np.int32)
    return x, q, ts


@pytest.fixture(scope="module")
def ref_tree(data):
    x, _, ts = data
    return RT.build(jnp.asarray(x), RCFG, leaf_size=LEAF,
                    timestamps=jnp.asarray(ts))


@pytest.fixture(scope="module")
def segs(data, ref_tree, tmp_path_factory):
    """The same tree written by each package (port tree from the
    reference's columns), opened by the port and by the reference."""
    d = tmp_path_factory.mktemp("segs")
    port_tree = _port_tree(ref_tree)
    RSeg.write_segment(str(d / "ref.coco"), ref_tree)
    write_segment(str(d / "port.coco"), port_tree)
    return {"dir": d, "port_tree": port_tree,
            "port": Segment.open(str(d / "port.coco")),
            "ref": RSeg.Segment.open(str(d / "ref.coco"))}


def _port_tree(rt, **extra):
    cols = {name: None if getattr(rt, name) is None
            else np.asarray(getattr(rt, name))
            for name in ("keys", "codes", "paas", "offsets", "raw",
                         "raw_ref", "timestamps", "ids")}
    cols.update(extra)
    return T.from_numpy(cols, series_len=CFG.series_len,
                        segments=CFG.segments, bits=CFG.bits,
                        leaf_size=rt.leaf_size, device="cpu")


def _columns(seg):
    return {name: np.asarray(getattr(seg, name)) for name in
            ("keys", "codes", "paas", "offsets", "timestamps", "raw",
             "fences", "ids") if getattr(seg, name) is not None}


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------------ codecs

@pytest.mark.parametrize("b", [1, 3, 4, 5, 8])
def test_packing_byte_identical(b):
    rng = np.random.default_rng(b)
    for w in (7, 8, 16):
        codes = rng.integers(0, 1 << b, (333, w)).astype(np.uint8)
        assert P.packed_code_width(w, b) == RP.packed_code_width(w, b)
        packed = P.pack_codes(codes, b)
        np.testing.assert_array_equal(packed, RP.pack_codes(codes, b))
        np.testing.assert_array_equal(P.unpack_codes(packed, w, b), codes)
        np.testing.assert_array_equal(P.PackedCodes(packed, w, b)[10:20],
                                      codes[10:20])
    nw = max(1, -(-(16 * b) // 32))
    keys = np.sort(rng.integers(0, 1 << 32, (1000, nw), dtype=np.uint64)
                   .astype(np.uint32), axis=0)
    blob = P.encode_keys(keys, 64)
    np.testing.assert_array_equal(blob, RP.encode_keys(keys, 64))
    view = P.PackedKeys(blob, len(keys), nw, 64)
    np.testing.assert_array_equal(np.asarray(view), keys)
    idx = rng.integers(0, len(keys), 50)
    np.testing.assert_array_equal(view[idx], keys[idx])
    assert view.leaf_nbytes(3) == RP.PackedKeys(blob, len(keys), nw,
                                                64).leaf_nbytes(3)


# ------------------------------------------------------ files across packages

def test_port_segment_opens_in_reference(segs, ref_tree):
    ref_view = RSeg.Segment.open(segs["port"].path)
    ref_view.verify()
    got = _columns(ref_view)
    want = _columns(segs["ref"])
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(got["keys"], np.asarray(ref_tree.keys))
    ref_view.close()


def test_reference_segment_opens_in_port(segs):
    seg = Segment.open(segs["ref"].path)
    seg.verify()
    assert seg.cfg == CFG and seg.version == 3 and seg.materialized
    got, want = _columns(seg), _columns(segs["port"])
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    tree = seg.to_tree(device="cpu")
    pt = segs["port_tree"]
    for name in ("keys", "codes", "paas", "offsets", "raw", "timestamps"):
        assert torch.equal(getattr(tree, name), getattr(pt, name)), name
    assert tree.keys.dtype == torch.int64 and int(tree.keys.max()) < 2 ** 32
    seg.close()


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_reference_segments_open_in_port(segs, ref_tree, version):
    path = str(segs["dir"] / f"ref-v{version}.coco")
    RSeg.write_segment(path, ref_tree, version=version)
    seg = Segment.open(path)
    seg.verify()
    assert seg.version == version and seg.codes_packed is None
    got, want = _columns(seg), _columns(segs["port"])
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    q = np.asarray(_walks(np.random.default_rng(3), 4, CFG.series_len))
    d_old, o_old, _ = exact_search_mmap(seg, q, k=3, device="cpu")
    d_new, o_new, _ = exact_search_mmap(segs["port"], q, k=3, device="cpu")
    np.testing.assert_array_equal(o_old, o_new)
    np.testing.assert_array_equal(_bits(d_old), _bits(d_new))
    seg.close()


@pytest.mark.parametrize("damage", ["truncate", "header", "magic",
                                    "missing"])
def test_truncated_and_corrupt_segments_rejected(segs, tmp_path, damage):
    path = str(tmp_path / "t.coco")
    with open(segs["port"].path, "rb") as f:
        blob = bytearray(f.read())
    if damage == "truncate":
        blob = blob[:-8]                   # clip the footer
    elif damage == "header":
        blob[40:42] = b"\xff\xff"          # bytes under the header crc
    elif damage == "magic":
        blob[:8] = b"NOTCOCO!"
    if damage != "missing":
        with open(path, "wb") as f:
            f.write(bytes(blob))
    for opener in (Segment.open, RSeg.Segment.open):
        with pytest.raises((SegmentFormatError, RSeg.SegmentFormatError)):
            opener(path)


@pytest.mark.parametrize("version", [1, 3])
@pytest.mark.parametrize("mat", [True, False])
def test_write_segment_byte_identical(data, tmp_path, version, mat):
    x, _, ts = data
    rt = RT.build(jnp.asarray(x), RCFG, leaf_size=LEAF, materialized=mat,
                  timestamps=jnp.asarray(ts),
                  ids=jnp.asarray(np.arange(N, dtype=np.int64) * 3))
    pt = _port_tree(rt)
    RSeg.write_segment(str(tmp_path / "r.coco"), rt, version=version)
    write_segment(str(tmp_path / "p.coco"), pt, version=version)
    with open(tmp_path / "r.coco", "rb") as f:
        want = f.read()
    with open(tmp_path / "p.coco", "rb") as f:
        got = f.read()
    assert got == want


# ------------------------------------------------------ external-sort build

# timestamps need array input in both packages
@pytest.mark.parametrize("as_iter,with_ts",
                         [(False, False), (False, True), (True, False)])
def test_build_external_matches_reference(data, tmp_path, as_iter, with_ts):
    x, _, ts = data
    chunk = 600
    src = ((x[s:s + chunk] for s in range(0, N, chunk)) if as_iter else x)
    r_src = ((x[s:s + chunk] for s in range(0, N, chunk)) if as_iter else x)
    kw = dict(chunk_size=chunk, leaf_size=LEAF, merge_batch=256,
              timestamps=ts if with_ts else None)
    io, rio = IOStats(), RIOStats()
    seg = build_external(src, CFG, workdir=str(tmp_path / "p"), io=io,
                         device="cpu", **kw)
    rseg = r_build_external(r_src, RCFG, workdir=str(tmp_path / "r"),
                            io=rio, **kw)
    got, want = _columns(seg), _columns(rseg)
    assert got.keys() == want.keys()
    for name in want:
        if name == "paas":
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
        else:      # codes included: no PAA near a breakpoint on this data
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    assert io.as_dict() == rio.as_dict()
    assert not any(f.startswith("spill") for f in
                   os.listdir(tmp_path / "p"))
    # and bit for bit the in-memory build (fused_build vs the two stages)
    tree = T.build(x, CFG, leaf_size=LEAF, device="cpu",
                   timestamps=ts if with_ts else None)
    for name in ("keys", "codes", "paas", "offsets", "raw"):
        want_t = getattr(tree, name).numpy()
        g = got[name].astype(want_t.dtype)
        if name == "paas":
            np.testing.assert_array_equal(_bits(g), _bits(want_t))
        else:
            np.testing.assert_array_equal(g, want_t, err_msg=name)


def test_build_external_merges_ties_in_input_order(tmp_path):
    """Duplicate rows across and within chunks: equal keys keep (chunk,
    row) order, as a stable in-memory sort and the reference do."""
    rng = np.random.default_rng(2)
    base = _walks(rng, 40, CFG.series_len)
    x = base[rng.integers(0, 40, 700)]
    seg = build_external(x, CFG, workdir=str(tmp_path / "p"),
                         chunk_size=128, leaf_size=LEAF, merge_batch=32,
                         device="cpu")
    rseg = r_build_external(x, RCFG, workdir=str(tmp_path / "r"),
                            chunk_size=128, leaf_size=LEAF, merge_batch=32)
    np.testing.assert_array_equal(np.asarray(seg.offsets),
                                  np.asarray(rseg.offsets))
    tree = T.build(x, CFG, leaf_size=LEAF, device="cpu")
    np.testing.assert_array_equal(np.asarray(seg.offsets),
                                  tree.offsets.numpy())


# ------------------------------------------------------------ search off disk

@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("nq", [1, 8, 64])
def test_exact_search_mmap_matches_reference(data, segs, k, nq):
    _, q, _ = data
    q = q[:nq]
    # fresh handles: the planner caches the fence envelopes on the source
    seg = Segment.open(segs["port"].path)
    rseg = RSeg.Segment.open(segs["ref"].path)
    for rnd in range(2):       # the second query hits the envelope cache
        io, rio = IOStats(), RIOStats()
        d, o, st = exact_search_mmap(seg, q, k=k, io=io, device="cpu")
        rd, ro, rst = r_exact_search_mmap(rseg, q, k=k, io=rio)
        np.testing.assert_array_equal(o, ro)
        np.testing.assert_allclose(d, rd, rtol=1e-6)
        assert (st.leaves_scanned, st.leaves_pruned, st.leaves_touched,
                st.candidates, st.scan_bytes) == (
            rst.leaves_scanned, rst.leaves_pruned, rst.leaves_touched,
            rst.candidates, rst.scan_bytes)
        assert io.as_dict() == rio.as_dict()


def test_segment_search_bitwise_equals_tree_and_round_trip(data, segs,
                                                           tmp_path):
    _, q, _ = data
    pt = segs["port_tree"]
    want_d, want_o, want_st = T.exact_search_batch(pt, q, k=10)
    d, o, st = exact_search_mmap(segs["port"], q, k=10, device="cpu")
    np.testing.assert_array_equal(o, want_o)
    np.testing.assert_array_equal(_bits(d), _bits(want_d))
    assert st.leaves_scanned == want_st.leaves_scanned
    path = str(tmp_path / "saved.coco")
    T.save(pt, path)
    back = T.load(path, device="cpu")
    for name in ("keys", "codes", "paas", "offsets", "raw", "timestamps"):
        assert torch.equal(getattr(back, name), getattr(pt, name)), name
    d2, o2, _ = T.exact_search_batch(back, q, k=10)
    np.testing.assert_array_equal(o2, want_o)
    np.testing.assert_array_equal(_bits(d2), _bits(want_d))


def test_seed_window_insertion_points_equal_searchsorted(data, segs):
    """The segment probe (fence search + one key leaf per query) lands
    where a binary search over the whole key column does."""
    x, q, _ = data
    pt = segs["port_tree"]
    qs = np.concatenate([q, x[::97], x[:1] - 50.0, x[:1] + 50.0])
    part = Partition.from_segment(segs["port"], device="cpu")
    idx = part.seed_window(torch.from_numpy(qs), radius_leaves=1)
    _, q_codes = RS.summarize(jnp.asarray(qs), RCFG)
    q_keys = torch.from_numpy(
        np.asarray(RS.invsax_keys(q_codes, RCFG)).astype(np.int64))
    pos = K.searchsorted_keys(pt.keys, q_keys).numpy()
    span = 2 * LEAF
    start = np.clip(pos - span // 2, 0, N - span)
    np.testing.assert_array_equal(idx[:, 0], start)
    np.testing.assert_array_equal(
        idx, T._seed_index(pt, torch.from_numpy(qs)).numpy())


def test_segment_entry_points_default_to_cuda(segs):
    if torch.cuda.is_available():
        pytest.skip("the default is the card, which this host has")
    with pytest.raises(RuntimeError, match="CUDA"):
        Partition.from_segment(segs["port"])
    with pytest.raises(RuntimeError, match="CUDA"):
        exact_search_mmap(segs["port"], np.zeros((1, CFG.series_len),
                                                 np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        segs["port"].to_tree()
    with pytest.raises(RuntimeError, match="CUDA"):
        exact_search_mmap(segs["port"], np.zeros((1, CFG.series_len),
                                                 np.float32), budget=2)
    d, o, st = exact_search_mmap(segs["port"],
                                 np.zeros((1, CFG.series_len), np.float32),
                                 mode="approx", device="cpu")
    assert np.all(st.gap == 0) and d.shape == o.shape == (1, 1)


def test_writer_rejects_wrong_rows(tmp_path):
    w = SegmentWriter(str(tmp_path / "w.coco"), CFG, 4, leaf_size=2)
    with pytest.raises(ValueError):
        w.append(np.zeros((5, CFG.n_words), np.uint32),
                 np.zeros((5, CFG.segments), np.uint8),
                 np.zeros((5, CFG.segments), np.float32),
                 np.zeros(5, np.int64), raw=np.zeros((5, CFG.series_len),
                                                     np.float32))
    w.abort()
    assert not os.path.exists(tmp_path / "w.coco")
