"""The port's rules: it stands alone and runs where the caller says.

* ``repro_torch`` imports with ``jax`` and the reference package ``repro``
  blocked, and no source file names them (nor ``chip_smoke.py`` and the
  compare tools, which run on the card's machine);
* a numpy input defaults to the CUDA device, so without one an entry point
  raises instead of running on the CPU;
* a tensor on a device with no kernel raises; there is no fallback to a
  plain twin.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKE_INDEX
from repro_torch.core import tree as T
from repro_torch.kernels import ops

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
MODULES = ["repro_torch", "repro_torch.core", "repro_torch.core.tree",
           "repro_torch.kernels", "repro_torch.kernels.ops",
           "repro_torch.kernels.loader", "repro_torch.kernels.sax_summarize",
           "repro_torch.kernels.zorder", "repro_torch.kernels.unpack_mindist",
           "repro_torch.query", "repro_torch.storage",
           "repro_torch.storage.segment", "repro_torch.storage.tiers",
           "repro_torch.storage.external_sort", "repro_torch.obs",
           "repro_torch.data", "repro_torch.configs",
           "repro_torch.query.approx", "repro_torch.core.lsm",
           "repro_torch.core.windows", "repro_torch.ingest",
           "repro_torch.ingest.snapshot", "repro_torch.ingest.compactor"]


def test_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


BAD_IMPORT = re.compile(r"^\s*(import jax|from jax|from repro\.|"
                        r"import repro\.|from repro import|import repro\s*$)",
                        re.M)


def test_no_source_names_jax_or_the_reference():
    files = list(PKG.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not BAD_IMPORT.search(f.read_text()), f


def test_chip_scripts_name_neither_jax_nor_the_reference():
    """chip_smoke.py and the compare tools run on the card's machine,
    which has no jax."""
    root = PKG.parents[1]
    files = [root / "chip_smoke.py", *sorted((root / "tools").glob("*.py"))]
    assert len(files) >= 5
    for f in files:
        assert not BAD_IMPORT.search(f.read_text()), f


def test_numpy_build_defaults_to_cuda():
    x = np.zeros((8, SMOKE_INDEX.series_len), np.float32)
    if torch.cuda.is_available():
        assert T.build(x, SMOKE_INDEX, leaf_size=4).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build(x, SMOKE_INDEX, leaf_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build(x, SMOKE_INDEX, leaf_size=4, device="cuda")
    cols = {"keys": np.zeros((8, 1), np.uint32),
            "codes": np.zeros((8, 8), np.uint8),
            "paas": np.zeros((8, 8), np.float32),
            "offsets": np.arange(8, dtype=np.int32), "raw": x}
    with pytest.raises(RuntimeError, match="CUDA"):
        T.from_numpy(cols, series_len=64, segments=8, bits=4, leaf_size=4)
    assert T.build(x, SMOKE_INDEX, leaf_size=4,
                   device="cpu").device.type == "cpu"


def test_streaming_and_budgeted_entry_points_default_to_cuda():
    """The LSM, the window engines and a budgeted search over numpy input
    run on the card by default; without one they raise."""
    from repro_torch.core.lsm import CoconutLSM
    from repro_torch.core.windows import window_engine
    from repro_torch.ingest import FrozenBuffer
    from repro_torch.query import Partition, approx_knn
    x = np.zeros((8, SMOKE_INDEX.series_len), np.float32)
    buf = FrozenBuffer(raw=x, ts=np.arange(8), ids=np.arange(8))
    if torch.cuda.is_available():
        assert CoconutLSM(SMOKE_INDEX).device.type == "cuda"
        assert window_engine("tp", SMOKE_INDEX).device.type == "cuda"
        assert Partition.from_buffer(buf, SMOKE_INDEX).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        CoconutLSM(SMOKE_INDEX)
    with pytest.raises(RuntimeError, match="CUDA"):
        window_engine("btp", SMOKE_INDEX)
    with pytest.raises(RuntimeError, match="CUDA"):
        approx_knn([Partition.from_buffer(buf, SMOKE_INDEX)], x[:2],
                   SMOKE_INDEX, budget=0)
    assert CoconutLSM(SMOKE_INDEX, device="cpu").device.type == "cpu"
    d, _, st = approx_knn(
        [Partition.from_buffer(buf, SMOKE_INDEX, device="cpu")], x[:2],
        SMOKE_INDEX, budget=0)
    assert st.buffer_rows == 8 and d.shape == (2, 1)


def test_device_without_kernel_raises():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    kernel and no twin."""
    q = torch.zeros((2, 8), device="meta")
    codes = torch.zeros((5, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.mindist_batch(q, codes, SMOKE_INDEX)
    with pytest.raises(ValueError, match="no kernel"):
        ops.batch_euclid_multi(torch.zeros((2, 64), device="meta"),
                               torch.zeros((5, 64), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ops.summarize_and_key(torch.zeros((5, 64), device="meta"),
                              SMOKE_INDEX)
    with pytest.raises(ValueError, match="no kernel"):
        ops.sax_summarize(torch.zeros((5, 64), device="meta"), SMOKE_INDEX)
    with pytest.raises(ValueError, match="no kernel"):
        ops.zorder(codes, SMOKE_INDEX)
    with pytest.raises(ValueError, match="no kernel"):
        ops.mindist_batch_packed(q, torch.zeros((5, 4), dtype=torch.uint8,
                                                device="meta"), SMOKE_INDEX)


def test_no_kernel_mode_override():
    src = "\n".join(p.read_text() for p in PKG.rglob("*.py"))
    assert "COCONUT_KERNEL_MODE" not in src
    assert "os.environ" not in (PKG / "kernels" / "ops.py").read_text()
