"""The port's rules: it stands alone and runs where the caller says.

* ``repro_torch`` imports with ``jax`` and the reference package ``repro``
  blocked, and no source file names them (nor ``chip_smoke.py`` and the
  tools, which run on the card's machine; the one CPU-only tool,
  ``tools/compare_dryrun.py``, names them only in its reference child's
  command);
* a numpy input defaults to the CUDA device, so without one an entry point
  raises instead of running on the CPU;
* a tensor on a device with no kernel raises; there is no fallback to a
  plain twin.
"""
from __future__ import annotations

import ast
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
ARCH_MODULES = ["llama3_2_1b", "llama3_405b", "qwen1_5_110b", "granite_3_2b",
                "granite_moe_1b_a400m", "llama4_maverick_400b_a17b",
                "mamba2_2_7b", "recurrentgemma_2b", "phi_3_vision_4_2b",
                "seamless_m4t_medium"]
SERVING = ["repro_torch.models", "repro_torch.models.config",
           "repro_torch.models.layers", "repro_torch.models.attention",
           "repro_torch.models.moe", "repro_torch.models.ssm",
           "repro_torch.models.rglru", "repro_torch.models.transformer",
           "repro_torch.models.steps", "repro_torch.configs.registry",
           "repro_torch.launch.serve",
           *(f"repro_torch.configs.{m}" for m in ARCH_MODULES)]
TRAINING = ["repro_torch.train.optimizer", "repro_torch.train.compression",
            "repro_torch.train.checkpoint", "repro_torch.train.runtime",
            "repro_torch.data.tokens", "repro_torch.distributed.pipeline",
            "repro_torch.launch.train", "repro_torch.launch.flops"]
POD = ["repro_torch.launch.sharding", "repro_torch.launch.hlo",
       "repro_torch.launch.dryrun", "repro_torch.configs.shapes"]
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
           "repro_torch.ingest.snapshot", "repro_torch.ingest.compactor",
           "repro_torch.storage.store", "repro_torch.ingest.wal",
           "repro_torch.core.trie", "repro_torch.distributed",
           "repro_torch.distributed.router",
           "repro_torch.distributed.samplesort",
           "repro_torch.distributed.sharded_lsm", "repro_torch.launch",
           "repro_torch.launch.mesh", "repro_torch.kernels.mesh_scan",
           "repro_torch.query.mesh", "repro_torch.distributed.sharded_index",
           "repro_torch.obs.profile", "repro_torch.obs.analytics",
           "repro_torch.obs.health", "repro_torch.obs.httpd",
           "repro_torch.obs.validate", *SERVING, "repro_torch.train",
           *TRAINING, *POD]


def test_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
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


def test_serving_modules_sit_at_the_references_paths_and_name_no_jax():
    """``models/``, ``launch/serve.py`` and the ten architecture configs
    exist at the reference's relative paths, and their text names neither
    jax, the reference package nor ``ml_dtypes`` (absent on the card's
    machine)."""
    ref_root = PKG.parent / "repro"
    files = [PKG / (m[len("repro_torch."):].replace(".", "/") + ".py")
             for m in SERVING if m != "repro_torch.models"]
    files.append(PKG / "models" / "__init__.py")
    assert len(files) == 21
    word = re.compile(r"\bjax\b|\brepro\b(?!_)|ml_dtypes")
    for f in files:
        rel = f.relative_to(PKG)
        if rel.name != "__init__.py":
            assert (ref_root / rel).exists(), rel
        assert not word.search(f.read_text()), f


def test_training_modules_sit_at_the_references_paths_and_name_no_jax():
    """``train/``, ``data/tokens.py``, ``distributed/pipeline.py`` and
    ``launch/{train,flops}.py`` exist at the reference's relative paths,
    and their text names neither jax, the reference package nor
    ``ml_dtypes``."""
    ref_root = PKG.parent / "repro"
    files = [PKG / (m[len("repro_torch."):].replace(".", "/") + ".py")
             for m in TRAINING]
    assert len(files) == 8
    word = re.compile(r"\bjax\b|\brepro\b(?!_)|ml_dtypes")
    for f in files:
        rel = f.relative_to(PKG)
        assert (ref_root / rel).exists(), rel
        assert not word.search(f.read_text()), f
    # every module of the reference's train/ has its counterpart
    ref_train = {p.name for p in (ref_root / "train").glob("*.py")}
    assert ref_train <= {p.name for p in (PKG / "train").glob("*.py")}


def test_pod_modules_sit_at_the_references_paths_and_name_no_jax():
    """``launch/{sharding,hlo,dryrun}.py`` and ``configs/shapes.py`` exist
    at the reference's relative paths and name neither jax nor the
    reference package; with them every module of the reference has its
    counterpart but two: ``distributed/compat.py`` (a ``shard_map`` shim
    across JAX versions; the port's meshes run one process and
    ``torch.distributed`` has no such shim to carry) and
    ``kernels/mindist_scan.py`` (kernel #1 at Q=1, ``ops.mindist``)."""
    ref_root = PKG.parent / "repro"
    word = re.compile(r"\bjax\b|\brepro\b(?!_)|ml_dtypes")
    for m in POD:
        f = PKG / (m[len("repro_torch."):].replace(".", "/") + ".py")
        assert (ref_root / f.relative_to(PKG)).exists(), f
        assert not word.search(f.read_text()), f
    missing = {str(p.relative_to(ref_root)) for p in ref_root.rglob("*.py")
               if not (PKG / p.relative_to(ref_root)).exists()}
    assert missing == {"distributed/compat.py", "kernels/mindist_scan.py"}


def test_model_and_serve_default_to_cuda():
    """``Model``, ``params_from_reference`` and the serve loop run on the
    card by default; without one they raise, and on the CPU they run only
    when ``device="cpu"`` is passed."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models import Model, params_from_reference
    cfg = get("llama3.2-1b", smoke=True)
    argv = ["--arch", "llama3.2-1b", "--steps", "2", "--batch", "1",
            "--probe-batch", "2"]
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve(cfg, serve.build_parser().parse_args(argv))
    model = Model(cfg, device="cpu")
    assert model.device.type == "cpu"
    tree = {k: v.numpy() for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference({"embed": tree["embed"], "rem": []}, cfg)
    with redirect_stdout(io.StringIO()):
        out = serve.main(argv, device="cpu")
    assert out["report"]["decode.steps_total"] == 2


# tools that run only on the CPU beside the reference, each with the one
# module-level string that is the reference's child command (``python -c``)
CPU_ONLY_TOOLS = {"compare_dryrun.py": "REFERENCE_CELL"}
_NAMES_REFERENCE = re.compile(r"import jax|from jax|from repro\.|"
                              r"import repro\b|from repro import")


def test_chip_scripts_name_neither_jax_nor_the_reference():
    """chip_smoke.py and the tools run on the card's machine, which has no
    jax.  A CPU-only tool imports neither either; only its reference
    child's command, a string run in a process of its own, names them."""
    root = PKG.parents[1]
    files = [root / "chip_smoke.py", *sorted((root / "tools").glob("*.py"))]
    assert len(files) >= 5
    assert {f.name for f in files} >= set(CPU_ONLY_TOOLS)
    for f in files:
        text = f.read_text()
        assert not BAD_IMPORT.search(text), f
        if f.name not in CPU_ONLY_TOOLS:
            continue
        tree = ast.parse(text)
        imported = {a.name for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names} | {
            n.module or "" for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)}
        assert not {m.split(".")[0] for m in imported} & {"jax", "repro"}, f
        child = [n.value for n in tree.body if isinstance(n, ast.Assign)
                 and [t.id for t in n.targets if isinstance(t, ast.Name)]
                 == [CPU_ONLY_TOOLS[f.name]]]
        assert len(child) == 1, f
        assert _NAMES_REFERENCE.search(ast.literal_eval(child[0])), f
        others = [c.value for c in ast.walk(tree)
                  if isinstance(c, ast.Constant) and isinstance(c.value, str)
                  and c is not child[0]]
        assert not [o for o in others if _NAMES_REFERENCE.search(o)], f


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
    from repro_torch.distributed import ShardedCoconutLSM
    from repro_torch.ingest import FrozenBuffer
    from repro_torch.query import Partition, approx_knn
    x = np.zeros((8, SMOKE_INDEX.series_len), np.float32)
    buf = FrozenBuffer(raw=x, ts=np.arange(8), ids=np.arange(8))
    if torch.cuda.is_available():
        assert CoconutLSM(SMOKE_INDEX).device.type == "cuda"
        assert window_engine("tp", SMOKE_INDEX).device.type == "cuda"
        sharded = window_engine("btp", SMOKE_INDEX, shards=4)
        assert sharded.device.type == "cuda"
        assert all(s.device.type == "cuda" for s in sharded._shard_list())
        assert Partition.from_buffer(buf, SMOKE_INDEX).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        CoconutLSM(SMOKE_INDEX)
    with pytest.raises(RuntimeError, match="CUDA"):
        window_engine("btp", SMOKE_INDEX)
    with pytest.raises(RuntimeError, match="CUDA"):
        window_engine("btp", SMOKE_INDEX, shards=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedCoconutLSM(SMOKE_INDEX, shards=2)
    assert window_engine("btp", SMOKE_INDEX, shards=4,
                         device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        approx_knn([Partition.from_buffer(buf, SMOKE_INDEX)], x[:2],
                   SMOKE_INDEX, budget=0)
    assert CoconutLSM(SMOKE_INDEX, device="cpu").device.type == "cpu"
    d, _, st = approx_knn(
        [Partition.from_buffer(buf, SMOKE_INDEX, device="cpu")], x[:2],
        SMOKE_INDEX, budget=0)
    assert st.buffer_rows == 8 and d.shape == (2, 1)


def test_durable_engine_defaults_to_cuda(tmp_path):
    """A durable engine, made over a store or reopened from one, runs on
    the card by default; without one it raises, and it runs on the CPU
    only when ``device="cpu"`` is passed."""
    from repro_torch.core.lsm import CoconutLSM
    from repro_torch.storage import SegmentStore
    x = np.zeros((8, SMOKE_INDEX.series_len), np.float32)
    root = str(tmp_path / "lsm")
    if torch.cuda.is_available():
        eng = CoconutLSM(SMOKE_INDEX, store=SegmentStore(root))
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CoconutLSM(SMOKE_INDEX, store=SegmentStore(root))
        assert not SegmentStore(root).exists()   # nothing committed
        eng = CoconutLSM(SMOKE_INDEX, store=SegmentStore(root),
                         device="cpu")
        assert eng.device.type == "cpu"
    eng.insert(x)
    eng.close()
    if torch.cuda.is_available():
        assert CoconutLSM.open(root).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        CoconutLSM.open(root)
    with pytest.raises(RuntimeError, match="CUDA"):
        CoconutLSM.open(root, device="cuda")
    re = CoconutLSM.open(root, device="cpu")
    assert re.device.type == "cpu" and re.n == 8


def test_sharded_store_defaults_to_cuda(tmp_path):
    """A sharded engine over a data directory, made or reopened, runs on
    the card by default; without one it raises, and it runs on the CPU
    only when ``device="cpu"`` is passed."""
    from repro_torch.distributed import ShardedCoconutLSM
    x = np.random.default_rng(0).standard_normal(
        (40, SMOKE_INDEX.series_len)).astype(np.float32)
    root = str(tmp_path / "sharded")
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    eng = ShardedCoconutLSM(SMOKE_INDEX, shards=2, data_dir=root,
                            device=dev)
    eng.insert(x)
    eng.close()
    if torch.cuda.is_available():
        re = ShardedCoconutLSM.open(root)
        assert re.device.type == "cuda" and re.n == 40
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedCoconutLSM.open(root)
    re = ShardedCoconutLSM.open(root, device="cpu")
    assert re.n == 40
    assert all(s.device.type == "cpu" for s in re._shard_list())


def test_static_sharded_tree_defaults_to_cuda(monkeypatch):
    """``build_sharded`` with no mesh takes one shard per visible card,
    and ``sharded_tree_from_arrays`` with no mesh spreads its shards over
    ``make_scan_mesh``'s devices; without a card both raise."""
    from repro_torch.distributed import sharded_index as SI
    x = np.random.default_rng(0).standard_normal(
        (16, SMOKE_INDEX.series_len)).astype(np.float32)
    if torch.cuda.is_available():
        tree = SI.build_sharded(None, x, SMOKE_INDEX)
        assert all(d.type == "cuda" for d in tree.mesh)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        SI.build_sharded(None, x, SMOKE_INDEX)
    tree = SI.build_sharded(["cpu"] * 2, x, SMOKE_INDEX)
    cols = [np.concatenate([c.numpy() for c in getattr(tree, n)])
            for n in ("keys", "codes", "paas", "raw")]
    with pytest.raises(RuntimeError, match="CUDA"):
        SI.sharded_tree_from_arrays(*cols, tree.counts.numpy(), SMOKE_INDEX)
    # the default mesh: one entry per shard over make_scan_mesh's devices
    seen = []

    def fake_mesh(n_shards):
        seen.append(n_shards)
        return (torch.device("cpu"),)

    monkeypatch.setattr(SI, "make_scan_mesh", fake_mesh)
    again = SI.sharded_tree_from_arrays(*cols, tree.counts.numpy(),
                                        SMOKE_INDEX)
    assert seen == [2] and again.mesh == (torch.device("cpu"),) * 2
    assert SI.build_sharded(None, x, SMOKE_INDEX).mesh == \
        (torch.device("cpu"),)
    assert seen == [2, 1]


def test_ops_profiles_the_references_dispatchers():
    """``ops`` wraps in ``profiled`` the four dispatchers the reference
    wraps, by the same names, and no others."""
    root = PKG.parent
    ref = re.findall(r'profiled\("(\w+)"\)',
                     (root / "repro" / "kernels" / "ops.py").read_text())
    port = re.findall(r'profiled\("(\w+)"\)',
                      (PKG / "kernels" / "ops.py").read_text())
    assert len(ref) == 4 and sorted(ref) == sorted(port)
    for name in port:
        assert getattr(ops, name).__name__ == name


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
    block = [torch.zeros((2, 5, 8), dtype=torch.uint8, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        ops.mesh_scan(torch.zeros((2, 64), device="meta"), q, block,
                      [torch.zeros((2, 5, 64), device="meta")],
                      [torch.zeros((2, 5), dtype=torch.int32,
                                   device="meta")],
                      [torch.zeros((2, 5), dtype=torch.int32,
                                   device="meta")], None,
                      torch.zeros(2, device="meta"), SMOKE_INDEX)


def test_no_kernel_mode_override():
    src = "\n".join(p.read_text() for p in PKG.rglob("*.py"))
    assert "COCONUT_KERNEL_MODE" not in src
    assert "os.environ" not in (PKG / "kernels" / "ops.py").read_text()
