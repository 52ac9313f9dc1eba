"""Shared set-up of the benchmark's CPU tests: a checkout in a temporary
directory holding the program (a link to ``src``), a copy of
``perfbench`` and a ``BENCHMARK.json`` whose cells keep their traffic
kinds at sizes a CPU run holds in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TREE = {"rows": 20000, "leaf_size": 250}
TINY_LSM = {"buffer_rows": 2048, "leaf_size": 128}
TINY_MIX = {
    "exact-q64": {"queries": 8},
    "budget16-q64": {"queries": 8, "check_batches": 3},
    "window-q64": {"queries": 8, "prefill_rows": 15000, "batch_rows": 1024,
                   "windows": [512, 2048, 4096, 12000]},
}


def make_tiny_root(dest: Path) -> Path:
    """A checkout at ``dest`` with the benchmark's cells cut to CPU size."""
    dest.mkdir(parents=True, exist_ok=True)
    (dest / "src").symlink_to(ROOT / "src")
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        p = dest / c["file"]
        cfg = json.loads(p.read_text())
        cfg.update(TINY_TREE if cfg["index"] == "coconut_tree" else TINY_LSM)
        p.write_text(json.dumps(cfg))
    for name, upd in TINY_MIX.items():
        p = dest / "perfbench" / "traffic" / f"{name}.json"
        mix = json.loads(p.read_text())
        mix.update(upd)
        p.write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench") / "checkout")
