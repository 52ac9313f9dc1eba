"""The harness: every cell driven on the CPU at a tiny size, a cell,
configuration and metric added as files and entries alone, the
``BENCHMARK.json`` contract, and the import rule."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import ROOT, make_tiny_root, tiny_root  # noqa: F401

BENCH = ROOT / "perfbench"
CELLS = ["tree-exact-q64", "lsm-window-q64", "tree-approx-b16"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu(tiny_root, workload, trace):
    r = run.run_cell(workload, 2**31 + 77, 0.3, trace, root=tiny_root,
                     device="cpu", t_start=0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    if workload == "tree-approx-b16":    # the budgeted answers' quality
        assert set(r["checks"]) >= {"seed_unmet", "gap_unsound"}
        assert r["observed"]["checked_queries"] > 0
        assert 0 < r["observed"]["recall"] <= 1
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in run.cell_metrics(spec, workload, trace)}
    got = set(r["metrics"])
    if trace:    # the device's metrics need the card's trace
        assert got <= want and got
    else:
        assert got == want


def test_a_cell_config_mix_and_metric_added_as_files_only(tmp_path):
    root = make_tiny_root(tmp_path / "checkout")
    bench = root / "perfbench"
    cfg = json.loads((bench / "configs" / "coconut-tree-rw256.json")
                     .read_text())
    cfg.update(name="tree-small", rows=5000)
    (bench / "configs" / "tree-small.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "exact-q4.json").write_text(json.dumps(
        {"kind": "knn", "queries": 4, "k": 3, "noise": 0.1,
         "from_dataset": 0.5, "budget": None, "windows": None,
         "check_batches": None}))
    (bench / "checks" / "tree-small-q4.json").write_text(json.dumps(
        {"numbers": {"build_mismatch": {"limit": 0},
                     "kth_gap": {"limit": 1e-5},
                     "rescore_gap": {"limit": 1e-5}}}))
    (bench / "metrics" / "batches_done.py").write_text(
        "def read(win):\n    return len(win.records)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tree-small", "source": "a test",
                            "file": "perfbench/configs/tree-small.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tree-small-q4", "config":
                              "tree-small", "traffic": "exact-q4",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "batches_done", "unit": "batches",
                              "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "queries_per_s",
                              "workloads": ["tree-small-q4"]})
    for m in spec["end_to_end"]:
        if m["name"] == "queries_per_s":
            m["workloads"].append("tree-small-q4")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run.run_cell("tree-small-q4", 5, 0.2, True, root=root,
                     device="cpu", t_start=0.0)
    assert r["correct"]
    assert r["metrics"]["batches_done"]["value"] >= 1
    r = run.run_cell("tree-small-q4", 5, 0.2, False, root=root,
                     device="cpu", t_start=0.0)
    assert set(r["metrics"]) == {"queries_per_s", "setup_s"}


KIND = """
class Kind:
    def __init__(self, h, system):
        self.h, self.system, self.observed = h, system, {}

    def setup(self):
        self.system.setup()

    def step(self, i):
        q = self.h.traffic.queries(i, self.system.dataset, self.h.device)
        t0 = self.h.clock()
        d, o, gap, st = self.system.search(q[:1].numpy(), 1, None, None)
        return {"t0": t0, "t1": self.h.clock(), "units": 1, "stats": st,
                "sorted_rows": self.system.sorted_rows()}

    def checks(self):
        return dict(self.system.after_window(), answered_wrong=0)
"""


def test_a_kind_of_traffic_added_as_a_file(tmp_path):
    """A new kind of traffic is a file under ``perfbench/kinds`` that the
    harness finds by the mix's ``kind``, with its mix and its cell."""
    root = make_tiny_root(tmp_path / "checkout")
    bench = root / "perfbench"
    (bench / "kinds" / "one-by-one.py").write_text(KIND)
    (bench / "traffic" / "single-q1.json").write_text(json.dumps(
        {"kind": "one-by-one", "queries": 4}))
    (bench / "checks" / "tree-single.json").write_text(json.dumps(
        {"numbers": {"build_mismatch": {"limit": 0},
                     "answered_wrong": {"limit": 0}}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tree-single", "config":
                              "coconut-tree-rw256", "traffic": "single-q1",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"] = [m for m in spec["end_to_end"]
                          if m["name"] == "setup_s"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run.run_cell("tree-single", 5, 0.2, False, root=root, device="cpu",
                     t_start=0.0)
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("name, want", [
    ("device_idle_pct", "device_idle_pct.py"),
    ("device_idle_pct.ingest", "device_idle_pct.py"),
    ("queries_per_s", "queries_per_s.py"),
    ("a_new.metric", "a_new.metric.py"),
])
def test_a_metric_finds_its_reader(tmp_path, name, want):
    """A metric's own file, or for ``<metric>.<part>`` the reader of
    ``<metric>``, so that a quantity split by what it moves needs no new
    reader."""
    for f in ("device_idle_pct.py", "queries_per_s.py", "a_new.metric.py"):
        (tmp_path / f).write_text("def read(win):\n    return None\n")
    assert run.reader_path(tmp_path, name) == tmp_path / want


def test_without_the_program_or_a_card_no_result(tmp_path):
    """A directory with only BENCHMARK.json and perfbench: exit 2, no
    line on standard output; likewise without a card."""
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    import shutil
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for cwd in (tmp_path, ROOT):
        p = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "tree-exact-q64", "--seed", "1", "--seconds", "1"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        if cwd == ROOT and torch.cuda.is_available():
            continue
        assert p.returncode != 0 and p.stdout == "", p.stderr


# ---------------------------------------------------------------------------
# the contract of BENCHMARK.json
# ---------------------------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert spec["paths"] == ["perfbench"]
    assert spec["command"] == ["python3", "perfbench/run.py"]
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells, 14 runs each, fits in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    four = 0
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        four += w["chips"] == 4
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "kinds" / f"{mix['kind']}.py").is_file()
        assert (BENCH / "checks" / f"{w['name']}.json").is_file()
        cells.add(w["name"])
    assert four <= max(1, len(cells) // 4)
    assert {w["config"] for w in spec["workloads"]} == names
    metric_names = set()
    e2e = {}
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in metric_names
        metric_names.add(m["name"])
        assert run.reader_path(BENCH / "metrics", m["name"]).is_file()
        assert set(m.get("workloads", [])) <= cells
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in cells:      # every cell: setup_s, another e2e, a per-layer
        assert sum(c in ws for n, ws in e2e.items() if n != "setup_s") >= 1
        assert any(c in m["workloads"] for m in spec["per_layer"])


# ---------------------------------------------------------------------------
# the import rule
# ---------------------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_top_level_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_no_file_imports_jax_or_the_reference_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "summaries.py", "walks.py", "counts.py",
                 "traffic.py", "trace.py", "kinds/knn.py"):
        assert "repro_torch" not in set(_imports(BENCH / name)), name


def test_nothing_reads_the_old_benchmarks():
    for f in sorted(BENCH.rglob("*.py")):
        if f.parent.name == "tests":
            continue
        src = f.read_text()
        assert "benchmarks/" not in src and "BENCH_" not in src, f


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from perfbench import run\n"
            "r = run.run_cell('tree-approx-b16', 3, 0.2, False, root=%r, "
            "device='cpu')\n"
            "assert r['correct']\n"
            "print(run.forbidden_modules())\n"
            % (str(ROOT), str(ROOT / "src"), str(tiny_root)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
