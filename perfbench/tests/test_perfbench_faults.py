"""The comparison that decides ``correct`` fails what it must: each cell's
control (the reference in the program's place, a precision below the
configuration's), and a run with the timed path broken underneath, once
for each fault the cell can have (a step that leaves its state unchanged,
half of the batch left out, an answer altered where it is produced, a
budgeted search without its seeds, acknowledged rows hidden).
Driven through the harness on the CPU at a tiny size."""
import numpy as np
import pytest

from perfbench import run
from perfbench.tests.tiny import tiny_root  # noqa: F401

CELLS = ["tree-exact-q64", "lsm-window-q64", "tree-approx-b16"]


def _run(root, workload, **kw):
    return run.run_cell(workload, 2**31 + 901, 0.3, False, root=root,
                        device="cpu", t_start=0.0, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_root, workload):
    r = _run(tiny_root, workload, impl="control", requests=4)
    assert not r["correct"], r["checks"]


# -- faults of a search: the answers a batch returns --------------------------

def _stale(real):
    last = {}

    def f(*a, **kw):
        out = real(*a, **kw)
        prev = last.get("out")
        last["out"] = out
        return out if prev is None else prev
    return f


def _half(real):
    def f(self_or_tree, q, **kw):
        n = len(q) // 2
        d, o, st = real(self_or_tree, q[:n], **kw)
        return (np.concatenate([d, d[:len(q) - n]]),
                np.concatenate([o, o[:len(q) - n]]), st)
    return f


def _altered(real):
    def f(*a, **kw):
        d, o, st = real(*a, **kw)
        d = d.copy()
        d[0, 0] = d[0, 0] * (1 + 1e-3)
        return d, o, st
    return f


SEARCH_FAULTS = {"unchanged": _stale, "half": _half, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(SEARCH_FAULTS))
@pytest.mark.parametrize("workload", ["tree-exact-q64", "tree-approx-b16",
                                      "lsm-window-q64"])
def test_a_broken_search_is_not_correct(tiny_root, monkeypatch, workload,
                                        fault):
    if workload.startswith("tree"):
        from repro_torch.core import tree as T
        monkeypatch.setattr(T, "exact_search_batch",
                            SEARCH_FAULTS[fault](T.exact_search_batch))
    else:
        from repro_torch.ingest.snapshot import Snapshot
        monkeypatch.setattr(Snapshot, "search_exact_batch",
                            SEARCH_FAULTS[fault](Snapshot.search_exact_batch))
    r = _run(tiny_root, workload, requests=6)
    assert not r["correct"], r["checks"]


def _misplaced_seeds(real):
    """The seed probe at the start of the sorted order, whatever the
    query: the seeding skipped or cheapened."""
    def f(tree, queries, radius_leaves=1):
        idx = real(tree, queries, radius_leaves=radius_leaves)
        return idx - idx[:, :1]
    return f


def test_a_budgeted_search_without_its_seeds_is_not_correct(tiny_root,
                                                            monkeypatch):
    """A budgeted batch whose seed probe lands in the wrong place returns
    answers whose distances and gap are sound, but worse than the seeds
    the configuration guarantees."""
    from repro_torch.core import tree as T
    monkeypatch.setattr(T, "_seed_index", _misplaced_seeds(T._seed_index))
    r = _run(tiny_root, "tree-approx-b16", requests=6)
    assert not r["correct"], r["checks"]
    c = r["checks"]
    assert c["rescore_gap"]["value"] <= c["rescore_gap"]["limit"]
    assert c["gap_unsound"]["value"] <= c["gap_unsound"]["limit"]
    assert c["seed_unmet"]["value"] > c["seed_unmet"]["limit"]


# -- the configuration's guarantee: acknowledged rows are searchable -----------

def test_an_invisible_buffer_is_not_correct(tiny_root, monkeypatch):
    """The configuration's guarantee broken: acknowledged rows still in
    the buffer are not there to search."""
    from repro_torch.core.lsm import CoconutLSM
    real = CoconutLSM.snapshot
    monkeypatch.setattr(CoconutLSM, "snapshot",
                        lambda self, include_buffer=None: real(
                            self, include_buffer=False))
    r = _run(tiny_root, "lsm-window-q64", requests=4)
    assert not r["correct"], r["checks"]
