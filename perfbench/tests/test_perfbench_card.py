"""The benchmark on the card: a short run of a cell is correct.  Needs a
CUDA device and skips without one; run on the card with
``python -m pytest -q perfbench/tests/test_perfbench_card.py``."""
import pytest
import torch

from perfbench import run


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark runs on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("workload", ["tree-approx-b16", "lsm-window-q64"])
def test_a_short_run_on_the_card_is_correct(cuda, workload):
    r = run.run_cell(workload, 2**31 + 5, 3.0, False, t_start=0.0)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
