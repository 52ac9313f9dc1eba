"""The port's GPipe forward against the reference's, on the CPU.

The reference's ``pipeline_forward`` runs in one subprocess with four
host devices (as ``tests/test_distributed.py`` runs it), over meshes of
its first 1, 2 and 4 devices; the port runs the same numpy weights and
microbatches over device tuples of 1, 2 and 4 CPU entries.  Both equal
the sequential pass at 1e-5, and each other at 1e-5.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import pipeline_forward
from repro_torch.launch.mesh import make_stage_mesh

REPO = Path(__file__).resolve().parents[1]
M, B, D = 8, 2, 16
STAGES = (1, 2, 4)


def _inputs(S):
    rng = np.random.RandomState(S)
    W = (rng.randn(S, D, D) * 0.3).astype(np.float32)
    xs = rng.randn(M, B, D).astype(np.float32)
    return W, xs


def _stage_fn(w, x):
    return torch.tanh(x @ w)


def _sequential(W, xs):
    y = torch.from_numpy(xs)
    for s in range(W.shape[0]):
        y = _stage_fn(torch.from_numpy(W[s]), y)
    return y.numpy()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs for every stage count, from one process
    with four host devices."""
    d = tmp_path_factory.mktemp("pipe")
    for S in STAGES:
        W, xs = _inputs(S)
        np.savez(d / f"in_{S}.npz", W=W, xs=xs)
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro.distributed.pipeline import pipeline_forward
        assert len(jax.devices()) == 4
        for S in {STAGES!r}:
            z = np.load({str(d)!r} + f"/in_{{S}}.npz")
            mesh = Mesh(np.asarray(jax.devices()[:S]), ("pod",))
            pipe = pipeline_forward(mesh, lambda w, x: jnp.tanh(x @ w), S,
                                    axis="pod")
            y = pipe(jnp.asarray(z["W"]), jnp.asarray(z["xs"]))
            np.save({str(d)!r} + f"/out_{{S}}.npy", np.asarray(y))
        print("PIPE_OK")
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0 and "PIPE_OK" in r.stdout, r.stderr
    return {S: np.load(d / f"out_{S}.npy") for S in STAGES}


@pytest.mark.parametrize("S", STAGES)
def test_pipeline_matches_reference_and_sequential(reference, S):
    W, xs = _inputs(S)
    mesh = ("cpu",) * S
    pipe = pipeline_forward(mesh, _stage_fn, S)
    y = pipe(torch.from_numpy(W), torch.from_numpy(xs))
    assert y.shape == (M, B, D)
    np.testing.assert_allclose(y.numpy(), _sequential(W, xs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.numpy(), reference[S], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(reference[S], _sequential(W, xs), rtol=1e-5,
                               atol=1e-5)


def test_pipeline_schedule_and_dict_params():
    """Stage s runs microbatch m at tick m + s: every stage sees the
    microbatches in order, M calls each; a dict of stacked weights is
    sliced per stage."""
    S = 3
    rng = np.random.RandomState(7)
    W = {"w": torch.from_numpy((rng.randn(S, D, D) * 0.3).astype(np.float32)),
         "b": torch.from_numpy(rng.randn(S, D).astype(np.float32))}
    xs = torch.from_numpy(rng.randn(M, B, D).astype(np.float32))
    calls = []

    def fn(p, x):
        calls.append(int(p["tag"]) if "tag" in p else None)
        return torch.tanh(x @ p["w"] + p["b"])

    W["tag"] = torch.arange(S)
    y = pipeline_forward(("cpu",) * S, fn, S)(W, xs)
    want = xs
    for s in range(S):
        want = torch.tanh(want @ W["w"][s] + W["b"][s])
    assert torch.equal(y, want)
    assert sorted(calls) == sorted(list(range(S)) * M)
    with pytest.raises(ValueError, match="3 stages"):
        pipeline_forward(("cpu",) * 2, fn, S)


def test_stage_mesh():
    assert make_stage_mesh(4, devices=["cpu"]) == (torch.device("cpu"),) * 4
    devs = [torch.device("cpu", i) for i in range(2)]
    assert make_stage_mesh(4, devices=devs) == (devs[0], devs[0], devs[1],
                                                devs[1])
    assert make_stage_mesh(1, devices=devs) == (devs[0],)
    with pytest.raises(ValueError):
        make_stage_mesh(0, devices=devs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_stage_mesh(4)
