"""The port's fault tolerance, checkpoints, compression and token
pipeline: each case of the reference's ``tests/test_train_runtime.py`` on
the port (toy scale, on the CPU), and the launcher.

A port train step updates the state's tensors in place (the reference's
jitted step returns new arrays), so a case that runs two histories from
one initial state clones it first.
"""
from __future__ import annotations

import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as LT
from repro_torch.models import Model, init_train_state, make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import (CompressionConfig,
                                           compress_grads, compress_init,
                                           modeled_wire_bytes)
from repro_torch.train.runtime import RuntimeConfig, TrainRuntime

CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                  param_dtype="float32")


def clone(tree):
    """A state with every tensor copied (a second, independent history)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture()
def setup(tmp_path):
    model = Model(CFG, device="cpu", seed=0)
    state = init_train_state(model)
    step = make_train_step(model, remat=False)
    data = TokenPipeline(CFG.vocab, batch=4, seq_len=16, seed=1,
                         device="cpu")
    return model, state, step, data, tmp_path


def test_checkpoint_roundtrip(setup):
    model, state, step, data, tmp = setup
    mgr = CheckpointManager(tmp / "ckpt", keep=2, async_save=False)
    state2, _ = step(state, data(0))
    mgr.save(1, state2)
    restored, at = mgr.restore(state2)
    assert at == 1
    meta = json.loads((tmp / "ckpt" / "step_00000001" /
                       "meta.json").read_text())
    assert meta["step"] == 1 and "time" in meta
    assert meta["leaves"] == sorted(k for k, _ in leaves(state2))
    assert "params/layers.0.attn.wq" in meta["leaves"]
    for (ka, a), (kb, b) in zip(leaves(state2), leaves(restored)):
        assert ka == kb and a.dtype == b.dtype
        assert a is not b
        assert torch.equal(a, b), ka


def test_checkpoint_gc_and_atomicity(setup):
    model, state, step, data, tmp = setup
    mgr = CheckpointManager(tmp / "ckpt", keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.steps() == [3, 4]
    # a .tmp dir (simulated crash mid-save) must be invisible to restore
    (tmp / "ckpt" / "step_00000099.tmp").mkdir()
    assert mgr.latest_step() == 4


def test_async_checkpoint(setup):
    model, state, step, data, tmp = setup
    mgr = CheckpointManager(tmp / "ckpt", keep=3, async_save=True)
    mgr.save(1, state)
    mgr.wait()
    assert mgr.steps() == [1]


def test_async_checkpoint_snapshots_synchronously(setup):
    """The host snapshot is taken inside ``save``: a step that updates the
    state in place right after does not reach the checkpoint."""
    model, state, step, data, tmp = setup
    mgr = CheckpointManager(tmp / "ckpt", keep=3, async_save=True)
    before = clone(state)
    mgr.save(1, state)
    step(state, data(0))
    mgr.wait()
    restored, _ = mgr.restore(state)
    for (k, a), (_, b) in zip(leaves(before), leaves(restored)):
        assert torch.equal(a, b), k


def test_fault_injection_restart(setup):
    """Crash at steps 7 and 13; the loop must resume from checkpoints and
    finish all 20 steps with restarts recorded."""
    model, state, step, data, tmp = setup
    crashed = set()

    def fault_hook(s):
        if s in (7, 13) and s not in crashed:
            crashed.add(s)
            raise RuntimeError(f"injected fault at {s}")

    rt = TrainRuntime(step, state, data, tmp / "ck",
                      RuntimeConfig(total_steps=20, checkpoint_every=5,
                                    log_every=5),
                      fault_hook=fault_hook)
    report = rt.run()
    assert report["final_step"] == 20
    assert report["restarts"] == 2
    assert report["checkpoints"] >= 3
    losses = [m["loss"] for m in rt.metrics_log]
    assert all(np.isfinite(l) for l in losses)


def test_resume_reproducibility(setup):
    """Stateless pipeline + checkpoint => identical state with/without a
    mid-run restart (exactly-once step semantics)."""
    model, state, step, data, tmp = setup

    # uninterrupted run of 10
    s_ref = clone(state)
    for i in range(10):
        s_ref, _ = step(s_ref, data(i))

    # interrupted run: 5 steps, checkpoint, "crash", resume, 5 more
    mgr = CheckpointManager(tmp / "ck2", async_save=False)
    s = clone(state)
    for i in range(5):
        s, _ = step(s, data(i))
    mgr.save(5, s)
    restored, at = mgr.restore(s)
    for i in range(at, 10):
        restored, _ = step(restored, data(i))

    for (k, a), (_, b) in zip(leaves(s_ref), leaves(restored)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   rtol=2e-5, atol=2e-5, err_msg=k)


def test_straggler_detection(setup):
    model, state, step, data, tmp = setup
    calls = {"n": 0}
    real_step = step

    def slow_step(st, b):
        calls["n"] += 1
        if calls["n"] == 10:
            time.sleep(1.0)       # synthetic straggler
        return real_step(st, b)

    rt = TrainRuntime(slow_step, state, data, tmp / "ck3",
                      RuntimeConfig(total_steps=12, checkpoint_every=100,
                                    straggler_factor=3.0))
    rt.run()
    assert rt.stragglers >= 1


def test_compression_error_feedback():
    rng = np.random.RandomState(0)
    grads = {"w": torch.from_numpy(rng.randn(64, 64).astype(np.float32))}
    res = compress_init(grads)
    cfg = CompressionConfig(ratio=0.05)
    comp, res2, stats = compress_grads(grads, res, cfg)
    # sparsity honored
    nz = int(torch.sum(comp["w"] != 0))
    assert nz <= max(int(0.05 * 64 * 64), 32) + 1
    # compressed + residual == original (lossless accounting)
    np.testing.assert_allclose((comp["w"] + res2["w"]).numpy(),
                               grads["w"].numpy(), rtol=1e-6, atol=1e-6)
    assert modeled_wire_bytes(stats) < 64 * 64 * 4 * 0.15
    # over repeated rounds nothing is lost: sum(sent) + residual == sum(grads)
    total = torch.zeros_like(grads["w"])
    res = compress_init(grads)
    for _ in range(80):
        comp, res, _ = compress_grads(grads, res, cfg)
        total = total + comp["w"]
    np.testing.assert_allclose((total + res["w"]).numpy(),
                               (80 * grads["w"]).numpy(), rtol=1e-3,
                               atol=1e-3)
    # and the residual is bounded (error feedback does not diverge)
    assert float(res["w"].abs().max()) < 80 * float(grads["w"].abs().max())


def test_elastic_restore_onto_a_device(setup):
    """Restore onto a named device (the reference's resharding restore):
    every tensor lands there with its bits; a bf16 state round-trips bit
    for bit through its uint16 bits."""
    model, state, step, data, tmp = setup
    mgr = CheckpointManager(tmp / "ck4", async_save=False)
    mgr.save(1, state)
    restored, _ = mgr.restore(state, device="cpu")
    assert all(t.device.type == "cpu" for _, t in leaves(restored))
    for (k, a), (_, b) in zip(leaves(state), leaves(restored)):
        assert torch.equal(a, b), k

    bf = Model(ModelConfig(**{**CFG.__dict__, "param_dtype": "bfloat16"}),
               device="cpu", seed=3)
    bstate = init_train_state(bf)
    make_train_step(bf, remat=False)(bstate, data(0))
    mgr.save(2, bstate)
    meta = json.loads((tmp / "ck4" / "step_00000002" /
                       "meta.json").read_text())
    assert meta["dtypes"]["params/embed"] == "bfloat16"
    assert "opt/m/embed" not in meta["dtypes"]          # fp32 moments
    back, at = mgr.restore(bstate)
    assert at == 2
    for (k, a), (_, b) in zip(leaves(bstate), leaves(back)):
        assert a.dtype == b.dtype, k
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k
        else:
            assert torch.equal(a, b), k


def test_restored_state_trains_the_model(setup):
    """A restored state holds new tensors; the step binds them into the
    model, so its parameters are the restored ones from then on."""
    model, state, step, data, tmp = setup
    mgr = CheckpointManager(tmp / "ck5", async_save=False)
    step(state, data(0))
    mgr.save(1, state)
    restored, _ = mgr.restore(state)
    restored, _ = step(restored, data(1))
    for name, p in model.named_parameters():
        assert restored["params"][name] is p
    assert int(restored["opt"]["step"]) == 2


def test_token_pipeline_is_a_function_of_seed_and_step():
    vocab, b, t = 97, 3, 40
    pipe = TokenPipeline(vocab, b, t, seed=5, device="cpu")
    a, again = pipe(7), pipe(7)
    other = TokenPipeline(vocab, b, t, seed=5, device="cpu")
    for k in ("tokens", "labels"):
        assert torch.equal(a[k], again[k]) and torch.equal(a[k],
                                                            other(7)[k])
    assert not torch.equal(a["tokens"], pipe(8)["tokens"])
    assert not torch.equal(a["tokens"],
                           TokenPipeline(vocab, b, t, seed=6,
                                         device="cpu")(7)["tokens"])
    # re-seek: any order of steps gives the same batches
    seq = [pipe(s)["tokens"] for s in range(4)]
    back = [pipe(s)["tokens"] for s in (3, 1, 0, 2)]
    for s, x in zip((3, 1, 0, 2), back):
        assert torch.equal(seq[s], x)
    toks, labels = a["tokens"], a["labels"]
    assert toks.shape == (b, t) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab
    assert torch.equal(labels[:, :-1], toks[:, 1:])
    assert bool((labels[:, -1] == 0).all())
    jumps = (toks[:, 1:] - toks[:, :-1]) % vocab
    assert int(jumps.max()) < 17                     # the Markov stream
    fe = TokenPipeline(vocab, b, t, seed=5, frontend_tokens=6, d_model=8,
                       device="cpu")(7)
    assert fe["frontend"].shape == (b, 6, 8)
    assert fe["frontend"].dtype == torch.float32
    assert 0.03 < float(fe["frontend"].std()) < 0.3


def test_launcher_main_trains_and_resumes(tmp_path):
    """``main`` trains the SMOKE config with checkpoints; a second run on
    the same directory resumes from its newest step.  Without CUDA and no
    ``device="cpu"`` it raises."""
    argv = ["--arch", "llama3.2-1b", "--steps", "12", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "5"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LT.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            TokenPipeline(8, 1, 4)
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = LT.main(argv, device="cpu")
    text = buf.getvalue()
    assert out["report"] == {"final_step": 12, "restarts": 0,
                             "stragglers": out["report"]["stragglers"],
                             "checkpoints": 2}
    assert "arch=llama3.2-1b (llama3.2-1b-smoke) report=" in text
    assert "loss " in text and " -> " in text
    log = out["runtime"].metrics_log
    assert [r["step"] for r in log] == [1, 10]
    assert log[-1]["loss"] < log[0]["loss"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        again = LT.main(argv[:3] + ["20"] + argv[4:], device="cpu")
    assert "resumed from step 10" in buf.getvalue()
    assert again["report"]["final_step"] == 20
