"""The port's serving launcher against the reference's, on the CPU.

* Step by step: the reference's decode loop, rebuilt here from its public
  ``make_prefill_step`` / ``make_serve_step`` / ``pad_cache`` /
  ``CoconutLSM`` as its ``launch/serve.py`` runs it, and the port's
  ``serve`` on the reference's weights (``params_from_reference``) and
  prompt: every step's logits, every ingested row (1e-5) and every probe
  micro-batch's ids (exact).  Both sides decode the reference's token
  stream; where the two top logits are further apart than the tolerance
  the port's own argmax must pick the same token.
* Both ``main``s for every branch of the command line (inline and
  ``--concurrent``; ``--data-dir`` made, reopened, and refused for the
  other layout; ``--shards`` with ``--scan-mode mesh``; ``--cache-mb``;
  ``--budget-leaves``; ``--checkpoint-every``; ``--trace-dir``;
  ``--metrics-interval``; ``--http-port``): the same report keys and the
  same counts.
"""
from __future__ import annotations

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as robs
import repro_torch.obs as tobs
from repro.configs import get as ref_get
from repro.core import SummaryConfig as RSummaryConfig
from repro.core.lsm import CoconutLSM as RCoconutLSM
from repro.core.summarization import znormalize as ref_znormalize
from repro.launch import serve as ref_serve_mod
from repro.models.steps import make_prefill_step as ref_prefill
from repro.models.steps import make_serve_step as ref_serve
from repro.models.steps import pad_cache as ref_pad
from repro.models.transformer import make_model as ref_model
from repro_torch.configs import get
from repro_torch.launch import serve as S
from repro_torch.models import params_from_reference

TOL = dict(rtol=2e-4, atol=2e-4)
STEPS, B, T, PROBE_BATCH = 12, 2, 8, 4


@pytest.fixture
def quiet_obs():
    """The launchers turn on tracing and install a query log in both
    packages' process-global state; put them back afterwards."""
    try:
        yield
    finally:
        for pkg in (robs, tobs):
            pkg.disable_tracing()
            pkg.install_query_log(None)


def reference_loop(arch: str):
    """serve.py's loop (the reference's ``main`` without its flags): the
    logits, tokens and rows of every step and each micro-batch's
    answers, with the weights and inputs it ran on."""
    cfg = ref_get(arch, smoke=True)
    model = ref_model(cfg)
    rng = jax.random.PRNGKey(0)
    params = model.init(rng)
    batch = {"tokens": jax.random.randint(rng, (B, T), 0,
                                          cfg.vocab_unpadded)}
    if cfg.frontend != "none":
        batch["frontend"] = jax.random.normal(
            rng, (B, cfg.frontend_tokens, cfg.d_model))
    prefill = jax.jit(ref_prefill(model))
    serve = jax.jit(ref_serve(model))
    last, cache = prefill(params, batch)
    cache = ref_pad(model, cache, extra=STEPS + 1)
    tokens = jnp.argmax(last, -1)[:, None]
    index = RCoconutLSM(RSummaryConfig(series_len=64, segments=16, bits=8),
                        buffer_capacity=64, leaf_size=32, mode="btp")
    base = T + (cfg.frontend_tokens
                if cfg.frontend != "none" and not cfg.is_encdec else 0)
    out = {"logits": [], "tokens": [], "rows": [], "answers": []}
    pending = []
    for s in range(STEPS):
        logits, cache = serve(params, cache, tokens, jnp.int32(base + s))
        tokens = jnp.argmax(logits[:, -1], -1)[:, None]
        h = np.asarray(ref_znormalize(
            logits[:, -1, :64].astype(jnp.float32)), np.float32)
        index.insert(h)
        pending.append(h[0])
        out["logits"].append(np.asarray(logits[:, -1], np.float32))
        out["tokens"].append(np.asarray(tokens))
        out["rows"].append(h)
        if len(pending) >= PROBE_BATCH:
            index.flush()
            d, off, _ = index.search_exact_batch(np.stack(pending), k=1,
                                                 window=64)
            out["answers"].append((np.asarray(d), np.asarray(off)))
            pending = []
    index.close()
    return cfg, params, batch, out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b",
                                  "phi-3-vision-4.2b"])
def test_serve_loop_matches_reference_step_by_step(arch):
    """recurrentgemma decodes past its window of 8; phi-3-vision carries
    frontend embeddings ahead of the prompt."""
    rcfg, params, batch, ref = reference_loop(arch)
    cfg = get(arch, smoke=True)
    args = S.build_parser().parse_args(
        ["--arch", arch, "--steps", str(STEPS), "--batch", str(B),
         "--prompt-len", str(T), "--probe-batch", str(PROBE_BATCH)])
    seen = []

    def on_step(s, logits, rows):
        got = logits[:, -1].float().numpy()
        want = ref["logits"][s]
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(rows, ref["rows"][s], rtol=1e-5,
                                   atol=1e-5)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * TOL["atol"]
        mine = got.argmax(-1)
        assert np.array_equal(mine[clear], ref["tokens"][s][clear, 0])
        seen.append(s)
        return torch.from_numpy(np.array(ref["tokens"][s])).long()

    frontend = (torch.from_numpy(np.array(batch["frontend"]))
                if "frontend" in batch else None)
    with contextlib.redirect_stdout(io.StringIO()):
        out = S.serve(cfg, args, device="cpu",
                      params=params_from_reference(
                          jax.tree.map(np.asarray, params), cfg,
                          device="cpu"),
                      prompt=torch.from_numpy(np.array(batch["tokens"])),
                      frontend=frontend, on_step=on_step)
    assert seen == list(range(STEPS))
    assert len(out["answers"]) == len(ref["answers"]) == STEPS // PROBE_BATCH
    for (probes, d, ids), (rd, rids) in zip(out["answers"], ref["answers"]):
        assert np.array_equal(ids, rids)
        np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5)
    assert out["report"]["ingest.rows_total"] == STEPS * B


def _report(text: str) -> dict:
    line = [ln for ln in text.splitlines() if ln.startswith("report: ")]
    assert len(line) == 1, text
    return dict(kv.split("=", 1) for kv in line[0][len("report: "):].split())


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue()


COUNTS = ("decode.steps_total", "probe.count_total", "ingest.rows_total",
          "probe.micro_batches_total")


def test_both_mains_every_branch(tmp_path, quiet_obs):
    base = ["--arch", "llama3.2-1b", "--steps", "8", "--batch", "2",
            "--probe-batch", "4"]
    branches = [
        ("inline", [], 1),
        ("observed", ["--budget-leaves", "2", "--metrics-interval", "0.001",
                      "--http-port", "0", "--trace-dir", "{d}/trace"], 1),
        ("durable", ["--concurrent", "--data-dir", "{d}/single",
                     "--cache-mb", "1", "--checkpoint-every", "3"], 2),
        ("sharded", ["--shards", "2", "--scan-mode", "mesh", "--concurrent",
                     "--data-dir", "{d}/sharded"], 2),
    ]
    for name, extra, runs in branches:
        reports = {}
        for side, main, kw in (("ref", ref_serve_mod.main, {}),
                               ("port", S.main, {"device": "cpu"})):
            d = tmp_path / side
            argv = base + [a.format(d=d) for a in extra]
            texts = [_run(main, argv, **kw) for _ in range(runs)]
            if runs == 2:       # the second run reopens what the first left
                assert "reopened" not in texts[0]
                assert "reopened" in texts[1], texts[1]
                tail = [ln for ln in texts[1].splitlines()
                        if ln.startswith("reopened")][0]
                assert "16 entries" in tail, tail
            reports[side] = [_report(t) for t in texts]
            if name == "observed":
                assert "gap max=" in texts[0]
                assert "metrics[exit]" in texts[0]
                assert (d / "trace" / "trace.json").exists()
                assert (d / "trace" / "WORKLOAD.json").exists()
        for r, p in zip(reports["ref"], reports["port"]):
            assert set(r) == set(p), name
            for key in COUNTS:
                assert r[key] == p[key], (name, key)
            if name == "sharded":
                assert int(p["query.mesh_launches_total"]) > 0
    # a directory of the other layout is refused by both
    for side, main, kw in (("ref", ref_serve_mod.main, {}),
                           ("port", S.main, {"device": "cpu"})):
        d = tmp_path / side
        with pytest.raises(SystemExit, match="unsharded"):
            _run(main, base + ["--shards", "2", "--data-dir",
                               str(d / "single")], **kw)
        with pytest.raises(SystemExit, match="sharded index"):
            _run(main, base + ["--data-dir", str(d / "sharded")], **kw)
        with pytest.raises(SystemExit, match="requires --data-dir"):
            _run(main, base + ["--cache-mb", "1"], **kw)
