"""Training launcher: --arch <id> with the fault-tolerant runtime.

``main`` runs the *smoke* config of the chosen arch end to end (token
pipeline -> train step -> checkpoints -> fault-tolerant loop), as the
reference's launcher does; ``train`` takes any ``ModelConfig``, so the
full configs run through it too.  The model, the batches and the state
live on the card unless the caller passes ``device="cpu"``.

Usage: PYTHONPATH=src python -m repro_torch.launch.train --arch \
           llama3.2-1b --steps 100 [--ckpt-dir /tmp/ck]
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Callable, Optional

from ..configs import ARCHS, get
from ..core.tree import _device_for
from ..data.tokens import TokenPipeline
from ..models.config import ModelConfig
from ..models.steps import init_train_state, make_train_step
from ..models.transformer import Model
from ..train.optimizer import AdamWConfig
from ..train.runtime import RuntimeConfig, TrainRuntime

__all__ = ["build_parser", "train", "main"]


def build_parser() -> argparse.ArgumentParser:
    """The reference launcher's command line, flag for flag."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    return ap


def train(cfg: ModelConfig, args: argparse.Namespace, *, device=None,
          remat: bool = False, microbatches: int = 1, log_every: int = 10,
          fault_hook: Optional[Callable[[int], None]] = None) -> dict:
    """Train ``cfg`` from weights drawn from seed 0 under the parsed
    flags ``args``: AdamW at lr 1e-3 with 10 warmup steps over
    ``--steps``, as the reference's launcher builds it; a checkpoint every
    ``--checkpoint-every`` steps under ``--ckpt-dir`` (a new temporary
    directory by default), resuming from the newest one there.

    ``device``: the card unless ``"cpu"`` is passed (no CUDA and no such
    request raises).  Prints the reference's report line and the first and
    last logged loss; returns ``{"report", "runtime", "model",
    "train_step", "data"}`` (the runtime holds the final state, every
    step's seconds and the logged metrics)."""
    dev = _device_for(None, device)
    model = Model(cfg, device=dev, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt_cfg=opt, remat=remat,
                           microbatches=microbatches)
    data = TokenPipeline(cfg.vocab_unpadded, batch=args.batch,
                         seq_len=args.seq,
                         frontend_tokens=cfg.frontend_tokens
                         if cfg.frontend != "none" else 0,
                         d_model=cfg.d_model, device=dev)
    ckdir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ck_")
    rt = TrainRuntime(step, state, data, ckdir,
                      RuntimeConfig(total_steps=args.steps,
                                    checkpoint_every=args.checkpoint_every,
                                    log_every=log_every),
                      fault_hook=fault_hook)
    if rt.try_resume():
        print(f"resumed from step {rt.step}")
    report = rt.run()
    print(f"arch={args.arch} ({cfg.name}) report={report}")
    if rt.metrics_log:
        print(f"loss {rt.metrics_log[0]['loss']:.3f} -> "
              f"{rt.metrics_log[-1]['loss']:.3f}")
    return {"report": report, "runtime": rt, "model": model,
            "train_step": step, "data": data}


def main(argv=None, *, device=None) -> dict:
    """The command line: ``--arch``'s SMOKE config through :func:`train`
    on ``device`` (the card unless ``"cpu"`` is passed)."""
    args = build_parser().parse_args(argv)
    return train(get(args.arch, smoke=True), args, device=device)


if __name__ == "__main__":
    main()
