"""The port's sharded steps on the multi-pod mesh's three axes, on the CPU.

Eight gloo ranks (``python -c`` subprocesses on a ``FileStore`` under
``tmp_path``) on a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh.  SMOKE
``llama3.2-1b``, ``granite-moe-1b-a400m``, ``mamba2-2.7b``,
``recurrentgemma-2b`` (its sequence past its window) and
``seamless-m4t-medium`` (with its audio frontend) in fp32 each take one
sharded train step (batch 8 x 16, 2 microbatches, remat; ``shard_state``
+ ``sh``; the loss vocab-parallel) whose loss, grad norm and updated
parameters equal the unsharded step's at rtol = atol = 1e-5; then each
one's sharded prefill and one decode token equal the unsharded ones.  The
mesh is ``make_pod_mesh``'s, laid out as ``("pod+data", "model")`` dims:
on three mesh dims DTensor's search for a matmul's placements in the
backward took over a minute an op.

Each rank arms ``faulthandler.dump_traceback_later``, so a rank that
stalls exits with its stack on its stderr, which the failure shows; the
parent waits with a timeout of its own.  The harness (:func:`run_ranks`)
also runs ``tests/test_torch_dryrun.py``'s ``(2, 2)`` case.  Nothing here
imports the JAX package: the file runs wherever the port does.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import (Model, init_train_state, make_prefill_step,
                                make_serve_step, make_train_step, pad_cache)

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-5, atol=1e-5)
GLOO_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m", "mamba2-2.7b",
              "recurrentgemma-2b", "seamless-m4t-medium")
T = 16                 # past recurrentgemma's SMOKE window of 8
POD_SHAPE, POD_NAMES = (2, 2, 2), ("pod", "data", "model")
POD_B = 8              # 2 microbatches of a row for each of 4 DP ranks
RANK_STALL_S = 240     # a rank dumps its stack and exits after this
PARENT_S = 270         # the parent's wait for all ranks (under the
                       # suite's 300 s a test)


def batch_for(cfg, B: int):
    """The train batch, with frontend frames for an arch that has one."""
    batch = TokenPipeline(cfg.vocab_unpadded, B, T, seed=3,
                          device="cpu")(0)
    if cfg.frontend != "none":
        g = torch.Generator().manual_seed(5)
        batch["frontend"] = 0.1 * torch.randn(
            (B, cfg.frontend_tokens, cfg.d_model), generator=g)
    return batch


def decode_pos(cfg):
    return T + (cfg.frontend_tokens
                if cfg.frontend != "none" and not cfg.is_encdec else 0)


_RANK = r"""
import faulthandler, sys
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
shape = tuple(int(n) for n in sys.argv[5].split("x"))
names, archs = tuple(sys.argv[6].split(",")), sys.argv[7].split(",")
B = int(sys.argv[8])
faulthandler.dump_traceback_later(float(sys.argv[9]), exit=True)
sys.path.insert(0, sys.argv[10])
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get
from repro_torch.launch.mesh import make_pod_mesh
from repro_torch.launch.sharding import (batch_placements, make_shardings,
                                         shard_state)
from repro_torch.models import (Model, init_train_state, make_prefill_step,
                                make_serve_step, make_train_step, pad_cache)
from test_torch_pod import batch_for, decode_pos
mesh = make_pod_mesh(shape, names, "cpu")
res = {}
for arch in archs:
    cfg = get(arch, smoke=True)
    model = Model(cfg, device="cpu", seed=0)
    batch = batch_for(cfg, B)
    pl = batch_placements(mesh, batch, B)
    sharded = {k: distribute_tensor(v, mesh, pl[k])
               for k, v in batch.items()}
    state = shard_state(init_train_state(model), mesh)
    step = make_train_step(model, sh=make_shardings(mesh), microbatches=2,
                           remat=True)
    state, met = step(state, sharded)
    r = {"loss": met["loss"].full_tensor(),
         "grad_norm": met["grad_norm"].full_tensor(),
         "params": {k: v.detach().full_tensor()
                    for k, v in state["params"].items()}}
    logits, cache = make_prefill_step(model, sh=make_shardings(mesh))(
        {k: v for k, v in sharded.items() if k != "labels"})
    with implicit_replication():
        cache = pad_cache(model, cache, 2)
    tok = distribute_tensor(batch["tokens"][:, :1], mesh, pl["tokens"])
    dlog, _ = make_serve_step(model, sh=make_shardings(mesh, sp=False))(
        cache, tok, decode_pos(cfg))
    r["prefill"] = logits.detach().full_tensor()
    r["decode"] = dlog.detach().full_tensor()
    res[arch] = r
if rank == 0:
    torch.save(res, out)
dist.destroy_process_group()
"""


def run_ranks(tmp: Path, shape, names, archs, B: int, *,
              stall_s: float = RANK_STALL_S, wait_s: float = PARENT_S):
    """One gloo process a rank of a ``shape`` mesh named ``names``; each
    arch's sharded train step, prefill and decode token, as rank 0 saves
    them (``{arch: {"loss", "grad_norm", "params", "prefill",
    "decode"}}``).  A rank's output goes to files under ``tmp``, so no
    pipe fills while the parent waits."""
    world = math.prod(shape)
    out = tmp / "sharded.pt"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    logs = [(open(tmp / f"rank{r}.out", "w"),
             open(tmp / f"rank{r}.err", "w")) for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), str(tmp / "store"),
         str(out), "x".join(map(str, shape)), ",".join(names),
         ",".join(archs), str(B), str(stall_s), str(Path(__file__).parent)],
        env=env, stdout=o, stderr=e) for r, (o, e) in enumerate(logs)]
    deadline = time.monotonic() + wait_s
    try:
        for p in procs:
            p.communicate(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o, e in logs:
            o.close()
            e.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            (f"rank {r} of {shape} exited {p.returncode}:\n"
             + (tmp / f"rank{r}.err").read_text()[-6000:])
    return torch.load(out)


def unsharded(arch, B: int):
    """The plain step from the same weights and batch: (model, batch,
    state, metrics)."""
    cfg = get(arch, smoke=True)
    model = Model(cfg, device="cpu", seed=0)
    batch = batch_for(cfg, B)
    state = init_train_state(model)
    state, met = make_train_step(model, microbatches=2, remat=True)(
        state, batch)
    return model, batch, state, met


def check_train_step(got, arch, B: int):
    _, _, state, met = unsharded(arch, B)
    torch.testing.assert_close(got["loss"], met["loss"], **TOL)
    torch.testing.assert_close(got["grad_norm"], met["grad_norm"], **TOL)
    assert set(got["params"]) == set(state["params"])
    for k, v in state["params"].items():
        torch.testing.assert_close(got["params"][k], v.detach(), **TOL,
                                   msg=k)


def check_prefill_and_decode(got, arch, B: int):
    model, batch, _, _ = unsharded(arch, B)
    with torch.no_grad():
        logits, cache = make_prefill_step(model)(
            {k: v for k, v in batch.items() if k != "labels"})
        cache = pad_cache(model, cache, 2)
        dlog, _ = make_serve_step(model)(cache, batch["tokens"][:, :1],
                                         decode_pos(get(arch, smoke=True)))
    torch.testing.assert_close(got["prefill"], logits, **TOL)
    torch.testing.assert_close(got["decode"], dlog, **TOL)


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("pod"), POD_SHAPE, POD_NAMES,
                     GLOO_ARCHS, POD_B)


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_pod_sharded_train_step_equals_unsharded(pod_run, arch):
    check_train_step(pod_run[arch], arch, POD_B)


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_pod_sharded_prefill_and_decode_equal_unsharded(pod_run, arch):
    check_prefill_and_decode(pod_run[arch], arch, POD_B)
