"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step.

For each cell this script:
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod,
     laid out as 32x16 with pod and data one dim: ``launch/mesh.py``)
     over a fake process group of 512 ranks in this one process (the
     counterpart of ``--xla_force_host_platform_device_count``; the
     single-pod mesh is its leading 256 ranks),
  2. resolves the architecture config for the mesh's TP degree (head/vocab
     padding; none under the dp policy),
  3. lays the model out on the meta device (no weight is allocated) and
     its state over the mesh by ``shard_state`` (DTensor placements, the
     reference's ``in_shardings``),
  4. runs the cell's step (train with remat and the registry's
     microbatches, moment and accumulation dtypes; prefill; one decode
     token against ``decode_cache_specs``) on meta DTensors, under
     ``MemTracker`` (the peak a device) and the local trace of
     ``launch/hlo.py`` (each rank's collectives, bytes accessed and
     FLOPs, by ``FlopCounterMode``'s formulas: a device's own),
  5. records memory, cost, collective traffic and the roofline terms into
     build/dryrun/<arch>_<shape>_<mesh>.json.

Failures here (sharding mismatch, an op DTensor cannot place) are bugs in
the system — the point of the exercise; a failed cell is recorded and the
run exits 1.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from ..configs import ARCHS, get
from ..configs.registry import (GRAD_ACCUM_DTYPE, OPT_MOMENT_DTYPE,
                                TRAIN_MICROBATCHES)
from ..configs.shapes import (SHAPES, ShapeSpec, applicable, input_specs,
                              skip_reason)
from ..models import (Model, init_train_state, make_prefill_step,
                      make_serve_step, make_train_step)
from ..models.layers import dtype_of
from ..train.optimizer import AdamWConfig
from .flops import model_flops_6nd, step_flops
from .hlo import LocalTrace, collective_stats
from .mesh import make_production_mesh, tp_axis
from .sharding import (_tree_map, batch_placements, cache_placements,
                       make_shardings, shard_state)

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "build" / "dryrun"
OPT_DIR = ROOT / "build" / "dryrun_opt"

# archs whose largest layer fits a single device use pure DP+FSDP for
# train/prefill — no TP activation collectives at all.
DP_POLICY_MAX_PARAMS = 8e9

# the reference's per-family result: dropping intra-block constraints
# ("lean") helped MoE and hurt very large dense TP.
OPT_SHARDING_MODE = {"moe": "lean"}

# NVIDIA H100 SXM 80GB (data sheet, 700 W) for the roofline terms
CARD = "NVIDIA H100 SXM 80GB"
PEAK_FLOPS = 989e12          # dense bf16
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # fits_80gb: the peak a device at most this
NVLINK_BW = 450e9            # bytes/s a direction, a group within a node
NET_BW = 50e9                # bytes/s, one 400 Gb/s port a GPU, a group
                             # that crosses nodes
GPUS_PER_NODE = 8


def init_fake_world(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this process (this
    rank is 0): collectives return at once, tensors stay where they are.
    For a dry run only; ``main`` calls it, and tests and scripts that
    call ``run_cell`` call it first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _leaves(tree):
    out = []
    _tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor)
              else None, tree)
    return out


def local_bytes(tree) -> int:
    """Bytes a device holds of a tree of (D)Tensors: its local shards."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _leaves(tree))


def _distribute(tree, placements, mesh):
    from torch.distributed.tensor import distribute_tensor

    def go(t, pl):
        if isinstance(t, dict):
            return {k: go(v, pl[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(a, b) for a, b in zip(t, pl))
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh, pl)

    return go(tree, placements)


@contextlib.contextmanager
def _propagation_unseen():
    """DTensor works out each new op's output shape by running it once on
    tensors of the global shapes (fake tensors in some torch versions,
    plain meta tensors in others): no rank executes that, so it runs with
    the dispatch modes off and neither the memory tracker nor the trace
    sees it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def unseen(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)

    setattr(ShardingPropagator, name, unseen)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _storages(tree) -> set:
    return {_local(t).untyped_storage()._cdata for t in _leaves(tree)}


def run_cell(arch: str, shape: str, mesh_kind: str,
             microbatches: Optional[int] = None, save: bool = True,
             verbose: bool = True, opt: bool = False,
             spec: Optional[ShapeSpec] = None, mesh=None) -> dict:
    """Trace one cell on the initialized (fake) process group.  ``spec``
    replaces the named shape and ``mesh`` the production mesh (a cell cut
    to one card: ``chip_smoke.py`` phase 21)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    t0 = time.time()
    base_cfg = get(arch)
    ss = spec or SHAPES[shape]
    if not applicable(base_cfg, ss.name):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped", "reason": skip_reason(base_cfg,
                                                           ss.name)}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    names = tuple(mesh.mesh_dim_names)
    n_chips = mesh.size()
    tp_n = mesh.shape[names.index(tp_axis(mesh))]
    # --- optimization bundle: policy / constraint mode / attention
    policy, sh_mode = "tp", "baseline"
    if opt:
        sh_mode = OPT_SHARDING_MODE.get(base_cfg.family, "baseline")
        # pure DP needs the global batch to divide the device count —
        # otherwise the batch silently replicates
        if ss.step in ("train", "prefill") \
                and base_cfg.param_count() <= DP_POLICY_MAX_PARAMS \
                and ss.global_batch % n_chips == 0:
            policy = "dp"
        base_cfg = dataclasses.replace(base_cfg, attn_dense_threshold=2048)
    cfg = base_cfg if policy == "dp" else base_cfg.resolve_for_tp(tp_n)
    kind, kwargs = input_specs(cfg, ss.name, spec=ss)
    model = Model(cfg, device="meta")
    mb = None

    if kind == "train":
        mb = microbatches or TRAIN_MICROBATCHES.get(arch, 1)
        sh = make_shardings(mesh, sp=(policy != "dp"),
                            mode=sh_mode if policy != "dp" else "dp")
        moment_dt = OPT_MOMENT_DTYPE.get(arch, "float32")
        accum_dt = GRAD_ACCUM_DTYPE.get(arch, "float32")
        opt_cfg = AdamWConfig(moment_dtype=moment_dt)
        step = make_train_step(model, sh=sh, microbatches=mb, remat=True,
                               opt_cfg=opt_cfg,
                               accum_dtype=dtype_of(accum_dt))
        state = shard_state(init_train_state(model, opt_cfg), mesh, policy)
        batch = _distribute(kwargs["batch"], batch_placements(
            mesh, kwargs["batch"], ss.global_batch, policy), mesh)
        args = (state, batch)

        def run():
            return step(state, batch)
    elif kind == "prefill":
        sh = make_shardings(mesh, sp=(policy != "dp"),
                            mode=sh_mode if policy != "dp" else "dp")
        shard_state(model, mesh, policy)
        batch = _distribute(kwargs["batch"], batch_placements(
            mesh, kwargs["batch"], ss.global_batch, policy), mesh)
        step = make_prefill_step(model, sh=sh)
        args = (dict(model.named_parameters()), batch)

        def run():
            return step(batch)
    else:  # decode
        dp = n_chips // tp_n
        shardable = ss.global_batch % dp == 0
        if opt:
            sh_mode = "decode2d"
        sh = make_shardings(mesh, sp=False, batch_shardable=shardable,
                            mode=sh_mode)
        shard_state(model, mesh)
        cache = _distribute(kwargs["cache"], cache_placements(
            mesh, kwargs["cache"], cfg, ss.global_batch), mesh)
        tokens = _distribute(kwargs["tokens"], batch_placements(
            mesh, kwargs["tokens"], ss.global_batch), mesh)
        step = make_serve_step(model, sh=sh)
        args = (dict(model.named_parameters()), cache, tokens)

        def run():
            return step(cache, tokens, kwargs["pos"])

    arg_bytes = local_bytes(args)
    t_setup = time.time() - t0
    trace = LocalTrace()
    mem = MemTracker()
    mem.track_external(*_leaves(args))
    with _propagation_unseen(), mem, trace:
        out = run()
    t_trace = time.time() - t0 - t_setup
    peak = max(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    out_leaves = _leaves(out)
    alias = _storages(args)
    out_bytes = local_bytes(out_leaves)
    alias_bytes = sum(_local(t).numel() * _local(t).element_size()
                      for t in out_leaves
                      if _local(t).untyped_storage()._cdata in alias)
    coll = collective_stats(trace, GPUS_PER_NODE)

    flops = float(trace.flops)
    bytes_acc = float(trace.bytes_accessed)
    # the traced FLOPs are what this rank's local ops execute; the
    # analytic model supplies the executed step's FLOPs over all devices.
    # The compute term takes the max of both, per device.
    analytic_global = step_flops(cfg, ss.global_batch, ss.seq_len, kind,
                                 remat=(kind == "train"))
    flops_dev = max(flops, analytic_global / n_chips)
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    intra = coll.link_bytes - coll.link_bytes_inter_node
    collective_s = intra / NVLINK_BW + coll.link_bytes_inter_node / NET_BW
    model_flops = model_flops_6nd(cfg, ss.global_batch, ss.seq_len, kind)

    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "status": "ok", "step_kind": kind,
        "optimized": opt, "policy": policy, "sharding_mode": sh_mode,
        "n_chips": n_chips,
        "microbatches": mb,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias_bytes,
            "temp_size_in_bytes": peak - arg_bytes,
            "peak_memory_in_bytes": peak,
            "fits_80gb": peak <= HBM_BYTES,
        },
        "cost": {"flops": flops, "bytes accessed": bytes_acc},
        "collectives": coll.as_dict(),
        "roofline": {
            "card": CARD,
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max(
                (("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)), key=lambda kv: kv[1])[0],
            "model_flops_global": model_flops,
            "traced_flops_per_device": flops,
            "analytic_flops_global": analytic_global,
            "useful_flop_ratio":
                model_flops / max(analytic_global, 1.0),
        },
        "timings": {"setup_s": t_setup, "trace_s": t_trace},
    }
    if save:
        out_dir = OPT_DIR if opt else OUT_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{arch}_{shape}_{mesh_kind}.json"
        path.write_text(json.dumps(result, indent=2))
    if verbose:
        r, m = result["roofline"], result["memory"]
        print(f"[{arch} | {shape} | {mesh_kind}] OK "
              f"trace={t_trace:.1f}s "
              f"compute={r['compute_s'] * 1e3:.2f}ms "
              f"memory={r['memory_s'] * 1e3:.2f}ms "
              f"coll={r['collective_s'] * 1e3:.2f}ms "
              f"dom={r['dominant']} "
              f"useful={r['useful_flop_ratio']:.2f} "
              f"peak={m['peak_memory_in_bytes'] / 2**30:.2f}GiB "
              f"fits_80gb={m['fits_80gb']}")
        print("  memory:", result["memory"])
        print("  cost: flops/dev=%.3e bytes/dev=%.3e" % (flops, bytes_acc))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--opt", action="store_true",
                    help="apply the optimization bundle")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    init_fake_world(512 if "multi" in meshes else 256)
    failures = []
    for arch, shape in cells:
        for mk in meshes:
            try:
                res = run_cell(arch, shape, mk,
                               microbatches=args.microbatches,
                               opt=args.opt)
                if res["status"] == "skipped":
                    print(f"[{arch} | {shape} | {mk}] SKIP: "
                          f"{res['reason']}")
                    OUT_DIR.mkdir(parents=True, exist_ok=True)
                    (OUT_DIR / f"{arch}_{shape}_{mk}.json").write_text(
                        json.dumps(res, indent=2))
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape, mk, repr(e)))
                print(f"[{arch} | {shape} | {mk}] FAIL: {e}")
                traceback.print_exc()
                out_dir = OPT_DIR if args.opt else OUT_DIR
                out_dir.mkdir(parents=True, exist_ok=True)
                (out_dir / f"{arch}_{shape}_{mk}.json").write_text(
                    json.dumps({"arch": arch, "shape": shape, "mesh": mk,
                                "status": "failed", "error": repr(e)},
                               indent=2))
    if failures:
        print(f"\n{len(failures)} cell(s) FAILED:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()
