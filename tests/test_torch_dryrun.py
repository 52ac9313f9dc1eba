"""The port's meshes, sharded steps and dry run, each in processes of its
own (a process keeps one default process group, and xdist reuses its
workers across files).

* Four real ranks: a 4-process gloo run on a ``(2, 2)`` mesh through a
  ``FileStore`` under ``tmp_path`` (the harness of
  ``tests/test_torch_pod.py``, which runs the same on ``(2, 2, 2)``).
  SMOKE ``llama3.2-1b``, ``granite-moe-1b-a400m``, ``mamba2-2.7b``,
  ``recurrentgemma-2b`` (its sequence past its window) and
  ``seamless-m4t-medium`` (with its audio frontend) in fp32 each take one
  sharded train step (2 microbatches, remat; ``shard_state`` + ``sh``;
  the loss vocab-parallel) whose loss, grad norm and updated parameters
  equal the unsharded step's at rtol = atol = 1e-5; then each one's
  sharded prefill and one decode token equal the unsharded ones.
* The fake backend, in one process: the pod meshes (the leading sub-grid
  of a larger group, an error for a smaller one; the multi-pod mesh with
  ``('pod', 'data')`` as one dim over the same ranks);
  the dry run's cell at SMOKE width on a fake ``(2, 2)`` world, under the
  ``tp`` and ``dp`` policies: argument bytes equal the summed local shard
  bytes worked out from the placements, the peak covers them,
  collectives are traced under ``tp``, and under ``dp`` no activation is
  all-reduced and two are all-gathered (DTensor's layout choices, named
  in the test); FLOPs are counted on each rank's local ops (a quarter of
  a matmul split four ways), not DTensor's global ones; a bf16 step over
  a ``(1, 1)`` and a ``(1, 1, 1)`` mesh equals the plain step bit for
  bit; and the CLI's ``long_500k`` cell of a full-attention arch is
  recorded as skipped with the reference's reason.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get as ref_get
from repro.configs.shapes import skip_reason as ref_skip_reason

from test_torch_pod import (GLOO_ARCHS, check_prefill_and_decode,
                            check_train_step, run_ranks)

SRC = Path(__file__).resolve().parents[1] / "src"
B = 4


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("gloo"), (2, 2),
                     ("data", "model"), GLOO_ARCHS, B)


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_gloo_sharded_train_step_equals_unsharded(gloo_run, arch):
    check_train_step(gloo_run[arch], arch, B)


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_gloo_sharded_prefill_and_decode_equal_unsharded(gloo_run, arch):
    check_prefill_and_decode(gloo_run[arch], arch, B)


_FAKE = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.hlo import LocalTrace
out = {}
try:
    M.make_production_mesh()
except RuntimeError as e:
    out["no_group"] = str(e)
D.init_fake_world(512)
single, multi = M.make_production_mesh(), M.make_production_mesh(
    multi_pod=True)
host = M.make_host_mesh(device_type="cpu")
if not torch.cuda.is_available():
    try:
        M.make_host_mesh()
    except RuntimeError as e:
        out["host_no_card"] = str(e)
out["meshes"] = [[list(m.shape), list(m.mesh_dim_names),
                  m.mesh.flatten().tolist()[:3], m.device_type,
                  list(M.dp_axes(m)), list(M.fsdp_axes(m)), M.tp_axis(m)]
                 for m in (single, multi, host)]
out["multi_groups"] = [dist.get_process_group_ranks(multi.get_group(i))
                       for i in range(2)]
D.init_fake_world(256)
try:
    M.make_production_mesh(multi_pod=True)
except RuntimeError as e:
    out["too_few"] = str(e)

D.init_fake_world(4)
mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
# a host model on a card mesh is refused, not moved to the mesh's device
from repro_torch.launch.sharding import shard_state
from repro_torch.models import Model
try:
    shard_state(Model(D.get("llama3.2-1b", smoke=True), device="cpu"), mesh)
except ValueError as e:
    out["moved"] = str(e)
# FLOPs: the trace counts each rank's local matmul, not DTensor's shape
# propagation at the global shapes; a FlopCounterMode on top sees
# DTensor's global op
a = distribute_tensor(torch.empty(64, 128, device="meta"), mesh,
                      [Shard(0), Shard(0)])
b = torch.empty(128, 32, device="meta")
from torch.distributed.tensor.experimental import implicit_replication
fc, tr = FlopCounterMode(display=False), LocalTrace()
with implicit_replication(), D._propagation_unseen(), tr, fc:
    a @ b
out["flops_local"], out["flops_global"] = tr.flops, fc.get_total_flops()
get, stats = D.get, D.collective_stats
traces = []
D.get = lambda arch: get(arch, smoke=True)
D.collective_stats = lambda tr, *a: (traces.append(tr), stats(tr, *a))[1]
cells, shapes = {}, {}
for opt in (False, True):
    r = D.run_cell("llama3.2-1b", "smoke", "2x2", save=False, verbose=False,
                   opt=opt, spec=ShapeSpec("smoke", 24, 8, "train"),
                   mesh=mesh)
    cells[r["policy"]] = r
    shapes[r["policy"]] = [(rec[0], rec[3], rec[4])
                           for rec in traces[-1].records]
out["cells"], out["collective_shapes"] = cells, shapes
# the argument bytes from the placements alone: fp32 params, m and v
# (12 bytes an element), the int32 step, int64 tokens and labels
from repro_torch.launch.sharding import param_placements
from repro_torch.models import Model
want = {}
for policy in ("tp", "dp"):
    model = Model(get("llama3.2-1b", smoke=True), device="meta")
    elems = 0
    for k, pl in param_placements(model, mesh, policy).items():
        n = dict(model.named_parameters())[k].numel()
        for p_ in pl:
            n //= 2 if isinstance(p_, Shard) else 1
        elems += n
    rows = 8 // (2 if policy == "tp" else 4)
    want[policy] = 12 * elems + 4 + 2 * 8 * rows * 24
out["want_arg_bytes"] = want
D.get = get
# a (1, 1) mesh: every placement replicates, and the sharded bf16 step is
# the plain one bit for bit (chip_smoke.py phase 21 at full width)
import dataclasses
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.sharding import batch_placements, make_shardings, \
    shard_state
from repro_torch.models import init_train_state, make_train_step
D.init_fake_world(1)
host = M.make_host_mesh(device_type="cpu")
cfg = dataclasses.replace(get("llama3.2-1b", smoke=True),
                          param_dtype="bfloat16")
data = TokenPipeline(cfg.vocab_unpadded, 4, 16, device="cpu")
# (and over the multi-pod mesh's three axes, one device each)
pod3 = M.make_pod_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
runs = []
for mesh_ in (host, pod3, None):
    model = Model(cfg, device="cpu", seed=0)
    state = init_train_state(model)
    if mesh_ is not None:
        state = shard_state(state, mesh_)
    step = make_train_step(model, sh=make_shardings(mesh_),
                           microbatches=2, remat=True)
    losses = []
    for s in range(2):
        b = data(s)
        if mesh_ is not None:
            pl = batch_placements(mesh_, b, 4)
            b = {k: distribute_tensor(v, mesh_, pl[k])
                 for k, v in b.items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    runs.append((losses, {k: getattr(v, "to_local", lambda: v)().detach()
                          for k, v in state["params"].items()}))
out["host_losses"] = [runs[0][0], runs[2][0]]
out["host_params_equal"] = all(torch.equal(runs[0][1][k], runs[2][1][k])
                               for k in runs[2][1])
out["pod_losses"] = runs[1][0]
out["pod_params_equal"] = all(torch.equal(runs[1][1][k], runs[2][1][k])
                              for k in runs[2][1])
D.OUT_DIR = __import__("pathlib").Path(sys.argv[1])
try:
    D.main(["--arch", "llama3.2-1b", "--shape", "long_500k"])
    out["main_exit"] = 0
except SystemExit as e:
    out["main_exit"] = e.code
print("RESULT " + json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def fake_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    p = subprocess.run([sys.executable, "-c", _FAKE, str(tmp)], env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):]), tmp


def test_pod_meshes(fake_run):
    out, _ = fake_run
    assert "initialized process group" in out["no_group"]
    single, multi, host = out["meshes"]
    assert single == [[16, 16], ["data", "model"], [0, 1, 2], "cuda",
                      ["data"], ["data"], "model"]
    assert multi == [[32, 16], ["pod+data", "model"], [0, 1, 2], "cuda",
                     ["pod", "data"], ["pod", "data"], "model"]
    assert host == [[1, 1], ["data", "model"], [0], "cpu", ["data"],
                    ["data"], "model"]
    assert "need 512 ranks" in out["too_few"]
    if not torch.cuda.is_available():
        assert "no CUDA device" in out["host_no_card"]


def test_multi_pod_mesh_flattens_pod_and_data(fake_run):
    out, _ = fake_run
    dp_ranks, tp_ranks = out["multi_groups"]
    # rank 0's data-parallel group: every (pod, data) pair at model 0, pod
    # major, as the reference's ('pod', 'data'); its model group as before
    assert dp_ranks == list(range(0, 512, 16))
    assert tp_ranks == list(range(16))


def test_shard_state_refuses_another_device(fake_run):
    out, _ = fake_run
    assert "a cpu tensor on a cuda mesh" in out["moved"]


def test_host_mesh_step_is_the_plain_step_bit_for_bit(fake_run):
    out, _ = fake_run
    sharded, plain = out["host_losses"]
    assert sharded == plain
    assert out["host_params_equal"]


def test_pod_mesh_step_is_the_plain_step_bit_for_bit(fake_run):
    # (1, 1, 1) over ("pod", "data", "model"): chip_smoke.py phase 21's
    # second mesh, laid out as ("pod+data", "model")
    out, _ = fake_run
    assert out["pod_losses"] == out["host_losses"][1]
    assert out["pod_params_equal"]


def test_flops_are_counted_per_device(fake_run):
    out, _ = fake_run
    # [64, 128] @ [128, 32] with the rows split over all four ranks
    assert out["flops_global"] == 2 * 64 * 128 * 32
    assert out["flops_local"] == out["flops_global"] // 4


@pytest.mark.parametrize("policy", ("tp", "dp"))
def test_dryrun_cell_memory_and_fields(fake_run, policy):
    out, _ = fake_run
    cell = out["cells"][policy]
    for key in ("status", "policy", "sharding_mode", "n_chips",
                "params_total", "params_active", "memory", "cost",
                "collectives", "roofline", "timings"):
        assert key in cell, key
    assert cell["status"] == "ok" and cell["n_chips"] == 4
    mem = cell["memory"]
    assert mem["argument_size_in_bytes"] == out["want_arg_bytes"][policy]
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"]
    assert mem["fits_80gb"] is True
    assert cell["cost"]["flops"] > 0
    r = cell["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["traced_flops_per_device"] == cell["cost"]["flops"]


def test_dryrun_collectives_by_policy(fake_run):
    out, _ = fake_run
    tp, dp = out["cells"]["tp"], out["cells"]["dp"]
    assert tp["policy"] == "tp" and dp["policy"] == "dp"
    assert all(tp["collectives"]["by_op_count"].get(op, 0) > 0
               for op in ("all-gather", "all-reduce", "reduce-scatter"))
    assert tp["collectives"]["link_bytes"] > 0
    # the reference's bf16 correction does not apply to a traced program
    assert tp["collectives"]["link_bytes_bf16_adjusted"] == \
        tp["collectives"]["link_bytes"]
    # an activation is a float [rows, seq, ...] tensor, the seq 24 or its
    # half (no SMOKE weight has three dims).  Under tp the sequence and
    # head re-layouts move activations.  Under dp no activation is
    # all-reduced, and only two are all-gathered: DTensor lays the
    # embedding's output out d-sharded like its FSDP table, so the batch
    # constraint after it re-lays it once, and one cotangent sum in the
    # backward meets two layouts.  The rest move weights, gradients,
    # scalars and token ids.
    def activations(policy, ops):
        return [s for o, dts, shapes in out["collective_shapes"][policy]
                for d, s in zip(dts, shapes)
                if o in ops and "float" in d and len(s) >= 3
                and s[1] in (12, 24)]

    assert activations("tp", ("all-gather", "all-reduce", "reduce-scatter",
                              "all-to-all"))
    assert not activations("dp", ("all-reduce",))
    assert len(activations("dp", ("all-gather",))) <= 2


def test_dryrun_skips_long_500k_for_full_attention(fake_run):
    out, tmp = fake_run
    assert out["main_exit"] == 0
    rec = json.loads((tmp / "llama3.2-1b_long_500k_single.json").read_text())
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_skip_reason(ref_get("llama3.2-1b"),
                                            "long_500k")


# ---------------------------------------------------------------------------
# what a device holds at the peak of a train step, at SMOKE width
# ---------------------------------------------------------------------------

_MEMORY = r"""
import dataclasses, json
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_pod_mesh
get, T, out = D.get, 16, {}
traces, stats = [], D.collective_stats
D.collective_stats = lambda tr, *a: (traces.append(tr), stats(tr, *a))[1]


def cell(arch, shape, B, layers=None, step="train"):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    n = 1
    for s in shape:
        n *= s
    D.init_fake_world(n)
    mesh = make_pod_mesh(shape, names, "cuda")
    cfg = get(arch, smoke=True)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    D.get = lambda a: cfg
    m = D.run_cell(arch, "smoke", "x", save=False, verbose=False,
                   spec=ShapeSpec("smoke", T, B, step),
                   mesh=mesh)["memory"]
    return m["argument_size_in_bytes"], m["temp_size_in_bytes"]


for arch in ("llama3.2-1b", "granite-moe-1b-a400m", "mamba2-2.7b"):
    out[arch] = {"depth": [cell(arch, (4, 2), 16, L) for L in (1, 2)]}
out["granite-moe-1b-a400m"]["pods"] = [
    cell("granite-moe-1b-a400m", (2, 2), 8, 1),
    cell("granite-moe-1b-a400m", (2, 2, 2), 16, 1)]
# the collectives of granite-moe's prefill on (2, 2): op and result shape
cell("granite-moe-1b-a400m", (2, 2), 8, step="prefill")
out["moe_prefill"] = [(r[0], r[4][0]) for r in traces[-1].records]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def memory_run():
    p = subprocess.run([sys.executable, "-c", _MEMORY], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("arch", ("llama3.2-1b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b"))
def test_peak_grows_a_layer_by_its_shards_and_boundary(memory_run, arch):
    # one more layer on a fake (4, 2) mesh, batch 16 x 16, fp32: the
    # peak's temporaries may grow by the layer's fp32 gradient shards (a
    # third of the arguments' growth: parameters, m and v) and the
    # activation its checkpoint saves ([rows, T / 2, d] on each rank).
    # A gradient kept at its gathered size until the backward ends (a
    # partial sum over the data axis) grows it by 4x that.
    from repro_torch.configs import get
    (a1, t1), (a2, t2) = memory_run[arch]["depth"]
    boundary = (16 // 4) * (16 // 2) * get(arch, smoke=True).d_model * 4
    assert t2 - t1 <= (a2 - a1) // 3 + boundary, (t2 - t1, a2 - a1)


def test_peak_holds_when_pods_add_rows(memory_run):
    # granite-moe (a layer) on (2, 2) with batch 8 and on (2, 2, 2) with
    # batch 16: the same rows a rank, so no more temporaries a device (the
    # MoE's dispatch and combine run on each rank's rows, not the whole
    # batch)
    (_, single), (_, pods) = memory_run["granite-moe-1b-a400m"]["pods"]
    assert pods <= single


def test_moe_combine_is_reduce_scattered(memory_run):
    # granite-moe's SMOKE prefill on (2, 2), batch 8 x 16, two attention +
    # MoE blocks: each block's two outputs are [4, 16, 64] partial sums
    # over 'model' on each rank.  The attention's is all-reduced whole
    # (then sliced to the residual's sequence shards); the MoE combine's
    # is reduce-scattered straight into them, [4, 8, 64], half the bytes
    recs = memory_run["moe_prefill"]
    assert [s for op, s in recs if op == "all-reduce"
            and s == [4, 16, 64]] == [[4, 16, 64]] * 2
    assert len([s for op, s in recs if op == "reduce-scatter"
                and s == [4, 8, 64]]) >= 2


def test_ssd_scan_saves_no_outer_product():
    # the SSD scan at mamba2-2.7b's chunk, heads of a 16-way shard, state
    # and head widths saves nothing larger than a chunk's [Q, Q, H],
    # [Q, H, S] or [H, P, S] for the backward, whatever contraction paths
    # einsum would pick
    from repro_torch.configs import get
    from repro_torch.models.ssm import _ssd_chunked
    cfg = get("mamba2-2.7b")
    Q, H, P, S = cfg.ssm_chunk, cfg.ssm_heads // 16, cfg.ssm_head_dim, \
        cfg.ssm_state
    T_ = 2 * Q

    def leaf(*shape):
        return torch.empty(shape, device="meta", requires_grad=True)

    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.untyped_storage().nbytes()) or t,
            lambda t: t):
        _ssd_chunked(leaf(1, T_, H, P), leaf(1, T_, H), leaf(H),
                     leaf(1, T_, H, S), leaf(1, T_, H, S), cfg)
    assert max(saved) <= 4 * max(Q * Q * H, Q * H * S, H * P * S)
