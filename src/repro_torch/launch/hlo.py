"""Collective-traffic accounting for the dry run's roofline, from a trace.

The reference parses the SPMD-partitioned HLO text of a compiled step for
every all-reduce / all-gather / reduce-scatter / all-to-all /
collective-permute.  The port has no HLO: DTensor issues its collectives
eagerly, as ``c10d_functional`` ops on each rank's local shards.
:class:`LocalTrace` is a dispatch mode that lets DTensor ops through and
records the collectives they issue: each one's reference op name, its
result bytes and its group size, from the op's own arguments.  The byte
model is the reference's (ring):

    op                  operand bytes      modeled link bytes (ring)
    all-reduce          result             2 (g-1)/g x result
    all-gather          result / g         (g-1)/g x result
    reduce-scatter      result x g         (g-1)/g x (result x g)
    all-to-all          result             (g-1)/g x result
    collective-permute  result             result

An eager trace counts each execution, so there are no trip counts (the
reference multiplies through its while loops' ``known_trip_count``).
``link_bytes_f32`` is the f32 share, reported as the reference reports
it; the reference subtracts half of it for bf16 models because XLA's CPU
float normalization widens bf16 collectives to f32 before partitioning.
The traced dtypes here are the program's own, so nothing is subtracted.
``link_bytes_inter_node`` is the share over groups whose ranks span more
than one node (``gpus_per_node`` ranks a node), which the roofline times
at the slower inter-node rate.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveStats", "LocalTrace", "collective_stats"]

# op packet name -> (reference op name, index of the group-name argument)
_OPS = {
    "all_reduce": ("all-reduce", 2),
    "all_reduce_": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
    "shard_dim_alltoall": ("all-to-all", 3),
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


@dataclasses.dataclass
class CollectiveStats:
    operand_bytes: int = 0                  # sum of operand sizes
    link_bytes: float = 0.0                 # modeled ring link traffic
    link_bytes_f32: float = 0.0             # its f32 share
    link_bytes_inter_node: float = 0.0      # its share over groups that
                                            # cross nodes
    by_op_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    by_op_count: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    top_ops: List[dict] = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "operand_bytes": int(self.operand_bytes),
            "link_bytes": float(self.link_bytes),
            "link_bytes_f32": float(self.link_bytes_f32),
            # the reference's key, its correction not applicable here (the
            # module docstring): the link bytes themselves
            "link_bytes_bf16_adjusted": float(self.link_bytes),
            "link_bytes_inter_node": float(self.link_bytes_inter_node),
            "by_op_bytes": {k: int(v) for k, v in self.by_op_bytes.items()},
            "by_op_count": dict(self.by_op_count),
            "top_ops": self.top_ops[:20],
        }


def _accounting(op: str, result_bytes: int, g: int) -> Tuple[float, float]:
    """(operand_bytes, link_bytes) for one execution of the op."""
    if op == "all-reduce":
        return result_bytes, 2.0 * (g - 1) / max(g, 1) * result_bytes
    if op == "all-gather":
        return result_bytes / max(g, 1), (g - 1) / max(g, 1) * result_bytes
    if op == "reduce-scatter":
        inp = result_bytes * g
        return inp, (g - 1) / max(g, 1) * inp
    if op == "all-to-all":
        return result_bytes, (g - 1) / max(g, 1) * result_bytes
    return result_bytes, float(result_bytes)     # collective-permute


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class LocalTrace(TorchDispatchMode):
    """Records every collective run inside it, one entry an execution:
    ``(op, result_bytes, group_ranks, result dtype names, result shapes,
    where)``, ``where`` the DTensor op that issued it.  DTensor ops pass through (the mode
    returns ``NotImplemented`` for them) so their local collectives come
    back through the mode.

    It also sums, over every other local op, ``bytes_accessed`` (tensor
    operand and result bytes, views excluded: the counterpart of a
    compiled program's ``bytes accessed``) and ``flops`` (by
    ``FlopCounterMode``'s own formulas).  Counted here, below DTensor,
    both are a device's own; a ``FlopCounterMode`` stacked beside DTensor
    sees its global ops, its local ones or both, by the order of the
    modes.  DTensor's own shape propagation (each new op run once at the
    global shapes) must run with the modes off: the dry run sees to
    that."""

    def __init__(self):
        super().__init__()
        self.records: List[tuple] = []
        self.bytes_accessed = 0
        self.flops = 0
        self._where = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            self._where = str(func)
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ns, name = packet._qualified_op_name.split("::")
        if ns in _NAMESPACES and name in _OPS:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            op, gi = _OPS[name]
            group = _resolve_process_group(
                args[gi] if len(args) > gi else kwargs["group_name"])
            ranks = tuple(dist.get_process_group_ranks(group))
            ts = _tensors(out)
            self.records.append((op, _nbytes(ts), ranks,
                                 tuple(str(t.dtype) for t in ts),
                                 tuple(tuple(t.shape) for t in ts),
                                 self._where))
        elif ns not in _NAMESPACES and not func.is_view:
            from torch.utils.flop_counter import flop_registry
            self.bytes_accessed += _nbytes(_tensors(list(args))) \
                + _nbytes(_tensors(list(kwargs.values()))) \
                + _nbytes(_tensors(out))
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                   out_val=out)
        return out


def collective_stats(trace: LocalTrace,
                     gpus_per_node: int = 8) -> CollectiveStats:
    """Sum a trace's collectives by the reference's byte model."""
    stats = CollectiveStats()
    details = []
    for op, rbytes, ranks, dtypes, shapes, where in trace.records:
        g = max(len(ranks), 1)
        operand, link = _accounting(op, rbytes, g)
        stats.operand_bytes += operand
        stats.link_bytes += link
        if "torch.float32" in dtypes:
            stats.link_bytes_f32 += link
        if len({r // gpus_per_node for r in ranks}) > 1:
            stats.link_bytes_inter_node += link
        stats.by_op_bytes[op] += int(operand)
        stats.by_op_count[op] += 1
        details.append({"op": op, "link_bytes": link, "trips": 1,
                        "groups": g,
                        "result": ", ".join(
                            f"{d.replace('torch.', '')}{list(s)}"
                            for d, s in zip(dtypes, shapes)),
                        "where": where[-100:]})
    details.sort(key=lambda d: -d["link_bytes"])
    stats.top_ops = details[:20]
    return stats
