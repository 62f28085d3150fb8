"""The collective schedule of an eager step: bytes on the wire per device.

Counterpart of ``src/repro/launch/hlo_analysis.py``.  The reference parses
the collectives out of XLA's per-device HLO text; an eager PyTorch step has
no such program, so :class:`CollectiveRecorder` records each collective as
the step runs it — DTensor's redistributions (``_c10d_functional`` /
``c10d_functional``) and the explicit ones of a ``local_map`` region
(``c10d``) — with its kind, its result bytes on this rank and its group's
size.  :class:`CollectiveOp`, :func:`_wire_factor` and :func:`summarize`
are the reference's, copied (``tests/test_torch_dryrun.py`` holds them to
its syntax tree), so the ring wire model and the summary are its own:

    all-reduce:          2 (N-1)/N x bytes   (reduce-scatter + all-gather)
    all-gather:            (N-1)/N x bytes   (bytes = full output)
    reduce-scatter:        (N-1)   x bytes   (bytes = the scattered shard)
    all-to-all:            (N-1)/N x bytes
    collective-permute:              1 x bytes   (point-to-point hops)

``wire_bytes_bf16`` equals ``wire_bytes``: the reference halves large
float32 collectives because XLA's CPU backend promotes bf16 products to
float32, where fake tensors keep their dtype.  An eager step repeats no
body, so every ``count`` is 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes: int              # result bytes (per device)
    group_size: int
    wire_bytes: float       # ring-model bytes on the wire per device
    computation: str
    count: int = 1          # trip-count multiplier
    wire_bytes_bf16: float = 0.0   # bf16-equivalent (TPU target) wire bytes


def _wire_factor(kind: str, n: int, op_bytes: int) -> float:
    if kind == "collective-permute":
        return float(op_bytes)   # pairwise; no replica_groups attribute
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * op_bytes
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n * op_bytes
    if kind == "reduce-scatter":
        return (n - 1) * op_bytes        # result is the scattered shard
    if kind == "collective-permute":
        return float(op_bytes)
    return float(op_bytes)


def summarize(ops: List[CollectiveOp]) -> Dict:
    by_kind: Dict[str, Dict] = {}
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "bytes": 0.0,
                                         "wire_bytes": 0.0,
                                         "wire_bytes_bf16": 0.0})
        d["count"] += op.count
        d["bytes"] += op.bytes * op.count
        d["wire_bytes"] += op.wire_bytes
        d["wire_bytes_bf16"] += op.wire_bytes_bf16
    total_wire = sum(d["wire_bytes"] for d in by_kind.values())
    total_16 = sum(d["wire_bytes_bf16"] for d in by_kind.values())
    return {"by_kind": by_kind, "total_wire_bytes_per_device": total_wire,
            "total_wire_bytes_bf16_per_device": total_16, "n_ops": len(ops)}


# op name (functional and c10d forms) -> the reference's kind
KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _tensors(x) -> list:
    """The tensors in nested lists, tuples and dicts, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(func, args, kwargs) -> int:
    """The size of the group a collective runs over: a functional
    collective names it (``group_name``), a ``c10d`` one carries it."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for i, a in enumerate(func._schema.arguments):
        if a.name not in ("group_name", "process_group", "group"):
            continue
        g = args[i] if i < len(args) else kwargs[a.name]
        if isinstance(g, str):
            return _resolve_process_group(g).size()
        return dist.ProcessGroup.unbox(g).size()
    return 1


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective run while it is on, DTensor's included:
    an operation on DTensors is handed back (``NotImplemented``) so that
    DTensor runs it and the collectives it lowers to come back here, as
    ``torch.distributed.tensor.debug.CommDebugMode`` does."""

    def __init__(self, computation: str = "step"):
        super().__init__()
        self.ops: List[CollectiveOp] = []
        self.computation = computation

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in NAMESPACES and name in KINDS:
            kind = KINDS[name]
            res = _tensors(out) if ns != "c10d" else _tensors(args[0])
            nbytes = _nbytes(res)
            n = _group_size(func, args, kwargs)
            wire = _wire_factor(kind, n, nbytes)
            self.ops.append(CollectiveOp(
                kind=kind, bytes=nbytes, group_size=n, wire_bytes=wire,
                computation=self.computation, wire_bytes_bf16=wire))
        return out
