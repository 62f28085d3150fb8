"""A process group that carries every collective through host memory.

Several ranks on one card cannot use NCCL (it refuses two ranks on one
device), and gloo's own CUDA collectives crash under the functional
collectives' wait that ``DTensor`` redistributes through (torch 2.11 on an
H100: ``all_gather_tensor`` then ``wait_tensor`` segfaults); gloo's
point-to-point ops take CPU tensors only.  This group, registered as the
``torch.distributed`` backend ``"hostgloo"``, copies each collective's
device tensors to the host, runs gloo's CPU op, and copies the results
back: the copy is the wire.  :data:`STAGED` counts the collectives and the
bytes that crossed to and from the host.  Point-to-point ops pass host
tensors to gloo as they are: their one caller, the int8 ring, stages and
counts its hops itself.  On CPU tensors the copies are no-ops, so the CPU
tests run the same code (``tests/test_torch_spmd_models.py``).

Use: ``register()`` in every rank before ``init_process_group("hostgloo",
...)`` (``launch/ranks.py`` does it).
"""
from __future__ import annotations

import datetime
from typing import Dict, List

import torch
import torch.distributed as dist

# collectives run and bytes copied between the card and the host by this
# process's host groups
STAGED: Dict[str, int] = {"ops": 0, "bytes": 0}

BACKEND = "hostgloo"


def reset_staged() -> None:
    for k in STAGED:
        STAGED[k] = 0


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu":
        return t
    STAGED["bytes"] += t.numel() * t.element_size()
    return t.cpu()


def _back(dst: torch.Tensor, src: torch.Tensor) -> None:
    if dst.device.type != "cpu":
        STAGED["bytes"] += src.numel() * src.element_size()
    if dst.data_ptr() != src.data_ptr():
        dst.copy_(src)


class HostGroup(dist.ProcessGroup):
    """gloo on host copies of the tensors (see the module docstring).  Each
    op is defined under the names torch's process-group trampolines call:
    torch 2.11 (the card's) calls ``allgather_into_tensor_coalesced``,
    ``reduce_scatter_tensor_coalesced`` and ``alltoall_base``; torch 2.13
    calls ``all_gather_single_coalesced`` and
    ``reduce_scatter_single_coalesced``."""

    def __init__(self, store, rank: int, size: int,
                 timeout: datetime.timedelta):
        super().__init__(rank, size)
        self._rank, self._size = rank, size
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    # ---------------------------------------------------------------- identity
    def getBackendName(self) -> str:
        return BACKEND

    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        return self._rank

    @property
    def group_name(self) -> str:
        return dist.distributed_c10d._world.pg_names[self]

    pg_name = group_name

    # ---------------------------------------------------------------- reduce
    def allreduce(self, tensors: List[torch.Tensor], opts=None):
        STAGED["ops"] += 1
        host = [_host(t) for t in tensors]
        o = dist.AllreduceOptions()
        if opts is not None:
            o.reduceOp = opts.reduceOp
        self._gloo.allreduce(host, o).wait()
        for t, h in zip(tensors, host):
            _back(t, h)
        return _done(tensors)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        # all-reduce each whole input, keep this rank's part
        for out, inp in zip(outputs, inputs):
            full = inp.clone()
            self.allreduce([full], opts)
            _back(out, full.chunk(self._size)[self._rank])
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    # ---------------------------------------------------------------- gather
    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for out, inp in zip(outputs, inputs):
            STAGED["ops"] += 1
            h_in = _host(inp)
            h_out = [torch.empty_like(h_in) for _ in range(self._size)]
            self._gloo.allgather([h_out], [h_in]).wait()
            for o, h in zip(out.chunk(self._size), h_out):
                _back(o, h)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    # ---------------------------------------------------------------- others
    def alltoall_base(self, output, inp, output_splits, input_splits,
                      opts=None):
        STAGED["ops"] += 1
        h_in, h_out = _host(inp), torch.empty(output.shape,
                                              dtype=output.dtype)
        self._gloo.alltoall_base(h_out, h_in, list(output_splits or []),
                                 list(input_splits or []),
                                 dist.AllToAllOptions()).wait()
        _back(output, h_out)
        return _done([output])

    def barrier(self, opts=None):
        self._gloo.barrier(dist.BarrierOptions()).wait()
        return _done([])

    # Point-to-point is gloo's own on host tensors (the ring stages its
    # hops itself, ``train/compression.py``); gloo's pending work is
    # returned, so that a ring posts its send before its receive.
    def send(self, tensors, dst: int, tag: int = 0):
        return self._gloo.send(tensors, dst, tag)

    def recv(self, tensors, src: int, tag: int = 0):
        return self._gloo.recv(tensors, src, tag)


def _create(store, rank, size, timeout):
    return HostGroup(store, rank, size, timeout)


def register() -> None:
    """Make ``"hostgloo"`` a ``torch.distributed`` backend (once a
    process)."""
    if not hasattr(dist.Backend, BACKEND.upper()):
        dist.Backend.register_backend(BACKEND, _create,
                                      devices=["cpu", "cuda"])
