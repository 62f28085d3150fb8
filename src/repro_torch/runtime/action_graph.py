"""The DiT action head's DDIM loop replayed from a CUDA graph.

Eager, ``models/vla.py::dit_sample`` issues some six thousand small
kernels a call (``diffusion_steps`` 10 x ``dit_layers`` 12 x ~47 in a
block at CogACT-7B's widths): each takes the card a few microseconds and
the host longer to issue, so the card waits on the host.  Captured once as
a ``torch.cuda.CUDAGraph``, the loop is one call of the host: the same
kernels on the same values, in the same dtypes, launched by CUDA itself.

:class:`DiTGraphs` holds one split executor's graphs.  A call runs the
graph only where it can observe that capture is sound: the cognition
feature on a CUDA device, autograd off, no ``DTensor`` among the head's
parameters, and no capture already under way on the current stream.
Anywhere else it runs ``dit_sample`` eagerly, unchanged.

A graph is keyed by the batch, the cognition's dtype and device, and the
address, dtype, shape and strides of every parameter leaf: a graph reads
its parameters where they lay when it was captured, so other weights or
another batch capture anew.  The ``KEEP`` keys used last are kept, and
with each graph its memory pool.

The cognition's conditioning product runs eagerly on the caller's view,
and only its (B, dit_dim) result is copied into the graph's input, so the
product sees the strides it sees eagerly.  The answer is a clone of the
graph's output, which the next replay overwrites.

Each call counts, in ``calls`` and with a recorder in its
``metrics``, as one of ``action_head.graph_replays``,
``action_head.graph_captures`` (the call captured, then replayed) and
``action_head.eager``.
"""
from __future__ import annotations

import collections
from typing import Dict, NamedTuple

import torch

from ..models import vla as V
from ..models.layers import dense
from ..models.sharding import is_dtensor, tree_leaves

REPLAYS = "action_head.graph_replays"
CAPTURES = "action_head.graph_captures"
EAGER = "action_head.eager"
KEEP = 4            # graphs an executor keeps, the least recently used out
WARM_RUNS = 2       # eager runs on the capture stream before capturing


def capturable(p, cognition: torch.Tensor) -> bool:
    """Whether a call of the DiT head on ``cognition`` with parameters
    ``p`` can run from a CUDA graph."""
    return (cognition.is_cuda and not torch.is_grad_enabled()
            and not any(is_dtensor(w) for w in tree_leaves(p))
            and not torch.cuda.is_current_stream_capturing())


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    cond: torch.Tensor          # (B, dit_dim), the cognition's dtype
    noise: torch.Tensor         # (B, horizon, action_dim), float32
    out: torch.Tensor
    consts: tuple               # ddim_constants, read by the graph


class DiTGraphs:
    """The DiT head of one executor: ``dit_sample``'s answer, from a CUDA
    graph where :func:`capturable` holds."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.calls: Dict[str, int] = dict.fromkeys((REPLAYS, CAPTURES,
                                                    EAGER), 0)
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = \
            collections.OrderedDict()

    def _count(self, name: str, recorder) -> None:
        self.calls[name] += 1
        if recorder is not None:
            recorder.metrics.inc(name)

    def __call__(self, p, cognition: torch.Tensor, noise: torch.Tensor,
                 recorder=None) -> torch.Tensor:
        if noise is None or not capturable(p, cognition):
            self._count(EAGER, recorder)
            return V.decode_action(self.cfg, p, cognition, noise)
        V.check_noise(self.cfg, cognition, noise)
        cond = dense(cognition, p["cond"])
        key = (cognition.shape[0], cognition.dtype, cognition.device,
               tuple((w.data_ptr(), w.dtype, tuple(w.shape), w.stride())
                     for w in tree_leaves(p)))
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(p, cond, noise)
            self._graphs[key] = g
            if len(self._graphs) > KEEP:
                self._graphs.popitem(last=False)
            self._count(CAPTURES, recorder)
        else:
            self._graphs.move_to_end(key)
            self._count(REPLAYS, recorder)
        g.cond.copy_(cond)
        g.noise.copy_(noise)
        g.graph.replay()
        return g.out.clone()

    def _capture(self, p, cond: torch.Tensor, noise: torch.Tensor
                 ) -> _Graph:
        """Static inputs holding this call's values, a few eager runs on a
        side stream (``torch.cuda.graphs`` asks for them before a capture),
        then the capture on that stream."""
        cfg, dev = self.cfg, cond.device
        s_cond = cond.clone()
        s_noise = noise.to(device=dev, dtype=torch.float32, copy=True)
        consts = V.ddim_constants(cfg, dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARM_RUNS):
                V.dit_ddim(cfg, p, s_cond, s_noise, consts)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = V.dit_ddim(cfg, p, s_cond, s_noise, consts)
        return _Graph(graph, s_cond, s_noise, out, consts)
