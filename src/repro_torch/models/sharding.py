"""Logical-axis sharding: ParamSpec trees, rule resolution, activation
constraints, random initialisation.

Counterpart of ``src/repro/models/sharding.py``.  Every parameter is
declared once as a :class:`ParamSpec` carrying *logical* axis names; at
launch the rules map logical axes to mesh axes (:func:`make_rules`, the
reference's rules as they are), which gives, without allocating anything,
``meta`` tensor trees (:func:`shape_tree`), placement trees
(:func:`sharding_tree`) and the bytes of a tree (:func:`spec_bytes`).

``torch.distributed``'s ``DTensor`` plays the part of GSPMD: on a bound
mesh (``launch/mesh.py``) a parameter is a ``DTensor`` whose placements
come from ``resolve(spec.axes, rules)`` (:func:`distribute_tree`), and
:func:`shard` — the JAX package's ``with_sharding_constraint`` — is
``redistribute``.  A ``PartitionSpec`` maps to placements mesh dim by mesh
dim: ``Shard(i)`` where tensor dim ``i``'s entry names that mesh axis,
``Replicate()`` otherwise; a tuple entry shards one tensor dim over several
mesh dims, in mesh order (:func:`placements`).  Off a mesh, and for a
plain tensor, :func:`shard` returns its argument: every one-device path
runs as it did.  ``shard_map`` regions are ``local_map`` regions
(:func:`local_region`), with explicit collectives over a named mesh
dimension inside (:func:`psum`, :func:`pmax`).  A region takes the mesh
axis it splits (the vocabulary, heads, experts) from the rules
(:func:`act_axis`, :func:`axis_rank`, :func:`pending`): under ``fsdp`` the
rules keep those axes whole and shard the batch over every mesh axis, and
each rank runs its own batch rows with the axis whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import require_device

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                     # normal | zeros | ones
    scale: Optional[float] = None            # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec(shape, axes, dtype=torch.bfloat16, init="normal", scale=None
         ) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of them (the JAX package's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        # a one-axis tuple entry is that axis, as JAX canonicalises it
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# --------------------------------------------------------------------------- rules
def make_rules(cfg, mesh, shape_kind: str = "train",
               strategy: str = "tp") -> Dict[str, Any]:
    """Resolve logical-axis -> mesh-axis rules for a (config, mesh, shape) cell.

    Strategies:
      * ``tp`` (baseline, Megatron-style): weights shard their big output
        dim over ``model``; activations are model-replicated between
        blocks (2 all-reduces per layer).
      * ``fsdp`` (ZeRO-3): weights shard over ``(data, model)`` jointly;
        activations shard over batch only.
      * ``batch`` shards on ``(pod, data)`` except for ``long_decode``
        (global_batch=1) where it stays replicated.
    """
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh is not None else {}
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    batch_rule = None if shape_kind == "long_decode" else (batch_axes or None)

    if strategy == "fsdp":
        w = ("data", "model") if "data" in axis_sizes else ("model",)
        # true FSDP: data-parallel over EVERY chip; params sharded over all
        fsdp_batch = tuple(a for a in ("pod", "data", "model")
                           if a in axis_sizes) or None
        batch_rule = None if shape_kind == "long_decode" else fsdp_batch
        return {
            "d_model": None, "vocab": w, "q_heads": w, "kv_heads": w,
            "head_dim": None, "ff": w, "experts": w, "moe_ff": None,
            "inner": w, "state": None, "lora": None, "layers": None,
            "dit": None, "vit_ff": w, "vit_heads": w,
            "batch": batch_rule, "seq": None,
            "act_heads": None, "act_kv_heads": None, "act_ff": None,
            "act_inner": None, "act_vocab": None, "act_experts": None,
            "cache_kv_heads": None, "cache_seq": None, "cache_seq_sp": None,
            None: None,
        }

    rules: Dict[str, Any] = {
        # weights
        "d_model": None,
        "vocab": "model",
        "q_heads": "model",          # flattened H*hd dim — always divisible
        "kv_heads": "model",         # flattened KV*hd dim — always divisible
        "head_dim": None,
        "ff": "model",
        "experts": "model",
        "moe_ff": None,
        "inner": "model",            # mamba2 d_inner / ssm heads
        "state": None,
        "lora": None,
        "layers": None,              # stacked-layer leading dim
        "dit": None,
        "vit_ff": "model",
        "vit_heads": "model",
        # activations (KV head tensors left to propagation)
        "batch": batch_rule,
        "seq": None,
        "act_heads": "model",
        "act_kv_heads": None,
        "act_ff": "model",
        "act_inner": "model",
        "act_vocab": "model",
        "act_experts": "model",
        # decode caches: shard KV-head dim
        "cache_kv_heads": "model",
        "cache_seq": None,
        # sequence-parallel flash-decode cache (cfg.decode_attn == "sp")
        "cache_seq_sp": "model",
        None: None,
    }
    return rules


# ---------------------------------------------------------------- mesh context
class _Ctx(threading.local):
    mesh = None
    rules: Optional[Dict[str, Any]] = None


_CTX = _Ctx()


class _Installed:
    """Installs (mesh, rules) for the length of a ``with`` block and puts
    back what was there before, whatever the block raises."""

    def __init__(self, mesh, rules):
        self.new, self.old = (mesh, rules), None

    def __enter__(self):
        self.old = (_CTX.mesh, _CTX.rules)
        _CTX.mesh, _CTX.rules = self.new

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self.old
        return False


class _PlainAsReplicated:
    """DTensor's ``implicit_replication`` that puts back the setting it
    found: the library's own clears it on exit, which would end an
    enclosing one (a recomputed layer enters the mesh again, and its exit
    would leave the rest of the step without it)."""

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        self.old = DTensor._op_dispatcher._allow_implicit_replication
        DTensor._op_dispatcher._allow_implicit_replication = True

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        DTensor._op_dispatcher._allow_implicit_replication = self.old
        return False


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Any]]):
    """Install (mesh, rules) so that in-model :func:`shard` constraints
    apply.  On a bound mesh, plain tensors that meet a ``DTensor`` in one
    operation (masks, position ids) count as replicated, as constants do
    under GSPMD."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(_Installed(mesh, rules))
        if mesh is not None and mesh.device_mesh is not None:
            stack.enter_context(_PlainAsReplicated())
        yield


def in_current_mesh(fn: Callable) -> Callable:
    """``fn`` run under the (mesh, rules) installed now, from whichever
    thread calls it: the context is thread-local, and autograd recomputes a
    checkpointed layer in its own device thread, where a layer run outside
    the context would hand the kernels DTensors instead of local shards."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with use_mesh(mesh, rules):
            return fn(*args, **kwargs)

    return run


def current_mesh():
    return _CTX.mesh


def batch_axes() -> Tuple[str, ...]:
    """The mesh axes the installed rules shard the batch over."""
    b = resolve(("batch",))[0]
    return () if b is None else ((b,) if isinstance(b, str) else tuple(b))


def bound_mesh():
    """The installed mesh if it is bound to a process group, else None."""
    m = _CTX.mesh
    return m if m is not None and m.device_mesh is not None else None


def axis_size(name: str) -> int:
    m = _CTX.mesh
    if m is None or name not in m.axis_names:
        return 1
    return dict(zip(m.axis_names, m.devices.shape))[name]


def act_axis(name: str) -> Optional[str]:
    """The mesh axis (or None) the installed rules shard the activation
    axis ``name`` over; a region on each rank's heads reads its head axis
    here, so that the rules decide it as they decide the weights'."""
    r = resolve((name,))[0]
    if isinstance(r, tuple):
        raise ValueError(f"activation axis {name!r} resolves to several "
                         f"mesh axes {r}; a region takes one")
    return r


def act_shards(name: str) -> int:
    """How many shards the activation axis ``name`` has under the rules."""
    a = act_axis(name)
    return 1 if a is None else axis_size(a)


def axis_rank(axis: Optional[str]) -> int:
    """This rank's index along ``axis`` of the installed bound mesh (0 for
    ``None``: a region whose rules keep the axis whole holds all of it)."""
    return bound_mesh().local_rank(axis) if axis is not None else 0


def pending(axis: Optional[str]) -> Tuple[str, ...]:
    """The ``partial_out`` of a region that sums its ranks' parts over
    ``axis``: nothing where the rules keep the axis whole."""
    return () if axis is None else (axis,)


def resolve(axes: Tuple[Optional[str], ...], rules=None) -> P:
    rules = rules if rules is not None else (_CTX.rules or {})
    out = []
    for a in axes:
        r = rules.get(a)
        if isinstance(r, tuple) and len(r) == 0:
            r = None
        out.append(r)
    return P(*out)


def rule_flag(name: str) -> Any:
    """Read an out-of-band flag stashed in the active rules dict."""
    return (_CTX.rules or {}).get(name)


def placements(pspec, mesh) -> tuple:
    """A partition spec over ``mesh``'s axis names -> one DTensor placement
    per mesh dim: ``Shard(i)`` where tensor dim ``i``'s entry names the
    mesh axis, ``Replicate()`` where none does.  A tuple entry shards one
    tensor dim over several mesh dims, which must come in mesh order (the
    order in which ``DTensor`` nests them, as JAX does).  A mesh axis named
    by two tensor dims raises, as JAX's ``DuplicateSpecError`` does."""
    from torch.distributed.tensor import Replicate, Shard
    named = [a for e in pspec
             for a in ((e,) if isinstance(e, str) else tuple(e or ()))]
    for a in set(named):
        if named.count(a) > 1:
            raise ValueError(f"spec {pspec} names mesh axis {a!r} in more "
                             "than one tensor dim")
    out = []
    for name in mesh.axis_names:
        pl = Replicate()
        for i, e in enumerate(pspec):
            names = (e,) if isinstance(e, str) else tuple(e or ())
            if name in names:
                pl = Shard(i)
                break
        out.append(pl)
    for e in pspec:
        if isinstance(e, tuple):
            order = [mesh.axis_names.index(a) for a in e
                     if a in mesh.axis_names]
            if order != sorted(order):
                raise ValueError(f"spec entry {e} is not in the mesh's "
                                 f"order {mesh.axis_names}")
    return tuple(out)


def check_placements(t, pl: tuple, what: str) -> None:
    """A cache or state written in place through its local shard must
    already have the placements ``pl`` its region takes (a redistributed
    copy would take the write and be thrown away)."""
    if tuple(t.placements) != pl:
        raise ValueError(f"{what} placements {tuple(t.placements)} are not "
                         f"the decode's {pl}; make it from its specs under "
                         "the same rules")


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x, *axes: Optional[str]):
    """Redistribute a ``DTensor`` to the placements the logical ``axes``
    resolve to under the installed rules (a sum left pending by a product
    is reduced on the way); a plain tensor, or any tensor off a bound
    mesh, comes back as it is."""
    m = bound_mesh()
    if m is None or _CTX.rules is None or not is_dtensor(x):
        return x
    pl = placements(resolve(axes), m)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(m.device_mesh, pl)


class _GradPlaced(torch.autograd.Function):
    """Identity whose backward redistributes the gradient to ``pl``."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def shard_both(x, *axes: Optional[str]):
    """:func:`shard` whose gradient is placed the same way, as JAX places
    the cotangent of a ``with_sharding_constraint``.  Where a reshape
    follows or precedes it, the gradient then meets the reshape in whole
    heads, whatever placements the products behind it leave (under
    ``fsdp`` a product's gradient may come back sharded over every rank on
    a dim the reshape splits)."""
    x = shard(x, *axes)
    if not is_dtensor(x) or bound_mesh() is None or not x.requires_grad:
        return x
    return _GradPlaced.apply(x, tuple(x.placements))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: DTensor takes
    a local shard's strides as its own, and a gradient leaving a region as
    a transposed view cannot be viewed back through the products before
    it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    return _ContiguousGrad.apply(x) if x.requires_grad else x


# Callables handed (device mesh, in placements, out placements) of every
# region as it is made: the dry run reads from them how many ranks split a
# region's work (``launch/dryrun.py``).  Empty otherwise.
REGION_OBSERVERS: list = []


def local_region(fn: Callable, out_pspecs, in_pspecs,
                 partial_grad: Tuple[str, ...] = (),
                 partial_out: Tuple[str, ...] = ()) -> Callable:
    """``shard_map`` on the installed bound mesh: ``fn`` runs on each
    rank's local shards and returns one tensor (or, when ``out_pspecs`` is
    a list of specs, a tuple of as many), the in/out specs over mesh
    axis names as in ``shard_map`` (``None`` for an argument that is not a
    tensor).  The inputs are redistributed to the in specs first.  The
    output is a sum still pending over the mesh axes in ``partial_out``
    (the ``psum`` left to :func:`shard`, which differentiates it).  An
    input replicated over the mesh axes in ``partial_grad``, whose ranks
    read different parts of it or meet different tokens, gets its gradient
    as a sum pending over those axes."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    m = bound_mesh()

    def pl(s, partial=()):  # local_map reads a list as one tensor's
        if s is None:       # placements
            return None
        return [Partial() if a in partial and p.is_replicate() else p
                for a, p in zip(m.axis_names, placements(s, m))]

    out = (tuple(pl(s, partial_out) for s in out_pspecs)
           if isinstance(out_pspecs, list) else pl(out_pspecs, partial_out))
    ins = tuple(pl(s) for s in in_pspecs)
    for observe in REGION_OBSERVERS:
        observe(m.device_mesh, ins, out)
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=tuple(pl(s, partial_grad)
                                              for s in in_pspecs),
                     device_mesh=m.device_mesh, redistribute_inputs=True)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map ``fn`` over the leaves of nested dicts with equal keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


# The collectives of a region, over one named mesh axis of the installed
# bound mesh, on the local tensors (``lax.psum`` / ``lax.pmax`` /
# ``lax.all_gather`` inside ``shard_map``); over ``None`` (an axis the
# rules keep whole) each is its input.  They are not differentiated:
# the regions that use them serve (flash-decode); a region on a training
# path returns a pending sum for ``redistribute`` to reduce instead.
def _axis_group(axis: str):
    return bound_mesh().device_mesh.get_group(axis)


def _all_reduce(x: torch.Tensor, axis: str, op) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    torch.distributed.all_reduce(out, op=op, group=_axis_group(axis))
    return out


def psum(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    if axis is None:
        return x
    return _all_reduce(x, axis, torch.distributed.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    if axis is None:
        return x
    return _all_reduce(x, axis, torch.distributed.ReduceOp.MAX)


def all_gather(x: torch.Tensor, dim: int, axis: Optional[str]
               ) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in rank
    order."""
    if axis is None:
        return x
    group = _axis_group(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x)
             for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


# --------------------------------------------------------------- tree utilities
def tree_map_specs(fn, tree: Tree) -> Tree:
    return tree_map(fn, tree)


def shape_tree(specs: Tree) -> Tree:
    """ParamSpec tree -> ``meta`` tensor tree (shapes and dtypes, no
    storage)."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def sharding_tree(specs: Tree, mesh, rules: Dict[str, Any]) -> Tree:
    """ParamSpec tree -> the DTensor placements of each leaf on ``mesh``."""
    return tree_map_specs(
        lambda s: placements(resolve(s.axes, rules), mesh), specs)


def spec_bytes(specs: Tree) -> int:
    total = 0
    for s in tree_leaves(specs):
        n = 1
        for d in s.shape:
            n *= d
        total += n * s.dtype.itemsize
    return total


def distribute_tree(params: Tree, specs: Tree, mesh, rules: Dict[str, Any]
                    ) -> Tree:
    """Place a parameter tree on a bound ``mesh`` (the JAX package's
    ``device_put`` with ``sharding_tree``): each leaf becomes a
    ``DTensor`` with its spec's placements.  Every rank holds the same
    full tree (the same seed, or the same converted weights) and keeps its
    own shard of it: nothing goes over the wire."""
    from torch.distributed.tensor import distribute_tensor
    dm = mesh.device_mesh
    return tree_map(lambda p, s: distribute_tensor(
        p, dm, placements(resolve(s.axes, rules), mesh), src_data_rank=None),
        params, specs)


def _draw(shape, scale: float, dtype, generator, device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def init_params(specs: Tree, generator: torch.Generator,
                device="cuda") -> Tree:
    """Materialise a random parameter tree from a ParamSpec tree.

    Drawn in float32 and cast to the spec dtype, as the JAX package does.
    Leaves are made one at a time on ``device`` and a stacked leaf one
    layer at a time, so the float32 temporary is never larger than one
    layer's weight."""
    dev = require_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, "
                         f"parameters are asked for on {dev}")

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        scale = s.scale if s.scale is not None else fan_in ** -0.5
        if s.axes and s.axes[0] == "layers":
            out = torch.empty(s.shape, dtype=s.dtype, device=dev)
            for i in range(s.shape[0]):
                out[i] = _draw(s.shape[1:], scale, s.dtype, generator, dev)
            return out
        return _draw(s.shape, scale, s.dtype, generator, dev)

    return tree_map(one, specs)
