"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on fake
tensors, on a fake process group of the production mesh's size.

    python -m repro_torch.launch.dryrun --arch mamba2-1.3b --shape long_500k --mesh multi

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each cell for 256 or 512 placeholder devices.  An eager PyTorch step has no
program to compile, so this module runs the step itself, in one process
with no device: a ``torch.distributed`` group of the ``fake`` backend with
the production mesh's size (rank 0 of 256 or 512; every collective returns
at once), a ``DeviceMesh`` over it, and the parameters, batch, cache and
optimizer state as ``FakeTensor`` s (shapes and dtypes, no storage) placed
by the cell's rules.  Per cell it

  1. runs the right step — ``make_train_step`` with the ZeRO-1 moments
     (``opt_state_specs`` under ``zero_rules``), ``model.prefill`` or
     ``model.decode`` — as the reference's ``_lower_train`` /
     ``_lower_prefill`` / ``_lower_decode`` lower it: success is the
     runnability proof;
  2. counts its operations (:class:`OpCounter`), its collectives
     (``comm_analysis.CollectiveRecorder``) and, where torch's
     ``MemTracker`` runs under fake tensors, rank 0's peak bytes;
  3. prices it on the H100 SXM data sheet (``devices.H100_SXM``) with the
     reference's roofline and writes a JSON artifact under ``build/dryrun/``.

Every kernel call takes its plain version, since fake tensors lie on the
CPU.  That is the path the reference's dry run lowers as well: its
``attn_impl`` defaults to ``"xla"`` (``configs/base.py``), so it compiles
the plain products and not the Pallas kernels.  The clip's scale
multiplies the gradients as a tensor (fake tensors have no value to read
back to the host, which the train step does on a card).

The artifact keeps the reference's field names where they mean the same
(``analytic_residency_per_device``, ``model_flops``, ``roofline``,
``collectives``) and renames those that do not: ``op_flops`` and
``op_bytes`` (the products' flops and the bytes each eager operation reads
and writes, with no fusion) for ``hlo_flops`` / ``hlo_bytes``, ``step_s``
for ``lower_s`` / ``compile_s``.  ``global.op_flops`` counts the step's
math once; ``per_device`` holds rank 0's share.  The analytic residency
(:func:`_sharded_bytes`, :func:`analytic_residency`, :func:`model_flops`)
is the reference's arithmetic, statement for statement.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ASSIGNED, SHAPES, get_config, get_shape, shape_applicable
from ..core.hardware import roofline
from ..models import build
from ..models import sharding as sh
from ..models.sharding import make_rules, resolve, use_mesh
from ..train import optimizer as opt_mod
from ..train.optimizer import OptConfig, opt_state_specs, zero_rules
from ..train.train_loop import TrainState, make_train_step
from .comm_analysis import CollectiveRecorder, _tensors, summarize
from .devices import H100_SXM
from .mesh import Mesh, make_production_mesh

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")


def _spec_leaves(specs) -> list:
    """A ParamSpec tree's leaves in JAX's flattening order (dict keys
    sorted), so that the sums below add in the reference's order."""
    if isinstance(specs, dict):
        return [leaf for k in sorted(specs) for leaf in _spec_leaves(specs[k])]
    return [specs]


def _sharded_bytes(specs, mesh, rules) -> float:
    """Per-device bytes of a ParamSpec tree under the given rules."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0.0
    for s in _spec_leaves(specs):
        n = float(np.prod(s.shape)) * s.dtype.itemsize
        pspec = resolve(s.axes, rules)
        denom = 1
        for entry in pspec:
            if entry is None:
                continue
            for ax in ((entry,) if isinstance(entry, str) else entry):
                denom *= sizes.get(ax, 1)
        total += n / denom
    return total


def analytic_residency(model, cfg, shape, mesh, rules) -> Dict:
    """Expected per-device residency (bf16 semantics), the reference's
    model: parameters, moments, gradients and activations by formula."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    batch_shards = 1
    br = rules.get("batch")
    for ax in ((br,) if isinstance(br, str) else (br or ())):
        batch_shards *= sizes.get(ax, 1)
    model_shards = sizes.get("model", 1)
    B_loc = max(shape.global_batch // batch_shards, 1)
    d = cfg.d_model or cfg.vit_dim
    S = shape.seq_len
    out = {"params": _sharded_bytes(model.param_specs, mesh, rules)}
    if shape.kind == "train":
        # deployable config: 8-way gradient-accumulation microbatching
        n_micro = 8
        B_mb = max(B_loc // n_micro, 1)
        ospecs = opt_state_specs(model.param_specs, mesh, rules, zero1=True)
        zr = zero_rules(rules, mesh)
        out["adam_moments"] = 2 * _sharded_bytes(ospecs, mesh, zr)
        out["grads"] = out["params"] * 2          # f32 accumulation buffer
        act_mult = (1 + cfg.ssm_expand) if cfg.family in ("ssm", "hybrid") \
            else 1
        out["remat_activations"] = cfg.n_layers * B_mb * S * d * 2 * act_mult
        out["logits_shard"] = B_mb * S * max(cfg.vocab_size, 1) * 2 \
            / model_shards
        out["working_set"] = 4 * B_mb * S * d * 2
    elif shape.kind == "prefill":
        cspecs = model.cache_specs(shape.global_batch, S, src_len=S)
        out["kv_cache"] = _sharded_bytes(cspecs, mesh, rules)
        out["working_set"] = 6 * B_loc * S * d * 2
    else:
        cspecs = model.cache_specs(shape.global_batch, S, src_len=S)
        out["kv_cache"] = _sharded_bytes(cspecs, mesh, rules)
        out["working_set"] = 8 * B_loc * 1 * d * 2 + B_loc * S * 4
    out["total"] = sum(v for v in out.values())
    return out


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference); N_active for MoE."""
    n = cfg.n_params()
    if cfg.n_experts:
        expert = 3 * cfg.d_model * cfg.moe_d_ff
        n_moe_layers = cfg.n_layers - cfg.first_dense_layers
        n -= n_moe_layers * (cfg.n_experts - cfg.moe_top_k) * expert
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per request


# ------------------------------------------------------------------ counting
def _pieces(dm, placement_lists) -> int:
    """How many ranks hold different parts of an operation's work: the
    product of the mesh dims on which any of the placements is a shard or a
    pending sum (ranks along the other dims repeat each other's work)."""
    n = 1
    for i in range(dm.ndim):
        if any(pl is not None and (pl[i].is_shard() or pl[i].is_partial())
               for pl in placement_lists):
            n *= dm.size(i)
    return n


def _local_bytes(ts) -> int:
    from torch.distributed.tensor import DTensor
    n = 0
    for t in ts:
        t = t._local_tensor if isinstance(t, DTensor) else t
        n += t.numel() * t.element_size()
    return n


class OpCounter(TorchDispatchMode):
    """Counts a step's products (``torch.utils.flop_counter``'s formulas)
    and every operation's bytes read and written, as rank 0 and as the
    whole mesh.

    It sees an operation on DTensors once, at its global shapes (DTensor's
    own local work and collectives run below it): the step's flops count
    in full, rank 0's share is that over the ranks that split the
    operation's output.  It sees the local operations of a ``local_map``
    region, forward and backward, on rank 0's shards: rank 0's share as it
    is, the step's flops that times the ranks that split the region's work
    (``models.sharding.REGION_OBSERVERS``), which every region of a step
    must agree on.  A view reads and writes nothing."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = {"global": 0.0, "rank0": 0.0}
        self.bytes_rank0 = 0.0
        self.region_pieces = set()

    def observe(self, dm, ins, out):
        outs = list(out) if isinstance(out, tuple) else [out]
        self.region_pieces.add(_pieces(dm, list(ins) + outs))

    def _flops(self, func, args, kwargs, out) -> float:
        f = self.registry.get(func._overloadpacket)
        return 0.0 if f is None else float(f(*args, **kwargs, out_val=out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        from torch.distributed.tensor import DTensor
        aliasing = any(r.alias_info is not None
                       for r in func._schema.returns)
        outs = _tensors(out)
        nbytes = 0 if aliasing else _local_bytes(
            _tensors(args) + _tensors(kwargs) + outs)
        self.bytes_rank0 += nbytes
        f = self._flops(func, args, kwargs, out)
        dts = [t for t in outs if isinstance(t, DTensor)]
        if dts:
            self.flops["global"] += f
            self.flops["rank0"] += f / _pieces(dts[0].device_mesh,
                                               [dts[0].placements])
        elif f:
            self.flops["rank0"] += f
            self.flops.setdefault("local", 0.0)
            self.flops["local"] += f
        return out

    def global_flops(self) -> float:
        local = self.flops.get("local", 0.0)
        if not local or not self.region_pieces:    # no mesh: all local
            return self.flops["global"] + local
        if len(self.region_pieces) != 1:
            raise ValueError(f"the step's regions split their work over "
                             f"different numbers of ranks "
                             f"{sorted(self.region_pieces)}")
        return self.flops["global"] + local * next(iter(self.region_pieces))


class _ObservingRegions:
    """The counter told of every region made while the block runs."""

    def __init__(self, counter: OpCounter):
        self.observe = counter.observe

    def __enter__(self):
        sh.REGION_OBSERVERS.append(self.observe)

    def __exit__(self, *exc):
        sh.REGION_OBSERVERS.remove(self.observe)
        return False


class _Swapped:
    """``owner.name`` replaced by ``value`` while the block runs."""

    def __init__(self, owner, name: str, value):
        self.owner, self.name, self.value = owner, name, value

    def __enter__(self):
        self.real = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)
        return False


@torch.no_grad()
def _clip_on_device(grads, max_norm: float):
    """``clip_by_global_norm`` with the scale kept as a tensor: fake tensors
    have no value to read back (the card's step reads it to round a bf16
    gradient once; the operations counted are the same)."""
    leaves = sh.tree_leaves(grads)
    gn = torch.sqrt(opt_mod._global_square_sum(leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in leaves:
        opt_mod._local(g).mul_(scale.to(g.dtype))
    return grads, gn


def _clip_without_host_read() -> _Swapped:
    return _Swapped(opt_mod, "clip_by_global_norm", _clip_on_device)


def _strided_offsets_on_real_tensors():
    """DTensor works out a strided shard's offsets from an index tensor as
    long as the dim that it reads back (``tolist``), which a fake tensor
    cannot give: that arithmetic runs on real tensors, once for each set of
    arguments (where this torch has it)."""
    from torch.distributed.tensor import placement_types as pt
    strided = getattr(pt, "_StridedShard", None)
    real = getattr(strided, "local_shard_size_and_offset", None)
    if real is None:
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    done = {}

    def on_real(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in done:
            with unset_fake_temporarily():
                done[key] = real(*args, **kwargs)
        return done[key]

    return _Swapped(strided, "local_shard_size_and_offset", on_real)


# ------------------------------------------------------------------ the mesh
def _fake_group(n: int) -> None:
    """Rank 0 of a ``fake`` process group of ``n`` ranks (made again if
    this process holds one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def bind_fake(mesh: Mesh) -> Mesh:
    """``mesh`` bound to a ``DeviceMesh`` over a fake group of its size."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = mesh.devices.shape
    _fake_group(int(np.prod(shape)))
    dm = DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                    mesh_dim_names=tuple(mesh.axis_names))
    return Mesh(shape, mesh.axis_names, dm)


def _fake_tree(specs, mesh: Mesh, rules) -> Dict:
    """A ParamSpec tree as fake DTensors placed by ``rules`` (call under a
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import distribute_tensor
    return sh.tree_map(lambda s: distribute_tensor(
        torch.empty(s.shape, dtype=s.dtype), mesh.device_mesh,
        sh.placements(resolve(s.axes, rules), mesh), src_data_rank=None),
        specs)


def _tree_bytes(tree) -> int:
    return _local_bytes(sh.tree_leaves(tree))


class _PeakBytes:
    """Rank 0's peak bytes through torch's ``MemTracker`` (a private tool)
    around ``run``, the tensors ``held`` before it counted; where the
    tracker does not run under fake tensors on this torch, ``run`` runs
    untracked and ``peak`` is None with the reason in ``note``."""

    def __init__(self, held):
        self.held, self.peak, self.note = held, None, None

    def __call__(self, run):
        try:
            from torch.distributed._tools.mem_tracker import MemTracker
            tracker = MemTracker()
            tracker.track_external(*self.held)
            with tracker:
                run()
            self.peak = float(max(
                s.get("Total", 0)
                for s in tracker.get_tracker_snapshot("peak").values()))
        except Exception as e:  # noqa: BLE001 - the tool is private API
            self.note = f"MemTracker: {e!r}"[:300]
            self.peak = None
            run()


# ------------------------------------------------------------------ steps
def _run_train(model, cfg, shape, mesh, rules, n_microbatches: int = 1,
               grad_compression=None):
    pspecs = model.param_specs
    params = _fake_tree(pspecs, mesh, rules)
    ospecs = opt_state_specs(pspecs, mesh, rules, zero1=True)
    zr = zero_rules(rules, mesh)
    m = _fake_tree(ospecs, mesh, zr)
    v = _fake_tree(ospecs, mesh, zr)
    batch = _fake_tree(model.input_specs(shape), mesh, rules)
    state = TrainState(0, params, m, v)
    step = make_train_step(model, OptConfig(),
                           n_microbatches=n_microbatches,
                           grad_compression=grad_compression)
    resident = {"params": _tree_bytes(params),
                "adam_moments": _tree_bytes(m) + _tree_bytes(v)}
    return (lambda: step(state, batch)), resident, (state, batch)


def _run_prefill(model, cfg, shape, mesh, rules):
    params = _fake_tree(model.param_specs, mesh, rules)
    batch = _fake_tree(model.input_specs(shape), mesh, rules)
    return (lambda: model.prefill(params, batch)), \
        {"params": _tree_bytes(params)}, (params, batch)


def _run_decode(model, cfg, shape, mesh, rules):
    params = _fake_tree(model.param_specs, mesh, rules)
    cache = _fake_tree(model.cache_specs(shape.global_batch, shape.seq_len,
                                         src_len=shape.seq_len), mesh, rules)
    tokens = _fake_tree(model.input_specs(shape), mesh, rules)["tokens"]
    # the last position: the whole cache is live
    return (lambda: model.decode(params, cache, tokens, shape.seq_len - 1)), \
        {"params": _tree_bytes(params), "kv_cache": _tree_bytes(cache)}, \
        (params, cache, tokens)


def _divides(specs, mesh, rules) -> bool:
    """Whether every sharded dim of every leaf divides over its mesh axes
    (rank 0's shard is then exactly the leaf over the shards)."""
    sizes = mesh.shape
    for s in _spec_leaves(specs):
        for dim, entry in zip(s.shape, resolve(s.axes, rules)):
            n = 1
            for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
                n *= sizes.get(ax, 1)
            if dim % n:
                return False
    return True


def _cell(arch: str, shape_name: str, multi_pod: bool,
          opt_overrides: Optional[Dict] = None, *, strategy: str = "tp",
          decode_attn: str = "tp", tp_collective: str = "ar",
          scan_layers: bool = False) -> Dict:
    shape = get_shape(shape_name)
    cfg = get_config(arch).replace(scan_layers=scan_layers,
                                   decode_attn=decode_attn,
                                   tp_collective=tp_collective)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "skipped", "reason": reason}

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.devices.size
    rules = make_rules(cfg, mesh, shape.kind, strategy=strategy)
    if tp_collective == "int8_ring":
        rules["__tp_int8__"] = True
    model = build(cfg)
    opt_overrides = opt_overrides or {}
    bound = bind_fake(mesh)

    from torch._subclasses.fake_tensor import FakeTensorMode
    counter, colls = OpCounter(), CollectiveRecorder()
    t0 = time.time()
    with FakeTensorMode(), use_mesh(bound, rules), \
            _ObservingRegions(counter), _clip_without_host_read(), \
            _strided_offsets_on_real_tensors():
        if shape.kind == "train":
            run, resident, held = _run_train(model, cfg, shape, bound,
                                             rules, **opt_overrides)
        elif shape.kind == "prefill":
            run, resident, held = _run_prefill(model, cfg, shape, bound,
                                               rules)
        else:
            run, resident, held = _run_decode(model, cfg, shape, bound,
                                              rules)
        if isinstance(held[0], TrainState):
            held = (held[0].params, held[0].m, held[0].v, held[1])
        peak = _PeakBytes([getattr(t, "_local_tensor", t)
                           for t in _tensors(held)])

        def counted():
            with colls, counter:
                run()

        peak(counted)
    step_s = time.time() - t0

    coll_sum = summarize(colls.ops)
    flops_dev = counter.flops["rank0"]
    bytes_dev = counter.bytes_rank0
    wire_dev = float(coll_sum["total_wire_bytes_per_device"])
    wire16_dev = float(coll_sum["total_wire_bytes_bf16_per_device"])
    terms = roofline(flops_dev * n_dev, bytes_dev * n_dev, wire16_dev * n_dev,
                     n_dev, H100_SXM, links_used=H100_SXM.ici_links)
    mf = model_flops(cfg, shape)
    residency = analytic_residency(model, cfg, shape, mesh, rules)
    even = _divides(model.param_specs, mesh, rules)

    out = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "status": "ok",
        "strategy": strategy,
        "step_s": round(step_s, 2),
        "analytic_residency_per_device": residency,
        "per_device": {
            "op_flops": flops_dev,
            "op_bytes": bytes_dev,
            "collective_wire_bytes": wire_dev,
            "collective_wire_bytes_bf16": wire16_dev,
            "resident_bytes": resident,
            "every_sharded_dim_divides": even,
            "peak_bytes": peak.peak,
            **({"peak_bytes_note": peak.note} if peak.peak is None else {}),
        },
        "global": {
            "op_flops": counter.global_flops(),
            "op_bytes": bytes_dev * n_dev,
            "collective_wire_bytes": wire_dev * n_dev,
            "collective_wire_bytes_bf16": wire16_dev * n_dev,
        },
        "roofline": {
            "device": H100_SXM.name,
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "bound_s": terms.bound_s,
        },
        "model_flops": mf,
        "useful_flops_ratio": mf / (flops_dev * n_dev)
        if flops_dev else 0.0,
        "collectives": coll_sum,
    }
    return out


# ------------------------------------------------------------------ command line
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (assigned pool)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="",
                    help="artifact suffix for experiment variants")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--decode-attn", default="tp", choices=["tp", "sp"])
    ap.add_argument("--tp-collective", default="ar",
                    choices=["ar", "int8_ring"])
    ap.add_argument("--scan-layers", action="store_true",
                    help="accepted for the reference's flags; the port "
                         "runs its layer stacks as a loop either way")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    results = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "2x16x16" if multi else "16x16"
                tag = f"__{args.tag}" if args.tag else ""
                fname = f"{arch}__{shape}__{mesh_name}{tag}.json".replace(
                    "/", "_")
                path = os.path.join(args.out, fname)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") != "error":
                        print(f"[skip-cached] {fname}")
                        continue
                    print(f"[retry-error] {fname}")
                print(f"[run] {arch} x {shape} x {mesh_name}", flush=True)
                try:
                    opt = {"n_microbatches": args.microbatches,
                           "grad_compression": args.grad_compression}
                    res = _cell(arch, shape, multi, opt,
                                strategy=args.strategy,
                                decode_attn=args.decode_attn,
                                tp_collective=args.tp_collective,
                                scan_layers=args.scan_layers)
                except Exception as e:  # noqa: BLE001 - record failures
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                results.append(res)
                status = res["status"]
                extra = ""
                if status == "ok":
                    r = res["roofline"]
                    est = res["analytic_residency_per_device"]["total"]
                    extra = (f" dom={r['dominant']}"
                             f" comp={r['compute_s']*1e3:.2f}ms"
                             f" mem={r['memory_s']*1e3:.2f}ms"
                             f" coll={r['collective_s']*1e3:.2f}ms"
                             f" est={est/2**30:.2f}GiB"
                             f" step={res['step_s']:.0f}s")
                elif status == "error":
                    extra = " " + res["error"][:200]
                print(f"[{status}] {arch} x {shape} x {mesh_name}{extra}",
                      flush=True)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_err = sum(1 for r in results if r["status"] == "error")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
