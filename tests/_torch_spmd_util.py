"""Rank functions for the port's SPMD tests (``tests/test_torch_spmd*.py``).

Each runs in a spawned ``gloo`` rank on the CPU (``repro_torch.launch.
ranks.run_ranks``) and imports the port only: the parent test holds what
comes back against the JAX package and the port's one-rank run.  Inputs
arrive as numpy trees, so every rank starts from the same values."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build
from repro_torch.models.sharding import (distribute_tree, make_rules,
                                         tree_leaves, tree_map, use_mesh)

AXES = ("data", "model")


def jobs_rank(rank, jobs):
    """Several rank functions in one spawn (one process group): ``jobs`` is
    a list of (function name, args); returns their results in order."""
    return [globals()[name](rank, *args) for name, args in jobs]


def small_cfg(name: str, **kw):
    return get_config(name).reduced().replace(**kw)


def _full(t):
    from repro_torch.models.sharding import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _params(model, params_np, f32: bool):
    p = from_numpy_tree(params_np, "cpu", specs=model.param_specs)
    return tree_map(lambda t: t.float(), p) if f32 else p


def ring_rank(rank, shape, names, axis, xs):
    """This rank's ring sum of ``xs[i]`` over ``axis``, ``i`` its index along
    ``axis``; and the ring's wire counts."""
    from repro_torch.train.compression import WIRE, ring_allreduce_int8
    mesh = make_mesh(shape, names, "cpu")
    with use_mesh(mesh, {}):
        r = mesh.local_rank(axis)
        return ring_allreduce_int8(torch.from_numpy(xs[r]), axis).numpy(), \
            dict(WIRE)


def train_rank(rank, shape, name, cfg_kw, params_np, batch_np, steps,
               compression, lr, f32, warmup=100, strategy="tp"):
    """``steps`` train steps on the mesh under the rules of ``strategy``;
    (losses, grad norms, the final parameters as full tensors)."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import init_state, make_train_step
    cfg = small_cfg(name, **cfg_kw)
    model = build(cfg)
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, "train", strategy=strategy)
    params = _params(model, params_np, f32)
    with use_mesh(mesh, rules):
        state = init_state(distribute_tree(params, model.param_specs, mesh,
                                           rules))
        batch = shard_batch(batch_np, mesh, rules)
        step = make_train_step(model, OptConfig(lr=lr, warmup_steps=warmup),
                               grad_compression=compression)
        losses, norms = [], []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(_full(m["grad_norm"])))
        return losses, norms, tree_map(_full, state.params)


def sync_rank(rank, shape, name, cfg_kw, params_np, batch_np,
              strategy="tp"):
    """One step's gradients on the mesh, synced twice from the same
    autograd output: by the int8 ring (``_compressed_sync``) and exactly
    (``_reduce_to_params``), as full tensors; and each leaf's ring bound,
    2(N-1) x 0.5/127 x the sum over the data ranks of the abs-max of what
    each hands the ring, the largest over the model shards."""
    import torch.distributed as dist
    from repro_torch.models.sharding import tree_leaves
    from repro_torch.train.train_loop import (_compressed_sync,
                                              _reduce_to_params,
                                              loss_and_grads)
    cfg = small_cfg(name, **cfg_kw)
    model = build(cfg)
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, "train", strategy=strategy)
    params = _params(model, params_np, True)
    N = mesh.shape["data"]
    d = AXES.index("data")
    with use_mesh(mesh, rules):
        pd = distribute_tree(params, model.param_specs, mesh, rules)
        _, grads = loss_and_grads(model, pd, shard_batch(batch_np, mesh,
                                                         rules))
        ring = _compressed_sync(grads, pd)
        exact = _reduce_to_params(grads, pd)
        bounds = []
        for g, p in zip(tree_leaves(grads), tree_leaves(pd)):
            mid = list(p.placements)
            mid[d] = g.placements[d]          # the data axis left pending
            amax = g.redistribute(p.device_mesh, mid).to_local().abs().max()
            dist.all_reduce(amax, group=mesh.device_mesh.get_group("data"))
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
            bounds.append(2 * (N - 1) * 0.5 / 127 * float(amax))
        return (tree_map(_full, ring), tree_map(_full, exact), bounds,
                [str(g.placements) for g in tree_leaves(grads)])


def fsdp_sync_rank(rank, shape):
    """``_compressed_sync`` and the exact sync (``_reduce_to_params``) of
    gradients beside parameters placed as the ``fsdp`` rules place them:
    "a" replicated, its gradient pending over both axes; "b" sharded over
    (data, model) on dim 0, its gradient pending over data and sharded over
    model; "c" the same parameter with its gradient already summed and
    sharded as it is (as autograd leaves one whose forward gathered it).
    Each rank's local parts are drawn from its rank.  Returns, by leaf, the
    two syncs as full tensors, their placements, and the ring's bound: 2(N-1)
    x 0.5/127 x the sum over the data ranks of the abs-max of what each
    hands the ring, the largest over the model ranks."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, distribute_tensor
    from repro_torch.models.sharding import P, placements
    from repro_torch.train.train_loop import (_compressed_sync,
                                              _reduce_to_params)
    mesh = make_mesh(shape, AXES, "cpu")
    dm, N = mesh.device_mesh, mesh.shape["data"]
    gen = torch.Generator().manual_seed(100 + rank)
    with use_mesh(mesh, make_rules(None, mesh, "train", strategy="fsdp")):
        rep, both = P(None, None), P(("data", "model"), None)
        params = {k: distribute_tensor(torch.ones(8, 4), dm,
                                       placements(s, mesh))
                  for k, s in (("a", rep), ("b", both), ("c", both))}
        m = shape[1]
        grads = {
            "a": DTensor.from_local(torch.randn(8, 4, generator=gen), dm,
                                    [Partial(), Partial()]),
            "b": DTensor.from_local(torch.randn(8 // m, 4, generator=gen),
                                    dm, [Partial()] + list(
                                        placements(P("model", None), mesh))[1:],
                                    shape=(8, 4), stride=(4, 1)),
            "c": DTensor.from_local(torch.randn(8 // (N * m), 4,
                                                generator=gen), dm,
                                    placements(both, mesh), shape=(8, 4),
                                    stride=(4, 1))}
        ring = _compressed_sync(grads, params)
        exact = _reduce_to_params(grads, params)
        out = {}
        for k, g in grads.items():
            mid = list(params[k].placements)
            mid[0] = g.placements[0]          # the data axis left pending
            amax = g.redistribute(dm, mid).to_local().abs().max()
            dist.all_reduce(amax, group=dm.get_group("data"))
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
            out[k] = {"ring": ring[k].full_tensor(),
                      "exact": exact[k].full_tensor(),
                      "placements": (str(ring[k].placements),
                                     str(params[k].placements)),
                      "bound": 2 * (N - 1) * 0.5 / 127 * float(amax)}
        return out


def staged_rank(rank):
    """The host group's counts in this rank (``launch/host_group.py``)."""
    from repro_torch.launch import host_group
    return dict(host_group.STAGED)


def decode_rank(rank, shape, name, cfg_kw, params_np, prompt, steps,
                int8_tp, shape_kind="prefill", forced=None):
    """Greedy decode on the mesh: (tokens, every step's last logits); with
    ``forced`` (B, steps) those tokens are fed instead of the argmax."""
    from repro_torch.runtime.serving import make_serve_step, prefill_and_pad
    cfg = small_cfg(name, **cfg_kw)
    model = build(cfg)
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, shape_kind)
    if int8_tp:
        rules["__tp_int8__"] = True
    params = _params(model, params_np, cfg.dtype == "float32")
    with use_mesh(mesh, rules), torch.no_grad():
        pd = distribute_tree(params, model.param_specs, mesh, rules)
        batch = shard_batch({"tokens": prompt}, mesh, rules)
        S = prompt.shape[1]
        logits, cache = prefill_and_pad(model, pd, batch, S + steps)
        step = make_serve_step(model)
        toks, all_logits = [], [_full(logits)[:, -1]]
        cur = torch.argmax(_full(logits)[:, -1], -1)[:, None].to(torch.int32)
        for i in range(steps):
            if forced is not None:
                cur = torch.from_numpy(forced[:, i:i + 1])
            toks.append(cur)
            tok = shard_batch({"tokens": cur.numpy()}, mesh, rules)["tokens"]
            logits, cache = step(pd, cache, tok, S + i)
            all_logits.append(_full(logits)[:, -1])
            cur = torch.argmax(_full(logits)[:, -1], -1)[:, None].to(
                torch.int32)
        return torch.cat(toks, 1), torch.stack(all_logits, 1)


def moe_rank(rank, shape, name, cfg_kw, params_np, x):
    """``moe_ffn`` with experts over ``model``: (out, aux)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.moe import moe_ffn, moe_specs
    from repro_torch.models.sharding import placements, resolve
    cfg = small_cfg(name, **cfg_kw)
    specs = moe_specs(cfg)
    params = tree_map(lambda t: t.float(),
                      from_numpy_tree(params_np, "cpu", specs=specs))
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, "train")
    with use_mesh(mesh, rules), torch.no_grad():
        pd = distribute_tree(params, specs, mesh, rules)
        xd = distribute_tensor(torch.from_numpy(x), mesh.device_mesh,
                               placements(resolve(("batch", "seq", None)),
                                          mesh), src_data_rank=None)
        y, aux = moe_ffn(cfg, pd, xd)
        return _full(y), float(_full(aux))


def moe_grad_rank(rank, shape, name, cfg_kw, params_np, x, c):
    """The gradients of ``sum(moe_ffn(x) * c) + aux`` with respect to x, the
    router and the expert tables, experts over ``model``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.moe import moe_ffn, moe_specs
    from repro_torch.models.sharding import placements, resolve
    cfg = small_cfg(name, **cfg_kw)
    specs = moe_specs(cfg)
    params = tree_map(lambda t: t.float(),
                      from_numpy_tree(params_np, "cpu", specs=specs))
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, "train")
    with use_mesh(mesh, rules):
        pd = distribute_tree(params, specs, mesh, rules)
        xd = distribute_tensor(torch.from_numpy(x), mesh.device_mesh,
                               placements(resolve(("batch", "seq", None)),
                                          mesh), src_data_rank=None)
        leaves = [xd, pd["router"], pd["wg"], pd["wd"]]
        for t in leaves:
            t.requires_grad_(True)
        y, aux = moe_ffn(cfg, pd, xd)
        ((y * torch.from_numpy(c)).sum() + aux).backward()
        return [_full(t.grad) for t in leaves]


def attn_rank(rank, shape, name, cfg_kw, params_np, x):
    """One causal self-attention prefill (B5's path) on the mesh, forward
    and the gradient of its sum with respect to x."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.attention import attn_forward, attn_specs
    from repro_torch.models.sharding import placements, resolve
    cfg = small_cfg(name, **cfg_kw)
    specs = attn_specs(cfg)
    params = tree_map(lambda t: t.float(),
                      from_numpy_tree(params_np, "cpu", specs=specs))
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, "train")
    with use_mesh(mesh, rules):
        pd = distribute_tree(params, specs, mesh, rules)
        xd = distribute_tensor(torch.from_numpy(x), mesh.device_mesh,
                               placements(resolve(("batch", "seq", None)),
                                          mesh), src_data_rank=None)
        xd.requires_grad_(True)
        pos = torch.arange(x.shape[1])
        y = attn_forward(cfg, pd, xd, pos)
        y.sum().backward()
        return _full(y).detach(), _full(xd.grad)


def proj_rank(rank, shape, h, w):
    """``int8_ring_proj`` of the model-sharded h (..., F) and w (F, d), F
    the MLP's hidden axis (``act_ff``)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.layers import int8_ring_proj
    from repro_torch.models.sharding import P, placements
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(None, mesh, "prefill")
    with use_mesh(mesh, rules), torch.no_grad():
        lead = (None,) * (h.ndim - 1)
        hd = distribute_tensor(torch.from_numpy(h), mesh.device_mesh,
                               placements(P(*lead, "model"), mesh),
                               src_data_rank=None)
        wd = distribute_tensor(torch.from_numpy(w), mesh.device_mesh,
                               placements(P("model", None), mesh),
                               src_data_rank=None)
        return _full(int8_ring_proj(hd, wd, "act_ff"))


# ------------------------------------------------ the five other families
def _counting_plain(mod, name, seen):
    """Wrap ``mod.name`` (a kernel's plain version) so that each call
    records the shape of its first argument in ``seen``; returns the
    original to put back."""
    orig = getattr(mod, name)

    def counted(x, *a, **k):
        seen.append(tuple(x.shape))
        return orig(x, *a, **k)

    setattr(mod, name, counted)
    return orig


def family_grad_rank(rank, shape, name, cfg_kw, params_np, batch_np,
                     inject_np=None, strategy="tp"):
    """One ``loss_and_grads`` of a reduced config on the mesh under the
    rules of ``strategy``, float32:
    the loss, every gradient reduced to its parameter's placements (as
    full tensors), and the (B, T, H, P) shapes the SSD scan's plain
    version was handed (its calls inside the regions)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.train.train_loop import _reduce_to_params, loss_and_grads
    cfg = small_cfg(name, **cfg_kw)
    model = build(cfg)
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, "train", strategy=strategy)
    params = _params(model, params_np, True)
    seen = []
    orig = _counting_plain(ssd_ops, "ssd_scan_plain", seen)
    try:
        with use_mesh(mesh, rules):
            pd = distribute_tree(params, model.param_specs, mesh, rules)
            batch = shard_batch(batch_np, mesh, rules)
            inject = {k: torch.from_numpy(v)
                      for k, v in (inject_np or {}).items()}
            loss, grads = loss_and_grads(model, pd, batch, **inject)
            grads = _reduce_to_params(grads, pd)
            return float(_full(loss)), tree_map(_full, grads), seen
    finally:
        ssd_ops.ssd_scan_plain = orig


def family_loss_rank(rank, shape, name, cfg_kw, params_np, batch_np,
                     inject_np=None, strategy="tp"):
    """The loss of a reduced config on the mesh, float32, no gradient."""
    cfg = small_cfg(name, **cfg_kw)
    model = build(cfg)
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, "train", strategy=strategy)
    params = _params(model, params_np, True)
    with use_mesh(mesh, rules), torch.no_grad():
        pd = distribute_tree(params, model.param_specs, mesh, rules)
        batch = shard_batch(batch_np, mesh, rules)
        inject = {k: torch.from_numpy(v) for k, v in (inject_np or {}).items()}
        return float(_full(model.loss_fn(pd, batch, None, **inject)))


def family_decode_rank(rank, shape, name, cfg_kw, params_np, batch_np,
                       steps, shape_kind="prefill", strategy="tp"):
    """Prefill and ``steps`` greedy steps of a reduced config on the mesh
    (float32 per ``cfg_kw``): the tokens, the last position's logits of
    the prefill and of every step, and the (B, T, H, P) shapes the SSD
    scan's plain version was handed."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.runtime.serving import make_serve_step, prefill_and_pad
    cfg = small_cfg(name, **cfg_kw)
    model = build(cfg)
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, shape_kind, strategy=strategy)
    params = _params(model, params_np, cfg.dtype == "float32")
    seen = []
    orig = _counting_plain(ssd_ops, "ssd_scan_plain", seen)
    try:
        with use_mesh(mesh, rules), torch.no_grad():
            pd = distribute_tree(params, model.param_specs, mesh, rules)
            batch = shard_batch(batch_np, mesh, rules)
            S = batch_np["tokens"].shape[1]
            kw = ({"src_len": batch_np["frames"].shape[1]}
                  if "frames" in batch_np else {})
            logits, cache = prefill_and_pad(model, pd, batch, S + steps, **kw)
            step = make_serve_step(model)
            toks, last = [], [_full(logits)[:, -1]]
            cur = torch.argmax(last[-1], -1)[:, None].to(torch.int32)
            for i in range(steps):
                toks.append(cur)
                tok = shard_batch({"tokens": cur.numpy()}, mesh,
                                  rules)["tokens"]
                logits, cache = step(pd, cache, tok, S + i)
                last.append(_full(logits)[:, -1])
                cur = torch.argmax(last[-1], -1)[:, None].to(torch.int32)
            return torch.cat(toks, 1), torch.stack(last, 1), seen
    finally:
        ssd_ops.ssd_scan_plain = orig


def _flat_names(tree, prefix=""):
    """The leaves' paths of a nested dict, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _flat_names(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def zero1_rank(rank, shape, name, cfg_kw, params_np, batch_np, steps):
    """``steps`` train steps of a reduced config on the mesh, float32, with
    the moments placed as the parameters (``init_state``) and by the
    ZeRO-1 specs (``opt_state_specs`` under ``zero_rules``): each run's
    losses, norms and final parameters (full tensors)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.sharding import placements, resolve
    from repro_torch.train.optimizer import (OptConfig, opt_state_specs,
                                             zero_rules)
    from repro_torch.train.train_loop import init_state, make_train_step
    cfg = small_cfg(name, **cfg_kw)
    model = build(cfg)
    mesh = make_mesh(shape, AXES, "cpu")
    rules = make_rules(cfg, mesh, "train")
    out = []
    for zero1 in (False, True):
        params = _params(model, params_np, True)
        with use_mesh(mesh, rules):
            state = init_state(distribute_tree(params, model.param_specs,
                                               mesh, rules))
            if zero1:
                zr = zero_rules(rules, mesh)
                ospecs = opt_state_specs(model.param_specs, mesh, rules)
                place = (lambda t, s: distribute_tensor(
                    t.full_tensor(), mesh.device_mesh,
                    placements(resolve(s.axes, zr), mesh),
                    src_data_rank=None))
                state.m = tree_map(place, state.m, ospecs)
                state.v = tree_map(place, state.v, ospecs)
            batch = shard_batch(batch_np, mesh, rules)
            step = make_train_step(model, OptConfig(lr=1e-3,
                                                    warmup_steps=1))
            losses, norms = [], []
            for _ in range(steps):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(_full(m["grad_norm"])))
            moved = sum(int(a.placements != b.placements) for a, b in zip(
                tree_leaves(state.m), tree_leaves(state.params)))
            out.append((losses, norms, tree_map(_full, state.params),
                        moved))
    return out
