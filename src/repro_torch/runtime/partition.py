"""Edge/cloud partitioned execution — RoboECC's runtime artifact.

Counterpart of ``src/repro/runtime/partition.py`` for the VLA request
path and the dense LM.  The model's layer stack is cut at a *dynamic*
split index that lives inside a static **parameter-sharing pool**
``[pool_start, pool_end)``: both tiers hold the pool layers' weights, so
moving the split inside the pool ships no weight and rebuilds nothing.
The JAX package keeps the cut a traced argument and runs each pool layer
under a ``lax.cond``; in eager PyTorch a Python ``if`` per pool layer gives
the same guarantee.

A two-pool plan adds a second pool ``[pool2_start, pool2_end)`` around the
cloud→edge tail cut of an edge→cloud→edge placement and ships two
payloads: the uplink cut activation (``codec``) and the downlink tail
activation (``codec2``).

The cut activation is optionally shipped through the int8 or packed-int4
activation codec (``kernels/activation_codec``).  ``chunk_payload`` slices
an encoded payload into token-axis chunks and ``merge_chunks`` reassembles
them; both codecs quantise per (row, 128-block) with no cross-token state,
so ``decode(merge(chunks)) == decode(payload)`` exactly and the streamed
forward (``run_streamed``) is bit-identical to the monolithic one.

Both tiers run on the one device the executor was made for and share one
parameter tree, as in the JAX package.  On the card both codecs launch
their hand-written kernels (int8: ``quantize`` / ``dequantize``; packed
int4: ``quantize_int4`` / ``dequantize_int4``); int4 at a width that is no
multiple of 256 raises here, before any kernel.  ``LMSplitExecutor``
serves the dense and MoE families; an MoE model's pool may not straddle
its dense/MoE group boundary.

Temporal-delta transport (``core/codec.DeltaCodec``): ``delta_encode``
ships only the token rows whose activation changed since the previous
step against a cloud-side *reference* copy, plus a packed one-bit change
mask (a numpy ``uint8`` array, as in the JAX package, so payloads compare
byte for byte); every R-th frame is a full key frame, byte-identical to
the plain ``encode_activation`` payload, that resyncs the reference.
``DeltaTransport`` keeps the per-robot references, with bytes accounted
against an optional budget in ``runtime.kvcache.ReferenceLedger``; an
evicted robot's next frame is forced back to a key frame.  These run on
the host around the forwards: the abs-max and the change mask are each
read back from the device (two syncs a delta frame), and the changed rows
go through the same codec kernels as a plain payload.

Both executors take an optional ``core.telemetry.FlightRecorder``: with
one, ``run`` records an ``edge_fwd`` span on the ``executor:edge`` lane
and a ``cloud_fwd`` span on the ``executor:cloud`` lane, the one ending
where the other starts, timed by CUDA events on the card (the device is
never synchronised for them) and by the host clock on the CPU; the VLA
executor nests its stages in them (``VLASplitExecutor.run``).  While
``torch.profiler`` records, the same stages are ``roboecc.*`` ranges on
the profiler's clock, recorder or not.  With neither, a stage costs one
check of the profiler's state and one ``is None``: no event, no clock.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import require_device, to_dtype
from ..core.telemetry import stage
from ..kernels.activation_codec import ops as codec
from ..models import transformer as T
from ..models import vla as V
from ..models.layers import embed, rmsnorm, unembed
from ..models.sharding import tree_leaves, tree_map
from ..models.transformer import block_forward, _layer_slice
from .action_graph import DiTGraphs

Tree = Any


def chunk_sizes(total: int, n_chunks: int) -> Sequence[int]:
    """Token-axis slice sizes for ``total`` rows in ``n_chunks`` chunks —
    ``numpy.array_split`` semantics (first ``total % K`` chunks one row
    longer).  The port's own copy of ``chunk_sizes`` in
    ``src/repro/core/pipeline.py``, which the planner shares."""
    K = int(n_chunks)
    if K < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    base, extra = divmod(int(total), K)
    return [base + 1 if i < extra else base for i in range(K)]


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Static pool placement(s) + codec choice; the cut indices themselves
    are dynamic.

    ``codec``: "" (raw), "int8" or "int4" — the wire format for the uplink
    cut activation.  ``pool2_start``/``pool2_end`` (both ``-1`` =
    disabled) place the second pool of an edge→cloud→edge plan; ``codec2``
    is the downlink wire format.

    ``use_codec`` is a DEPRECATED alias for ``codec="int8"`` kept as a
    warning shim for one release — pass ``codec`` explicitly."""
    pool_start: int
    pool_end: int
    use_codec: Optional[bool] = None
    codec: str = ""
    pool2_start: int = -1
    pool2_end: int = -1
    codec2: str = ""

    def __post_init__(self):
        if self.use_codec is not None:
            warnings.warn(
                "SplitPlan(use_codec=...) is deprecated; pass "
                "codec='int8' (or '') instead — use_codec will be removed "
                "next release", DeprecationWarning, stacklevel=3)
        if (self.pool2_start >= 0) != (self.pool2_end >= 0):
            raise ValueError("pool2_start and pool2_end must be set "
                             "together (or both left at -1)")
        if self.two_pool and not (self.pool_end <= self.pool2_start
                                  <= self.pool2_end):
            raise ValueError(
                f"second pool [{self.pool2_start}, {self.pool2_end}) must "
                f"follow the first [{self.pool_start}, {self.pool_end})")

    @property
    def two_pool(self) -> bool:
        return self.pool2_start >= 0

    @property
    def wire_codec(self) -> str:
        if self.codec:
            return self.codec
        return "int8" if self.use_codec else ""

    def clamp(self, split: int) -> int:
        return max(self.pool_start, min(int(split), self.pool_end))

    def clamp2(self, split2: int) -> int:
        return max(self.pool2_start, min(int(split2), self.pool2_end))


# ------------------------------------------------------------------ helpers
def _masked_stack(cfg, pool_params: Tree, x: torch.Tensor, positions,
                  split: int, offset: int, side: str, *, is_moe: bool = False):
    """Run the pool layers that are active on this side of the cut.

    ``side`` names the *predicate*, not the physical tier: ``"edge"`` runs
    layers with ``i < split`` (the below-the-cut half), ``"cloud"`` those
    with ``i >= split``.  A two-pool plan reuses the same predicates around
    its second cut with the tiers swapped."""
    n = tree_leaves(pool_params)[0].shape[0]
    for j in range(n):
        i = offset + j
        if (i < split) if side == "edge" else (i >= split):
            x, _, _ = block_forward(cfg, _layer_slice(pool_params, j), x,
                                    positions, is_moe=is_moe)
    return x


def _codec_block(D: int) -> int:
    return 128 if D % 128 == 0 else D


def encode_activation(x: torch.Tensor, wire_codec) -> Dict:
    """``wire_codec``: "" / False (raw), "int8" / True, or "int4".

    int4 requires ``x.shape[-1] % 256 == 0`` and raises otherwise — a
    silent int8 fallback would ship ~2x the wire bytes the planner
    priced."""
    if not wire_codec:
        return {"x": x}
    if wire_codec == "int4":
        if x.shape[-1] % 256 != 0:
            raise ValueError(
                f"int4 codec needs last dim % 256 == 0, got {tuple(x.shape)}; "
                "use int8 (and plan with the int8 codec) instead")
        p, s = codec.quantize_int4(x)
        return {"q4": p, "s": s}
    if wire_codec not in ("int8", True):
        # refuse rather than silently ship a different format than the
        # planner priced
        raise ValueError(f"no data-plane codec {wire_codec!r}; "
                         "have '', 'int8', 'int4'")
    q, s = codec.quantize(x, block=_codec_block(x.shape[-1]))
    return {"q": q, "s": s}


def decode_activation(payload: Dict, dtype=torch.bfloat16) -> torch.Tensor:
    if "x" in payload:
        return payload["x"]
    dtype = to_dtype(dtype)
    if "q4" in payload:
        return codec.dequantize_int4(payload["q4"], payload["s"], dtype)
    q, s = payload["q"], payload["s"]
    return codec.dequantize(q, s, dtype, block=q.shape[-1] // s.shape[-1])


def payload_bytes(payload: Dict) -> int:
    """Wire bytes of every array in ``payload``: the tensors and the numpy
    change mask of a delta frame alike."""
    return sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor)
               else v.nbytes for v in payload.values()
               if isinstance(v, (torch.Tensor, np.ndarray)))


def chunk_payload(payload: Dict, n_chunks: int) -> List[Dict]:
    """Slice an encoded cut-activation payload into ``n_chunks`` token-axis
    chunks (views, nothing is copied).  Every payload array — raw ``x``,
    int8 ``q``, packed-int4 ``q4`` and the block scales ``s`` — carries
    tokens on axis 1 with per-row scale groups, so slicing commutes with
    the codec.  Chunks for ``n_chunks > tokens`` come out empty and merge
    back harmlessly."""
    S = next(iter(payload.values())).shape[1]
    out: List[Dict] = []
    start = 0
    for sz in chunk_sizes(S, n_chunks):
        out.append({k: v[:, start:start + sz] for k, v in payload.items()})
        start += sz
    return out


def merge_chunks(chunks: List[Dict]) -> Dict:
    """Reassemble ``chunk_payload`` slices; concatenation of token slices
    is exact."""
    if not chunks:
        raise ValueError("merge_chunks needs at least one chunk")
    return {k: torch.cat([c[k] for c in chunks], dim=1) for k in chunks[0]}


# ------------------------------------------------- temporal-delta transport
def delta_encode(x: torch.Tensor, base_codec: str,
                 ref: Optional[torch.Tensor] = None, *,
                 threshold: float = 0.02, resync_every: int = 8,
                 steps_since_key: int = 0
                 ) -> Tuple[Dict, torch.Tensor, bool]:
    """Encode ``x`` against the reference ``ref`` from the previous step.

    Returns ``(payload, new_ref, is_keyframe)``.  Key frames (``ref`` is
    ``None``, ``resync_every <= 1``, the resync cadence fires, or the
    delta would be at least as large as a full frame) produce a payload
    **byte-identical** to ``encode_activation(x, base_codec)`` and reset
    the reference.  Delta frames ship a packed one-bit change mask over the
    token rows (axis 1) plus the base-codec encoding of just the changed
    rows; a row counts as changed when ``max|x - ref|`` over that row
    exceeds ``threshold * max|x|``, compared in ``x``'s dtype.
    ``new_ref`` is the cloud-side reconstruction (``delta_decode`` of the
    payload): both tiers update their reference from the *shipped* bytes.

    Unsent rows satisfy ``|x - ref| <= threshold * max|x|`` at *this*
    step by construction; ``DeltaCodec.err_bound`` is the planner's
    envelope of that over a key-frame cycle.  Host-side: the abs-max and
    the change mask are read back from the device."""
    is_key = (ref is None or int(resync_every) <= 1
              or int(steps_since_key) + 1 >= int(resync_every))
    if not is_key:
        absmax = float(x.abs().max())
        rowdiff = (x - ref.to(x.dtype)).abs().amax(dim=(0, 2))
        changed = (rowdiff > threshold * absmax).cpu().numpy()
        idx = np.flatnonzero(changed)
        S = x.shape[1]
        body = encode_activation(
            x[:, torch.from_numpy(idx).to(x.device), :], base_codec)
        mask = np.packbits(changed)
        # encoded bytes are linear in the token count (per-row block
        # scales, no cross-token state), so the full-frame size follows
        # from the changed-rows size without encoding twice
        if idx.size and mask.nbytes + payload_bytes(body) \
                >= payload_bytes(body) * (S / idx.size):
            is_key = True       # delta no smaller than a key frame
        else:
            payload = {"mask": mask, **body}
            new_ref = delta_decode(payload, ref, x.dtype)
            return payload, new_ref, False
    payload = encode_activation(x, base_codec)
    return payload, decode_activation(payload, x.dtype), True


def delta_decode(payload: Dict, ref: Optional[torch.Tensor] = None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Reconstruct the full cut activation from a ``delta_encode``
    payload.  Key-frame payloads (no ``"mask"`` key) decode standalone;
    delta payloads scatter the decoded changed rows into a copy of
    ``ref``."""
    if "mask" not in payload:
        return decode_activation(payload, dtype)
    if ref is None:
        raise ValueError("delta payload needs the reference activation "
                         "(reference evicted? force a key frame)")
    S = ref.shape[1]
    changed = np.unpackbits(np.asarray(payload["mask"]),
                            count=S).astype(bool)
    idx = np.flatnonzero(changed)
    out = ref.to(to_dtype(dtype), copy=True)
    if idx.size:
        body = {k: v for k, v in payload.items() if k != "mask"}
        out[:, torch.from_numpy(idx).to(out.device), :] = \
            decode_activation(body, dtype)
    return out


class DeltaTransport:
    """Per-robot temporal-delta transport state.

    One instance simulates both tiers of the delta channel for a fleet:
    the per-robot reference activation (the cloud-side copy the edge
    mirrors bit-exactly, since both update from the shipped bytes), the
    steps-since-keyframe counter that drives the resync cadence, and the
    ``ReferenceLedger`` byte accounting that makes references compete with
    the KV budget.  When a ``put`` overflows the budget the stalest robots'
    references are evicted and their next ``step`` is forced onto a key
    frame."""

    def __init__(self, base_codec: str = "int8", *,
                 threshold: float = 0.02, resync_every: int = 8,
                 budget_bytes: Optional[float] = None):
        from .kvcache import ReferenceLedger
        self.base_codec = base_codec
        self.threshold = threshold
        self.resync_every = int(resync_every)
        self.ledger = ReferenceLedger(budget_bytes)
        self._ref: Dict[int, torch.Tensor] = {}
        self._ssk: Dict[int, int] = {}
        self.n_keyframes = 0
        self.n_delta_frames = 0
        self.n_evictions = 0

    def step(self, robot_id: int, x: torch.Tensor
             ) -> Tuple[Dict, torch.Tensor, bool]:
        """Encode ``x`` for ``robot_id`` and return
        ``(payload, reconstruction, is_keyframe)`` — the reconstruction
        is what the cloud decodes (and the next step's reference)."""
        payload, new_ref, is_key = delta_encode(
            x, self.base_codec, self._ref.get(robot_id),
            threshold=self.threshold, resync_every=self.resync_every,
            steps_since_key=self._ssk.get(robot_id, 0))
        self._ref[robot_id] = new_ref
        self._ssk[robot_id] = 0 if is_key else self._ssk[robot_id] + 1
        if is_key:
            self.n_keyframes += 1
        else:
            self.n_delta_frames += 1
        for k in self.ledger.put(robot_id,
                                 new_ref.numel() * new_ref.element_size()):
            self.evict(k)
            self.n_evictions += 1
        return payload, new_ref, is_key

    def evict(self, robot_id: int) -> None:
        """Drop ``robot_id``'s reference; its next frame is a forced
        key frame."""
        self._ref.pop(robot_id, None)
        self._ssk.pop(robot_id, None)
        self.ledger.drop(robot_id)


def _check_device(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} lie on {t.device}; this executor "
                             f"runs on {device}")


# ================================================================ LM executor
class LMSplitExecutor:
    """Dense or MoE decoder-only LM split at a block boundary.

    Layer indexing: 0..L-1 are transformer blocks (an MoE model's dense
    blocks first, then its MoE blocks); embed always on edge.
    Single-pool plans keep final-norm + unembed cloud-side; a two-pool plan
    returns the tail — pool-2 layers with ``i >= split2``, the blocks after
    ``pool2_end`` and the LM head — to the edge, shipping a second
    (downlink) payload.

    ``device`` is where both tiers run: the card by default, and the
    constructor raises when there is none; ``device="cpu"`` is for callers
    that ask for the plain versions (the tests)."""

    def __init__(self, cfg, plan: SplitPlan, device="cuda"):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"LMSplitExecutor serves the dense and moe "
                             f"families, got {cfg.family!r}")
        if not 0 <= plan.pool_start <= plan.pool_end <= cfg.n_layers:
            raise ValueError(f"pool [{plan.pool_start}, {plan.pool_end}) "
                             f"must lie in [0, {cfg.n_layers}]")
        if plan.two_pool and not plan.pool2_end <= cfg.n_layers:
            raise ValueError(f"second pool [{plan.pool2_start}, "
                             f"{plan.pool2_end}) must end by {cfg.n_layers}")
        nd = cfg.first_dense_layers if cfg.family == "moe" else 0
        for lo, hi in ((plan.pool_start, plan.pool_end),
                       (plan.pool2_start, plan.pool2_end)):
            if lo < nd < hi:
                raise ValueError(f"pool [{lo}, {hi}) straddles the dense/MoE "
                                 f"group boundary at block {nd}")
        self.cfg = cfg
        self.plan = plan
        self.device = require_device(device)

    # -- groups bookkeeping (dense vs moe layer groups)
    def _block_at(self, params, i: int) -> Tuple[Tree, bool]:
        """Block ``i``'s params (views) and whether it is an MoE block."""
        cfg = self.cfg
        if cfg.family == "moe" and i >= cfg.first_dense_layers:
            return _layer_slice(params["moe_blocks"],
                                i - cfg.first_dense_layers), True
        name = "dense_blocks" if cfg.family == "moe" else "blocks"
        return _layer_slice(params[name], i), False

    def _group_params(self, params, start: int, end: int
                      ) -> Tuple[Tree, bool]:
        """Stacked params of blocks [start, end) (one pool's weights,
        views), which lie in one group."""
        cfg = self.cfg
        if cfg.family != "moe":
            return tree_map(lambda w: w[start:end], params["blocks"]), False
        nd = cfg.first_dense_layers
        if start >= nd:
            return tree_map(lambda w: w[start - nd:end - nd],
                            params["moe_blocks"]), True
        return tree_map(lambda w: w[start:end], params["dense_blocks"]), False

    def _run_blocks(self, params, x, positions, start: int, end: int):
        for i in range(start, end):
            pl, is_moe = self._block_at(params, i)
            x, _, _ = block_forward(self.cfg, pl, x, positions, is_moe=is_moe)
        return x

    def _pool(self, params, x, positions, split: int, start: int, end: int,
              side: str):
        if end > start:
            pool, is_moe = self._group_params(params, start, end)
            x = _masked_stack(self.cfg, pool, x, positions, split, start,
                              side, is_moe=is_moe)
        return x

    # -- edge side: embed + [0, pool_start) + masked pool
    def _edge_hidden(self, params, tokens, split: int):
        cfg, plan = self.cfg, self.plan
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
        x = self._run_blocks(params, x, positions, 0, plan.pool_start)
        return self._pool(params, x, positions, split, plan.pool_start,
                          plan.pool_end, "edge")

    def _edge_fwd(self, params, tokens, split: int) -> Dict:
        return encode_activation(self._edge_hidden(params, tokens, split),
                                 self.plan.wire_codec)

    # -- cloud side (single-pool): masked pool + [pool_end, L)
    def _cloud_hidden(self, params, x, split: int):
        cfg, plan = self.cfg, self.plan
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._pool(params, x, positions, split, plan.pool_start,
                       plan.pool_end, "cloud")
        return self._run_blocks(params, x, positions, plan.pool_end,
                                cfg.n_layers)

    def _cloud_fwd(self, params, payload: Dict, split: int):
        x = decode_activation(payload, self.cfg.dtype)
        return T.lm_logits(self.cfg, params,
                           self._cloud_hidden(params, x, split))

    # -- cloud side (two-pool): masked pool + mid blocks + masked pool 2
    def _cloud_mid_fwd(self, params, payload: Dict, split: int, split2: int
                       ) -> Dict:
        plan = self.plan
        x = decode_activation(payload, self.cfg.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._pool(params, x, positions, split, plan.pool_start,
                       plan.pool_end, "cloud")
        x = self._run_blocks(params, x, positions, plan.pool_end,
                             plan.pool2_start)
        # cloud owns the BELOW-split2 half of pool 2 ("edge" predicate)
        x = self._pool(params, x, positions, split2, plan.pool2_start,
                       plan.pool2_end, "edge")
        return encode_activation(x, plan.codec2)

    # -- edge tail (two-pool): masked pool 2 + [pool2_end, L) + head
    def _tail_fwd(self, params, payload: Dict, split2: int):
        cfg, plan = self.cfg, self.plan
        x = decode_activation(payload, cfg.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._pool(params, x, positions, split2, plan.pool2_start,
                       plan.pool2_end, "cloud")
        x = self._run_blocks(params, x, positions, plan.pool2_end,
                             cfg.n_layers)
        return T.lm_logits(cfg, params, x)

    # -- public API
    def _finish(self, params, payload, wire, split: int, split2):
        """Everything after the uplink: ``payload`` is what the cloud
        decodes, ``wire`` what is reported as shipped."""
        if not self.plan.two_pool:
            return self._cloud_fwd(params, payload, split), wire
        split2 = self.plan.clamp2(
            split2 if split2 is not None else self.plan.pool2_end)
        down = self._cloud_mid_fwd(params, payload, split, split2)
        logits = self._tail_fwd(params, down, split2)
        return logits, {"up": wire, "down": down}

    @torch.no_grad()
    def run(self, params, tokens, split: int, split2: Optional[int] = None,
            recorder=None):
        """One co-inference.  Single-pool plans return
        ``(logits, uplink_payload)``; two-pool plans take the second cut
        ``split2`` and return ``(logits, {"up": ..., "down": ...})`` — the
        logits computed on the edge tail.  With a ``FlightRecorder``
        passed as ``recorder``, records an ``edge_fwd`` and a ``cloud_fwd``
        span (the latter with the edge tail of a two-pool plan), with no
        stage nested in them and ``req`` -1, as the reference records
        them; no synchronisation."""
        _check_device(self.device, tokens=tokens)
        split = self.plan.clamp(split)
        if recorder is not None:
            recorder.open_run(self.device, numbered=False)
        with stage("edge_fwd", recorder, "executor:edge"):
            payload = self._edge_fwd(params, tokens, split)
        with stage("cloud_fwd", recorder, "executor:cloud"):
            return self._finish(params, payload, payload, split, split2)

    @torch.no_grad()
    def run_streamed(self, params, tokens, split: int, n_chunks: int,
                     split2: Optional[int] = None):
        """One co-inference with the uplink payload shipped in
        ``n_chunks`` token-axis chunk slices.  Returns ``(logits, chunks)``
        (two-pool: ``(logits, {"up": chunks, "down": payload})`` — the
        small downlink tail never streams).  Bit-identical to ``run``."""
        _check_device(self.device, tokens=tokens)
        split = self.plan.clamp(split)
        payload = self._edge_fwd(params, tokens, split)
        chunks = chunk_payload(payload, n_chunks)
        return self._finish(params, merge_chunks(chunks), chunks, split,
                            split2)


# ================================================================ VLA executor
class VLASplitExecutor:
    """ViT + LLM (+ action head) split; pool(s) inside the LLM block range.

    Layer indexing: ViT blocks [0, Lv) — always edge-side; LLM blocks
    [Lv, Lv+L); action head after.  The dynamic pools must lie inside the
    LLM range.

    A two-pool plan realizes the edge→cloud→edge placement: the cloud runs
    the trunk up to the (dynamic) second cut and ships the tail activation
    back; the final norm + action decode run on the **edge**.

    ``device`` is where both tiers run: the card by default, and the
    constructor raises when there is none; ``device="cpu"`` is for callers
    that ask for the plain versions (the tests)."""

    def __init__(self, cfg, plan: SplitPlan, action_on_cloud: bool = True,
                 device="cuda"):
        if cfg.family != "vla":
            raise ValueError(f"VLASplitExecutor serves the vla family, "
                             f"got {cfg.family!r}")
        if cfg.vla_action_head not in V.HEADS:
            raise ValueError(f"unknown action head {cfg.vla_action_head!r}")
        self.cfg = cfg
        self.plan = plan
        self.device = require_device(device)
        Lv, end = cfg.vit_layers, cfg.vit_layers + cfg.n_layers
        if not Lv <= plan.pool_start <= plan.pool_end <= end:
            raise ValueError(f"pool [{plan.pool_start}, {plan.pool_end}) "
                             f"must lie in the LLM range [{Lv}, {end}]")
        if plan.two_pool and not plan.pool2_end <= end:
            raise ValueError(f"second pool [{plan.pool2_start}, "
                             f"{plan.pool2_end}) must end by {end}")
        self.action_on_cloud = action_on_cloud and not plan.two_pool
        # the DiT head's DDIM loop, from a CUDA graph on the card; its
        # calls counted in ``dit.calls``
        self.dit = DiTGraphs(cfg) if cfg.vla_action_head == "dit" else None

    def _blocks(self, params, start: int, end: int) -> Tree:
        """Stacked LLM-block params [start, end) in graph indexing (views)."""
        Lv = self.cfg.vit_layers
        return tree_map(lambda w: w[start - Lv:end - Lv], params["blocks"])

    def _run_blocks(self, params, x, positions, start: int, end: int):
        """LLM blocks [start, end) in LLM indexing, outside any pool."""
        for i in range(start, end):
            x, _, _ = block_forward(self.cfg, _layer_slice(params["blocks"], i),
                                    x, positions)
        return x

    def _tail_slice(self) -> int:
        """Static downlink sequence length.  When pool 2 is degenerate at
        the graph end the tail is exactly the action stage, which reads
        only its semantic conditioning slice (detok: the last
        ``action_dim`` positions; every other head: the cognition token).  A pool 2
        with movable blocks needs the full sequence.  0 means "ship
        everything"."""
        cfg, plan = self.cfg, self.plan
        if plan.pool2_start == plan.pool2_end == cfg.vit_layers \
                + cfg.n_layers:
            return cfg.action_dim if cfg.vla_action_head in ("detok", "") \
                else 1
        return 0

    def _action_decode(self, params, x, noise, recorder=None):
        """Final norm + action decode — runs on whichever tier owns the
        last segment.  The DiT head goes to ``self.dit``, which counts the
        call in ``recorder``'s metrics."""
        cfg = self.cfg
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if cfg.vla_action_head in ("detok", ""):
            return V.detokenize(unembed(params["head"],
                                        h[:, -cfg.action_dim:]))
        if self.dit is not None:
            return self.dit(params["action"], h[:, -1], noise, recorder)
        return V.decode_action(cfg, params["action"], h[:, -1], noise)

    # -- edge: ViT + embed + [0, pool_start) + the pool below the cut
    def _edge_hidden(self, params, patches, tokens, split: int,
                     recorder=None):
        cfg, plan = self.cfg, self.plan
        Lv = cfg.vit_layers
        with stage("vit", recorder):
            img = V.vit_encode(cfg, params["vit"], patches)
        with stage("edge_blocks", recorder):
            txt = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
            x = torch.cat([img, txt], dim=1)
            positions = torch.arange(x.shape[1], device=x.device)
            x = self._run_blocks(params, x, positions, 0,
                                 plan.pool_start - Lv)
            if plan.pool_end > plan.pool_start:
                pool = self._blocks(params, plan.pool_start, plan.pool_end)
                x = _masked_stack(cfg, pool, x, positions, split,
                                  plan.pool_start, "edge")
        return x

    def _edge_fwd(self, params, patches, tokens, split: int,
                  recorder=None) -> Dict:
        x = self._edge_hidden(params, patches, tokens, split, recorder)
        with stage("encode", recorder):
            return encode_activation(x, self.plan.wire_codec)

    # -- cloud (single-pool): the pool above the cut + [pool_end, L)
    def _cloud_hidden(self, params, x, split: int):
        cfg, plan = self.cfg, self.plan
        Lv = cfg.vit_layers
        positions = torch.arange(x.shape[1], device=x.device)
        if plan.pool_end > plan.pool_start:
            pool = self._blocks(params, plan.pool_start, plan.pool_end)
            x = _masked_stack(cfg, pool, x, positions, split,
                              plan.pool_start, "cloud")
        return self._run_blocks(params, x, positions, plan.pool_end - Lv,
                                cfg.n_layers)

    def _cloud_fwd(self, params, payload: Dict, split: int, noise,
                   recorder=None):
        with stage("decode", recorder):
            x = decode_activation(payload, self.cfg.dtype)
        with stage("cloud_blocks", recorder):
            x = self._cloud_hidden(params, x, split)
        with stage("action_head", recorder):
            return self._action_decode(params, x, noise, recorder)

    # -- two-pool cloud trunk: pool above cut 1 + mid blocks + pool 2 below
    #    cut 2
    def _cloud_mid_fwd(self, params, payload: Dict, split: int, split2: int,
                       recorder=None) -> Dict:
        cfg, plan = self.cfg, self.plan
        Lv = cfg.vit_layers
        with stage("decode", recorder):
            x = decode_activation(payload, cfg.dtype)
        with stage("cloud_blocks", recorder):
            positions = torch.arange(x.shape[1], device=x.device)
            if plan.pool_end > plan.pool_start:
                pool = self._blocks(params, plan.pool_start, plan.pool_end)
                x = _masked_stack(cfg, pool, x, positions, split,
                                  plan.pool_start, "cloud")
            x = self._run_blocks(params, x, positions, plan.pool_end - Lv,
                                 plan.pool2_start - Lv)
            if plan.pool2_end > plan.pool2_start:
                # cloud owns the BELOW-split2 half of pool 2 ("edge"
                # predicate)
                pool2 = self._blocks(params, plan.pool2_start, plan.pool2_end)
                x = _masked_stack(cfg, pool2, x, positions, split2,
                                  plan.pool2_start, "edge")
            k = self._tail_slice()
            if k:
                x = x[:, -k:]   # semantic downlink: only what the tail reads
        with stage("encode", recorder):
            return encode_activation(x, plan.codec2)

    # -- two-pool edge tail: pool 2 above cut 2 + remaining blocks + action
    def _tail_fwd(self, params, payload: Dict, split2: int, noise,
                  recorder=None):
        cfg, plan = self.cfg, self.plan
        Lv = cfg.vit_layers
        with stage("decode", recorder):
            x = decode_activation(payload, cfg.dtype)
        with stage("edge_blocks", recorder):
            positions = torch.arange(x.shape[1], device=x.device)
            if plan.pool2_end > plan.pool2_start:
                pool2 = self._blocks(params, plan.pool2_start, plan.pool2_end)
                x = _masked_stack(cfg, pool2, x, positions, split2,
                                  plan.pool2_start, "cloud")
            x = self._run_blocks(params, x, positions, plan.pool2_end - Lv,
                                 cfg.n_layers)
        with stage("action_head", recorder):
            return self._action_decode(params, x, noise, recorder)

    # -- public API
    def _prepare(self, patches, tokens, noise, generator):
        _check_device(self.device, patches=patches, tokens=tokens)
        if self.cfg.vla_action_head in V.NOISY_HEADS and noise is None:
            noise = V.draw_noise(self.cfg, patches.shape[0], patches.device,
                                 generator)
        return noise

    def _finish(self, params, payload, wire, split: int, split2, noise,
                recorder=None):
        """Everything after the uplink: ``payload`` is what the cloud
        decodes, ``wire`` what is reported as shipped."""
        if not self.plan.two_pool:
            return self._cloud_fwd(params, payload, split, noise,
                                   recorder), wire
        split2 = self.plan.clamp2(
            split2 if split2 is not None else self.plan.pool2_end)
        down = self._cloud_mid_fwd(params, payload, split, split2, recorder)
        action = self._tail_fwd(params, down, split2, noise, recorder)
        return action, {"up": wire, "down": down}

    @torch.no_grad()
    def run(self, params, patches, tokens, split: int,
            noise: Optional[torch.Tensor] = None,
            split2: Optional[int] = None, recorder=None,
            generator: Optional[torch.Generator] = None):
        """One co-inference.  Single-pool plans return
        ``(action, uplink_payload)``; two-pool plans take the second cut
        ``split2`` and return ``(action, {"up": ..., "down": ...})`` with
        the action decoded on the edge tail.  ``noise`` is the initial
        draw of a ``diffusion`` or ``dit`` head (made from ``generator``
        when left out).

        With a ``FlightRecorder`` passed as ``recorder``, records one
        group a tier, each the tier's span and the stages nested in it, all
        with the run's number as ``req``, timed with no synchronisation
        (module docstring):

        - ``edge_fwd`` on ``executor:edge``: ``vit``, ``edge_blocks`` (the
          embedding, the blocks below the pool and the pool below the cut)
          and ``encode``;
        - ``cloud_fwd`` on ``executor:cloud``, starting where ``edge_fwd``
          ends: ``decode``, ``cloud_blocks`` and ``action_head`` (the final
          norm and the action decode, a DiT's whole sampling loop); under a
          two-pool plan ``decode``, ``cloud_blocks``, ``encode``, then the
          edge tail's ``decode``, ``edge_blocks`` and ``action_head``."""
        noise = self._prepare(patches, tokens, noise, generator)
        split = self.plan.clamp(split)
        if recorder is not None:
            recorder.open_run(self.device)
        with stage("edge_fwd", recorder, "executor:edge"):
            payload = self._edge_fwd(params, patches, tokens, split, recorder)
        with stage("cloud_fwd", recorder, "executor:cloud"):
            return self._finish(params, payload, payload, split, split2,
                                noise, recorder)

    @torch.no_grad()
    def run_streamed(self, params, patches, tokens, split: int,
                     n_chunks: int, noise: Optional[torch.Tensor] = None,
                     split2: Optional[int] = None,
                     generator: Optional[torch.Generator] = None):
        """One co-inference with the uplink payload shipped in
        ``n_chunks`` token-axis chunk slices; the small downlink tail never
        streams.  Actions are bit-identical to ``run``."""
        noise = self._prepare(patches, tokens, noise, generator)
        split = self.plan.clamp(split)
        payload = self._edge_fwd(params, patches, tokens, split)
        chunks = chunk_payload(payload, n_chunks)
        return self._finish(params, merge_chunks(chunks), chunks, split,
                            split2, noise)
