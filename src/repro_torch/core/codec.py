"""Split-boundary transport codecs — compression in the planning loop.

The port's own copy of ``src/repro/core/codec.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

RoboECC's wire cost at the split point decides the split, and the paper's
2.55–2.62 % overhead budget is exactly the codec/adjustment machinery — so
codec cost belongs INSIDE the Alg. 1 search, not bolted on after (RAPID,
arXiv 2603.07949, shows transfer reduction shifts the optimal partition;
ActionFlow, arXiv 2512.20276, shows compression compute must be
co-scheduled with transmission).  Every decision layer in this repo prices
transport through a ``Codec``:

* ``core/segmentation.py`` — ``evaluate_split``/``search`` take a codec;
  ``search_vec``/``sweep_search`` take a codec *axis* and return the joint
  (split × codec) optimum per bandwidth;
* ``core/adjustment.py`` — the ΔNB move is joint over (split, codec);
* ``core/controller.py`` — ``RoboECC`` prices its per-tick latency through
  the shared codec (replacing a hard-coded int8 formula);
* ``runtime/fleet.py`` — robots carry per-robot codec state.

A ``Codec`` models three things about shipping a cut activation:

1. **wire bytes** — ``wire_bytes(raw_bytes)``, exact per-element format
   cost including block-scale / index overheads (layouts match
   ``kernels/activation_codec``: per-(row, 128)-block scales);
2. **codec compute** — encode/decode FLOPs + HBM traffic per element,
   priced into seconds on a concrete ``DeviceSpec`` with the same
   max(compute, memory) roofline as Eq. 2 (``encode_s`` on the edge device,
   ``decode_s`` on the cloud device);
3. **accuracy proxy** — ``err_bound``, the relative per-element
   reconstruction error bound (0 for lossless), so planners can gate codec
   choice with ``max_err``.

Cost model notes: both cost terms are *linear* in the element count, which
is what lets the vectorized planner fold codecs into one numpy pass
(``encode_s(raw) == raw * encode_s_per_byte``).  Identity is exactly free
(factor 1.0, zero compute) so enabling the codec axis with only
``identity`` reproduces codec-free plans bit-for-bit.

**Temporal deltas** (``DeltaCodec`` / ``make_delta_codec``): a VLA control
loop sees near-identical consecutive camera frames, so the cloud caches
the previous step's cut activation and the edge ships only the
changed-token rows plus a 1-bit-per-row change mask, resyncing with a full
key frame every ``resync_every`` steps (RAPID's redundancy-awareness as a
planner axis; ROADMAP item 2).  The planner-facing fields are the
CYCLE-AVERAGED expected costs over one key-frame period parameterized by
the expected change fraction — still linear per raw byte, so every
existing search/sweep/adjust path consumes a ``DeltaCodec`` unchanged.
``err_bound`` grows with the worst-case steps-since-keyframe
(``base + (R-1)*threshold``), so the ``max_err`` gate forces honest
resync cadences.  Degenerate parameters (``resync_every=1``, or a change
fraction at which deltas stop paying) collapse every field to the base
codec's exactly — bit-for-bit the non-delta path.  The matching stateful
data plane (reference cache, mask packing, eviction→resync) lives in
``runtime/partition.py``; the measured-vs-planned change fraction drives
``RoboECC.observe_change_frac`` and the fleet's drift replans
(``runtime/fleet.py``), with scene-dynamics traces from ``core/scene.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

from .hardware import DeviceSpec

BLOCK = 128                      # scale-block size (matches the kernels)


@dataclasses.dataclass(frozen=True)
class Codec:
    """One wire format for the cut activation.

    ``raw_bytes_per_elem`` is the uncompressed on-wire element size the
    factors are quoted against (2 = bf16, the repo-wide ``Workload``
    default).  ``bytes_per_elem`` includes all sideband overhead (scales,
    indices).  FLOPs / move-bytes are per *element*, one-sided (encode and
    decode each have their own pair).
    """
    name: str
    bytes_per_elem: float
    raw_bytes_per_elem: float = 2.0
    enc_flops_per_elem: float = 0.0
    enc_move_bytes_per_elem: float = 0.0
    dec_flops_per_elem: float = 0.0
    dec_move_bytes_per_elem: float = 0.0
    err_bound: float = 0.0

    # ------------------------------------------------------------- wire
    @property
    def wire_factor(self) -> float:
        """wire_bytes / raw_bytes (1.0 for identity)."""
        return self.bytes_per_elem / self.raw_bytes_per_elem

    def wire_bytes(self, raw_bytes: float) -> float:
        """Bytes on the network for ``raw_bytes`` of raw activation."""
        return raw_bytes * self.wire_factor

    # ---------------------------------------------------------- compute
    def _side_s_per_byte(self, flops: float, move: float, dev: DeviceSpec
                         ) -> float:
        """max(compute, memory) seconds per raw byte on ``dev`` (Eq. 2
        roofline form; linear in bytes by construction)."""
        elems_per_byte = 1.0 / self.raw_bytes_per_elem
        t_comp = flops * elems_per_byte / (dev.peak_flops * dev.eta_compute)
        t_mem = move * elems_per_byte / (dev.hbm_bw * dev.eta_mem)
        return max(t_comp, t_mem)

    def encode_s_per_byte(self, dev: DeviceSpec) -> float:
        return self._side_s_per_byte(self.enc_flops_per_elem,
                                     self.enc_move_bytes_per_elem, dev)

    def decode_s_per_byte(self, dev: DeviceSpec) -> float:
        return self._side_s_per_byte(self.dec_flops_per_elem,
                                     self.dec_move_bytes_per_elem, dev)

    def encode_s(self, raw_bytes: float, dev: DeviceSpec) -> float:
        """Seconds to encode ``raw_bytes`` of activation on ``dev``."""
        return raw_bytes * self.encode_s_per_byte(dev)

    def decode_s(self, raw_bytes: float, dev: DeviceSpec) -> float:
        """Seconds to decode on ``dev`` (the receiving tier)."""
        return raw_bytes * self.decode_s_per_byte(dev)


def transport_s(raw_bytes: float, bandwidth_bps: float, codec: "Codec",
                edge: Optional[DeviceSpec] = None,
                cloud: Optional[DeviceSpec] = None,
                rtt_s: float = 0.0) -> float:
    """End-to-end split-boundary transport: encode (edge) + wire + rtt +
    decode (cloud).  Devices are optional — without them codec compute is
    unpriced (wire-only), which is what the ΔNB adjuster uses when called
    without hardware context."""
    t = codec.wire_bytes(raw_bytes) / bandwidth_bps + rtt_s
    if edge is not None:
        t += codec.encode_s(raw_bytes, edge)
    if cloud is not None:
        t += codec.decode_s(raw_bytes, cloud)
    return t


@dataclasses.dataclass(frozen=True)
class DeltaCodec(Codec):
    """Cross-step temporal-delta transport priced as a plain ``Codec``.

    The inherited cost fields are the CYCLE-AVERAGED expected costs of one
    key-frame period (see ``make_delta_codec`` — they stay linear per raw
    byte, so planners need no special casing); the extra fields record the
    parameters the data plane (``runtime/partition.py``) and the fleet's
    measured pricing (``runtime/fleet.py``) execute with:

    * ``base``        — name of the per-frame payload codec (key frames
      ship the full base-encoded activation; delta frames the changed
      rows, base-encoded);
    * ``change_frac`` — expected fraction of token rows changed per step
      (the scene-dependent parameter plans carry; measured drift beyond
      tolerance triggers ``RoboECC.observe_change_frac`` replans);
    * ``resync_every``— key-frame cadence R (a key frame every R steps
      bounds worst-case staleness);
    * ``threshold``   — per-row relative change threshold τ: rows moving
      less than τ x the activation scale are not shipped, so each
      unshipped step adds at most τ relative error — hence
      ``err_bound = base_err + (R-1) * τ``;
    * ``row_elems``   — elements per token row (hidden dim) the 1-bit
      row mask is amortized over.
    """
    base: str = "int8"
    change_frac: float = 0.15
    resync_every: int = 8
    threshold: float = 0.02
    row_elems: int = 4096


def make_delta_codec(base: Union[str, Codec] = "int8",
                     change_frac: float = 0.15,
                     resync_every: int = 8,
                     threshold: float = 0.02,
                     row_elems: int = 4096,
                     raw_bytes_per_elem: float = 2.0,
                     name: str = "delta") -> DeltaCodec:
    """Build a temporal-delta codec whose planner-facing fields are the
    expected per-element costs averaged over one key-frame period.

    With base per-element wire cost ``b``, change fraction ``p``, mask
    cost ``m = 1/(8*row_elems)`` and cadence ``R = resync_every``:

    * a key frame costs exactly the base codec (full re-encode, the cloud
      reference is rewritten — bit-exact reconstruction of the non-delta
      path, checked by the data-plane tests);
    * a delta frame costs ``p*b + m`` wire plus a compare pass on every
      row (the edge must diff against its reference mirror) and the base
      encode/decode of only the changed rows;
    * the cycle average weighs 1 key frame and ``R-1`` delta frames.

    Degenerate settings — ``resync_every <= 1``, or ``p*b + m >= b`` (true
    at ``change_frac = 1.0``: deltas cannot pay, every frame is a key
    frame) — return a ``DeltaCodec`` whose every cost field EQUALS the
    base codec's, so plans and prices reproduce the non-delta codec
    bit-for-bit (the encoder then ships only key frames and skips the
    compare pass).

    ``err_bound = base_err + (R-1)*threshold``: between key frames an
    unshipped row may drift by up to τ per step relative to the reference,
    so the planner's ``max_err`` gate forces small R honestly."""
    if isinstance(base, Codec):
        b = base
    else:
        b = make_codecs(raw_bytes_per_elem)[base]
    r = b.raw_bytes_per_elem
    p = min(max(float(change_frac), 0.0), 1.0)
    R = int(resync_every)
    mask_bpe = 1.0 / (8.0 * row_elems)
    delta_bpe = p * b.bytes_per_elem + mask_bpe
    common = dict(name=name, raw_bytes_per_elem=r, base=b.name,
                  change_frac=p, resync_every=R, threshold=float(threshold),
                  row_elems=int(row_elems))
    if R <= 1 or delta_bpe >= b.bytes_per_elem:
        # degenerate: every frame is a key frame — all fields equal the
        # base codec exactly (bit-for-bit the non-delta path)
        return DeltaCodec(bytes_per_elem=b.bytes_per_elem,
                          enc_flops_per_elem=b.enc_flops_per_elem,
                          enc_move_bytes_per_elem=b.enc_move_bytes_per_elem,
                          dec_flops_per_elem=b.dec_flops_per_elem,
                          dec_move_bytes_per_elem=b.dec_move_bytes_per_elem,
                          err_bound=b.err_bound, **common)
    share = (R - 1.0) / R       # delta-frame weight in the cycle average
    key = 1.0 / R
    return DeltaCodec(
        bytes_per_elem=key * b.bytes_per_elem + share * delta_bpe,
        # delta frames pay a 2-FLOP/elem compare pass (diff + row-max
        # reduce) over the full activation plus the base encode of the
        # changed fraction; key frames the plain base encode
        enc_flops_per_elem=key * b.enc_flops_per_elem
        + share * (2.0 + p * b.enc_flops_per_elem),
        # compare reads current + reference mirror (2r); changed rows
        # then move through the base encoder
        enc_move_bytes_per_elem=key * b.enc_move_bytes_per_elem
        + share * (2.0 * r + p * b.enc_move_bytes_per_elem),
        # cloud: key frames base-decode + rewrite the reference (+r);
        # delta frames read the reference and scatter the decoded rows
        dec_flops_per_elem=key * b.dec_flops_per_elem
        + share * (1.0 + p * b.dec_flops_per_elem),
        dec_move_bytes_per_elem=key * (b.dec_move_bytes_per_elem + r)
        + share * (r + p * b.dec_move_bytes_per_elem),
        err_bound=b.err_bound + (R - 1) * float(threshold),
        **common)


# ------------------------------------------------------------------ zoo
def make_codecs(raw_bytes_per_elem: float = 2.0, block: int = BLOCK,
                topk_frac: float = 0.25) -> Dict[str, Codec]:
    """Build the codec registry for a given raw element size.

    Formats (per-element wire cost, ``block``-element scale groups):

    * ``identity`` — raw bytes through, zero compute, lossless.
    * ``fp16``     — 2-byte float cast (a no-op when raw is already bf16,
      a 2x cut from f32); 1 cast FLOP/elem, ~2^-11 relative error.
    * ``int8``     — block-scaled int8 (`kernels/activation_codec`):
      1 B/elem + 4 B scale per block; fused absmax+scale+round ≈ 4
      FLOPs/elem encode, 2 FLOPs/elem decode; err ≤ 1/127.
    * ``int4``     — block-scaled packed int4 (Pallas pack/unpack kernel):
      0.5 B/elem + 4 B scale per block; ≈ 6 FLOPs/elem encode (absmax,
      scale, round, bias, nibble mul-add), 4 decode; err ≤ 1/7.
    * ``topk``     — per-block top-``topk_frac`` magnitude sparsification:
      kept elements ship fp16 value + 1-byte in-block index
      (3 B × frac per elem); selection ≈ 16 FLOPs/elem encode, scatter
      ≈ 2 decode; ``err_bound`` is the dropped-coefficient L2 proxy.
    * ``delta``    — cross-step temporal deltas over an int8 base
      (``make_delta_codec`` defaults: expected change fraction 0.15,
      key frame every 8 steps, row threshold 0.02): cycle-averaged wire
      ≈ 0.27 B/elem, err grows with steps-since-keyframe.  Scene-specific
      variants come from ``make_delta_codec`` directly.
    """
    r = raw_bytes_per_elem
    scale_b = 4.0 / block
    out = {
        "identity": Codec("identity", bytes_per_elem=r,
                          raw_bytes_per_elem=r),
        "fp16": Codec("fp16", bytes_per_elem=2.0, raw_bytes_per_elem=r,
                      enc_flops_per_elem=1.0,
                      enc_move_bytes_per_elem=r + 2.0,
                      dec_flops_per_elem=1.0,
                      dec_move_bytes_per_elem=2.0 + r,
                      err_bound=2.0 ** -11),
        "int8": Codec("int8", bytes_per_elem=1.0 + scale_b,
                      raw_bytes_per_elem=r,
                      enc_flops_per_elem=4.0,
                      enc_move_bytes_per_elem=r + 1.0 + scale_b,
                      dec_flops_per_elem=2.0,
                      dec_move_bytes_per_elem=1.0 + scale_b + r,
                      err_bound=1.0 / 127.0),
        "int4": Codec("int4", bytes_per_elem=0.5 + scale_b,
                      raw_bytes_per_elem=r,
                      enc_flops_per_elem=6.0,
                      enc_move_bytes_per_elem=r + 0.5 + scale_b,
                      dec_flops_per_elem=4.0,
                      dec_move_bytes_per_elem=0.5 + scale_b + r,
                      err_bound=1.0 / 7.0),
        "topk": Codec("topk", bytes_per_elem=3.0 * topk_frac,
                      raw_bytes_per_elem=r,
                      enc_flops_per_elem=16.0,
                      enc_move_bytes_per_elem=r + 3.0 * topk_frac,
                      dec_flops_per_elem=2.0,
                      dec_move_bytes_per_elem=3.0 * topk_frac + r,
                      err_bound=0.45),
    }
    # registered AFTER the bases so the default delta can reference the
    # int8 instance of THIS registry (same raw element size)
    out["delta"] = make_delta_codec(base=out["int8"],
                                    raw_bytes_per_elem=r)
    return out


CODECS: Dict[str, Codec] = make_codecs()
IDENTITY = CODECS["identity"]

CodecLike = Union[str, Codec, None]


def get_codec(codec: CodecLike) -> Optional[Codec]:
    """Resolve a codec name / instance / None (``None`` passes through:
    callers treat it as "no codec", i.e. raw-byte transport)."""
    if codec is None or isinstance(codec, Codec):
        return codec
    try:
        return CODECS[codec]
    except KeyError:
        raise KeyError(
            f"unknown codec {codec!r}; have {sorted(CODECS)}") from None


def resolve_codecs(codecs: Optional[Sequence[CodecLike]],
                   max_err: Optional[float] = None
                   ) -> Optional[Tuple[Codec, ...]]:
    """Resolve a codec list for a planner's codec axis, optionally dropping
    codecs whose ``err_bound`` exceeds ``max_err``.  Order is preserved —
    planners break latency ties toward the *earlier* codec, so put the
    preferred (usually lossless) codec first."""
    if codecs is None:
        return None
    out = [get_codec(c) for c in codecs]
    if any(c is None for c in out):
        raise ValueError("None is not a valid member of a codec axis; "
                         "use 'identity'")
    if max_err is not None:
        out = [c for c in out if c.err_bound <= max_err]
    if not out:
        raise ValueError(f"no codec satisfies max_err={max_err}")
    return tuple(out)
