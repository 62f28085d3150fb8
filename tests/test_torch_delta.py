"""The temporal-delta transport of the port against the JAX package's:
``delta_encode`` / ``delta_decode`` / ``DeltaTransport`` on the same frame
streams (the ``_delta_frames`` of ``tests/test_codec.py``), with key and
delta payloads byte-equal between the packages, the contract of
``_check_delta_stream`` held on the port, and the wire accounting of a
delta payload's numpy change mask."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CODECS as J_CODECS
from repro.runtime import partition as j_part
from repro_torch.core import CODECS
from repro_torch.runtime.partition import (DeltaTransport, decode_activation,
                                           delta_decode, delta_encode,
                                           encode_activation, payload_bytes)

from _torch_port_util import t2np, to_np
from test_codec import _delta_frames

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(v):
    """A payload value as numpy: the mask already is; tensors and jax
    arrays keep their dtype (bf16 travels as float32, exactly)."""
    if isinstance(v, np.ndarray):
        return v
    return t2np(v) if isinstance(v, torch.Tensor) else to_np(v)


def _assert_payloads_equal(pt, pj):
    assert pt.keys() == pj.keys()
    for k in pt:
        a, b = _np(pt[k]), _np(pj[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert payload_bytes(pt) == j_part.payload_bytes(pj)


def _check_both(frames, threshold, R, base="int8", dtype="float32"):
    """Drive both packages' ``delta_encode`` over one frame stream: the
    same key/delta decisions, payloads byte-equal, reconstructions equal;
    and the port alone held to the contract of ``_check_delta_stream``
    (key frames byte-identical to the plain codec, exact wire bytes,
    bounded error, the resync cadence)."""
    jdt, tdt = DTYPES[dtype]
    base_err = CODECS[base].err_bound if base else 0.0
    assert base_err == (J_CODECS[base].err_bound if base else 0.0)
    ref_t = ref_j = None
    ssk = 0
    n_delta = 0
    for step, xf in enumerate(frames):
        xt = torch.from_numpy(xf).to(tdt)
        xj = jnp.asarray(xf, jdt)
        pt, new_t, key_t = delta_encode(xt, base, ref_t, threshold=threshold,
                                        resync_every=R, steps_since_key=ssk)
        pj, new_j, key_j = j_part.delta_encode(
            xj, base, ref_j, threshold=threshold, resync_every=R,
            steps_since_key=ssk)
        assert key_t == key_j, step
        _assert_payloads_equal(pt, pj)
        assert np.array_equal(t2np(new_t), to_np(new_j)), step
        assert new_t.dtype == tdt
        S = xt.shape[1]
        if key_t:
            plain = encode_activation(xt, base)
            assert pt.keys() == plain.keys()
            for k in pt:
                assert torch.equal(pt[k], plain[k]), k
            assert torch.equal(new_t, decode_activation(plain, tdt))
            ssk = 0
        else:
            mask = pt["mask"]
            assert isinstance(mask, np.ndarray) and mask.dtype == np.uint8
            idx = np.flatnonzero(np.unpackbits(mask)[:S])
            body = encode_activation(xt[:, torch.from_numpy(idx), :], base)
            assert payload_bytes(pt) == mask.nbytes + payload_bytes(body)
            ssk += 1
            n_delta += 1
        recon = delta_decode(pt, ref_t, tdt)
        assert torch.equal(recon, new_t), step
        want = t2np(xt)
        amax = float(np.abs(want).max())
        tol = (base_err + (0.0 if key_t else threshold)) * amax
        if dtype == "bfloat16":
            # the threshold is compared in bf16, and the reconstruction is
            # rounded to bf16 once more
            tol = tol * (1 + 2.0 ** -8) + np.abs(want) * 2.0 ** -8
        assert np.all(np.abs(t2np(recon) - want) <= tol + 1e-6), step
        assert ssk < max(R, 1)
        ref_t, ref_j = new_t, new_j
    return n_delta


STREAMS = {
    **{f"seed{s}_R{3 + s}": (lambda s=s: (_delta_frames(s, 7, 0.2), 0.05,
                                          3 + s)) for s in range(4)},
    "every_frame_key_R1": lambda: (_delta_frames(9, 4, 0.5), 0.05, 1),
    "static": lambda: ([_delta_frames(1, 1, 0.0)[0]] * 5, 0.05, 8),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_delta_stream_equals_the_reference(stream, dtype):
    frames, threshold, R = STREAMS[stream]()
    n_delta = _check_both(frames, threshold, R, dtype=dtype)
    if stream == "every_frame_key_R1":
        assert n_delta == 0
    elif stream == "static":
        assert n_delta == len(frames) - 1      # only the mask ships


@pytest.mark.parametrize("base", ["int4", ""])
def test_delta_stream_other_base_codecs(base):
    """The packed-int4 body (D = 256) and the raw one."""
    _check_both(_delta_frames(2, 6, 0.3), 0.05, 4, base=base)
    _check_both(_delta_frames(5, 5, 0.3), 0.05, 3, base=base,
                dtype="bfloat16")


def test_threshold_is_compared_in_the_activation_dtype():
    """A row whose change equals bf16(threshold * max|x|) exactly lies
    above the float32 rounding of that product but not above the bf16
    one: in bf16 both packages leave it out, in float32 both ship it."""
    S, D = 4, 256
    x = np.zeros((1, S, D), np.float32)
    ref = np.zeros_like(x)
    x[0, 0, 0] = ref[0, 0, 0] = 1.0                 # max|x| = 1, unchanged
    x[0, 1, 5] = 165 * 2.0 ** -13                   # == bf16(0.0201)
    x[0, 2, 5] = 164 * 2.0 ** -13                   # below both roundings
    x[0, 3, 5] = 166 * 2.0 ** -13                   # above both
    for dtype, want in (("bfloat16", [0, 0, 0, 1]), ("float32", [0, 1, 0, 1])):
        jdt, tdt = DTYPES[dtype]
        pt, _, kt = delta_encode(torch.from_numpy(x).to(tdt), "int8",
                                 torch.from_numpy(ref).to(tdt),
                                 threshold=0.0201)
        pj, _, kj = j_part.delta_encode(jnp.asarray(x, jdt), "int8",
                                        jnp.asarray(ref, jdt),
                                        threshold=0.0201)
        assert not kt and not kj
        assert list(np.unpackbits(pt["mask"])[:S]) == want, dtype
        _assert_payloads_equal(pt, pj)


def test_payload_bytes_counts_the_delta_mask():
    """The mask is a numpy array among tensors; the wire carries it."""
    frames = _delta_frames(4, 2, 0.25)
    x0, x1 = (torch.from_numpy(f) for f in frames)
    _, ref, _ = delta_encode(x0, "int8")
    payload, _, is_key = delta_encode(x1, "int8", ref, threshold=0.05)
    assert not is_key
    mask = payload["mask"]
    body = {k: v for k, v in payload.items() if k != "mask"}
    assert mask.nbytes == 2                        # 16 rows, one bit each
    assert payload_bytes(payload) == mask.nbytes + payload_bytes(body)
    assert payload_bytes({"mask": mask}) == 2
    pj, _, _ = j_part.delta_encode(jnp.asarray(frames[1]), "int8",
                                   jnp.asarray(t2np(ref)), threshold=0.05)
    assert payload_bytes(payload) == j_part.payload_bytes(pj)


def test_delta_payload_without_its_reference_raises():
    x = torch.from_numpy(_delta_frames(0, 1, 0.0)[0])
    payload = {"mask": np.packbits(np.zeros(16, bool))}
    with pytest.raises(ValueError, match="reference"):
        delta_decode(payload, None, torch.float32)
    assert torch.equal(delta_decode(payload, x, torch.float32), x)


def test_delta_transport_eviction_forces_resync():
    """Evicting a robot's reference (budget pressure, or by hand) forces
    its next frame back to a key frame, as in the reference; both
    packages count the same frames and evictions."""
    frames = _delta_frames(3, 6, 0.1)
    ref_bytes = frames[0].size * 4                 # float32 reference
    trs = (DeltaTransport("int8", threshold=0.05, resync_every=100,
                          budget_bytes=1.5 * ref_bytes),
           j_part.DeltaTransport("int8", threshold=0.05, resync_every=100,
                                 budget_bytes=1.5 * ref_bytes))
    keys = []
    for tr, conv in zip(trs, (torch.from_numpy, jnp.asarray)):
        ks = [tr.step(0, conv(frames[0]))[2], tr.step(0, conv(frames[1]))[2]]
        tr.step(1, conv(frames[2]))                # robot 1 evicts robot 0
        ks.append(tr.step(0, conv(frames[3]))[2])
        keys.append((ks, tr.n_keyframes, tr.n_delta_frames, tr.n_evictions,
                     tr.ledger.total_bytes))
    assert keys[0] == keys[1]
    assert keys[0][0] == [True, False, True] and keys[0][3] >= 1
    tr = DeltaTransport("int8", threshold=0.05, resync_every=100)
    tr.step(5, torch.from_numpy(frames[0]))
    assert not tr.step(5, torch.from_numpy(frames[1]))[2]
    tr.evict(5)
    assert tr.ledger.total_bytes == 0
    assert tr.step(5, torch.from_numpy(frames[2]))[2]


def test_delta_transport_resync_cadence_and_ledger():
    """Every R-th frame is a key frame; the ledger holds one reference
    per robot at the reconstruction's size (bf16: 2 bytes an element)."""
    frames = _delta_frames(6, 9, 0.2)
    tr = DeltaTransport("int8", threshold=0.05, resync_every=3)
    jt = j_part.DeltaTransport("int8", threshold=0.05, resync_every=3)
    got, want = [], []
    for f in frames:
        got.append(tr.step(7, torch.from_numpy(f).to(torch.bfloat16))[2])
        want.append(jt.step(7, jnp.asarray(f, jnp.bfloat16))[2])
    assert got == want == [True, False, False] * 3
    assert tr.ledger.total_bytes == jt.ledger.total_bytes == frames[0].size * 2
