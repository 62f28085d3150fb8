"""The int8 codec kernels (B1 quantise, B2 dequantise) of ``repro_torch``
on the CPU: the kernels' arithmetic written out in numpy float32 and held
equal to the plain version, at the 128-column block and at other widths
(the general kernels).  The wrappers' dispatch to the C entries on a
stand-in card is in ``test_torch_hygiene.py``."""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.activation_codec import ref as t_ref

# the kernel's constants (csrc/activation_codec.cu: kTieMargin8, kMagic) and
# the smallest normal float32, below which a block's scale sends every
# element to the division
MARGIN = np.float32(2.0 ** -15)
MAGIC = np.float32(1.5 * 2.0 ** 23)
FLT_MIN = np.finfo(np.float32).tiny
QMAX = 127

# columns of the test arrays for each block width
WIDTH = {128: 1024, 64: 1024, 100: 1000}


# ------------------------------------------------- the kernel's rounding
def _block_scales(xb: np.ndarray):
    """The block scales as the kernel forms them: the abs-max as the
    maximum of the float bits with the sign cleared (a NaN the largest),
    s = a * RN(1/127) where a > 0, else 1; and which blocks divide every
    element (s < FLT_MIN, or a NaN abs-max)."""
    bits = xb.view(np.uint32) & np.uint32(0x7FFFFFFF)
    a = bits.max(axis=-1, keepdims=True).view(np.float32)
    with np.errstate(invalid="ignore"):
        s = np.where(a > 0, a * np.float32(1.0 / QMAX),
                     np.float32(1.0)).astype(np.float32)
    return s, (s < FLT_MIN) | np.isnan(a)


def _kernel_codes(xb: np.ndarray, s: np.ndarray, divide_all: np.ndarray,
                  margin=MARGIN):
    """clamp(rint(x / s), -127, 127) as ``quantize_int8_kernel`` computes
    it, in float32: per block r = RN(1/s); per element y = RN(x * r),
    t = RN(y + M) with M = 1.5 * 2^23, and d = y - (t - M) = y - rint(y);
    the int8 value is the low byte of bits(t), unless |d| >= 1/2 -
    ``margin`` (y within the margin of a half-integer, or NaN) or the block
    divides every element, where the element takes clamp(rint(x / s), -127,
    127) with the IEEE quotient (a NaN quotient giving -127, as fmaxf /
    fminf do).  Returns (int8 values, which elements took the product)."""
    with np.errstate(all="ignore"):
        r = np.float32(1.0) / s
        y = xb * r
        t = y + MAGIC
        d = y - (t - MAGIC)
        fast = ~divide_all & (np.abs(d) < np.float32(0.5) - margin)
        q_fast = (t.view(np.uint32) & np.uint32(0xFF)).astype(np.uint8)
        q_div = np.fmin(np.fmax(np.rint(xb / s), -QMAX), QMAX)
    q_div = np.where(np.isnan(q_div), -QMAX, q_div).astype(np.int8)
    return np.where(fast, q_fast.view(np.int8), q_div), fast


def _emulate_quantize_int8(x: np.ndarray, block: int = 128):
    """The whole quantise kernel on a float32 (R, D) array: block scales
    by ``_block_scales``, values by ``_kernel_codes``."""
    R, D = x.shape
    xb = x.reshape(R, D // block, block)
    s, divide_all = _block_scales(xb)
    q, fast = _kernel_codes(xb, s, divide_all)
    return q.reshape(R, D), s[..., 0], fast


def _as_input(x: np.ndarray, dtype) -> np.ndarray:
    """``x`` rounded to ``dtype`` and back to float32, as the kernel reads
    it."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def _random(rng, shape):
    return (rng.standard_normal(shape) * 3.0).astype(np.float32)


def _ties(rng, shape, block):
    """Every block holds 127.0 once (scale exactly 127 * RN(1/127) = 1.0);
    the rest lies on the half-integers -126.5 ... 126.5, exact in
    bfloat16."""
    x = rng.integers(-QMAX, QMAX, shape).astype(np.float32) + np.float32(0.5)
    x.reshape(-1, block)[:, 0] = 127.0
    return x


def _near_ties(rng, shape, dtype, block):
    """Quotients at and next to half-integers (the construction of
    ``chip_smoke.py``'s ``near_ties`` at the quantum 127).  Even blocks:
    abs-max 127 m 2^e for an odd m, the rest (2k + 1) m 2^(e-1) rounded to
    ``dtype``.  Odd blocks: abs-max a 2^e with a = 1 + j/128, the rest
    a (2k + 1) 2^e / 254 rounded to ``dtype`` (k = 63: exactly half the
    abs-max).  A third of all elements then move one ulp of ``dtype``."""
    R, D = shape
    nb = R * D // block
    m = rng.choice([1, 3, 5, 9, 11, 13, 15, 17, 19], (nb, 1))
    e = np.exp2(rng.integers(-3, 4, (nb, 1))).astype(np.float32)
    a = (1 + rng.integers(0, 128, (nb, 1)) / 128).astype(np.float32)
    k = rng.integers(0, QMAX, (nb, block))
    sign = rng.integers(0, 2, (nb, block)) * 2 - 1
    odd = (np.arange(nb) % 2 == 1)[:, None]
    amax = np.where(odd, a * e, (QMAX * m).astype(np.float32) * e)
    x = np.where(odd, a * e * (2 * k + 1).astype(np.float32) / (2 * QMAX),
                 ((2 * k + 1) * m).astype(np.float32) * e / 2)
    x = x.astype(np.float32)
    x[:, 0] = amax[:, 0]
    t = torch.from_numpy(sign * x).float().to(dtype)
    bits = t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    step = torch.from_numpy(rng.integers(-1, 2, (nb, block)))
    step[:, 0] = 0
    bits += step.to(bits.dtype)
    return t.float().numpy().reshape(R, D)


def _sub_flt_min(rng, shape, block):
    """Blocks whose scale lies below FLT_MIN: every fourth scaled by 1e-39
    (scales near 1e-40, where RN(1/s) overflows, subnormal elements), every
    fourth from the third on by 7e-38 (scales near 5e-39, where it is
    finite); and every fourth from the second on to a tiny normal scale."""
    x = _random(rng, shape)
    blocks = x.reshape(-1, block)
    blocks[0::4] *= np.float32(1e-39)
    blocks[2::4] *= np.float32(7e-38)
    blocks[1::4] *= np.float32(1e-30)
    return x


INPUTS = {
    "random": lambda rng, shape, dt, b: _as_input(_random(rng, shape), dt),
    "ties": lambda rng, shape, dt, b: _as_input(_ties(rng, shape, b), dt),
    "near_ties": lambda rng, shape, dt, b: _near_ties(rng, shape, dt, b),
    "sub_flt_min": lambda rng, shape, dt, b: _as_input(
        _sub_flt_min(rng, shape, b), dt),
}


@pytest.mark.parametrize("block", sorted(WIDTH))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_kernel_rounding_equals_the_division(kind, dtype, block):
    """The reciprocal product with its 2^-15 margin and its FLT_MIN rule
    gives the plain version's ``torch.round(x / s)`` on every element:
    payload and scales bit for bit."""
    x = INPUTS[kind](np.random.default_rng(7), (96, WIDTH[block]), dtype,
                     block)
    assert np.isfinite(x).all()
    q, s, _ = _emulate_quantize_int8(x, block)
    want_q, want_s = t_ref.quantize_int8(torch.from_numpy(x), block)
    assert np.array_equal(s, want_s.numpy())
    assert np.array_equal(q, want_q.numpy())


def test_ties_have_scale_one():
    x = _as_input(_ties(np.random.default_rng(1), (4, 512), 128),
                  torch.bfloat16)
    assert np.array_equal(x, _ties(np.random.default_rng(1), (4, 512), 128))
    _, s, _ = _emulate_quantize_int8(x)
    assert (s == 1.0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_random_inputs_take_the_product(dtype):
    """Away from ties the division is rare: on random activations nearly
    every element rounds its product (float32 inputs all but a few in a
    hundred thousand; bfloat16 ones, whose quotients are ratios of 8-bit
    numbers and land on half-integers more often, all but about one in
    two hundred)."""
    x = INPUTS["random"](np.random.default_rng(8), (96, 4096), dtype, 128)
    *_, fast = _emulate_quantize_int8(x)
    assert fast.mean() > (0.99 if dtype == torch.bfloat16 else 0.9999)
    if dtype == torch.bfloat16:
        assert fast.mean() < 0.999          # ... and that share is not 0


@pytest.mark.parametrize("block", sorted(WIDTH))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_near_ties_need_the_margin(dtype, block):
    """On the near-tie inputs the product alone (no margin) rounds some
    elements the other way than the IEEE quotient, and every such element
    lies inside the margin, so the kernel divides there."""
    R, D = 96, WIDTH[block]
    x = INPUTS["near_ties"](np.random.default_rng(9), (R, D), dtype, block)
    xb = x.reshape(R, D // block, block)
    s, divide_all = _block_scales(xb)
    q_product, _ = _kernel_codes(xb, s, divide_all, margin=np.float32(-1.0))
    q_kernel, fast = _kernel_codes(xb, s, divide_all)
    exact = np.clip(np.rint(xb / s), -QMAX, QMAX).astype(np.int8)
    wrong = q_product != exact
    assert wrong.sum() > 0
    assert not (wrong & fast).any()
    assert np.array_equal(q_kernel, exact)


def test_the_margin_of_the_quantum_7_is_too_narrow_for_127():
    """With int4's margin 2^-18 the int8 rounding goes wrong on the
    float32 near-tie inputs (some products that round the wrong way lie
    2^-17 from a half-integer): the margin has to widen with the
    quantum."""
    x = INPUTS["near_ties"](np.random.default_rng(9), (96, 1024),
                            torch.float32, 128)
    xb = x.reshape(96, 8, 128)
    s, divide_all = _block_scales(xb)
    q, _ = _kernel_codes(xb, s, divide_all, margin=np.float32(2.0 ** -18))
    exact = np.clip(np.rint(xb / s), -QMAX, QMAX).astype(np.int8)
    assert (q != exact).any()


def test_a_scale_below_flt_min_divides_the_whole_block():
    """Both where RN(1/s) overflows and where it is finite."""
    x = INPUTS["sub_flt_min"](np.random.default_rng(10), (8, 512),
                              torch.float32, 128)
    _, s, fast = _emulate_quantize_int8(x)
    small = s < FLT_MIN
    with np.errstate(over="ignore"):
        finite_r = np.isfinite(np.float32(1.0) / s)
    assert (small & finite_r).any() and (small & ~finite_r).any()
    assert (s > 0).all()
    fast = fast.reshape(8, 4, 128)
    assert not fast[small].any() and fast[~small].mean() > 0.99


@pytest.mark.parametrize("block", [128, 100])
def test_non_finite_inputs(block):
    """What the header states: a block holding a NaN gets the scale 1.0
    (as the plain version) and divides every element, so its other
    elements (+-Inf too) are the plain version's and a NaN gives -127; a
    block holding +-Inf and no NaN gets the scale Inf (as the plain
    version), its finite elements 0 and +-Inf -127."""
    rng = np.random.default_rng(13)
    x = _random(rng, (8, WIDTH[block]))
    blocks = x.reshape(-1, block)
    blocks[:, 0] = 300.0                              # |x / 1| past 127.5
    blocks[0::3, 5] = np.nan
    blocks[0::6, 7] = np.inf
    blocks[1::3, 9] = -np.inf
    q, s, _ = _emulate_quantize_int8(x, block)
    want_q, want_s = t_ref.quantize_int8(torch.from_numpy(x), block)
    assert np.array_equal(s, want_s.numpy())
    s = s.reshape(-1)
    assert (s[0::3] == 1.0).all() and np.isinf(s[1::3]).all()
    finite = np.isfinite(x)
    assert np.array_equal(q[finite], want_q.numpy()[finite])
    qb = q.reshape(-1, block)
    assert (qb[0::3, 5] == -127).all()
    assert (qb[0::6, 7] == 127).all()                 # +Inf in a NaN block
    assert (qb[1::3, 9] == -127).all()                # +-Inf in an Inf block
    assert (qb[1::3, 0] == 0).all() and (qb[0::3, 0] == 127).all()


def test_the_constants_are_the_kernels():
    src = (_build.CSRC / "activation_codec.cu").read_text()
    (margin,) = re.findall(r"kTieMargin8 = 0x1p-(\d+)f", src)
    assert np.float32(2.0 ** -int(margin)) == MARGIN
    (magic,) = re.findall(r"kMagic = (\d+)\.0f", src)
    (bits,) = re.findall(r"kMagicBits = (0x[0-9A-F]+)u", src)
    assert np.float32(int(magic)) == MAGIC
    assert np.array(MAGIC).view(np.uint32) == int(bits, 16)
    assert int(bits, 16) & 0x3FFFFF == 0               # the low byte is k


def test_the_margin_bound():
    """The header's bound: |y - q| <= 2^7 (2^-23 + 2^-48) and half an ulp
    in [64, 128), 2^-18, lie together under the margin."""
    assert 2.0 ** 7 * (2.0 ** -23 + 2.0 ** -48) + 2.0 ** -18 < 2.0 ** -15.6
    assert 2.0 ** -15.6 < float(MARGIN)
    assert np.float32(QMAX) * np.float32(1.0 + 2.0 ** -22) < 127.5


def _emulate_dequantize_int8(q: np.ndarray, s: np.ndarray, dtype, block):
    """``dequantize_int8_kernel`` in float32: each byte + 128 (a flip of its
    top bit) is b in [0, 255]; the float whose bits are 0x4B400000 | b minus
    1.5 * 2^23 + 128 is q, exactly; times the block's scale, rounded once
    to ``dtype``."""
    R, D = q.shape
    b = (q.view(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    value = ((np.uint32(0x4B400000) | b).view(np.float32)
             - (MAGIC + np.float32(128.0)))
    assert np.array_equal(value, q.astype(np.float32))
    out = value.reshape(R, D // block, block) * s[..., None]
    return torch.from_numpy(out.reshape(R, D)).to(dtype)


@pytest.mark.parametrize("block", [128, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_dequantise_equals_the_plain_version(dtype, block):
    """Every byte value (the kernels write [-127, 127]; -128 is taken as it
    comes) under scales of every size, subnormal ones included."""
    rng = np.random.default_rng(11)
    D = WIDTH[block]
    q = rng.integers(-128, 128, (64, D)).astype(np.int8)
    q[0, :256] = np.arange(-128, 128)
    s = (np.exp2(rng.uniform(-140, 60, (64, D // block))) *
         rng.choice([1, -1], (64, D // block))).astype(np.float32)
    got = _emulate_dequantize_int8(q, s, dtype, block)
    want = t_ref.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s),
                                 dtype, block)
    assert torch.equal(got, want)


def test_the_lanes_abs_max_keeps_a_nan():
    """The lane's abs-max is a maximum of bits: a NaN is the largest value
    (an fmaxf would drop it), zeros, subnormals and Inf order as values."""
    rng = np.random.default_rng(12)
    v = np.abs(rng.standard_normal((500, 4)).astype(np.float32))
    v[:100] *= np.float32(1e-40)                      # subnormals
    v[100:110, 3] = 0.0
    v[110:120, 1] = np.inf
    v[120:130, 2] = -np.nan
    bits = (v.view(np.uint32) & np.uint32(0x7FFFFFFF)).max(axis=1)
    got = bits.view(np.float32)
    assert np.isnan(got[120:130]).all()
    assert np.array_equal(got[:120], np.abs(v[:120]).max(axis=1))
    assert np.array_equal(got[130:], np.abs(v[130:]).max(axis=1))
