"""The packed-int4 codec kernels (B3 quantise, B4 dequantise) of
``repro_torch`` on the CPU: the quantise kernel's rounding written out in
float32 and held equal to the plain version.  The wrappers' dispatch to
the C entries on a stand-in card is in ``test_torch_hygiene.py``."""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.activation_codec import ref as t_ref

# the kernel's constants (csrc/activation_codec.cu: kTieMargin, kMagic) and
# the smallest normal float32, below which a block's scale sends every
# element to the division
MARGIN = np.float32(2.0 ** -18)
MAGIC = np.float32(1.5 * 2.0 ** 23)
FLT_MIN = np.finfo(np.float32).tiny


# ------------------------------------------------- the kernel's rounding
def _kernel_nibbles(xb: np.ndarray, s: np.ndarray, margin=MARGIN):
    """rint(x / s) + 7 as ``quantize_int4_kernel`` computes it, in float32:
    per block r = RN(1/s); per element y = RN(x * r), t = RN(y + M) with
    M = 1.5 * 2^23 + 7, and d = y - (t - M) = y - rint(y); the nibble is
    bits(t) & 15, unless |d| >= 1/2 - ``margin`` (y within the margin of a
    half-integer) or the block's scale lies below FLT_MIN, where the element
    takes clamp(rint(x / s), -7, 7) + 7 with the IEEE quotient.  Returns
    (nibbles, which elements took the product)."""
    m7 = MAGIC + np.float32(7.0)
    with np.errstate(all="ignore"):
        r = np.float32(1.0) / s
        y = xb * r
        t = y + m7
        d = y - (t - m7)
        fast = (s >= FLT_MIN) & (np.abs(d) < np.float32(0.5) - margin)
        q_fast = t.view(np.uint32) & np.uint32(15)
        q_div = np.clip(np.rint(xb / s), -7, 7) + 7
    return np.where(fast, q_fast, q_div).astype(np.int32), fast


def _emulate_quantize_int4(x: np.ndarray):
    """The whole quantise kernel on a float32 (R, D) array: block scales as
    the kernel forms them, nibbles by ``_kernel_nibbles``, bytes packed
    q_lo + 16 q_hi - 128 with element j beside element j + 128."""
    R, D = x.shape
    xb = x.reshape(R, D // 128, 128)
    amax = np.abs(xb).max(axis=-1, keepdims=True)
    s = np.where(amax > 0, amax * np.float32(1.0 / 7.0),
                 np.float32(1.0)).astype(np.float32)
    q, fast = _kernel_nibbles(xb, s)
    q = q.reshape(R, D // 256, 2, 128)
    packed = (q[:, :, 0] + 16 * q[:, :, 1] - 128).astype(np.int8)
    return packed.reshape(R, D // 2), s[..., 0], fast


def _as_input(x: np.ndarray, dtype) -> np.ndarray:
    """``x`` rounded to ``dtype`` and back to float32, as the kernel reads
    it."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def _random(rng, shape):
    return (rng.standard_normal(shape) * 3.0).astype(np.float32)


def _ties(rng, shape):
    """Every block holds 7.0 once (scale exactly 1.0); the rest lies on the
    half-integers -6.5 ... 6.5."""
    x = rng.integers(-7, 7, shape).astype(np.float32) + np.float32(0.5)
    x[:, ::128] = 7.0
    return x


def _near_ties(rng, shape, dtype):
    """Quotients at and next to half-integers (the construction of
    ``chip_smoke.py``'s ``near_ties``).  Even blocks: abs-max 7 m 2^e for
    an odd m, the rest (2k + 1) m 2^(e-1), exact in ``dtype``.  Odd blocks:
    abs-max a 2^e with a = 1 + j/128, the rest a (2k + 1) 2^e / 14 rounded
    to ``dtype`` (k = 3: exactly half the abs-max).  A third of all
    elements then move one ulp of ``dtype``."""
    R, D = shape
    nb = R * D // 128
    m = rng.choice([1, 3, 5, 9, 11, 13, 15, 17, 19], (nb, 1))
    e = np.exp2(rng.integers(-3, 4, (nb, 1))).astype(np.float32)
    a = (1 + rng.integers(0, 128, (nb, 1)) / 128).astype(np.float32)
    k = rng.integers(0, 7, (nb, 128))
    sign = rng.integers(0, 2, (nb, 128)) * 2 - 1
    odd = (np.arange(nb) % 2 == 1)[:, None]
    amax = np.where(odd, a * e, (7 * m).astype(np.float32) * e)
    x = np.where(odd, a * e * (2 * k + 1).astype(np.float32) / 14,
                 ((2 * k + 1) * m).astype(np.float32) * e / 2)
    x = x.astype(np.float32)
    x[:, 0] = amax[:, 0]
    t = torch.from_numpy(sign * x).float().to(dtype)
    bits = t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    step = torch.from_numpy(rng.integers(-1, 2, (nb, 128)))
    step[:, 0] = 0
    bits += step.to(bits.dtype)
    return t.float().numpy().reshape(R, D)


def _sub_flt_min(rng, shape):
    """Blocks whose scale lies below FLT_MIN, subnormal elements in them:
    every fourth with a scale near 1e-39, where RN(1/s) overflows, every
    fourth from the third on with one near 5e-39, where it is finite; and
    every fourth from the second on with a tiny normal scale."""
    x = _random(rng, shape)
    blocks = x.reshape(-1, 128)
    blocks[0::4] *= np.float32(1e-39)
    blocks[2::4] *= np.float32(4e-39)
    blocks[1::4] *= np.float32(1e-30)
    return x


INPUTS = {
    "random": lambda rng, shape, dt: _as_input(_random(rng, shape), dt),
    "ties": lambda rng, shape, dt: _as_input(_ties(rng, shape), dt),
    "near_ties": lambda rng, shape, dt: _near_ties(rng, shape, dt),
    "sub_flt_min": lambda rng, shape, dt: _as_input(_sub_flt_min(rng, shape),
                                                     dt),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_kernel_rounding_equals_the_division(kind, dtype):
    """The reciprocal product with its tie margin and its FLT_MIN rule
    gives the plain version's ``torch.round(x / s)`` on every element:
    payload and scales bit for bit."""
    x = INPUTS[kind](np.random.default_rng(7), (96, 1024), dtype)
    assert np.isfinite(x).all()
    packed, s, _ = _emulate_quantize_int4(x)
    want_p, want_s = t_ref.quantize_int4(torch.from_numpy(x))
    assert np.array_equal(s, want_s.numpy())
    assert np.array_equal(packed, want_p.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_random_inputs_take_the_product(dtype):
    """Away from ties the division is rare: on random activations nearly
    every element rounds its product (float32 inputs all but a few in a
    million; bfloat16 ones, whose quotients are ratios of 8-bit numbers
    and land on half-integers more often, all but a few per thousand)."""
    x = INPUTS["random"](np.random.default_rng(8), (96, 1024), dtype)
    *_, fast = _emulate_quantize_int4(x)
    assert fast.mean() > (0.99 if dtype == torch.bfloat16 else 0.9999)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_near_ties_need_the_margin(dtype):
    """On the near-tie inputs the product alone (no margin) rounds some
    elements the other way than the IEEE quotient, and every such element
    lies inside the margin, so the kernel divides there."""
    x = INPUTS["near_ties"](np.random.default_rng(9), (96, 1024), dtype)
    xb = x.reshape(96, 8, 128)
    _, s, _ = _emulate_quantize_int4(x)
    s = s[..., None]
    q_product, _ = _kernel_nibbles(xb, s, margin=np.float32(-1.0))
    q_kernel, fast = _kernel_nibbles(xb, s)
    wrong = q_product != np.clip(np.rint(xb / s), -7, 7).astype(np.int32) + 7
    assert wrong.sum() > 0
    assert not (wrong & fast).any()
    assert np.array_equal(q_kernel[wrong],
                          (np.clip(np.rint(xb / s), -7, 7) + 7)
                          .astype(np.int32)[wrong])


def test_a_scale_below_flt_min_divides_the_whole_block():
    """Both where RN(1/s) overflows and where it is finite."""
    x = INPUTS["sub_flt_min"](np.random.default_rng(10), (8, 512),
                              torch.float32)
    _, s, fast = _emulate_quantize_int4(x)
    small = s < FLT_MIN
    with np.errstate(over="ignore"):
        finite_r = np.isfinite(np.float32(1.0) / s)
    assert (small & finite_r).any() and (small & ~finite_r).any()
    assert (s > 0).all()
    assert not fast[small].any() and fast[~small].mean() > 0.99


def test_the_constants_are_the_kernels():
    src = (_build.CSRC / "activation_codec.cu").read_text()
    (margin,) = re.findall(r"kTieMargin = 0x1p-(\d+)f", src)
    assert np.float32(2.0 ** -int(margin)) == MARGIN
    (magic,) = re.findall(r"kMagic = (\d+)\.0f", src)
    (bits,) = re.findall(r"kMagicBits = (0x[0-9A-F]+)u", src)
    assert np.float32(int(magic)) == MAGIC
    assert np.array(MAGIC).view(np.uint32) == int(bits, 16)


def _emulate_dequantize_int4(packed: np.ndarray, s: np.ndarray, dtype):
    """``dequantize_int4_kernel`` in float32: each byte + 128 (a flip of
    its top bit), the low and high nibble n each turned into n - 7 by the
    float whose bits are 0x4B400000 | n minus 1.5 * 2^23 + 7, times the
    block's scale, rounded once to ``dtype``."""
    R, Dh = packed.shape
    w = packed.view(np.uint8).astype(np.uint32) ^ np.uint32(0x80)
    w = w.reshape(R, Dh // 128, 128)
    def value(n):
        return ((np.uint32(0x4B400000) | n).view(np.float32)
                - (MAGIC + np.float32(7.0)))
    sb = s.reshape(R, Dh // 128, 2, 1)
    lo = value(w & np.uint32(15)) * sb[:, :, 0]
    hi = value(w >> np.uint32(4)) * sb[:, :, 1]
    out = np.stack([lo, hi], axis=2).reshape(R, 2 * Dh)
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_dequantise_equals_the_plain_version(dtype):
    """Every byte value (the kernels write [-128, 110]; the rest is taken
    as it comes) under scales of every size, subnormal ones included."""
    rng = np.random.default_rng(11)
    packed = rng.integers(-128, 128, (64, 512)).astype(np.int8)
    packed[0, :256] = np.arange(-128, 128)
    s = (np.exp2(rng.uniform(-140, 60, (64, 8))) *
         rng.choice([1, -1], (64, 8))).astype(np.float32)
    got = _emulate_dequantize_int4(packed, s, dtype)
    want = t_ref.dequantize_int4(torch.from_numpy(packed), torch.from_numpy(s),
                                 dtype)
    assert torch.equal(got, want)


def test_the_warp_max_of_abs_values_is_the_max_of_their_bits():
    """The kernel takes a block's abs-max as the integer maximum of the
    float bits (one redux.sync): for values >= 0 (zeros, subnormals,
    normals, inf) the bits order as the values."""
    rng = np.random.default_rng(12)
    v = np.abs(rng.standard_normal((500, 32)).astype(np.float32))
    v[:100] *= np.float32(1e-40)                      # subnormals
    v[100:110, 3] = 0.0
    v[110:120, 7] = np.inf
    bits = v.view(np.uint32).max(axis=1).view(np.float32)
    assert np.array_equal(bits, v.max(axis=1))
