"""What the port's kernels are built for covers what its ``build`` serves:
every config's attention geometry (head dim, GQA group) lies in the flash
attention and flash-decode instantiations — MLA's prefill head dims
(q/k 192, v 128 in deepseek-v2-lite-16b) in the flash attention's built
pairs, its absorbed decode having no kernel; the VLM's (D 128, group 4)
and the encoder-decoder's (D 64, group 1) causal self attention, their
cross attention and the encoder being plain products — and every SSM
geometry (state dim, head dim) in the SSD scan's.  ``build`` serves all
six families and refuses none (``REFUSED`` is empty), so that a family
added later turns this red unless the kernels take its geometry.  Head
dim 96 (phi3-mini-3.8b) reaches both attention entry points on a card and
agrees with the JAX package on the CPU, and deepseek-v2-lite-16b's
(192, 128) reaches the flash attention entry."""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ref as j_dec_ref
from repro.kernels.flash_attention import ref as j_fa_ref
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.models import build

from _torch_port_util import t2np, to_np

# causal prefill + decode
ATTENTION = ("dense", "vla", "hybrid", "moe", "vlm", "audio")
SSM = ("ssm", "hybrid")
REFUSED = ()


def test_the_walk_covers_every_config_and_family():
    assert len(ARCHS) == 12
    fams = {c.family for c in ARCHS.values()}
    assert fams == set(ATTENTION) | set(SSM) | set(REFUSED)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_what_build_serves_lies_in_what_the_kernels_build(name):
    cfg = get_config(name)
    if cfg.family in REFUSED:
        with pytest.raises(NotImplementedError, match="not ported"):
            build(cfg)
        return
    build(cfg)
    if cfg.family in ATTENTION and cfg.use_mla:
        # MLA: the prefill's decompressed heads; decode is absorbed (plain)
        pair = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
        assert pair in fa.HEAD_DIM_PAIRS, (name, pair)
    elif cfg.family in ATTENTION:
        hd, group = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
        assert cfg.n_heads % cfg.n_kv_heads == 0
        assert (hd, hd) in fa.HEAD_DIM_PAIRS and hd in da.HEAD_DIMS, (name,
                                                                      hd)
        assert group <= da.MAX_GROUP, (name, group)
    if cfg.family in ("vlm", "audio"):
        # llama-3.2-vision-11b: 32 x 128 over 8 KV heads; seamless: 16 x 64
        want = {"vlm": (128, 4), "audio": (64, 1)}[cfg.family]
        _cross_family_geometry(cfg, want)
    if cfg.family in SSM:
        assert cfg.ssm_state in ssd.STATE_DIMS, (name, cfg.ssm_state)
        assert cfg.ssm_headdim in ssd.HEAD_DIMS, (name, cfg.ssm_headdim)
        assert 1 <= cfg.ssm_chunk <= ssd.MAX_CHUNK


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_what_the_reduced_configs_serve_lies_in_what_the_kernels_build(name):
    """The reduced configs (the serving driver's data plane and the CPU
    tests) too: their attention geometry lies in what B5/B6 are built for
    — deepseek-v2-lite-16b's reduced MLA prefill at (24, 16)."""
    cfg = get_config(name).reduced()
    if cfg.family in REFUSED:
        return
    build(cfg)
    if cfg.family in ATTENTION and cfg.use_mla:
        pair = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
        assert pair in fa.HEAD_DIM_PAIRS, (name, pair)
    elif cfg.family in ATTENTION:
        hd = cfg.resolved_head_dim
        assert (hd, hd) in fa.HEAD_DIM_PAIRS and hd in da.HEAD_DIMS, (name,
                                                                      hd)
        assert cfg.n_heads // cfg.n_kv_heads <= da.MAX_GROUP, name
    if cfg.family in ("vlm", "audio"):
        _cross_family_geometry(cfg, (16, 1))     # reduced: 4 x 16, MHA


def _cross_family_geometry(cfg, want):
    """The VLM's and the encoder-decoder's causal self attention: its
    (head dim, group) is ``want`` and lies in B5's pairs, B6's head dims
    and B6's largest group."""
    hd, group = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    assert (hd, group) == want, (cfg.name, hd, group)
    assert (hd, hd) in fa.HEAD_DIM_PAIRS, (cfg.name, hd)
    assert hd in da.HEAD_DIMS and group <= da.MAX_GROUP, (cfg.name, hd, group)


def test_the_limits_the_walk_meets():
    """phi3-mini-3.8b is the head dim 96 the kernels now build; glm4-9b's
    group of 16 query heads a KV head sits exactly at the bf16
    flash-decode's limit."""
    assert get_config("phi3-mini-3.8b").resolved_head_dim == 96
    glm = get_config("glm4-9b")
    assert glm.n_heads // glm.n_kv_heads == da.MAX_GROUP == 16
    ds = get_config("deepseek-v2-lite-16b")
    assert (ds.qk_nope_dim + ds.qk_rope_dim, ds.v_head_dim) == (192, 128)
    gr = get_config("granite-moe-3b-a800m")
    assert (gr.resolved_head_dim, gr.n_heads // gr.n_kv_heads) == (64, 3)


# ------------------------------------------------- head dim 96 on a card
class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    for mod in (fa, da):
        monkeypatch.setattr(mod.torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa, "_device_kind", lambda ts, name: "cuda")
    monkeypatch.setattr(da, "_device_kind", lambda ts: "cuda")
    monkeypatch.setattr(da, "sm_count", lambda d: 132)
    monkeypatch.setattr(da, "_SCRATCH", {})
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    monkeypatch.setattr(da.decode_attention, "launches", 0)
    return fake


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_phi3_prefill_reaches_the_flash_attention_entry(fake_card, dtype):
    """phi3-mini-3.8b's prefill, (1, 512, 32/32, 96) causal: one C call
    with head dim 96."""
    cfg = get_config("phi3-mini-3.8b")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.zeros((1, 512, H, hd), dtype=dtype)
    k = torch.zeros((1, 512, KV, hd), dtype=dtype)
    out = fa.flash_attention(q, k, k, causal=True)
    assert out.shape == q.shape and out.dtype == dtype
    ((name, a),) = fake_card.calls
    assert name == "rt_flash_attention"
    assert a[4:11] == (1, 512, 512, H, KV, 96, 96)
    assert a[23] == 96 ** -0.5 and a[24] == 1
    assert a[25] == fa.DTYPE_CODE[dtype]
    assert fa.flash_attention.launches == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_deepseek_prefill_reaches_the_flash_attention_entry(fake_card, dtype):
    """deepseek-v2-lite-16b's MLA prefill, one layer at (1, 512): one C
    call with q/k head dim 192 and v head dim 128, the scale of the q/k
    head dim, and an output of v's head dim."""
    from repro_torch.models import attention as t_attn
    cfg = get_config("deepseek-v2-lite-16b").replace(
        dtype=str(dtype).split(".")[-1])
    specs = t_attn.mla_specs(cfg)
    p = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}
    x = torch.zeros((1, 512, cfg.d_model), dtype=dtype)
    y = t_attn.mla_forward(cfg, p, x, torch.arange(512))
    assert tuple(y.shape) == (1, 512, cfg.d_model)
    ((name, a),) = fake_card.calls
    assert name == "rt_flash_attention"
    H = cfg.n_heads
    assert a[4:11] == (1, 512, 512, H, H, 192, 128)
    assert a[20:23] == (512 * H * 128, H * 128, 128)            # out
    assert a[23] == 192 ** -0.5 and a[24] == 1
    assert a[25] == fa.DTYPE_CODE[dtype]
    assert fa.flash_attention.launches == 1
    # the serving driver's reduced deepseek: (24, 16)
    red = get_config("deepseek-v2-lite-16b").reduced().replace(
        dtype=str(dtype).split(".")[-1])
    p = {k: torch.zeros(s.shape, dtype=s.dtype)
         for k, s in t_attn.mla_specs(red).items()}
    t_attn.mla_forward(red, p, torch.zeros((2, 17, red.d_model), dtype=dtype),
                       torch.arange(17))
    (_, a) = fake_card.calls[1]
    assert a[4:11] == (2, 17, 17, red.n_heads, red.n_heads, 24, 16)
    assert a[23] == 24 ** -0.5
    with pytest.raises(ValueError, match="head dim 192"):
        fa.flash_attention(torch.zeros((1, 8, 2, 192), dtype=dtype),
                           torch.zeros((1, 8, 2, 192), dtype=dtype),
                           torch.zeros((1, 8, 2, 192), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_phi3_decode_reaches_the_flash_decode_entry(fake_card, dtype):
    """phi3-mini-3.8b's decode step on its flat (1, 576, 32 * 96) cache:
    one C call with head dim 96, the split plan of the buffer and a
    scratch of D + 2 floats a partial row."""
    cfg = get_config("phi3-mini-3.8b")
    H, KV, hd, T = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 576
    cache = torch.zeros((1, T, KV * hd), dtype=dtype)
    k4 = cache.view(1, T, KV, hd).permute(0, 2, 1, 3)
    q = torch.zeros((1, 1, H, hd), dtype=dtype)
    out = da.decode_attention(q, k4, k4, 513)
    assert out.shape == (1, 1, H, hd) and out.dtype == dtype
    ((name, a),) = fake_card.calls
    assert name == "rt_decode_attention" and a[1] == cache.data_ptr()
    chunk, n_split = da.split_plan(T, KV, 132)
    assert a[6:12] == (1, H, KV, T, 96, 513)
    assert a[13:15] == (chunk, n_split)
    part, _ = da._SCRATCH[q.device]
    assert part.numel() == H * n_split * (96 + 2)
    assert a[25] == 96 ** -0.5
    assert da.decode_attention.launches == 1


def test_a_head_dim_still_unbuilt_raises_before_a_launch(fake_card):
    q = torch.zeros((1, 8, 2, 80), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 80"):
        fa.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="head dim 80"):
        da.decode_attention(q[:, :1], q.permute(0, 2, 1, 3),
                            q.permute(0, 2, 1, 3), 4)
    assert not fake_card.calls


# --------------------------------------- head dim 96 against the reference
DTYPES = [("float32", jnp.float32, torch.float32, 5e-6),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, 2e-2)]


def _draw(shapes, jdt, tdt, seed):
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for shape in shapes:
        a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        ).astype(jdt)
        js.append(a)
        ts.append(torch.from_numpy(np.array(to_np(a))).to(tdt))
    return js, ts


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_phi3_shaped_prefill_attention_matches_the_reference(name, jdt, tdt,
                                                             tol):
    """phi3's heads (32 of 96, MHA) over 80 causal positions: the port's
    plain flash attention against the JAX package's reference, the
    tolerances of tests/test_torch_flash_attention.py."""
    cfg = get_config("phi3-mini-3.8b")
    H, KV, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 80
    (q, k, v), (qt, kt, vt) = _draw([(1, S, H, D), (1, S, KV, D),
                                     (1, S, KV, D)], jdt, tdt, 96)
    want = j_fa_ref.attention(q, k, v, causal=True)
    got = fa.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == tdt and tuple(got.shape) == (1, S, H, D)
    np.testing.assert_allclose(t2np(got), to_np(want), atol=tol)


@pytest.mark.parametrize("name,jdt,tdt,tol", [
    ("float32", jnp.float32, torch.float32, 1e-5),
    ("bfloat16", jnp.bfloat16, torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kv_len", [1, 77, 150])
def test_phi3_shaped_decode_attention_matches_the_reference(kv_len, name,
                                                            jdt, tdt, tol):
    """One phi3 query token against a 150-position cache of head dim 96:
    the port's plain flash-decode against the JAX package's reference, the
    tolerances of tests/test_torch_decode_attention.py."""
    cfg = get_config("phi3-mini-3.8b")
    H, KV, D, T = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 150
    (q, k, v), (qt, kt, vt) = _draw([(2, H, D), (2, KV, T, D),
                                     (2, KV, T, D)], jdt, tdt, kv_len)
    want = j_dec_ref.decode_attention(q, k, v, kv_len)
    got = da.decode_attention(qt, kt, vt, kv_len)
    assert got.dtype == tdt and tuple(got.shape) == (2, 1, H, D)
    np.testing.assert_allclose(t2np(got)[:, 0], to_np(want).reshape(2, H, D),
                               atol=tol)
