"""The port's slice as a whole: the split executor of ``repro_torch``
against its own monolithic forward (the invariants of
tests/test_runtime.py) and against the JAX executor at converted
weights."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro.runtime import partition as j_part
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.runtime.partition import (SplitPlan, VLASplitExecutor,
                                           chunk_payload, chunk_sizes,
                                           decode_activation,
                                           encode_activation, merge_chunks,
                                           payload_bytes)

from _torch_port_util import both_params, t2np, to_np

B, N_TOK = 2, 8


def _setup(name, n_layers=6, dtype="float32"):
    cj = j_get_config(name).reduced().replace(n_layers=n_layers, dtype=dtype)
    ct = get_config(name).reduced().replace(n_layers=n_layers, dtype=dtype)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=0, fill_zeros=True)
    rng = np.random.default_rng(11)
    patches = rng.standard_normal((B, cj.n_patches, cj.vit_dim)).astype(
        np.float32)
    tokens = rng.integers(0, cj.vocab_size, (B, N_TOK))
    noise = rng.standard_normal((B, cj.action_horizon, cj.action_dim)).astype(
        np.float32)
    return dict(cj=cj, ct=ct, mj=mj, mt=mt, pj=pj, pt=pt, patches=patches,
                tokens=tokens, noise=noise,
                t_in=(torch.from_numpy(patches), torch.from_numpy(tokens)),
                t_noise=torch.from_numpy(noise))


@pytest.fixture(scope="module")
def cogact():
    return _setup("cogact-7b")


@pytest.fixture(scope="module")
def openvla():
    return _setup("openvla-7b")


def _bins(action: np.ndarray) -> np.ndarray:
    return np.rint((action + 1.0) * 127.5).astype(np.int64)


def _mono(s):
    return s["mt"].forward(s["pt"], {"patches": s["t_in"][0],
                                     "tokens": s["t_in"][1]}, s["t_noise"])


# ------------------------------------------------ executor == monolithic
@pytest.mark.parametrize("which", ["cogact", "openvla"])
def test_split_equals_monolithic_every_cut(which, request):
    s = request.getfixturevalue(which)
    ref = _mono(s)
    Lv = s["ct"].vit_layers
    ex = VLASplitExecutor(s["ct"], SplitPlan(Lv + 1, Lv + 4), device="cpu")
    for split in range(Lv, Lv + 6):                  # incl. clamped ones
        act, payload = ex.run(s["pt"], *s["t_in"], split, s["t_noise"])
        assert set(payload) == {"x"}
        np.testing.assert_allclose(t2np(act), t2np(ref), atol=1e-5)


@pytest.mark.parametrize("which", ["cogact", "openvla"])
def test_two_pool_equals_monolithic_every_cut_pair(which, request):
    s = request.getfixturevalue(which)
    ref = _mono(s)
    Lv = s["ct"].vit_layers
    ex = VLASplitExecutor(s["ct"], SplitPlan(Lv + 1, Lv + 2,
                                             pool2_start=Lv + 4,
                                             pool2_end=Lv + 6), device="cpu")
    for split in (Lv + 1, Lv + 2):
        for split2 in (Lv + 4, Lv + 5, Lv + 6):
            act, payloads = ex.run(s["pt"], *s["t_in"], split, s["t_noise"],
                                   split2=split2)
            assert set(payloads) == {"up", "down"}
            np.testing.assert_allclose(t2np(act), t2np(ref), atol=1e-5)


@pytest.mark.parametrize("which,rows", [("cogact", 1), ("openvla", 7)])
def test_two_pool_semantic_downlink_slice(which, rows, request):
    """A degenerate pool 2 at the graph end ships only what the action
    stage reads: the cognition token (DiT) or the 7 action positions
    (detok)."""
    s = request.getfixturevalue(which)
    ref = _mono(s)
    cfg = s["ct"]
    Lv, L = cfg.vit_layers, cfg.vit_layers + cfg.n_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv + 1, Lv + 3, pool2_start=L,
                                         pool2_end=L), device="cpu")
    act, payloads = ex.run(s["pt"], *s["t_in"], Lv + 2, s["t_noise"])
    np.testing.assert_allclose(t2np(act), t2np(ref), atol=1e-5)
    assert payloads["down"]["x"].shape[1] == rows
    seq = cfg.n_patches + N_TOK
    assert payload_bytes(payloads["down"]) == \
        payload_bytes(payloads["up"]) // seq * rows


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
@pytest.mark.parametrize("which", ["cogact", "openvla"])
def test_run_streamed_bit_identical(which, n_chunks, request):
    s = request.getfixturevalue(which)
    Lv = s["ct"].vit_layers
    ex = VLASplitExecutor(s["ct"], SplitPlan(Lv + 1, Lv + 3, codec="int8"),
                          device="cpu")
    base, payload = ex.run(s["pt"], *s["t_in"], Lv + 2, s["t_noise"])
    act, chunks = ex.run_streamed(s["pt"], *s["t_in"], Lv + 2, n_chunks,
                                  s["t_noise"])
    assert len(chunks) == n_chunks
    assert torch.equal(act, base)
    assert sum(payload_bytes(c) for c in chunks) == payload_bytes(payload)


def test_two_pool_run_streamed_bit_identical(cogact):
    s = cogact
    Lv = s["ct"].vit_layers
    ex = VLASplitExecutor(s["ct"], SplitPlan(Lv + 1, Lv + 3, codec="int8",
                                             pool2_start=Lv + 4,
                                             pool2_end=Lv + 6, codec2="int8"),
                          device="cpu")
    base, _ = ex.run(s["pt"], *s["t_in"], Lv + 2, s["t_noise"], split2=Lv + 5)
    act, payloads = ex.run_streamed(s["pt"], *s["t_in"], Lv + 2, 4,
                                    s["t_noise"], split2=Lv + 5)
    assert torch.equal(act, base)
    assert isinstance(payloads["up"], list) and len(payloads["up"]) == 4
    assert isinstance(payloads["down"], dict)    # small tail never streams


@pytest.mark.parametrize("codec", ["", "int8", "int4"])
def test_chunk_payload_partitions_bytes_and_merges_exactly(codec):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 13, 256)).astype(np.float32)).to(torch.bfloat16)
    payload = encode_activation(x, codec)
    for k in (1, 2, 4, 13, 20):              # incl. empty chunks (k > S)
        chunks = chunk_payload(payload, k)
        assert len(chunks) == k
        assert sum(payload_bytes(c) for c in chunks) == payload_bytes(payload)
        assert torch.equal(decode_activation(payload),
                           decode_activation(merge_chunks(chunks)))
    with pytest.raises(ValueError):
        merge_chunks([])
    with pytest.raises(ValueError):
        chunk_payload(payload, 0)


@pytest.mark.parametrize("total,k", [(273, 4), (13, 20), (7, 1), (0, 3)])
def test_chunk_sizes_equal_the_planner_copy(total, k):
    from repro.core.pipeline import chunk_sizes as j_chunk_sizes
    assert list(chunk_sizes(total, k)) == list(j_chunk_sizes(total, k))


# ---------------------------------------------------------- against JAX
@pytest.mark.parametrize("which", ["cogact", "openvla"])
def test_int8_executor_against_jax(which, request):
    """Same input, converted weights, float32: the wire carries as many
    bytes as the JAX executor's, and the same bytes wherever the pre-cut
    activations agree.  They agree to float32 rounding only (the two
    frameworks sum in another order), so a value that sits on a rounding
    boundary of the int8 grid may land one step away: at least 99.9 % of
    the payload bytes are equal and the rest are off by one.  The action
    is within 1e-4 (DiT) or the same bins (detok) as far as the int8 cut
    tensors agree."""
    s = request.getfixturevalue(which)
    cj, ct = s["cj"], s["ct"]
    Lv = cj.vit_layers
    key = jax.random.PRNGKey(5)
    exj = j_part.VLASplitExecutor(cj, j_part.SplitPlan(Lv + 1, Lv + 3,
                                                       codec="int8"))
    ext = VLASplitExecutor(ct, SplitPlan(Lv + 1, Lv + 3, codec="int8"),
                           device="cpu")
    noise_j = jax.random.normal(key, (B, cj.action_horizon, cj.action_dim),
                                jnp.float32)
    act_j, pay_j = exj.run(s["pj"], jnp.asarray(s["patches"]),
                           jnp.asarray(s["tokens"]), Lv + 2, key)
    act_t, pay_t = ext.run(s["pt"], *s["t_in"], Lv + 2,
                           torch.from_numpy(np.array(noise_j)))
    assert payload_bytes(pay_t) == j_part.payload_bytes(pay_j)
    qj, qt = np.asarray(pay_j["q"]).astype(np.int32), pay_t["q"].numpy().astype(np.int32)
    assert qj.shape == qt.shape
    diff = np.abs(qj - qt)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    np.testing.assert_allclose(pay_t["s"].numpy(), np.asarray(pay_j["s"]),
                               rtol=1e-5)
    if cj.vla_action_head == "dit":
        np.testing.assert_allclose(t2np(act_t), to_np(act_j), atol=1e-4)
    else:
        # a bin may flip where an int8 step flipped a near-tie of the argmax
        assert (_bins(t2np(act_t)) != _bins(to_np(act_j))).mean() <= 0.15


@pytest.mark.parametrize("which", ["cogact", "openvla"])
def test_raw_executor_against_jax(which, request):
    s = request.getfixturevalue(which)
    cj, ct = s["cj"], s["ct"]
    Lv = cj.vit_layers
    key = jax.random.PRNGKey(5)
    exj = j_part.VLASplitExecutor(cj, j_part.SplitPlan(Lv + 1, Lv + 3))
    ext = VLASplitExecutor(ct, SplitPlan(Lv + 1, Lv + 3), device="cpu")
    noise_j = jax.random.normal(key, (B, cj.action_horizon, cj.action_dim),
                                jnp.float32)
    act_j, pay_j = exj.run(s["pj"], jnp.asarray(s["patches"]),
                           jnp.asarray(s["tokens"]), Lv + 2, key)
    act_t, pay_t = ext.run(s["pt"], *s["t_in"], Lv + 2,
                           torch.from_numpy(np.array(noise_j)))
    assert payload_bytes(pay_t) == j_part.payload_bytes(pay_j)
    np.testing.assert_allclose(t2np(pay_t["x"]), to_np(pay_j["x"]),
                               atol=2e-4, rtol=2e-4)
    if cj.vla_action_head == "dit":
        np.testing.assert_allclose(t2np(act_t), to_np(act_j), atol=1e-4)
    else:
        # the same bins; the jitted reference divides by 127.5 through a
        # reciprocal multiply, which moves the float by an ulp
        assert np.array_equal(_bins(t2np(act_t)), _bins(to_np(act_j)))
        np.testing.assert_allclose(t2np(act_t), to_np(act_j), atol=1e-6)


def test_int4_executor_against_jax():
    """CogACT cut down to a width the int4 codec takes (``d_model`` 256,
    4 heads of 64), float32, converted weights, the same DiT noise.  The
    two executors' cut activations agree to float32 rounding only (sums in
    another order), so: the packed nibbles are equal byte for byte at these
    inputs, the block scales (abs-max of those activations times 1/7) are
    within 1e-5, and the port's codec turns the JAX executor's own cut
    activation into the JAX payload exactly — nibbles and scales.  The
    action is within the 2e-4 of ``tests/test_runtime.py``."""
    kw = dict(n_layers=4, dtype="float32", d_model=256, n_heads=4,
              n_kv_heads=4, head_dim=64, d_ff=512)
    cj = j_get_config("cogact-7b").reduced().replace(**kw)
    ct = get_config("cogact-7b").reduced().replace(**kw)
    pj, pt = both_params(j_build(cj), build(ct), seed=3, fill_zeros=True)
    rng = np.random.default_rng(12)
    patches = rng.standard_normal((B, cj.n_patches, cj.vit_dim)).astype(
        np.float32)
    tokens = rng.integers(0, cj.vocab_size, (B, N_TOK))
    Lv = cj.vit_layers
    key = jax.random.PRNGKey(6)
    noise = np.array(jax.random.normal(
        key, (B, cj.action_horizon, cj.action_dim), jnp.float32))
    exj = j_part.VLASplitExecutor(cj, j_part.SplitPlan(Lv + 1, Lv + 3,
                                                       codec="int4"))
    raw_j = j_part.VLASplitExecutor(cj, j_part.SplitPlan(Lv + 1, Lv + 3))
    ext = VLASplitExecutor(ct, SplitPlan(Lv + 1, Lv + 3, codec="int4"),
                           device="cpu")
    for cut in (Lv + 1, Lv + 2, Lv + 3):
        act_j, pay_j = exj.run(pj, jnp.asarray(patches), jnp.asarray(tokens),
                               cut, key)
        act_t, pay_t = ext.run(pt, torch.from_numpy(patches),
                               torch.from_numpy(tokens), cut,
                               torch.from_numpy(noise))
        assert set(pay_t) == set(pay_j) == {"q4", "s"}
        assert payload_bytes(pay_t) == j_part.payload_bytes(pay_j) == \
            B * (cj.n_patches + N_TOK) * (256 // 2 + 2 * 4)
        assert np.array_equal(pay_t["q4"].numpy(), np.asarray(pay_j["q4"]))
        # 1e-5, not equality: the cut activations already differ by up to
        # 1.55e-6 (3.7e-7 of their largest value) at cut = Lv, before any
        # LLM block, because torch.matmul and jnp.einsum, and the means of
        # rmsnorm, sum in other orders (dense (57, 512) @ (512, 256): 3.6e-6
        # apart, each within 3.6e-6 of the float64 product); the codec
        # itself is exact, as the last check below shows
        np.testing.assert_allclose(pay_t["s"].numpy(), np.asarray(pay_j["s"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(t2np(act_t), to_np(act_j), atol=2e-4)
        _, cut_j = raw_j.run(pj, jnp.asarray(patches), jnp.asarray(tokens),
                             cut, key)
        again = encode_activation(torch.from_numpy(np.array(cut_j["x"])),
                                  "int4")
        assert np.array_equal(again["q4"].numpy(), np.asarray(pay_j["q4"]))
        assert np.array_equal(again["s"].numpy(), np.asarray(pay_j["s"]))


# ------------------------------------------------------------- the plan
def test_split_plan_use_codec_deprecation_shim():
    with pytest.warns(DeprecationWarning, match="use_codec"):
        plan = SplitPlan(2, 5, use_codec=True)
    assert plan.wire_codec == "int8"
    with pytest.warns(DeprecationWarning):
        assert SplitPlan(2, 5, use_codec=False).wire_codec == ""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert SplitPlan(2, 5, codec="int8").wire_codec == "int8"


def test_split_plan_validation_matches_the_reference():
    for kw in (dict(pool2_start=4), dict(pool2_end=6),
               dict(pool2_start=3, pool2_end=6),
               dict(pool2_start=7, pool2_end=6)):
        with pytest.raises(ValueError):
            SplitPlan(2, 5, **kw)
        with pytest.raises(ValueError):
            j_part.SplitPlan(2, 5, **kw)
    plan = SplitPlan(2, 5, pool2_start=6, pool2_end=8)
    ref = j_part.SplitPlan(2, 5, pool2_start=6, pool2_end=8)
    for v in (0, 3, 9):
        assert plan.clamp(v) == ref.clamp(v)
        assert plan.clamp2(v) == ref.clamp2(v)
    assert plan.two_pool and not SplitPlan(2, 5).two_pool


def test_executor_refuses_what_is_not_ported(cogact):
    s = cogact
    Lv = s["ct"].vit_layers
    ex = VLASplitExecutor(s["ct"], SplitPlan(Lv + 1, Lv + 3), device="cpu")
    with pytest.raises(NotImplementedError, match="recorder"):
        ex.run(s["pt"], *s["t_in"], Lv + 2, s["t_noise"], recorder=object())
    with pytest.raises(ValueError, match="LLM range"):
        VLASplitExecutor(s["ct"], SplitPlan(0, Lv + 3), device="cpu")
    with pytest.raises(ValueError, match="second pool"):
        VLASplitExecutor(s["ct"], SplitPlan(Lv + 1, Lv + 3, pool2_start=Lv + 4,
                                            pool2_end=Lv + 99), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            VLASplitExecutor(s["ct"], SplitPlan(Lv + 1, Lv + 3))
