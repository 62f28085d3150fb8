"""Port parity: ``repro_torch``'s LM split executor against its own
monolithic forward (the invariants of tests/test_runtime.py) and against
the JAX executor at converted weights; the serving scheduler held equal to
the reference's copy; the serving entry point on the CPU."""
import ast
import io
import pathlib
import re
import warnings
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro.runtime import partition as j_part
from repro.runtime import scheduler as j_sched
from repro_torch.configs import get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import build
from repro_torch.models.transformer import lm_hidden, lm_logits
from repro_torch.runtime import scheduler as t_sched
from repro_torch.runtime.partition import (LMSplitExecutor, SplitPlan,
                                           payload_bytes)

from _torch_port_util import both_params, t2np, to_np

B, S = 2, 12


def _setup(n_kv_heads=None):
    cj = j_get_config("llama3.2-3b").reduced().replace(n_layers=6,
                                                       dtype="float32")
    ct = get_config("llama3.2-3b").reduced().replace(n_layers=6,
                                                     dtype="float32")
    if n_kv_heads:
        cj, ct = (c.replace(n_kv_heads=n_kv_heads) for c in (cj, ct))
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=0)
    tokens = np.random.default_rng(1).integers(0, cj.vocab_size, (B, S))
    tt = torch.from_numpy(tokens).to(torch.int32)
    h, _ = lm_hidden(ct, pt, tt)
    return dict(cj=cj, ct=ct, pj=pj, pt=pt, tj=jnp.asarray(tokens, jnp.int32),
                tt=tt, ref=lm_logits(ct, pt, h))


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def lm(request):
    return _setup(request.param)


def _ex(s, plan):
    return LMSplitExecutor(s["ct"], plan, device="cpu")


# --------------------------------------------- executor == monolithic
def test_split_equals_monolithic_every_cut(lm):
    ex = _ex(lm, SplitPlan(2, 5))
    for split in range(0, 7):                       # incl. clamped ones
        logits, payload = ex.run(lm["pt"], lm["tt"], split)
        assert set(payload) == {"x"}
        np.testing.assert_allclose(t2np(logits), t2np(lm["ref"]), rtol=2e-4,
                                   atol=2e-4)


def test_two_pool_equals_monolithic_every_cut_pair(lm):
    ex = _ex(lm, SplitPlan(1, 3, pool2_start=4, pool2_end=6))
    for split in range(1, 4):
        for split2 in range(4, 7):
            logits, payloads = ex.run(lm["pt"], lm["tt"], split, split2)
            assert set(payloads) == {"up", "down"}
            np.testing.assert_allclose(t2np(logits), t2np(lm["ref"]),
                                       rtol=2e-4, atol=2e-4)


def test_codec_halves_the_payload(lm):
    raw = _ex(lm, SplitPlan(2, 5))
    qz = _ex(lm, SplitPlan(2, 5, codec="int8"))
    _, p_raw = raw.run(lm["pt"], lm["tt"], 3)
    logits, p_q = qz.run(lm["pt"], lm["tt"], 3)
    assert set(p_q) == {"q", "s"}
    assert payload_bytes(p_q) < 0.6 * payload_bytes(p_raw)
    ref = lm["ref"]
    rel = ((logits - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
    assert rel < 0.05


@pytest.mark.parametrize("codec", ["", "int8"])
def test_run_streamed_bit_identical(lm, codec):
    ex = _ex(lm, SplitPlan(2, 5, codec=codec))
    base, payload = ex.run(lm["pt"], lm["tt"], 3)
    for k in (1, 2, 3, 5, 12):
        logits, chunks = ex.run_streamed(lm["pt"], lm["tt"], 3, k)
        assert len(chunks) == k and torch.equal(logits, base)
        assert sum(payload_bytes(c) for c in chunks) == payload_bytes(payload)


def test_two_pool_run_streamed_bit_identical(lm):
    ex = _ex(lm, SplitPlan(1, 3, codec="int8", pool2_start=4, pool2_end=6,
                           codec2="int8"))
    base, _ = ex.run(lm["pt"], lm["tt"], 2, split2=5)
    logits, payloads = ex.run_streamed(lm["pt"], lm["tt"], 2, 4, split2=5)
    assert torch.equal(logits, base)
    assert isinstance(payloads["up"], list) and len(payloads["up"]) == 4
    assert set(payloads["down"]) == {"q", "s"}      # the tail never streams


# ---------------------------------------------- against the JAX executor
@pytest.mark.parametrize("plan_kw,splits", [
    ({"pool_start": 0, "pool_end": 3}, [0, 1, 3]),
    ({"pool_start": 1, "pool_end": 3, "pool2_start": 4, "pool2_end": 6},
     [(1, 4), (2, 6)]),
])
@pytest.mark.parametrize("codec", ["", "int8"])
def test_logits_and_payload_against_jax(lm, plan_kw, splits, codec):
    """Logits within 2e-4.  The payload is byte-equal where the cut
    activation is bit-equal (cut 0: the embedding rows); elsewhere the
    activations agree to float32 rounding, so the int8 bytes are equal
    and the scales within 1e-5 (ROADMAP queue C)."""
    kw = dict(plan_kw, codec=codec)
    if "pool2_start" in kw:
        kw["codec2"] = codec
    ej = j_part.LMSplitExecutor(lm["cj"], j_part.SplitPlan(**kw))
    et = _ex(lm, SplitPlan(**kw))
    for cut in splits:
        c1, c2 = cut if isinstance(cut, tuple) else (cut, None)
        lj, pj = ej.run(lm["pj"], lm["tj"], c1, c2)
        lt, pt = et.run(lm["pt"], lm["tt"], c1, c2)
        np.testing.assert_allclose(t2np(lt), to_np(lj), rtol=2e-4, atol=2e-4)
        pairs = [(pj, pt)] if c2 is None else [(pj["up"], pt["up"]),
                                                 (pj["down"], pt["down"])]
        for a, b in pairs:
            assert set(a) == set(b)
            assert payload_bytes(b) == j_part.payload_bytes(a)
            if "q" in b:
                assert np.array_equal(t2np(b["q"]), to_np(a["q"]))
                np.testing.assert_allclose(
                    t2np(b["s"]), to_np(a["s"]), atol=0,
                    rtol=0 if (c1, c2) == (0, None) else 1e-5)
            else:
                np.testing.assert_allclose(t2np(b["x"]), to_np(a["x"]),
                                           atol=2e-5)


def test_cut_zero_ships_the_embedding_rows_byte_equal():
    s = _setup()
    ej = j_part.LMSplitExecutor(s["cj"], j_part.SplitPlan(0, 2, codec="int8"))
    et = LMSplitExecutor(s["ct"], SplitPlan(0, 2, codec="int8"), device="cpu")
    _, pj = ej.run(s["pj"], s["tj"], 0)
    _, pt = et.run(s["pt"], s["tt"], 0)
    assert np.array_equal(t2np(pt["q"]), to_np(pj["q"]))
    assert np.array_equal(t2np(pt["s"]), to_np(pj["s"]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_reduced_serve_codec_ships_the_reference_payload(dtype):
    """The data plane of ``launch.serve --codec``: the reduced Llama-3.2-3B
    at 8 layers (d_model 64, so the int8 codec takes one 64-column block a
    row), the pool ``[3, 6)``, a batch of 4 requests of 17 tokens, in the
    config's own bfloat16 and in float32.  At every cut the port's payload
    has the reference's bytes and blocks, and is what the reference's codec
    makes of the port's cut activation, byte for byte.  With the pool at
    ``[0, 3)``, cut 0 ships the embedding rows, which both executors hold
    bit for bit: the payloads are byte-equal.  In float32 the two
    executors' payloads also agree with each other, the int8 values within
    one step (a value on a rounding boundary may flip: the cut activations
    agree to matmul order) and the scales within 1e-5; in bfloat16 the cut
    activations themselves round apart, so that comparison is the one on
    the shared activation above."""
    cj = j_get_config("llama3.2-3b").reduced().replace(n_layers=8,
                                                       dtype=dtype)
    ct = get_config("llama3.2-3b").reduced().replace(n_layers=8, dtype=dtype)
    assert ct.d_model == 64
    pj, pt = both_params(j_build(cj), build(ct), seed=3)
    tokens = np.random.default_rng(4).integers(0, cj.vocab_size, (4, 17))
    tj, tt = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens).int()
    ej = j_part.LMSplitExecutor(cj, j_part.SplitPlan(3, 6, codec="int8"))
    et = LMSplitExecutor(ct, SplitPlan(3, 6, codec="int8"), device="cpu")
    for cut in (0, 3, 4, 5, 6):
        _, pay_j = ej.run(pj, tj, cut)
        _, pay_t = et.run(pt, tt, cut)
        assert payload_bytes(pay_t) == j_part.payload_bytes(pay_j) \
            == 4 * 17 * 64 + 4 * 17 * 4
        assert tuple(pay_t["s"].shape) == tuple(pay_j["s"].shape) \
            == (4, 17, 1)
        h = et._edge_hidden(pt, tt, cut)
        ref = j_part.encode_activation(
            jnp.asarray(t2np(h.float())).astype(cj.dtype), "int8")
        assert np.array_equal(t2np(pay_t["q"]), to_np(ref["q"]))
        assert np.array_equal(t2np(pay_t["s"]), to_np(ref["s"]))
        if dtype == "float32":
            dq = t2np(pay_t["q"]).astype(np.int32) - to_np(pay_j["q"])
            assert np.abs(dq).max() <= 1
            np.testing.assert_allclose(t2np(pay_t["s"]), to_np(pay_j["s"]),
                                       atol=0, rtol=1e-5)
    _, pay_j = j_part.LMSplitExecutor(
        cj, j_part.SplitPlan(0, 3, codec="int8")).run(pj, tj, 0)
    _, pay_t = LMSplitExecutor(ct, SplitPlan(0, 3, codec="int8"),
                               device="cpu").run(pt, tt, 0)
    assert np.array_equal(t2np(pay_t["q"]), to_np(pay_j["q"]))
    assert np.array_equal(t2np(pay_t["s"]), to_np(pay_j["s"]))


# ----------------------------------------------------------- what raises
def test_the_executor_refuses_what_it_does_not_serve():
    """An MoE model is served, but a pool may not straddle its dense/MoE
    group boundary (deepseek-v2-lite-16b reduced: one dense block first);
    the VLA family goes to its own executor."""
    ds = get_config("deepseek-v2-lite-16b").reduced().replace(n_layers=4)
    LMSplitExecutor(get_config("granite-moe-3b-a800m").reduced(),
                    SplitPlan(0, 1), device="cpu")
    LMSplitExecutor(ds, SplitPlan(0, 1), device="cpu")
    LMSplitExecutor(ds, SplitPlan(1, 3), device="cpu")
    with pytest.raises(ValueError, match="straddles"):
        LMSplitExecutor(ds, SplitPlan(0, 2), device="cpu")
    with pytest.raises(ValueError, match="straddles"):
        LMSplitExecutor(ds, SplitPlan(0, 0, pool2_start=0, pool2_end=3),
                        device="cpu")
    with pytest.raises(ValueError, match="dense"):
        LMSplitExecutor(get_config("openvla-7b").reduced(), SplitPlan(0, 1),
                        device="cpu")
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(ValueError, match="pool"):
        LMSplitExecutor(cfg, SplitPlan(0, cfg.n_layers + 1), device="cpu")
    ex = LMSplitExecutor(cfg, SplitPlan(0, 1), device="cpu")
    with pytest.raises(ValueError, match="meta"):
        ex.run({}, torch.zeros((1, 2), dtype=torch.int32, device="meta"), 0)


def test_the_executor_runs_on_the_card_unless_asked():
    cfg = get_config("llama3.2-3b").reduced()
    if torch.cuda.is_available():
        assert LMSplitExecutor(cfg, SplitPlan(0, 1)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LMSplitExecutor(cfg, SplitPlan(0, 1))


def test_use_codec_shim_warns_and_works(lm):
    with pytest.warns(DeprecationWarning, match="use_codec"):
        plan = SplitPlan(2, 5, use_codec=True)
    _, p = _ex(lm, plan).run(lm["pt"], lm["tt"], 3)
    assert set(p) == {"q", "s"}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert SplitPlan(2, 5, codec="int8").wire_codec == "int8"


# ------------------------------------------------------ the scheduler, ==
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _code(path):
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.Expr)
                         and isinstance(n.value, ast.Constant)
                         and isinstance(n.value.value, str))]
    return ast.dump(tree)


def test_the_scheduler_is_the_reference_code():
    assert _code(SRC / "repro_torch" / "runtime" / "scheduler.py") == \
        _code(SRC / "repro" / "runtime" / "scheduler.py")


@pytest.mark.parametrize("mod", [t_sched, j_sched], ids=["port", "jax"])
def test_microbatcher_forms_on_size_and_timeout(mod):
    mb = mod.MicroBatcher(batch_size=3, max_wait_s=0.5)
    mb.add(mod.Request(0, 0.0, 4))
    assert mb.maybe_form(0.1) is None
    mb.add(mod.Request(1, 0.1, 4))
    mb.add(mod.Request(2, 0.1, 4))
    b = mb.maybe_form(0.2)
    assert b is not None and len(b.requests) == 3
    mb.add(mod.Request(3, 1.0, 4))
    assert mb.maybe_form(1.1) is None
    b2 = mb.maybe_form(1.6)          # timeout fires
    assert b2 is not None and len(b2.requests) == 1


def _hedge_run(mod):
    sm = mod.StragglerMitigator()
    lat = {"fast": 0.01, "slow": 0.10}
    seq = {"n": 0}

    def exec_fn(r):
        seq["n"] += 1
        if r == "fast" and seq["n"] == 30:      # one tail event after warmup
            return 1.0
        return lat[r]

    return [sm.run(["fast", "slow"], exec_fn) for _ in range(40)]


def test_straggler_hedging_prefers_the_fast_replica():
    outs = _hedge_run(t_sched)
    assert sum(o.hedged for o in outs) >= 1
    assert all(o.latency_s < 1.0 for o in outs if o.hedged)
    assert all(o.replica == "fast" for o in outs[5:29])
    ref = _hedge_run(j_sched)
    assert [(o.replica, o.latency_s, o.hedged, o.winner) for o in outs] == \
        [(o.replica, o.latency_s, o.hedged, o.winner) for o in ref]


@pytest.mark.parametrize("mod", [t_sched, j_sched], ids=["port", "jax"])
def test_elastic_pool_detects_loss(mod):
    events = []
    pool = mod.ElasticPool(on_change=lambda live: events.append(tuple(live)),
                           timeout_s=1.0)
    pool.heartbeat("edge", 0.0)
    pool.heartbeat("cloud", 0.0)
    assert pool.live(0.5) == ["cloud", "edge"]
    pool.heartbeat("cloud", 2.0)     # edge went silent
    assert pool.live(2.0) == ["cloud"]
    assert events[-1] == ("cloud",)


# ------------------------------------------------------- the serving entry point
def test_serve_entry_point_on_the_cpu():
    """``python -m repro_torch.launch.serve --device cpu``: the Alg. 1 line
    is the reference controller's for the same arguments; the number of
    batches depends on the wall clock (MicroBatcher's timeout), so only
    the shape of the report is checked."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        t_serve.main(["--device", "cpu", "--requests", "8", "--codec"])
    lines = buf.getvalue().splitlines()
    cfg = j_get_config("llama3.2-3b")
    ctl = J.RoboECC(cfg, J.ORIN, J.A100, workload=J.Workload(s_new=17),
                    cloud_budget_bytes=0.9 * cfg.n_params() * 2,
                    use_codec=True)
    assert lines[0] == (f"Alg.1 split: {ctl.seg.split}/{len(ctl.graph)} "
                        f"pool=[{ctl.pool.start},{ctl.pool.end}) "
                        f"overhead={ctl.pool.overhead_frac*100:.2f}%")
    assert re.fullmatch(r"served 8 requests in [1-8] batches", lines[1])
    assert lines[2].startswith("modeled total latency: mean ")
    assert re.fullmatch(r"cut payload: [0-9.]+ KB/request \(codec=on\)",
                        lines[3])


# ------------------------------------------------------------ MoE family
def _moe_setup(arch, **kw):
    kw = dict(n_layers=4, dtype="float32", **kw)
    cj = j_get_config(arch).reduced().replace(**kw)
    ct = get_config(arch).reduced().replace(**kw)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=0)
    tokens = np.random.default_rng(1).integers(0, cj.vocab_size, (2, 10))
    return cj, ct, pj, pt, tokens


MOE_PLANS = [("granite-moe-3b-a800m", (1, 3), 2),
             ("deepseek-v2-lite-16b", (1, 3), 2),
             ("deepseek-v2-lite-16b", (0, 1), 1)]


@pytest.mark.parametrize("arch,pool,split", MOE_PLANS)
def test_moe_split_equivalence(arch, pool, split):
    """tests/test_runtime.py::test_moe_split_equivalence in the port: the
    split run's logits against the JAX package's full forward within its
    2e-4, and against the JAX executor's; every cut of the pool equals the
    port's own monolithic forward."""
    from repro.models.transformer import lm_hidden as j_lm_hidden
    from repro.models.transformer import lm_logits as j_lm_logits
    cj, ct, pj, pt, tokens = _moe_setup(arch)
    hj, _ = j_lm_hidden(cj, pj, jnp.asarray(tokens), remat=False)
    ref = j_lm_logits(cj, pj, hj)
    ex = LMSplitExecutor(ct, SplitPlan(*pool), device="cpu")
    tt = torch.from_numpy(tokens)
    logits, _ = ex.run(pt, tt, split)
    np.testing.assert_allclose(t2np(logits), to_np(ref), rtol=2e-4,
                               atol=2e-4)
    lj, _ = j_part.LMSplitExecutor(cj, j_part.SplitPlan(*pool)).run(
        pj, jnp.asarray(tokens), split)
    np.testing.assert_allclose(t2np(logits), to_np(lj), rtol=2e-4, atol=2e-4)
    h, _ = lm_hidden(ct, pt, tt)
    mono = lm_logits(ct, pt, h)
    for s in range(pool[0], pool[1] + 1):
        np.testing.assert_allclose(t2np(ex.run(pt, tt, s)[0]), t2np(mono),
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_two_pool_and_int8_against_jax(arch):
    """A two-pool plan with both pools in the MoE group equals the
    monolithic forward; the int8 uplink payload of the port and of the
    JAX executor agree (codes within one step, scales within 1e-5)."""
    cj, ct, pj, pt, tokens = _moe_setup(arch)
    tt = torch.from_numpy(tokens)
    h, _ = lm_hidden(ct, pt, tt)
    mono = lm_logits(ct, pt, h)
    ex = LMSplitExecutor(ct, SplitPlan(1, 2, pool2_start=3, pool2_end=4),
                         device="cpu")
    logits, legs = ex.run(pt, tt, 2, 3)
    np.testing.assert_allclose(t2np(logits), t2np(mono), atol=1e-5)
    assert set(legs) == {"up", "down"}
    _, pay_j = j_part.LMSplitExecutor(
        cj, j_part.SplitPlan(1, 3, codec="int8")).run(pj, jnp.asarray(tokens),
                                                      2)
    _, pay_t = LMSplitExecutor(ct, SplitPlan(1, 3, codec="int8"),
                               device="cpu").run(pt, tt, 2)
    assert payload_bytes(pay_t) == j_part.payload_bytes(pay_j)
    dq = t2np(pay_t["q"]).astype(np.int32) - to_np(pay_j["q"])
    assert np.abs(dq).max() <= 1
    np.testing.assert_allclose(t2np(pay_t["s"]), to_np(pay_j["s"]),
                               atol=0, rtol=1e-5)


def test_moe_int4_cut():
    """granite reduced at a width the int4 codec takes (d_model 256): the
    packed payload is a quarter of the float32 bytes plus the scales, and
    the logits stay within the codec's error of the monolithic forward."""
    cj, ct, pj, pt, tokens = _moe_setup("granite-moe-3b-a800m", d_model=256,
                                        n_heads=4, n_kv_heads=2, head_dim=64)
    tt = torch.from_numpy(tokens)
    h, _ = lm_hidden(ct, pt, tt)
    mono = lm_logits(ct, pt, h)
    logits, pay = LMSplitExecutor(ct, SplitPlan(1, 3, codec="int4"),
                                  device="cpu").run(pt, tt, 2)
    assert set(pay) == {"q4", "s"}
    assert payload_bytes(pay) == 2 * 10 * 256 // 2 + 2 * 10 * 2 * 4
    assert torch.isfinite(logits).all()
    assert float((logits - mono).abs().max()) < 0.1 * float(mono.abs().max())
