"""Port parity: the control plane of ``repro_torch.core`` against
``repro.core`` — graph, Alg. 1, pool, ΔNB adjustment, trace simulator,
codec wire bytes and the closed-loop controller, compared with ``==``.
The numpy-only modules are the port's own copies of the reference's, so
every number must come out identical; only the LSTM forecast is computed
by another library, and it is held to 1e-5."""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

from repro import core as J
from repro.configs import ARCHS as J_ARCHS, get_config as j_get_config
from repro_torch import core as T
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lstm_params_from_numpy

from _torch_port_util import jax_tree_to_np

NAMES = sorted(ARCHS)
PAIRS = [("ORIN", "A100"), ("THOR", "A100"), ("ORIN", "TPU_V5E")]
LSTM_TOL = 1e-5


def same(a, b, path="") -> None:
    """Structural equality across the two packages: dataclasses by class
    name and field, containers element by element, arrays by dtype, shape
    and value, numbers with ``==``."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple, range)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b), f"{path}: {type(a)} != {type(b)}"
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def _workload(mod, name):
    cfg = (get_config if mod is T else j_get_config)(name)
    return mod.Workload(s_new=17, decode_steps=0) \
        if cfg.vla_action_head == "dit" else mod.Workload()


def _plan(mod, name, edge="ORIN", cloud="A100", budget_frac=0.6):
    cfg = (get_config if mod is T else j_get_config)(name)
    g = mod.build_graph(cfg, _workload(mod, name))
    budget = budget_frac * sum(c.weight_bytes for c in g)
    seg = mod.search(g, getattr(mod, edge), getattr(mod, cloud), 10e6,
                     cloud_budget_bytes=budget)
    return cfg, g, seg, mod.build_pool(g, seg.split)


def test_the_port_registers_the_same_twelve_configs():
    assert list(ARCHS) == list(J_ARCHS) and len(ARCHS) == 12


ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
COPIES = ["structure", "hardware", "codec", "pipeline", "placement",
          "segmentation", "pool", "network", "adjustment"]


def _code(path):
    """The module's syntax tree without its docstring."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.Expr)
                         and isinstance(n.value, ast.Constant)
                         and isinstance(n.value.value, str))]
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIES)
def test_the_core_copies_are_the_reference_code(name):
    """The numpy-only modules are the reference's code, statement for
    statement (only the module docstring says whose copy it is)."""
    assert _code(ROOT / "repro_torch" / "core" / f"{name}.py") == \
        _code(ROOT / "repro" / "core" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "repro" / "configs").glob("*.py")
    if p.stem not in ("__init__", "base")))
def test_the_config_files_are_the_reference_files(name):
    assert (ROOT / "repro_torch" / "configs" / f"{name}.py").read_bytes() \
        == (ROOT / "repro" / "configs" / f"{name}.py").read_bytes()


@pytest.mark.parametrize("decode_steps", [0, 7])
@pytest.mark.parametrize("name", NAMES)
def test_build_graph_equal(name, decode_steps):
    wl = dict(s_new=17, decode_steps=decode_steps)
    gj = J.build_graph(j_get_config(name), J.Workload(**wl))
    gt = T.build_graph(get_config(name), T.Workload(**wl))
    same(gj, gt)
    assert T.total_flops(gt) == J.total_flops(gj)
    assert T.total_weight_bytes(gt) == J.total_weight_bytes(gj)


@pytest.mark.parametrize("edge,cloud", PAIRS)
@pytest.mark.parametrize("name", NAMES)
def test_alg1_search_and_pool_equal(name, edge, cloud):
    for frac in (0.3, 0.6, None):
        cj, gj, sj, pj = _plan(J, name, edge, cloud, frac or 1e9)
        ct, gt, st, pt = _plan(T, name, edge, cloud, frac or 1e9)
        same(sj, st)
        same(pj, pt)
        same(J.pool_transfer_profile(gj, pj), T.pool_transfer_profile(gt, pt))
    for codec in ("int8", "int4"):
        e, c = getattr(J, edge), getattr(J, cloud)
        same(J.search(gj, e, c, 2e6, cloud_budget_bytes=12e9,
                      codec=J.get_codec(codec)),
             T.search(gt, getattr(T, edge), getattr(T, cloud), 2e6,
                      cloud_budget_bytes=12e9, codec=T.get_codec(codec)))


@pytest.mark.parametrize("name", NAMES)
def test_evaluate_split_equal(name):
    _, gj, _, _ = _plan(J, name)
    _, gt, _, _ = _plan(T, name)
    n = len(gj)
    for split in sorted({0, 1, n // 3, n // 2, n - 1, n}):
        for bw in (0.3e6, 10e6):
            for codec in (None, "int8", "int4"):
                kw = dict(rtt_s=0.005, input_bytes=150_000.0)
                same(J.evaluate_split(gj, split, J.ORIN, J.A100, bw,
                                      codec=J.get_codec(codec), **kw),
                     T.evaluate_split(gt, split, T.ORIN, T.A100, bw,
                                      codec=T.get_codec(codec), **kw))


@pytest.mark.parametrize("name", NAMES)
def test_adjust_and_adjust_placement_equal(name):
    """A seeded set of (split, NB_pred, NB_real) through the single-cut
    and the placement adjusters, with and without the codec axis."""
    _, gj, _, pj = _plan(J, name)
    _, gt, _, pt = _plan(T, name)
    rng = np.random.default_rng(NAMES.index(name))
    thr_j, thr_t = J.Thresholds(1.5e6, -1.5e6), T.Thresholds(1.5e6, -1.5e6)
    codecs = ["identity", "int8", "int4"]
    splits = list(pj.splits())
    for _ in range(12):
        split = int(rng.choice(splits))
        real = float(rng.uniform(0.2e6, 15e6))
        pred = real + float(rng.normal(0.0, 3e6))
        for cs, cur in ((None, None), (codecs, "int8")):
            dj = J.adjust(gj, pj, split, pred, real, thr_j, codecs=cs,
                          current_codec=cur, edge=J.ORIN, cloud=J.A100)
            dt = T.adjust(gt, pt, split, pred, real, thr_t, codecs=cs,
                          current_codec=cur, edge=T.ORIN, cloud=T.A100)
            same(dj, dt)
            same(J.adjust_placement(
                     gj, pj, J.PlacementPlan.single(split, cur), pred, real,
                     thr_j, codecs=cs, edge=J.ORIN, cloud=J.A100),
                 T.adjust_placement(
                     gt, pt, T.PlacementPlan.single(split, cur), pred, real,
                     thr_t, codecs=cs, edge=T.ORIN, cloud=T.A100))


@pytest.mark.parametrize("seed", [0, 11])
def test_generate_trace_and_network_sim_equal(seed):
    for cfg in (None, J.TraceConfig(ar_sigma=0.05)):
        tcfg = None if cfg is None else T.TraceConfig(**dataclasses.asdict(cfg))
        a, b = J.generate_trace(4000, cfg, seed=seed), \
            T.generate_trace(4000, tcfg, seed=seed)
        same(a, b)
    nj, nt = J.NetworkSim(a, rtt_s=0.005), T.NetworkSim(b, rtt_s=0.005)
    for step in (0, 1, 31, 200):
        nj.step(step)
        nt.step(step)
        assert nt.now_bps == nj.now_bps
        same(nj.window(32), nt.window(32))
        for nbytes in (1e3, 594_048.0, 8e6):
            assert nt.transfer_s(nbytes) == nj.transfer_s(nbytes)
            assert nt.transfer_trace_s(nbytes, 0.01) == \
                nj.transfer_trace_s(nbytes, 0.01)


def test_codecs_equal_and_price_the_same_wire_bytes():
    assert list(T.CODECS) == list(J.CODECS)
    for name in J.CODECS:
        cj, ct = J.CODECS[name], T.CODECS[name]
        same(cj, ct)
        for raw in (2.0 * 273 * 4096, 2.0 * 17 * 4096, 2.0 * 4096, 1e9):
            assert ct.wire_bytes(raw) == cj.wire_bytes(raw)
            for dj, dt in ((J.ORIN, T.ORIN), (J.A100, T.A100)):
                assert ct.encode_s(raw, dt) == cj.encode_s(raw, dj)
                assert ct.decode_s(raw, dt) == cj.decode_s(raw, dj)
    same(J.DEVICES, T.DEVICES)


# ------------------------------------------------------------ controller
class _Forecast:
    """A deterministic stand-in for the LSTM, identical on both sides, so
    that the controllers' own logic is compared with ``==``."""

    def __init__(self, mod):
        self.cfg = mod.PredictorConfig(window=8)

    def predict(self, window):
        return float(window[-1] * 1.5 - window[0] * 0.5)


@pytest.mark.parametrize("mode", [dict(), dict(multicut=True),
                                  dict(streamed=True)])
@pytest.mark.parametrize("name", ["cogact-7b", "openvla-7b", "glm4-9b"])
def test_controller_modes_equal_with_a_fixed_forecast(name, mode):
    trace = J.generate_trace(400, seed=2)
    ticks = []
    for mod, get in ((J, j_get_config), (T, get_config)):
        ctl = mod.RoboECC(get(name), mod.ORIN, mod.A100,
                          workload=_workload(mod, name),
                          cloud_budget_bytes=12e9,
                          thresholds=mod.Thresholds(1.5e6, -1.5e6),
                          adjust_codecs=["identity", "int8", "int4"], **mode)
        ctl.predictor = _Forecast(mod)
        net = mod.NetworkSim(trace)
        net.step(8)
        ticks.append([ctl.tick(net) for _ in range(40)])
        ticks[-1].append((ctl.seg, ctl.pool, ctl.pool2, ctl.placement))
    for rj, rt in zip(*ticks):
        if isinstance(rj, tuple):
            same(rj, rt)
            continue
        rj.adjust_overhead_s = rt.adjust_overhead_s = 0.0
        rj.total_s = rt.total_s = 0.0
        same(rj, rt)


@pytest.fixture(scope="module")
def jax_predictor():
    """The reference predictor as the serving example trains it, at 20
    epochs to keep the file fast."""
    trace = J.generate_trace(4000, seed=11)
    pred, _ = J.train_predictor(trace[:3000], J.PredictorConfig(epochs=20))
    return trace, pred


def _cogact_controller(mod):
    get = get_config if mod is T else j_get_config
    return mod.RoboECC(get("cogact-7b"), mod.ORIN, mod.A100,
                       workload=mod.Workload(s_new=17, decode_steps=0),
                       cloud_budget_bytes=12e9,
                       thresholds=mod.Thresholds(high=1.5e6, low=-1.5e6),
                       adjust_codecs=["identity", "int8", "int4"])


def test_cogact_closed_loop_200_ticks_equal(jax_predictor):
    """The 200-tick CogACT-7B loop of the serving example, both controllers
    driven by the same JAX-trained LSTM (converted into the port): every
    tick's split, codec, decision and modelled latencies are equal, and
    the forecast is within the LSTM tolerance.  The wall-clock
    ``adjust_overhead_s`` (and the ``total_s`` that adds it) is excluded."""
    trace, jpred = jax_predictor
    cj, ct = _cogact_controller(J), _cogact_controller(T)
    same(cj.graph, ct.graph)
    same((cj.seg, cj.pool), (ct.seg, ct.pool))
    assert (cj.seg.split, cj.pool.start, cj.pool.end) == (28, 27, 28)
    cj.predictor = jpred
    ct.predictor = T.Predictor(
        lstm_params_from_numpy(jax_tree_to_np(jpred.params), "cpu"),
        T.PredictorConfig(**dataclasses.asdict(jpred.cfg)), jpred.ref_bps)
    nj, nt = J.NetworkSim(trace[3000:]), T.NetworkSim(trace[3000:])
    nj.step(32)
    nt.step(32)
    codecs = []
    for _ in range(200):
        rj, rt = cj.tick(nj), ct.tick(nt)
        assert (rt.split, rt.codec, rt.n_chunks) == \
            (rj.split, rj.codec, rj.n_chunks)
        assert (rt.edge_s, rt.cloud_s, rt.net_s) == \
            (rj.edge_s, rj.cloud_s, rj.net_s)
        assert rt.bw_real_bps == rj.bw_real_bps
        assert rt.bw_pred_bps == pytest.approx(rj.bw_pred_bps, rel=LSTM_TOL)
        assert (rt.decision.split, rt.decision.reason, rt.decision.codec,
                rt.decision.moved) == (rj.decision.split, rj.decision.reason,
                                       rj.decision.codec, rj.decision.moved)
        same(rj.placement, rt.placement)
        codecs.append(rt.codec)
    assert "int4" in codecs


def test_fit_predictor_trains_on_the_device_it_is_given():
    ctl = _cogact_controller(T)
    ctl.fit_predictor(T.generate_trace(200, seed=1),
                      T.PredictorConfig(epochs=2, hidden=8), device="cpu")
    assert ctl.predictor.device.type == "cpu"
    assert isinstance(ctl.predictor.predict(np.full(32, 5e6)), float)
