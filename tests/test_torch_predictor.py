"""Port parity: the LSTM bandwidth predictor of ``repro_torch.core``
against ``repro.core.predictor`` on the same numpy windows and converted
parameters.  Tolerance 1e-5 in float32: the same products and gates, sums
taken in another order by another library."""
import jax
import numpy as np
import pytest
import torch

from repro.core import predictor as jp
from repro.core.network import generate_trace as j_generate_trace
from repro_torch.convert import lstm_params_from_numpy
from repro_torch.core import predictor as tp

from _torch_port_util import jax_tree_to_np

TOL = 1e-5


def _jax_init(seed, hidden):
    return jax_tree_to_np(jp.init_lstm(jax.random.PRNGKey(seed), hidden))


@pytest.mark.parametrize("hidden,batch,T", [(64, 8, 32), (16, 3, 5),
                                            (64, 1, 1)])
def test_lstm_forward_matches_jax(hidden, batch, T):
    params = _jax_init(hidden, hidden)
    rng = np.random.default_rng(hidden + T)
    win = (rng.standard_normal((batch, T)) * 0.5).astype(np.float32)
    ref = np.asarray(jp.lstm_forward(params, win))
    got = tp.lstm_forward(lstm_params_from_numpy(params, "cpu"),
                          torch.from_numpy(win))
    assert got.shape == (batch,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_predict_matches_jax_and_returns_a_float():
    params = _jax_init(3, 64)
    cfg = tp.PredictorConfig()
    trace = j_generate_trace(200, seed=4)
    jpred = jp.Predictor(params, jp.PredictorConfig(), float(trace.mean()))
    tpred = tp.Predictor(lstm_params_from_numpy(params, "cpu"), cfg,
                         float(trace.mean()))
    for t in (32, 100, 199):
        w = trace[t - 32:t]
        got = tpred.predict(w)
        assert isinstance(got, float)
        assert got == pytest.approx(jpred.predict(w), rel=TOL)
    assert tpred.n_bytes() == jpred.n_bytes()
    assert tpred.device == torch.device("cpu")


def test_init_lstm_shapes_and_generator():
    p = tp.init_lstm(torch.Generator().manual_seed(0), 16, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {"wx": (1, 64), "wh": (16, 64), "b": (64,), "head": (16, 1)}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert not p["b"].any()
    q = tp.init_lstm(torch.Generator().manual_seed(0), 16, "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    r = tp.init_lstm(torch.Generator().manual_seed(1), 16, "cpu")
    assert not torch.equal(p["wh"], r["wh"])


def test_train_first_loss_matches_jax_and_the_loss_goes_down(monkeypatch):
    """Both start from the JAX package's initial parameters and draw the
    same batches; the first loss is computed before any update, so it
    agrees to float32 rounding.  Later weights drift apart by rounding
    and are not compared; the loss must fall over the 20 epochs."""
    cfg_j = jp.PredictorConfig(epochs=20, hidden=32)
    cfg_t = tp.PredictorConfig(epochs=20, hidden=32)
    trace = j_generate_trace(600, seed=3)
    init = _jax_init(0, 32)
    monkeypatch.setattr(tp, "init_lstm",
                        lambda gen, hidden, device: lstm_params_from_numpy(
                            init, device))
    _, lj = jp.train_predictor(trace, cfg_j, seed=0)
    pred, lt = tp.train_predictor(trace, cfg_t, seed=0, device="cpu")
    assert len(lt) == len(lj) == 20
    assert lt[0] == pytest.approx(lj[0], rel=1e-5)
    np.testing.assert_allclose(lt[:3], lj[:3], rtol=1e-3)
    assert np.mean(lt[-5:]) < np.mean(lt[:5])
    assert pred.ref_bps == float(np.mean(trace))
    assert all(v.device.type == "cpu" for v in pred.params.values())


def test_train_without_patching_is_seeded():
    trace = j_generate_trace(300, seed=5)
    cfg = tp.PredictorConfig(epochs=3, hidden=8)
    a, la = tp.train_predictor(trace, cfg, seed=2, device="cpu")
    b, lb = tp.train_predictor(trace, cfg, seed=2, device="cpu")
    assert la == lb
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_lstm_params_from_numpy_checks_keys_and_shapes():
    params = _jax_init(0, 8)
    with pytest.raises(KeyError):
        lstm_params_from_numpy({k: v for k, v in params.items()
                                if k != "b"}, "cpu")
    bad = dict(params, head=np.zeros((8, 2), np.float32))
    with pytest.raises(ValueError, match="head"):
        lstm_params_from_numpy(bad, "cpu")


def test_check_granularity_equal():
    for args in ((0.05, 0.137, 0.094), (0.2, 0.137, 0.094),
                 (0.094, 0.137, 0.094)):
        assert tp.check_granularity(*args) == jp.check_granularity(*args)


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    trace = j_generate_trace(100, seed=0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tp.train_predictor(trace, tp.PredictorConfig(epochs=1))
    with pytest.raises(RuntimeError, match="CUDA device"):
        tp.init_lstm(torch.Generator(), 8)
