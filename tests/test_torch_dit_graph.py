"""The DiT head's DDIM loop: the hoisted loop against the loop it replaced,
the rules that send a call to a CUDA graph or to the eager path, the
graphs' keys and counters, and (tests marked ``card``, which skip without
a CUDA device) the graph's replay against the eager head on the card.
Imports no JAX, so that the file runs on the card as it is."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch import to_dtype
from repro_torch.configs import get_config
from repro_torch.core.telemetry import FlightRecorder
from repro_torch.models import build
from repro_torch.models import vla as V
from repro_torch.models.layers import dense
from repro_torch.models.sharding import init_params, tree_map
from repro_torch.models.transformer import run_stack
from repro_torch.runtime import action_graph as AG
from repro_torch.runtime.partition import SplitPlan, VLASplitExecutor


# ------------------------------------------------ the loop before hoisting
def _old_timestep_embed(t, dim=64):
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-torch.log(torch.tensor(10_000.0, device=t.device))
                      * idx / half)
    ang = t[..., None].float() * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _old_dit_denoise(cfg, p, noisy, t, cognition):
    dt = to_dtype(cfg.dtype)
    x = dense(noisy.to(dt), p["x_in"])
    cond = dense(cognition, p["cond"]) + dense(_old_timestep_embed(t).to(dt),
                                               p["t_emb"])

    def one(pl, h):
        return V._dit_block(cfg, pl, h, cond), None, 0.0

    x, _, _ = run_stack(cfg, p["blocks"], x, one, cfg.dit_layers)
    m = dense(F.silu(cond.float()).to(x.dtype), p["final_mod"])
    sh, sc = m[:, None, :].chunk(2, dim=-1)
    return dense(V._ln(x) * (1 + sc) + sh, p["out"])


def _old_dit_sample(cfg, p, cognition, noise):
    B = cognition.shape[0]
    dev = cognition.device
    x = noise.to(device=dev, dtype=torch.float32)
    n = cfg.diffusion_steps
    betas = torch.linspace(1e-4, 0.02, n, dtype=torch.float32, device=dev)
    alphas = torch.cumprod(1.0 - betas, dim=0)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for i in range(n):
        t = n - 1 - i
        ab = alphas[t]
        ab_prev = alphas[t - 1] if t > 0 else one
        eps = _old_dit_denoise(cfg, p, x, torch.full((B,), t, device=dev),
                               cognition).float()
        x0 = (x - torch.sqrt(1 - ab) * eps) / torch.sqrt(ab)
        x = torch.sqrt(ab_prev) * x0 + torch.sqrt(1 - ab_prev) * eps
    return x


# ------------------------------------------------------------------ setup
def _tiny(dtype="bfloat16"):
    """The reduced CogACT at the cell's 10 DDIM steps."""
    return get_config("cogact-7b").reduced().replace(diffusion_steps=10,
                                                     dtype=dtype)


def _head(cfg, seed, device="cpu"):
    """The DiT head's parameters, the adaLN-zero leaves drawn too, so that
    every product of a block reaches the answer."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = init_params(V.action_head_specs(cfg), g, device)

    def fill(w):
        if w.eq(0).all():
            w = (0.02 * torch.randn(w.shape, generator=g, device=device)
                 ).to(w.dtype)
        return w
    return tree_map(fill, p)


def _inputs(cfg, batch, seed, device="cpu", rows=3):
    """A cognition feature as the executor hands it over, the last row of
    a (B, rows, d_model) hidden state (a strided view), and the noise."""
    g = torch.Generator(device=device).manual_seed(1000 + seed)
    h = torch.randn((batch, rows, cfg.d_model), generator=g, device=device
                    ).to(to_dtype(cfg.dtype))
    noise = torch.randn((batch, cfg.action_horizon, cfg.action_dim),
                        generator=g, device=device)
    return h[:, -1], noise


# ---------------------------------------------------------------- CPU tests
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_the_hoisted_loop_equals_the_loop_it_replaced(batch, seed):
    cfg = _tiny()
    p = _head(cfg, seed)
    cog, noise = _inputs(cfg, batch, seed)
    with torch.no_grad():
        want = _old_dit_sample(cfg, p, cog, noise)
        got = V.dit_sample(cfg, p, cog, noise)
    assert want.dtype == got.dtype == torch.float32
    assert float(want.abs().max()) > 1e-2
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dit_denoise_keeps_its_signature_and_result(dtype):
    cfg = _tiny(dtype)
    p = _head(cfg, 3)
    cog, noise = _inputs(cfg, 4, 3)
    t = torch.tensor([9, 4, 1, 0])
    want = _old_dit_denoise(cfg, p, noise, t, cog)
    got = V.dit_denoise(cfg, p, noise, t, cog)
    assert float(want.float().abs().max()) > 1e-3
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="noise"):
        V.dit_sample(cfg, p, cog, noise[:2])


class _OnCard:
    """Stands in for a cognition feature on a CUDA device: the rules read
    only where it lies."""
    is_cuda = True


@pytest.mark.parametrize("off", [None, "cpu", "grad", "dtensor",
                                 "capturing"])
def test_the_graph_engages_only_where_capture_is_sound(monkeypatch, off):
    cfg = _tiny()
    p = _head(cfg, 0)
    marked = p["blocks"]["wq"]
    monkeypatch.setattr(AG, "is_dtensor",
                        lambda w: off == "dtensor" and w is marked)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: off == "capturing")
    cog = torch.zeros(2, cfg.d_model) if off == "cpu" else _OnCard()
    with torch.set_grad_enabled(off == "grad"):
        assert AG.capturable(p, cog) is (off is None)


def test_a_cpu_executor_runs_the_head_eagerly_and_counts_it():
    cfg = _tiny()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    params["action"] = _head(cfg, 0)
    Lv = cfg.vit_layers
    g = torch.Generator().manual_seed(5)
    patches = torch.randn((2, cfg.n_patches, cfg.vit_dim), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 5), generator=g)
    noise = V.draw_noise(cfg, 2, "cpu", g)
    ex = VLASplitExecutor(cfg, SplitPlan(Lv + 1, Lv + 2), device="cpu")
    rec = FlightRecorder("full")
    want = model.forward(params, {"patches": patches, "tokens": tokens},
                         noise)
    for n in (1, 2):
        act, _ = ex.run(params, patches, tokens, Lv + 1, noise, recorder=rec)
        assert torch.equal(act, want)
        assert rec.metrics.counters == {AG.EAGER: n}
    ex.run(params, patches, tokens, Lv + 2, noise)
    assert ex.dit.calls == {AG.REPLAYS: 0, AG.CAPTURES: 0, AG.EAGER: 3}
    detok = get_config("openvla-7b").reduced()
    assert VLASplitExecutor(detok, SplitPlan(Lv + 1, Lv + 2),
                            device="cpu").dit is None


class _ReplayedEagerly:
    """A graph's stand-in on the CPU: a replay runs the loop on the static
    inputs into the static output, as the captured kernels would."""

    def __init__(self, run):
        self.run = run

    def replay(self):
        self.run()


def _cpu_capture(self, p, cond, noise):
    consts = V.ddim_constants(self.cfg, cond.device)
    s_cond, s_noise = cond.clone(), noise.clone()
    out = torch.empty_like(noise)
    graph = _ReplayedEagerly(lambda: out.copy_(
        V.dit_ddim(self.cfg, p, s_cond, s_noise, consts)))
    return AG._Graph(graph, s_cond, s_noise, out, consts)


def test_the_graphs_key_count_and_hand_back_unaliased_answers(monkeypatch):
    """The graphs' bookkeeping on the CPU, a capture replaced by a stand-in:
    a new batch or new weights capture anew, the same ones replay, the
    least recently used key goes past ``KEEP``, and an answer survives the
    next replay."""
    monkeypatch.setattr(AG, "capturable", lambda p, cog: True)
    monkeypatch.setattr(AG.DiTGraphs, "_capture", _cpu_capture)
    cfg = _tiny()
    p = _head(cfg, 0)
    heads = AG.DiTGraphs(cfg)
    rec = FlightRecorder("full")

    def call(p, batch, seed):
        cog, noise = _inputs(cfg, batch, seed)
        got = heads(p, cog, noise, rec)
        assert torch.equal(got, V.dit_sample(cfg, p, cog, noise))
        return got

    with torch.no_grad():
        a = call(p, 3, 0)
        b = call(p, 3, 1)
        assert torch.equal(a, call(p, 3, 0)) and not torch.equal(a, b)
        assert heads.calls == {AG.REPLAYS: 2, AG.CAPTURES: 1, AG.EAGER: 0}
        call(p, 1, 0)                                   # another batch
        p2 = tree_map(torch.clone, p)                   # other weights
        call(p2, 3, 0)
        assert heads.calls[AG.CAPTURES] == 3
        for batch in (2, 4):
            call(p, batch, 0)
        assert len(heads._graphs) == AG.KEEP
        call(p, 1, 0)                               # kept
        call(p, 3, 0)                               # gone: used least lately
        assert heads.calls == {AG.REPLAYS: 3, AG.CAPTURES: 6, AG.EAGER: 0}
        assert rec.metrics.counters == {AG.REPLAYS: 3, AG.CAPTURES: 6}
        cog, noise = _inputs(cfg, 3, 0)
        with pytest.raises(ValueError, match="noise"):
            heads(p, cog, noise[:1])


# --------------------------------------------------------------- card tests
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph captures only there")
    return torch.device("cuda")


def _cell_head(card, seed=0):
    """CogACT-7B's DiT head at the DiT cell's widths (768 wide, 12 heads,
    12 blocks, a 16-step chunk of 7, 10 DDIM steps) over its 4096-wide
    cognition feature, bfloat16."""
    cfg = get_config("cogact-7b")
    assert (cfg.dit_dim, cfg.dit_heads, cfg.dit_layers, cfg.action_horizon,
            cfg.action_dim, cfg.diffusion_steps) == (768, 12, 12, 16, 7, 10)
    return cfg, _head(cfg, seed, card)


@pytest.mark.card
@pytest.mark.parametrize("batch", [1, 64])
def test_the_replayed_graph_equals_the_eager_head_on_the_card(card, batch):
    cfg, p = _cell_head(card)
    heads = AG.DiTGraphs(cfg)
    with torch.no_grad():
        for seed in range(3):
            cog, noise = _inputs(cfg, batch, seed, card, rows=273)
            want = V.dit_sample(cfg, p, cog, noise)
            assert torch.equal(want, _old_dit_sample(cfg, p, cog, noise))
            assert torch.equal(heads(p, cog, noise), want)
    assert heads.calls == {AG.REPLAYS: 2, AG.CAPTURES: 1, AG.EAGER: 0}


@pytest.mark.card
def test_a_new_batch_captures_anew_and_every_answer_survives(card):
    cfg, p = _cell_head(card)
    heads = AG.DiTGraphs(cfg)
    rec = FlightRecorder("full")
    with torch.no_grad():
        ins = [_inputs(cfg, b, s, card) for b, s in ((1, 0), (64, 1),
                                                     (64, 2), (1, 3))]
        got = [heads(p, cog, noise, rec) for cog, noise in ins]
        for (cog, noise), a in zip(ins, got):
            assert torch.equal(a, V.dit_sample(cfg, p, cog, noise))
        assert heads.calls == {AG.REPLAYS: 2, AG.CAPTURES: 2, AG.EAGER: 0}
        for _ in range(3):
            heads(p, *ins[1], rec)
        assert rec.metrics.counters == {AG.REPLAYS: 5, AG.CAPTURES: 2}
        with torch.enable_grad():
            heads(p, *ins[0], rec)
    assert rec.metrics.counters[AG.EAGER] == 1
