"""The cells of ``BENCHMARK.json`` at a size the CPU runs in a second:
every width cut, two blocks of each stack, two robots."""
from __future__ import annotations

from ecc_bench import catalog

TINY = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
            d_ff=512, vocab_size=512, vit_layers=2, vit_dim=64, n_patches=16)
TINY_DIT = dict(dit_layers=2, dit_dim=64, dit_heads=2, diffusion_steps=3,
                action_horizon=4)


def cell(name: str, limit: float = 1e9) -> catalog.Cell:
    c = catalog.cell(name)
    cfg = c.config["config"]
    cfg.update(TINY)
    if cfg["vla_action_head"] == "dit":
        cfg.update(TINY_DIT)
    t = c.traffic
    t.update(robots=2, warmup_steps=1, trace_steps=2, check_steps=2,
             wire_steps=3)
    if "plan" in t:
        t["plan"] = {"pool_blocks": [0, 2], "edge_blocks": 1,
                     "codec": t["plan"]["codec"]}
    else:
        t["controller"].update(trace_ticks=600, fit_ticks=300, epochs=3)
    for e in c.limits.values():
        e["limit"] = limit
    return c
