"""Run RoboECC's segmentation across ALL 10 assigned architectures + the
paper's own VLAs, on the PyTorch/CUDA port's control plane: per-arch
optimal split, pool, and latency decomposition — the paper's "diverse
model structures" claim (Insight 1) at framework scale.

The port's counterpart of ``examples/multi_arch_segmentation.py``,
statement for statement over ``repro_torch`` (numpy only: the planner runs
no kernel), and it prints exactly what that script prints.

    PYTHONPATH=src python examples/multi_arch_segmentation_torch.py
"""
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import Workload, build_graph, build_pool, fixed_split, \
    evaluate_split, search
from repro_torch.core.hardware import A100, ORIN

BW = 10e6

print(f"{'arch':24s} {'layers':>6s} {'split':>5s} {'edge ms':>8s} "
      f"{'cloud ms':>8s} {'net ms':>7s} {'total ms':>8s} {'vs fixed':>8s} "
      f"{'pool %':>6s}")
for arch in sorted(ARCHS):
    cfg = get_config(arch)
    w = Workload(decode_steps=7 if cfg.vla_action_head in ("detok", "")
                 and cfg.family == "vla" else 0)
    g = build_graph(cfg, w)
    budget = 0.9 * sum(c.weight_bytes for c in g)
    seg = search(g, ORIN, A100, BW, cloud_budget_bytes=budget)
    fx = sum(evaluate_split(g, fixed_split(g), ORIN, A100, BW))
    pool = build_pool(g, seg.split, overhead_target=0.028)
    print(f"{arch:24s} {len(g):6d} {seg.split:5d} {seg.edge_s * 1e3:8.1f} "
          f"{seg.cloud_s * 1e3:8.1f} {seg.net_s * 1e3:7.1f} "
          f"{seg.total_s * 1e3:8.1f} {fx / seg.total_s:7.2f}x "
          f"{pool.overhead_frac * 100:6.2f}")
print("\n(all 12 architectures segmented by the same Alg.1 + Eq.1/Eq.2 "
      "models; DESIGN.md §4)")
