"""Fleet demo: 24 heterogeneous robots served by 3 shared cloud replicas.

The port's counterpart of ``examples/fleet_serve.py``, statement for
statement over ``repro_torch`` (numpy only: the simulator prices the
requests and runs no kernel), and it prints exactly what that script
prints.

Each robot runs its own RoboECC controller over its own fluctuating link;
cloud-side work is micro-batched per replica and hedged across replicas.
Mid-run, one replica drops (capacity crunch), then the whole cloud tier
goes dark — every controller replans to edge-only — and later recovers.

Picking a codec: ``FleetConfig.codecs`` is the split-boundary transport
axis (``core/codec.py`` names, preferred/lossless first).  The planner
searches (model × split × bandwidth × codec) jointly, so each robot lands
on the codec that minimises its end-to-end latency for its current link —
identity on fast links (no quantisation error for free), int8/int4 as the
link degrades.  Pin a single name (``codecs=("int8",)``) to force one
format fleet-wide, or set ``max_codec_err`` to cap the accuracy proxy.

    PYTHONPATH=src python examples/fleet_serve_torch.py
"""
import numpy as np

from repro_torch.runtime.fleet import FleetConfig, outage_schedule, run_fleet

cfg = FleetConfig(
    n_robots=24,
    archs=("openvla-7b", "cogact-7b", "llama3.2-3b", "glm4-9b"),
    n_ticks=400,
    n_replicas=3,
    codecs=("identity", "int8", "int4"),
    seed=0,
    # flight recorder (core/telemetry.py): "sampled" records ~1/64 of
    # requests — stage spans, metric sketches and the planner-drift
    # audit land in rep.metrics without perturbing the simulation
    telemetry="sampled",
)
cfg.replica_events = outage_schedule(cfg)
for ev in cfg.replica_events:
    print(f"  t={ev.tick * cfg.tick_s:5.1f}s  {ev.replica} {ev.kind}s")

rep = run_fleet(cfg)

print(f"\n{'robot':9s} {'arch':22s} {'n':>4s} {'p50 ms':>8s} {'p95 ms':>8s} "
      f"{'codec':>8s}")
for r in rep.robots:
    print(f"{r.name:9s} {r.arch:22s} {r.n_requests:4d} "
          f"{r.p50_s * 1e3:8.1f} {r.p95_s * 1e3:8.1f} {r.codec:>8s}")

print(f"\n{rep.summary()}")
print(f"outage-window completions (edge-only): {rep.n_outage_completions}")

drift = rep.metrics["drift"]
print(f"telemetry: {rep.metrics['n_recorded']} requests recorded, "
      f"{rep.metrics['spans']['kept']} span groups kept; planner drift "
      f"over {drift['n_joined']} joins, worst stage-sum mismatch "
      f"{drift['reconcile_max_abs_s']:.1e} s")
for stage, st in drift["stages"].items():
    print(f"  {stage:12s} mean err {st['mean_err']:+10.2e}  "
          f"p95 err {st['p95_err']:+10.2e}")

assert rep.throughput_rps > 0 and rep.fleet_p95_s >= rep.fleet_p50_s > 0
assert rep.n_replans > 0, "outage schedule should have triggered replans"
assert all(r.n_requests > 0 for r in rep.robots)
p95s = np.array([r.p95_s for r in rep.robots])
print(f"per-robot p95 spread: {p95s.min() * 1e3:.1f}–{p95s.max() * 1e3:.1f} ms")
print("OK")
