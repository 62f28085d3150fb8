"""The readings the limits of ``limits/<cell>.json`` are set from.

For each seed: the cell's set-up, a short window at the cell's own load,
and the program's readings against the reference on the sampled steps, as
a run judges them, with each request's own readings.  For the first
``--control`` seeds also the control's: the reference in float8 e4m3
(``lowp="fp8"``, the nearest precision below the configuration's
bfloat16) put in the program's place on the same steps.  One JSON line a seed; the benchmark's
own runs do not run this.

    python3 -m ecc_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        --control 3 --seconds 4
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List

import torch

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds: List[int], seconds: float, n_control: int,
             device="cuda") -> Iterator[Dict]:
    from . import check
    from .harness import Run
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        r = Run(cell, seed, device)
        r.warm()
        r.window(seconds)
        r.close()
        each: Dict[str, list] = {"program": []}
        out = {"seed": seed,
               "program": check.judge(cell.family, cell.config["config"],
                                      r.params, r.inputs, r.sample,
                                      each["program"]),
               "steps": [(kept.step, kept.decision)
                         for kept in r.sample.kept]}
        if k < n_control:
            each["control"] = []
            out["control"] = check.control(cell.family,
                                           cell.config["config"], r.params,
                                           r.inputs, r.sample,
                                           requests=each["control"])
        out["requests"] = each
        out["seconds"] = time.perf_counter() - t0
        del r
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from ecc_bench import catalog
    if not torch.cuda.is_available():
        print("ecc_bench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = catalog.cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    for out in readings(cell, seeds, args.seconds, args.control):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
