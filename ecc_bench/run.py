"""Run one cell of ``BENCHMARK.json`` and print its result as the last line.

    python3 -m ecc_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout; ``src`` is put on the path.  The run needs as
many CUDA cards as the cell asks for and exits with code 2 and no result
when they are not there.  It exits with code 3 and no result if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.  The numbers
compared with the reference are printed beside their limits as the last
lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# one host thread for the math libraries: the run's host work is one
# Python thread issuing to the card, and idle pool threads only compete
# with it for the host's shared cores
THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is, whole, one of
    ``FORBIDDEN`` (``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.update(THREADS)
    sys.path.insert(0, str(ROOT / "src"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from ecc_bench import catalog, harness

    cell = catalog.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"ecc_bench: the cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed % (1 << 63), args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"ecc_bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, e in out["check"].items():
        print(f"check {name} {e['value']!r} limit {e['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
