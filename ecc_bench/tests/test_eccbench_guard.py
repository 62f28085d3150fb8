"""What the harness and the reference load, and what they read.

Each import runs in a fresh interpreter, since the test process itself
loads the JAX package for other tests.  Top-level names are compared
whole: ``repro_torch`` is not ``repro``."""
import json
import re
import subprocess
import sys

import pytest

from ecc_bench import catalog
from ecc_bench.run import forbidden_modules

HARNESS = ["ecc_bench.run", "ecc_bench.harness", "ecc_bench.program",
           "ecc_bench.check", "ecc_bench.calibrate", "ecc_bench.devtrace"]
# every module each cell finds by name: its family, server, loop, metrics
CELL_MODULES = ("from ecc_bench import catalog\n"
                "for n in catalog.names(catalog.load()):\n"
                "    cell = catalog.cell(n)\n"
                "    for m in cell.end_to_end + cell.per_layer:\n"
                "        cell.metric_reader(m['name'])\n")
REFERENCE = ["ecc_bench.reference.vla", "ecc_bench.reference.codec"]


def _loaded(modules, extra=""):
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in modules) + extra
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=str(catalog.ROOT),
                         env={"PYTHONPATH": f"{catalog.ROOT / 'src'}:"
                                            f"{catalog.ROOT}",
                              "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_jax_package():
    top = _loaded(HARNESS, CELL_MODULES)
    assert "repro_torch" in top      # the system under test is loaded
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_either_package():
    top = _loaded(REFERENCE)
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules({"repro_torch.core": 1, "reprox": 1,
                              "jax_utils": 1}) == []
    assert forbidden_modules({"repro.core.codec": 1, "jax.numpy": 1,
                              "flax": 1}) == ["flax", "jax", "repro"]


@pytest.mark.parametrize("path", sorted(p.relative_to(catalog.HERE).as_posix()
                                        for p in catalog.HERE.rglob("*.py")))
def test_no_file_of_the_benchmark_reads_the_old_harness(path):
    """The JAX package's harness in ``benchmarks/`` is read by nothing."""
    if path.endswith("test_eccbench_guard.py"):
        return
    text = (catalog.HERE / path).read_text()
    assert not re.search(r"benchmarks\s*/|\bimport\s+benchmarks\b"
                         r"|\bfrom\s+benchmarks\b|['\"]benchmarks['\"]",
                         text), path
