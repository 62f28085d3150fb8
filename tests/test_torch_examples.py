"""The paper's example scripts on the port (``examples/*_torch.py``),
each run as its own process under its own time limit: the two numpy-only
scripts print exactly what the reference scripts print, the quickstart
prints what the reference's does, the VLA serving script runs its
60 requests with ``--device cpu`` and ends ``OK``, and the training
script converges on the CPU at a small width and survives its injected
failure."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script, *args, timeout):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("name,timeout", [("multi_arch_segmentation", 120),
                                          ("fleet_serve", 240)])
def test_numpy_only_examples_print_what_the_reference_prints(name, timeout):
    port = _run(f"{name}_torch.py", timeout=timeout)
    assert port == _run(f"{name}.py", timeout=timeout)
    assert len(port.splitlines()) > 10


def test_quickstart_on_the_cpu_prints_what_the_reference_prints():
    port = _run("quickstart_torch.py", "--device", "cpu", timeout=120)
    assert port.splitlines()[-1] == "OK"
    assert port == _run("quickstart.py", timeout=120)


def test_serve_vla_ecc_on_the_cpu():
    """The control plane's lines equal what the reference's controller
    plans; the cut payload is the int8 payload of the reduced CogACT's
    full sequence."""
    from repro.configs import get_config
    from repro.core import RoboECC, Thresholds, Workload
    from repro.core.hardware import A100, ORIN
    from repro.kernels.activation_codec import ref as codec_ref
    out = _run("serve_vla_ecc_torch.py", "--device", "cpu",
               timeout=240).splitlines()
    assert out[-1] == "OK"
    assert re.fullmatch(r"LSTM predictor trained in [0-9.]+s \(\d+ KB\)",
                        out[0])
    ctl = RoboECC(get_config("cogact-7b"), ORIN, A100,
                  workload=Workload(s_new=17, decode_steps=0),
                  cloud_budget_bytes=12.0e9,
                  thresholds=Thresholds(high=1.5e6, low=-1.5e6))
    assert out[1] == (f"Alg.1: split {ctl.seg.split}/{len(ctl.graph)}, "
                      f"pool [{ctl.pool.start},{ctl.pool.end}) "
                      f"({ctl.pool.overhead_frac * 100:.2f}% overhead)")
    reqs = [line for line in out if line.startswith("  req ")]
    assert len(reqs) == 3 and all(l.endswith("action (1, 4, 7)")
                                  for l in reqs)
    cfg = get_config("cogact-7b").reduced()
    kb = codec_ref.wire_bytes((1, cfg.n_patches + 17, cfg.d_model)) / 1e3
    assert out[-2].endswith(f"cut payload {kb:.1f} KB (int8 codec)")


def test_train_lm_on_the_cpu_converges_and_survives_its_failure():
    """The twin of ``examples/train_lm.py`` at a CPU size: the loss falls
    below 0.7 of the first (the script's own assertion), and the failure
    injected at half-way is survived."""
    out = _run("train_lm_torch.py", "--device", "cpu", "--steps", "40",
               "--batch", "4", "--seq", "64", "--d-model", "128",
               timeout=240).splitlines()
    assert out[-1] == "OK"
    assert out[0] == "model: 16.8M params (8L d128)"
    assert "1 restart(s) survived" in out[-3]
