"""The port stands alone: no JAX, nothing of the JAX package, nothing built
or imported from the GPU toolchain at import time, and no quiet change of
implementation on a device it has no version for."""
import ast
import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_triton_or_a_build():
    """In a fresh interpreter: import every module of the package, then
    look at what came with it."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._LIB is None and _build.build_seconds is None\n"
        "assert not _build.build_dir().exists() or not any("
        "_build.build_dir().glob('.lib*'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('triton', 'jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_the_package_lists_every_module_of_the_slice():
    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for want in ("configs.base", "configs.openvla_7b", "configs.cogact_7b",
                 "configs.llama3_2_3b", "convert", "models.sharding",
                 "models.layers", "models.attention", "models.transformer",
                 "models.vla", "models.model", "runtime.partition",
                 "kernels._build", "kernels.activation_codec.ops",
                 "kernels.activation_codec.ref",
                 "kernels.flash_attention.ops", "kernels.flash_attention.ref"):
        assert f"repro_torch.{want}" in names
    from repro_torch.kernels import _build
    assert {p.name for p in _build.sources()} == {"activation_codec.cu",
                                                  "flash_attention.cu"}
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_wrappers_raise_on_a_device_they_have_no_version_for():
    from repro_torch.kernels.activation_codec import ops as codec
    from repro_torch.kernels.flash_attention import ops as fa
    x = torch.empty((2, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        codec.quantize(x)
    with pytest.raises(ValueError, match="meta"):
        codec.dequantize(torch.empty((2, 128), dtype=torch.int8,
                                     device="meta"),
                         torch.empty((2, 1), device="meta"))
    with pytest.raises(ValueError, match="meta"):
        codec.quantize_int4(torch.empty((2, 256), device="meta"))
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError):                   # mixed devices
        fa.flash_attention(torch.zeros(1, 4, 2, 16), q, q)
    assert codec.quantize.launches == 0 and fa.flash_attention.launches == 0


def test_a_block_the_kernels_do_not_take_raises_on_the_card(monkeypatch):
    """Blocks other than 128 columns run the plain version on a CPU tensor
    only: on a CUDA tensor the wrappers raise, and launch nothing."""
    from repro_torch.kernels.activation_codec import ops as codec
    x = torch.ones((2, 64))
    q, s = codec.quantize(x, block=64)                 # CPU: plain version
    assert q.shape == (2, 64) and s.shape == (2, 1)
    monkeypatch.setattr(codec, "_device_kind", lambda t: "cuda")
    n = (codec.quantize.launches, codec.dequantize.launches)
    with pytest.raises(NotImplementedError, match="64"):
        codec.quantize(x, block=64)
    with pytest.raises(NotImplementedError, match="64"):
        codec.dequantize(q, s, torch.float32, block=64)
    assert (codec.quantize.launches, codec.dequantize.launches) == n


def test_no_try_except_around_kernels_or_entry_points():
    """No fallback: the kernel wrappers, the build and the executor hold no
    ``try`` at all (the one in the config registry turns a KeyError into a
    readable one)."""
    for path in FILES:
        rel = str(path.relative_to(ROOT))
        tries = [n.lineno for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.Try)]
        if rel.endswith("configs/__init__.py"):
            continue
        if rel == "chip_smoke.py":
            assert len(tries) == 1, tries      # the check that a call raises
            continue
        assert not tries, f"{rel}: try at lines {tries}"


def test_missing_nvcc_raises_with_a_reason(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "b")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()
    assert _build._LIB is None
