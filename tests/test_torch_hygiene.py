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


def test_the_import_rule_covers_the_control_plane_copies():
    """The numpy-only modules of ``core/`` are the port's own copies, and
    the controller reaches the predictor through them alone."""
    core = {p.name for p in FILES if p.parent == PKG / "core"}
    assert core >= {"__init__.py", "structure.py", "hardware.py", "codec.py",
                    "pipeline.py", "placement.py", "segmentation.py",
                    "pool.py", "network.py", "adjustment.py", "predictor.py",
                    "controller.py", "scene.py", "telemetry.py"}
    for name in core:
        rel = [n.module for n in ast.walk(ast.parse((PKG / "core" / name)
                                                     .read_text()))
               if isinstance(n, ast.ImportFrom) and n.level > 0]
        assert all(m is None or m.split(".")[0] in (
            "structure", "hardware", "codec", "pipeline", "placement",
            "segmentation", "pool", "network", "adjustment", "predictor",
            "controller", "configs", "scene", "telemetry") for m in rel), \
            (name, rel)


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
                 "models.moe", "models.vlm", "models.encdec",
                 "models.vla", "models.model", "runtime.partition",
                 "kernels._build", "kernels.activation_codec.ops",
                 "kernels.activation_codec.ref",
                 "kernels.flash_attention.ops", "kernels.flash_attention.ref",
                 "core", "core.structure", "core.hardware", "core.codec",
                 "core.pipeline", "core.placement", "core.segmentation",
                 "core.pool", "core.network", "core.adjustment",
                 "core.predictor", "core.controller",
                 "kernels.decode_attention.ops", "kernels.decode_attention.ref",
                 "runtime.kvcache", "runtime.serving", "runtime.scheduler",
                 "launch", "launch.serve", "models.ssm", "models.hybrid",
                 "kernels.ssd_scan.ops", "kernels.ssd_scan.ref",
                 "core.scene", "core.telemetry", "runtime.trace_export",
                 "runtime.fleet", "runtime.events",
                 "train", "train.optimizer", "train.train_loop",
                 "train.compression", "checkpoint", "checkpoint.ckpt",
                 "data", "data.pipeline", "runtime.fault", "launch.train",
                 "launch.mesh", "launch.ranks", "launch.host_group",
                 "launch.dryrun", "launch.comm_analysis", "launch.devices",
                 *(f"configs.{m}" for m in (
                     "command_r_35b", "deepseek_v2_lite_16b", "glm4_9b",
                     "granite_moe_3b_a800m", "llama_3_2_vision_11b",
                     "mamba2_1_3b", "phi3_mini_3_8b", "seamless_m4t_large_v2",
                     "zamba2_1_2b"))):
        assert f"repro_torch.{want}" in names
    from repro_torch.kernels import _build
    assert {p.name for p in _build.sources()} == {"activation_codec.cu",
                                                  "flash_attention.cu",
                                                  "decode_attention.cu",
                                                  "ssd_scan.cu"}
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {"common.cuh"}
    assert {"rt_quantize_int8", "rt_dequantize_int8", "rt_quantize_int4",
            "rt_dequantize_int4", "rt_flash_attention",
            "rt_flash_attention_occupancy", "rt_decode_attention",
            "rt_ssd_scan"} == set(_build.SIGNATURES)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for name in ("rt_flash_attention", "rt_flash_attention_occupancy"):
        assert f'extern "C" int {name}(' in src
    src = (_build.CSRC / "activation_codec.cu").read_text()
    for name in _build.SIGNATURES:
        if "quantize" in name:
            assert f'extern "C" int {name}(' in src
    src = (_build.CSRC / "decode_attention.cu").read_text()
    assert 'extern "C" int rt_decode_attention(' in src
    assert "decode_attention_pallas" in src
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    assert 'extern "C" int rt_ssd_scan(' in src
    assert "ssd_scan_pallas" in src
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
    from repro_torch.kernels.decode_attention import ops as da
    qd = torch.empty((1, 4, 16), device="meta")
    kd = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        da.decode_attention(qd, kd, kd, 3)
    with pytest.raises(ValueError):                   # mixed devices
        da.decode_attention(torch.zeros(1, 4, 16), kd, kd, 3)
    assert da.decode_attention.launches == 0
    from repro_torch.kernels.ssd_scan import ops as ssd
    xs = torch.empty((1, 8, 2, 16), device="meta")
    bs = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ssd.ssd_scan(xs, xs[..., 0], xs[0, 0, :, 0], bs, bs, chunk=8)
    assert ssd.ssd_scan.launches == 0


def test_a_block_the_kernels_do_not_take_raises_on_the_card(monkeypatch):
    """int8 takes any block width that divides the row: block 64 (the
    reduced ``d_model = 64``, one block a row) runs the plain version on a
    CPU tensor and reaches the C entries with its width on a card, while a
    block that does not divide the row raises there before any launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.activation_codec import ops as codec
    x = torch.ones((2, 64))
    q, s = codec.quantize(x, block=64)                 # CPU: plain version
    assert q.shape == (2, 64) and s.shape == (2, 1)
    fake = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(codec, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(codec, "_stream", lambda device: 0)
    monkeypatch.setattr(codec.quantize, "launches", 0)
    monkeypatch.setattr(codec.dequantize, "launches", 0)
    q2, s2 = codec.quantize(x, block=64)
    assert q2.shape == (2, 64) and s2.shape == (2, 1)
    codec.dequantize(q, s, torch.float32, block=64)
    (n1, a1), (n2, a2) = fake.calls
    assert n1 == "rt_quantize_int8" and a1[3:6] == (2, 64, 0)
    assert n2 == "rt_dequantize_int8" and a2[3:6] == (2, 64, 0)
    codec.quantize(torch.ones((3, 256), dtype=torch.bfloat16))
    assert fake.calls[-1][1][3:6] == (6, 128, 1)       # the 128-column path
    with pytest.raises(ValueError, match="multiple of 48"):
        codec.quantize(x, block=48)
    with pytest.raises(ValueError, match="belong together"):
        codec.dequantize(q, s, torch.float32, block=48)
    assert len(fake.calls) == 3
    assert (codec.quantize.launches, codec.dequantize.launches) == (2, 1)


def test_no_try_except_around_kernels_or_entry_points():
    """No fallback: the kernel wrappers, the build and the executor hold no
    ``try`` at all.  The config registry, the codec registry of the
    control plane (``core/codec.py::get_codec`` and its use in
    ``core/adjustment.py``) and the scene registry (``core/scene.py::
    scene_config``) each hold one, which turns a KeyError into a readable
    one; the event engine of the fleet simulator holds one ``try`` with
    only a ``finally``, which unhooks it from the simulator; the training
    supervisor (``runtime/fault.py``) holds one that catches only
    ``InjectedFailure``, the drill it restores a checkpoint for; the dry
    run (``launch/dryrun.py``) holds two, no kernel or entry point in
    either: ``main`` records a cell that raised as ``error`` (as the
    reference's ``main`` does) and ``_PeakBytes`` runs the step
    untracked where torch's private ``MemTracker`` does not run."""
    registries = ("configs/__init__.py", "core/codec.py", "core/adjustment.py",
                  "core/scene.py")
    for path in FILES:
        rel = str(path.relative_to(ROOT))
        tree = ast.parse(path.read_text())
        tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
        if rel.endswith("launch/dryrun.py"):
            owners = sorted(f.name for f in ast.walk(tree)
                            if isinstance(f, ast.FunctionDef)
                            and any(isinstance(n, ast.Try)
                                    for n in ast.walk(f)))
            assert len(tries) == 2 and owners == ["__call__", "main"], \
                (rel, owners)
            continue
        if rel.endswith("runtime/fault.py"):
            assert len(tries) == 1 and len(tries[0].handlers) == 1, rel
            assert ast.unparse(tries[0].handlers[0].type) == \
                "InjectedFailure", rel
            continue
        if rel.endswith("runtime/events.py"):
            assert len(tries) == 1 and not tries[0].handlers \
                and tries[0].finalbody, rel
            continue
        tries = [n.lineno for n in tries]
        if rel.endswith(registries):
            assert len(tries) == 1, (rel, tries)
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


class _FakeLib:
    """Stands in for the built library: records each C call and reports a
    launch that went through."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_int4_launches_its_kernel_on_a_cuda_tensor(monkeypatch):
    """On a CUDA tensor the int4 wrappers launch their kernels (they no
    longer raise ``NotImplementedError``) with the tile count and type the
    C entry expects, and count the launch; what the kernels do not take
    raises before any launch."""
    import contextlib
    from repro_torch.kernels import _build
    from repro_torch.kernels.activation_codec import ops as codec
    fake = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(codec, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(codec.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(codec, "_stream", lambda device: 0)
    monkeypatch.setattr(codec.quantize_int4, "launches", 0)
    monkeypatch.setattr(codec.dequantize_int4, "launches", 0)
    x = torch.ones((3, 5, 512), dtype=torch.bfloat16)
    p, s = codec.quantize_int4(x)
    assert p.shape == (3, 5, 256) and p.dtype == torch.int8
    assert s.shape == (3, 5, 4) and s.dtype == torch.float32
    out = codec.dequantize_int4(p, s, torch.float32)
    assert out.shape == (3, 5, 512) and out.dtype == torch.float32
    (n1, a1), (n2, a2) = fake.calls
    assert n1 == "rt_quantize_int4" and a1[3:5] == (30, 1)
    assert n2 == "rt_dequantize_int4" and a2[3:5] == (30, 0)
    assert codec.quantize_int4.launches == codec.dequantize_int4.launches == 1
    with pytest.raises(ValueError, match="2 \\* 128"):
        codec.quantize_int4(torch.ones((2, 384)))
    with pytest.raises(NotImplementedError, match="64"):
        codec.quantize_int4(torch.ones((2, 256)), block=64)
    with pytest.raises(TypeError):
        codec.quantize_int4(torch.ones((2, 256), dtype=torch.float16))
    with pytest.raises(ValueError, match="belong together"):
        codec.dequantize_int4(p, s[..., :2])
    with pytest.raises(TypeError):
        codec.dequantize_int4(p, s, torch.float16)
    assert len(fake.calls) == 2
    assert codec.quantize_int4.launches == codec.dequantize_int4.launches == 1


@pytest.fixture
def int4_card(monkeypatch):
    """The int4 wrappers on a stand-in card: the library is a ``_FakeLib``,
    every tensor counts as a CUDA tensor, the stream's handle is 77 and the
    launch counts start at 0."""
    import contextlib
    from repro_torch.kernels import _build
    from repro_torch.kernels.activation_codec import ops as codec
    fake = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(codec, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(codec.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(codec, "_stream", lambda device: 77)
    monkeypatch.setattr(codec.quantize_int4, "launches", 0)
    monkeypatch.setattr(codec.dequantize_int4, "launches", 0)
    return fake, codec


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1),
                                        (torch.float32, 0)],
                         ids=["bfloat16", "float32"])
def test_int4_passes_pointers_units_and_the_stream(int4_card, dtype, code):
    """Each int4 C entry gets the three tensors' pointers in its order, the
    tile count, the type's code and the current stream, in the number of
    arguments its signature declares."""
    from repro_torch.kernels import _build
    fake, codec = int4_card
    x = torch.zeros((2, 273, 1024), dtype=dtype)
    p, s = codec.quantize_int4(x)
    out = codec.dequantize_int4(p, s, dtype)
    (n1, a1), (n2, a2) = fake.calls
    assert n1 == "rt_quantize_int4" and n2 == "rt_dequantize_int4"
    assert len(a1) == len(_build.SIGNATURES[n1])
    assert len(a2) == len(_build.SIGNATURES[n2])
    assert a1 == (x.data_ptr(), p.data_ptr(), s.data_ptr(), 2 * 273 * 4,
                  code, 77)
    assert a2 == (p.data_ptr(), s.data_ptr(), out.data_ptr(), 2 * 273 * 4,
                  code, 77)
    assert codec.quantize_int4.launches == codec.dequantize_int4.launches == 1


def test_int4_copies_an_input_off_a_16_byte_boundary(int4_card):
    """The kernels read 8 or 16 bytes at a time: a view one element into its
    storage reaches the C entry as an aligned copy, a strided view as a
    contiguous one."""
    fake, codec = int4_card
    x = torch.zeros(2 * 256 + 1, dtype=torch.bfloat16)[1:].view(2, 256)
    codec.quantize_int4(x)
    assert x.data_ptr() % 16 != 0 and fake.calls[-1][1][0] % 16 == 0
    y = torch.zeros((512, 2), dtype=torch.bfloat16).t()
    codec.quantize_int4(y)
    b = fake.calls[-1][1][0]
    assert b != y.data_ptr() and b % 16 == 0
    assert codec.quantize_int4.launches == 2


def test_int4_launches_nothing_for_an_empty_input(int4_card):
    fake, codec = int4_card
    p, s = codec.quantize_int4(torch.zeros((0, 256)))
    assert p.shape == (0, 128) and s.shape == (0, 2)
    assert codec.dequantize_int4(p, s, torch.float32).shape == (0, 256)
    assert not fake.calls
    assert codec.quantize_int4.launches == codec.dequantize_int4.launches == 0


# what the int4 kernels do not take, beyond the refusals of
# test_int4_launches_its_kernel_on_a_cuda_tensor
INT4_REFUSED = {
    "int8 input": (TypeError, lambda c: c.quantize_int4(
        torch.zeros((2, 256), dtype=torch.int8))),
    "dequantize block 64": (NotImplementedError, lambda c: c.dequantize_int4(
        torch.zeros((2, 128), dtype=torch.int8), torch.ones((2, 2)),
        block=64)),
    "int32 payload": (TypeError, lambda c: c.dequantize_int4(
        torch.zeros((2, 128), dtype=torch.int32), torch.ones((2, 2)))),
    "float64 scales": (TypeError, lambda c: c.dequantize_int4(
        torch.zeros((2, 128), dtype=torch.int8),
        torch.ones((2, 2), dtype=torch.float64))),
    "scales of another row count": (ValueError, lambda c: c.dequantize_int4(
        torch.zeros((2, 128), dtype=torch.int8), torch.ones((3, 2)))),
    "payload width no multiple of 128": (ValueError,
                                         lambda c: c.dequantize_int4(
        torch.zeros((2, 192), dtype=torch.int8), torch.ones((2, 3)))),
    "scales on another device": (ValueError, lambda c: c.dequantize_int4(
        torch.zeros((2, 128), dtype=torch.int8),
        torch.ones((2, 2), device="meta"))),
}


@pytest.mark.parametrize("case", sorted(INT4_REFUSED))
def test_int4_refuses_before_a_launch(int4_card, case):
    fake, codec = int4_card
    exc, call = INT4_REFUSED[case]
    with pytest.raises(exc):
        call(codec)
    assert not fake.calls
    assert codec.quantize_int4.launches == codec.dequantize_int4.launches == 0


def test_decode_attention_launches_its_kernel_on_a_cuda_tensor(monkeypatch):
    """On a CUDA tensor the flash-decode wrapper makes one C call per call,
    reading the model's flat cache in place through its strides, with the
    split plan of the buffer length, ``kv_len`` as an int and the splits'
    scratch allocated once per card (the same pointers call after call, the
    tickets zero), and counts the launch; what the kernel does not take
    raises before any launch."""
    import contextlib
    import types
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da
    fake = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(da, "_device_kind", lambda ts: "cuda")
    monkeypatch.setattr(da.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(da.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(da.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(da.decode_attention, "launches", 0)
    monkeypatch.setattr(da, "_SCRATCH", {})
    asked = []
    monkeypatch.setattr(da, "sm_count",
                        lambda d: asked.append(d) or 132)   # an H100 SXM
    B, S_max, H, KV, hd = 1, 576, 24, 8, 128      # llama3.2-3b, served
    cache = torch.zeros((2, B, S_max, KV * hd), dtype=torch.bfloat16)
    kc = cache[1]                                  # layer 1 of the stack
    k4 = kc.view(B, S_max, KV, hd).permute(0, 2, 1, 3)
    q = torch.ones((B, 1, H, hd), dtype=torch.bfloat16)
    out = da.decode_attention(q, k4, k4, 513)
    assert out.shape == (B, 1, H, hd) and out.dtype == torch.bfloat16
    ((name, a),) = fake.calls
    assert name == "rt_decode_attention"
    assert a[1] == a[2] == kc.data_ptr()           # no copy of the cache
    part, ticket = da._SCRATCH[q.device]
    assert a[4:6] == (part.data_ptr(), ticket.data_ptr())
    assert part.dtype == torch.float32 and part.numel() == B * H * 9 * (hd + 2)
    assert ticket.dtype == torch.int32 and ticket.numel() == B * KV
    assert not ticket.any()
    assert a[6:12] == (B, H, KV, S_max, hd, 513)
    assert a[12] is None and a[13:15] == (64, 9)
    assert asked == [q.device]                     # the SMs of q's card
    assert a[15:17] == (H * hd, hd)                            # q
    assert a[17:20] == a[20:23] == (S_max * KV * hd, hd, KV * hd)  # k, v
    assert a[23:25] == (H * hd, hd)                            # out
    assert a[25] == hd ** -0.5 and a[26] == 1
    assert da.decode_attention.launches == 1
    da.decode_attention(q, k4, k4, 100)            # the same scratch again
    assert fake.calls[1][1][4:6] == a[4:6]
    assert da.decode_attention.launches == 2
    with pytest.raises(ValueError, match="head dim"):
        da.decode_attention(q[..., :48], k4[..., :48], k4[..., :48], 5)
    with pytest.raises(TypeError):
        da.decode_attention(q.half(), k4.half(), k4.half(), 5)
    with pytest.raises(ValueError, match="belong together"):
        da.decode_attention(q[:, :, :7], k4, k4, 5)
    with pytest.raises(ValueError, match="empty cache"):
        da.decode_attention(q, k4, k4, 0)
    with pytest.raises(ValueError, match="up to 16"):   # a 24x group in bf16
        da.decode_attention(q, k4[:, :1], k4[:, :1], 5)
    assert len(fake.calls) == 2 and da.decode_attention.launches == 2


def test_flash_attention_launches_its_kernel_on_a_cuda_tensor(monkeypatch):
    """On a CUDA tensor the flash-attention wrapper makes one C call with
    the model's (B, S, H, D) / (B, T, KV, D) strides, the scale, the causal
    flag and the type code, enters no device context when q is on the
    current card, and counts the launch."""
    import types
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    fake = _FakeLib()
    entered = []
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(fa.torch.cuda, "device",
                        lambda d: entered.append(d))
    monkeypatch.setattr(fa.torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    monkeypatch.setattr(fa, "_device_kind", lambda ts, name: "cuda")
    B, S, H, KV, hd = 4, 17, 24, 8, 128           # serve_lm's blocks
    q = torch.ones((B, S, H, hd), dtype=torch.bfloat16)
    k = torch.ones((B, S, KV, hd), dtype=torch.bfloat16)
    out = fa.flash_attention(q, k, k, causal=True)   # q.device.index: None
    assert out.shape == (B, S, H, hd) and out.dtype == torch.bfloat16
    ((name, a),) = fake.calls
    assert name == "rt_flash_attention"
    assert a[4:11] == (B, S, S, H, KV, hd, hd)
    assert a[11:14] == (S * H * hd, H * hd, hd)                 # q
    assert a[14:17] == a[17:20] == (S * KV * hd, KV * hd, hd)   # k, v
    assert a[20:23] == (S * H * hd, H * hd, hd)                 # out
    assert a[23] == hd ** -0.5 and a[24:] == (1, 1, 7)
    assert entered == [] and fa.flash_attention.launches == 1
