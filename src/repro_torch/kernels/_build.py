"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

At first use every ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc``
process per source, all started together), the objects are linked into
one shared library with a plain C interface, and the library is loaded
with ``ctypes``.  The library lives in a ``build/`` directory at the root
of the checkout, keyed by a hash of the sources and flags, so a second
process finds it built.

No ``--use_fast_math``: the int8 and int4 codecs need IEEE division and
``rintf`` to stay bit-equal to their plain versions.

Importing this module builds nothing; :func:`lib` does.  A missing
``nvcc`` or a failed compile raises with the compiler's output — nothing
here falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# name -> argtypes; every entry returns the launch's cudaError_t as an int
# (negative: the arguments name a case the kernel does not take)
SIGNATURES: Dict[str, list] = {
    # x, q, scales, n_blocks, block (columns), dtype code, stream
    "rt_quantize_int8": [_P, _P, _P, _L, _I, _I, _P],
    # q, scales, out, n_blocks, block (columns), dtype code, stream
    "rt_dequantize_int8": [_P, _P, _P, _L, _I, _I, _P],
    # x, packed, scales, n_tiles (256 columns each), dtype code, stream
    "rt_quantize_int4": [_P, _P, _P, _L, _I, _P],
    # packed, scales, out, n_tiles, dtype code, stream
    "rt_dequantize_int4": [_P, _P, _P, _L, _I, _P],
    # q, k, v, o, B, S, T, H, KV, D, 4 x (batch, seq, head) strides,
    # scale, causal, dtype code, stream
    "rt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                           _F, _I, _I, _P],
    # q, k, v, o, split scratch (float32), tickets, B, H, KV, T, D, kv_len,
    # device kv_len or NULL, keys per split, n_split, q (batch, head),
    # k and v (batch, head, seq), o (batch, head) strides, scale, dtype code,
    # stream
    "rt_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                            _L, _F, _I, _P],
    # x, dt, A, Bm, Cm, y, state, the chunk-state, cumsum and C B^T
    # workspaces, B, T, H, P, N, chunk, n_chunks, x (batch, seq, head),
    # dt (batch, seq), Bm and Cm (batch, seq) strides, dtype code, stream
    "rt_ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _P],
}
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None    # None until lib() ran; 0.0 = cache hit
build_log: str = ""


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels of repro_torch cannot be built")


def _source_hash(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    global build_log
    nvcc = _find_nvcc()
    srcs = sources()
    tmp = out.parent / f".{out.stem}.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, cmd, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    so_tmp = tmp / out.name
    cmd = [nvcc, "-shared", "-o", str(so_tmp),
           *[str(obj) for _, obj, _, _ in procs]]
    link = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    build_log += f"\n$ {' '.join(cmd)}\n{link.stdout}"
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc could not link {out.name}:\n{build_log}")
    os.replace(so_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)
    (out.parent / (out.stem + ".log")).write_text(build_log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library; built on the first call."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = build_dir() / f"librepro_torch_kernels_{_source_hash(srcs)}.so"
    t0 = time.perf_counter()
    if out.is_file():
        build_seconds = 0.0
    else:
        out.parent.mkdir(parents=True, exist_ok=True)
        _compile(out)
        build_seconds = time.perf_counter() - t0
    handle = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = handle
    return _LIB


def check_launch(name: str, rc: int) -> None:
    """Raise if a C entry point reported that its launch was refused."""
    if rc == 0:
        return
    if rc < 0:
        raise ValueError(f"{name}: the kernel does not take these arguments "
                         f"(code {rc})")
    raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
