#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Drives the port's main paths at full width and depth with random weights
made from a seed — OpenVLA-7B and CogACT-7B action requests served by split
co-inference (``repro_torch.runtime.partition.VLASplitExecutor``), and the
paper's closed loop (``repro_torch.core.RoboECC``) choosing the cut and the
codec of every CogACT request — and holds every hand-written kernel on those
paths against its plain PyTorch version on the card.  Needs one card,
``nvcc`` and no network; the kernels are built from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use.  Any phase
that fails raises, and the process then exits non-zero.

Phases, one JSON line each:

  env           torch / CUDA versions, the card's name and power limit
  build         seconds the kernels took to build
  kernels       each kernel against its plain version at the main paths'
                shapes and at awkward ones, with times
  serve         8 OpenVLA-7B int8 requests with the cut walking the pool,
                one two-pool request, and the checks on what came out
  serve_cogact  8 CogACT-7B packed-int4 requests walking the pool that
                Alg. 1 places, one two-pool request with an int4 downlink,
                the checks on what came out, stage times and profiles
  control       the LSTM trained on the card, then 60 ticks of the closed
                loop, each request served at the tick's cut and codec:
                codec and split mix, forecast time against request wall,
                planner-priced against shipped bytes

then the card's name and power limit as ``nvidia-smi`` prints them, a
``{"kernels": [...]}`` summary of every kernel (launch count on the main
paths, error, time, plain version's time, the card's bound, the library
call's time) and, last, ``{"ok": true, "device": {...}}``.

``--llm-layers`` / ``--vit-layers`` cut the depth of the served models, for
finding faults (the controller still plans the published CogACT-7B); with
no arguments everything runs in full.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.activation_codec import ops as codec_ops
from repro_torch.kernels.activation_codec import ref as codec_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import build
from repro_torch.models.layers import rmsnorm
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.models.vla import vla_backbone
from repro_torch.runtime.partition import (SplitPlan, VLASplitExecutor,
                                           decode_activation,
                                           encode_activation, payload_bytes)

# NVIDIA H100 SXM data-sheet peaks (dense), used for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEED = 0
DEV = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


_BLOCKER = []


def _hold_the_card() -> None:
    """Queue about two milliseconds of other work, so that what is queued
    next starts only when the host has long finished queueing it."""
    if not _BLOCKER:
        _BLOCKER.append(torch.randn((8192, 8192), device=DEV,
                                    dtype=torch.bfloat16))
    a = _BLOCKER[0]
    torch.matmul(a, a)
    torch.matmul(a, a)


def time_ms(fn, warmup: int = 5, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call: median over ``reps`` of the CUDA-event time
    of ``inner`` calls queued behind other work, per call.  A call here
    takes a few microseconds on the card and tens on the host, so without
    the work in front the events would time the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        _hold_the_card()
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def host_ms(fn, calls: int = 200) -> float:
    """Host time to issue one call (nothing waits for the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ===================================================================== env
def phase_env() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device and found none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    info = {"phase": "env", "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "nvidia_smi": smi[0],
            "host_cores": len(os.sched_getaffinity(0)),
            "host_load_avg_1m": os.getloadavg()[0],
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(info)
    return info


# =================================================================== build
def phase_build() -> None:
    _build.lib()
    log = _build.build_log.splitlines()
    spills = [ln for ln in log
              if "bytes spill" in ln and " 0 bytes spill stores" not in ln]
    nvcc = subprocess.run([_build._find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    emit({"phase": "build", "seconds": _build.build_seconds,
          "nvcc": next((ln.strip() for ln in nvcc.splitlines()
                        if "release" in ln), nvcc.strip()),
          "sources": [p.name for p in _build.sources()],
          "flags": " ".join(_build.NVCC_FLAGS),
          "kernels_compiled": sum("Compiling entry function" in ln
                                  for ln in log),
          "kernels_with_spills": len(spills)})


# ================================================================= kernels
def _codec_input(shape, dtype, seed):
    x = torch.randn(shape, generator=gen(seed), device=DEV,
                    dtype=torch.float32) * 3.0
    x.reshape(-1, shape[-1])[0, :128] = 0.0        # one all-zero block
    return x.to(dtype)


def check_codec(shape, dtype, seed) -> dict:
    x = _codec_input(shape, dtype, seed)
    q_k, s_k = codec_ops.quantize(x)
    q_p, s_p = codec_ops.quantize_plain(x)
    torch.cuda.synchronize()
    if q_k.dtype != torch.int8 or q_k.shape != x.shape \
            or s_k.shape != (*x.shape[:-1], x.shape[-1] // 128):
        raise AssertionError(f"quantize {shape}: wrong output {q_k.shape} "
                             f"{q_k.dtype} {s_k.shape}")
    q_err = (q_k.int() - q_p.int()).abs().max().item()
    s_err = (s_k - s_p).abs().max().item()
    if not (torch.equal(q_k, q_p) and torch.equal(s_k, s_p)):
        raise AssertionError(f"quantize_int8 {shape} {dtype}: kernel and "
                             f"plain version differ (payload by {q_err}, "
                             f"scales by {s_err}); they are held bit-equal")
    d_k = codec_ops.dequantize(q_k, s_k, dtype)
    d_p = codec_ops.dequantize_plain(q_k, s_k, dtype)
    torch.cuda.synchronize()
    d_err = (d_k.float() - d_p.float()).abs().max().item()
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"dequantize_int8 {shape} {dtype}: kernel and "
                             f"plain version differ by {d_err}; they are "
                             "held bit-equal")
    return {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "quantize_max_err": max(q_err, s_err), "dequantize_max_err": d_err}


def _codec4_input(shape, dtype, seed, case):
    """Inputs for the packed-int4 codec.  ``zero_lo`` / ``zero_hi``: one
    all-zero 128-block beside a non-zero one in the same 256-column tile.
    ``ties``: every block holds 7.0 once, so its scale is 7 * (1/7) = 1.0
    exactly, and the rest of it lies on the half-integers -6.5 ... 6.5, so
    that every x / s is an exact .5 tie for the half-to-even rounding."""
    x = torch.randn(shape, generator=gen(seed), device=DEV,
                    dtype=torch.float32) * 3.0
    rows = x.reshape(-1, shape[-1])
    if case == "zero_lo":
        rows[0, :128] = 0.0
    elif case == "zero_hi":
        rows[0, 128:256] = 0.0
    elif case == "ties":
        k = torch.randint(-7, 7, rows.shape, generator=gen(seed + 1),
                          device=DEV).float() + 0.5
        k[:, ::128] = 7.0
        rows.copy_(k)
    return x.to(dtype)


def check_codec4(shape, dtype, seed, case="zero_lo") -> dict:
    x = _codec4_input(shape, dtype, seed, case)
    if case == "ties":
        s_ones = codec_ops.quantize_int4_plain(x)[1]
        if not torch.equal(s_ones, torch.ones_like(s_ones)):
            raise AssertionError("int4 ties input: scales are not all 1.0")
    p_k, s_k = codec_ops.quantize_int4(x)
    p_p, s_p = codec_ops.quantize_int4_plain(x)
    torch.cuda.synchronize()
    D = x.shape[-1]
    if p_k.dtype != torch.int8 or p_k.shape != (*x.shape[:-1], D // 2) \
            or s_k.shape != (*x.shape[:-1], D // 128):
        raise AssertionError(f"quantize_int4 {shape}: wrong output "
                             f"{p_k.shape} {p_k.dtype} {s_k.shape}")
    p_err = (p_k.int() - p_p.int()).abs().max().item()
    s_err = (s_k - s_p).abs().max().item()
    if not (torch.equal(p_k, p_p) and torch.equal(s_k, s_p)):
        raise AssertionError(f"quantize_int4 {shape} {dtype} {case}: kernel "
                             f"and plain version differ (payload by {p_err}, "
                             f"scales by {s_err}); they are held bit-equal")
    if p_k.min().item() < -128 or p_k.max().item() > 110:
        raise AssertionError("quantize_int4: a packed byte outside [-128, 110]")
    d_k = codec_ops.dequantize_int4(p_k, s_k, dtype)
    d_p = codec_ops.dequantize_int4_plain(p_k, s_k, dtype)
    torch.cuda.synchronize()
    d_err = (d_k.float() - d_p.float()).abs().max().item()
    if not torch.equal(d_k, d_p):
        raise AssertionError(f"dequantize_int4 {shape} {dtype} {case}: kernel "
                             f"and plain version differ by {d_err}; they are "
                             "held bit-equal")
    return {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "case": case, "quantize_max_err": max(p_err, s_err),
            "dequantize_max_err": d_err}


def _attn_inputs(B, S, T, H, KV, D, dtype, seed, strided=False):
    g = gen(seed)
    if strided:      # q, k, v as views into one fused projection output
        assert S == T and H == KV
        qkv = torch.randn((B, S, 3, H, D), generator=g, device=DEV,
                          dtype=torch.float32).to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = torch.randn((B, S, H, D), generator=g, device=DEV,
                    dtype=torch.float32).to(dtype)
    k = torch.randn((B, T, KV, D), generator=g, device=DEV,
                    dtype=torch.float32).to(dtype)
    v = torch.randn((B, T, KV, D), generator=g, device=DEV,
                    dtype=torch.float32).to(dtype)
    return q, k, v


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def check_attn(B, S, T, H, KV, D, dtype, causal, seed, strided=False) -> dict:
    q, k, v = _attn_inputs(B, S, T, H, KV, D, dtype, seed, strided)
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    ref = fa_ops.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != dtype:
        raise AssertionError(f"flash_attention: wrong output {out.shape} "
                             f"{out.dtype}")
    if not torch.isfinite(out.float()).all():
        raise AssertionError("flash_attention: output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    case = {"B": B, "S": S, "T": T, "H": H, "KV": KV, "D": D,
            "dtype": str(dtype).split(".")[-1], "causal": causal,
            "strided": strided, "max_err": err, "tol": ATTN_TOL[dtype]}
    if err > ATTN_TOL[dtype]:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {case}")
    return case


def phase_kernels(cfg) -> dict:
    """Every kernel against its plain version, then times at the main
    path's shapes.  Returns the per-kernel records for the summary line."""
    S_main = cfg.n_patches + 17
    d, H, KV, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    bf, f32 = torch.bfloat16, torch.float32

    codec_cases = [
        check_codec((1, S_main, d), bf, 1),           # uplink, main path
        check_codec((1, cfg.action_dim, d), bf, 2),   # two-pool downlink
        check_codec((1, S_main, d), f32, 3),
        check_codec((1, d), bf, 4),                   # one row
        check_codec((5, 128), f32, 5),                # D = one block
        check_codec((5, 128), bf, 6),
        check_codec((2, 17, 256), bf, 7),
    ]
    codec4_cases = [
        check_codec4((1, S_main, d), bf, 40),         # uplink, main path
        check_codec4((1, S_main, d), f32, 41),
        check_codec4((1, 1, d), bf, 42),              # two-pool downlink
        check_codec4((1, d), f32, 43),                # one row
        check_codec4((5, 256), bf, 44),               # D = one tile
        check_codec4((5, 256), f32, 45),
        check_codec4((3, 512), bf, 46, "zero_hi"),
        check_codec4((1, S_main, d), bf, 47, "ties"),
        check_codec4((4, 512), f32, 48, "ties"),
    ]
    attn_cases = [
        check_attn(1, S_main, S_main, H, KV, hd, bf, True, 10),   # main path
        check_attn(1, S_main, S_main, H, KV, hd, f32, True, 11),
        check_attn(1, S_main, S_main, H, KV, hd, bf, True, 12, strided=True),
        check_attn(2, 200, 200, 8, 2, 64, bf, True, 13),          # GQA 4x
        check_attn(2, 200, 200, 8, 2, 64, f32, True, 14),
        check_attn(1, 100, 333, 4, 4, 32, f32, False, 15),        # S != T
        check_attn(1, 100, 333, 4, 2, 32, bf, False, 16),
        check_attn(1, 384, 384, 8, 2, 32, f32, True, 17),
        check_attn(1, 130, 130, 2, 1, 64, f32, True, 18),
        check_attn(1, 130, 130, 2, 2, 128, bf, False, 19),
    ]
    for i, S in enumerate((1, 2, 17, 63, 64, 65)):                # ragged
        attn_cases.append(check_attn(2, S, S, 2, 2, 16, f32, True, 20 + i))
        attn_cases.append(check_attn(2, S, S, 2, 1, 64, bf, False, 30 + i))

    # ---- times at the main path's shapes
    x = _codec_input((1, S_main, d), bf, 1)
    q8, s8 = codec_ops.quantize(x)
    n = x.numel()
    rec = {}
    b_ms, b_by = bound(n * 2 + n + n // 128 * 4, 6 * n, f32)
    rec["quantize_int8"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/activation_codec.cu",
        "replaces": "src/repro/kernels/activation_codec/kernel.py:48",
        "shape": [1, S_main, d], "dtype": "bfloat16",
        "max_abs_err": max(c["quantize_max_err"] for c in codec_cases),
        "ms": time_ms(lambda: codec_ops.quantize(x)),
        "host_ms": host_ms(lambda: codec_ops.quantize(x)),
        "plain_ms": time_ms(lambda: codec_ops.quantize_plain(x)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    b_ms, b_by = bound(n + n // 128 * 4 + n * 2, 2 * n, f32)
    rec["dequantize_int8"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/activation_codec.cu",
        "replaces": "src/repro/kernels/activation_codec/kernel.py:71",
        "shape": [1, S_main, d], "dtype": "bfloat16",
        "max_abs_err": max(c["dequantize_max_err"] for c in codec_cases),
        "ms": time_ms(lambda: codec_ops.dequantize(q8, s8, bf)),
        "host_ms": host_ms(lambda: codec_ops.dequantize(q8, s8, bf)),
        "plain_ms": time_ms(lambda: codec_ops.dequantize_plain(q8, s8, bf)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    p4, s4 = codec_ops.quantize_int4(x)
    b_ms, b_by = bound(n * 2 + n // 2 + n // 128 * 4, 6 * n, f32)
    rec["quantize_int4"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/activation_codec.cu",
        "replaces": "src/repro/kernels/activation_codec/kernel.py:113",
        "shape": [1, S_main, d], "dtype": "bfloat16",
        "max_abs_err": max(c["quantize_max_err"] for c in codec4_cases),
        "ms": time_ms(lambda: codec_ops.quantize_int4(x)),
        "host_ms": host_ms(lambda: codec_ops.quantize_int4(x)),
        "plain_ms": time_ms(lambda: codec_ops.quantize_int4_plain(x)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    b_ms, b_by = bound(n // 2 + n // 128 * 4 + n * 2, 4 * n, f32)
    rec["dequantize_int4"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/activation_codec.cu",
        "replaces": "src/repro/kernels/activation_codec/kernel.py:137",
        "shape": [1, S_main, d], "dtype": "bfloat16",
        "max_abs_err": max(c["dequantize_max_err"] for c in codec4_cases),
        "ms": time_ms(lambda: codec_ops.dequantize_int4(p4, s4, bf)),
        "host_ms": host_ms(lambda: codec_ops.dequantize_int4(p4, s4, bf)),
        "plain_ms": time_ms(
            lambda: codec_ops.dequantize_int4_plain(p4, s4, bf)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    q, k, v = _attn_inputs(1, S_main, S_main, H, KV, hd, bf, 10)
    # causal: S(S+1)/2 (query, key) pairs, 2 products of D multiply-adds each
    flops = 4.0 * H * hd * S_main * (S_main + 1) / 2
    nbytes = 2 * (2 * H + 2 * KV) * S_main * hd
    b_ms, b_by = bound(nbytes, flops, bf)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # (B,H,S,D) views
    rec["flash_attention"] = {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
        "shape": [1, S_main, H, hd], "dtype": "bfloat16", "causal": True,
        "max_abs_err": attn_cases[0]["max_err"],
        "ms": time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True)),
        "host_ms": host_ms(
            lambda: fa_ops.flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(
            lambda: fa_ops.flash_attention_plain(q, k, v, causal=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        # yardstick only: the port calls this nowhere
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))}
    emit({"phase": "kernels",
          "tolerances": {"quantize_int8": "bit-equal",
                         "dequantize_int8": "bit-equal",
                         "quantize_int4": "bit-equal",
                         "dequantize_int4": "bit-equal",
                         "flash_attention": {"float32": 2e-5,
                                             "bfloat16": 2e-2}},
          "timing": "device time: CUDA events, median of 20 x 10 calls "
                    "queued behind other work; host_ms: time to issue a call",
          "codec_cases": codec_cases, "codec4_cases": codec4_cases,
          "attention_cases": attn_cases,
          "at_main_shapes": rec})
    return rec


# =================================================================== serve
WRAPPERS = {"quantize_int8": codec_ops.quantize,
            "dequantize_int8": codec_ops.dequantize,
            "quantize_int4": codec_ops.quantize_int4,
            "dequantize_int4": codec_ops.dequantize_int4,
            "flash_attention": fa_ops.flash_attention}


def _counts() -> dict:
    return {k: w.launches for k, w in WRAPPERS.items()}


def _reset_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def _want(n_llm: int, codec: str = "", codec2: str = "") -> dict:
    """Launches one request makes: one flash attention per LLM block, one
    quantise and one dequantise per leg that ships through a codec."""
    want = dict.fromkeys(WRAPPERS, 0)
    want["flash_attention"] = n_llm
    for c in (codec, codec2):
        if c:
            want[f"quantize_{c}"] += 1
            want[f"dequantize_{c}"] += 1
    return want


def _check_action(cfg, action) -> None:
    if tuple(action.shape) != (1, cfg.action_horizon, cfg.action_dim):
        raise AssertionError(f"action shape {tuple(action.shape)}")
    if not torch.isfinite(action).all():
        raise AssertionError("action is not finite")
    if cfg.vla_action_head != "dit" and (action.min().item() < -1.0
                                         or action.max().item() > 1.0):
        raise AssertionError("detokenised action outside [-1, 1]")


def _wall_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _must_raise(exc, fn) -> None:
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"expected {exc.__name__} on a CUDA tensor")


def small_reference_check() -> dict:
    """Reduced models in float32: the card's kernels against the plain
    versions on the CPU, same weights and inputs."""
    out = {}
    for name, tol in (("openvla-7b", 2e-4), ("cogact-7b", 1e-4)):
        cfg = get_config(name).reduced().replace(n_layers=4, dtype="float32")
        model = build(cfg)
        params = model.init(gen(SEED + 1), DEV)
        for t in tree_leaves(params):      # the DiT's zero-initialised leaves
            if not t.any():                # would hide the layers behind them
                t.normal_(0.0, 0.02, generator=gen(SEED + 2))
        params_cpu = tree_map(lambda t: t.cpu(), params)
        g = gen(SEED + 3)
        patches = torch.randn((2, cfg.n_patches, cfg.vit_dim), generator=g,
                              device=DEV)
        tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=g,
                               device=DEV)
        noise = torch.randn((2, cfg.action_horizon, cfg.action_dim),
                            generator=g, device=DEV)
        Lv = cfg.vit_layers
        h_card = vla_backbone(cfg, params, patches, tokens)
        h_cpu = vla_backbone(cfg, params_cpu, patches.cpu(), tokens.cpu())
        h_err = (h_card.cpu() - h_cpu).abs().max().item()
        if h_err > 2e-4:
            raise AssertionError(f"{name} reduced: hidden state on the card "
                                 f"is {h_err} from the CPU's (limit 2e-4)")
        ex = VLASplitExecutor(cfg, SplitPlan(Lv + 1, Lv + 3))
        ex_cpu = VLASplitExecutor(cfg, SplitPlan(Lv + 1, Lv + 3), device="cpu")
        a_card, _ = ex.run(params, patches, tokens, Lv + 2, noise)
        a_cpu, _ = ex_cpu.run(params_cpu, patches.cpu(), tokens.cpu(),
                              Lv + 2, noise.cpu())
        a_err = (a_card.cpu() - a_cpu).abs().max().item()
        # detok picks a bin by argmax: equal bins, or neighbours on a near-tie
        a_tol = tol if cfg.vla_action_head == "dit" else 1.0 / 127.5 + 1e-6
        if a_err > a_tol:
            raise AssertionError(f"{name} reduced: action on the card is "
                                 f"{a_err} from the CPU's (limit {a_tol})")
        out[name] = {"hidden_max_err": h_err, "action_max_err": a_err}
    return out


def profile_request(fn) -> dict:
    """Device time of one request by kernel, from ``torch.profiler``.  Says
    "not measured" when the trace holds no device time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, float(e.self_device_time_total), int(e.count))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        return {"device_busy_ms": "not measured"}
    rows.sort(key=lambda r: -r[1])
    groups = {}
    for key, us, count in rows:
        low = key.lower()
        ours = re.search(r"(flash_attention_\w+|\w*quantize_int[48])_kernel",
                         key)
        if ours:
            name = "hand-written: " + ours.group(1)
        elif any(w in low for w in ("nvjet", "gemm", "gemv", "cutlass",
                                    "cublas", "xmma")):
            name = "matrix products (library)"
        elif "reduce_kernel" in low or "softmax" in low:
            name = "reductions and softmax"
        elif "copy" in low or "cat" in low or "index" in low:
            name = "copies, casts, cat, gather"
        elif "elementwise" in low or "vectorized" in low:
            name = "elementwise"
        else:
            name = "other"
        grp = groups.setdefault(name, {"device_ms": 0.0, "launches": 0})
        grp["device_ms"] += us / 1e3
        grp["launches"] += count
    return {"device_busy_ms": busy_us / 1e3,
            "n_kernel_launches": sum(r[2] for r in rows),
            "by_group": groups,
            "top": [{"kernel": k[:80], "device_ms": us / 1e3, "calls": c}
                    for k, us, c in rows[:8]]}


def phase_serve(cfg, n_requests: int = 8) -> dict:
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(gen(SEED), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))

    Lv, L = cfg.vit_layers, cfg.n_layers
    lo, hi = Lv + min(14, L - 1), Lv + min(18, L)
    plan = SplitPlan(lo, hi, codec="int8")
    ex = VLASplitExecutor(cfg, plan)
    S = cfg.n_patches + 17
    g = gen(SEED + 7)

    def request():
        patches = torch.randn((1, cfg.n_patches, cfg.vit_dim), generator=g,
                              device=DEV)
        tokens = torch.randint(0, cfg.vocab_size, (1, 17), generator=g,
                               device=DEV)
        return patches, tokens

    cuts = [lo + i % (hi - lo + 1) for i in range(n_requests)]
    for _ in range(2):                                   # warm-up
        ex.run(params, *request(), cuts[0])
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after
    requests = [request() for _ in range(n_requests)]
    walls = []
    _reset_counts()
    for (patches, tokens), cut in zip(requests, cuts):
        before = _counts()
        ms, (action, payload) = _wall_ms(
            lambda: ex.run(params, patches, tokens, cut))
        walls.append(ms)
        moved = _moved(before)
        want = _want(L, "int8")
        if moved != want:
            raise AssertionError(f"launch counts moved by {moved} in one "
                                 f"request, expected {want}")
        _check_action(cfg, action)
        want_bytes = codec_ref.wire_bytes((1, S, cfg.d_model))
        if payload_bytes(payload) != want_bytes \
                or want_bytes != S * cfg.d_model + S * (cfg.d_model // 128) * 4:
            raise AssertionError(f"payload {payload_bytes(payload)} bytes, "
                                 f"expected {want_bytes}")
    launches = _counts()

    # ---- streamed == run, bit for bit, at the same cut
    patches, tokens = requests[0]
    cut = cuts[2 % len(cuts)]
    a_run, _ = ex.run(params, patches, tokens, cut)
    a_str, chunks = ex.run_streamed(params, patches, tokens, cut, n_chunks=4)
    if len(chunks) != 4 or not torch.equal(a_run, a_str):
        raise AssertionError("run_streamed(n_chunks=4) differs from run")

    # ---- codec off: the executor's final hidden state equals the monolithic
    # backbone's at every cut.  Same kernels on the same inputs in the same
    # order, so the limit is exact equality.
    ex_raw = VLASplitExecutor(cfg, SplitPlan(lo, hi))
    h_ref = vla_backbone(cfg, params, patches, tokens)
    if not torch.isfinite(h_ref.float()).all():
        raise AssertionError("backbone hidden state is not finite")
    raw_err = 0.0
    for c in range(lo, hi + 1):
        x = ex_raw._cloud_hidden(
            params, ex_raw._edge_hidden(params, patches, tokens, c), c)
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        raw_err = max(raw_err, (h.float() - h_ref.float()).abs().max().item())
    if raw_err != 0.0:
        raise AssertionError(f"codec off: split hidden state is {raw_err} "
                             "from the monolithic one; expected equality")
    # ---- codec on: the cut tensor comes back within half a quantisation step
    x_cut = ex._edge_hidden(params, patches, tokens, cut)
    pay = encode_activation(x_cut, "int8")
    back = decode_activation(pay, cfg.dtype)
    step = pay["s"].repeat_interleave(128, dim=-1)
    # half a step of the int8 grid plus one rounding of the result to bf16
    lim = 0.5 * step + back.float().abs() * 2.0 ** -8 + 1e-12
    over = ((back.float() - x_cut.float()).abs() - lim).max().item()
    if over > 0:
        raise AssertionError(f"int8 round trip exceeds half a step by {over}")

    # ---- one two-pool request: the downlink ships the 7 action positions
    end = Lv + L
    ex2 = VLASplitExecutor(cfg, SplitPlan(lo, hi, codec="int8",
                                          pool2_start=end, pool2_end=end,
                                          codec2="int8"))
    before = _counts()
    ms2, (a2, pay2) = _wall_ms(
        lambda: ex2.run(params, patches, tokens, cut))
    moved2 = _moved(before)
    _check_action(cfg, a2)
    if tuple(pay2["down"]["q"].shape) != (1, cfg.action_dim, cfg.d_model):
        raise AssertionError(f"downlink {tuple(pay2['down']['q'].shape)}")
    if moved2 != _want(L, "int8", "int8"):
        raise AssertionError(f"two-pool launch counts {moved2}")
    if payload_bytes(pay2["down"]) != codec_ref.wire_bytes(
            (1, cfg.action_dim, cfg.d_model)):
        raise AssertionError("downlink payload bytes")

    # ---- what the card has no kernel for raises, and launches nothing:
    # int4 at a width that is no multiple of 256, an int8 block other than
    # 128 columns (what a width such as 64 asks for), an unbuilt head dim
    before = _counts()
    _must_raise(ValueError,
                lambda: encode_activation(x_cut[..., :384], "int4"))
    _must_raise(ValueError,
                lambda: codec_ops.quantize_int4(x_cut[..., :384]))
    _must_raise(NotImplementedError,
                lambda: encode_activation(x_cut[..., :64], "int8"))
    _must_raise(NotImplementedError,
                lambda: codec_ops.dequantize(pay["q"][..., :64],
                                             pay["s"][..., :1], block=64))
    q48 = torch.zeros((1, 8, 2, 48), device=DEV, dtype=torch.bfloat16)
    _must_raise(ValueError,
                lambda: fa_ops.flash_attention(q48, q48, q48, causal=True))
    if _counts() != before:
        raise AssertionError("a call that raised also launched a kernel")

    # ---- where a request's time goes: the four stages, each synchronised
    stages = {"edge": [], "encode": [], "decode": [], "cloud": []}
    for _ in range(8):
        ms, x = _wall_ms(lambda: ex._edge_hidden(params, patches, tokens, cut))
        stages["edge"].append(ms)
        ms, p = _wall_ms(lambda: encode_activation(x, "int8"))
        stages["encode"].append(ms)
        ms, y = _wall_ms(lambda: decode_activation(p, cfg.dtype))
        stages["decode"].append(ms)
        ms, _ = _wall_ms(lambda: ex._action_decode(
            params, ex._cloud_hidden(params, y, cut), None))
        stages["cloud"].append(ms)

    peak = torch.cuda.max_memory_allocated()
    prof = profile_request(lambda: ex.run(params, patches, tokens, cut))
    small = small_reference_check()
    info = {"phase": "serve", "model": cfg.name, "n_params": n_params,
            "vit_layers": Lv, "llm_layers": L, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "seq": S, "init_s": init_s,
            "pool": [lo, hi], "cuts": cuts,
            "request_wall_ms": walls,
            "request_wall_ms_median": statistics.median(walls),
            "stage_wall_ms_median": {k: statistics.median(v)
                                     for k, v in stages.items()},
            "two_pool_request_wall_ms": ms2,
            "profile_one_request": prof,
            "payload_bytes": payload_bytes(payload),
            "downlink_payload_bytes": payload_bytes(pay2["down"]),
            "launches": launches,
            "codec_off_hidden_max_err": raw_err,
            "streamed_equals_run": True,
            "small_reference": small,
            "peak_memory_bytes": peak}
    emit(info)
    return info


# ============================================================ serve_cogact
WIRE = {None: "", "identity": "", "int8": "int8", "int4": "int4"}


def make_controller(cfg):
    """RoboECC as ``examples/serve_vla_ecc.py`` sets it up for CogACT-7B:
    Jetson Orin edge, A100 cloud, a 12 GB cloud budget, ±1.5 MB/s ΔNB
    thresholds, and the codec chosen per tick among identity, int8, int4."""
    return core.RoboECC(cfg, core.ORIN, core.A100,
                        workload=core.Workload(s_new=17, decode_steps=0),
                        cloud_budget_bytes=12.0e9,
                        thresholds=core.Thresholds(high=1.5e6, low=-1.5e6),
                        adjust_codecs=["identity", "int8", "int4"])


def executor_cut(cfg, ctl, split: int) -> tuple:
    """Planner split -> (executor cut, whether it had to be clamped).  The
    planner's graph holds a ``vit.proj`` node after the ViT that the
    executor has no layer for, so a graph split in the LLM range
    ``[Lv + 1, Lv + 1 + L]`` puts ``split - Lv - 1`` LLM blocks on the edge:
    at the published depth that is executor cut ``split - 1``.  A split in
    the ViT or the DiT, or past a cut depth, cannot be served by the
    executor and is clamped into the LLM range and reported."""
    on_edge = split - ctl.cfg.vit_layers - 1
    cut = cfg.vit_layers + min(max(on_edge, 0), cfg.n_layers)
    return cut, cut != cfg.vit_layers + on_edge


def setup_cogact(cfg) -> dict:
    """Parameters on the card, the controller, and one executor per wire
    codec over the same parameters and the same pool (``SplitPlan.codec``
    is static, as in the JAX package).  The controller always plans the
    published configuration; a cut depth (``--llm-layers``) only shortens
    what the executor serves."""
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    peak_after_reset = torch.cuda.max_memory_allocated()
    ctl = make_controller(get_config(cfg.name))
    Lv, L = ctl.cfg.vit_layers, ctl.cfg.n_layers
    names = [c.name for c in ctl.graph]
    if names[Lv] != "vit.proj" or names[Lv + 1] != "llm.0" \
            or names[Lv + L] != f"llm.{L - 1}":
        raise AssertionError(f"graph layout around the ViT/LLM seam: "
                             f"{names[Lv - 1:Lv + 2]}")
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(gen(SEED + 20), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lo, hi = (executor_cut(cfg, ctl, s)[0]
              for s in (ctl.pool.start, ctl.pool.end))
    executors = {w: VLASplitExecutor(cfg, SplitPlan(lo, hi, codec=w))
                 for w in ("", "int8", "int4")}
    return {"cfg": cfg, "ctl": ctl, "params": params, "init_s": init_s,
            "held_before_bytes": held_before,
            "peak_after_reset_bytes": peak_after_reset,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "pool": (lo, hi), "executors": executors,
            "n_params": sum(t.numel() for t in tree_leaves(params)),
            "gen": gen(SEED + 21)}


def _cogact_request(st: dict) -> tuple:
    cfg, g = st["cfg"], st["gen"]
    patches = torch.randn((1, cfg.n_patches, cfg.vit_dim), generator=g,
                          device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (1, 17), generator=g,
                           device=DEV)
    noise = torch.randn((1, cfg.action_horizon, cfg.action_dim), generator=g,
                        device=DEV)
    return patches, tokens, noise


def _shipped_bytes(cfg, wire: str) -> int:
    shape = (1, cfg.n_patches + 17, cfg.d_model)
    if wire == "int4":
        return codec_ref.wire_bytes_int4(shape)
    if wire == "int8":
        return codec_ref.wire_bytes(shape)
    return shape[0] * shape[1] * shape[2] * torch.finfo(
        getattr(torch, cfg.dtype)).bits // 8


def phase_serve_cogact(st: dict, n_requests: int = 8) -> dict:
    cfg, params = st["cfg"], st["params"]
    Lv, L = cfg.vit_layers, cfg.n_layers
    S = cfg.n_patches + 17
    lo, hi = st["pool"]
    ex = st["executors"]["int4"]
    cuts = [lo + i % (hi - lo + 1) for i in range(n_requests)]
    for _ in range(2):                                   # warm-up
        patches, tokens, noise = _cogact_request(st)
        ex.run(params, patches, tokens, cuts[0], noise)
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after
    requests = [_cogact_request(st) for _ in range(n_requests)]
    walls = []
    want_bytes = codec_ref.wire_bytes_int4((1, S, cfg.d_model))
    if want_bytes != S * cfg.d_model // 2 + S * (cfg.d_model // 128) * 4:
        raise AssertionError(f"wire_bytes_int4 gives {want_bytes}")
    _reset_counts()
    for (patches, tokens, noise), cut in zip(requests, cuts):
        before = _counts()
        ms, (action, payload) = _wall_ms(
            lambda: ex.run(params, patches, tokens, cut, noise))
        walls.append(ms)
        moved = _moved(before)
        if moved != _want(L, "int4"):
            raise AssertionError(f"launch counts moved by {moved} in one "
                                 f"CogACT request, expected {_want(L, 'int4')}")
        _check_action(cfg, action)
        if set(payload) != {"q4", "s"} or payload_bytes(payload) != want_bytes:
            raise AssertionError(f"payload {payload_bytes(payload)} bytes, "
                                 f"expected {want_bytes} of packed int4")
    launches = _counts()

    # ---- streamed == run, bit for bit, at the same cut and noise
    patches, tokens, noise = requests[0]
    cut = cuts[1 % len(cuts)]
    a_run, _ = ex.run(params, patches, tokens, cut, noise)
    a_str, chunks = ex.run_streamed(params, patches, tokens, cut, 4, noise)
    if len(chunks) != 4 or not torch.equal(a_run, a_str):
        raise AssertionError("CogACT run_streamed(n_chunks=4) differs from run")

    # ---- codec off: the split hidden state equals the monolithic backbone
    ex_raw = st["executors"][""]
    h_ref = vla_backbone(cfg, params, patches, tokens)
    if not torch.isfinite(h_ref.float()).all():
        raise AssertionError("CogACT backbone hidden state is not finite")
    raw_err = 0.0
    for c in range(lo, hi + 1):
        x = ex_raw._cloud_hidden(
            params, ex_raw._edge_hidden(params, patches, tokens, c), c)
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        raw_err = max(raw_err, (h.float() - h_ref.float()).abs().max().item())
    if raw_err != 0.0:
        raise AssertionError(f"CogACT codec off: split hidden state is "
                             f"{raw_err} from the monolithic one")

    # ---- the int4 round trip: within half a step of its grid plus one
    # rounding of the result to the model's type
    x_cut = ex._edge_hidden(params, patches, tokens, cut)
    pay = encode_activation(x_cut, "int4")
    back = decode_activation(pay, cfg.dtype)
    step = pay["s"].repeat_interleave(128, dim=-1)
    lim = 0.5 * step + back.float().abs() * 2.0 ** -8 + 1e-12
    over = ((back.float() - x_cut.float()).abs() - lim).max().item()
    if over > 0:
        raise AssertionError(f"int4 round trip exceeds half a step by {over}")

    # ---- one two-pool request: the downlink ships the cognition token
    end = Lv + L
    ex2 = VLASplitExecutor(cfg, SplitPlan(lo, hi, codec="int4",
                                          pool2_start=end, pool2_end=end,
                                          codec2="int4"))
    before = _counts()
    ms2, (a2, pay2) = _wall_ms(
        lambda: ex2.run(params, patches, tokens, cut, noise))
    moved2 = _moved(before)
    _check_action(cfg, a2)
    if tuple(pay2["down"]["q4"].shape) != (1, 1, cfg.d_model // 2):
        raise AssertionError(f"downlink {tuple(pay2['down']['q4'].shape)}")
    if moved2 != _want(L, "int4", "int4"):
        raise AssertionError(f"two-pool launch counts {moved2}")
    if payload_bytes(pay2["down"]) != codec_ref.wire_bytes_int4(
            (1, 1, cfg.d_model)):
        raise AssertionError("downlink payload bytes")

    # ---- where a request's time goes: five stages, each synchronised
    stages = {"edge": [], "encode": [], "decode": [], "cloud_llm": [],
              "action_dit": []}
    for _ in range(8):
        ms, x = _wall_ms(lambda: ex._edge_hidden(params, patches, tokens, cut))
        stages["edge"].append(ms)
        ms, p = _wall_ms(lambda: encode_activation(x, "int4"))
        stages["encode"].append(ms)
        ms, y = _wall_ms(lambda: decode_activation(p, cfg.dtype))
        stages["decode"].append(ms)
        ms, h = _wall_ms(lambda: ex._cloud_hidden(params, y, cut))
        stages["cloud_llm"].append(ms)
        ms, _ = _wall_ms(lambda: ex._action_decode(params, h, noise))
        stages["action_dit"].append(ms)

    peak = torch.cuda.max_memory_allocated()
    prof = profile_request(lambda: ex.run(params, patches, tokens, cut, noise))
    prof_dit = profile_request(lambda: ex._action_decode(params, h, noise))
    info = {"phase": "serve_cogact", "model": cfg.name,
            "n_params": st["n_params"], "vit_layers": Lv, "llm_layers": L,
            "d_model": cfg.d_model, "dit": [cfg.dit_layers, cfg.dit_dim,
                                            cfg.diffusion_steps],
            "dtype": cfg.dtype, "seq": S, "init_s": st["init_s"],
            "graph_pool": [st["ctl"].pool.start, st["ctl"].pool.end],
            "alg1_split": st["ctl"].seg.split,
            "executor_pool": [lo, hi], "cuts": cuts,
            "request_wall_ms": walls,
            "request_wall_ms_median": statistics.median(walls),
            "stage_wall_ms_median": {k: statistics.median(v)
                                     for k, v in stages.items()},
            "two_pool_request_wall_ms": ms2,
            "profile_one_request": prof,
            "profile_action_dit": prof_dit,
            "payload_bytes": want_bytes,
            "downlink_payload_bytes": payload_bytes(pay2["down"]),
            "launches": launches,
            "codec_off_hidden_max_err": raw_err,
            "int4_round_trip_over_half_step": over,
            "streamed_equals_run": True,
            "held_before_init_bytes": st["held_before_bytes"],
            "peak_after_reset_bytes": st["peak_after_reset_bytes"],
            "param_bytes": st["param_bytes"],
            "peak_memory_bytes": peak}
    emit(info)
    return info


# ================================================================= control
def phase_control(st: dict, n_ticks: int = 60) -> dict:
    """The closed loop of ``examples/serve_vla_ecc.py`` at full width: the
    LSTM trained on the card on the first 3000 steps of the trace, then one
    tick per request on the rest, each request served on the card at the
    tick's cut and codec."""
    cfg, ctl, params = st["cfg"], st["ctl"], st["params"]
    L = cfg.n_layers
    trace = core.generate_trace(4000, seed=11)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctl.fit_predictor(trace[:3000], core.PredictorConfig(epochs=120),
                      device=DEV)
    train_s = time.perf_counter() - t0
    if ctl.predictor.device.type != torch.device(DEV).type:
        raise AssertionError("the predictor is not on the card")
    W = ctl.predictor.cfg.window
    net = core.NetworkSim(trace[3000:])
    net.step(W)
    predict_ms = [_wall_ms(lambda: ctl.predictor.predict(net.window(W)))[0]
                  for _ in range(10)]

    n = len(ctl.graph)
    requests = [_cogact_request(st) for _ in range(n_ticks)]
    ticks, walls, clamped, shipped, priced = [], [], 0, [], []
    _reset_counts()
    for patches, tokens, noise in requests:
        tick = ctl.tick(net)
        wire = WIRE[tick.codec]
        cut, was_clamped = executor_cut(cfg, ctl, tick.split)
        clamped += was_clamped
        ex = st["executors"][wire]
        before = _counts()
        ms, (action, payload) = _wall_ms(
            lambda: ex.run(params, patches, tokens, cut, noise))
        moved = _moved(before)
        if moved != _want(L, wire):
            raise AssertionError(f"tick with codec {tick.codec!r}: launches "
                                 f"moved by {moved}, expected {_want(L, wire)}")
        _check_action(cfg, action)
        if payload_bytes(payload) != _shipped_bytes(cfg, wire):
            raise AssertionError(f"tick with codec {tick.codec!r}: payload "
                                 f"{payload_bytes(payload)} bytes, expected "
                                 f"{_shipped_bytes(cfg, wire)}")
        raw = core.cut_bytes(ctl.graph, tick.split)
        c = core.get_codec(tick.codec)
        priced.append(c.wire_bytes(raw) if c is not None
                      and core.codec_applies(tick.split, n) else raw)
        shipped.append(payload_bytes(payload))
        walls.append(ms)
        ticks.append(tick)
    launches = _counts()
    if not any(WIRE[t.codec] == "int4" for t in ticks):
        raise AssertionError("the controller never served int4")

    def mix(values):
        out = {}
        for v in values:
            out[str(v)] = out.get(str(v), 0) + 1
        return out

    overhead = [t.adjust_overhead_s * 1e3 for t in ticks]
    info = {"phase": "control", "model": cfg.name, "ticks": n_ticks,
            "edge_device": ctl.edge_dev.name, "cloud_device": ctl.cloud_dev.name,
            "alg1_split": ctl.seg.split,
            "graph_pool": [ctl.pool.start, ctl.pool.end],
            "executor_pool": list(st["pool"]),
            "codec_mix": mix(t.codec for t in ticks),
            "split_mix": mix(t.split for t in ticks),
            "executor_cut_mix": mix(executor_cut(cfg, ctl, t.split)[0]
                                    for t in ticks),
            "decision_mix": mix(t.decision.reason for t in ticks),
            "ticks_clamped": clamped,
            "predictor": {"epochs": ctl.predictor.cfg.epochs,
                          "n_bytes": ctl.predictor.n_bytes(),
                          "train_s": train_s,
                          "predict_ms": predict_ms,
                          "predict_ms_median": statistics.median(predict_ms)},
            "adjust_overhead_ms": overhead,
            "adjust_overhead_ms_median": statistics.median(overhead),
            "request_wall_ms": walls,
            "request_wall_ms_median": statistics.median(walls),
            "overhead_share_of_wall": statistics.median(overhead)
            / statistics.median(walls),
            "modelled_total_ms": [t.total_s * 1e3 for t in ticks],
            "modelled_total_ms_median": statistics.median(
                t.total_s * 1e3 for t in ticks),
            "modelled_ms_median": {
                k: statistics.median(getattr(t, k) * 1e3 for t in ticks)
                for k in ("edge_s", "cloud_s", "net_s")},
            "bw_real_mbps_median": statistics.median(
                t.bw_real_bps / 1e6 for t in ticks),
            "planner_priced_bytes": mix(int(b) for b in priced),
            "shipped_bytes": mix(shipped),
            "launches": launches}
    emit(info)
    return info


# ==================================================================== main
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--llm-layers", type=int, default=None,
                    help="cut the LLM depth (default: the model's own)")
    ap.add_argument("--vit-layers", type=int, default=None)
    args = ap.parse_args()

    env = phase_env()
    torch.cuda.set_device(0)
    cfg, cogact = get_config("openvla-7b"), get_config("cogact-7b")
    if args.llm_layers is not None:
        cfg = cfg.replace(n_layers=args.llm_layers)
        cogact = cogact.replace(n_layers=args.llm_layers)
    if args.vit_layers is not None:
        cfg = cfg.replace(vit_layers=args.vit_layers)
        cogact = cogact.replace(vit_layers=args.vit_layers)

    phase_build()
    kernels = phase_kernels(cfg)
    runs = {"serve": phase_serve(cfg)["launches"]}
    gc.collect()                    # the OpenVLA parameters go before CogACT
    torch.cuda.empty_cache()
    cst = setup_cogact(cogact)
    runs["serve_cogact"] = phase_serve_cogact(cst)["launches"]
    runs["control"] = phase_control(cst)["launches"]

    print(env["nvidia_smi"], flush=True)
    summary = []
    for name, r in kernels.items():
        by_path = {path: counts[name] for path, counts in runs.items()}
        n = sum(by_path.values())
        if n < 1:
            raise AssertionError(f"no main path launched {name}")
        summary.append({"name": name, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": n, "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "host_ms": r["host_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
