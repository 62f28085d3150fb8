#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Drives the port's main paths at full width and depth with random weights
made from a seed — OpenVLA-7B and CogACT-7B action requests served by split
co-inference (``repro_torch.runtime.partition.VLASplitExecutor``), OpenVLA-7B
requests through the temporal-delta transport (``DeltaTransport``), the
paper's closed loop (``repro_torch.core.RoboECC``) choosing the cut and the
codec of every CogACT request, Llama-3.2-3B prefill and greedy decode
(``repro_torch.runtime.serving.greedy_generate``), Llama-3.2-3B requests
served by split co-inference (``LMSplitExecutor``), prefill and greedy
decode of Mamba2-1.3B (SSM), Zamba2-1.2B (hybrid) and phi3-mini-3.8b (head
dim 96), granite-moe-3b-a800m and deepseek-v2-lite-16b (MoE; MLA), the
port's serving entry point with the int8 codec at the reduced width of 64
columns, and the paper's example scripts — and holds every
hand-written kernel on those paths against its plain PyTorch version on the
card.  Needs one card,
``nvcc`` and no network; the kernels are built from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use.  Any phase
that fails raises, and the process then exits non-zero.

Phases, one JSON line each:

  env           torch / CUDA versions, the card's name and power limit
  build         seconds the kernels took to build
  kernels       each kernel against its plain version at the main paths'
                shapes and at awkward ones, with times
  serve         8 OpenVLA-7B int8 requests with the cut walking the pool,
                one two-pool request, and the checks on what came out;
                then 4 of them and the two-pool one again with a flight
                recorder: two executor spans each, the same outputs and
                launches, a Chrome trace written to build/ and read back
  delta         OpenVLA-7B over a static and a dynamic scene, 24 action
                steps each, through the temporal-delta transport (int8):
                key and delta frames, the measured fraction of changed
                rows at the cut against the scene's, bytes per step
                against the plain int8 payload, exact codec launches,
                encode and decode host walls, and the checks against the
                plain codec, the wire accounting and the error bound
  serve_cogact  8 CogACT-7B packed-int4 requests walking the pool that
                Alg. 1 places, one two-pool request with an int4 downlink,
                the checks on what came out, stage times and profiles
  control       the LSTM trained on the card, then 60 ticks of the closed
                loop, each request served at the tick's cut and codec:
                codec and split mix, forecast time against request wall,
                planner-priced against shipped bytes
  generate      Llama-3.2-3B: a 512-token prompt and 64 greedy steps at
                batch 1 and 4, exact launch counts, step walls, a profiled
                step, the logits against one full forward
  serve_lm      Llama-3.2-3B split at a cut walking the pool of
                ``launch/serve.py``, int8 on the cut, batches of 4 requests
                of 17 tokens, one two-pool request, the checks on what came
                out
  generate_ssm  Mamba2-1.3B as ``generate`` does Llama (the SSD scan in
                every layer of the prefill and of the full forward), after
                its reduced config in float32 against the full forward and
                against the plain versions on the card
  generate_hybrid  Zamba2-1.2B the same way (the shared attention block at
                7 sites: flash attention in the prefill, flash-decode in
                every step)
  generate_phi3 phi3-mini-3.8b (32 heads of 96): a 512-token prompt and 16
                greedy steps at batch 1, as ``generate``, and the model in
                float32 against its full forward
  vla_heads     OpenVLA-7B's backbone (after ``delta``, the same
                parameters) with the ``mlp``, ``lstm`` and ``diffusion``
                action heads at full width: one int8 split request each,
                exact launches, each head alone on the card against the
                CPU on one cognition feature
  generate_moe  granite-moe-3b-a800m (32 MoE layers, 40 experts top-8 in a
                table of 48): a 512-token prompt and 32 greedy steps at
                batch 1 and 4, as ``generate``, the float32 gate at a
                capacity factor of 8, one MoE layer profiled
  serve_moe     ``LMSplitExecutor`` on granite and then deepseek, a pool
                inside the MoE group, int8 and then int4 on the cut, exact
                bytes and launches, the decoded cut against the unsplit one
  generate_mla  deepseek-v2-lite-16b (27 layers: 1 dense, 26 MoE with 64
                experts top-6 and 2 shared; MLA): 16 steps at batch 1 and
                4, flash attention at head dims (192, 128) in every layer
                of the prefill, the absorbed decode in plain products
  serve_cli     ``python -m repro_torch.launch.serve --codec --requests 4``
                for Llama-3.2-3B, then with ``--arch`` granite-moe-3b-a800m
                and deepseek-v2-lite-16b
                on the card: its reduced data plane (d_model 64) ships the
                cut through the int8 codec at one 64-column block a row
  examples      ``examples/quickstart_torch.py``, ``serve_vla_ecc_torch.py``
                and ``multi_arch_segmentation_torch.py``, each as its own
                process on the card, with their walls

Every ``generate*`` phase also profiles one prefill by kernel family,
holds the synchronised step loop's tokens equal to ``greedy_generate``'s,
and checks that each SSD scan call ran one chunk-state and one output
kernel.  Then come the card's name and power limit as ``nvidia-smi``
prints them, a ``{"kernels": [...]}`` summary of every kernel (launch
count on the main paths and the CUDA kernels a launch queues, error,
time, plain version's time, the card's bound, the library call's time;
flash attention, flash-decode and the SSD scan with a
``served`` list of every shape their main paths give them) and, last,
``{"ok": true, "device": {...}}``.

``--llm-layers`` / ``--vit-layers`` cut the depth of the served VLA models,
for finding faults (the controller still plans the published CogACT-7B;
Llama-3.2-3B always runs in full); with no arguments everything runs in
full.  ``--attention-only`` runs the flash attention and flash-decode
cases and times alone, and counts the kernels of one Llama-3.2-3B and one
Zamba2-1.2B decode step (about a minute); ``--ssd-only`` runs the SSD
scan's cases and its times at the four served shapes; ``--codec-only``
runs the int8 and int4 codecs' cases, their times at the served shapes
beside the launch floor (an empty kernel queued the same way), what the
quantise kernels' rounding division costs (inputs with no tie, random
ones, all ties), and where the host time of an int4 call goes.  With
``--src DIR`` each does so for the ``repro_torch`` under ``DIR``, e.g. a
parent commit unpacked beside this one, so that two versions are compared
in one call.
"""
from __future__ import annotations

import argparse
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import redirect_stdout

_OWN_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")


def _src_dir() -> str:
    """The ``src`` whose ``repro_torch`` this script drives: this
    checkout's, or the one after ``--src`` (to run the same cases and times
    on another checkout, such as a parent commit unpacked with ``git
    archive``, beside this one's in one call)."""
    if "--src" in sys.argv[1:-1]:
        return os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
    return _OWN_SRC


sys.path.insert(0, _src_dir())

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.core.telemetry import FlightRecorder
from repro_torch.kernels import _build
from repro_torch.kernels.activation_codec import ops as codec_ops
from repro_torch.kernels.activation_codec import ref as codec_ref
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import build
from repro_torch.models.attention import mla_cache_specs, mla_decode
from repro_torch.models.hybrid import n_sites
from repro_torch.models.layers import rmsnorm
from repro_torch.models.moe import capacity, moe_ffn
from repro_torch.models.sharding import init_params, tree_leaves, tree_map
from repro_torch.models.ssm import ssd_step
from repro_torch.models.transformer import _layer_slice, lm_hidden, lm_logits
from repro_torch.models.vla import (action_head_specs, decode_action,
                                   draw_noise, vla_backbone)
from repro_torch.runtime.kvcache import cache_bytes
from repro_torch.runtime.partition import (DeltaTransport, LMSplitExecutor,
                                           SplitPlan, VLASplitExecutor,
                                           decode_activation, delta_decode,
                                           delta_encode, encode_activation,
                                           payload_bytes)
from repro_torch.runtime.trace_export import chrome_trace, export_chrome_trace
from repro_torch.runtime.scheduler import MicroBatcher, Request
from repro_torch.runtime.serving import (greedy_generate, make_serve_step,
                                         prefill_and_pad)

# NVIDIA H100 SXM data-sheet peaks (dense), used for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEED = 0
DEV = "cuda"

# the LM paths: generate's prompt and greedy steps, its batches, and
# serve_lm's requests (tokens each) and micro-batch; generate_phi3's steps
LM_PROMPT, LM_STEPS, LM_BATCHES = 512, 64, (1, 4)
LM_SEQ, LM_MICRO_BATCH = 17, 4
PHI3_STEPS = 16
# the MoE paths: granite-moe-3b-a800m (GQA) and deepseek-v2-lite-16b (MLA),
# each generate_* phase's greedy steps
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v2-lite-16b"
MOE_STEPS = 32


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


def host_times(fn, calls: int = 200, reps: int = 5) -> dict:
    """Host time to issue one call (nothing waits for the card), over
    ``reps`` runs of ``calls`` calls each: ``host_ms`` the median run,
    ``host_ms_least`` the least.  The host's cores are shared, and single
    runs of the same call moved up to twofold: the median is what a path
    pays, the least what the call itself costs."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return {"host_ms": statistics.median(times), "host_ms_least": min(times)}


def host_ms(fn) -> float:
    """The median of ``host_times``."""
    return host_times(fn)["host_ms"]


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
    spills, entry = [], None
    for ln in log:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "bytes spill" in ln and " 0 bytes spill stores" not in ln:
            spills.append(f"{entry}: {ln.split(':')[-1].strip()}")
    nvcc = subprocess.run([_build._find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    emit({"phase": "build", "seconds": _build.build_seconds,
          "nvcc": next((ln.strip() for ln in nvcc.splitlines()
                        if "release" in ln), nvcc.strip()),
          "sources": [p.name for p in _build.sources()],
          "flags": " ".join(_build.NVCC_FLAGS),
          "kernels_compiled": sum("Compiling entry function" in ln
                                  for ln in log),
          "kernels_with_spills": len(spills), "spills": spills})


# ================================================================= kernels
def _codec_input(shape, dtype, seed, case="zero_lo", qmax=7, block=128):
    """Inputs for the codecs, 3 N(0, 1) at heart.  ``qmax`` is the codec's
    quantum (7 for int4, 127 for int8) and ``block`` its block width.
    ``zero_lo`` / ``zero_hi``: the first 128 columns of the first row all
    zero (int8: a zero block), or the next 128 (int4: one all-zero
    128-block beside a non-zero one in the same 256-column tile).  ``ties``:
    every block holds ``qmax`` once, so its scale is qmax * RN(1/qmax) = 1.0
    exactly (for 7 and 127), and the rest of it lies on the half-integers
    -qmax + 1/2 ... qmax - 1/2, exact in bfloat16, so that every x / s is an
    exact .5 tie for the half-to-even rounding.  ``integers``: the same with
    the rest on the integers -qmax + 1 ... qmax, so that no x / s lies near a
    tie.  ``near_ties``: see ``_near_tie_blocks``.  ``sub_flt_min``: every
    other block scaled so that its scale lies below FLT_MIN (where RN(1/s)
    overflows, and where it does not; many elements subnormal), every
    fourth one to a tiny normal scale, beside blocks of the usual size.
    ``non_finite`` (int8): a NaN in every third block, +Inf in every sixth
    of those, -Inf in every third from the second on, and every block's
    first element 300 (past the int8 range at the scale 1 a NaN gives)."""
    x = torch.randn(shape, generator=gen(seed), device=DEV,
                    dtype=torch.float32) * 3.0
    rows = x.reshape(-1, shape[-1])
    blocks = rows.view(-1, block)
    if case == "zero_lo":
        rows[0, :128] = 0.0
    elif case == "zero_hi":
        rows[0, 128:256] = 0.0
    elif case in ("ties", "integers"):
        k = torch.randint(-qmax, qmax, rows.shape, generator=gen(seed + 1),
                          device=DEV).float()
        rows.copy_(k + 0.5 if case == "ties" else k + 1.0)
        blocks[:, 0] = float(qmax)
    elif case == "near_ties":
        _near_tie_blocks(rows, dtype, seed + 1, qmax, block)
    elif case == "sub_flt_min":
        overflows, finite = SUB_FLT_MIN_FACTORS[qmax]
        blocks[0::4] *= overflows            # RN(1/s) overflows
        blocks[2::4] *= finite               # RN(1/s) finite
        blocks[1::4] *= 1e-30
    elif case == "non_finite":
        blocks[:, 0] = 300.0
        blocks[0::3, 5] = float("nan")
        blocks[0::6, 7] = float("inf")
        blocks[1::3, 9] = float("-inf")
    return x.to(dtype)


# what ``sub_flt_min`` scales its blocks by, per quantum: block scales near
# 1e-40 (int8) or 1e-39 (int4), where RN(1/s) overflows, and near 5e-39,
# where it is finite
SUB_FLT_MIN_FACTORS = {7: (1e-39, 4e-39), 127: (1e-39, 7e-38)}


def _plain_scales(x, qmax, block=128):
    return (codec_ops.quantize_plain(x, block) if qmax == 127
            else codec_ops.quantize_int4_plain(x))[1]


def _case_checks(x, case, qmax, block=128):
    """The checks that an input is what its case says: all scales 1.0 for
    ``ties``, some scale below FLT_MIN for ``sub_flt_min``, and for
    ``near_ties`` some element that the reciprocal alone rounds the wrong
    way (returned, else None)."""
    codec = "int8" if qmax == 127 else "int4"
    if case == "ties":
        s = _plain_scales(x, qmax, block)
        if not torch.equal(s, torch.ones_like(s)):
            raise AssertionError(f"{codec} ties input: scales are not all 1.0")
    if case == "sub_flt_min":
        s_min = _plain_scales(x, qmax, block).min().item()
        if not 0.0 < s_min < torch.finfo(torch.float32).tiny:
            raise AssertionError(f"{codec} sub_flt_min input: smallest scale "
                                 f"{s_min} is not below FLT_MIN")
    if case != "near_ties":
        return None
    flips = _reciprocal_flips(x, qmax, block)
    if flips == 0:
        raise AssertionError(f"{codec} near-ties input: no element that the "
                             "reciprocal alone would round the wrong way")
    return flips


def _non_finite_want(x, q_p, block):
    """What the header of ``csrc/activation_codec.cu`` states for
    non-finite inputs: the plain version's values, but -127 for a NaN and
    for +-Inf in a block without a NaN (where the plain version's cast of a
    NaN is undefined)."""
    xb = x.reshape(-1, block)
    nan_block = xb.isnan().any(-1, keepdim=True)
    want = q_p.reshape(-1, block).clone()
    want[xb.isnan() | (xb.isinf() & ~nan_block)] = -127
    return want.reshape(q_p.shape)


def check_codec(shape, dtype, seed, block=128, case="zero_lo") -> dict:
    x = _codec_input(shape, dtype, seed, case, 127, block)
    flips = _case_checks(x, case, 127, block)
    q_k, s_k = codec_ops.quantize(x, block)
    q_p, s_p = codec_ops.quantize_plain(x, block)
    torch.cuda.synchronize()
    if q_k.dtype != torch.int8 or q_k.shape != x.shape \
            or s_k.shape != (*x.shape[:-1], x.shape[-1] // block):
        raise AssertionError(f"quantize {shape}: wrong output {q_k.shape} "
                             f"{q_k.dtype} {s_k.shape}")
    if case == "non_finite":
        q_p = _non_finite_want(x, q_p, block)
    q_err = (q_k.int() - q_p.int()).abs().max().item()
    s_err = (s_k - s_p).abs().nan_to_num().max().item()
    if not (torch.equal(q_k, q_p) and torch.equal(s_k, s_p)):
        raise AssertionError(f"quantize_int8 {shape} {dtype} {case}: kernel "
                             f"and plain version differ (payload by {q_err}, "
                             f"scales by {s_err}); they are held bit-equal")
    d_k = codec_ops.dequantize(q_k, s_k, dtype, block)
    d_p = codec_ops.dequantize_plain(q_k, s_k, dtype, block)
    torch.cuda.synchronize()
    nan = d_p.isnan()
    d_err = (d_k.float() - d_p.float())[~nan].abs().nan_to_num().max().item()
    if not (torch.equal(d_k.isnan(), nan)
            and torch.equal(d_k[~nan], d_p[~nan])):
        raise AssertionError(f"dequantize_int8 {shape} {dtype} {case}: kernel "
                             f"and plain version differ by {d_err}; they are "
                             "held bit-equal")
    return {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "block": block, "case": case,
            "quantize_max_err": max(q_err, s_err), "dequantize_max_err": d_err,
            **({"reciprocal_flips": flips} if flips is not None else {})}


def _near_tie_blocks(rows, dtype, seed, qmax=7, block=128):
    """Fill every block of ``rows`` (float32, (R, D), blocks of ``block``
    columns) with inputs whose quotient x / s lies at or next to a
    half-integer, for the quantum ``qmax``.  Even blocks: the abs-max is
    qmax m 2^e for an odd m, so s = RN(qmax m 2^e RN(1/qmax)) is m 2^e or an
    ulp off it, and the other elements are (2k + 1) m 2^(e-1) (k = 0 ..
    qmax - 1, random signs) rounded to ``dtype`` (exact for int4); m = 1
    gives exact ties (s = 2^e).  Odd blocks: the abs-max is a 2^e with
    a = 1 + j/128, and the other elements a (2k + 1) 2^e / (2 qmax) rounded
    to ``dtype``, so that k = (qmax - 1) / 2 gives a 2^(e-1) exactly and
    x / s lies an ulp or so off qmax / 2.  Then a third of all elements move
    one ulp of ``dtype`` up or down.  Some of these elements a product with
    RN(1/s) rounds the other way than the IEEE quotient."""
    g = gen(seed)
    blocks = rows.view(-1, block)
    nb = blocks.shape[0]
    ms = torch.tensor([1, 3, 5, 9, 11, 13, 15, 17, 19], device=DEV)
    m = ms[torch.randint(0, len(ms), (nb, 1), generator=g, device=DEV)]
    e = torch.exp2(torch.randint(-3, 4, (nb, 1), generator=g,
                                 device=DEV).float())
    a = 1.0 + torch.randint(0, 128, (nb, 1), generator=g,
                            device=DEV).float() / 128
    k = torch.randint(0, qmax, (nb, block), generator=g, device=DEV)
    sign = torch.randint(0, 2, (nb, block), generator=g, device=DEV) * 2 - 1
    odd = (torch.arange(nb, device=DEV) % 2 == 1)[:, None]
    amax = torch.where(odd, a * e, (qmax * m).float() * e)
    x = torch.where(odd, a * e * (2 * k + 1).float() / (2 * qmax),
                    ((2 * k + 1) * m).float() * e / 2)
    x[:, 0] = amax[:, 0]
    x = (sign * x).to(dtype)
    bits = x.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    step = torch.randint(-1, 2, (nb, block), generator=g, device=DEV)
    step[:, 0] = 0
    bits += step.to(bits.dtype)              # one ulp up / down, same sign
    blocks.copy_(x.float())


def _reciprocal_flips(x, qmax=7, block=128) -> int:
    """Elements of ``x`` whose rint(x * RN(1/s)) differs from
    rint(x / s) (IEEE division), s the plain version's block scales for the
    quantum ``qmax``: how many elements a rounding by the reciprocal alone
    would get wrong."""
    s = _plain_scales(x, qmax, block)
    xb = x.float().reshape(*x.shape[:-1], -1, block)
    sb = s[..., None]
    return int((torch.round(xb * (1.0 / sb)) != torch.round(xb / sb)).sum())


def check_codec4(shape, dtype, seed, case="zero_lo") -> dict:
    x = _codec_input(shape, dtype, seed, case)
    flips = _case_checks(x, case, 7)
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
            "dequantize_max_err": d_err,
            **({"reciprocal_flips": flips} if flips is not None else {})}


def _attn_inputs(B, S, T, H, KV, D, dtype, seed, strided=False, Dv=None):
    """q (B, S, H, D), k (B, T, KV, D), v (B, T, KV, Dv); ``Dv`` defaults
    to ``D``."""
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
    v = torch.randn((B, T, KV, Dv or D), generator=g, device=DEV,
                    dtype=torch.float32).to(dtype)
    return q, k, v


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def check_attn(B, S, T, H, KV, D, dtype, causal, seed, strided=False,
               Dv=None) -> dict:
    q, k, v = _attn_inputs(B, S, T, H, KV, D, dtype, seed, strided, Dv)
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
            **({"Dv": Dv} if Dv else {}),
            "dtype": str(dtype).split(".")[-1], "causal": causal,
            "strided": strided, "max_err": err, "tol": ATTN_TOL[dtype]}
    if err > ATTN_TOL[dtype]:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {case}")
    return case


DECODE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _decode_inputs(B, H, KV, T, D, dtype, seed, flat=False):
    """q (B, H, D) and k, v as (B, KV, T, D).  ``flat``: k and v are views
    of a model's flat (B, T, KV*D) cache, read through its strides."""
    g = gen(seed)

    def draw(shape):
        return torch.randn(shape, generator=g, device=DEV,
                           dtype=torch.float32).to(dtype)

    q = draw((B, H, D))
    if flat:
        kc, vc = draw((B, T, KV * D)), draw((B, T, KV * D))
        return (q, kc.view(B, T, KV, D).permute(0, 2, 1, 3),
                vc.view(B, T, KV, D).permute(0, 2, 1, 3))
    return q, draw((B, KV, T, D)), draw((B, KV, T, D))


def check_decode(B, H, KV, T, D, kv_len, dtype, seed, flat=False,
                 device_len=False) -> dict:
    q, k, v = _decode_inputs(B, H, KV, T, D, dtype, seed, flat)
    n = torch.tensor(kv_len, dtype=torch.int32, device=DEV) if device_len \
        else kv_len
    out = da_ops.decode_attention(q, k, v, n)
    ref = da_ops.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != dtype:
        raise AssertionError(f"decode_attention: wrong output {out.shape} "
                             f"{out.dtype}")
    if not torch.isfinite(out.float()).all():
        raise AssertionError("decode_attention: output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    chunk, n_split = da_ops.split_plan(T, B * KV, da_ops.sm_count(q.device))
    case = {"B": B, "H": H, "KV": KV, "T": T, "D": D, "kv_len": kv_len,
            "dtype": str(dtype).split(".")[-1], "flat_cache": flat,
            "device_kv_len": device_len, "n_split": n_split,
            "live_splits": -(-min(kv_len, T) // chunk), "max_err": err,
            "tol": DECODE_TOL[dtype]}
    if err > DECODE_TOL[dtype]:
        raise AssertionError(f"decode_attention disagrees with its plain "
                             f"version: {case}")
    return case


def decode_cases(lcfg) -> list:
    """B6 cases; the served ones at Llama-3.2-3B's heads and the buffer of
    ``generate`` (prompt + steps), on its flat cache."""
    bf, f32 = torch.bfloat16, torch.float32
    H, KV, hd = lcfg.n_heads, lcfg.n_kv_heads, lcfg.resolved_head_dim
    T = LM_PROMPT + LM_STEPS
    cases = []
    seed = 200
    for b, h, kv, t, d in ((2, 4, 2, 256, 32), (1, 8, 8, 512, 64)):
        for kv_len in (1, 7, 100, 256, t):             # tests/test_kernels.py
            for dt in (f32, bf):
                seed += 1
                cases.append(check_decode(b, h, kv, t, d, kv_len, dt, seed))
    for B in LM_BATCHES:                               # the served shape
        for kv_len in (1, 300, LM_PROMPT + 1, T):
            seed += 1
            cases.append(check_decode(B, H, KV, T, hd, kv_len, bf, seed,
                                      flat=True))
        cases.append(check_decode(B, H, KV, T, hd, T - 31, f32, seed + 50,
                                  flat=True))
        cases.append(check_decode(B, H, KV, T, hd, T, bf, seed + 60))
    for kv_len in (1, 100, 200):                       # ragged buffer
        for dt in (f32, bf):
            seed += 1
            cases.append(check_decode(1, 6, 2, 200, 64, kv_len, dt, seed))
    # many splits, most of them dead; the kv_len read from the card
    cases.append(check_decode(1, 8, 2, 4096, 128, 100, bf, 301))
    cases.append(check_decode(1, 8, 2, 4096, 128, 4000, f32, 302))
    cases.append(check_decode(1, H, KV, T, hd, LM_PROMPT + 8, bf, 303,
                              flat=True, device_len=True))
    cases.append(check_decode(2, 6, 3, 100, 16, 77, f32, 304,
                              device_len=True))
    cases.append(check_decode(1, 32, 2, 8192, 128, 8192, bf, 305))  # GQA 16x
    # one split in all (a 32-position buffer); one live split of many,
    # written straight out; the most splits a plan gives (one pair, 8192
    # positions: 128 splits of one tile); dead splits behind a kv_len read
    # from the card
    for dt in (f32, bf):
        cases.append(check_decode(1, H, KV, 32, hd, 32, dt, 306, flat=True))
        cases.append(check_decode(1, H, KV, T, hd, 20, dt, 307, flat=True))
        cases.append(check_decode(1, 8, 1, 8192, 128, 8192, dt, 308))
        cases.append(check_decode(1, 8, 2, 4096, 128, 100, dt, 309,
                                  device_len=True))
    if not any(c["n_split"] > c["live_splits"] > 1 for c in cases):
        raise AssertionError("no case left a split dead")
    if not any(c["n_split"] == 1 for c in cases) \
            or not any(c["n_split"] > c["live_splits"] == 1 for c in cases):
        raise AssertionError("no case ran a single (live) split")
    return cases


def check_repeat(name, fn) -> dict:
    """Two calls in a row on the same inputs must be bit-equal: a merge
    ticket left dirty, or a merge order that depends on which block came
    last, would show here."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls on the same inputs differ "
                             f"by {(a.float() - b.float()).abs().max().item()}")
    return {"case": name, "bit_equal": True}


def attention_cases(cfg, lcfg, zcfg, pcfg) -> tuple:
    """B5 and B6 against their plain versions at the shapes the main paths
    give them (``cfg`` the served VLA, ``lcfg`` Llama-3.2-3B, ``zcfg``
    Zamba2-1.2B, ``pcfg`` phi3-mini-3.8b's head dim 96, and the MoE models:
    granite-moe-3b-a800m's GQA 24/8 x 64 and deepseek-v2-lite-16b's MLA
    prefill at head dims (192, 128)) and at awkward ones, and repeated
    calls held bit-equal.  Returns (B5 cases, B6 cases)."""
    gcfg, dcfg = get_config(GRANITE), get_config(DEEPSEEK)
    S_main = cfg.n_patches + 17
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    H_l, KV_l, hd_l = lcfg.n_heads, lcfg.n_kv_heads, lcfg.resolved_head_dim
    H_z, KV_z, hd_z = zcfg.n_heads, zcfg.n_kv_heads, zcfg.resolved_head_dim
    T_l = LM_PROMPT + LM_STEPS
    bf, f32 = torch.bfloat16, torch.float32
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
    for i, B in enumerate(LM_BATCHES):            # generate's prefill, GQA 3x
        attn_cases.append(check_attn(B, LM_PROMPT, LM_PROMPT, H_l, KV_l, hd_l,
                                     bf, True, 50 + i))
    attn_cases += [
        check_attn(1, LM_PROMPT, LM_PROMPT, H_l, KV_l, hd_l, f32, True, 52),
        check_attn(LM_MICRO_BATCH, LM_SEQ, LM_SEQ, H_l, KV_l, hd_l, bf, True,
                   53),                                   # serve_lm blocks
        check_attn(LM_MICRO_BATCH, LM_SEQ, LM_SEQ, H_l, KV_l, hd_l, f32, True,
                   54),
        # S < one 64-row query tile, not causal; T > S, so K/V tiles ring
        check_attn(LM_MICRO_BATCH, LM_SEQ, 150, H_l, KV_l, hd_l, bf, False,
                   57),
        check_attn(1, S_main, S_main, H_z, KV_z, hd_z, bf, True, 58),  # D 64
    ]
    for i, S in enumerate((1, 2, 17, 63, 64, 65)):                # ragged
        attn_cases.append(check_attn(2, S, S, 2, 2, 16, f32, True, 20 + i))
        attn_cases.append(check_attn(2, S, S, 2, 1, 64, bf, False, 30 + i))
    for i, B in enumerate(LM_BATCHES):    # Zamba2's shared block, MHA 32 x 64
        attn_cases.append(check_attn(B, LM_PROMPT, LM_PROMPT, H_z, KV_z, hd_z,
                                     bf, True, 55 + i))
    H_p, KV_p, hd_p = pcfg.n_heads, pcfg.n_kv_heads, pcfg.resolved_head_dim
    attn_cases += [                       # head dim 96: phi3's prefill
        check_attn(1, LM_PROMPT, LM_PROMPT, H_p, KV_p, hd_p, bf, True, 60),
        check_attn(1, LM_PROMPT, LM_PROMPT, H_p, KV_p, hd_p, f32, True, 61),
        check_attn(2, 130, 130, 4, 2, 96, bf, False, 62),
        check_attn(1, 100, 333, 4, 4, 96, f32, False, 63),
        check_attn(2, 17, 17, 8, 8, 96, bf, True, 64),
        check_attn(1, 65, 65, 2, 1, 96, f32, True, 65),
        check_attn(1, S_main, S_main, 4, 4, 96, bf, True, 66, strided=True),
    ]
    # granite-moe-3b-a800m's prefill (24/8 heads of 64) and serve_moe's
    # blocks; deepseek-v2-lite-16b's MLA prefill at head dims (192, 128):
    # causal, S of 17, 512 and a ragged 300, batch 1 and 4, bf16 and f32
    H_g, KV_g, hd_g = gcfg.n_heads, gcfg.n_kv_heads, gcfg.resolved_head_dim
    for i, B in enumerate(LM_BATCHES):
        attn_cases.append(check_attn(B, LM_PROMPT, LM_PROMPT, H_g, KV_g, hd_g,
                                     bf, True, 70 + i))
    attn_cases.append(check_attn(LM_MICRO_BATCH, LM_SEQ, LM_SEQ, H_g, KV_g,
                                 hd_g, bf, True, 72))
    H_d, Dqk, Dv = dcfg.n_heads, dcfg.qk_nope_dim + dcfg.qk_rope_dim, \
        dcfg.v_head_dim
    seed = 80
    for S in (LM_SEQ, LM_PROMPT, 300):
        for B in LM_BATCHES:
            for dt in (bf, f32):
                seed += 1
                attn_cases.append(check_attn(B, S, S, H_d, H_d, Dqk, dt, True,
                                             seed, Dv=Dv))
    attn_cases += [                      # not causal, S != T, GQA, S < 64
        check_attn(1, 100, 333, 4, 4, Dqk, f32, False, 90, Dv=Dv),
        check_attn(2, 130, 130, 4, 2, Dqk, bf, False, 91, Dv=Dv),
        check_attn(2, 5, 5, 2, 1, Dqk, bf, True, 92, Dv=Dv),
    ]
    # the reduced MLA of launch/serve.py --arch deepseek-v2-lite-16b: q/k
    # 24 (carried zero-padded to 32 in bf16), v 16; its 4 x 17 requests
    rd = dcfg.reduced()
    Dqk_r, Dv_r = rd.qk_nope_dim + rd.qk_rope_dim, rd.v_head_dim
    for i, (B, S, dt) in enumerate(((4, LM_SEQ, bf), (4, LM_SEQ, f32),
                                    (2, 130, bf), (1, 300, f32),
                                    (1, 65, bf))):
        attn_cases.append(check_attn(B, S, S, rd.n_heads, rd.n_heads, Dqk_r,
                                     dt, True, 94 + i, Dv=Dv_r))
    attn_cases.append(check_attn(2, 40, 100, 4, 2, Dqk_r, bf, False, 99,
                                 Dv=Dv_r))
    q, k, v = _attn_inputs(1, S_main, S_main, H, KV, hd, bf, 10)
    attn_cases.append(check_repeat(
        "flash_attention (1, 273, 32 x 128) causal, twice",
        lambda: fa_ops.flash_attention(q, k, v, causal=True)))
    qp, kp, vp = _attn_inputs(1, LM_PROMPT, LM_PROMPT, H_p, KV_p, hd_p, bf,
                              67)
    attn_cases.append(check_repeat(
        f"flash_attention (1, {LM_PROMPT}, {H_p} x {hd_p}) causal, twice",
        lambda: fa_ops.flash_attention(qp, kp, vp, causal=True)))
    qd, kd, vd = _attn_inputs(1, LM_PROMPT, LM_PROMPT, H_d, H_d, Dqk, bf, 93,
                              Dv=Dv)
    attn_cases.append(check_repeat(
        f"flash_attention (1, {LM_PROMPT}, {H_d} x ({Dqk}, {Dv})) causal, "
        "twice", lambda: fa_ops.flash_attention(qd, kd, vd, causal=True)))

    dec_cases = decode_cases(lcfg)
    for i, B in enumerate(LM_BATCHES):    # Zamba2's 7 sites, MHA 32 x 64
        for kv_len in (LM_PROMPT + 1, T_l):
            dec_cases.append(check_decode(B, H_z, KV_z, T_l, hd_z, kv_len, bf,
                                          320 + 2 * i + kv_len, flat=True))
    T_p = LM_PROMPT + PHI3_STEPS          # head dim 96: phi3's decode
    for kv_len in (1, 300, LM_PROMPT + 1, T_p):
        dec_cases.append(check_decode(1, H_p, KV_p, T_p, hd_p, kv_len, bf,
                                      340 + kv_len, flat=True))
    T_g = LM_PROMPT + MOE_STEPS           # granite's decode, GQA 3x
    for B in LM_BATCHES:
        for kv_len in (1, LM_PROMPT + 1, T_g):
            dec_cases.append(check_decode(B, H_g, KV_g, T_g, hd_g, kv_len, bf,
                                          350 + B + kv_len, flat=True))
    dec_cases.append(check_decode(1, H_g, KV_g, T_g, hd_g, T_g - 2, f32, 351,
                                  flat=True))
    dec_cases += [
        check_decode(1, H_p, KV_p, T_p, hd_p, T_p - 5, f32, 341, flat=True),
        check_decode(1, H_p, KV_p, T_p, hd_p, LM_PROMPT + 3, bf, 342,
                     flat=True, device_len=True),
        check_decode(2, 8, 2, 200, 96, 150, f32, 343),
        check_decode(2, 8, 2, 200, 96, 150, bf, 344),
        check_decode(1, 16, 1, 4096, 96, 4000, bf, 345),      # GQA 16x
        check_decode(1, 4, 4, 32, 96, 32, f32, 346),         # one split
    ]
    for B, h, kv, t, d in ((1, H_l, KV_l, T_l, hd_l), (4, H_l, KV_l, T_l, hd_l),
                           (1, H_l, KV_l, 8192, hd_l), (4, H_z, KV_z, T_l, hd_z),
                           (1, 32, 2, 8192, 128), (1, H_p, KV_p, T_p, hd_p)):
        q, k, v = _decode_inputs(B, h, kv, t, d, bf, 330 + B + t, flat=True)
        n = torch.tensor(t - 3, dtype=torch.int32, device=DEV)
        dec_cases.append(check_repeat(
            f"decode_attention ({B}, {h}/{kv}, {t}, {d}), kv_len {t - 3} on "
            "the card, twice",
            lambda: da_ops.decode_attention(q, k, v, n)))
    return attn_cases, dec_cases


def attn_bound(B, S, T, H, KV, D, causal, Dv=None) -> tuple:
    """The card's least time for one bf16 prefill attention: q, k, v read
    and the output written once; the two products over the (query, key)
    pairs the mask keeps (q k^T at D, p v at Dv)."""
    Dv = Dv or D
    pairs = S * (S + 1) / 2 if causal and S == T else S * T
    return bound(2 * B * (H * S * (D + Dv) + KV * T * (D + Dv)),
                 2.0 * B * H * (D + Dv) * pairs, torch.bfloat16)


def time_attn(B, S, H, KV, D, max_err, Dv=None) -> dict:
    """Times of the flash attention kernel at a served bf16 causal shape:
    the kernel, its host time, the plain version, and as the yardstick
    ``F.scaled_dot_product_attention`` on (B, H, S, D) views of the same
    tensors (grouped heads by ``enable_gqa``, a backend that takes Dv != D
    at the MLA shapes; the port calls it nowhere)."""
    q, k, v = _attn_inputs(B, S, S, H, KV, D, torch.bfloat16, 10 + B + S + D,
                           Dv=Dv)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by = attn_bound(B, S, S, H, KV, D, True, Dv)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
            "shape": [B, S, H, KV, D] + ([Dv] if Dv else []),
            "dtype": "bfloat16", "causal": True,
            "max_abs_err": max_err,
            "ms": time_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                         causal=True)),
            "host_ms": host_ms(
                lambda: fa_ops.flash_attention(q, k, v, causal=True)),
            "plain_ms": time_ms(
                lambda: fa_ops.flash_attention_plain(q, k, v, causal=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=KV != H))}


def time_decode(B, H, KV, T, D, kv_len, max_err) -> dict:
    """Times of the flash-decode kernel on a flat bf16 cache at live length
    ``kv_len``: the kernel, its host time, the plain version, and as the
    yardstick ``F.scaled_dot_product_attention`` on the same q and the live
    K/V prefix (grouped heads by ``enable_gqa``; the port calls it
    nowhere)."""
    bf = torch.bfloat16
    q, k, v = _decode_inputs(B, H, KV, T, D, bf, 400 + T, flat=True)
    q4, kl, vl = q[:, :, None], k[:, :, :kv_len], v[:, :, :kv_len]
    nbytes = 2 * (2 * B * KV * kv_len * D + 2 * B * H * D)
    b_ms, b_by = bound(nbytes, 4.0 * B * H * kv_len * D, bf)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
            "shape": [B, H, KV, T, D], "kv_len": kv_len, "dtype": "bfloat16",
            "split_plan": list(da_ops.split_plan(T, B * KV,
                                                 da_ops.sm_count(q.device))),
            "max_abs_err": max_err,
            "ms": time_ms(lambda: da_ops.decode_attention(q, k, v, kv_len)),
            "host_ms": host_ms(
                lambda: da_ops.decode_attention(q, k, v, kv_len)),
            "plain_ms": time_ms(
                lambda: da_ops.decode_attention_plain(q, k, v, kv_len)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, kl, vl, enable_gqa=KV != H))}


SERVED_KEYS = ("shape", "kv_len", "split_plan", "ms", "host_ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")


def attention_times(cfg, lcfg, zcfg, pcfg, attn_cases, dec_cases) -> dict:
    """B5 and B6 timed at every shape the main paths give them, each with
    its bound and its library time: B5 at the VLA's 273 tokens (``serve``,
    ``serve_cogact``, ``control``), ``serve_lm``'s 4 x 17, and the
    512-token prefills of Llama-3.2-3B and Zamba2-1.2B at batch 1 and 4 and
    of phi3-mini-3.8b at batch 1; B6 at ``generate``'s and
    ``generate_hybrid``'s 576-position buffers at batch 1 and 4, Llama-3.2-
    3B's heads at 8192 positions, and phi3's 528-position buffer.  The first
    shape of each heads its record; all of them are in its ``served``
    list."""
    H_l, KV_l, hd_l = lcfg.n_heads, lcfg.n_kv_heads, lcfg.resolved_head_dim
    H_z, KV_z, hd_z = zcfg.n_heads, zcfg.n_kv_heads, zcfg.resolved_head_dim
    T_l = LM_PROMPT + LM_STEPS
    attn_err = max(c["max_err"] for c in attn_cases
                   if c.get("dtype") == "bfloat16")
    served = [time_attn(1, cfg.n_patches + 17, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, attn_err),
              time_attn(LM_MICRO_BATCH, LM_SEQ, H_l, KV_l, hd_l, attn_err)]
    served += [time_attn(B, LM_PROMPT, h, kv, d, attn_err)
               for h, kv, d in ((H_l, KV_l, hd_l), (H_z, KV_z, hd_z))
               for B in LM_BATCHES]
    H_p, KV_p, hd_p = pcfg.n_heads, pcfg.n_kv_heads, pcfg.resolved_head_dim
    served.append(time_attn(1, LM_PROMPT, H_p, KV_p, hd_p, attn_err))
    gcfg, dcfg = get_config(GRANITE), get_config(DEEPSEEK)
    H_g, KV_g, hd_g = gcfg.n_heads, gcfg.n_kv_heads, gcfg.resolved_head_dim
    served += [time_attn(B, LM_PROMPT, H_g, KV_g, hd_g, attn_err)
               for B in LM_BATCHES]
    served += [time_attn(B, LM_PROMPT, dcfg.n_heads, dcfg.n_heads,
                         dcfg.qk_nope_dim + dcfg.qk_rope_dim, attn_err,
                         Dv=dcfg.v_head_dim) for B in LM_BATCHES]
    rec = {"flash_attention": dict(served[0])}
    rec["flash_attention"]["served"] = [
        {k: r[k] for k in SERVED_KEYS if k in r} for r in served]
    # blocks of the bf16 kernel one SM holds, by (D, Dv), from
    # cudaOccupancyMaxActiveBlocksPerMultiprocessor
    rec["flash_attention"]["blocks_per_sm"] = {
        f"{d},{dv}": fa_ops.occupancy(d, dv) for d, dv in fa_ops.HEAD_DIM_PAIRS}
    dec_err = max(c["max_err"] for c in dec_cases
                  if c.get("dtype") == "bfloat16")
    served = [time_decode(B, h, kv, T_l, d, T_l, dec_err)
              for h, kv, d in ((H_l, KV_l, hd_l), (H_z, KV_z, hd_z))
              for B in LM_BATCHES]
    served.append(time_decode(1, H_l, KV_l, 8192, hd_l, 8192, dec_err))
    T_p = LM_PROMPT + PHI3_STEPS
    served.append(time_decode(1, H_p, KV_p, T_p, hd_p, T_p, dec_err))
    T_g = LM_PROMPT + MOE_STEPS
    served += [time_decode(B, H_g, KV_g, T_g, hd_g, T_g, dec_err)
               for B in LM_BATCHES]
    rec["decode_attention"] = dict(served[0])
    rec["decode_attention"]["served"] = [
        {k: r[k] for k in SERVED_KEYS if k in r} for r in served]
    return rec


def _ssd_inputs(B, T, H, P, N, dtype, seed, a_init=False):
    """The distribution of tests/test_kernels.py: x * 0.5, dt =
    softplus(normal), A = -exp(0.3 normal) (or -1, as ``A_log``'s zero
    init gives), B and C * 0.3; x, B, C in ``dtype``, dt and A float32."""
    g = gen(seed)

    def draw(shape):
        return torch.randn(shape, generator=g, device=DEV,
                           dtype=torch.float32)

    x = (draw((B, T, H, P)) * 0.5).to(dtype)
    dt = F.softplus(draw((B, T, H)))
    A = -torch.ones(H, device=DEV) if a_init else -torch.exp(draw((H,)) * 0.3)
    Bm = (draw((B, T, N)) * 0.3).to(dtype)
    Cm = (draw((B, T, N)) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


# B7 limits, stated before the first run on the card.  float32: the
# reference's 2e-5 (tests/test_kernels.py), scaled by the largest value
# where it passes 1.  bf16 inputs: against the plain version fed the same
# inputs upcast, y within two bf16 rounding units (2 * 2^-8) of the largest
# |y| (the kernel rounds y once) and the float32 state as in float32;
# against the plain version in bf16 (which rounds xdt, the scores and the
# chunk states to bf16), 3e-2 of the largest value.
SSD_F32_TOL = 2e-5
SSD_BF16_Y_REL = 2 * 2.0 ** -8
SSD_BF16_PLAIN_REL = 3e-2


def _err_and_max(got, want) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    return err, want.float().abs().max().item()


def _ssd_plan(B, T, H, P, N, chunk) -> dict:
    """How the scan being driven cuts this call: its ``launch_plan``, or,
    for an earlier design (``--src``), its column tile."""
    if hasattr(ssd_ops, "launch_plan"):
        return ssd_ops.launch_plan(B, T, H, P, N, chunk)._asdict()
    return {"p_tile": ssd_ops.p_tile(P, B * H, ssd_ops.sm_count(
        torch.device(DEV, torch.cuda.current_device())))}


def check_ssd(B, T, H, P, N, chunk, dtype, seed, a_init=False) -> dict:
    x, dt, A, Bm, Cm = _ssd_inputs(B, T, H, P, N, dtype, seed, a_init)
    y, s = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y32, s32 = ssd_ops.ssd_scan_plain(x.float(), dt, A, Bm.float(),
                                      Cm.float(), chunk)
    torch.cuda.synchronize()
    if tuple(y.shape) != (B, T, H, P) or y.dtype != dtype \
            or tuple(s.shape) != (B, H, N, P) or s.dtype != torch.float32:
        raise AssertionError(f"ssd_scan: wrong output {tuple(y.shape)} "
                             f"{y.dtype} {tuple(s.shape)} {s.dtype}")
    if not (torch.isfinite(y.float()).all() and torch.isfinite(s).all()):
        raise AssertionError("ssd_scan: output is not finite")
    y_err, y_max = _err_and_max(y, y32)
    s_err, s_max = _err_and_max(s, s32)
    case = {"B": B, "T": T, "H": H, "P": P, "N": N, "chunk": chunk,
            "dtype": str(dtype).split(".")[-1], "A_minus_one": a_init,
            "plan": _ssd_plan(B, T, H, P, N, chunk),
            "y_max_err_vs_f32": y_err, "y_max_abs": y_max,
            "state_max_err_vs_f32": s_err, "state_max_abs": s_max,
            "state_tol": SSD_F32_TOL * max(1.0, s_max),
            "max_err": max(y_err, s_err)}
    ok = s_err <= case["state_tol"]
    if dtype == torch.float32:
        case["y_tol"] = SSD_F32_TOL * max(1.0, y_max)
        ok = ok and y_err <= case["y_tol"]
    else:
        case["y_tol"] = SSD_BF16_Y_REL * y_max
        yb, sb = ssd_ops.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
        yb_err, yb_max = _err_and_max(y, yb)
        sb_err, sb_max = _err_and_max(s, sb)
        case.update({"y_max_err_vs_plain_bf16": yb_err,
                     "state_max_err_vs_plain_bf16": sb_err,
                     "y_tol_vs_plain_bf16": SSD_BF16_PLAIN_REL * yb_max,
                     "state_tol_vs_plain_bf16": SSD_BF16_PLAIN_REL * sb_max})
        ok = (ok and y_err <= case["y_tol"]
              and yb_err <= case["y_tol_vs_plain_bf16"]
              and sb_err <= case["state_tol_vs_plain_bf16"])
    if not ok:
        raise AssertionError(f"ssd_scan disagrees with its plain version: "
                             f"{case}")
    return case


def check_ssd_recurrence() -> dict:
    """tests/test_kernels.py::test_ssd_state_equals_sequential on the card:
    (1, 48, 2, 8, 16) at chunk 16, y and the final state against the
    per-token recurrence ``ssd_step``, 1e-4."""
    B, T, H, P, N = 1, 48, 2, 8, 16
    x, dt, A, Bm, Cm = _ssd_inputs(B, T, H, P, N, torch.float32, 90)
    y, s = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    S = torch.zeros((B, H, N, P), device=DEV)
    ys = []
    for t in range(T):
        yt, S = ssd_step(S, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(yt)
    y_err = (y - torch.stack(ys, 1)).abs().max().item()
    s_err = (s - S).abs().max().item()
    case = {"B": B, "T": T, "H": H, "P": P, "N": N, "chunk": 16,
            "dtype": "float32", "against": "ssd_step recurrence",
            "y_max_err": y_err, "state_max_err": s_err, "tol": 1e-4,
            "max_err": max(y_err, s_err)}
    if max(y_err, s_err) > 1e-4:
        raise AssertionError(f"ssd_scan disagrees with the recurrence: "
                             f"{case}")
    return case


def ssd_cases(mcfg, zcfg) -> list:
    """B7 cases: the reference's sweep, the recurrence, the served shapes
    of Mamba2-1.3B and Zamba2-1.2B (prompt ``LM_PROMPT``, batch 1 and 4) in
    float32 and bf16, a ragged and a short prompt, the reduced widths."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [check_ssd(*shape, f32, 500 + i) for i, shape in enumerate((
        (2, 128, 3, 16, 32, 32), (1, 256, 2, 32, 16, 64),
        (1, 64, 1, 8, 8, 64)))]                      # tests/test_kernels.py
    cases.append(check_ssd_recurrence())
    seed = 510
    for cfg in (mcfg, zcfg):
        H, P, N, Q = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                      cfg.ssm_chunk)
        for B in LM_BATCHES:
            for dt in (f32, bf):
                seed += 1
                cases.append(check_ssd(B, LM_PROMPT, H, P, N, Q, dt, seed))
        for T in (300, 17):                          # ragged, T < chunk
            for dt in (f32, bf):
                seed += 1
                cases.append(check_ssd(1, T, H, P, N, Q, dt, seed))
    H, P, N, Q = (mcfg.ssm_nheads, mcfg.ssm_headdim, mcfg.ssm_state,
                  mcfg.ssm_chunk)
    cases.append(check_ssd(1, LM_PROMPT, H, P, N, Q, bf, 530, a_init=True))
    r = mcfg.reduced()
    cases.append(check_ssd(2, 70, r.ssm_nheads, r.ssm_headdim, r.ssm_state,
                           r.ssm_chunk, f32, 531))      # N = P = 16, chunk 32
    return cases


def ssd_bound(B, T, H, P, N, chunk, dtype) -> tuple:
    """The card's least time for one scan: each input read and each output
    written once; the multiply-adds of the four products in their least
    form (C B^T once per batch row and chunk and only its lower triangle,
    the intra-chunk product lower-triangular), at the inputs' type's peak."""
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * T * H * P * es + B * H * N * P * 4 + 2 * B * T * N * es
              + B * T * H * 4 + H * 4)
    macs = 0
    for c0 in range(0, T, chunk):
        q = min(chunk, T - c0)
        tri = q * (q + 1) // 2
        macs += B * tri * N + B * H * (tri * P + 2 * q * N * P)
    return bound(nbytes, 2.0 * macs, dtype) + (nbytes, 2.0 * macs)


def time_ssd(B, T, H, P, N, chunk, max_err) -> dict:
    """Times of the SSD scan kernel in bf16 at a served shape: the kernel,
    its host time and the plain version; no single PyTorch call computes
    the scan, so there is no library time."""
    bf = torch.bfloat16
    x, dt, A, Bm, Cm = _ssd_inputs(B, T, H, P, N, bf, 600 + B + N)
    b_ms, b_by, nbytes, flops = ssd_bound(B, T, H, P, N, chunk, bf)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:74",
            "shape": [B, T, H, P, N], "chunk": chunk, "dtype": "bfloat16",
            "plan": _ssd_plan(B, T, H, P, N, chunk),
            "max_abs_err": max_err,
            "ms": time_ms(lambda: ssd_ops.ssd_scan(x, dt, A, Bm, Cm,
                                                   chunk=chunk)),
            "host_ms": host_ms(lambda: ssd_ops.ssd_scan(x, dt, A, Bm, Cm,
                                                        chunk=chunk)),
            "plain_ms": time_ms(lambda: ssd_ops.ssd_scan_plain(
                x, dt, A, Bm, Cm, chunk), warmup=2, reps=5, inner=2),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops, "library_ms": None}


def phase_ssd(mcfg, zcfg) -> dict:
    """``--ssd-only``: B7 alone — every case against the plain versions,
    the times at the four served shapes (Mamba2-1.3B and Zamba2-1.2B at
    batch 1 and 4)."""
    cases = ssd_cases(mcfg, zcfg)
    err = max(c.get("max_err", 0.0) for c in cases)
    info = {"phase": "ssd", "src": _src_dir(), "ssd_cases": cases,
            "times": [time_ssd(B, LM_PROMPT, c.ssm_nheads, c.ssm_headdim,
                               c.ssm_state, c.ssm_chunk, err)
                      for c in (mcfg, zcfg) for B in LM_BATCHES]}
    emit(info)
    return info


CODEC_SOURCE = "src/repro_torch/kernels/csrc/activation_codec.cu"
CODEC_REPLACES = {"quantize_int8": 48, "dequantize_int8": 71,
                  "quantize_int4": 113, "dequantize_int4": 137}


def codec_cases(cfg, lcfg) -> tuple:
    """Every int8 (B1/B2) and int4 (B3/B4) case, each held bit-equal to the
    plain version: the main paths' shapes (``cfg`` the served VLA, ``lcfg``
    Llama-3.2-3B) and awkward ones.  The int8 ``non_finite`` cases hold
    what this checkout's kernel source states for NaN and Inf, so they run
    only on this checkout's ``repro_torch`` (not under ``--src``)."""
    S_main = cfg.n_patches + 17
    d, d_l = cfg.d_model, lcfg.d_model
    bf, f32 = torch.bfloat16, torch.float32
    codec8 = [
        check_codec((1, S_main, d), bf, 1),           # uplink, main path
        check_codec((1, cfg.action_dim, d), bf, 2),   # two-pool downlink
        check_codec((1, S_main, d), f32, 3),
        check_codec((1, d), bf, 4),                   # one row
        check_codec((5, 128), f32, 5),                # D = one block
        check_codec((5, 128), bf, 6),
        check_codec((2, 17, 256), bf, 7),
        check_codec((LM_MICRO_BATCH, LM_SEQ, d_l), bf, 8),   # serve_lm cut
        check_codec((LM_MICRO_BATCH, LM_SEQ, d_l), f32, 9),
        # one block a row at the reduced d_model = 64 (serve_cli), and a
        # width no multiple of 4 (scalar loads and stores)
        check_codec((LM_MICRO_BATCH, LM_SEQ, 64), bf, 10, 64),
        check_codec((17, 64), bf, 11, 64),
        check_codec((S_main, 64), bf, 12, 64),
        check_codec((S_main, 64), f32, 13, 64),
        check_codec((5, 100), f32, 14, 100),
        check_codec((3, 7, 100), bf, 15, 100),
    ]
    for dt, seed in ((bf, 16), (f32, 26)):
        codec8 += [
            check_codec((1, S_main, d), dt, seed, case="ties"),
            # quotients at and next to half-integers (the rounding's slow
            # path), at the 128-column block and in the general kernels
            check_codec((1, S_main, d), dt, seed + 1, case="near_ties"),
            check_codec((S_main, 64), dt, seed + 2, 64, "near_ties"),
            check_codec((37, 1000), dt, seed + 3, 100, "near_ties"),
            check_codec((37, 1000), dt, seed + 4, 100, "ties"),
            # scales below FLT_MIN (the whole block divides), subnormal inputs
            check_codec((1, S_main, d), dt, seed + 5, case="sub_flt_min"),
            check_codec((S_main, 64), dt, seed + 6, 64, "sub_flt_min"),
            # many rows: 139 776 blocks, more than the card holds at once
            check_codec((16, S_main, d), dt, seed + 7),
            # a block count that fills no whole thread block (37 x 6 blocks)
            check_codec((37, 768), dt, seed + 8),
        ]
        if _src_dir() == _OWN_SRC:      # this checkout's kernels' statement
            codec8.append(check_codec((3, 7, 1000), dt, seed + 9, 100,
                                      "non_finite"))
            codec8.append(check_codec((1, S_main, d), dt, seed + 9,
                                      case="non_finite"))
    codec4 = [
        check_codec4((1, S_main, d), bf, 40),         # uplink, main path
        check_codec4((1, S_main, d), f32, 41),
        check_codec4((1, 1, d), bf, 42),              # two-pool downlink
        check_codec4((1, d), f32, 43),                # one row
        check_codec4((5, 256), bf, 44),               # D = one tile
        check_codec4((5, 256), f32, 45),
        check_codec4((3, 512), bf, 46, "zero_hi"),
        check_codec4((1, S_main, d), bf, 47, "ties"),
        check_codec4((4, 512), f32, 48, "ties"),
        # quotients at and next to half-integers (the rounding's slow path)
        check_codec4((1, S_main, d), bf, 49, "near_ties"),
        check_codec4((1, S_main, d), f32, 50, "near_ties"),
        # scales below FLT_MIN (the whole block divides), subnormal inputs
        check_codec4((1, S_main, d), bf, 51, "sub_flt_min"),
        check_codec4((1, S_main, d), f32, 52, "sub_flt_min"),
        # many rows: 8 736 blocks, more than the card holds at once
        check_codec4((16, S_main, d), bf, 53),
        check_codec4((16, S_main, d), f32, 54),
        # a tile count that fills no whole thread block (37 x 3 tiles)
        check_codec4((37, 768), bf, 55),
        check_codec4((37, 768), f32, 56),
    ]
    return codec8, codec4


def _codec_bytes(name, n, block=128) -> tuple:
    """(bytes, operations) of one call on ``n`` bfloat16 elements: each
    input read once and each output written once."""
    return {"quantize_int8": (n * 2 + n + n // block * 4, 6 * n),
            "dequantize_int8": (n + n // block * 4 + n * 2, 2 * n),
            "quantize_int4": (n * 2 + n // 2 + n // 128 * 4, 6 * n),
            "dequantize_int4": (n // 2 + n // 128 * 4 + n * 2, 4 * n)}[name]


def _codec_call(name, x, block=128) -> tuple:
    """(the call, its plain version, its input) of one codec kernel on
    ``x`` (bfloat16), the dequantising ones on ``x`` quantised."""
    bf = torch.bfloat16
    if name == "quantize_int8":
        return (lambda: codec_ops.quantize(x, block),
                lambda: codec_ops.quantize_plain(x, block), x)
    if name == "quantize_int4":
        return (lambda: codec_ops.quantize_int4(x),
                lambda: codec_ops.quantize_int4_plain(x), x)
    if name == "dequantize_int8":
        q, s = codec_ops.quantize(x, block)
        return (lambda: codec_ops.dequantize(q, s, bf, block),
                lambda: codec_ops.dequantize_plain(q, s, bf, block), q)
    p, s = codec_ops.quantize_int4(x)
    return (lambda: codec_ops.dequantize_int4(p, s, bf),
            lambda: codec_ops.dequantize_int4_plain(p, s, bf), p)


def _time_codec(name, shape, floor_ms, behind=False, block=128) -> dict:
    """Device, host and plain times of one codec kernel on bfloat16 at
    ``shape`` (int8 at ``block`` columns), with its bound and the launch
    floor measured beside it.  ``behind``: also the device time the call
    adds behind a PyTorch elementwise kernel that rewrites its input in
    place (as the served path runs it, after the layer that wrote the
    activation): time(elementwise, then the call) - time(elementwise)."""
    x = _codec_input(shape, torch.bfloat16, 1)
    fn, plain, inp = _codec_call(name, x, block)
    nbytes, ops = _codec_bytes(name, x.numel(), block)
    b_ms, b_by = bound(nbytes, ops, torch.float32)
    rec = {"shape": list(shape), "dtype": "bfloat16", "ms": time_ms(fn),
           **host_times(fn), "plain_ms": time_ms(plain),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "launch_floor_ms": floor_ms, "library_ms": None}
    if block != 128:
        rec["block"] = block
    if behind:
        pre = lambda: inp.add_(0)                          # noqa: E731
        pre_ms = time_ms(pre)
        rec["elementwise_ms"] = pre_ms
        rec["ms_behind_elementwise"] = time_ms(lambda: (pre(), fn())) - pre_ms
    return rec


def division_cost(name, shape) -> dict:
    """What the rounding's division costs a quantise kernel
    (int8 or int4) on bfloat16 at ``shape``, back to back: its time on
    inputs where no element divides (``integers``), on the served random
    input, and where every element but each block's abs-max divides
    (``ties``); and the share of the random input's elements, and of its
    warps (blocks, int8; tiles, int4), that divide, computed here from the
    kernel's rule (a product RN(x * RN(1/s)) within the margin of a
    half-integer)."""
    qmax, margin, width = ((127, 2.0 ** -15, 128) if name.endswith("int8")
                           else (7, 2.0 ** -18, 256))
    rec = {"shape": list(shape), "dtype": "bfloat16"}
    for case in ("integers", "zero_lo", "ties"):
        x = _codec_input(shape, torch.bfloat16, 1, case, qmax)
        rec[f"{case}_ms"] = time_ms(_codec_call(name, x)[0])
    x = _codec_input(shape, torch.bfloat16, 1, "zero_lo", qmax)
    s = _plain_scales(x, qmax)
    y = x.float().reshape(*x.shape[:-1], -1, 128) * (1.0 / s[..., None])
    near = ((y - torch.round(y)).abs() >= 0.5 - margin).reshape(-1, width)
    rec["random_element_share"] = near.float().mean().item()
    rec["random_warp_share"] = near.any(-1).float().mean().item()
    return rec


def codec_host_breakdown(shape) -> dict:
    """Host time (µs) to issue each piece of one int4 call at ``shape``,
    bfloat16, each piece alone in a loop: the wrappers whole, the output
    allocations, the stream and device queries, the input's contiguity and
    alignment check, the dtype's code, the pointers, the C entry refused at
    once (the ``ctypes`` call alone) and taken (a launch), the launch check,
    and PyTorch's own launch of an empty kernel beside them."""
    bf = torch.bfloat16
    x = _codec_input(shape, bf, 1)
    p, s = codec_ops.quantize_int4(x)
    lib = _build.lib()
    n_tiles, stream = x.numel() // 256, torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), p.data_ptr(), s.data_ptr())
    pieces = {
        "quantize_int4": lambda: codec_ops.quantize_int4(x),
        "dequantize_int4": lambda: codec_ops.dequantize_int4(p, s, bf),
        "torch_empty_payload": lambda: torch.empty(p.shape, dtype=torch.int8,
                                                   device=x.device),
        "torch_empty_scales": lambda: torch.empty(s.shape,
                                                  dtype=torch.float32,
                                                  device=x.device),
        "new_empty_payload": lambda: x.new_empty(p.shape, dtype=torch.int8),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_device": torch.cuda.current_device,
        "contiguous_and_alignment": lambda: x.contiguous().data_ptr() % 16,
        "dtype_code_by_str": lambda: _build.DTYPE_CODES[
            str(x.dtype).split(".")[-1]],
        "data_ptr_x3": lambda: (x.data_ptr(), p.data_ptr(), s.data_ptr()),
        "ctypes_refused": lambda: lib.rt_quantize_int4(0, 0, 0, 0, 1, 0),
        "ctypes_and_launch": lambda: lib.rt_quantize_int4(*ptrs, n_tiles, 1,
                                                          stream),
        "check_launch": lambda: _build.check_launch("quantize_int4", 0),
        "torch_cuda_sleep_0": lambda: torch.cuda._sleep(0),
    }
    times = {k: host_times(fn) for k, fn in pieces.items()}
    return {stat: {k: t[key] * 1e3 for k, t in times.items()}
            for stat, key in (("median", "host_ms"),
                              ("least", "host_ms_least"))}


def codec_times(cfg, lcfg, codec8, codec4) -> dict:
    """The four codec kernels at the main path's shape (273 rows of the
    served VLA's width), bfloat16, each beside the launch floor: the device
    time per call of an empty kernel (``torch.cuda._sleep(0)``) queued the
    same way.  Also at the other served shapes: B1/B2 at the two-pool
    downlink (the action rows), ``serve_lm``'s cut (4 x 17 rows of
    Llama-3.2-3B), ``serve_cli``'s 4 x 17 rows of 64 columns at block 64,
    and 16 x 273 rows; B3/B4 at the two-pool downlink's one row and at
    16 x 273 rows.  The quantise kernels add what their division costs
    (``division_cost``)."""
    S_main, d = cfg.n_patches + 17, cfg.d_model
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    rec = {}
    for name in ("quantize_int8", "dequantize_int8", "quantize_int4",
                 "dequantize_int4"):
        key = name.split("_")[0] + "_max_err"
        cases = codec8 if name.endswith("int8") else codec4
        served = [_time_codec(name, (1, S_main, d), floor_ms, behind=True)]
        if name.endswith("int8"):
            served += [
                _time_codec(name, (1, cfg.action_dim, d), floor_ms),
                _time_codec(name, (LM_MICRO_BATCH, LM_SEQ, lcfg.d_model),
                            floor_ms),
                _time_codec(name, (LM_MICRO_BATCH, LM_SEQ, 64), floor_ms,
                            block=64),
                _time_codec(name, (16, S_main, d), floor_ms)]
        else:
            served += [_time_codec(name, (1, 1, d), floor_ms),
                       _time_codec(name, (16, S_main, d), floor_ms)]
        rec[name] = {"route": "cuda", "source": CODEC_SOURCE,
                     "replaces": "src/repro/kernels/activation_codec/"
                                 f"kernel.py:{CODEC_REPLACES[name]}",
                     **served[0],
                     "max_abs_err": max(c[key] for c in cases),
                     "served": served}
        if name.startswith("quantize"):
            rec[name]["division"] = division_cost(name, (1, S_main, d))
    return rec


def phase_codec(cfg, lcfg) -> dict:
    """``--codec-only``: B1-B4 alone — every int8 and int4 case against the
    plain versions, the times at the served shapes with the launch floor
    and the division's cost, and where the host time of an int4 call
    goes."""
    codec8, codec4 = codec_cases(cfg, lcfg)
    rec = codec_times(cfg, lcfg, codec8, codec4)
    info = {"phase": "codec", "src": _src_dir(), "codec_cases": codec8,
            "codec4_cases": codec4, "times": rec,
            "host_breakdown_us": codec_host_breakdown(
                (1, cfg.n_patches + 17, cfg.d_model))}
    emit(info)
    return info


def phase_kernels(cfg, lcfg, mcfg, zcfg, pcfg) -> dict:
    """Every kernel against its plain version, at the shapes the main paths
    give it (``cfg`` the served VLA, ``lcfg`` Llama-3.2-3B, ``mcfg``
    Mamba2-1.3B, ``zcfg`` Zamba2-1.2B, ``pcfg`` phi3-mini-3.8b) and at
    awkward ones, then times at the main path's shapes.  Returns the
    per-kernel records for the summary line."""
    codec8, codec4 = codec_cases(cfg, lcfg)
    attn_cases, dec_cases = attention_cases(cfg, lcfg, zcfg, pcfg)
    ssd = ssd_cases(mcfg, zcfg)

    # ---- times at the main path's shapes
    rec = codec_times(cfg, lcfg, codec8, codec4)
    rec.update(attention_times(cfg, lcfg, zcfg, pcfg, attn_cases,
                               dec_cases))
    # Mamba2-1.3B's scan at batch 1 heads the summary; the other served
    # shapes (batch 4, Zamba2's N = 64) beside it
    ssd_err = max(c.get("max_err", 0.0) for c in ssd)
    served = [time_ssd(B, LM_PROMPT, c.ssm_nheads, c.ssm_headdim,
                       c.ssm_state, c.ssm_chunk, ssd_err)
              for c in (mcfg, zcfg) for B in LM_BATCHES]
    rec["ssd_scan"] = dict(served[0])
    rec["ssd_scan"]["served"] = [
        {k: v for k, v in r.items() if k in (
            "shape", "plan", "ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "bytes", "flops", "library_ms")} for r in served]
    emit({"phase": "kernels",
          "tolerances": {"quantize_int8": "bit-equal",
                         "dequantize_int8": "bit-equal",
                         "quantize_int4": "bit-equal",
                         "dequantize_int4": "bit-equal",
                         "flash_attention": {"float32": 2e-5,
                                             "bfloat16": 2e-2,
                                             "twice": "bit-equal"},
                         "decode_attention": {"float32": 1e-5,
                                              "bfloat16": 2e-2,
                                              "twice": "bit-equal"},
                         "ssd_scan": {
                             "float32": f"{SSD_F32_TOL} x max(1, max|ref|)",
                             "recurrence": 1e-4,
                             "bfloat16_vs_f32": f"y {SSD_BF16_Y_REL} x max|y|"
                                                f", state as float32",
                             "bfloat16_vs_plain_bf16":
                                 f"{SSD_BF16_PLAIN_REL} x max|ref|"}},
          "timing": "device time: CUDA events, median of 20 x 10 calls "
                    "queued behind other work; host_ms: time to issue a "
                    "call, the median of 5 runs of 200 (host_ms_least, "
                    "codec rows: the least run)",
          "codec_cases": codec8, "codec4_cases": codec4,
          "attention_cases": attn_cases,
          "decode_cases": dec_cases,
          "ssd_cases": ssd,
          "at_main_shapes": rec})
    return rec


# =================================================================== serve
WRAPPERS = {"quantize_int8": codec_ops.quantize,
            "dequantize_int8": codec_ops.dequantize,
            "quantize_int4": codec_ops.quantize_int4,
            "dequantize_int4": codec_ops.dequantize_int4,
            "flash_attention": fa_ops.flash_attention,
            "decode_attention": da_ops.decode_attention,
            "ssd_scan": ssd_ops.ssd_scan}


# CUDA kernels one counted launch queues: the SSD scan's C entry queues
# the chunk-state and the output kernel (checked on a profiled prefill in
# ``_generate_at``); every other wrapper launches one kernel
KERNELS_PER_LAUNCH = {"ssd_scan": 2}


def _counts() -> dict:
    return {k: w.launches for k, w in WRAPPERS.items()}


def _reset_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def _want(n_llm: int, codec: str = "", codec2: str = "",
          decode: int = 0, ssd: int = 0) -> dict:
    """Launches one request makes: one flash attention per LLM block, one
    quantise and one dequantise per leg that ships through a codec,
    ``decode`` flash-decode and ``ssd`` SSD scan launches."""
    want = dict.fromkeys(WRAPPERS, 0)
    want["flash_attention"] = n_llm
    want["decode_attention"] = decode
    want["ssd_scan"] = ssd
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
    if cfg.vla_action_head == "detok" and (action.min().item() < -1.0
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
    out["llama3.2-3b"] = small_decode_check()
    return out


def _plain_decode_attention(q, k, v, kv_len):
    return da_ops.decode_attention_plain(q[:, 0] if q.dim() == 4 else q,
                                         k, v, kv_len)


def small_decode_check() -> dict:
    """Llama-3.2-3B reduced, float32, GQA switched on (the stock reduced
    config has as many KV heads as query heads): prefill plus decode on the
    card against the full forward (2e-3, tests/test_decode_equivalence.py),
    the decode logits with B6 against those with the plain decode attention
    on the same card (1e-5), and the split executor at d_model 256 with the
    int8 codec on the card against the one on the CPU."""
    cfg = get_config("llama3.2-3b").reduced().replace(n_kv_heads=2,
                                                      dtype="float32")
    model = build(cfg)
    params = model.init(gen(SEED + 40), DEV)
    B, P, T = 2, 5, 12
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen(SEED + 41),
                           device=DEV)
    h, _ = lm_hidden(cfg, params, tokens)
    full = lm_logits(cfg, params, h)

    def decode_all():
        logits, cache = prefill_and_pad(model, params,
                                        {"tokens": tokens[:, :P]}, T)
        steps = [logits[:, 0]]
        for i in range(P, T):
            logits, cache = model.decode(params, cache, tokens[:, i:i + 1], i)
            steps.append(logits[:, 0])
        return torch.stack(steps, 1)                  # positions P-1 .. T-1

    before = da_ops.decode_attention.launches
    with_kernel = decode_all()
    if da_ops.decode_attention.launches - before != cfg.n_layers * (T - P):
        raise AssertionError("reduced decode did not launch B6 per layer "
                             "and step")
    da_ops.decode_attention = _plain_decode_attention     # swapped, then back
    with_plain = decode_all()
    da_ops.decode_attention = WRAPPERS["decode_attention"]
    full_err = (with_kernel - full[:, P - 1:]).abs().max().item()
    plain_err = (with_kernel - with_plain).abs().max().item()
    if full_err > 2e-3:
        raise AssertionError(f"reduced prefill + decode is {full_err} from "
                             "the full forward (limit 2e-3)")
    if plain_err > 1e-5:
        raise AssertionError(f"reduced decode logits with B6 are {plain_err} "
                             "from those with the plain version (limit 1e-5)")

    cfg2 = get_config("llama3.2-3b").reduced().replace(
        n_layers=4, n_kv_heads=2, d_model=256, dtype="float32")
    params2 = build(cfg2).init(gen(SEED + 42), DEV)
    params2_cpu = tree_map(lambda t: t.cpu(), params2)
    tok2 = torch.randint(0, cfg2.vocab_size, (B, 17), generator=gen(SEED + 43),
                         device=DEV)
    ex_err, card = {}, {}
    for codec in ("", "int8"):
        plan = SplitPlan(1, 3, codec=codec)
        card[codec], pc = LMSplitExecutor(cfg2, plan).run(params2, tok2, 2)
        lh, ph = LMSplitExecutor(cfg2, plan, device="cpu").run(
            params2_cpu, tok2.cpu(), 2)
        ex_err[codec or "raw"] = (card[codec].cpu() - lh).abs().max().item()
        if payload_bytes(pc) != payload_bytes(ph):
            raise AssertionError("reduced LM payload bytes differ card/CPU")
    if ex_err["raw"] > 2e-4:
        raise AssertionError(f"reduced LM executor on the card is "
                             f"{ex_err['raw']} from the CPU's (limit 2e-4)")
    rel = ((card["int8"] - card[""]).abs().max()
           / card[""].abs().max()).item()
    if rel > 0.05:            # tests/test_runtime.py's bound for the codec
        raise AssertionError(f"reduced LM int8 logits {rel} relative from "
                             "the raw ones (limit 0.05)")
    return {"decode_vs_full_forward_max_err": full_err,
            "decode_b6_vs_plain_max_err": plain_err,
            "logits_max_abs": with_plain.abs().max().item(),
            "executor_card_vs_cpu_max_err": ex_err,
            "executor_int8_rel_err": rel}


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
        ours = re.search(r"(flash_attention_\w+?|decode_attention_\w+?"
                         r"|decode_(?:split|combine)|\w*quantize_int[48]\w*?"
                         r"|ssd_\w+?)_kernel", key)
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


def setup_openvla(cfg) -> dict:
    """OpenVLA-7B's parameters on the card, shared by ``serve`` and
    ``delta``."""
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(gen(SEED), DEV)
    torch.cuda.synchronize()
    return {"cfg": cfg, "params": params,
            "init_s": time.perf_counter() - t0,
            "held_before": held_before,
            "peak_init": torch.cuda.max_memory_allocated(),
            "n_params": sum(t.numel() for t in tree_leaves(params))}


def _span_checks(rec, n_before: int, wall_ms: float) -> list:
    """The two spans one traced request adds: edge then cloud, on the
    executor lanes, adjacent, together within the request's wall."""
    groups = rec.spans.items[n_before:]
    if len(groups) != 2 or any(len(g) != 1 for g in groups):
        raise AssertionError(f"a traced request added {groups}")
    (e,), (c,) = groups
    if (e.name, e.lane, c.name, c.lane) != ("edge_fwd", "executor:edge",
                                            "cloud_fwd", "executor:cloud") \
            or {e.cat, c.cat} != {"executor"}:
        raise AssertionError(f"executor spans {e}, {c}")
    if not (e.dur_s >= 0.0 and c.dur_s >= 0.0 and c.t0_s >= e.t0_s
            and abs(c.t0_s - (e.t0_s + e.dur_s)) <= 1e-9
            and (e.dur_s + c.dur_s) * 1e3 <= wall_ms):
        raise AssertionError(f"edge {e.dur_s} s + cloud {c.dur_s} s against "
                             f"a request wall of {wall_ms} ms")
    return [e.dur_s * 1e3, c.dur_s * 1e3]


def _same_payload(a: dict, b: dict) -> bool:
    """Byte equality of two payloads: tensors, a delta frame's numpy mask,
    and the two legs of a two-pool run."""
    def same(u, v):
        if isinstance(u, dict):
            return _same_payload(u, v)
        if isinstance(u, np.ndarray):
            return isinstance(v, np.ndarray) and u.dtype == v.dtype \
                and np.array_equal(u, v)
        return torch.equal(u, v)
    return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)


def phase_serve(st: dict, n_requests: int = 8) -> dict:
    cfg, params = st["cfg"], st["params"]
    held_before, init_s = st["held_before"], st["init_s"]
    peak_init, n_params = st["peak_init"], st["n_params"]

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
    walls, untraced = [], []
    _reset_counts()
    for (patches, tokens), cut in zip(requests, cuts):
        before = _counts()
        ms, (action, payload) = _wall_ms(
            lambda: ex.run(params, patches, tokens, cut))
        walls.append(ms)
        moved = _moved(before)
        untraced.append((action, payload, moved))
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

    # ---- executor spans: 4 of the requests and the two-pool one again, with
    # a flight recorder; the same actions, payloads and launches as without
    rec = FlightRecorder(mode="full")
    traced = [(ex, requests[i], cuts[i], untraced[i]) for i in range(4)]
    traced.append((ex2, (patches, tokens), cut, (a2, pay2, moved2)))
    span_ms, traced_walls = [], []
    for exr, (p_i, t_i), c_i, (a_i, pay_i, moved_i) in traced:
        n_before = len(rec.spans.items)
        before = _counts()
        ms, (a_t, pay_t) = _wall_ms(
            lambda: exr.run(params, p_i, t_i, c_i, recorder=rec))
        if _moved(before) != moved_i or not torch.equal(a_t, a_i) \
                or not _same_payload(pay_t, pay_i):
            raise AssertionError("a traced request differs from the same "
                                 "request without a recorder")
        span_ms.append(_span_checks(rec, n_before, ms))
        traced_walls.append(ms)
    trace_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "serve_executor.trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    with open(export_chrome_trace(rec, trace_path)) as f:
        loaded = json.load(f)
    spans_x = [e for e in loaded["traceEvents"] if e["ph"] == "X"]
    if loaded != json.loads(json.dumps(chrome_trace(rec))) \
            or [e["name"] for e in spans_x] != ["edge_fwd", "cloud_fwd"] * 5:
        raise AssertionError(f"Chrome trace {trace_path} read back as "
                             f"{[e['name'] for e in spans_x]}")

    # ---- what the card has no kernel for raises, and launches nothing:
    # int4 at a width that is no multiple of 256 or at a block other than
    # 128 columns, an int8 block that does not divide the row, an unbuilt
    # head dim
    before = _counts()
    _must_raise(ValueError,
                lambda: encode_activation(x_cut[..., :384], "int4"))
    _must_raise(ValueError,
                lambda: codec_ops.quantize_int4(x_cut[..., :384]))
    _must_raise(NotImplementedError,
                lambda: codec_ops.quantize_int4(x_cut[..., :256], block=64))
    _must_raise(ValueError,
                lambda: codec_ops.quantize(x_cut[..., :100], block=64))
    _must_raise(ValueError,
                lambda: codec_ops.dequantize(pay["q"][..., :64],
                                             pay["s"][..., :1], block=48))
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
            "executor_spans": {
                "requests": "4 single-pool and the two-pool one, again with "
                            "FlightRecorder(mode='full'): actions, payloads "
                            "and launches equal to the untraced runs",
                "edge_cloud_span_ms": span_ms,
                "traced_request_wall_ms": traced_walls,
                "chrome_trace": os.path.relpath(
                    trace_path, os.path.dirname(os.path.abspath(__file__))),
                "chrome_trace_events": len(loaded["traceEvents"])},
            "profile_one_request": prof,
            "payload_bytes": payload_bytes(payload),
            "downlink_payload_bytes": payload_bytes(pay2["down"]),
            "launches": launches,
            "codec_off_hidden_max_err": raw_err,
            "streamed_equals_run": True,
            "small_reference": small,
            "held_before_init_bytes": held_before,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "peak_at_init_bytes": peak_init,
            "peak_memory_bytes": peak}
    emit(info)
    return info


# =================================================================== delta
# the reference's DeltaTransport defaults; 24 action steps a scene; the cut
# after 16 LLM blocks lies inside serve's pool
DELTA_SCENES, DELTA_STEPS = ("static", "dynamic"), 24
DELTA_THRESHOLD, DELTA_RESYNC, DELTA_CUT = 0.02, 8, 16


def _scene_images(cfg, scene: str, seed: int) -> list:
    """``DELTA_STEPS`` images of one scene: each is the previous step's
    with ``ceil(f_t * n_patches)`` patch rows redrawn, ``f_t`` the scene
    trace's change fraction (``core.generate_scene_trace``)."""
    frac = core.generate_scene_trace(DELTA_STEPS, core.SCENES[scene], seed)
    g = gen(seed)
    n = cfg.n_patches
    patches = torch.randn((1, n, cfg.vit_dim), generator=g, device=DEV)
    out = [(float(frac[0]), n, patches)]
    for f in frac[1:]:
        k = math.ceil(float(f) * n)
        rows = torch.randperm(n, generator=g, device=DEV)[:k]
        patches = patches.clone()
        patches[:, rows] = torch.randn((1, k, cfg.vit_dim), generator=g,
                                       device=DEV)
        out.append((float(f), k, patches))
    return out


def _changed_rows(x, ref) -> torch.Tensor:
    """The rows ``delta_encode`` counts as changed, by its own test."""
    absmax = float(x.abs().max())
    rowdiff = (x - ref.to(x.dtype)).abs().amax(dim=(0, 2))
    return rowdiff > DELTA_THRESHOLD * absmax


def _threshold_rounding_check() -> dict:
    """On the card the change test compares in the activation's dtype, as
    the JAX package's weak-typed scalar does: a row changed by exactly
    bf16(0.0201 * max|x|) is not shipped in bf16, and is in float32."""
    x = torch.zeros((1, 4, 256), device=DEV)
    ref = torch.zeros_like(x)
    x[0, 0, 0] = ref[0, 0, 0] = 1.0
    x[0, 1, 5], x[0, 2, 5], x[0, 3, 5] = (v * 2.0 ** -13
                                          for v in (165, 164, 166))
    got = {}
    for dtype, want in ((torch.bfloat16, [0, 0, 0, 1]),
                        (torch.float32, [0, 1, 0, 1])):
        payload, _, key = delta_encode(x.to(dtype), "int8", ref.to(dtype),
                                       threshold=0.0201)
        mask = [int(b) for b in np.unpackbits(payload["mask"])[:4]]
        if key or mask != want:
            raise AssertionError(f"{dtype}: change mask {mask}, expected "
                                 f"{want} (the reference's)")
        got[str(dtype).split(".")[-1]] = mask
    return got


def _delta_launches(tried: bool, key: bool, n_changed) -> tuple:
    """(quantise, dequantise) launches of one ``DeltaTransport.step``: a
    tried delta encodes its changed rows (none when no row changed, the
    wrappers return before a launch on an empty tensor), a key frame
    encodes the whole activation, and the reconstruction decodes what was
    shipped."""
    return (int(tried and n_changed > 0) + int(key),
            int(key or n_changed > 0))


def delta_mixing(cfg, params, tokens, images: list) -> dict:
    """Where the static scene's change spreads: the fraction of image and
    text rows over the threshold between its first two steps, right after
    the ViT (no LLM block on the edge) and at the delta path's cut."""
    Lv, L = cfg.vit_layers, cfg.n_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv, Lv + L))
    n = cfg.n_patches
    out = {"patch_rows_redrawn": images[1][1], "n_patches": n}
    for depth in (0, min(DELTA_CUT, L)):
        x0, x1 = (ex._edge_hidden(params, img[2], tokens, Lv + depth)
                  for img in images[:2])
        changed = _changed_rows(x1, x0).float()
        out[f"llm_blocks_{depth}"] = {
            "image_rows_changed": changed[:n].mean().item(),
            "text_rows_changed": changed[n:].mean().item()}
    return out


def delta_replan(cfg, scenes: dict) -> dict:
    """The planner's side of each scene: ``RoboECC`` planned with a delta
    codec priced at the scene's mean change fraction, then told the
    fraction measured at the cut (``observe_change_frac``)."""
    out = {}
    for name, sc in scenes.items():
        d0 = core.make_delta_codec(change_frac=sc["scene_frac_mean"],
                                   resync_every=DELTA_RESYNC,
                                   threshold=DELTA_THRESHOLD,
                                   row_elems=cfg.d_model)
        ctl = core.RoboECC(get_config(cfg.name), core.ORIN, core.A100,
                           cloud_budget_bytes=12.1e9, nominal_bw_bps=1e6,
                           codec=d0, adjust_codecs=[d0, "identity", "int8"])
        before = (ctl.seg.split, ctl.codec.bytes_per_elem)
        replanned = ctl.observe_change_frac(sc["changed_frac_at_cut_mean"],
                                            nominal_bw_bps=1e6)
        out[name] = {"priced_change_frac": d0.change_frac,
                     "measured_change_frac": sc["changed_frac_at_cut_mean"],
                     "replanned": replanned,
                     "split_before_after": [before[0], ctl.seg.split],
                     "bytes_per_elem_before_after": [before[1],
                                                     ctl.codec.bytes_per_elem]}
    return out


def delta_frames_check(S: int, D: int) -> dict:
    """Delta frames on the card, beside the main path (whose cut rows all
    change, so it ships key frames only): a stream at the cut's shape in
    which about a fifth of the rows move for 7 steps and then none, through
    one ``DeltaTransport`` on the card and one on the CPU (the plain
    codec).  Payloads byte-equal, reconstructions equal, exact launches on
    the card (none for a frame with no changed row), and the host walls of
    a delta frame."""
    g = torch.Generator().manual_seed(SEED + 45)
    x = torch.randn((1, S, D), generator=g).to(torch.bfloat16)
    frames = [x]
    for t in range(11):
        x = x.clone()
        if t < 7:
            rows = torch.rand(S, generator=g) < 0.2
            x[0, rows] += (0.5 * torch.randn((int(rows.sum()), D),
                                             generator=g)).to(x.dtype)
        frames.append(x)
    trs = [DeltaTransport("int8", threshold=DELTA_THRESHOLD,
                          resync_every=DELTA_RESYNC) for _ in range(2)]
    steps = []
    for t, f in enumerate(frames):
        fd = f.to(DEV)
        ref = trs[0]._ref.get(0)
        tried = ref is not None and trs[0]._ssk[0] + 1 < DELTA_RESYNC
        n_changed = int(_changed_rows(fd, ref).sum()) if ref is not None \
            else None
        before = _counts()
        enc_ms, (pay, recon, key) = _wall_ms(lambda: trs[0].step(0, fd))
        moved = _moved(before)
        pay_cpu, recon_cpu, key_cpu = trs[1].step(0, f)
        q, dq = _delta_launches(tried, key, n_changed)
        want = dict.fromkeys(WRAPPERS, 0)
        want["quantize_int8"], want["dequantize_int8"] = q, dq
        on_host = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                   for k, v in pay.items()}
        if key != key_cpu or moved != want \
                or not _same_payload(on_host, pay_cpu) \
                or not torch.equal(recon.cpu(), recon_cpu):
            raise AssertionError(f"delta frame {t} on the card: key {key} / "
                                 f"{key_cpu}, launches {moved} against "
                                 f"{want}, or payloads differ from the CPU")
        dec_ms, back = _wall_ms(lambda: delta_decode(pay, ref, fd.dtype))
        if not torch.equal(back, recon):
            raise AssertionError(f"delta frame {t}: delta_decode differs")
        steps.append({"key": key, "changed_rows": n_changed,
                      "wire_bytes": payload_bytes(pay), "encode_ms": enc_ms,
                      "decode_ms": dec_ms, "quantize_int8": q,
                      "dequantize_int8": dq})
    delta = [r for r in steps if not r["key"]]
    if not (any(r["changed_rows"] for r in delta)
            and any(r["changed_rows"] == 0 for r in delta)):
        raise AssertionError(f"the stream did not give both kinds of delta "
                             f"frame: {steps}")
    return {"shape": [1, S, D], "dtype": "bfloat16",
            "compared_with": "the same stream through DeltaTransport on the "
                             "CPU: payloads byte-equal",
            "steps": steps}


def phase_delta(st: dict) -> dict:
    """OpenVLA-7B requests over a static and a dynamic scene through the
    temporal-delta transport (int8 base codec): the edge forward to the
    raw cut activation, ``DeltaTransport.step``, the cloud forward from the
    reconstruction.  Counts are set to 0 before the two scenes and read
    after; then every frame is checked against the plain codec, the
    reference's wire accounting and error bound, and each key frame's
    action against ``VLASplitExecutor.run`` on the same request."""
    cfg, params = st["cfg"], st["params"]
    Lv, L = cfg.vit_layers, cfg.n_layers
    cut = Lv + min(DELTA_CUT, L)
    ex = VLASplitExecutor(cfg, SplitPlan(Lv + min(14, L - 1),
                                         Lv + min(18, L), codec="int8"))
    S = cfg.n_patches + 17
    tokens = torch.randint(0, cfg.vocab_size, (1, 17), generator=gen(SEED + 40),
                           device=DEV)
    scenes = {name: _scene_images(cfg, name, SEED + 41 + i)
              for i, name in enumerate(DELTA_SCENES)}
    ex.run(params, scenes["static"][0][2], tokens, cut)          # warm-up
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after
    frames = {name: [] for name in DELTA_SCENES}
    transports = {}
    _reset_counts()
    for name in DELTA_SCENES:
        tr = transports[name] = DeltaTransport(
            "int8", threshold=DELTA_THRESHOLD, resync_every=DELTA_RESYNC)
        x_prev = None
        for f, k, patches in scenes[name]:
            ref = tr._ref.get(0)
            tried = ref is not None and tr._ssk[0] + 1 < DELTA_RESYNC
            before = _counts()
            edge_ms, x = _wall_ms(
                lambda: ex._edge_hidden(params, patches, tokens, cut))
            enc_ms, (payload, recon, key) = _wall_ms(lambda: tr.step(0, x))
            cloud_ms, action = _wall_ms(lambda: ex._action_decode(
                params, ex._cloud_hidden(params, recon, cut), None))
            moved = _moved(before)
            n_changed = int(_changed_rows(x, ref).sum()) if ref is not None \
                else None
            want = _want(L)
            want["quantize_int8"], want["dequantize_int8"] = \
                _delta_launches(tried, key, n_changed)
            if moved != want:
                raise AssertionError(f"{name}: a step moved the counts by "
                                     f"{moved}, expected {want}")
            _check_action(cfg, action)
            rows_moved = None if x_prev is None else int(
                (x != x_prev).any(dim=2).sum())
            frames[name].append(dict(
                scene_frac=f, patch_rows=k, x=x, ref=ref, payload=payload,
                recon=recon, key=key, tried=tried, n_changed=n_changed,
                rows_moved=rows_moved, patches=patches, action=action,
                edge_ms=edge_ms, encode_ms=enc_ms, cloud_ms=cloud_ms,
                q=moved["quantize_int8"], dq=moved["dequantize_int8"]))
            x_prev = x
    launches = _counts()

    # ---- the checks, after the counts were read
    err_bound = core.CODECS["int8"].err_bound
    plain_bytes = payload_bytes(encode_activation(frames["static"][0]["x"],
                                                  "int8"))
    out = {}
    for name in DELTA_SCENES:
        steps = []
        for t, fr in enumerate(frames[name]):
            x, payload, ref, recon = (fr["x"], fr["payload"], fr["ref"],
                                      fr["recon"])
            plain_ms, plain = _wall_ms(lambda: encode_activation(x, "int8"))
            if fr["key"]:
                if not _same_payload(payload, plain):
                    raise AssertionError(f"{name} step {t}: key frame is not "
                                         "the plain int8 payload")
                a_run, pay_run = ex.run(params, fr["patches"], tokens, cut)
                if not torch.equal(a_run, fr["action"]) \
                        or not _same_payload(pay_run, payload):
                    raise AssertionError(f"{name} step {t}: the key frame's "
                                         "action is not VLASplitExecutor.run's")
            else:
                mask = payload["mask"]
                changed = np.unpackbits(mask)[:S].astype(bool)
                idx = np.flatnonzero(changed)
                body = encode_activation(
                    x[:, torch.from_numpy(idx).to(DEV), :], "int8")
                if payload_bytes(payload) != mask.nbytes + payload_bytes(body) \
                        or not _same_payload(
                            {k: v for k, v in payload.items() if k != "mask"},
                            body) or len(idx) != fr["n_changed"]:
                    raise AssertionError(f"{name} step {t}: delta payload is "
                                         "not the mask and the changed rows")
                card = _changed_rows(x, ref).cpu().numpy()
                cpu = _changed_rows(x.cpu(), ref.cpu()).numpy()
                if not (np.array_equal(card, changed)
                        and np.array_equal(cpu, changed)):
                    raise AssertionError(f"{name} step {t}: the change mask "
                                         "differs between the card and the CPU")
            dec_ms, back = _wall_ms(lambda: delta_decode(payload, ref,
                                                         x.dtype))
            if not torch.equal(back, recon):
                raise AssertionError(f"{name} step {t}: new_ref is not "
                                     "delta_decode(payload, ref)")
            xf = x.float()
            lim = (err_bound + (0.0 if fr["key"] else DELTA_THRESHOLD)) \
                * xf.abs().max().item()
            err = (recon.float() - xf).abs().max().item()
            if err > lim:
                raise AssertionError(f"{name} step {t}: reconstruction error "
                                     f"{err} over {lim}")
            rel = None
            if ref is not None:
                rel = ((x - ref.to(x.dtype)).abs().amax(dim=(0, 2)).float()
                       / xf.abs().max()).cpu()
            steps.append({
                "key": fr["key"], "scene_frac": fr["scene_frac"],
                "row_change_over_max_min_median": None if rel is None
                else [rel.min().item(), rel.median().item()],
                "patch_rows_redrawn": fr["patch_rows"],
                "changed_frac_at_cut": None if fr["n_changed"] is None
                else fr["n_changed"] / S,
                "moved_frac_at_cut": None if fr["rows_moved"] is None
                else fr["rows_moved"] / S,
                "wire_bytes": payload_bytes(payload),
                "quantize_int8": fr["q"], "dequantize_int8": fr["dq"],
                "recon_max_err": err, "err_limit": lim,
                "edge_ms": fr["edge_ms"], "encode_ms": fr["encode_ms"],
                "plain_encode_ms": plain_ms, "decode_ms": dec_ms,
                "cloud_ms": fr["cloud_ms"]})
        tr = transports[name]
        wire = [r["wire_bytes"] for r in steps]
        fracs = [r["scene_frac"] for r in steps]
        measured = [r["changed_frac_at_cut"] for r in steps[1:]]
        planner = core.make_delta_codec(change_frac=statistics.mean(fracs),
                                        resync_every=DELTA_RESYNC,
                                        threshold=DELTA_THRESHOLD,
                                        row_elems=cfg.d_model)
        out[name] = {
            "keyframes": tr.n_keyframes, "delta_frames": tr.n_delta_frames,
            "wire_bytes_total": sum(wire),
            "plain_int8_bytes_total": plain_bytes * len(wire),
            "wire_over_plain": sum(wire) / (plain_bytes * len(wire)),
            "scene_frac_mean": statistics.mean(fracs),
            "changed_frac_at_cut_mean": statistics.mean(measured),
            "moved_frac_at_cut_mean": statistics.mean(
                r["moved_frac_at_cut"] for r in steps[1:]),
            "planner_bytes_per_step": planner.bytes_per_elem * S
            * cfg.d_model,
            "measured_bytes_per_step": statistics.mean(wire),
            "quantize_int8": sum(r["quantize_int8"] for r in steps),
            "dequantize_int8": sum(r["dequantize_int8"] for r in steps),
            "median_ms": {k: statistics.median(r[k] for r in steps)
                          for k in ("edge_ms", "encode_ms",
                                    "plain_encode_ms", "decode_ms",
                                    "cloud_ms")},
            "steps": steps}
    info = {"phase": "delta", "model": cfg.name, "cut": cut, "seq": S,
            "dtype": cfg.dtype, "base_codec": "int8",
            "threshold": DELTA_THRESHOLD, "resync_every": DELTA_RESYNC,
            "steps_per_scene": DELTA_STEPS,
            "plain_int8_bytes_per_step": plain_bytes,
            "threshold_rounding": _threshold_rounding_check(),
            "scenes": out,
            "mixing": delta_mixing(cfg, params, tokens, scenes["static"]),
            "planner": delta_replan(cfg, out),
            "delta_frames_on_the_card": delta_frames_check(S, cfg.d_model),
            "launches": launches}
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
    peak_init = torch.cuda.max_memory_allocated()
    lo, hi = (executor_cut(cfg, ctl, s)[0]
              for s in (ctl.pool.start, ctl.pool.end))
    executors = {w: VLASplitExecutor(cfg, SplitPlan(lo, hi, codec=w))
                 for w in ("", "int8", "int4")}
    return {"cfg": cfg, "ctl": ctl, "params": params, "init_s": init_s,
            "held_before_bytes": held_before,
            "peak_after_reset_bytes": peak_after_reset,
            "peak_at_init_bytes": peak_init,
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
            "peak_at_init_bytes": st["peak_at_init_bytes"],
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


# ================================================================ generate
def setup_lm(name: str, seed: int) -> dict:
    """An LM at full width and depth, bf16, weights from a seed, with the
    launches its prefill (and its full forward) and one decode step make:
    dense, one flash attention per block and one flash-decode per block and
    step; ssm, one SSD scan per Mamba layer and nothing per step; hybrid,
    the shared block's flash attention at each site and the scans, and one
    flash-decode per site and step; moe, one flash attention per block
    and one flash-decode per block and step (MLA: none, its decode is the
    absorbed form in plain products)."""
    cfg = get_config(name)
    model = build(cfg)
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen(seed), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L = cfg.n_layers
    if cfg.family == "dense":
        per_prefill, per_step = _want(L), _want(0, decode=L)
    elif cfg.family == "moe":       # MLA decodes in the absorbed form: plain
        per_prefill = _want(L)
        per_step = _want(0, decode=0 if cfg.use_mla else L)
    elif cfg.family == "ssm":
        per_prefill, per_step = _want(0, ssd=L), _want(0)
    else:
        ns = n_sites(cfg)
        per_prefill, per_step = _want(ns, ssd=L), _want(0, decode=ns)
    return {"cfg": cfg, "model": model, "params": params, "init_s": init_s,
            "held_before_bytes": held_before,
            "n_params": sum(t.numel() for t in tree_leaves(params)),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "per_prefill": per_prefill, "per_step": per_step,
            "gen": gen(seed + 1)}


def _family_launches(prof: dict, prefix: str) -> int:
    """CUDA kernels in a profiled window whose hand-written family starts
    with ``prefix``."""
    return sum(g["launches"] for name, g in prof.get("by_group", {}).items()
               if name.startswith("hand-written: " + prefix))


def _decode_kernel_launches(prof: dict) -> int:
    """CUDA kernels of the flash-decode source in a profiled window."""
    return _family_launches(prof, "decode")


def profile_decode_step(name: str, seed: int) -> dict:
    """Kernel launches of one decode step of an LM at full width and depth,
    batch 1, after a ``LM_PROMPT``-token prefill, from ``torch.profiler``:
    in all and by kernel group, and those of the flash-decode source."""
    st = setup_lm(name, seed)
    model, params, cfg = st["model"], st["params"], st["cfg"]
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_PROMPT),
                           generator=st["gen"], device=DEV)
    logits, cache = prefill_and_pad(model, params, {"tokens": tokens},
                                    LM_PROMPT + LM_STEPS)
    cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    step = make_serve_step(model)
    logits, cache = step(params, cache, cur, LM_PROMPT)          # warm-up
    prof = profile_request(lambda: step(params, cache, cur, LM_PROMPT + 1))
    out = {"model": name, "batch": 1,
           "n_kernel_launches": prof.get("n_kernel_launches"),
           "device_busy_ms": prof.get("device_busy_ms"),
           "decode_kernel_launches": _decode_kernel_launches(prof),
           "decode_attention_calls": st["per_step"]["decode_attention"],
           "launches_by_group": {k: g["launches"] for k, g in
                                 prof.get("by_group", {}).items()}}
    del st, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_attention(cfg, lcfg, zcfg, pcfg) -> dict:
    """``--attention-only``: B5 and B6 alone — every case against the plain
    versions, the times at every served shape, and the kernel launches of
    one Llama-3.2-3B and one Zamba2-1.2B decode step."""
    attn_cases, dec_cases = attention_cases(cfg, lcfg, zcfg, pcfg)
    info = {"phase": "attention", "src": _src_dir(),
            "attention_cases": attn_cases, "decode_cases": dec_cases,
            "times": attention_times(cfg, lcfg, zcfg, pcfg, attn_cases,
                                     dec_cases),
            "decode_step_launches": [
                profile_decode_step("llama3.2-3b", SEED + 30),
                profile_decode_step("zamba2-1.2b", SEED + 80)]}
    emit(info)
    return info


def _generate_at(st: dict, batch: int, prompt: int, steps: int) -> dict:
    cfg, model, params = st["cfg"], st["model"], st["params"]
    per_prefill, per_step = st["per_prefill"], st["per_step"]
    max_len = prompt + steps
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=st["gen"], device=DEV)
    greedy_generate(model, params, {"tokens": tokens[:, :64]}, 2)  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts set to 0 just before, read just after
    _reset_counts()
    wall, out = _wall_ms(lambda: greedy_generate(
        model, params, {"tokens": tokens}, steps, max_len=max_len))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: per_prefill[k] + steps * per_step[k] for k in WRAPPERS}
    if launches != want:
        raise AssertionError(f"greedy_generate at batch {batch} launched "
                             f"{launches}, expected {want}")
    if tuple(out.shape) != (batch, steps) or out.min().item() < 0 \
            or out.max().item() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of "
                             "range")

    # ---- the same loop, each stage synchronised, logits kept
    step = make_serve_step(model)
    before = _counts()
    ms_prefill, (logits, cache) = _wall_ms(lambda: prefill_and_pad(
        model, params, {"tokens": tokens}, max_len))
    if _moved(before) != per_prefill:
        raise AssertionError(f"prefill launched {_moved(before)}")
    cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    toks, step_logits, step_ms = [], [], []
    for i in range(steps):
        toks.append(cur)
        before = _counts()
        ms, (logits, cache) = _wall_ms(
            lambda: step(params, cache, cur, prompt + i))
        if _moved(before) != per_step:
            raise AssertionError(f"decode step {i}: launches {_moved(before)}")
        step_ms.append(ms)
        step_logits.append(logits[:, 0])
        cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    toks = torch.cat(toks, 1)
    if not torch.equal(toks, out):
        raise AssertionError(f"batch {batch}: the synchronised step loop "
                             "chose other tokens than greedy_generate")
    n_cache = cache_bytes(cache)
    prof = profile_request(lambda: step(params, cache, cur, max_len - 1))

    # ---- each step's logits against one full forward over prompt + tokens
    before = _counts()
    full = model.forward(params, {"tokens": torch.cat([tokens, toks], 1)}
                         )[:, prompt:]
    if _moved(before) != per_prefill:
        raise AssertionError(f"full forward launched {_moved(before)}")
    # ---- one prefill by kernel family, from torch.profiler
    prof_pre = profile_request(lambda: prefill_and_pad(
        model, params, {"tokens": tokens}, max_len))
    busy_pre = prof_pre.get("device_busy_ms")
    if isinstance(busy_pre, float):
        n_ssd = {k: _family_launches(prof_pre, "ssd_" + k)
                 for k in ("state", "out")}
        if any(n != per_prefill["ssd_scan"] for n in n_ssd.values()):
            raise AssertionError(f"one prefill ran SSD kernels {n_ssd} for "
                                 f"{per_prefill['ssd_scan']} calls; a call "
                                 "is one chunk-state and one output kernel")
    V = cfg.vocab_size                 # the pad slots past it hold -1e30
    dec = torch.stack(step_logits, 1)[..., :V].float()
    full = full[..., :V].float()
    if not torch.isfinite(dec).all():
        raise AssertionError("decode logits are not finite")
    err = (dec - full).abs()
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    busy = prof.get("device_busy_ms")
    n_dec = _decode_kernel_launches(prof)
    if isinstance(busy, float) and n_dec != per_step["decode_attention"]:
        raise AssertionError(f"one decode step ran {n_dec} flash-decode "
                             f"kernels for {per_step['decode_attention']} "
                             "calls; a call is one kernel launch")
    med = statistics.median(step_ms)
    return {"batch": batch, "prompt": prompt, "steps": steps,
            "max_len": max_len,
            "generate_wall_ms": wall,
            "generate_tokens_per_s": batch * steps / wall * 1e3,
            "prefill_wall_ms": ms_prefill,
            "profile_prefill": prof_pre,
            "prefill_device_idle_share": (1 - busy_pre / ms_prefill)
            if isinstance(busy_pre, float) else "not measured",
            "decode_step_wall_ms": step_ms,
            "decode_step_wall_ms_median": med,
            "decode_step_wall_ms_min_max": [min(step_ms), max(step_ms)],
            "decode_tokens_per_s": batch * steps / sum(step_ms) * 1e3,
            "profile_one_step": prof,
            "decode_kernel_launches_one_step": n_dec,
            "device_idle_share_one_step": (1 - busy / med)
            if isinstance(busy, float) else "not measured",
            "launches": launches,
            "launches_per_prefill": per_prefill,
            "launches_per_step": per_step,
            "cache_bytes": n_cache,
            "held_before_bytes": base,
            "peak_during_generate_bytes": peak,
            "peak_above_held_bytes": peak - base,
            "logits_max_abs": full.abs().max().item(),
            "logits_vs_full_forward_max_err": err.max().item(),
            "logits_vs_full_forward_mean_err": err.mean().item(),
            "logits_vs_full_forward_mean_err_first_last_step": [
                err[:, 0].mean().item(), err[:, -1].mean().item()],
            "argmax_agreement": agree}


def phase_generate(st: dict, name: str = "generate", prompt: int = LM_PROMPT,
                   steps: int = LM_STEPS, small: dict = None,
                   batches=LM_BATCHES, f32_check: bool = False) -> dict:
    """``runtime/serving.py::greedy_generate`` on an LM at full width and
    depth: a 512-token prompt (two SSD chunks) and 64 greedy steps, at
    batch 1 and 4 (or ``steps`` at ``batches``); with ``f32_check``, the
    same model in float32 against its full forward
    (``full_width_f32_check``, over ``steps``)."""
    runs = [_generate_at(st, b, prompt, steps) for b in batches]
    launches = {k: sum(r["launches"][k] for r in runs) for k in WRAPPERS}
    cfg = st["cfg"]
    info = {"phase": name, "model": cfg.name, "family": cfg.family,
            "n_params": st["n_params"], "n_params_analytic": cfg.n_params(),
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "init_s": st["init_s"],
            "held_before_init_bytes": st["held_before_bytes"],
            "param_bytes": st["param_bytes"], "runs": runs,
            "launches": launches}
    if cfg.family in ("dense", "hybrid") or (cfg.family == "moe"
                                             and not cfg.use_mla):
        info["heads"] = [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim]
    if cfg.family == "moe":
        info["moe"] = moe_layer_profiles(st)
    if cfg.family in ("ssm", "hybrid"):
        info["ssm"] = {"d_inner": cfg.d_inner, "heads": cfg.ssm_nheads,
                       "head_dim": cfg.ssm_headdim, "state": cfg.ssm_state,
                       "chunk": cfg.ssm_chunk}
    if cfg.family == "hybrid":
        info["shared_block_sites"] = n_sites(cfg)
    if f32_check:
        info["full_width_float32"] = full_width_f32_check(st, steps)
    if small is not None:
        info["small_reference"] = small
    emit(info)
    return info


# limit of the float32 check below, stated before its first run: relative
# to the largest logit (a 24-layer, d_model 512 Mamba2 on the CPU gives
# 7.5e-6 of it), over the prefill and the first F32_GATE_STEPS steps; the
# same limit holds phi3-mini-3.8b (the float32 flash attention and
# flash-decode at head dim 96), stated before its first run there
FULL_F32_REL = 5e-5
F32_GATE_STEPS = 8
F32_MOE_CAPACITY = 8.0


def full_width_f32_check(st: dict, steps: int = LM_STEPS) -> dict:
    """The served model at full width and depth with float32 activations
    (the parameters stay bf16, as the specs store them): prefill of the
    512-token prompt plus ``steps`` decode steps at batch 1.  The gate, as
    it always ran: the prefill and the first ``F32_GATE_STEPS`` steps
    against one full forward over prompt + ``F32_GATE_STEPS`` tokens,
    within ``FULL_F32_REL`` of its largest logit.  Recorded, not gated:
    every step against a second full forward over prompt + ``steps``
    tokens, to see whether the error grows with the step (a forward over
    another length takes other library kernels, whose float32 sums move
    the logits by a few 1e-6 of their largest value).  In bf16 a decode
    step and the full forward round at other places (the SSD recurrence
    against the chunked scan, one query's attention against a causal
    block) and drift apart with depth and steps; in float32 they must
    agree."""
    cfg = st["cfg"].replace(dtype="float32")
    if cfg.family == "moe":
        # GShard drops depend on the token count, so a prefill and a full
        # forward over more tokens drop other choices; a capacity that binds
        # nowhere makes them comparable (tests/test_decode_equivalence.py)
        cfg = cfg.replace(moe_capacity_factor=F32_MOE_CAPACITY)
    model = build(cfg)
    params, V = st["params"], cfg.vocab_size
    # the gate's tokens are drawn first, as they always were; the later
    # steps' after them
    tokens = torch.randint(0, V, (1, LM_PROMPT + F32_GATE_STEPS),
                           generator=st["gen"], device=DEV)
    if steps > F32_GATE_STEPS:
        tokens = torch.cat([tokens, torch.randint(
            0, V, (1, steps - F32_GATE_STEPS), generator=st["gen"],
            device=DEV)], 1)
    before = _counts()
    gate_full = model.forward(
        params, {"tokens": tokens[:, :LM_PROMPT + F32_GATE_STEPS]})[
        :, LM_PROMPT - 1:, :V].float()
    full = model.forward(params, {"tokens": tokens})[
        :, LM_PROMPT - 1:, :V].float()
    logits, cache = prefill_and_pad(model, params,
                                    {"tokens": tokens[:, :LM_PROMPT]},
                                    LM_PROMPT + steps)
    outs = [logits[:, 0]]
    for i in range(LM_PROMPT, LM_PROMPT + steps):
        logits, cache = model.decode(params, cache, tokens[:, i:i + 1], i)
        outs.append(logits[:, 0])
    moved = _moved(before)
    want = {k: 3 * v + steps * st["per_step"][k]
            for k, v in st["per_prefill"].items()}
    if moved != want:
        raise AssertionError(f"float32 check launched {moved}, expected "
                             f"{want}")
    dec = torch.stack(outs, 1)[..., :V].float()
    top = gate_full.abs().max().item()
    err = (dec[:, :F32_GATE_STEPS + 1] - gate_full).abs().max().item()
    if not err <= FULL_F32_REL * top:
        raise AssertionError(f"{cfg.name} float32 at full width: prefill + "
                             f"{F32_GATE_STEPS} steps are {err} from the "
                             f"full forward (limit {FULL_F32_REL * top})")
    per_step = (dec - full).abs().amax(dim=(0, 2)).tolist()
    top_step = full.abs().amax(dim=(0, 2)).tolist()
    rel = [e / t for e, t in zip(per_step, top_step)]
    return {"dtype": "float32", "batch": 1, "prompt": LM_PROMPT,
            "steps": steps, "gate_steps": F32_GATE_STEPS, "max_err": err,
            "limit": FULL_F32_REL * top, "logits_max_abs": top,
            "max_err_per_step": per_step,
            "logits_max_abs_per_step": top_step,
            "max_err_prefill_first_last_step": [per_step[0], per_step[1],
                                                per_step[-1]],
            "rel_err_prefill_first_last_step": [rel[0], rel[1], rel[-1]],
            "rel_err_max_all_steps": max(rel)}


def _plain_ssd_scan(x, dt, A, Bm, Cm, *, chunk):
    return ssd_ops.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)


# limit of the reduced gate below, stated before its first run: logits with
# the kernels against logits with the plain versions, relative to the
# largest logit (float32; about 3e-7 of it on the CPU with the kernel's
# arithmetic written out)
SMALL_KERNEL_REL = 4e-6


def small_ssm_check(name: str) -> dict:
    """The reduced config in float32, its own depth, on the card: prefill
    of a two-chunk prompt (37 positions, chunk 32) plus 6 decode steps
    against the full forward (2e-3, tests/test_decode_equivalence.py), and
    the logits of both with the kernels against those with every kernel of
    the path swapped for its plain version (``SMALL_KERNEL_REL`` of the
    largest logit)."""
    cfg = get_config(name).reduced().replace(dtype="float32")
    model = build(cfg)
    params = model.init(gen(SEED + 60), DEV)
    B, P, T = 2, 37, 43
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen(SEED + 61),
                           device=DEV)

    def run():
        full = model.forward(params, {"tokens": tokens})
        logits, cache = prefill_and_pad(model, params,
                                        {"tokens": tokens[:, :P]}, T)
        steps = [logits[:, 0]]
        for i in range(P, T):
            logits, cache = model.decode(params, cache, tokens[:, i:i + 1], i)
            steps.append(logits[:, 0])
        return full, torch.stack(steps, 1)            # positions P-1 .. T-1

    before = _counts()
    full_k, dec_k = run()
    n_sites_ = n_sites(cfg) if cfg.family == "hybrid" else 0
    want = {k: 2 * v for k, v in _want(n_sites_, ssd=cfg.n_layers).items()}
    want["decode_attention"] = n_sites_ * (T - P)
    if _moved(before) != want:
        raise AssertionError(f"{name} reduced: launches {_moved(before)}, "
                             f"expected {want}")
    swapped = (ssd_ops.ssd_scan, fa_ops.flash_attention,
               da_ops.decode_attention)
    ssd_ops.ssd_scan = _plain_ssd_scan                # swapped, then back
    fa_ops.flash_attention = fa_ops.flash_attention_plain
    da_ops.decode_attention = _plain_decode_attention
    full_p, dec_p = run()
    ssd_ops.ssd_scan, fa_ops.flash_attention, da_ops.decode_attention = \
        swapped
    full_err = (dec_k - full_k[:, P - 1:]).abs().max().item()
    top = full_p.abs().max().item()
    plain_err = max((full_k - full_p).abs().max().item(),
                    (dec_k - dec_p).abs().max().item())
    if full_err > 2e-3:
        raise AssertionError(f"{name} reduced prefill + decode is {full_err} "
                             "from the full forward (limit 2e-3)")
    if plain_err > SMALL_KERNEL_REL * top:
        raise AssertionError(f"{name} reduced logits with the kernels are "
                             f"{plain_err} from those with the plain "
                             f"versions (limit {SMALL_KERNEL_REL * top})")
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "state": cfg.ssm_state, "head_dim": cfg.ssm_headdim,
                       "chunk": cfg.ssm_chunk, "dtype": cfg.dtype},
            "batch": B, "prompt": P, "steps": T - P,
            "decode_vs_full_forward_max_err": full_err,
            "kernels_vs_plain_max_err": plain_err,
            "kernels_vs_plain_limit": SMALL_KERNEL_REL * top,
            "logits_max_abs": top}


# ================================================================ serve_lm
def phase_serve_lm(st: dict, n_batches: int = 8, seq: int = LM_SEQ) -> dict:
    """``LMSplitExecutor`` as ``launch/serve.py`` drives it, at full width
    and depth: requests of 17 tokens batched by 4 (``MicroBatcher``), the
    int8 codec on the cut, the cut walking the pool of ``launch/serve.py``
    ``[n//2 - 1, n//2 + 2)``; one two-pool request."""
    cfg, model, params = st["cfg"], st["model"], st["params"]
    n = cfg.n_layers
    lo = max(n // 2 - 1, 0)
    hi = min(lo + 3, n)
    ex = LMSplitExecutor(cfg, SplitPlan(lo, hi, codec="int8"))
    alg1 = {}
    for codec in (False, True):
        ctl = core.RoboECC(cfg, core.ORIN, core.A100,
                           workload=core.Workload(s_new=seq),
                           cloud_budget_bytes=0.9 * cfg.n_params() * 2,
                           use_codec=codec)
        alg1["codec" if codec else "raw"] = {
            "split": ctl.seg.split, "graph_len": len(ctl.graph),
            "pool": [ctl.pool.start, ctl.pool.end],
            "graph_names_at_split": [c.name for c in
                                     ctl.graph[max(ctl.seg.split - 1, 0):
                                               ctl.seg.split + 1]]}
    g = st["gen"]
    batcher = MicroBatcher(batch_size=LM_MICRO_BATCH, max_wait_s=0.02)
    batches = []
    mb = LM_MICRO_BATCH
    for rid in range(mb * n_batches):         # arrivals 1 ms apart
        batcher.add(Request(rid, rid * 1e-3, seq))
        b = batcher.maybe_form(rid * 1e-3)
        if b is not None:
            batches.append(torch.randint(0, cfg.vocab_size,
                                         (len(b.requests), seq), generator=g,
                                         device=DEV))
    if [t.shape[0] for t in batches] != [mb] * n_batches:
        raise AssertionError(f"batches {[t.shape[0] for t in batches]}")
    cuts = [lo + i % (hi - lo + 1) for i in range(n_batches)]
    ex.run(params, batches[0], cuts[0])                  # warm-up
    torch.cuda.synchronize()

    want_bytes = codec_ref.wire_bytes((mb, seq, cfg.d_model))
    if want_bytes != mb * seq * cfg.d_model \
            + mb * seq * cfg.d_model // 128 * 4:
        raise AssertionError(f"wire_bytes gives {want_bytes}")
    walls = []
    _reset_counts()
    for tokens, cut in zip(batches, cuts):
        before = _counts()
        ms, (logits, payload) = _wall_ms(
            lambda: ex.run(params, tokens, cut))
        walls.append(ms)
        if _moved(before) != _want(n, "int8"):
            raise AssertionError(f"LM request launches {_moved(before)}")
        if tuple(logits.shape[:2]) != (mb, seq) \
                or not torch.isfinite(logits.float()).all():
            raise AssertionError(f"LM logits {tuple(logits.shape)}")
        if set(payload) != {"q", "s"} or payload_bytes(payload) != want_bytes:
            raise AssertionError(f"LM payload {payload_bytes(payload)} bytes, "
                                 f"expected {want_bytes}")
    launches = _counts()

    # ---- streamed == run, bit for bit
    tokens, cut = batches[0], cuts[1]
    l_run, _ = ex.run(params, tokens, cut)
    l_str, chunks = ex.run_streamed(params, tokens, cut, 4)
    if len(chunks) != 4 or not torch.equal(l_run, l_str):
        raise AssertionError("LM run_streamed(n_chunks=4) differs from run")

    # ---- codec off equals the monolithic forward exactly, at every cut
    ex_raw = LMSplitExecutor(cfg, SplitPlan(lo, hi))
    mono = model.forward(params, {"tokens": tokens})
    raw_err = 0.0
    for c in range(lo, hi + 1):
        lr, _ = ex_raw.run(params, tokens, c)
        raw_err = max(raw_err, (lr.float() - mono.float()).abs().max().item())
    if raw_err != 0.0:
        raise AssertionError(f"LM codec off: split logits are {raw_err} from "
                             "the monolithic ones; expected equality")
    rel = ((l_run.float() - mono.float()).abs().max()
           / mono.float().abs().max()).item()

    # ---- one two-pool request: the tail and the LM head back on the edge
    ex2 = LMSplitExecutor(cfg, SplitPlan(lo, hi, codec="int8",
                                         pool2_start=n - 2, pool2_end=n,
                                         codec2="int8"))
    before = _counts()
    ms2, (l2, pay2) = _wall_ms(lambda: ex2.run(params, tokens, cut, n - 1))
    if _moved(before) != _want(n, "int8", "int8"):
        raise AssertionError(f"LM two-pool launches {_moved(before)}")
    if payload_bytes(pay2["down"]) != want_bytes \
            or not torch.isfinite(l2.float()).all():
        raise AssertionError("LM two-pool downlink or logits")

    prof = profile_request(lambda: ex.run(params, tokens, cut))
    busy = prof.get("device_busy_ms")
    med = statistics.median(walls)
    info = {"phase": "serve_lm", "model": cfg.name, "batch": mb, "seq": seq,
            "alg1_full_config": alg1,
            "executor_pool": [lo, hi], "cuts": cuts,
            "request_wall_ms": walls, "request_wall_ms_median": med,
            "two_pool_request_wall_ms": ms2,
            "profile_one_request": prof,
            "device_idle_share_one_request": (1 - busy / med)
            if isinstance(busy, float) else "not measured",
            "payload_bytes": want_bytes,
            "downlink_payload_bytes": payload_bytes(pay2["down"]),
            "codec_off_logits_max_err": raw_err,
            "int8_logits_rel_err": rel,
            "streamed_equals_run": True,
            "launches": launches}
    emit(info)
    return info


# ================================================================== MoE
def moe_layer_profiles(st: dict) -> dict:
    """One MoE layer's FFN, profiled by kernel family at a decode step's
    shape (batch 1, one token) and at the prefill's (batch 1, 512 tokens),
    and for an MLA model one absorbed decode step of one layer over a
    ``LM_PROMPT + 32``-position latent cache: what the dispatch and the
    absorbed decode cost in launches and device time (no hand-written
    kernel on either)."""
    cfg, params = st["cfg"], st["params"]
    pl = _layer_slice(params["moe_blocks"], 0)
    g = gen(SEED + 500)
    out = {"n_experts": cfg.n_experts, "table": int(pl["moe"]["wg"].shape[0]),
           "top_k": cfg.moe_top_k, "shared": cfg.n_shared_experts,
           "capacity_factor": cfg.moe_capacity_factor,
           "first_dense_layers": cfg.first_dense_layers}
    for name, S in (("decode", 1), ("prefill", LM_PROMPT)):
        h = torch.randn((1, S, cfg.d_model), generator=g, device=DEV,
                        dtype=torch.float32).to(torch.bfloat16)
        moe_ffn(cfg, pl["moe"], h)                          # warm-up
        prof = profile_request(lambda: moe_ffn(cfg, pl["moe"], h))
        out[f"ffn_{name}"] = {
            "tokens": S, "capacity": capacity(S, cfg.n_experts,
                                              cfg.moe_top_k,
                                              cfg.moe_capacity_factor),
            "n_kernel_launches": prof.get("n_kernel_launches"),
            "device_busy_ms": prof.get("device_busy_ms"),
            "wall_ms": _wall_ms(lambda: moe_ffn(cfg, pl["moe"], h))[0],
            "by_group": prof.get("by_group")}
    if cfg.use_mla:
        T = LM_PROMPT + 32
        cache = {k: torch.randn(s.shape, generator=g, device=DEV,
                                dtype=torch.float32).to(s.dtype)
                 for k, s in mla_cache_specs(cfg, 1, T).items()}
        x = torch.randn((1, 1, cfg.d_model), generator=g, device=DEV,
                        dtype=torch.float32).to(torch.bfloat16)
        mla_decode(cfg, pl["attn"], x, LM_PROMPT, cache)    # warm-up
        prof = profile_request(
            lambda: mla_decode(cfg, pl["attn"], x, LM_PROMPT, cache))
        out["mla_decode_one_layer"] = {
            "cache_positions": T, "kv_len": LM_PROMPT + 1,
            "n_kernel_launches": prof.get("n_kernel_launches"),
            "device_busy_ms": prof.get("device_busy_ms"),
            "by_group": prof.get("by_group")}
    return out


# limit of the head-alone check of vla_heads, stated before its first run:
# the head on the card against the same head on the CPU, both in bf16, fed
# the same cognition feature (and noise), within this share of
# max(1, max|action|): the two round products summed in other orders
HEAD_REL = 5e-2
VLA_HEAD_HORIZON = 16          # the action chunk of the three heads


def phase_vla_heads(st: dict) -> dict:
    """OpenVLA-7B's backbone (the parameters of ``serve``) with each of the
    ``mlp``, ``lstm`` and ``diffusion`` action heads at full width
    (d_model 4096), a chunk of ``VLA_HEAD_HORIZON`` actions, the head's
    parameters drawn from a seed: one split request each through
    ``VLASplitExecutor`` with the int8 codec on the cut, exact launches,
    then the head alone on the card against the same head on the CPU."""
    cfg0, params0 = st["cfg"], st["params"]
    Lv, L = cfg0.vit_layers, cfg0.n_layers
    lo, hi = Lv + min(14, L - 1), Lv + min(18, L)
    S = cfg0.n_patches + 17
    g = gen(SEED + 600)
    heads, launches = {}, dict.fromkeys(WRAPPERS, 0)
    for i, head in enumerate(("mlp", "lstm", "diffusion")):
        cfg = cfg0.replace(vla_action_head=head,
                           action_horizon=VLA_HEAD_HORIZON)
        t0 = time.perf_counter()
        hp = init_params(action_head_specs(cfg), gen(SEED + 610 + i), DEV)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params = dict(params0, action=hp)
        ex = VLASplitExecutor(cfg, SplitPlan(lo, hi, codec="int8"))
        patches = torch.randn((1, cfg.n_patches, cfg.vit_dim), generator=g,
                              device=DEV)
        tokens = torch.randint(0, cfg.vocab_size, (1, 17), generator=g,
                               device=DEV)
        noise = draw_noise(cfg, 1, DEV, g) if head == "diffusion" else None
        cut = lo + i % (hi - lo + 1)
        ex.run(params, patches, tokens, cut, noise)          # warm-up
        torch.cuda.synchronize()
        # ---- the main path: counts set to 0 just before, read just after
        _reset_counts()
        wall, (action, payload) = _wall_ms(
            lambda: ex.run(params, patches, tokens, cut, noise))
        moved = _counts()
        if moved != _want(L, "int8"):
            raise AssertionError(f"{head} head request launched {moved}, "
                                 f"expected {_want(L, 'int8')}")
        _check_action(cfg, action)
        want_bytes = codec_ref.wire_bytes((1, S, cfg.d_model))
        if payload_bytes(payload) != want_bytes:
            raise AssertionError(f"{head}: payload {payload_bytes(payload)} "
                                 f"bytes, expected {want_bytes}")
        for k in WRAPPERS:
            launches[k] += moved[k]
        # ---- the head alone: card against CPU on one cognition feature
        cog = vla_backbone(cfg, params, patches, tokens)[:, -1]
        ms_head, a_card = _wall_ms(lambda: decode_action(cfg, hp, cog, noise))
        hp_cpu = tree_map(lambda t: t.cpu(), hp)
        a_cpu = decode_action(cfg, hp_cpu, cog.cpu(),
                              None if noise is None else noise.cpu())
        top = max(1.0, a_cpu.float().abs().max().item())
        err = (a_card.cpu().float() - a_cpu.float()).abs().max().item()
        if not err <= HEAD_REL * top:
            raise AssertionError(f"{head} head on the card is {err} from the "
                                 f"CPU (limit {HEAD_REL * top})")
        heads[head] = {
            "action_shape": list(action.shape),
            "action_max_abs": action.float().abs().max().item(),
            "n_params": sum(t.numel() for t in tree_leaves(hp)),
            "init_s": init_s, "cut": cut, "request_wall_ms": wall,
            "head_alone_wall_ms": ms_head, "payload_bytes": want_bytes,
            "launches": moved, "head_vs_cpu_max_err": err,
            "head_vs_cpu_limit": HEAD_REL * top}
        del hp, hp_cpu, params
    info = {"phase": "vla_heads", "model": cfg0.name,
            "d_model": cfg0.d_model, "n_layers": L, "vit_layers": Lv,
            "horizon": VLA_HEAD_HORIZON, "executor_pool": [lo, hi],
            "heads": heads, "launches": launches}
    emit(info)
    return info


def phase_serve_moe(st: dict, n_batches: int = 4, seq: int = LM_SEQ) -> dict:
    """``LMSplitExecutor`` on an MoE model at full width and depth: batches
    of 4 requests of 17 tokens, the cut walking a pool inside the MoE group,
    the int8 and then the packed-int4 codec on the cut.  Exact launches and
    payload bytes; the decoded cut activation within the codec's half step
    (and its bf16 rounding) of the unsplit hidden state at the cut; codec
    off, every cut equal to the monolithic forward."""
    cfg, model, params = st["cfg"], st["model"], st["params"]
    n, nd = cfg.n_layers, cfg.first_dense_layers
    lo = max(n // 2 - 1, nd)
    hi = min(lo + 3, n)
    mb, d = LM_MICRO_BATCH, cfg.d_model
    g = st["gen"]
    batches = [torch.randint(0, cfg.vocab_size, (mb, seq), generator=g,
                             device=DEV) for _ in range(n_batches)]
    cuts = [lo + i % (hi - lo + 1) for i in range(n_batches)]
    legs, launches = {}, dict.fromkeys(WRAPPERS, 0)
    for codec, qmax in (("int8", 127), ("int4", 7)):
        ex = LMSplitExecutor(cfg, SplitPlan(lo, hi, codec=codec))
        ex.run(params, batches[0], cuts[0])                 # warm-up
        torch.cuda.synchronize()
        want_bytes = (codec_ref.wire_bytes if codec == "int8"
                      else codec_ref.wire_bytes_int4)((mb, seq, d))
        if want_bytes != mb * seq * d * (8 if codec == "int8" else 4) // 8 \
                + mb * seq * (d // 128) * 4:
            raise AssertionError(f"{codec} wire bytes {want_bytes}")
        walls, sent = [], []
        _reset_counts()
        for tokens, cut in zip(batches, cuts):
            before = _counts()
            ms, (logits, payload) = _wall_ms(
                lambda: ex.run(params, tokens, cut))
            walls.append(ms)
            if _moved(before) != _want(n, codec):
                raise AssertionError(f"{cfg.name} {codec} request launched "
                                     f"{_moved(before)}")
            if tuple(logits.shape[:2]) != (mb, seq) \
                    or not torch.isfinite(logits.float()).all():
                raise AssertionError(f"{cfg.name} logits "
                                     f"{tuple(logits.shape)}")
            if payload_bytes(payload) != want_bytes:
                raise AssertionError(f"{cfg.name} {codec} payload "
                                     f"{payload_bytes(payload)} bytes, "
                                     f"expected {want_bytes}")
            sent.append((tokens, cut, payload))
        moved = _counts()
        half_steps = []
        for tokens, cut, payload in sent:
            # the decoded cut against the unsplit hidden state at the cut:
            # within half a quantisation step of its 128-column block (the
            # step abs-max / qmax, 1e-3 of it for the scale's own rounding)
            # plus the bf16 rounding of the decoded value (2^-8 of it)
            blk = (mb, seq, d // 128, 128)
            h = ex._edge_hidden(params, tokens, cut).float().reshape(blk)
            got = decode_activation(payload, cfg.dtype).float().reshape(blk)
            limit = 0.5 * (1 + 1e-3) * h.abs().amax(-1, keepdim=True) / qmax \
                + got.abs() * 2.0 ** -8
            ratio = ((got - h).abs() / limit.clamp_min(1e-30)).max().item()
            half_steps.append(ratio)
            if not ratio <= 1.0:
                raise AssertionError(f"{cfg.name} {codec}: the decoded cut is "
                                     f"{ratio} of its limit from the unsplit "
                                     "one")
        for k in WRAPPERS:
            launches[k] += moved[k]
        V = cfg.vocab_size             # the pad slots past it hold -1e30
        mono = model.forward(params, {"tokens": batches[0]})[..., :V]
        l_run = ex.run(params, batches[0], cuts[0])[0][..., :V]
        legs[codec] = {
            "payload_bytes": want_bytes, "request_wall_ms": walls,
            "request_wall_ms_median": statistics.median(walls),
            "cut_err_over_limit_max": max(half_steps),
            "logits_rel_err_vs_unsplit": (
                (l_run.float() - mono.float()).abs().max()
                / mono.float().abs().max()).item(),
            "argmax_agreement_vs_unsplit": (
                l_run.argmax(-1) == mono.argmax(-1)).float().mean().item(),
            "launches": moved}
    # ---- codec off equals the monolithic forward exactly, at every cut
    ex_raw = LMSplitExecutor(cfg, SplitPlan(lo, hi))
    tokens = batches[1]
    mono = model.forward(params, {"tokens": tokens})
    raw_err = max((ex_raw.run(params, tokens, c)[0].float()
                   - mono.float()).abs().max().item()
                  for c in range(lo, hi + 1))
    if raw_err != 0.0:
        raise AssertionError(f"{cfg.name} codec off: split logits are "
                             f"{raw_err} from the monolithic ones")
    prof = profile_request(lambda: ex_raw.run(params, tokens, cuts[0]))
    info = {"phase": "serve_moe", "model": cfg.name, "batch": mb,
            "seq": seq, "executor_pool": [lo, hi], "cuts": cuts,
            "codecs": legs, "codec_off_logits_max_err": raw_err,
            "profile_one_raw_request": prof, "launches": launches}
    emit(info)
    return info


# =============================================================== serve_cli
def phase_serve_cli(n_requests: int = 4, arch: str = None) -> dict:
    """``python -m repro_torch.launch.serve [--arch ARCH] --codec
    --requests 4`` on the card, through its ``main``: the controller plans
    the full config (Llama-3.2-3B unless ``arch`` names another) and the
    LSTM trains on the card, then the reduced data plane (8 layers, d_model
    64) serves the requests with the int8 codec on the cut, one 64-column
    block a row.  Fails unless the int8 kernels launched."""
    from repro_torch.launch import serve as serve_cli
    argv = (["--arch", arch] if arch else []) + [
        "--codec", "--requests", str(n_requests)]
    buf = io.StringIO()
    _reset_counts()
    with redirect_stdout(buf):
        wall, _ = _wall_ms(lambda: serve_cli.main(argv))
    launches = _counts()
    lines = buf.getvalue().splitlines()
    served = re.fullmatch(rf"served {n_requests} requests in (\d+) batches",
                          lines[1])
    if served is None or not re.fullmatch(
            r"cut payload: [0-9.]+ KB/request \(codec=on\)", lines[3]):
        raise AssertionError(f"launch.serve --codec printed {lines}")
    n_batches = int(served.group(1))
    if not launches["quantize_int8"] == launches["dequantize_int8"] \
            == n_batches >= 1:
        raise AssertionError(f"launch.serve --codec launched {launches} for "
                             f"{n_batches} batches; the int8 kernels run "
                             "once a batch")
    info = {"phase": "serve_cli", "argv": argv, "printed": lines,
            "wall_ms": wall, "launches": launches}
    if arch:
        info["phase_part"] = arch
    emit(info)
    return info


# ================================================================ examples
# the paper's example scripts on the port that use the card; the numpy-only
# multi_arch_segmentation prints what the reference script prints, which
# ends with its closing line rather than "OK"
EXAMPLES = {"quickstart_torch.py": "OK",
            "serve_vla_ecc_torch.py": "OK",
            "multi_arch_segmentation_torch.py":
                "(all 12 architectures segmented by the same Alg.1 + "
                "Eq.1/Eq.2 models; DESIGN.md §4)"}


def phase_examples() -> dict:
    """Each example as its own process on the card, over the same
    ``repro_torch``; fails unless it exits 0 with its last line."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": _src_dir()}
    runs = {}
    for name, last in EXAMPLES.items():
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable,
                              os.path.join(root, "examples", name)],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = out.stdout.splitlines()
        if out.returncode != 0 or not lines or lines[-1] != last:
            raise AssertionError(f"examples/{name} exited {out.returncode} "
                                 f"after {lines[-3:]}: {out.stderr[-2000:]}")
        runs[name] = {"wall_s": wall, "lines": len(lines),
                      "tail": lines[-4:]}
    info = {"phase": "examples", "runs": runs}
    emit(info)
    return info


# ==================================================================== main
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--llm-layers", type=int, default=None,
                    help="cut the LLM depth (default: the model's own)")
    ap.add_argument("--vit-layers", type=int, default=None)
    ap.add_argument("--attention-only", action="store_true",
                    help="run only the flash attention (B5) and flash-decode "
                         "(B6) cases and times, and count one decode step's "
                         "kernels")
    ap.add_argument("--ssd-only", action="store_true",
                    help="run only the SSD scan (B7) cases and times")
    ap.add_argument("--codec-only", action="store_true",
                    help="run only the int8 and int4 codec (B1-B4) cases, "
                         "times and host-time breakdown")
    ap.add_argument("--src", default=None,
                    help="drive the repro_torch under this directory instead "
                         "of this checkout's src/")
    args = ap.parse_args()

    env = phase_env()
    torch.cuda.set_device(0)
    if args.attention_only or args.ssd_only or args.codec_only:
        phase_build()
        if args.codec_only:
            phase_codec(get_config("openvla-7b"), get_config("llama3.2-3b"))
        if args.attention_only:
            phase_attention(get_config("openvla-7b"),
                            get_config("llama3.2-3b"),
                            get_config("zamba2-1.2b"),
                            get_config("phi3-mini-3.8b"))
        if args.ssd_only:
            phase_ssd(get_config("mamba2-1.3b"), get_config("zamba2-1.2b"))
        print(env["nvidia_smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    cfg, cogact = get_config("openvla-7b"), get_config("cogact-7b")
    if args.llm_layers is not None:
        cfg = cfg.replace(n_layers=args.llm_layers)
        cogact = cogact.replace(n_layers=args.llm_layers)
    if args.vit_layers is not None:
        cfg = cfg.replace(vit_layers=args.vit_layers)
        cogact = cogact.replace(vit_layers=args.vit_layers)

    phase_build()
    kernels = phase_kernels(cfg, get_config("llama3.2-3b"),
                            get_config("mamba2-1.3b"),
                            get_config("zamba2-1.2b"),
                            get_config("phi3-mini-3.8b"))
    ost = setup_openvla(cfg)
    runs = {"serve": phase_serve(ost)["launches"]}
    runs["delta"] = phase_delta(ost)["launches"]
    runs["vla_heads"] = phase_vla_heads(ost)["launches"]
    del ost
    gc.collect()                    # the OpenVLA parameters go before CogACT
    torch.cuda.empty_cache()
    cst = setup_cogact(cogact)
    runs["serve_cogact"] = phase_serve_cogact(cst)["launches"]
    runs["control"] = phase_control(cst)["launches"]
    del cst                         # the CogACT parameters go before Llama
    gc.collect()
    torch.cuda.empty_cache()
    lst = setup_lm("llama3.2-3b", SEED + 30)
    runs["generate"] = phase_generate(lst)["launches"]
    runs["serve_lm"] = phase_serve_lm(lst)["launches"]
    del lst                         # the Llama parameters go before Mamba2
    cli = [phase_serve_cli(arch=a)["launches"]
           for a in (None, GRANITE, DEEPSEEK)]
    runs["serve_cli"] = {k: sum(c[k] for c in cli) for k in WRAPPERS}
    for phase, name, seed in (("generate_ssm", "mamba2-1.3b", SEED + 70),
                              ("generate_hybrid", "zamba2-1.2b", SEED + 80)):
        gc.collect()
        torch.cuda.empty_cache()
        small = small_ssm_check(name)
        st = setup_lm(name, seed)
        runs[phase] = phase_generate(st, phase, small=small,
                                     f32_check=True)["launches"]
        del st
    gc.collect()
    torch.cuda.empty_cache()
    st = setup_lm("phi3-mini-3.8b", SEED + 90)
    runs["generate_phi3"] = phase_generate(
        st, "generate_phi3", steps=PHI3_STEPS, batches=(1,),
        f32_check=True)["launches"]
    del st
    serve_moe = []
    for phase, name, seed, steps in (
            ("generate_moe", GRANITE, SEED + 100, MOE_STEPS),
            ("generate_mla", DEEPSEEK, SEED + 110, PHI3_STEPS)):
        gc.collect()                # the model before goes first
        torch.cuda.empty_cache()
        st = setup_lm(name, seed)
        runs[phase] = phase_generate(st, phase, steps=steps,
                                     f32_check=True)["launches"]
        serve_moe.append(phase_serve_moe(st)["launches"])
        del st
    runs["serve_moe"] = {k: sum(r[k] for r in serve_moe) for k in WRAPPERS}
    gc.collect()
    torch.cuda.empty_cache()
    phase_examples()

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
                        "kernels_per_launch": KERNELS_PER_LAUNCH.get(name, 1),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "host_ms": r["host_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **{k: r[k] for k in ("launch_floor_ms", "served")
                           if k in r}})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
