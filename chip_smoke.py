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
dim 96), granite-moe-3b-a800m and deepseek-v2-lite-16b (MoE; MLA),
llama-3.2-vision-11b (VLM, cross attention over vision embeddings) and
seamless-m4t-large-v2 (encoder-decoder), the port's serving entry point
with the int8 codec at the reduced width of 64 columns, training
(``make_train_step``: Llama-3.2-3B and Mamba2-1.3B at full width and
depth, OpenVLA-7B and CogACT-7B at 16 LLM blocks, every reduced config
against the CPU) and the paper's example scripts — and holds every
hand-written kernel on those paths against its plain PyTorch version on
the card.  Needs one card, ``nvcc``
and no network; the kernels are built from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use.  Any phase
that fails raises, and the process then exits non-zero.

Phases, one JSON line each:

  env           torch / CUDA versions, the card's name and power limit
  build         seconds the kernels took to build
  dryrun        the dry run's four cells (``DRYRUN_CELLS``), each its own
                process on this machine's CPU, started beside the build
                (neither uses the card)
  kernels       each kernel against its plain version at the main paths'
                shapes and at awkward ones, with times
  serve         8 OpenVLA-7B int8 requests with the cut walking the pool,
                one two-pool request, and the checks on what came out;
                then 4 of them and the two-pool one again with a flight
                recorder: each tier's span and the stages nested in it
                (CUDA events), the same outputs and launches, a Chrome
                trace written to build/ and read back; one request under
                the profiler (the stages' ranges on the host only), and
                a request's wall without a recorder, with one and under
                the profiler
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
  generate_vlm  llama-3.2-vision-11b (40 dense blocks of 32/8 heads of 128,
                a tanh-gated cross block after every fifth, its gates drawn
                from [0.5, 1.0]): 1600 vision embeddings from the seed, a
                512-token prompt and 16 greedy steps at batch 1 and 4, flash
                attention 40 a prefill and flash-decode 40 a step, cross
                attention in plain products; the float32 gate with the
                vision passed through; a second vision draw moves the
                logits
  generate_encdec  seamless-m4t-large-v2 (24 encoder and 24 decoder layers,
                16 x 64 MHA): 512 frames from the seed, a 16-token
                teacher-forced decoder prefix and 64 greedy steps at batch
                1 and 4, flash attention 24 a prefill (the decoder; the
                encoder is plain) and flash-decode 24 a step; the float32
                gate; a second frames draw moves the logits
  serve_cli     ``python -m repro_torch.launch.serve --codec --requests 4``
                for Llama-3.2-3B, then with ``--arch`` granite-moe-3b-a800m
                and deepseek-v2-lite-16b
                on the card: its reduced data plane (d_model 64) ships the
                cut through the int8 codec at one 64-column block a row
  train_grad_cases  flash attention (B5) at Llama-3.2-3B's (2, 512, 24/8,
                128) and the VLA's (2, 273, 32 x 128), the SSD scan (B7) at
                Mamba2-1.3B's (2, 512, 64 x 64, N 128), float32 and bf16:
                the autograd Function (kernel forward, the plain version's
                gradients backward) against autograd of the plain version,
                one counted launch a forward; ``clip_by_global_norm`` on a
                bf16 and a float32 leaf bit-equal to the float32 scaling
  train         Llama-3.2-3B at full width and depth, bf16, remat: every
                leaf's gradient non-zero on the first batch, then 6
                ``make_train_step`` steps on 2 x 512 ``SyntheticStream``
                tokens (loss finite, parameters moved, 56 flash attention
                launches a step: 28 forward and 28 recomputed), the step
                split into forward, backward and optimizer, one step
                profiled, peak memory; the float32 gate, 2 layers at full
                width, one ``make_train_step`` step on the card against the
                same step on the CPU (loss, gradient norm, the parameters
                after it; every leaf's gradient by ``loss_and_grads``)
  train_ssm     Mamba2-1.3B the same way (96 SSD scans a step)
  train_vla     OpenVLA-7B (detok) and CogACT-7B (DiT, timesteps and noise
                handed in) at full width with 16 LLM blocks: one step each,
                every leaf's gradient non-zero but the LM head the DiT
                loss does not read, 32 flash attention launches, peak
                memory
  train_families  every reduced config in float32: one step on the card
                against the same step on the CPU
  spmd_ring, spmd_train, spmd_moe, spmd_decode  4 ranks spawned on the
                card (``launch/ranks.py``, the ``hostgloo`` group: every
                collective through host copies) after one-rank references
                on this process: the int8 ring over data = 4 on one
                Llama-3.2-3B block's gradient leaves against the plain ring
                (bit-equal) and the exact sum; Llama-3.2-3B at 4 layers on
                data 2 x model 2, 3 steps without and 3 with the int8 ring
                on 4 x 512 tokens (B5 on 12 q / 4 KV heads, 24 launches a
                rank a run) and a reduced float32 gate; one granite MoE
                layer with experts over model = 4; float32 decode (512-token
                prompt, 16 steps) with the cache over model = 4 on the
                sequence (sp), over model = 2 on the KV heads (tp, B6 on
                local heads) and tp with the int8 ring
  spmd_families the SSM, hybrid, VLM, encoder-decoder and VLA families at
                full width, depth cut, on the same ranks
  spmd_fsdp     the same ranks under ``make_rules(..., strategy="fsdp")``
                (ZeRO-3: every weight over data and model together on one
                dim, the batch over all four ranks): Llama-3.2-3B at 4
                layers, 3 bf16 steps without and 3 with the int8 ring on
                4 x 512 tokens against one rank (B5 on each rank's batch
                row with all 24 / 8 heads); every reduced config's float32
                ``loss_and_grads`` against one rank; float32 greedy decode
                of Llama-3.2-3B and Mamba2-1.3B at 4 layers (batch 4, a
                128-token prompt, 16 steps, B5 / B6 / B7 on each rank's
                row); then ``spmd_walls``
  examples      ``examples/quickstart_torch.py``, ``serve_vla_ecc_torch.py``,
                ``train_lm_torch.py`` (300 steps of a ~100M Llama with a
                failure injected half-way) and
                ``multi_arch_segmentation_torch.py``, each as its own
                process on the card, with their walls; then ``python -m
                repro_torch.launch.train --reduce smoke --steps 20
                --fail-at 10 --ckpt-every 5``

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
``--train-only`` runs the gradient cases and the four training paths, and
``--spmd-only`` the SPMD phases (``--spmd-lr-probe``: the one-rank
runs that chose ``spmd_train``'s learning rate); ``--serve-only`` runs the
build and the ``serve`` phase alone.
With ``--src DIR`` each does so for the ``repro_torch`` under ``DIR``, e.g. a
parent commit unpacked beside this one, so that two versions are compared
in one call.
"""
from __future__ import annotations

import argparse
import functools
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
import types
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
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.telemetry import RANGE_PREFIX, FlightRecorder
from repro_torch.data.pipeline import DataConfig, SyntheticStream, to_device
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
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import capacity, moe_ffn
from repro_torch.models.sharding import init_params, tree_leaves, tree_map
from repro_torch.models.ssm import ssd_step
from repro_torch.models.transformer import _layer_slice, lm_hidden, lm_logits
from repro_torch.models.vla import (action_head_specs, decode_action,
                                   draw_noise, vla_backbone)
from repro_torch.runtime import action_graph as AG
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
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, lr_at)
from repro_torch.train.train_loop import (init_state, loss_and_grads,
                                          make_train_step)

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
# the cross-attention paths: llama-3.2-vision-11b (VLM: a 512-token prompt
# over 1600 vision embeddings, 16 greedy steps) and seamless-m4t-large-v2
# (encoder-decoder: 512 source frames, a 16-token teacher-forced decoder
# prefix, 64 greedy steps); the cross gates are drawn from [0.5, 1.0]
VLM, ENCDEC = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
VLM_STEPS = 16
ENCDEC_SRC, ENCDEC_PREFIX, ENCDEC_STEPS = 512, 16, 64
CROSS_GATES = (0.5, 1.0)


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


def spmd_attn_shapes(lcfg) -> list:
    """(B, S, H, KV, D, dtype) of B5's launches on one rank of the SPMD
    phases: spmd_train's bf16 steps (batch over data 2, heads over model
    2) and its reduced float32 gate, spmd_decode's float32 prefills (tp:
    model 2, sp: model SPMD_WORLD)."""
    H, KV, hd = lcfg.n_heads, lcfg.n_kv_heads, lcfg.resolved_head_dim
    r = get_config("llama3.2-3b").reduced()
    return [(SPMD_TRAIN_BATCH // 2, SPMD_TRAIN_SEQ, H // 2, KV // 2, hd,
             torch.bfloat16),
            (SPMD_F32_BATCH // 2, SPMD_F32_SEQ, r.n_heads // 2,
             r.n_kv_heads // 2, r.resolved_head_dim, torch.float32),
            (1, SPMD_PROMPT, H // 2, KV // 2, hd, torch.float32),
            (1, SPMD_PROMPT, H // SPMD_WORLD, KV // SPMD_WORLD, hd,
             torch.float32)]


def spmd_decode_shape(lcfg) -> tuple:
    """(B, H, KV, T, D) of B6's launches on one rank of spmd_decode's tp
    run: batch 1, the heads over model 2, the prompt + steps buffer."""
    return (1, lcfg.n_heads // 2, lcfg.n_kv_heads // 2,
            SPMD_PROMPT + SPMD_STEPS, lcfg.resolved_head_dim)


def attention_cases(cfg, lcfg, zcfg, pcfg) -> tuple:
    """B5 and B6 against their plain versions at the shapes the main paths
    give them (``cfg`` the served VLA, ``lcfg`` Llama-3.2-3B, ``zcfg``
    Zamba2-1.2B, ``pcfg`` phi3-mini-3.8b's head dim 96, the MoE models:
    granite-moe-3b-a800m's GQA 24/8 x 64 and deepseek-v2-lite-16b's MLA
    prefill at head dims (192, 128), and the cross-attention families'
    causal self attention: llama-3.2-vision-11b's 32/8 x 128 and
    seamless-m4t-large-v2's decoder, 16/16 x 64) and at awkward ones, and
    repeated calls held bit-equal.  Returns (B5 cases, B6 cases)."""
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
    # the cross-attention families' causal self attention: the VLM's
    # prefill (32/8 heads of 128) and the encoder-decoder's teacher-forced
    # decoder prefix (16/16 of 64) at batch 1 and 4, and in float32 at the
    # lengths of the float32 gate's full forward
    vcfg, ecfg = get_config(VLM), get_config(ENCDEC)
    H_v, KV_v, hd_v = vcfg.n_heads, vcfg.n_kv_heads, vcfg.resolved_head_dim
    H_e, KV_e, hd_e = ecfg.n_heads, ecfg.n_kv_heads, ecfg.resolved_head_dim
    for i, B in enumerate(LM_BATCHES):
        attn_cases.append(check_attn(B, LM_PROMPT, LM_PROMPT, H_v, KV_v, hd_v,
                                     bf, True, 110 + i))
        attn_cases.append(check_attn(B, ENCDEC_PREFIX, ENCDEC_PREFIX, H_e,
                                     KV_e, hd_e, bf, True, 112 + i))
    S_v, S_e = LM_PROMPT + F32_GATE_STEPS, ENCDEC_PREFIX + F32_GATE_STEPS
    attn_cases += [check_attn(1, S_v, S_v, H_v, KV_v, hd_v, f32, True, 114),
                   check_attn(1, S_e, S_e, H_e, KV_e, hd_e, f32, True, 115)]
    # the SPMD phases' local heads: spmd_train's (data 2 x model 2, bf16,
    # and the reduced float32 gate's) and spmd_decode's prefills (float32,
    # model SPMD_WORLD for sp and 2 for tp)
    for i, (B, S, h, kv, d, dt) in enumerate(spmd_attn_shapes(lcfg)):
        attn_cases.append(check_attn(B, S, S, h, kv, d, dt, True, 120 + i))
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
    # the VLM's decode (GQA 4x over 528 positions) and the encoder-decoder's
    # (MHA 16 x 64 over 80)
    for (h, kv, d, t, p0, seed) in (
            (H_v, KV_v, hd_v, LM_PROMPT + VLM_STEPS, LM_PROMPT, 360),
            (H_e, KV_e, hd_e, ENCDEC_PREFIX + ENCDEC_STEPS, ENCDEC_PREFIX,
             370)):
        for B in LM_BATCHES:
            for kv_len in (1, p0 + 1, t):
                dec_cases.append(check_decode(B, h, kv, t, d, kv_len, bf,
                                              seed + B + kv_len, flat=True))
        dec_cases.append(check_decode(1, h, kv, t, d, t - 2, f32, seed + 1,
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
    # spmd_decode's tp: float32, the cache's KV heads over model 2, each
    # rank's flat (B, T, KV/2 * hd) shard read through its strides
    B, h, kv, t, d = spmd_decode_shape(lcfg)
    for kv_len in (1, SPMD_PROMPT + 1, t):
        dec_cases.append(check_decode(B, h, kv, t, d, kv_len, f32,
                                      380 + kv_len, flat=True))
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


def attn_bound(B, S, T, H, KV, D, causal, Dv=None,
               dtype=torch.bfloat16) -> tuple:
    """The card's least time for one prefill attention: q, k, v read and
    the output written once; the two products over the (query, key) pairs
    the mask keeps (q k^T at D, p v at Dv)."""
    Dv = Dv or D
    pairs = S * (S + 1) / 2 if causal and S == T else S * T
    size = torch.finfo(dtype).bits // 8
    return bound(size * B * (H * S * (D + Dv) + KV * T * (D + Dv)),
                 2.0 * B * H * (D + Dv) * pairs, dtype)


def time_attn(B, S, H, KV, D, max_err, Dv=None,
              dtype=torch.bfloat16) -> dict:
    """Times of the flash attention kernel at a served causal shape (bf16
    unless ``dtype`` says otherwise): the kernel, its host time, the plain
    version, and as the yardstick ``F.scaled_dot_product_attention`` on
    (B, H, S, D) views of the same tensors (grouped heads by
    ``enable_gqa``, a backend that takes Dv != D at the MLA shapes; the
    port calls it nowhere)."""
    q, k, v = _attn_inputs(B, S, S, H, KV, D, dtype, 10 + B + S + D, Dv=Dv)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by = attn_bound(B, S, S, H, KV, D, True, Dv, dtype)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
            "shape": [B, S, H, KV, D] + ([Dv] if Dv else []),
            "dtype": str(dtype).split(".")[-1], "causal": True,
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


def time_decode(B, H, KV, T, D, kv_len, max_err,
                dtype=torch.bfloat16) -> dict:
    """Times of the flash-decode kernel on a flat cache (bf16 unless
    ``dtype`` says otherwise) at live length ``kv_len``: the kernel, its
    host time, the plain version, and as the yardstick
    ``F.scaled_dot_product_attention`` on the same q and the live K/V
    prefix (grouped heads by ``enable_gqa``; the port calls it
    nowhere)."""
    q, k, v = _decode_inputs(B, H, KV, T, D, dtype, 400 + T, flat=True)
    q4, kl, vl = q[:, :, None], k[:, :, :kv_len], v[:, :, :kv_len]
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (2 * B * KV * kv_len * D + 2 * B * H * D)
    b_ms, b_by = bound(nbytes, 4.0 * B * H * kv_len * D, dtype)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
            "shape": [B, H, KV, T, D], "kv_len": kv_len,
            "dtype": str(dtype).split(".")[-1],
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


SERVED_KEYS = ("shape", "dtype", "kv_len", "split_plan", "ms", "host_ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")


def attention_times(cfg, lcfg, zcfg, pcfg, attn_cases, dec_cases) -> dict:
    """B5 and B6 timed at every shape the main paths give them, each with
    its bound and its library time: B5 at the VLA's 273 tokens (``serve``,
    ``serve_cogact``, ``control``), ``serve_lm``'s 4 x 17, and the
    512-token prefills of Llama-3.2-3B and Zamba2-1.2B at batch 1 and 4 and
    of phi3-mini-3.8b at batch 1, the MoE models' and llama-3.2-vision-11b's
    512-token prefills and seamless-m4t-large-v2's 16-token decoder prefix
    at batch 1 and 4; B6 at ``generate``'s and ``generate_hybrid``'s
    576-position buffers at batch 1 and 4, Llama-3.2-3B's heads at 8192
    positions, phi3's 528-position buffer, granite's 544, the VLM's 528
    and seamless's 80 at batch 1 and 4.  The first shape of each heads its
    record; all of them are in its ``served`` list."""
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
    vcfg, ecfg = get_config(VLM), get_config(ENCDEC)
    H_v, KV_v, hd_v = vcfg.n_heads, vcfg.n_kv_heads, vcfg.resolved_head_dim
    H_e, KV_e, hd_e = ecfg.n_heads, ecfg.n_kv_heads, ecfg.resolved_head_dim
    served += [time_attn(B, LM_PROMPT, H_v, KV_v, hd_v, attn_err)
               for B in LM_BATCHES]
    served += [time_attn(B, ENCDEC_PREFIX, H_e, KV_e, hd_e, attn_err)
               for B in LM_BATCHES]
    errs = {dt: max(c["max_err"] for c in attn_cases
                    if c.get("dtype") == str(dt).split(".")[-1])
            for dt in (torch.bfloat16, torch.float32)}
    served += [time_attn(B, S, h, kv, d, errs[dt], dtype=dt)
               for B, S, h, kv, d, dt in spmd_attn_shapes(lcfg)]
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
    T_v, T_e = LM_PROMPT + VLM_STEPS, ENCDEC_PREFIX + ENCDEC_STEPS
    served += [time_decode(B, H_v, KV_v, T_v, hd_v, T_v, dec_err)
               for B in LM_BATCHES]
    served += [time_decode(B, H_e, KV_e, T_e, hd_e, T_e, dec_err)
               for B in LM_BATCHES]
    B, h, kv, t, d = spmd_decode_shape(lcfg)
    served.append(time_decode(B, h, kv, t, d, t, max(
        c["max_err"] for c in dec_cases if c.get("dtype") == "float32"),
        dtype=torch.float32))
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


def time_ssd(B, T, H, P, N, chunk, max_err, dtype=torch.bfloat16) -> dict:
    """Times of the SSD scan kernel at a served shape (bf16 unless
    ``dtype`` says otherwise): the kernel, its host time and the plain
    version; no single PyTorch call computes the scan, so there is no
    library time."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, T, H, P, N, dtype, 600 + B + N)
    b_ms, b_by, nbytes, flops = ssd_bound(B, T, H, P, N, chunk, dtype)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:74",
            "shape": [B, T, H, P, N], "chunk": chunk,
            "dtype": str(dtype).split(".")[-1],
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
    fam = family_kernel_cases(ssd_err, attn_cases, dec_cases)
    served += fam["ssd_times"]
    rec["ssd_scan"]["served"] = [
        {k: v for k, v in r.items() if k in (
            "shape", "dtype", "plan", "ms", "host_ms", "plain_ms",
            "bound_ms", "bound_by", "bytes", "flops", "library_ms")}
        for r in served]
    for name in ("flash_attention", "decode_attention"):
        rec[name]["served"] += [{k: r[k] for k in SERVED_KEYS if k in r}
                                for r in fam[name + "_times"]]
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
          "spmd_family_cases": fam["cases"],
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


# the stage tree of a VLA request (``VLASplitExecutor.run``): each tier's
# span, then the stages nested in it
EDGE_STAGES = ("edge_fwd", "vit", "edge_blocks", "encode")
CLOUD_STAGES = ("cloud_fwd", "decode", "cloud_blocks", "action_head")
CLOUD_STAGES_TWO_POOL = ("cloud_fwd", "decode", "cloud_blocks", "encode",
                         "decode", "edge_blocks", "action_head")


def _span_checks(rec, n_before: int, wall_ms: float, two_pool: bool) -> list:
    """The two groups one traced request adds: edge then cloud, on the
    executor lanes, each its tier's span and the stages nested in it, one
    run number, the stages inside their parent and each starting where the
    one before it ended, cloud starting where edge ended, both together
    within the request's wall.  Returns each stage's name (under its
    parent's) and milliseconds, in the groups' order."""
    groups = rec.spans.items[n_before:]
    want = (EDGE_STAGES, CLOUD_STAGES_TWO_POOL if two_pool else CLOUD_STAGES)
    if len(groups) != 2 or tuple(tuple(s.name for s in g)
                                 for g in groups) != want:
        raise AssertionError(f"a traced request added {groups}")
    (e, *_), (c, *_) = groups
    for g, lane in zip(groups, ("executor:edge", "executor:cloud")):
        top, end = g[0], g[0].t0_s + g[0].dur_s
        if {s.lane for s in g} != {lane} or {s.cat for s in g} != \
                {"executor"} or {s.req for s in g} != {e.req} \
                or [s.parent for s in g] != [""] + [top.name] * (len(g) - 1):
            raise AssertionError(f"executor spans {g}")
        for s in g:
            if not (s.dur_s >= 0.0 and top.t0_s - 1e-9 <= s.t0_s
                    and s.t0_s + s.dur_s <= end + 1e-9):
                raise AssertionError(f"{s} outside {top}")
        for prev, s in zip(g[1:], g[2:]):
            if abs(s.t0_s - (prev.t0_s + prev.dur_s)) > 1e-9:
                raise AssertionError(f"{s} does not start where {prev} ends")
    if not (c.t0_s >= e.t0_s and abs(c.t0_s - (e.t0_s + e.dur_s)) <= 1e-9
            and (e.dur_s + c.dur_s) * 1e3 <= wall_ms):
        raise AssertionError(f"edge {e.dur_s} s + cloud {c.dur_s} s against "
                             f"a request wall of {wall_ms} ms")
    return [[f"{s.parent}/{s.name}" if s.parent else s.name,
             s.dur_s * 1e3] for g in groups for s in g]


def _ranges_on_the_host_only(prof) -> dict:
    """The profiler's events of a request: the program's ``roboecc.*``
    ranges are host events, none has a device-side twin and none is a user
    annotation; returns how many ranges and device operations it holds."""
    ranges = devs = 0
    for e in prof.events():
        cuda = e.device_type == torch.autograd.DeviceType.CUDA
        ours = e.name.startswith(RANGE_PREFIX)
        if cuda and (ours or e.is_user_annotation):
            raise AssertionError(f"device-side event {e.name!r} "
                                 f"(user annotation {e.is_user_annotation})")
        if ours and e.is_user_annotation:
            raise AssertionError(f"range {e.name!r} is a user annotation")
        ranges += ours
        devs += cuda
    return {"ranges": ranges, "device_events": devs}


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
        span_ms.append(_span_checks(rec, n_before, ms, exr is ex2))
        traced_walls.append(ms)
    trace_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "serve_executor.trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    with open(export_chrome_trace(rec, trace_path)) as f:
        loaded = json.load(f)
    spans_x = [e for e in loaded["traceEvents"] if e["ph"] == "X"]
    want_x = (EDGE_STAGES + CLOUD_STAGES) * 4 + EDGE_STAGES \
        + CLOUD_STAGES_TWO_POOL
    if loaded != json.loads(json.dumps(chrome_trace(rec))) \
            or sorted(e["name"] for e in spans_x) != sorted(want_x) \
            or any(("parent" in e["args"])
                   == (e["name"] in ("edge_fwd", "cloud_fwd"))
                   for e in spans_x):
        raise AssertionError(f"Chrome trace {trace_path} read back as "
                             f"{[e['name'] for e in spans_x]}")

    # ---- the stages under the profiler: FUNCTION-scope ranges on the host,
    # none on the device; one request's wall without a recorder, with one,
    # and under the profiler (no recorder), 5 of each
    p_0, t_0 = requests[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as rprof:
        a_p, pay_p = ex.run(params, p_0, t_0, cuts[0])
        torch.cuda.synchronize()
    if not torch.equal(a_p, untraced[0][0]) \
            or not _same_payload(pay_p, untraced[0][1]):
        raise AssertionError("a profiled request differs from the same "
                             "request without the profiler")
    profiled = _ranges_on_the_host_only(rprof)
    if profiled["ranges"] != len(EDGE_STAGES + CLOUD_STAGES) \
            or profiled["device_events"] < 1:
        raise AssertionError(f"a profiled request held {profiled}")
    stage_walls = {"plain": [], "recorder": [], "profiler": []}
    for _ in range(5):
        stage_walls["plain"].append(
            _wall_ms(lambda: ex.run(params, p_0, t_0, cuts[0]))[0])
        stage_walls["recorder"].append(_wall_ms(
            lambda: ex.run(params, p_0, t_0, cuts[0], recorder=rec))[0])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            stage_walls["profiler"].append(
                _wall_ms(lambda: ex.run(params, p_0, t_0, cuts[0]))[0])

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
                            "and launches equal to the untraced runs; the "
                            "stages timed by CUDA events",
                "stage_span_ms": span_ms,
                "traced_request_wall_ms": traced_walls,
                "profiled_request": profiled,
                "request_wall_ms_by_tracing": stage_walls,
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
    warm_calls = dict(ex.dit.calls)
    if warm_calls != {AG.REPLAYS: 1, AG.CAPTURES: 1, AG.EAGER: 0}:
        raise AssertionError(f"the warm-up's DiT head calls {warm_calls}: "
                             "expected one capture, then one replay")

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
    moved_calls = {k: ex.dit.calls[k] - warm_calls[k] for k in warm_calls}
    if moved_calls != {AG.REPLAYS: n_requests, AG.CAPTURES: 0, AG.EAGER: 0}:
        raise AssertionError(f"after the warm-up the DiT head's calls moved "
                             f"by {moved_calls}: expected only replays")

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

    dit_graph = _dit_graph_checks(st, ex, h, [r[2] for r in requests[:2]])

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
            "dit_graph": dit_graph,
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


@torch.no_grad()
def _dit_graph_checks(st: dict, ex, x, noises) -> dict:
    """The DiT head from the executor's CUDA graph against the eager head
    (the final norm and ``decode_action``), bit for bit, with autograd off
    as in the executor's ``run`` (with it on, the head runs eagerly, as it
    does in this phase's stage walls and profile): at batch 1 on the
    served hidden state ``x`` and at the DiT cell's batch 64; two answers
    in a row, the first compared after the second is made, so that neither
    is the graph's own output; a new batch captures once, then replays.
    Then both heads' walls and the profiler's view of a replay at 64."""
    cfg, params = st["cfg"], st["params"]
    g = gen(SEED + 22)

    def eager(x, noise):
        h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return decode_action(cfg, params["action"], h[:, -1], noise)

    x64 = torch.randn((64, 2, cfg.d_model), generator=g, device=DEV
                      ).to(x.dtype)
    n64 = [torch.randn((64, cfg.action_horizon, cfg.action_dim), generator=g,
                       device=DEV) for _ in range(2)]
    out = {}
    for name, xs, ns, want_calls in (
            ("batch_1", x, noises, {AG.REPLAYS: 2, AG.CAPTURES: 0}),
            ("batch_64", x64, n64, {AG.REPLAYS: 1, AG.CAPTURES: 1})):
        before = dict(ex.dit.calls)
        got = [ex._action_decode(params, xs, n) for n in ns]
        moved = {k: ex.dit.calls[k] - before[k] for k in before}
        if moved != dict(want_calls, **{AG.EAGER: 0}):
            raise AssertionError(f"DiT head at {name}: calls moved by "
                                 f"{moved}, expected {want_calls}")
        want = [eager(xs, n) for n in ns]
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"DiT head at {name}: the graph's replay is "
                                 f"{err} from the eager head")
        if torch.equal(got[0], got[1]):
            raise AssertionError(f"DiT head at {name}: two noises, one answer")
        graph_ms = [_wall_ms(lambda: ex._action_decode(params, xs, ns[0]))[0]
                    for _ in range(5)]
        eager_ms = [_wall_ms(lambda: eager(xs, ns[0]))[0] for _ in range(5)]
        out[name] = {"bit_equal": True, "max_abs_diff": err,
                     "calls_moved": moved,
                     "graph_wall_ms_median": statistics.median(graph_ms),
                     "eager_wall_ms_median": statistics.median(eager_ms)}
    out["profile_replay_batch_64"] = profile_request(
        lambda: ex._action_decode(params, x64, n64[0]))
    out["profile_eager_batch_64"] = profile_request(lambda: eager(x64, n64[0]))
    out["calls"] = dict(ex.dit.calls)
    return out


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
    dense and vlm, one flash attention per (dense) block and one
    flash-decode per block and step, the VLM's cross blocks plain; ssm, one
    SSD scan per Mamba layer and nothing per step; hybrid, the shared
    block's flash attention at each site and the scans, and one
    flash-decode per site and step; moe, one flash attention per block
    and one flash-decode per block and step (MLA: none, its decode is the
    absorbed form in plain products); audio, one flash attention per
    decoder layer (the encoder is plain) and one flash-decode per decoder
    layer and step.  The VLM's cross gates, zero at init, are drawn from
    ``CROSS_GATES`` (a trained checkpoint's are not zero, and at zero the
    cross path would add nothing); the VLM's vision embeddings and the
    encoder-decoder's frames come from the seed too (``_batch``)."""
    cfg = get_config(name)
    model = build(cfg)
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen(seed), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L = cfg.n_layers
    side, cache_kw, prompt = None, {}, LM_PROMPT
    if cfg.family in ("dense", "vlm"):
        per_prefill, per_step = _want(L), _want(0, decode=L)
    elif cfg.family == "moe":       # MLA decodes in the absorbed form: plain
        per_prefill = _want(L)
        per_step = _want(0, decode=0 if cfg.use_mla else L)
    elif cfg.family == "ssm":
        per_prefill, per_step = _want(0, ssd=L), _want(0)
    elif cfg.family == "audio":
        Ld = cfg.n_dec_layers
        per_prefill, per_step = _want(Ld), _want(0, decode=Ld)
    else:
        ns = n_sites(cfg)
        per_prefill, per_step = _want(ns, ssd=L), _want(0, decode=ns)
    if cfg.family == "vlm":
        side = ("vision", (cfg.n_vision_tokens, cfg.d_model))
        g = gen(seed + 2)
        for k in ("gate_attn", "gate_mlp"):
            w = params["cross_blocks"][k]
            w.copy_(torch.empty(w.shape, device=DEV).uniform_(
                *CROSS_GATES, generator=g))
    elif cfg.family == "audio":
        side = ("frames", (ENCDEC_SRC, cfg.d_model))
        cache_kw, prompt = {"src_len": ENCDEC_SRC}, ENCDEC_PREFIX
    return {"cfg": cfg, "model": model, "params": params, "init_s": init_s,
            "held_before_bytes": held_before,
            "n_params": sum(t.numel() for t in tree_leaves(params)),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "per_prefill": per_prefill, "per_step": per_step,
            "gen": gen(seed + 1), "side": side, "side_seed": seed + 3,
            "side_inputs": {}, "cache_kw": cache_kw, "prompt": prompt}


def _batch(st: dict, tokens: torch.Tensor, draw: int = 0) -> dict:
    """The batch of ``tokens``: with the VLM's vision embeddings
    ``(B, 1600, 4096)`` or the encoder-decoder's frames ``(B, 512, 1024)``,
    bf16 draws from the seed, one per batch size and ``draw`` (a second
    draw checks that the cross path moves the logits)."""
    if st["side"] is None:
        return {"tokens": tokens}
    key, shape = st["side"]
    B = tokens.shape[0]
    if (B, draw) not in st["side_inputs"]:
        st["side_inputs"][(B, draw)] = torch.randn(
            (B,) + shape, generator=gen(st["side_seed"] + 100 * draw + B),
            device=DEV, dtype=torch.float32).to(torch.bfloat16)
    return {"tokens": tokens, key: st["side_inputs"][(B, draw)]}


def _family_launches(prof: dict, prefix: str) -> int:
    """CUDA kernels in a profiled window whose hand-written family starts
    with ``prefix``."""
    return sum(g["launches"] for name, g in prof.get("by_group", {}).items()
               if name.startswith("hand-written: " + prefix))


def _decode_kernel_launches(prof: dict) -> int:
    """CUDA kernels of the flash-decode source in a profiled window."""
    return _family_launches(prof, "decode")


# torch.profiler's trace has been seen to lose one kernel record of a
# window now and then (23 of 24 flash-decode kernels, 31 of 32, where the
# launch counters and the outputs held): a window whose trace holds fewer
# kernels of the family than the calls it made is profiled again, at most
# TRACE_TRIES times in all.  The count must still come out exact; a trace
# with more kernels than calls fails at once.
TRACE_TRIES = 3


def _profile_exact(fn, count, want: int) -> tuple:
    """``profile_request(fn)`` with ``count(profile)``, the kernels of a
    family in its trace, against ``want`` (see TRACE_TRIES): returns
    (the last profile, each try's count); no count when the trace holds no
    device time.  ``fn`` must give the same launches when run again."""
    tries = []
    for _ in range(TRACE_TRIES):
        prof = profile_request(fn)
        if not isinstance(prof.get("device_busy_ms"), float):
            break
        tries.append(count(prof))
        if tries[-1] >= want:
            break
    return prof, tries


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
    kw = st["cache_kw"]
    max_len = prompt + steps
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=st["gen"], device=DEV)
    greedy_generate(model, params, _batch(st, tokens[:, :64]), 2,
                    **kw)                                         # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts set to 0 just before, read just after
    _reset_counts()
    wall, out = _wall_ms(lambda: greedy_generate(
        model, params, _batch(st, tokens), steps, max_len=max_len, **kw))
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
        model, params, _batch(st, tokens), max_len, **kw))
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
    # the last position again, which writes the same cache entries
    prof, dec_tries = _profile_exact(
        lambda: step(params, cache, cur, max_len - 1),
        _decode_kernel_launches, per_step["decode_attention"])

    # ---- each step's logits against one full forward over prompt + tokens
    before = _counts()
    full = model.forward(params, _batch(st, torch.cat([tokens, toks], 1))
                         )[:, prompt:]
    if _moved(before) != per_prefill:
        raise AssertionError(f"full forward launched {_moved(before)}")
    # ---- one prefill by kernel family, from torch.profiler
    n_ssd = per_prefill["ssd_scan"]
    prof_pre, ssd_tries = _profile_exact(
        lambda: prefill_and_pad(model, params, _batch(st, tokens), max_len,
                                **kw),
        lambda p: min(_family_launches(p, "ssd_" + k)
                      for k in ("state", "out")) if n_ssd else 0, n_ssd)
    busy_pre = prof_pre.get("device_busy_ms")
    if isinstance(busy_pre, float):
        got = {k: _family_launches(prof_pre, "ssd_" + k)
               for k in ("state", "out")}
        if any(n != n_ssd for n in got.values()):
            raise AssertionError(f"one prefill ran SSD kernels {got} for "
                                 f"{n_ssd} calls (tries {ssd_tries}); a call "
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
                             f"calls (tries {dec_tries}); a call is one "
                             "kernel launch")
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
            "trace_tries": {"decode": dec_tries, "ssd": ssd_tries},
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


def phase_generate(st: dict, name: str = "generate",
                   steps: int = LM_STEPS, small: dict = None,
                   batches=LM_BATCHES, f32_check: bool = False) -> dict:
    """``runtime/serving.py::greedy_generate`` on an LM at full width and
    depth: a 512-token prompt (two SSD chunks; the encoder-decoder's
    16-token prefix after 512 frames) and 64 greedy steps, at batch 1 and
    4 (or ``steps`` at ``batches``); with ``f32_check``, the same model in
    float32 against its full forward (``full_width_f32_check``, over
    ``steps``); for the VLM and the encoder-decoder, a second vision or
    frames draw against the first (``second_input_check``)."""
    prompt = st["prompt"]
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
    if cfg.family in ("dense", "hybrid", "vlm", "audio") or (
            cfg.family == "moe" and not cfg.use_mla):
        info["heads"] = [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim]
    if cfg.family == "vlm":
        info["cross"] = {"every": cfg.cross_attn_every,
                         "blocks": cfg.n_layers // cfg.cross_attn_every,
                         "vision_tokens": cfg.n_vision_tokens,
                         "gates_drawn_from": list(CROSS_GATES)}
    if cfg.family == "audio":
        info["encdec"] = {"enc_layers": cfg.n_enc_layers,
                          "dec_layers": cfg.n_dec_layers,
                          "src_len": ENCDEC_SRC, "prefix": prompt}
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
    if st["side"] is not None:
        info["second_input"] = second_input_check(st)
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
    512-token prompt (the encoder-decoder: its 512 frames and 16-token
    prefix; the VLM's vision embeddings and the frames passed through)
    plus ``steps`` decode steps at batch 1.  The gate, as
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
    params, V, P = st["params"], cfg.vocab_size, st["prompt"]
    # the gate's tokens are drawn first, as they always were; the later
    # steps' after them
    tokens = torch.randint(0, V, (1, P + F32_GATE_STEPS),
                           generator=st["gen"], device=DEV)
    if steps > F32_GATE_STEPS:
        tokens = torch.cat([tokens, torch.randint(
            0, V, (1, steps - F32_GATE_STEPS), generator=st["gen"],
            device=DEV)], 1)
    before = _counts()
    gate_full = model.forward(
        params, _batch(st, tokens[:, :P + F32_GATE_STEPS]))[
        :, P - 1:, :V].float()
    full = model.forward(params, _batch(st, tokens))[:, P - 1:, :V].float()
    logits, cache = prefill_and_pad(model, params,
                                    _batch(st, tokens[:, :P]), P + steps,
                                    **st["cache_kw"])
    outs = [logits[:, 0]]
    for i in range(P, P + steps):
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
    return {"dtype": "float32", "batch": 1, "prompt": P,
            "steps": steps, "gate_steps": F32_GATE_STEPS, "max_err": err,
            "limit": FULL_F32_REL * top, "logits_max_abs": top,
            "max_err_per_step": per_step,
            "logits_max_abs_per_step": top_step,
            "max_err_prefill_first_last_step": [per_step[0], per_step[1],
                                                per_step[-1]],
            "rel_err_prefill_first_last_step": [rel[0], rel[1], rel[-1]],
            "rel_err_max_all_steps": max(rel)}


# limit of the check below, stated before its first run: a second draw of
# the vision embeddings (frames) moves the prefill's last logits and the
# first step's each by at least this share of the largest logit
SECOND_DRAW_REL = 1e-2


def second_input_check(st: dict) -> dict:
    """The cross path is live at full width: one prompt with a second draw
    of the VLM's vision embeddings (the encoder-decoder's frames) against
    the first, at batch 1 in bf16: the prefill's last logits and one
    decode step's, each moved by at least ``SECOND_DRAW_REL`` of the
    largest logit.  Recorded: the same draw run twice (the run-to-run
    difference the move stands against)."""
    cfg, model, params = st["cfg"], st["model"], st["params"]
    P, V = st["prompt"], cfg.vocab_size
    tokens = torch.randint(0, V, (1, P + 1), generator=st["gen"], device=DEV)

    def run(draw):
        logits, cache = prefill_and_pad(model, params,
                                        _batch(st, tokens[:, :P], draw),
                                        P + 1, **st["cache_kw"])
        step, _ = model.decode(params, cache, tokens[:, P:], P)
        return torch.cat([logits[:, 0], step[:, 0]])[:, :V].float()

    a, again, b = run(0), run(0), run(1)
    top = a.abs().max().item()
    moved = (a - b).abs().amax(-1).tolist()            # [prefill, step]
    if not min(moved) >= SECOND_DRAW_REL * top:
        raise AssertionError(f"{cfg.name}: a second "
                             f"{st['side'][0]} draw moved the logits by "
                             f"{moved}, under {SECOND_DRAW_REL} of {top}")
    return {"input": st["side"][0], "moved_prefill_step": moved,
            "limit": SECOND_DRAW_REL * top, "logits_max_abs": top,
            "same_draw_twice_max_diff": (a - again).abs().max().item(),
            "argmax_changed_prefill_step":
                (a.argmax(-1) != b.argmax(-1)).tolist()}


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
# =================================================================== train
# The training paths (limits stated before their first run on the card):
# TRAIN_STEPS AdamW steps of Llama-3.2-3B and Mamba2-1.3B at full width and
# depth on batches of TRAIN_BATCH x TRAIN_SEQ from SyntheticStream with
# OptConfig's defaults; their float32 gates, TRAIN_GATE_LAYERS layers at
# full width on TRAIN_BATCH x TRAIN_GATE_SEQ, one step on the card against
# the same step on the CPU from the same parameters and batch: the loss
# within TRAIN_LOSS_REL relative, each leaf's gradient within
# TRAIN_GRAD_REL of that leaf's largest, the parameters after the step
# within 2 lr (Adam's first step moves an element by about lr * sign(g), so
# a tiny gradient whose sign differs moves it by up to 2 lr); one step of
# OpenVLA-7B and CogACT-7B cut to VLA_TRAIN_LAYERS LLM blocks on 256
# patches + VLA_TRAIN_TEXT tokens; every reduced config's float32 step
# against the CPU the same way.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 512, 6
TRAIN_GATE_LAYERS, TRAIN_GATE_SEQ = 2, 128
VLA_TRAIN_LAYERS, VLA_TRAIN_TEXT = 16, 17
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-5, 1e-4
# and the gradient norm before clipping within TRAIN_NORM_REL relative
# (added after the first run, where the CPU's torch.linalg.vector_norm
# summed the norm 0.46 % low; stated before the run that checks it)
TRAIN_NORM_REL = 1e-5
FAMILY_OPT = OptConfig(lr=1e-3)
# the DiT's adaLN-zero leaves (``mod``, ``final_mod``, ``out``) start at
# zero, so its output is 0 and no gradient reaches the layers behind it:
# the training paths draw them N(0, 1) * DIT_FILL from a seed, as a trained
# checkpoint's are not zero
DIT_FILL = 0.05
# the router's top-k on the card and on the CPU must not meet a tie: the
# gap between neighbouring probabilities down to the (k+1)-th, at least
ROUTER_GAP = 1e-5


def _leaf_names(tree, prefix: str = "") -> list:
    """Names of ``tree_leaves(tree)``, in their order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def _fill_zero_leaves(tree, generator) -> list:
    """Give the zero-initialised leaves of ``tree`` seeded draws (see
    ``DIT_FILL``); returns their names."""
    filled = []
    for name, t in zip(_leaf_names(tree), tree_leaves(tree)):
        if t.is_floating_point() and t.numel() and not t.any():
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device)
                    * DIT_FILL)
            filled.append(name)
    return filled


def _draw_gates(params, generator) -> None:
    """The VLM's cross gates from ``CROSS_GATES`` (zero at init)."""
    for k in ("gate_attn", "gate_mlp"):
        w = params["cross_blocks"][k]
        w.copy_(torch.empty(w.shape, device=w.device).uniform_(
            *CROSS_GATES, generator=generator))


def _zero_grad_leaves(params, grads) -> list:
    """Names of the leaves whose gradient is zero everywhere; raises on a
    gradient that is not finite."""
    zero = []
    for name, g in zip(_leaf_names(params), tree_leaves(grads)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"gradient of {name} is not finite")
        if not g.any():
            zero.append(name)
    return zero


def _train_want(cfg) -> dict:
    """Launches of one training step: each causal self-attention block's
    flash attention and each Mamba2 layer's SSD scan, twice under
    ``remat`` (forward, and recomputed in the backward); the hybrid's
    shared block is not checkpointed, as in the JAX package."""
    r = 2 if cfg.remat else 1
    L = cfg.n_layers
    if cfg.family == "ssm":
        return _want(0, ssd=r * L)
    if cfg.family == "hybrid":
        return _want(n_sites(cfg), ssd=r * L)
    if cfg.family == "audio":
        return _want(r * cfg.n_dec_layers)
    return _want(r * L)


def _with_draws(model, inject: dict):
    """``model`` with its ``loss_fn`` given the VLA draws ``inject``."""
    return types.SimpleNamespace(
        cfg=model.cfg, loss_fn=functools.partial(model.loss_fn, **inject))


def _dit_draws(cfg, B: int, seed: int) -> dict:
    """The DiT loss's timesteps and noise, drawn on the CPU from a seed, so
    that the card and the CPU take the same ones."""
    if cfg.vla_action_head != "dit":
        return {}
    g = torch.Generator().manual_seed(seed)
    return {"t": torch.randint(0, cfg.diffusion_steps, (B,), generator=g),
            "noise": torch.randn((B, cfg.action_horizon, cfg.action_dim),
                                 generator=g)}


def _data(cfg, seq: int, seed: int) -> SyntheticStream:
    return SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=TRAIN_BATCH,
        seed=seed, family=cfg.family, d_model=cfg.d_model,
        n_vision_tokens=cfg.n_vision_tokens, n_patches=cfg.n_patches,
        vit_dim=cfg.vit_dim, action_dim=cfg.action_dim,
        action_horizon=cfg.action_horizon))


def _router_gaps(fn) -> tuple:
    """(result of ``fn()``, the least gap between neighbouring router
    probabilities down to the (k+1)-th over every MoE layer it runs; None
    without MoE layers)."""
    gaps = []
    route = moe_mod._route

    def recording(x2d, router, k):
        with torch.no_grad():
            p = torch.softmax(x2d.float() @ router.float(), -1)
            top = torch.sort(p, dim=-1, descending=True).values[:, :k + 1]
            gaps.append(float((top[:, :-1] - top[:, 1:]).min()))
        return route(x2d, router, k)

    moe_mod._route = recording
    out = fn()
    moe_mod._route = route
    return out, (min(gaps) if gaps else None)


def compare_train_step(model, params, batch_np: dict, opt: OptConfig,
                       want: dict) -> dict:
    """One float32 ``make_train_step`` step on the card and the same step
    on the CPU from a host copy of ``params``: the loss, the gradient norm
    and the parameters after the step at the limits above, and every
    leaf's gradient (``loss_and_grads`` on the same parameters and batch,
    taken before the step for this comparison only).  Each of the card's
    two runs must launch ``want``; every leaf's gradient that is not zero
    on the CPU must not be zero on the card.  ``model`` has the
    ``loss_fn`` to train (``_with_draws`` hands a VLA its draws)."""
    host = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    step_fn = make_train_step(model, opt)
    sides = {}
    for side, p, dev in (("card", params, DEV), ("cpu", host, "cpu")):
        batch = to_device(batch_np, dev)
        before = _counts()
        (loss, grads), gap = _router_gaps(
            lambda: loss_and_grads(model, p, batch))
        grad_launches = _moved(before)
        zero = _zero_grad_leaves(p, grads)
        before = _counts()
        _, met = step_fn(init_state(p), batch)
        torch.cuda.synchronize()
        sides[side] = {"loss": float(met["loss"]),
                       "grad_loss": float(loss), "grads": grads,
                       "gap": gap, "zero": zero,
                       "grad_norm": float(met["grad_norm"]),
                       "grad_launches": grad_launches,
                       "launches": _moved(before)}
    c, h = sides["card"], sides["cpu"]
    name = model.cfg.name
    if c["grad_launches"] != want or c["launches"] != want:
        raise AssertionError(f"{name} gradients launched "
                             f"{c['grad_launches']}, the train step "
                             f"{c['launches']}, expected {want} each")
    if h["gap"] is not None and min(c["gap"], h["gap"]) < ROUTER_GAP:
        raise AssertionError(f"{name}: a router tie ({c['gap']}, "
                             f"{h['gap']}) on these inputs")
    loss_err = max(abs(c[k] - h[k]) for k in ("loss", "grad_loss"))
    if not loss_err <= TRAIN_LOSS_REL * abs(h["loss"]):
        raise AssertionError(f"{name} loss {c['loss']} on the card, "
                             f"{h['loss']} on the CPU")
    if set(c["zero"]) != set(h["zero"]):
        raise AssertionError(f"{name}: zero gradients on the card "
                             f"{c['zero']}, on the CPU {h['zero']}")
    names = _leaf_names(params)
    worst, worst_leaf = 0.0, None
    for leaf, a, b in zip(names, tree_leaves(c["grads"]),
                          tree_leaves(h["grads"])):
        scale = b.abs().max().item()
        rel = (a.cpu() - b).abs().max().item() / scale if scale else 0.0
        if rel > worst:
            worst, worst_leaf = rel, leaf
    if not worst <= TRAIN_GRAD_REL:
        raise AssertionError(f"{name} gradient of {worst_leaf} {worst} of "
                             f"its largest from the CPU's")
    norm_err = abs(c["grad_norm"] - h["grad_norm"])
    if not norm_err <= TRAIN_NORM_REL * h["grad_norm"]:
        raise AssertionError(f"{name} gradient norm {c['grad_norm']} on the "
                             f"card, {h['grad_norm']} on the CPU")
    lr = lr_at(opt, 0)
    p_err = max((a.cpu() - b).abs().max().item()
                for a, b in zip(tree_leaves(params), tree_leaves(host)))
    if not p_err <= 2 * lr:
        raise AssertionError(f"{name} parameters after the step {p_err} "
                             f"apart (limit {2 * lr})")
    return {"loss": c["loss"], "loss_cpu": h["loss"],
            "loss_rel_err": loss_err / abs(h["loss"]),
            "grad_worst_rel_err": worst, "grad_worst_leaf": worst_leaf,
            "grad_norm": c["grad_norm"], "grad_norm_cpu": h["grad_norm"],
            "param_max_err": p_err, "param_limit": 2 * lr,
            "zero_grad_leaves": c["zero"], "n_leaves": len(names),
            "router_min_gap": h["gap"], "launches": c["launches"],
            "grad_launches": c["grad_launches"]}


def _step_parts(model, state, batch, opt) -> dict:
    """One step of what ``make_train_step`` runs, ``loss_and_grads`` then
    ``adamw_update``, timed by CUDA events: the loss (forward, read where
    ``loss_fn`` returns), the gradients (backward, with the recomputation
    under ``remat``) and clip + AdamW (optimizer); device ms each and the
    host wall."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def timed_loss(*a, **kw):
        loss = model.loss_fn(*a, **kw)
        ev[1].record()
        return loss

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    _, grads = loss_and_grads(types.SimpleNamespace(loss_fn=timed_loss),
                              state.params, batch)
    ev[2].record()
    adamw_update(opt, state.params, grads, state.m, state.v, state.step)
    ev[3].record()
    torch.cuda.synchronize()
    state.step += 1
    return {"forward_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "optimizer_ms": ev[2].elapsed_time(ev[3]),
            "wall_ms": (time.perf_counter() - t0) * 1e3}


def phase_train(name: str, phase: str, seed: int) -> dict:
    """``make_train_step`` on ``name`` at full width and depth, bf16,
    ``remat`` as configured: the leaves' gradients on the first batch
    (every one non-zero), then TRAIN_STEPS steps counted and timed (loss
    finite, parameters moved, exact launches), one step split into
    forward, backward and optimizer, one profiled step, and the float32
    gate (``train_f32_gate``)."""
    cfg = get_config(name)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(gen(seed), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    per_step = _train_want(cfg)
    stream = _data(cfg, TRAIN_SEQ, seed)
    before = _counts()
    loss0, grads = loss_and_grads(model, params,
                                  to_device(stream.next(), DEV))
    moved = _moved(before)
    zero = _zero_grad_leaves(params, grads)
    if zero or moved != per_step:
        raise AssertionError(f"{phase}: zero gradients {zero}, launches "
                             f"{moved} (expected {per_step})")
    del grads
    stream.restore({"step": 0})
    state = init_state(params)
    opt = OptConfig()
    step_fn = make_train_step(model, opt)
    n_look = 1 << 20
    look = [p.reshape(-1)[:n_look].clone() for p in tree_leaves(params)]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    walls, losses, gnorms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = to_device(stream.next(), DEV)
        wall, (state, m) = _wall_ms(lambda: step_fn(state, batch,
                                                    gen(seed + 10 + i)))
        walls.append(wall)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{phase} launched {launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{phase} losses {losses}, norms {gnorms}")
    changed = sum(int((p.reshape(-1)[:n_look] != s).sum())
                  for p, s in zip(tree_leaves(params), look))
    if changed == 0:
        raise AssertionError(f"{phase}: no parameter moved")
    del look
    parts = _step_parts(model, state, to_device(stream.next(), DEV), opt)
    batch = to_device(stream.next(), DEV)
    prof = profile_request(lambda: step_fn(state, batch, gen(seed + 30)))
    med = statistics.median(walls)
    busy = prof.get("device_busy_ms")
    n = sum(t.numel() for t in tree_leaves(params))
    info = {"phase": phase, "model": cfg.name, "family": cfg.family,
            "n_params": n, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "remat": cfg.remat, "init_s": init_s,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "state_bytes": sum(t.numel() * t.element_size() for t in
                               tree_leaves(params) + tree_leaves(state.m)
                               + tree_leaves(state.v)),
            "first_batch_loss": float(loss0), "losses": losses,
            "grad_norms": gnorms, "step_wall_ms": walls,
            "step_wall_ms_median": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
            "peak_memory_bytes": peak, "params_changed_of_sampled":
                [changed, n_look * len(tree_leaves(params))],
            "launches": launches, "launches_per_step": per_step,
            "split_step": parts,
            "profiled_step": {k: prof.get(k) for k in (
                "device_busy_ms", "n_kernel_launches", "by_group", "top")}}
    if isinstance(busy, float):
        info["device_idle_share"] = 1.0 - busy / med
    del state, params, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    info["float32_gate"] = train_f32_gate(name, seed + 40)
    emit(info)
    return info


def train_f32_gate(name: str, seed: int) -> dict:
    """``name`` at full width with TRAIN_GATE_LAYERS layers, float32
    activations and parameters: one step on the card against the CPU
    (``compare_train_step``) on TRAIN_BATCH x TRAIN_GATE_SEQ tokens."""
    cfg = get_config(name).replace(n_layers=TRAIN_GATE_LAYERS,
                                   dtype="float32")
    model = build(cfg)
    params = tree_map(lambda t: t.float(), model.init(gen(seed), DEV))
    t0 = time.perf_counter()
    out = compare_train_step(model, params,
                             _data(cfg, TRAIN_GATE_SEQ, seed).next(),
                             OptConfig(), _train_want(cfg))
    out.update({"layers": TRAIN_GATE_LAYERS, "seq": TRAIN_GATE_SEQ,
                "batch": TRAIN_BATCH, "wall_s": time.perf_counter() - t0})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_training() -> dict:
    """The four training paths, each model's parameters freed before the
    next; returns each path's launches."""
    runs = {}
    for phase, name, seed in (("train", "llama3.2-3b", SEED + 140),
                              ("train_ssm", "mamba2-1.3b", SEED + 145)):
        runs[phase] = phase_train(name, phase, seed)["launches"]
        gc.collect()
        torch.cuda.empty_cache()
    runs["train_vla"] = phase_train_vla()["launches"]
    runs["train_families"] = phase_train_families()["launches"]
    return runs


def phase_train_vla() -> dict:
    """One ``make_train_step`` step of OpenVLA-7B (detok) and CogACT-7B
    (DiT, its timesteps and noise handed in) at full width with
    VLA_TRAIN_LAYERS LLM blocks: every leaf's gradient non-zero (but the
    LM head, which a DiT loss does not read), exact launches, the step's
    wall and peak memory."""
    runs, launches = {}, dict.fromkeys(WRAPPERS, 0)
    for name, seed in (("openvla-7b", SEED + 150), ("cogact-7b", SEED + 160)):
        cfg = get_config(name).replace(n_layers=VLA_TRAIN_LAYERS)
        model = build(cfg)
        params = model.init(gen(seed), DEV)
        filled = _fill_zero_leaves(params["action"], gen(seed + 1))
        batch_np = _data(cfg, VLA_TRAIN_TEXT, seed).next()
        inject = _dit_draws(cfg, TRAIN_BATCH, seed + 2)
        model_d = _with_draws(model, inject)
        per_step = _train_want(cfg)
        batch = to_device(batch_np, DEV)
        before = _counts()
        loss0, grads = loss_and_grads(model_d, params, batch)
        moved = _moved(before)
        zero = _zero_grad_leaves(params, grads)
        unread = ["head"] if cfg.vla_action_head == "dit" else []
        if zero != unread or moved != per_step:
            raise AssertionError(f"train_vla {name}: zero gradients {zero}, "
                                 f"launches {moved} (expected {per_step})")
        del grads
        state = init_state(params)
        step_fn = make_train_step(model_d, OptConfig())
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        before = _counts()
        wall, (state, m) = _wall_ms(lambda: step_fn(state, batch,
                                                    gen(seed + 3)))
        moved = _moved(before)
        if moved != per_step or not math.isfinite(float(m["loss"])):
            raise AssertionError(f"train_vla {name}: launched {moved}, loss "
                                 f"{float(m['loss'])}")
        for k in launches:
            launches[k] += moved[k]
        runs[name] = {
            "head": cfg.vla_action_head, "llm_layers": cfg.n_layers,
            "vit_layers": cfg.vit_layers,
            "tokens": cfg.n_patches + VLA_TRAIN_TEXT, "batch": TRAIN_BATCH,
            "n_params": sum(t.numel() for t in tree_leaves(params)),
            "filled_zero_leaves": filled, "zero_grad_leaves": zero,
            "first_loss": float(loss0), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "step_wall_ms": wall,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": moved}
        del state, params, step_fn, batch, model_d
        gc.collect()
        torch.cuda.empty_cache()
    info = {"phase": "train_vla", "runs": runs, "launches": launches}
    emit(info)
    return info


def _family_batch(cfg, seed: int, B: int = 2, S: int = 16) -> dict:
    """A batch of B x S tokens for ``cfg``'s family (8 text tokens after
    the patches for a VLA), numpy from a seed."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "vla":
        batch = {"patches": rng.standard_normal(
                     (B, cfg.n_patches, cfg.vit_dim)).astype(np.float32),
                 "tokens": tokens[:, :8],
                 "actions": rng.uniform(
                     -1, 1, (B, cfg.action_horizon, cfg.action_dim)
                 ).astype(np.float32)}
    return batch


def phase_train_families() -> dict:
    """Every reduced config, float32: one step on the card against the CPU
    (``compare_train_step``), the twin of
    ``tests/test_models_smoke.py::test_one_train_step``.  The VLM's cross
    gates are drawn from ``CROSS_GATES`` and the DiT's zero leaves filled,
    so that every leaf the loss reads has a gradient."""
    runs, launches = {}, dict.fromkeys(WRAPPERS, 0)
    for i, arch in enumerate(sorted(ARCHS)):
        cfg = get_config(arch).reduced().replace(dtype="float32")
        model = build(cfg)
        params = tree_map(lambda t: t.float(),
                          model.init(gen(SEED + 200 + i), DEV))
        if cfg.family == "vlm":
            _draw_gates(params, gen(SEED + 220 + i))
        if cfg.family == "vla":
            _fill_zero_leaves(params["action"], gen(SEED + 240 + i))
        r = compare_train_step(_with_draws(model, _dit_draws(cfg, 2,
                                                             280 + i)),
                               params, _family_batch(cfg, 260 + i),
                               FAMILY_OPT, _train_want(cfg))
        unread = ["head"] if cfg.vla_action_head == "dit" else []
        if r["zero_grad_leaves"] != unread:
            raise AssertionError(f"train_families {arch}: zero gradients "
                                 f"{r['zero_grad_leaves']}")
        for k in launches:
            launches[k] += r["launches"][k]
        runs[arch] = r
    info = {"phase": "train_families", "runs": runs, "launches": launches}
    emit(info)
    return info


# the B5 and B7 autograd Functions against autograd of their plain versions
# on the card: the forward within the kernels' own limits above (ATTN_TOL;
# B7 SSD_F32_TOL scaled / SSD_BF16_PLAIN_REL of the largest value), the
# input gradients within GRAD_CASE_REL of the largest plain gradient (the
# backward is the plain version's, recomputed: equal up to the order of the
# library's sums), one counted launch a forward and none in the backward
GRAD_CASE_REL = 1e-5


def _grad_case(name, fn, plain, ins, dout, out_tol) -> dict:
    """``fn`` and ``plain`` on the same ``ins``, each differentiated
    against ``dout`` (the first output's gradient)."""
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    before = _counts()
    out = fn(*a)
    out = out[0] if isinstance(out, tuple) else out
    out.backward(dout)
    torch.cuda.synchronize()
    moved = _moved(before)
    ref = plain(*b)
    ref = ref[0] if isinstance(ref, tuple) else ref
    ref.backward(dout)
    err, top = _err_and_max(out, ref)
    g_err = max(_err_and_max(x.grad, y.grad)[0] for x, y in zip(a, b))
    g_top = max(_err_and_max(x.grad, y.grad)[1] for x, y in zip(a, b))
    want = dict.fromkeys(WRAPPERS, 0)
    want[name] = 1
    case = {"max_err": err, "out_max_abs": top, "out_tol": out_tol(top),
            "grad_max_err": g_err, "grad_max_abs": g_top,
            "grad_tol": GRAD_CASE_REL * g_top, "launches": moved[name]}
    if moved != want or not err <= out_tol(top) \
            or not g_err <= GRAD_CASE_REL * g_top or g_top == 0 \
            or not all(torch.isfinite(x.grad).all() for x in a):
        raise AssertionError(f"{name} gradient case failed: {case}")
    return case


def train_grad_cases() -> list:
    """B5 at Llama-3.2-3B's (2, 512, 24/8, 128) and the VLA's (2, 273,
    32 x 128), B7 at Mamba2-1.3B's (2, 512, 64 x 64, N 128, chunk 256),
    each in float32 and bf16."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for i, (B, S, H, KV, D) in enumerate(((2, 512, 24, 8, 128),
                                              (2, 273, 32, 32, 128))):
            q, k, v = _attn_inputs(B, S, S, H, KV, D, dtype, 700 + i)
            do = torch.randn(q.shape, generator=gen(710 + i), device=DEV
                             ).to(dtype)
            c = _grad_case("flash_attention",
                           lambda *t: fa_ops.flash_attention(*t, causal=True),
                           lambda *t: fa_ops.flash_attention_plain(
                               *t, causal=True),
                           (q, k, v), do, lambda top: ATTN_TOL[dtype])
            cases.append({"kernel": "flash_attention", "dtype": dn,
                          "shape": [B, S, H, KV, D], **c})
        x, dt, A, Bm, Cm = _ssd_inputs(2, 512, 64, 64, 128, dtype, 720)
        dy = torch.randn(x.shape, generator=gen(721), device=DEV).to(dtype)
        tol = ((lambda top: SSD_F32_TOL * max(1.0, top))
               if dtype == torch.float32
               else (lambda top: SSD_BF16_PLAIN_REL * top))
        c = _grad_case("ssd_scan",
                       lambda *t: ssd_ops.ssd_scan(*t, chunk=256),
                       lambda *t: ssd_ops.ssd_scan_plain(*t, 256),
                       (x, dt, A, Bm, Cm), dy, tol)
        cases.append({"kernel": "ssd_scan", "dtype": dn,
                      "shape": [2, 512, 64, 64, 128, 256], **c})
    emit({"phase": "train_grad_cases", "cases": cases,
          "clip": train_clip_case()})
    return cases


def train_clip_case() -> dict:
    """``clip_by_global_norm`` on the card on a bf16 leaf of Llama-3.2-3B's
    MLP width and a float32 leaf: each scaled gradient bit-equal to the
    gradient times the float32 scale, rounded once to its dtype, as the
    JAX package clips."""
    grads = {"w": torch.randn((3072, 8192), generator=gen(730), device=DEV
                              ).to(torch.bfloat16),
             "b": torch.randn((8192,), generator=gen(731), device=DEV)}
    before = tree_map(torch.clone, grads)
    _, gn = clip_by_global_norm(grads, 1.0)
    scale = torch.clamp(1.0 / (gn + 1e-9), max=1.0)
    unequal = {k: int((grads[k] != (before[k].float() * scale).to(
        grads[k].dtype)).sum()) for k in grads}
    case = {"norm": float(gn), "scale": float(scale), "unequal": unequal}
    if any(unequal.values()) or not float(scale) < 1.0:
        raise AssertionError(f"clip_by_global_norm on the card: {case}")
    return case



EXAMPLES = {"quickstart_torch.py": "OK",
            "serve_vla_ecc_torch.py": "OK",
            "train_lm_torch.py": "OK",
            "multi_arch_segmentation_torch.py":
                "(all 12 architectures segmented by the same Alg.1 + "
                "Eq.1/Eq.2 models; DESIGN.md §4)"}
# what else an example's output must hold: the training example survives
# its injected failure; the training entry point, run by module, its own
EXAMPLE_ALSO = {"train_lm_torch.py": "1 restart(s) survived"}
TRAIN_CLI = ["-m", "repro_torch.launch.train", "--reduce", "smoke",
             "--steps", "20", "--fail-at", "10", "--ckpt-every", "5"]
TRAIN_CLI_ALSO = "done: 20 steps, 1 restarts"


def _run_example(label: str, argv: list, last, also) -> dict:
    """One example as its own process; its wall and the tail of its
    output.  Raises unless it exits 0 with ``last`` as its last line and
    ``also`` in its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": _src_dir()}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *argv], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    if out.returncode != 0 or not lines or (last and lines[-1] != last) \
            or (also and also not in out.stdout):
        raise AssertionError(f"{label} exited {out.returncode} after "
                             f"{lines[-3:]}: {out.stderr[-2000:]}")
    return {"wall_s": wall, "lines": len(lines), "tail": lines[-4:]}


def phase_examples() -> dict:
    """Each example as its own process on the card, over the same
    ``repro_torch``; fails unless it exits 0 with its last line (and what
    ``EXAMPLE_ALSO`` asks); then the training entry point
    ``python -m repro_torch.launch.train`` with an injected failure."""
    root = os.path.dirname(os.path.abspath(__file__))
    runs = {name: _run_example(f"examples/{name}",
                               [os.path.join(root, "examples", name)], last,
                               EXAMPLE_ALSO.get(name))
            for name, last in EXAMPLES.items()}
    runs["launch.train"] = _run_example(" ".join(TRAIN_CLI), TRAIN_CLI, None,
                                        TRAIN_CLI_ALSO)
    info = {"phase": "examples", "runs": runs}
    emit(info)
    return info


# ==================================================================== spmd
# The SPMD layer (``models/sharding.py``: DTensor parameters and
# activations, ``local_map`` regions; ``train/compression.py``: the int8
# ring) driven by SPMD_WORLD ranks on the one card.  NCCL refuses two ranks
# on one device ("Duplicate GPU detected") and gloo's CUDA collectives
# crash under DTensor's functional-collective wait (torch 2.11), so the
# ranks' group is the port's ``hostgloo`` (``launch/host_group.py``): gloo
# on host copies of the tensors, the copy counted as the wire.  The ranks
# are spawned children (``launch/ranks.py``) that load the kernels the
# parent built; the parent computes the one-rank references first.
SPMD_WORLD = 4
SPMD_BACKEND = "hostgloo"
SPMD_LAYERS = 4                     # depth cut of Llama-3.2-3B (28 layers)
SPMD_TRAIN_BATCH, SPMD_TRAIN_SEQ, SPMD_TRAIN_STEPS = 4, 512, 3
SPMD_F32_BATCH, SPMD_F32_SEQ = 4, 64    # the reduced float32 gate's batch
# bf16 training at the full lr from the first step.  The one-rank loss
# diverges at lr 1e-3 (250 -> 906 -> 703) and jumps at 1e-4 (250 -> 613 ->
# 507) and 5e-5 (250 -> 369 -> 264); at 3e-5 it falls (250 -> 186 -> 166)
# (``--spmd-lr-probe`` on the H100).  AdamW's first steps move an element
# by at most 1.001 lr (sign-like), which bf16 keeps where that is above
# half the element's ulp: the elements below 2^-7 move, and those above
# stay put on every rank (half their ulp, 3.05e-5 and up, exceeds 1.001 lr)
SPMD_OPT = OptConfig(lr=3e-5, warmup_steps=1)
# the float32 gate's optimizers: without compression the default warm-up
# (lr 1e-5 .. 3e-5), where rounding-level gradient differences stay
# rounding-level in the parameters (at the full lr an element whose
# gradient is near zero moves by up to 2 lr on a flip of its sign); with
# the int8 ring lr 1e-3 from the first step, so that the update shows
SPMD_F32_OPT = OptConfig(lr=1e-3)
SPMD_F32_RING_OPT = OptConfig(lr=1e-3, warmup_steps=1)
SPMD_PROMPT, SPMD_STEPS = 512, 16
SPMD_MOE_TOKENS = (2, 512)
SPMD_RING_ODD = 3 * 3072 + 1        # a leaf whose size 4 does not divide
# Bounds of spmd_train against the one-rank run, every step:
# - the loss within SPMD_LOSS_REL of one rank's, and its change from the
#   first step within SPMD_DLOSS_REL of one rank's change (a missing update
#   does not change the loss);
# - the gradient norm (after the sync) within SPMD_NORM_REL, and the
#   float32 int8 run's first one (the ring's noise alone) within
#   SPMD_F32_NORM_REL: a sync that drops, halves or doubles the sum is 50 %
#   off or more, and AdamW would not see a factor;
# - the parameters' change p - p0 within SPMD_DELTA_RATIO of one rank's
#   change, in norm over every element (a missing update is 1 off; the
#   layouts' roundings and the ring's noise flip the first, sign-like step
#   of elements whose gradient lies within that noise);
# - the int8 runs' step-0 gradients synced by the ring and exactly from one
#   autograd output: every element within the ring's bound, 2(N-1) x
#   0.5/127 x the data ranks' abs-max sum, plus 3 roundings to the dtype of
#   that sum (3 eps/2) -- which must stay below the leaf's largest
#   element, so that a missing sum would show.
# The float32 gate without compression holds losses and parameters to
# SPMD_F32_TOL.  The MoE output within 2 % of its largest magnitude; the
# int8 ring's logits within 2 % of the largest.
SPMD_LOSS_REL, SPMD_DLOSS_REL, SPMD_NORM_REL = 1e-2, 1e-1, 2e-2
SPMD_F32_NORM_REL, SPMD_F32_DLOSS_REL = 1e-3, 1e-2
SPMD_DELTA_RATIO = 0.5
SPMD_MOE_REL, SPMD_F32_TOL = 2e-2, 1e-5
SPMD_INT8_LOGIT_REL = 2e-2
DECODE_MODES = ("sp", "tp", "tp_int8_ring")
SPMD_CONSTS = ("SPMD_WORLD", "SPMD_BACKEND", "SPMD_TRAIN_BATCH",
               "SPMD_TRAIN_SEQ", "SPMD_TRAIN_STEPS", "SPMD_PROMPT",
               "SPMD_STEPS", "SPMD_MOE_TOKENS", "SPMD_RING_ODD", "FAM_STEPS")


def _spmd_sync(dev) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def _spmd_barrier_wall(dev, t0) -> float:
    import torch.distributed as dist
    _spmd_sync(dev)
    dist.barrier()
    return (time.perf_counter() - t0) * 1e3


def _local_slice(full: torch.Tensor, dt) -> torch.Tensor:
    """The part of ``full`` that the DTensor ``dt``'s local shard holds
    (torch.chunk along each sharded dim, mesh dims in order)."""
    dm = dt.device_mesh
    coord = dm.get_coordinate()
    for i, pl in enumerate(dt.placements):
        if pl.is_shard():
            full = full.chunk(dm.size(i), pl.dim)[coord[i]]
    return full


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _ring_leaves(lcfg) -> dict:
    """Shapes of one Llama-3.2-3B block's gradient leaves, and one leaf
    whose size the ring's 4 ranks do not divide."""
    from repro_torch.models.transformer import dense_block_specs
    leaves = {k: s.shape for k, s in _flat(dense_block_specs(lcfg)).items()}
    leaves["odd"] = (SPMD_RING_ODD,)
    return leaves


def spmd_ring_rank(rank, spec) -> dict:
    """spmd_ring on this rank: data = SPMD_WORLD."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import use_mesh
    from repro_torch.train import compression as C
    dev = spec["dev"]
    N = SPMD_WORLD
    mesh = make_mesh((N, 1), ("data", "model"), dev)
    r = mesh.local_rank("data")
    rows = []
    with use_mesh(mesh, {}):
        for i, (name, shape) in enumerate(_ring_leaves(spec["lcfg"]).items()):
            g = torch.Generator(device=dev)
            xs = []
            for j in range(N):
                g.manual_seed(SEED + 200 + 10 * i + j)
                xs.append(torch.randn(shape, generator=g, device=dev))
            C.reset_wire()
            t0 = time.perf_counter()
            out = C.ring_allreduce_int8(xs[r], "data")
            wall = _spmd_barrier_wall(dev, t0)
            wire = dict(C.WIRE)
            stacked = torch.stack(xs)
            plain = C.ring_allreduce_int8_plain(stacked)[r]
            exact = stacked.double().sum(0)
            bound = 2 * (N - 1) * 0.5 / 127 * float(sum(
                x.abs().max() for x in xs))
            n = math.prod(shape)
            rows.append({"leaf": name, "shape": list(shape),
                         "plain_max_abs_err": float((out - plain).abs().max()),
                         "exact_max_abs_err": float(
                             (out.double() - exact).abs().max()),
                         "bound": bound,
                         "int8_bytes_per_hop": -(-n // N), "scale_bytes": 4,
                         "hops": wire["hops"],
                         "host_bytes": wire["host_bytes"], "wall_ms": wall})
            del xs, stacked, plain, exact, out
    return {"rows": rows}


def _sync_check(model, params, batch, mesh) -> dict:
    """The step-0 gradients of ``params`` synced by the int8 ring
    (``_compressed_sync``) and exactly (``_reduce_to_params``) from one
    autograd output: by leaf, the largest distance on this rank's shard,
    the ring's bound there (see SPMD_DELTA_RATIO's comment), the largest
    exact element, whether the gradient was a pending sum over data, and
    whether it came sharded over data, summed already (under ``fsdp``
    autograd reduce-scatters a weight whose forward gathered it)."""
    import torch.distributed as dist
    from repro_torch.train.train_loop import (_compressed_sync,
                                              _reduce_to_params)
    _, grads = loss_and_grads(model, params, batch)
    ring = _compressed_sync(grads, params)
    exact = _reduce_to_params(grads, params)
    N, d = mesh.shape["data"], mesh.axis_names.index("data")
    rows = {}
    for (name, g), r, e, p in zip(_flat(grads).items(), tree_leaves(ring),
                                  tree_leaves(exact), tree_leaves(params)):
        mid = list(p.placements)
        mid[d] = g.placements[d]
        amax = g.redistribute(p.device_mesh, mid).to_local().float() \
            .abs().max()
        dist.all_reduce(amax, group=mesh.device_mesh.get_group("data"))
        eps = torch.finfo(g.dtype).eps
        el = e.to_local().float()
        rows[name] = {"err": float((r.to_local().float() - el).abs().max()),
                      "bound": (2 * (N - 1) * 0.5 / 127 + 1.5 * eps)
                      * float(amax),
                      "max_abs": float(el.abs().max()),
                      "partial": g.placements[d].is_partial(),
                      "summed": g.placements[d].is_shard()}
    return rows


class _recording_shapes:
    """For the length of a ``with`` block, the shapes each B5 launch takes
    (q, k), each B7 launch (x) and each B6 call on the card (q, k), by
    kernel; a raise ends the rank."""

    def __enter__(self):
        self.seen = {"b5": [], "b7": [], "b6": []}
        self.fa, self.ssd = fa_ops._launch, ssd_ops._launch
        self.da = da_ops._device_kind
        fa, ssd, da, seen = self.fa, self.ssd, self.da, self.seen

        def b5(q, k, v, causal):
            seen["b5"].append((tuple(q.shape), tuple(k.shape)))
            return fa(q, k, v, causal)

        def b7(x, *args):
            seen["b7"].append(tuple(x.shape))
            return ssd(x, *args)

        def b6(tensors):                # B6 reads the kind of each call
            q, k, _ = tensors
            if q.is_cuda:
                seen["b6"].append((tuple(q.shape), tuple(k.shape)))
            return da(tensors)

        fa_ops._launch, ssd_ops._launch = b5, b7
        da_ops._device_kind = b6
        return self.seen

    def __exit__(self, *exc):
        fa_ops._launch, ssd_ops._launch = self.fa, self.ssd
        da_ops._device_kind = self.da
        return False


def _spmd_train_run(spec, mesh, cfg, params, batch_np, steps, compression,
                    ref, opt, want_shapes=False, zero1=False,
                    strategy="tp") -> dict:
    """``steps`` train steps of ``cfg`` on ``mesh`` from ``params`` (full,
    on every rank): losses, gradient norms, walls and B5 launches; against
    ``ref`` (the one-rank run's final parameters, flat names) the largest
    distance of this rank's shard of every parameter, and the sums of
    squares of (p - p0) - (p_ref - p0) and of p_ref - p0 over the shard;
    with the int8 ring, the sync check of the step-0 gradients first
    (not counted).  With ``zero1`` the moments take the ZeRO-1 specs
    (``opt_state_specs`` under ``zero_rules``: sharded over data too).
    ``strategy`` names ``make_rules``' strategy."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models.sharding import (distribute_tree, make_rules,
                                             use_mesh)
    from repro_torch.train.optimizer import opt_state_specs, zero_rules
    dev = spec["dev"]
    model = build(cfg)
    rules = make_rules(cfg, mesh, "train", strategy=strategy)
    with use_mesh(mesh, rules):
        pd = distribute_tree(params, model.param_specs, mesh, rules)
        del params
        if zero1:
            from torch.distributed.tensor import zeros
            from repro_torch.models.sharding import placements, resolve
            from repro_torch.train.train_loop import TrainState
            zr = zero_rules(rules, mesh)

            def moments():              # each rank makes only its shard
                return tree_map(lambda s: zeros(
                    s.shape, dtype=torch.float32,
                    device_mesh=mesh.device_mesh,
                    placements=placements(resolve(s.axes, zr), mesh)),
                    opt_state_specs(model.param_specs, mesh, rules))

            state = TrainState(0, pd, moments(), moments())
        else:
            state = init_state(pd)
        del pd
        # on the host: a card shared by the ranks holds their states
        p0 = {k: p.to_local().to("cpu", copy=True)
              for k, p in _flat(state.params).items()}
        batch = shard_batch(batch_np, mesh, rules)
        sync = None if compression is None else _sync_check(
            model, state.params, batch, mesh)
        step = make_train_step(model, opt, grad_compression=compression)
        _reset_counts()
        losses, norms, walls = [], [], []
        with _recording_shapes() as seen:
            for _ in range(steps):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                walls.append(_spmd_barrier_wall(dev, t0))
        counts = _counts()
        errs, num, den = {}, 0.0, 0.0
        for name, p in _flat(state.params).items():
            want = _local_slice(ref[name], p).to(dev).float()
            got, start = p.to_local().float(), p0[name].to(dev).float()
            errs[name] = float((got - want).abs().max())
            num += float(((got - want).double() ** 2).sum())
            den += float(((want - start).double() ** 2).sum())
    return {"losses": losses, "norms": norms, "walls_ms": walls,
            "launches": counts,
            "b5_shapes": sorted(set(seen["b5"])) if want_shapes else None,
            "b7_shapes": sorted(set(seen["b7"])) if want_shapes else None,
            "param_max_abs_err": max(errs.values()),
            "param_worst": max(errs, key=errs.get),
            "delta_sq": num, "ref_delta_sq": den, "sync": sync}


def spmd_train_rank(rank, spec) -> dict:
    """spmd_train on this rank: data 2 x model 2."""
    from repro_torch.launch.mesh import make_mesh
    dev = spec["dev"]
    lcfg = spec["lcfg"]
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    model = build(lcfg)
    out = {}
    ref = torch.load(spec["train_ref"], mmap=True)
    for compression in (None, "int8_ring"):
        params = init_params(model.param_specs, gen(SEED + 210), dev)
        out[str(compression)] = _spmd_train_run(
            spec, mesh, lcfg, params, spec["train_batch"], SPMD_TRAIN_STEPS,
            compression, ref, SPMD_OPT, want_shapes=True)
        gc.collect()
    del ref
    # the float32 gate: a reduced config without compression (one-rank
    # parameters to 1e-5) and with the int8 ring
    scfg = spec["small_cfg"]
    for key, compression, opt in (("f32_reduced", None, SPMD_F32_OPT),
                                  ("f32_reduced_int8_ring", "int8_ring",
                                   SPMD_F32_RING_OPT)):
        small = tree_map(lambda a: torch.from_numpy(a).to(dev, copy=True),
                         spec["small_params"])
        out[key] = _spmd_train_run(
            spec, mesh, scfg, small, spec["small_batch"], SPMD_TRAIN_STEPS,
            compression, tree_map(torch.from_numpy, spec["small_ref"][key]),
            opt)
    return out


def spmd_moe_rank(rank, spec) -> dict:
    """spmd_moe on this rank: one granite MoE layer, experts over model."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import (distribute_tree, make_rules,
                                             placements, resolve, use_mesh)
    dev = spec["dev"]
    out = {}
    mesh = make_mesh((1, SPMD_WORLD), ("data", "model"), dev)
    for dtype in ("bfloat16", "float32"):
        cfg = spec["gcfg"].replace(dtype=dtype)
        specs = moe_mod.moe_specs(cfg)
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        params = tree_map(lambda t: t.to(tdt),
                          init_params(specs, gen(SEED + 220), dev))
        x = torch.randn(SPMD_MOE_TOKENS + (cfg.d_model,), generator=gen(
            SEED + 221), device=dev).to(tdt)
        with torch.no_grad():
            y1, aux1 = moe_ffn(cfg, params, x)
        rules = make_rules(cfg, mesh, "train")
        with use_mesh(mesh, rules), torch.no_grad():
            pd = distribute_tree(params, specs, mesh, rules)
            xd = distribute_tensor(x, mesh.device_mesh, placements(
                resolve(("batch", "seq", None)), mesh), src_data_rank=None)
            t0 = time.perf_counter()
            y, aux = moe_ffn(cfg, pd, xd)
            y = y.to_local()
            wall = _spmd_barrier_wall(dev, t0)
            aux = float(aux.full_tensor())
        out[dtype] = {"y_max_abs_err": float((y.float() - y1.float())
                                             .abs().max()),
                      "y_max_abs": float(y1.float().abs().max()),
                      "aux": aux, "aux_one_rank": float(aux1),
                      "experts_per_rank": pd["wg"].to_local().shape[0],
                      "wall_ms": wall}
    return out


def _spmd_decode_run(spec, mesh, cfg, rules, forced=None) -> dict:
    """Prefill SPMD_PROMPT tokens and SPMD_STEPS greedy steps at batch 1 on
    ``mesh`` (with ``forced`` tokens fed instead of the argmax); the
    tokens, each step's logits (rank 0), walls and launches."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models.sharding import distribute_tree, use_mesh
    dev = spec["dev"]
    model = build(cfg)
    params = tree_map(lambda t: t.float(), init_params(
        model.param_specs, gen(SEED + 230), dev))
    prompt = spec["decode_prompt"]
    with use_mesh(mesh, rules), torch.no_grad():
        pd = distribute_tree(params, model.param_specs, mesh, rules)
        del params
        _reset_counts()
        t0 = time.perf_counter()
        logits, cache = prefill_and_pad(
            model, pd, shard_batch({"tokens": prompt}, mesh, rules),
            SPMD_PROMPT + SPMD_STEPS)
        prefill_ms = _spmd_barrier_wall(dev, t0)
        prefill_counts = _counts()
        step = make_serve_step(model)
        last = [logits.full_tensor()[:, -1].float()]
        toks, walls = [], []
        for i in range(SPMD_STEPS):
            cur = (torch.argmax(last[-1], -1)[:, None].to(torch.int32).cpu()
                   if forced is None else torch.from_numpy(forced[:, i:i + 1]))
            toks.append(cur)
            t0 = time.perf_counter()
            logits, cache = step(pd, cache, shard_batch(
                {"tokens": cur.numpy()}, mesh, rules)["tokens"],
                SPMD_PROMPT + i)
            last.append(logits.full_tensor()[:, -1].float())
            walls.append(_spmd_barrier_wall(dev, t0))
        counts = _counts()
    return {"tokens": torch.cat(toks, 1),
            "logits": torch.stack(last, 1).cpu() if mesh.device_mesh
            .get_rank() == 0 else None,
            "prefill_ms": prefill_ms, "step_ms": walls,
            "prefill_launches": prefill_counts, "launches": counts}


def spmd_decode_rank(rank, spec) -> dict:
    """spmd_decode on this rank: sp over model = 4, tp over model = 2 (B6
    on 12 / 4 local heads), tp with the int8 ring on the row-parallel
    projections fed the one-rank tokens."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import make_rules
    dev = spec["dev"]
    lcfg = spec["lcfg"].replace(dtype="float32")
    out = {}
    m14 = make_mesh((1, SPMD_WORLD), ("data", "model"), dev)
    cfg = lcfg.replace(decode_attn="sp")
    out["sp"] = _spmd_decode_run(spec, m14, cfg,
                                 make_rules(cfg, m14, "long_decode"))
    m22 = make_mesh((2, 2), ("data", "model"), dev)
    rules = make_rules(lcfg, m22, "long_decode")
    out["tp"] = _spmd_decode_run(spec, m22, lcfg, rules)
    rules = dict(rules, __tp_int8__=True)
    out["tp_int8_ring"] = _spmd_decode_run(
        spec, m22, lcfg.replace(tp_collective="int8_ring"), rules,
        forced=spec["decode_ref_tokens"])
    return out


def spmd_rank(rank, spec) -> dict:
    """Every spmd phase on this rank, in order, with the staged bytes of
    each."""
    global DEV
    from repro_torch.launch import host_group
    DEV = spec["dev"]
    globals().update(spec["consts"])      # the parent's sizes
    out = {}
    for name, fn in (("spmd_ring", spmd_ring_rank),
                     ("spmd_train", spmd_train_rank),
                     ("spmd_moe", spmd_moe_rank),
                     ("spmd_decode", spmd_decode_rank),
                     ("spmd_families", spmd_families_rank),
                     ("spmd_fsdp", spmd_fsdp_rank)):
        host_group.reset_staged()
        t0 = time.perf_counter()
        out[name] = fn(rank, spec)
        out[name]["wall_s"] = _spmd_barrier_wall(DEV, t0) / 1e3
        out[name]["staged"] = dict(host_group.STAGED)
        if rank == 0:                   # progress, before the phase's line
            print(json.dumps({"rank0_done": name,
                              "wall_s": out[name]["wall_s"]}), flush=True)
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
            out[name]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
    return out


def _spmd_references(lcfg, scfg, workdir) -> dict:
    """The one-rank runs the ranks are held against, on this process: the
    train steps (parameters saved for the ranks to slice), the reduced
    float32 steps and the greedy tokens and logits of the decode."""
    model = build(lcfg)
    batch_np = SyntheticStream(DataConfig(
        vocab_size=lcfg.vocab_size, seq_len=SPMD_TRAIN_SEQ,
        global_batch=SPMD_TRAIN_BATCH, seed=SEED + 211)).next()
    state = init_state(init_params(model.param_specs, gen(SEED + 210), DEV))
    step = make_train_step(model, SPMD_OPT)
    b = to_device(batch_np, DEV)
    losses, norms = [], []
    for _ in range(SPMD_TRAIN_STEPS):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    path = os.path.join(workdir, "train_ref.pt")
    torch.save({k: v.cpu() for k, v in _flat(state.params).items()}, path)
    del state, step
    # the float32 gate, with the default warm-up and without
    smodel = build(scfg)
    small = tree_map(lambda t: t.float(), init_params(
        smodel.param_specs, gen(SEED + 212), DEV))
    small_np = tree_map(lambda t: t.cpu().numpy().copy(), small)
    sbatch = SyntheticStream(DataConfig(
        vocab_size=scfg.vocab_size, seq_len=SPMD_F32_SEQ,
        global_batch=SPMD_F32_BATCH,
        seed=SEED + 213)).next()
    small_ref, small_losses, small_norms = {}, {}, {}
    for key, opt in (("f32_reduced", SPMD_F32_OPT),
                     ("f32_reduced_int8_ring", SPMD_F32_RING_OPT)):
        sstate = init_state(tree_map(
            lambda a: torch.from_numpy(a).to(DEV, copy=True), small_np))
        sstep = make_train_step(smodel, opt)
        small_losses[key], small_norms[key] = [], []
        for _ in range(SPMD_TRAIN_STEPS):
            sstate, m = sstep(sstate, to_device(sbatch, DEV))
            small_losses[key].append(float(m["loss"]))
            small_norms[key].append(float(m["grad_norm"]))
        small_ref[key] = {k: v.cpu().numpy().copy()
                          for k, v in _flat(sstate.params).items()}
    # the decode: float32, batch 1
    dcfg = lcfg.replace(dtype="float32")
    dmodel = build(dcfg)
    dparams = tree_map(lambda t: t.float(), init_params(
        dmodel.param_specs, gen(SEED + 230), DEV))
    prompt = np.random.default_rng(SEED + 231).integers(
        0, lcfg.vocab_size, (1, SPMD_PROMPT)).astype(np.int32)
    with torch.no_grad():
        logits, cache = prefill_and_pad(dmodel, dparams,
                                        to_device({"tokens": prompt}, DEV),
                                        SPMD_PROMPT + SPMD_STEPS)
        dstep = make_serve_step(dmodel)
        last, toks = [logits[:, -1].float()], []
        for i in range(SPMD_STEPS):
            cur = torch.argmax(last[-1], -1)[:, None].to(torch.int32)
            toks.append(cur)
            logits, cache = dstep(dparams, cache, cur, SPMD_PROMPT + i)
            last.append(logits[:, -1].float())
    del dparams, cache
    return {"dev": DEV, "lcfg": lcfg, "small_cfg": scfg,
            "train_ref": path, "train_batch": batch_np,
            "train_ref_losses": losses, "train_ref_norms": norms,
            "small_params": small_np, "small_batch": sbatch,
            "small_ref": small_ref, "small_ref_losses": small_losses,
            "small_ref_norms": small_norms,
            "decode_prompt": prompt,
            "decode_ref_tokens": torch.cat(toks, 1).cpu().numpy(),
            "decode_ref_logits": torch.stack(last, 1).cpu()}


def _hold_train_runs(key, runs_k, ref_l, ref_n, f32: bool, exact: bool,
                     later_norm_rel: float = SPMD_NORM_REL,
                     loss_rel: float = SPMD_LOSS_REL) -> float:
    """Every rank's train run ``key`` against the one-rank run's losses
    ``ref_l`` and norms ``ref_n`` (see SPMD_DELTA_RATIO's comment; the
    losses to ``loss_rel``, the norms after the first to
    ``later_norm_rel``; the exact float32 gate to SPMD_F32_TOL); returns
    the parameters' change ratio over the ranks."""
    for run in runs_k:
        losses, norms = run["losses"], run["norms"]
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            raise AssertionError(f"{key}: losses {losses} norms {norms}")
        if exact:
            np.testing.assert_allclose(losses, ref_l, rtol=SPMD_F32_TOL)
            np.testing.assert_allclose(norms, ref_n, rtol=SPMD_F32_TOL)
            if not run["param_max_abs_err"] <= SPMD_F32_TOL:
                raise AssertionError(f"float32 gate {key}: {run}")
            continue
        np.testing.assert_allclose(
            losses[:1], ref_l[:1], rtol=SPMD_F32_TOL if f32 else loss_rel)
        np.testing.assert_allclose(losses, ref_l, rtol=loss_rel)
        dl = SPMD_F32_DLOSS_REL if f32 else SPMD_DLOSS_REL
        for k in range(1, len(losses)):
            want = ref_l[k] - ref_l[0]
            if not abs(losses[k] - losses[0] - want) <= dl * abs(want):
                raise AssertionError(f"{key}: loss change at step {k}: "
                                     f"{losses} vs {ref_l}")
        np.testing.assert_allclose(norms[:1], ref_n[:1], rtol=SPMD_NORM_REL)
        np.testing.assert_allclose(norms, ref_n, rtol=later_norm_rel)
        if f32:
            np.testing.assert_allclose(norms[:1], ref_n[:1],
                                       rtol=SPMD_F32_NORM_REL)
        # every leaf pending over data rung within its bound, every other
        # one (fsdp) sharded over data, summed by autograd already; at
        # least one leaf rung
        for name, row in (run["sync"] or {}).items():
            if not (row["partial"] and row["err"] <= row["bound"]
                    < row["max_abs"] or row["summed"]):
                raise AssertionError(f"{key}: sync of {name}: {row}")
        if run["sync"] and not any(row["partial"]
                                   for row in run["sync"].values()):
            raise AssertionError(f"{key}: the ring rang no leaf")
    ratio = _change_ratio(runs_k)
    if not exact and not ratio <= SPMD_DELTA_RATIO:
        raise AssertionError(f"{key}: the parameters' change is "
                             f"{ratio} off one rank's")
    return ratio


def _sum_ranks(ranks, get) -> dict:
    return {k: sum(get(r)[k] for r in ranks) for k in WRAPPERS}


SPMD_LR_PROBE = ((1e-3, 1), (1e-4, 1), (5e-5, 1), (3e-5, 1), (1e-3, 100))


def spmd_lr_probe(lcfg=None) -> None:
    """What chose SPMD_OPT: spmd_train's one-rank run (bf16, its depth,
    batch and seed) at each (lr, warm-up) of SPMD_LR_PROBE, a line each:
    the losses and gradient norms, the share of elements the 3 steps
    moved, and the parameters' change against two other runs, in the norm
    of spmd_train's change check: two microbatches (another summation
    order: the size of rounding noise) and half the batch (what a sync
    that keeps one data rank's part feeds AdamW)."""
    lcfg = lcfg or get_config("llama3.2-3b").replace(n_layers=SPMD_LAYERS)
    model = build(lcfg)
    b = to_device(SyntheticStream(DataConfig(
        vocab_size=lcfg.vocab_size, seq_len=SPMD_TRAIN_SEQ,
        global_batch=SPMD_TRAIN_BATCH, seed=SEED + 211)).next(), DEV)
    half = {k: v[:SPMD_TRAIN_BATCH // 2] for k, v in b.items()}

    def run(opt, n, batch):
        params = init_params(model.param_specs, gen(SEED + 210), DEV)
        p0 = [p.clone() for p in tree_leaves(params)]
        st, step = init_state(params), make_train_step(model, opt,
                                                        n_microbatches=n)
        out = {"losses": [], "norms": []}
        for _ in range(SPMD_TRAIN_STEPS):
            st, m = step(st, batch)
            out["losses"].append(float(m["loss"]))
            out["norms"].append(float(m["grad_norm"]))
        return out, [p.float() - q.float()
                     for p, q in zip(tree_leaves(st.params), p0)]

    def ratio(da, db):
        return math.sqrt(sum(float(((x - y) ** 2).sum())
                             for x, y in zip(da, db))
                         / sum(float((x ** 2).sum()) for x in da))

    for lr, warmup in SPMD_LR_PROBE:
        opt = OptConfig(lr=lr, warmup_steps=warmup)
        one, da = run(opt, 1, b)
        micro, db = run(opt, 2, b)
        part, dh = run(opt, 1, half)
        emit({"phase": "spmd_lr_probe", "model": "llama3.2-3b",
              "depth": f"{lcfg.n_layers} of 28 layers", "lr": lr,
              "warmup_steps": warmup, **one,
              "moved_share": sum(int((x != 0).sum()) for x in da)
              / sum(x.numel() for x in da),
              "change_ratio_two_microbatches": ratio(da, db),
              "change_ratio_half_batch": ratio(da, dh),
              "two_microbatches": micro, "half_batch": part})
        del da, db, dh
        gc.collect()
        torch.cuda.empty_cache()


def phase_spmd(lcfg=None, scfg=None, gcfg=None, workdir=None) -> dict:
    """spmd_ring, spmd_train, spmd_moe, spmd_decode, spmd_families and
    spmd_fsdp: the references on this process, then SPMD_WORLD spawned
    ranks on the card running them all; one line each.  Returns each
    phase's launches, summed over the ranks."""
    from repro_torch.launch.ranks import run_ranks
    t_all = time.perf_counter()
    lcfg = lcfg or get_config("llama3.2-3b").replace(n_layers=SPMD_LAYERS)
    scfg = scfg or get_config("llama3.2-3b").reduced().replace(
        dtype="float32")
    workdir = workdir or os.path.join(_build.build_dir(),
                                      f"spmd_{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    spec = _spmd_references(lcfg, scfg, workdir)
    spec["gcfg"] = gcfg or get_config(GRANITE)
    spec["consts"] = {k: globals()[k] for k in SPMD_CONSTS}
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    spec["families"] = _fam_references(workdir)
    fam_ref_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    spec["fsdp"] = _fsdp_references()
    fsdp_ref_s = time.perf_counter() - t1
    ref_s = time.perf_counter() - t0
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(spmd_rank, SPMD_WORLD, os.path.join(workdir, "ranks"),
                      spec, backend=SPMD_BACKEND, device=DEV,
                      timeout_s=900)
    ranks_s = time.perf_counter() - t0
    depth = {"llama3.2-3b": f"{lcfg.n_layers} of 28 layers"}
    common = {"world": SPMD_WORLD, "backend": SPMD_BACKEND,
              "ranks_on": "one card, each rank cuda:0",
              "references_s": ref_s, "ranks_s": ranks_s}
    runs = {}

    # ---- ring
    rows = [r["spmd_ring"]["rows"] for r in ranks]
    for leaf in zip(*rows):
        for x in leaf:
            if x["plain_max_abs_err"] != 0.0:
                raise AssertionError(f"ring != plain ring on {x['leaf']}")
            if not x["exact_max_abs_err"] <= x["bound"]:
                raise AssertionError(f"ring off the exact sum: {x}")
    runs["spmd_ring"] = _sum_ranks(ranks, lambda r: dict.fromkeys(WRAPPERS,
                                                                  0))
    emit({"phase": "spmd_ring", "mesh": {"data": SPMD_WORLD, "model": 1},
          "tolerances": {"plain": "bit-equal",
                         "exact": "2 (N-1) x 0.5 / 127 x sum of the ranks' "
                                  "abs-max"},
          "leaves": [{k: v for k, v in x.items()} for x in rows[0]],
          "wall_ms_by_rank": [[x["wall_ms"] for x in rr] for rr in rows],
          "wall_s": ranks[0]["spmd_ring"]["wall_s"],
          "staged": ranks[0]["spmd_ring"]["staged"], **common})

    # ---- train
    tr = [r["spmd_train"] for r in ranks]
    want_b5 = SPMD_TRAIN_STEPS * lcfg.n_layers * (2 if lcfg.remat else 1)
    keys = ("None", "int8_ring", "f32_reduced", "f32_reduced_int8_ring")
    one = {"None": (spec["train_ref_losses"], spec["train_ref_norms"]),
           "int8_ring": (spec["train_ref_losses"], spec["train_ref_norms"])}
    for k in keys[2:]:
        one[k] = (spec["small_ref_losses"][k], spec["small_ref_norms"][k])
    summary = {}
    for key in keys:
        runs_k = [r[key] for r in tr]
        ref_l, ref_n = one[key]
        f32 = key.startswith("f32")
        ratio = _hold_train_runs(key, runs_k, ref_l, ref_n, f32,
                                 key == "f32_reduced")
        want = want_b5 if not f32 else SPMD_TRAIN_STEPS * \
            spec["small_cfg"].n_layers
        for run in runs_k:
            if run["launches"]["flash_attention"] != want:
                raise AssertionError(f"{key}: B5 launches {run['launches']}")
            if any(v for k, v in run["launches"].items()
                   if k != "flash_attention"):
                raise AssertionError(f"{key}: launches {run['launches']}")
        if not f32:
            heads = {(q[2], k[2]) for r in runs_k for q, k in r["b5_shapes"]}
            if DEV == "cuda" and heads != {(lcfg.n_heads // 2,
                                            lcfg.n_kv_heads // 2)}:
                raise AssertionError(f"B5 local heads {heads}")
        sync = [r["sync"] for r in runs_k if r["sync"]]
        summary[key] = {
            "losses": runs_k[0]["losses"], "one_rank_losses": ref_l,
            "grad_norms": runs_k[0]["norms"], "one_rank_grad_norms": ref_n,
            "delta_ratio": ratio,
            "param_max_abs_err": max(r["param_max_abs_err"] for r in runs_k),
            "param_worst": runs_k[0]["param_worst"],
            "sync_err_over_bound_max": max(
                (row["err"] / row["bound"] for s_ in sync
                 for row in s_.values()), default=None),
            "step_ms": runs_k[0]["walls_ms"],
            "tokens_per_s": (SPMD_TRAIN_BATCH * SPMD_TRAIN_SEQ if not f32
                             else SPMD_F32_BATCH * SPMD_F32_SEQ)
            / statistics.median(runs_k[0]["walls_ms"]) * 1e3,
            "b5_launches_per_rank": [r["launches"]["flash_attention"]
                                     for r in runs_k],
            "b5_local_heads": runs_k[0]["b5_shapes"]}
    runs["spmd_train"] = _sum_ranks(
        ranks, lambda r: {k: sum(r["spmd_train"][key]["launches"][k]
                                 for key in keys) for k in WRAPPERS})

    def opt_of(o):
        return {"lr": o.lr, "warmup_steps": o.warmup_steps}

    emit({"phase": "spmd_train", "model": "llama3.2-3b",
          "mesh": {"data": 2, "model": 2}, "depth": depth, "reduced":
              ["n_layers 28 -> 4"], "batch": SPMD_TRAIN_BATCH,
          "seq": SPMD_TRAIN_SEQ, "steps": SPMD_TRAIN_STEPS,
          "opt": {"bf16": opt_of(SPMD_OPT), "f32_reduced": opt_of(
              SPMD_F32_OPT), "f32_reduced_int8_ring": opt_of(
              SPMD_F32_RING_OPT)},
          "tolerances": {"loss_rel": SPMD_LOSS_REL,
                         "loss_change_rel": {"bf16": SPMD_DLOSS_REL,
                                             "f32": SPMD_F32_DLOSS_REL},
                         "grad_norm_rel": {"every step": SPMD_NORM_REL,
                                           "f32_int8_ring step 0":
                                               SPMD_F32_NORM_REL},
                         "delta_ratio": SPMD_DELTA_RATIO,
                         "sync": "2 (N-1) x 0.5/127 x sum of abs-max + "
                                 "3 eps/2 x the same, below max|g|",
                         "f32_reduced": SPMD_F32_TOL},
          "runs": summary,
          "wall_s": ranks[0]["spmd_train"]["wall_s"],
          "staged": ranks[0]["spmd_train"]["staged"],
          "peak_gb_rank0": ranks[0]["spmd_train"].get("peak_gb"), **common})

    # ---- moe
    for r in ranks:
        for dtype in ("bfloat16", "float32"):
            res = r["spmd_moe"][dtype]
            rel = SPMD_MOE_REL if dtype == "bfloat16" else SPMD_F32_TOL
            if not res["y_max_abs_err"] <= rel * res["y_max_abs"]:
                raise AssertionError(f"MoE {dtype}: {res}")
            if not abs(res["aux"] - res["aux_one_rank"]) <= \
                    1e-5 * abs(res["aux_one_rank"]):
                raise AssertionError(f"MoE aux {dtype}: {res}")
    runs["spmd_moe"] = _sum_ranks(ranks, lambda r: dict.fromkeys(WRAPPERS,
                                                                 0))
    emit({"phase": "spmd_moe", "model": GRANITE,
          "mesh": {"data": 1, "model": SPMD_WORLD},
          "layer": "one MoE layer at full width", "tokens":
              list(SPMD_MOE_TOKENS),
          "tolerances": {"bfloat16": f"{SPMD_MOE_REL} x max|y|",
                         "float32": f"{SPMD_F32_TOL} x max|y|",
                         "aux_rel": 1e-5},
          "results": ranks[0]["spmd_moe"],
          "wall_s": ranks[0]["spmd_moe"]["wall_s"],
          "staged": ranks[0]["spmd_moe"]["staged"], **common})

    # ---- decode
    ref_toks = torch.from_numpy(spec["decode_ref_tokens"])
    ref_logits = spec["decode_ref_logits"]
    for r in ranks:
        dec = r["spmd_decode"]
        for mode in ("sp", "tp"):
            if not torch.equal(dec[mode]["tokens"], ref_toks):
                raise AssertionError(f"{mode} tokens {dec[mode]['tokens']} "
                                     f"!= {ref_toks}")
        tp = dec["tp"]["launches"]
        if tp["decode_attention"] != SPMD_STEPS * lcfg.n_layers:
            raise AssertionError(f"tp B6 launches {tp}")
        if dec["sp"]["launches"]["decode_attention"] != 0:
            raise AssertionError(f"sp launched B6: {dec['sp']['launches']}")
        for mode in DECODE_MODES:
            if dec[mode]["prefill_launches"]["flash_attention"] != \
                    lcfg.n_layers:
                raise AssertionError(f"{mode} prefill B5 launches")
    d0 = ranks[0]["spmd_decode"]
    errs = {mode: float((d0[mode]["logits"] - ref_logits).abs().max())
            for mode in DECODE_MODES}
    scale = float(ref_logits.abs().max())
    if not errs["tp_int8_ring"] <= SPMD_INT8_LOGIT_REL * scale:
        raise AssertionError(f"int8 ring logits {errs} (scale {scale})")
    runs["spmd_decode"] = _sum_ranks(
        ranks, lambda r: {k: sum(r["spmd_decode"][m]["launches"][k]
                                 for m in DECODE_MODES)
                          for k in WRAPPERS})
    emit({"phase": "spmd_decode", "model": "llama3.2-3b", "dtype": "float32",
          "depth": depth, "reduced": ["n_layers 28 -> 4"],
          "prompt": SPMD_PROMPT, "steps": SPMD_STEPS, "batch": 1,
          "meshes": {"sp": {"data": 1, "model": SPMD_WORLD},
                     "tp": {"data": 2, "model": 2},
                     "tp_int8_ring": {"data": 2, "model": 2}},
          "tolerances": {"tokens": "equal to one rank's (sp, tp)",
                         "int8_ring_logits": f"{SPMD_INT8_LOGIT_REL} x "
                                             f"max|logit| = "
                                             f"{SPMD_INT8_LOGIT_REL * scale}"},
          "logits_max_abs_err": errs,
          "runs": {m: {"prefill_ms": d0[m]["prefill_ms"],
                       "step_ms_median": statistics.median(d0[m]["step_ms"]),
                       "b6_launches_per_rank": [
                           r["spmd_decode"][m]["launches"]["decode_attention"]
                           for r in ranks],
                       "b5_prefill_launches_per_rank": [
                           r["spmd_decode"][m]["prefill_launches"][
                               "flash_attention"] for r in ranks]}
                   for m in DECODE_MODES},
          "wall_s": ranks[0]["spmd_decode"]["wall_s"],
          "staged": ranks[0]["spmd_decode"]["staged"], **common})
    # ---- the other five families: every family's numbers on the line,
    # then the checks
    runs["spmd_families"] = dict.fromkeys(WRAPPERS, 0)
    summary = {name: _family_summary(f, [r["spmd_families"][name]
                                         for r in ranks],
                                     runs["spmd_families"])
               for name, f in spec["families"].items()}
    emit({"phase": "spmd_families", "mesh": {"train": {"data": 2,
                                                       "model": 2},
                                             "serve": ["data 2 x model 2, "
                                                       "the batch replicated",
                                                       f"model {SPMD_WORLD}"]},
          "train": {"batch": FAM_TRAIN_BATCH, "seq": FAM_TRAIN_SEQ,
                    "steps": SPMD_TRAIN_STEPS, "opt": {
                        "lr": SPMD_OPT.lr,
                        "warmup_steps": SPMD_OPT.warmup_steps},
                    "f32_reduced": {"batch": FAM_F32_BATCH,
                                    "seq": FAM_F32_SEQ}},
          "serve": {"dtype": "float32", "prompt": FAM_PROMPT,
                    "encdec_prefix": FAM_ENCDEC_PREFIX, "steps": FAM_STEPS,
                    "batch": 1},
          "tolerances": {"train": "as spmd_train (bf16; losses to "
                                  f"{FAM_LOSS_REL}, the norms after the "
                                  f"first to {FAM_LATER_NORM_REL}), "
                                  f"f32_reduced {SPMD_F32_TOL}",
                         "tokens": "equal to one rank's",
                         "logits": f"{FAM_LOGIT_REL} x max|logit|"},
          "families": summary, "references_s": fam_ref_s,
          "wall_s": ranks[0]["spmd_families"]["wall_s"],
          "staged": ranks[0]["spmd_families"]["staged"],
          "peak_gb_rank0": ranks[0]["spmd_families"].get("peak_gb"),
          **common})
    for name, f in spec["families"].items():
        _hold_family(name, f, [r["spmd_families"][name] for r in ranks])
    runs["spmd_fsdp"] = _fsdp_phase(spec, ranks, fsdp_ref_s, common, depth)
    emit({"phase": "spmd_walls", "total_s": time.perf_counter() - t_all,
          "references_s": ref_s, "ranks_s": ranks_s,
          "by_phase_s": {p: ranks[0][p]["wall_s"] for p in ranks[0]}})
    return runs


# =========================================================== spmd_families
# The SSM, hybrid, VLM, encoder-decoder and VLA families on the same ranks
# (after the spmd_* phases above, in the same spawn), each at full width
# with its depth cut (FAM_DEPTH; the VLA keeps its whole ViT): data 2 x
# model 2, SPMD_TRAIN_STEPS bf16 ``make_train_step`` steps at SPMD_OPT
# held against one rank every step as spmd_train is, and the reduced
# config's float32 gate; then for the served families (FAM_SERVED) a
# float32 prefill of FAM_PROMPT tokens (seamless: FAM_PROMPT frames and a
# FAM_ENCDEC_PREFIX-token prefix) and FAM_STEPS greedy steps with model 2
# (data 2, the batch of 1 replicated) and model 4: tokens equal to one
# rank's, logits within FAM_LOGIT_REL of the largest.  B5, B6 and B7 run
# on each rank's heads, counted exactly on every rank.
FAM_DEPTH = {"mamba2-1.3b": {"n_layers": 4},
             "zamba2-1.2b": {"n_layers": 7},        # 2 shared sites
             VLM: {"n_layers": 5},                   # 5 dense + 1 cross
             ENCDEC: {"n_layers": 4, "n_enc_layers": 2, "n_dec_layers": 2},
             "openvla-7b": {"n_layers": 4},
             "cogact-7b": {"n_layers": 4}}
FAM_SERVED = ("mamba2-1.3b", "zamba2-1.2b", VLM, ENCDEC)
FAM_TRAIN_BATCH, FAM_TRAIN_SEQ = 2, 256
FAM_F32_BATCH, FAM_F32_SEQ = 2, 16
FAM_PROMPT, FAM_ENCDEC_PREFIX, FAM_STEPS = 128, 16, 16
FAM_LOGIT_REL = 1e-4
# the bf16 runs against one rank, where spmd_train's limits do not fit
# (all measured on the H100): the gradient norms after the first step to
# FAM_LATER_NORM_REL (a 7-layer Zamba2's parted by 2.8 % at step 3, 0.34 %
# at step 1: two summation orders' trajectories); the losses to
# FAM_LOSS_REL (CogACT's DiT noise MSE, 6.8 on 2 x 16 x 7 actions, was
# 1.1 % off before any update and 3.1 % at step 3; the VLM's 2.2 % at step
# 3 after its loss fell from 281 to 14.5, its change within 0.09 %).  A
# sync that drops, halves or doubles the sum is 50 % off in the norms; a
# missing update fails the loss change and the change ratio
FAM_LATER_NORM_REL = 0.1
FAM_LOSS_REL = 5e-2
# the reduced VLAs' ViT has one head, which model 2 does not divide; at
# width 128 it has two of 64
FAM_GATE_KW = {"openvla-7b": {"vit_dim": 128}, "cogact-7b": {"vit_dim": 128}}


def _fam_cfg(name: str):
    return get_config(name).replace(**FAM_DEPTH[name])


def _fam_gate_cfg(name: str):
    return get_config(name).reduced().replace(dtype="float32",
                                              **FAM_GATE_KW.get(name, {}))


def _fam_depth(name: str, cfg) -> str:
    full = get_config(name)
    if cfg.family == "ssm":
        return f"{cfg.n_layers} of {full.n_layers} Mamba2 layers"
    if cfg.family == "hybrid":
        return (f"{cfg.n_layers} of {full.n_layers} Mamba2 layers, "
                f"{n_sites(cfg)} of {n_sites(full)} shared-attention sites")
    if cfg.family == "vlm":
        return (f"{cfg.n_layers} of {full.n_layers} dense blocks, "
                f"{cfg.n_layers // cfg.cross_attn_every} of "
                f"{full.n_layers // full.cross_attn_every} cross blocks")
    if cfg.family == "audio":
        return (f"{cfg.n_enc_layers} + {cfg.n_dec_layers} of "
                f"{full.n_enc_layers} + {full.n_dec_layers} encoder and "
                f"decoder layers")
    return (f"{cfg.n_layers} of {full.n_layers} LLM blocks, the ViT's "
            f"{cfg.vit_layers}")


def _fam_params(model, cfg, seed: int, dev, f32: bool = False):
    """``cfg``'s parameters from a seed on ``dev``, the VLM's cross gates
    drawn from CROSS_GATES and the DiT's zero leaves filled."""
    params = init_params(model.param_specs, gen(seed), dev)
    if f32:
        params = tree_map(lambda t: t.float(), params)
    if cfg.family == "vlm":
        _draw_gates(params, gen(seed + 1))
    if cfg.vla_action_head == "dit":
        _fill_zero_leaves(params["action"], gen(seed + 2))
    return params


def _fam_launches(cfg, train: bool, remat: bool = False) -> dict:
    """B5 and B7 launches a train step (with ``remat`` the layers that
    recompute twice) or a prefill makes on each rank."""
    want = dict.fromkeys(WRAPPERS, 0)
    twice = 2 if remat else 1
    if cfg.family in ("ssm", "hybrid"):
        want["ssd_scan"] = cfg.n_layers * twice
    if cfg.family == "hybrid":
        want["flash_attention"] = n_sites(cfg)      # the shared block: no remat
    if cfg.family in ("dense", "vlm", "vla"):
        want["flash_attention"] = cfg.n_layers * twice
    if cfg.family == "audio":
        want["flash_attention"] = cfg.n_dec_layers * twice
    return want


def _fam_attn_layers(cfg) -> int:
    """Layers whose decode step runs B6."""
    if cfg.family == "hybrid":
        return n_sites(cfg)
    if cfg.family in ("dense", "vlm"):
        return cfg.n_layers
    return cfg.n_dec_layers if cfg.family == "audio" else 0


def family_shapes() -> dict:
    """The local shapes spmd_families gives B5 (B, S, H, KV, D, dtype), B6
    (B, H, KV, T, D, dtype) and B7 (B, T, H, P, N, chunk, dtype) on one
    rank: the bf16 train steps on data 2 x model 2, the float32 decode
    with model 2 and 4; and spmd_fsdp's (``fsdp_shapes``)."""
    bf, f32 = torch.bfloat16, torch.float32
    fa, da, ssd = [], [], []
    for name in FAM_DEPTH:
        c = _fam_cfg(name)
        runs = [(FAM_TRAIN_BATCH // 2, 2, bf, FAM_TRAIN_SEQ)]
        if name in FAM_SERVED:
            runs += [(1, n, f32, FAM_PROMPT) for n in (2, SPMD_WORLD)]
        for B, n, dt, S in runs:
            if c.family in ("ssm", "hybrid"):
                ssd.append((B, S, c.ssm_nheads // n, c.ssm_headdim,
                            c.ssm_state, c.ssm_chunk, dt))
            if c.family == "ssm":
                continue
            H, KV, hd = c.n_heads, c.n_kv_heads, c.resolved_head_dim
            if c.family == "vla":
                S = c.n_patches + 8
            if c.family == "audio" and dt == f32:
                S = FAM_ENCDEC_PREFIX
            fa.append((B, S, H // n, KV // n, hd, dt))
            if dt == f32:
                da.append((B, H // n, KV // n, S + FAM_STEPS, hd, dt))
    fsdp = fsdp_shapes()
    fa += fsdp["flash_attention"]
    da += fsdp["decode_attention"]
    ssd += fsdp["ssd_scan"]
    return {k: list(dict.fromkeys(v)) for k, v in (
        ("flash_attention", fa), ("decode_attention", da), ("ssd_scan", ssd))}


def family_kernel_cases(ssd_err, attn_cases, dec_cases) -> dict:
    """B5, B6 and B7 against their plain versions at spmd_families' local
    shapes (``family_shapes``), and timed there."""
    sh = family_shapes()
    cases = {"flash_attention": [check_attn(B, S, S, H, KV, D, dt, True,
                                            700 + i)
                                 for i, (B, S, H, KV, D, dt) in enumerate(
                                     sh["flash_attention"])],
             "decode_attention": [check_decode(B, H, KV, T, D, T, dt,
                                               730 + i)
                                  for i, (B, H, KV, T, D, dt) in enumerate(
                                      sh["decode_attention"])],
             "ssd_scan": [check_ssd(B, T, H, P, N, Q, dt, 760 + i)
                          for i, (B, T, H, P, N, Q, dt) in enumerate(
                              sh["ssd_scan"])]}

    def err(name, dt, also=()):
        return max(c.get("max_err", 0.0) for c in list(cases[name]) + list(
            also) if c.get("dtype", str(dt).split(".")[-1]) ==
            str(dt).split(".")[-1])

    return {"cases": cases,
            "flash_attention_times": [
                time_attn(B, S, H, KV, D, err("flash_attention", dt,
                                              attn_cases), dtype=dt)
                for B, S, H, KV, D, dt in sh["flash_attention"]],
            "decode_attention_times": [
                time_decode(B, H, KV, T, D, T, err("decode_attention", dt,
                                                   dec_cases), dtype=dt)
                for B, H, KV, T, D, dt in sh["decode_attention"]],
            "ssd_times": [time_ssd(B, T, H, P, N, Q, max(ssd_err, err(
                "ssd_scan", dt)), dtype=dt)
                for B, T, H, P, N, Q, dt in sh["ssd_scan"]]}


def _fam_decode_batch(cfg, seed: int, rows: int = 1) -> dict:
    """A float32 decode request of ``rows`` rows: FAM_PROMPT tokens (and the
    VLM's vision embeddings), or seamless's FAM_PROMPT frames and a
    FAM_ENCDEC_PREFIX-token prefix."""
    rng = np.random.default_rng(seed)
    S = FAM_ENCDEC_PREFIX if cfg.family == "audio" else FAM_PROMPT
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, S)).astype(
        np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (rows, FAM_PROMPT, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (rows, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _fam_greedy(model, batch, prefill, step, wall=None, steps=FAM_STEPS):
    """Prefill ``batch`` and ``steps`` greedy steps (``prefill`` / ``step``
    run them, on the mesh or not): the tokens, each step's last logits,
    the step walls and the prefill's and the steps' launches."""
    S, V = batch["tokens"].shape[1], model.cfg.vocab_size
    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(batch, S + steps)
    prefill_ms = wall(t0) if wall else None
    prefill_counts = _counts()
    _reset_counts()
    # the real vocabulary: the table's pad rows are masked to -1e30
    last, toks, walls = [logits[:, -1, :V].float()], [], []
    for i in range(steps):
        cur = torch.argmax(last[-1], -1)[:, None].to(torch.int32).cpu()
        toks.append(cur)
        t0 = time.perf_counter()
        logits, cache = step(cache, cur, S + i)
        last.append(logits[:, -1, :V].float())
        if wall:
            walls.append(wall(t0))
    return {"tokens": torch.cat(toks, 1), "logits": torch.stack(last, 1),
            "prefill_ms": prefill_ms, "step_ms": walls,
            "prefill_launches": prefill_counts, "launches": _counts()}


def _fam_decode_ref(cfg, seed: int, batch: dict, steps: int = FAM_STEPS
                    ) -> dict:
    """One rank's float32 greedy decode of ``batch``, on this process, from
    ``cfg``'s parameters drawn from ``seed``: what ``_fam_decode_run``
    draws again on the ranks and is held against (``_hold_decode``)."""
    dcfg = cfg.replace(dtype="float32")
    model = build(dcfg)
    params = _fam_params(model, dcfg, seed, DEV, f32=True)
    kw = {"src_len": batch["frames"].shape[1]} if "frames" in batch else {}
    with torch.no_grad():
        ref = _fam_greedy(
            model, batch,
            lambda b, n: prefill_and_pad(model, params, to_device(b, DEV),
                                         n, **kw),
            lambda cache, cur, pos: model.decode(params, cache, cur.to(DEV),
                                                 pos), steps=steps)
    return {"decode_seed": seed, "decode_batch": batch,
            "decode_steps": steps, "ref_tokens": ref["tokens"],
            "ref_logits": ref["logits"].cpu()}


def _fam_decode_run(spec, mesh, cfg, rules, f) -> dict:
    """The float32 greedy decode of ``f`` (``_fam_decode_ref``) on
    ``mesh`` under ``rules``."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models.sharding import distribute_tree, use_mesh
    dev = spec["dev"]
    dcfg = cfg.replace(dtype="float32")
    model = build(dcfg)
    params = _fam_params(model, dcfg, f["decode_seed"], dev, f32=True)
    batch_np = f["decode_batch"]
    kw = ({"src_len": batch_np["frames"].shape[1]} if "frames" in batch_np
          else {})
    with use_mesh(mesh, rules), torch.no_grad(), _recording_shapes() as seen:
        pd = distribute_tree(params, model.param_specs, mesh, rules)
        del params

        def prefill(batch, max_len):
            logits, cache = prefill_and_pad(
                model, pd, shard_batch(batch, mesh, rules), max_len, **kw)
            return logits.full_tensor(), cache

        def step(cache, cur, pos):
            logits, cache = model.decode(pd, cache, shard_batch(
                {"tokens": cur.numpy()}, mesh, rules)["tokens"], pos)
            return logits.full_tensor(), cache

        out = _fam_greedy(model, batch_np, prefill, step,
                          lambda t0: _spmd_barrier_wall(dev, t0),
                          f["decode_steps"])
    out["logits"] = out["logits"].cpu() if mesh.device_mesh.get_rank() == 0 \
        else None
    out["b5_shapes"] = sorted(set(seen["b5"]))
    out["b7_shapes"] = sorted(set(seen["b7"]))
    out["b6_shapes"] = sorted(set(seen["b6"]))
    return out


def spmd_families_rank(rank, spec) -> dict:
    """spmd_families on this rank: every family's bf16 train steps and its
    float32 gate on data 2 x model 2; the served families' float32 decode
    with model 2 (data 2, the batch replicated) and model SPMD_WORLD."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import make_rules
    dev = spec["dev"]
    m22 = make_mesh((2, 2), ("data", "model"), dev)
    m14 = make_mesh((1, SPMD_WORLD), ("data", "model"), dev)
    out = {}
    for name, f in spec["families"].items():
        cfg = f["cfg"]
        r = {}
        ref = torch.load(f["train_ref"], mmap=True)
        r["train"] = _spmd_train_run(
            spec, m22, cfg, _fam_params(build(cfg), cfg, f["seed"], dev),
            f["train_batch"], SPMD_TRAIN_STEPS, None, ref, SPMD_OPT,
            want_shapes=True, zero1=True)
        del ref
        gc.collect()
        small = tree_map(lambda a: torch.from_numpy(a).to(dev, copy=True),
                         f["small_params"])
        r["f32_reduced"] = _spmd_train_run(
            spec, m22, f["small_cfg"], small, f["small_batch"],
            SPMD_TRAIN_STEPS, None, tree_map(torch.from_numpy,
                                             f["small_ref"]), SPMD_F32_OPT)
        if name in FAM_SERVED:
            for key, mesh in (("model2", m22), ("model4", m14)):
                r[key] = _fam_decode_run(spec, mesh, cfg, make_rules(
                    cfg, mesh, "long_decode"), f)
        out[name] = r
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        if rank == 0:                   # progress, before the phase's line
            print(json.dumps({"rank0_family_done": name}), flush=True)
    return out


def _fam_references(workdir) -> dict:
    """The one-rank runs spmd_families holds the ranks against, on this
    process, family by family: SPMD_TRAIN_STEPS bf16 steps (the parameters
    saved for the ranks to slice), the reduced float32 gate, and the
    float32 greedy decode of the served families."""
    out = {}
    for i, name in enumerate(FAM_DEPTH):
        cfg = _fam_cfg(name)
        model = build(cfg)
        seed = SEED + 300 + 10 * i
        f = {"cfg": cfg, "seed": seed, "depth": _fam_depth(name, cfg),
             "train_batch": _family_batch(cfg, seed + 3, FAM_TRAIN_BATCH,
                                          FAM_TRAIN_SEQ)}
        state = init_state(_fam_params(model, cfg, seed, DEV))
        step = make_train_step(model, SPMD_OPT)
        b = to_device(f["train_batch"], DEV)
        f["ref_losses"], f["ref_norms"] = [], []
        for _ in range(SPMD_TRAIN_STEPS):
            state, m = step(state, b)
            f["ref_losses"].append(float(m["loss"]))
            f["ref_norms"].append(float(m["grad_norm"]))
        f["train_ref"] = os.path.join(workdir, f"family{i}_ref.pt")
        torch.save({k: v.cpu() for k, v in _flat(state.params).items()},
                   f["train_ref"])
        del state, step, b
        scfg = _fam_gate_cfg(name)
        smodel = build(scfg)
        small = _fam_params(smodel, scfg, seed + 4, DEV, f32=True)
        f["small_cfg"] = scfg
        f["small_params"] = tree_map(lambda t: t.cpu().numpy().copy(), small)
        f["small_batch"] = _family_batch(scfg, seed + 6, FAM_F32_BATCH,
                                         FAM_F32_SEQ)
        sstate = init_state(small)
        sstep = make_train_step(smodel, SPMD_F32_OPT)
        f["small_losses"], f["small_norms"] = [], []
        for _ in range(SPMD_TRAIN_STEPS):
            sstate, m = sstep(sstate, to_device(f["small_batch"], DEV))
            f["small_losses"].append(float(m["loss"]))
            f["small_norms"].append(float(m["grad_norm"]))
        f["small_ref"] = {k: v.cpu().numpy().copy()
                          for k, v in _flat(sstate.params).items()}
        del sstate, sstep, small
        if name in FAM_SERVED:
            f.update(_fam_decode_ref(cfg, seed + 5,
                                     _fam_decode_batch(cfg, seed + 7)))
        out[name] = f
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return out


def _change_ratio(runs) -> float:
    return math.sqrt(sum(r["delta_sq"] for r in runs)
                     / sum(r["ref_delta_sq"] for r in runs))


def _family_summary(f, runs, launches) -> dict:
    """One family's numbers in spmd_families (rank 0's, and every rank's
    launches), its launches added to ``launches``."""
    cfg = f["cfg"]
    tr = [r["train"] for r in runs]
    gate = [r["f32_reduced"] for r in runs]
    out = {"depth": f["depth"],
           "train": {"losses": tr[0]["losses"],
                     "one_rank_losses": f["ref_losses"],
                     "grad_norms": tr[0]["norms"],
                     "one_rank_grad_norms": f["ref_norms"],
                     "delta_ratio": _change_ratio(tr),
                     "step_ms": tr[0]["walls_ms"],
                     "tokens_per_s": FAM_TRAIN_BATCH * (
                         cfg.n_patches + 8 if cfg.family == "vla"
                         else FAM_TRAIN_SEQ)
                     / statistics.median(tr[0]["walls_ms"]) * 1e3,
                     "launches_per_rank": [
                         {k: v for k, v in r["launches"].items() if v}
                         for r in tr],
                     "b5_local": tr[0]["b5_shapes"],
                     "b7_local": tr[0]["b7_shapes"],
                     "peak_gb_rank0": runs[0].get("peak_gb")},
           "f32_reduced": {"losses": gate[0]["losses"],
                           "one_rank_losses": f["small_losses"],
                           "param_max_abs_err": max(
                               g["param_max_abs_err"] for g in gate)}}
    serve = {key: _decode_summary(f, [r[key] for r in runs])
             for key in ("model2", "model4") if key in runs[0]}
    if serve:
        out["serve"] = serve
    for r in runs:
        for k in launches:
            launches[k] += r["train"]["launches"][k] + \
                r["f32_reduced"]["launches"][k] + sum(
                    r[key]["prefill_launches"][k] + r[key]["launches"][k]
                    for key in serve)
    return out


def _decode_summary(f, ds) -> dict:
    """A decode's numbers on the ranks (``ds``, rank 0's first) against one
    rank's (``f``): the tokens on every rank, rank 0's logits, walls,
    launches and local shapes."""
    d = ds[0]
    return {"tokens_equal": [torch.equal(x["tokens"], f["ref_tokens"])
                             for x in ds],
            "logits_max_abs_err": float(
                (d["logits"] - f["ref_logits"]).abs().max()),
            "logits_max_abs": float(f["ref_logits"].abs().max()),
            "prefill_ms": d["prefill_ms"],
            "step_ms_median": statistics.median(d["step_ms"]),
            "prefill_launches": {k: v for k, v in
                                 d["prefill_launches"].items() if v},
            "step_b6_per_rank": [x["launches"]["decode_attention"]
                                 for x in ds],
            "b5_local": d["b5_shapes"], "b7_local": d["b7_shapes"],
            "b6_local": d["b6_shapes"]}


def _hold_decode(label, ds, f, cfg) -> None:
    """A decode on the ranks (``ds``, rank 0's first) against one rank's
    (``f``): the tokens equal on every rank, the prefill's and the steps'
    launches exact, rank 0's logits within FAM_LOGIT_REL of the
    largest."""
    pre = _fam_launches(cfg, False)
    steps = dict.fromkeys(WRAPPERS, 0)
    steps["decode_attention"] = f["decode_steps"] * _fam_attn_layers(cfg)
    for d in ds:
        if not torch.equal(d["tokens"], f["ref_tokens"]):
            raise AssertionError(f"{label} tokens {d['tokens']} "
                                 f"!= {f['ref_tokens']}")
        if d["prefill_launches"] != pre or d["launches"] != steps:
            raise AssertionError(f"{label} launches "
                                 f"{d['prefill_launches']} / "
                                 f"{d['launches']}")
    scale = float(f["ref_logits"].abs().max())
    err = float((ds[0]["logits"] - f["ref_logits"]).abs().max())
    if not err <= FAM_LOGIT_REL * scale:
        raise AssertionError(f"{label} logits {err} of {scale}")


def _hold_family(name, f, runs) -> None:
    """One family's checks in spmd_families against the one-rank runs: the
    train steps as spmd_train's (the norms after the first to
    FAM_LATER_NORM_REL), the float32 gate, exact launches and local heads
    on every rank, and the served decode's tokens and logits."""
    cfg = f["cfg"]
    tr = [r["train"] for r in runs]
    _hold_train_runs(f"{name} train", tr, f["ref_losses"], f["ref_norms"],
                     False, False, FAM_LATER_NORM_REL, FAM_LOSS_REL)
    _hold_train_runs(f"{name} f32_reduced", [r["f32_reduced"] for r in runs],
                     f["small_losses"], f["small_norms"], True, True)
    want = {k: v * SPMD_TRAIN_STEPS
            for k, v in _fam_launches(cfg, True, cfg.remat).items()}
    want_gate = {k: v * SPMD_TRAIN_STEPS
                 for k, v in _fam_launches(f["small_cfg"], True).items()}
    for r in runs:
        if r["train"]["launches"] != want:
            raise AssertionError(f"{name} train launches "
                                 f"{r['train']['launches']} != {want}")
        if r["f32_reduced"]["launches"] != want_gate:
            raise AssertionError(f"{name} f32 gate launches "
                                 f"{r['f32_reduced']['launches']}")
    heads = {"b5": {(q[2], k[2]) for r in tr for q, k in r["b5_shapes"]},
             "b7": {x[2] for r in tr for x in r["b7_shapes"]}}
    want_heads = {"b5": {(cfg.n_heads // 2, cfg.n_kv_heads // 2)}
                  if want["flash_attention"] else set(),
                  "b7": {cfg.ssm_nheads // 2} if want["ssd_scan"] else set()}
    if DEV == "cuda" and heads != want_heads:
        raise AssertionError(f"{name} local heads {heads} != {want_heads}")
    if name in FAM_SERVED:
        for key in ("model2", "model4"):
            _hold_decode(f"{name} {key}", [r[key] for r in runs], f, cfg)


# =============================================================== spmd_fsdp
# The ``fsdp`` rules (ZeRO-3: every weight over data and model together on
# one dim, the batch over all four ranks, each region on its rank's batch
# rows with the vocabulary, heads and experts whole) on the same ranks,
# after spmd_families in the same spawn, data 2 x model 2:
# - Llama-3.2-3B at spmd_train's depth, batch, steps, seed and SPMD_OPT:
#   3 bf16 steps without and 3 with the int8 ring, held against spmd_train's
#   one-rank run by ``_hold_train_runs`` at spmd_train's limits (its sync
#   check passes the leaves that autograd already summed, sharded over
#   data, which the ring leaves exact);
#   B5 on each rank's batch row with all 24 / 8 heads, 24 launches a rank
#   a run;
# - every reduced config in float32 at FSDP_BATCH x FSDP_SEQ (a row a rank;
#   MoE at capacity factor 8, so that no choice drops): one
#   ``loss_and_grads`` against one rank on the card, the loss within
#   FSDP_REL relative and every gradient within FSDP_REL of its leaf's
#   largest; each rank launching what one rank's step launches (B5 / B7 on
#   its row, all heads);
# - Llama-3.2-3B and Mamba2-1.3B at 4 layers in float32: a prefill of
#   FAM_PROMPT tokens and FSDP_DECODE's greedy steps at batch FSDP_BATCH,
#   held as spmd_families' decode (``_hold_decode``), B5 / B7 / B6 on each
#   rank's row with all heads.
FSDP_BATCH, FSDP_SEQ, FSDP_REL = 4, 16, 1e-5
# each decode's depth and greedy steps: Llama's cut from FAM_STEPS to 4 for
# the run's time (each of its float32 steps gathers 3.7 GB of weights
# through the host, 4-6 s on the H100)
FSDP_DECODE = {"llama3.2-3b": ({"n_layers": 4}, 4),
               "mamba2-1.3b": ({"n_layers": 4}, FAM_STEPS)}


def fsdp_shapes() -> dict:
    """The local shapes spmd_fsdp gives B5 (B, S, H, KV, D, dtype), B6 (B,
    H, KV, T, D, dtype) and B7 (B, T, H, P, N, chunk, dtype) at full width
    on one rank: a batch row, every head."""
    lcfg, mcfg = get_config("llama3.2-3b"), get_config("mamba2-1.3b")
    H, KV, hd = lcfg.n_heads, lcfg.n_kv_heads, lcfg.resolved_head_dim
    f32 = torch.float32
    return {"flash_attention": [(1, SPMD_TRAIN_SEQ, H, KV, hd,
                                 torch.bfloat16),
                                (1, FAM_PROMPT, H, KV, hd, f32)],
            "decode_attention": [(1, H, KV, FAM_PROMPT
                                  + FSDP_DECODE["llama3.2-3b"][1], hd, f32)],
            "ssd_scan": [(1, FAM_PROMPT, mcfg.ssm_nheads, mcfg.ssm_headdim,
                          mcfg.ssm_state, mcfg.ssm_chunk, f32)]}


def _fsdp_reduced_cfg(arch: str):
    cfg = get_config(arch).reduced().replace(dtype="float32")
    return cfg.replace(moe_capacity_factor=8.0) if cfg.n_experts else cfg


def _fsdp_references() -> dict:
    """The one-rank runs spmd_fsdp holds the ranks against, on this
    process: every reduced config's loss and gradients, and the float32
    greedy decode of FSDP_DECODE."""
    reduced = {}
    for i, arch in enumerate(sorted(ARCHS)):
        cfg = _fsdp_reduced_cfg(arch)
        model = build(cfg)
        seed = SEED + 400 + 10 * i
        params = _fam_params(model, cfg, seed, DEV, f32=True)
        batch = _family_batch(cfg, seed + 1, FSDP_BATCH, FSDP_SEQ)
        inject = _dit_draws(cfg, FSDP_BATCH, seed + 2)
        loss, grads = loss_and_grads(
            model, params, to_device(batch, DEV),
            **{k: v.to(DEV) for k, v in inject.items()})
        reduced[arch] = {
            "cfg": cfg, "batch": batch, "inject": inject,
            "params": tree_map(lambda t: t.cpu().numpy().copy(), params),
            "loss": float(loss),
            "grads": {k: v.cpu() for k, v in _flat(grads).items()}}
        del params, grads
    decode = {}
    for i, (name, (depth, steps)) in enumerate(FSDP_DECODE.items()):
        cfg = get_config(name).replace(dtype="float32", **depth)
        seed = SEED + 500 + 10 * i
        decode[name] = {"cfg": cfg, **_fam_decode_ref(
            cfg, seed, _fam_decode_batch(cfg, seed + 1, FSDP_BATCH), steps)}
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return {"reduced": reduced, "decode": decode}


def _fsdp_grad_run(spec, mesh, r) -> dict:
    """One ``loss_and_grads`` of a reduced config under the fsdp rules:
    the loss, by leaf the largest distance of this rank's shard of the
    gradient (reduced to its parameter's placements) from one rank's, the
    launches and the local shapes B5 and B7 took, and the wall."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models.sharding import (distribute_tree, make_rules,
                                             use_mesh)
    from repro_torch.train.train_loop import _reduce_to_params
    dev, cfg = spec["dev"], r["cfg"]
    model = build(cfg)
    rules = make_rules(cfg, mesh, "train", strategy="fsdp")
    params = tree_map(lambda a: torch.from_numpy(a).to(dev, copy=True),
                      r["params"])
    with use_mesh(mesh, rules), _recording_shapes() as seen:
        pd = distribute_tree(params, model.param_specs, mesh, rules)
        del params
        batch = shard_batch(r["batch"], mesh, rules)
        _reset_counts()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(
            model, pd, batch, **{k: v.to(dev) for k, v in r["inject"].items()})
        grads = _reduce_to_params(grads, pd)
        wall = _spmd_barrier_wall(dev, t0)
        counts = _counts()
        errs = {name: float((g.to_local() - _local_slice(
            r["grads"][name], g).to(dev)).abs().max())
            for name, g in _flat(grads).items()}
    return {"loss": float(loss.full_tensor() if hasattr(loss, "full_tensor")
                          else loss), "errs": errs,
            "launches": counts, "b5_shapes": sorted(set(seen["b5"])),
            "b7_shapes": sorted(set(seen["b7"])), "wall_ms": wall}


def spmd_fsdp_rank(rank, spec) -> dict:
    """spmd_fsdp on this rank: data 2 x model 2 under the fsdp rules."""
    from repro_torch.launch import host_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import make_rules
    dev, lcfg, f = spec["dev"], spec["lcfg"], spec["fsdp"]
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    model = build(lcfg)
    out, staged = {}, {}

    def counted(key, run):              # the host bytes each run stages
        before = dict(host_group.STAGED)
        result = run()
        staged[key] = {k: v - before[k] for k, v in host_group.STAGED.items()}
        gc.collect()
        return result

    ref = torch.load(spec["train_ref"], mmap=True)
    for compression in (None, "int8_ring"):
        out[str(compression)] = counted(str(compression), lambda: (
            _spmd_train_run(spec, mesh, lcfg, init_params(
                model.param_specs, gen(SEED + 210), dev),
                spec["train_batch"], SPMD_TRAIN_STEPS, compression, ref,
                SPMD_OPT, want_shapes=True, strategy="fsdp")))
    del ref
    out["reduced"] = counted("reduced", lambda: {
        arch: _fsdp_grad_run(spec, mesh, r)
        for arch, r in f["reduced"].items()})
    out["decode"] = {name: counted("decode " + name, lambda: _fam_decode_run(
        spec, mesh, d["cfg"], make_rules(d["cfg"], mesh, "prefill",
                                         strategy="fsdp"), d))
        for name, d in f["decode"].items()}
    out["staged_by_run"] = staged
    return out


def _fsdp_phase(spec, ranks, ref_s, common, depth) -> dict:
    """spmd_fsdp's line, then its checks; returns its launches summed over
    the ranks."""
    lcfg, f = spec["lcfg"], spec["fsdp"]
    runs = [r["spmd_fsdp"] for r in ranks]
    H, KV = lcfg.n_heads, lcfg.n_kv_heads
    want_b5 = SPMD_TRAIN_STEPS * lcfg.n_layers * (2 if lcfg.remat else 1)
    train = {}
    for key in ("None", "int8_ring"):
        rk = [r[key] for r in runs]
        train[key] = {
            "losses": rk[0]["losses"],
            "one_rank_losses": spec["train_ref_losses"],
            "grad_norms": rk[0]["norms"],
            "one_rank_grad_norms": spec["train_ref_norms"],
            "delta_ratio": _change_ratio(rk),
            "param_max_abs_err": max(x["param_max_abs_err"] for x in rk),
            "sync_rung_leaves": (sum(row["partial"] for row in
                                     rk[0]["sync"].values())
                                 if rk[0]["sync"] else None),
            "sync_summed_leaves": (sum(row["summed"] for row in
                                       rk[0]["sync"].values())
                                   if rk[0]["sync"] else None),
            "sync_err_over_bound_max": max(
                (row["err"] / row["bound"] for x in rk if x["sync"]
                 for row in x["sync"].values() if row["partial"]),
                default=None),
            "step_ms": rk[0]["walls_ms"],
            "tokens_per_s": SPMD_TRAIN_BATCH * SPMD_TRAIN_SEQ
            / statistics.median(rk[0]["walls_ms"]) * 1e3,
            "b5_launches_per_rank": [x["launches"]["flash_attention"]
                                     for x in rk],
            "b5_local": rk[0]["b5_shapes"]}
    reduced = {}
    for arch, r in f["reduced"].items():
        rr = [x["reduced"][arch] for x in runs]
        scale = {k: float(g.abs().max()) for k, g in r["grads"].items()}
        reduced[arch] = {
            "loss": rr[0]["loss"], "one_rank_loss": r["loss"],
            "grad_err_over_leaf_max": max(
                x["errs"][k] / scale[k] for x in rr for k in scale
                if scale[k] > 0),
            "wall_ms": rr[0]["wall_ms"],
            "launches_per_rank": {k: v for k, v in rr[0]["launches"].items()
                                  if v},
            "b5_local": rr[0]["b5_shapes"], "b7_local": rr[0]["b7_shapes"]}
    decode = {name: dict(_decode_summary(d, [x["decode"][name]
                                             for x in runs]),
                         steps=d["decode_steps"])
              for name, d in f["decode"].items()}
    emit({"phase": "spmd_fsdp", "rules": "make_rules(strategy='fsdp')",
          "mesh": {"data": 2, "model": 2}, "batch_over": ["data", "model"],
          "train": {"model": "llama3.2-3b", "depth": depth,
                    "reduced": ["n_layers 28 -> 4"],
                    "batch": SPMD_TRAIN_BATCH, "seq": SPMD_TRAIN_SEQ,
                    "steps": SPMD_TRAIN_STEPS,
                    "opt": {"lr": SPMD_OPT.lr,
                            "warmup_steps": SPMD_OPT.warmup_steps},
                    "runs": train},
          "reduced_f32": {"batch": FSDP_BATCH, "seq": FSDP_SEQ,
                          "moe_capacity_factor": 8.0, "configs": reduced},
          "decode": {"dtype": "float32", "depth": "4 layers",
                     "batch": FSDP_BATCH, "prompt": FAM_PROMPT,
                     "runs": decode},
          "tolerances": {"train": "spmd_train's (_hold_train_runs); the "
                                  "sync: rung leaves within the ring's "
                                  "bound, the others sharded over data",
                         "reduced_f32": f"loss {FSDP_REL} relative, each "
                                        f"gradient {FSDP_REL} x its leaf's "
                                        "max",
                         "decode": "tokens equal to one rank's, logits "
                                   f"{FAM_LOGIT_REL} x max|logit|"},
          "staged_by_run_rank0": runs[0]["staged_by_run"],
          "fsdp_references_s": ref_s,
          "wall_s": ranks[0]["spmd_fsdp"]["wall_s"],
          "staged": ranks[0]["spmd_fsdp"]["staged"],
          "peak_gb_rank0": ranks[0]["spmd_fsdp"].get("peak_gb"), **common})

    # ---- the checks: train
    for key in ("None", "int8_ring"):
        rk = [r[key] for r in runs]
        _hold_train_runs(f"fsdp {key}", rk, spec["train_ref_losses"],
                         spec["train_ref_norms"], False, False)
        for x in rk:
            if x["launches"]["flash_attention"] != want_b5 or any(
                    v for k, v in x["launches"].items()
                    if k != "flash_attention"):
                raise AssertionError(f"fsdp {key}: launches {x['launches']}")
        b5 = {s for x in rk for s in x["b5_shapes"]}
        if DEV == "cuda" and b5 != {((1, SPMD_TRAIN_SEQ, H,
                                      lcfg.resolved_head_dim),
                                     (1, SPMD_TRAIN_SEQ, KV,
                                      lcfg.resolved_head_dim))}:
            raise AssertionError(f"fsdp {key}: B5 local shapes {b5}")
    # ---- every reduced config
    for arch, r in f["reduced"].items():
        cfg = r["cfg"]
        want = _train_want(cfg)
        for x in [y["reduced"][arch] for y in runs]:
            if not abs(x["loss"] - r["loss"]) <= FSDP_REL * abs(r["loss"]):
                raise AssertionError(f"fsdp {arch}: loss {x['loss']} != "
                                     f"{r['loss']}")
            for k, g in r["grads"].items():
                if not x["errs"][k] <= FSDP_REL * float(g.abs().max()):
                    raise AssertionError(f"fsdp {arch}: gradient {k} "
                                         f"{x['errs'][k]} off")
            if x["launches"] != want:
                raise AssertionError(f"fsdp {arch}: launches "
                                     f"{x['launches']} != {want}")
            rows_heads = all(q[0] == 1 and q[2] == cfg.n_heads
                             for q, _ in x["b5_shapes"]) and all(
                s[0] == 1 and s[2] == cfg.ssm_nheads for s in x["b7_shapes"])
            if DEV == "cuda" and not rows_heads:
                raise AssertionError(f"fsdp {arch}: local shapes "
                                     f"{x['b5_shapes']} {x['b7_shapes']}")
    # ---- decode: as spmd_families', and each rank on its row, all heads
    for name, d in f["decode"].items():
        cfg, ds = d["cfg"], [y["decode"][name] for y in runs]
        _hold_decode(f"fsdp {name}", ds, d, cfg)
        attn = cfg.family != "ssm"
        want = ({(1, cfg.n_heads, cfg.n_kv_heads)} if attn
                else {(1, cfg.ssm_nheads)})
        for x in ds:
            heads = ({(q[0], q[2], k[2]) for q, k in x["b5_shapes"]}
                     | {(q[0], q[1], k[1]) for q, k in x["b6_shapes"]}
                     if attn else {(s[0], s[2]) for s in x["b7_shapes"]})
            if DEV == "cuda" and heads != want:
                raise AssertionError(f"fsdp {name}: local heads {heads}")
    return _sum_ranks(ranks, lambda r: {
        k: sum(r["spmd_fsdp"][key]["launches"][k]
               for key in ("None", "int8_ring"))
        + sum(x["launches"][k] for x in r["spmd_fsdp"]["reduced"].values())
        + sum(x["prefill_launches"][k] + x["launches"][k]
              for x in r["spmd_fsdp"]["decode"].values())
        for k in WRAPPERS})


# ================================================================= dryrun
# The dry run (``launch/dryrun.py``): one step of a cell on fake tensors
# over a fake process group of the production mesh's size, on this
# machine's CPU (no card), each cell its own process, the four at once
# and beside the kernels' build (``main``).
# What it prices are estimates from the H100 SXM data sheet, not
# measurements; it runs here for this torch's DTensor.  The fourth cell is
# the second under the fsdp rules with the int8 ring on the gradients.
# Each cell: (arch, shape, mesh, the CLI's other flags, the artifact tag).
DRYRUN_CELLS = (("mamba2-1.3b", "long_500k", "multi", (), ""),
                ("llama3.2-3b", "train_4k", "single", (), ""),
                (DEEPSEEK, "decode_32k", "single", (), ""),
                ("llama3.2-3b", "train_4k", "single",
                 ("--strategy", "fsdp", "--grad-compression", "int8_ring"),
                 "fsdp_int8_ring"))


def start_dryrun() -> tuple:
    """DRYRUN_CELLS' processes, started: (their start time, the processes,
    the artifacts' directory)."""
    out_dir = os.path.join(_build.build_dir(), "dryrun")
    env = dict(os.environ, PYTHONPATH=_src_dir(), CUDA_VISIBLE_DEVICES="")
    return time.perf_counter(), [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", sh, "--mesh", m, "--out", out_dir, "--force",
         *flags, *(("--tag", tag) if tag else ())],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for a, sh, m, flags, tag in DRYRUN_CELLS], out_dir


def phase_dryrun(started: tuple = None) -> dict:
    """Each of DRYRUN_CELLS through ``python -m repro_torch.launch.dryrun``
    (``started`` by ``start_dryrun``, or here): status ``ok``, rank 0's
    parameter bytes on the fake mesh (and a train cell's ZeRO-1 moments)
    equal to the analytic residency's; one line with each cell's
    residency, roofline terms and collectives."""
    t0, procs, out_dir = started or start_dryrun()
    logs = [p.communicate(timeout=900)[0] for p in procs]
    cells = []
    for (a, sh, m, flags, tag), p, log in zip(DRYRUN_CELLS, procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"dryrun {a} {sh} {m} {flags}: exit "
                                 f"{p.returncode}\n{log[-3000:]}")
        mesh = "2x16x16" if m == "multi" else "16x16"
        name = f"{a}__{sh}__{mesh}" + (f"__{tag}" if tag else "")
        with open(os.path.join(out_dir, name + ".json")) as f:
            res = json.load(f)
        if res["status"] != "ok":
            raise AssertionError(f"dryrun {a} {sh} {mesh}: {res}")
        have = res["per_device"]["resident_bytes"]
        want = res["analytic_residency_per_device"]
        if not res["per_device"]["every_sharded_dim_divides"] or any(
                have[k] != want[k] for k in ("params", "adam_moments")
                if k in want):
            raise AssertionError(f"dryrun {a} {sh} {mesh}: rank 0 holds "
                                 f"{have}, the analytic residency {want}")
        cells.append({"flags": list(flags)} | {k: res[k] for k in (
            "arch", "shape", "mesh", "n_devices", "status", "strategy",
            "step_s",
            "analytic_residency_per_device", "roofline", "model_flops",
            "useful_flops_ratio")} | {
            "per_device": {k: res["per_device"][k] for k in (
                "op_flops", "op_bytes", "collective_wire_bytes",
                "resident_bytes", "peak_bytes")},
            "global_op_flops": res["global"]["op_flops"],
            "collectives": {k: v["count"] for k, v in
                            res["collectives"]["by_kind"].items()}})
    info = {"phase": "dryrun", "estimates": "H100 SXM data-sheet rates "
            "(launch/devices.py), not measurements",
            "torch": torch.__version__, "cells": cells,
            "wall_s": time.perf_counter() - t0}
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
    ap.add_argument("--train-only", action="store_true",
                    help="run only the training paths: the B5/B7 gradient "
                         "cases, train, train_ssm, train_vla and "
                         "train_families")
    ap.add_argument("--spmd-only", action="store_true",
                    help="run only the SPMD phases: spmd_ring, spmd_train, "
                         "spmd_moe, spmd_decode, spmd_families and "
                         "spmd_fsdp on SPMD_WORLD ranks")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="run only the dry run's cells (DRYRUN_CELLS) on "
                         "fake process groups")
    ap.add_argument("--serve-only", action="store_true",
                    help="run only the serve phase: OpenVLA-7B requests "
                         "through the split executor, its stage spans and "
                         "profiler ranges")
    ap.add_argument("--spmd-lr-probe", action="store_true",
                    help="run only the one-rank training probe that chose "
                         "spmd_train's learning rate")
    ap.add_argument("--src", default=None,
                    help="drive the repro_torch under this directory instead "
                         "of this checkout's src/")
    args = ap.parse_args()

    env = phase_env()
    torch.cuda.set_device(0)
    if args.dryrun_only:
        phase_dryrun()
        print(env["nvidia_smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    if args.spmd_only or args.spmd_lr_probe:
        phase_build()
        spmd_lr_probe() if args.spmd_lr_probe else phase_spmd()
        print(env["nvidia_smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    if args.train_only:
        phase_build()
        train_grad_cases()
        phase_training()
        print(env["nvidia_smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
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
    if args.serve_only:
        phase_build()
        phase_serve(setup_openvla(cfg))
        print(env["nvidia_smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return

    dryrun = start_dryrun()
    phase_build()
    phase_dryrun(dryrun)
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
    for phase, name, seed, steps in (
            ("generate_vlm", VLM, SEED + 120, VLM_STEPS),
            ("generate_encdec", ENCDEC, SEED + 130, ENCDEC_STEPS)):
        gc.collect()                # deepseek's 31.4 GB go before the VLM
        torch.cuda.empty_cache()
        st = setup_lm(name, seed)
        runs[phase] = phase_generate(st, phase, steps=steps,
                                     f32_check=True)["launches"]
        del st
    gc.collect()
    torch.cuda.empty_cache()
    train_grad_cases()
    runs.update(phase_training())
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(phase_spmd())
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
