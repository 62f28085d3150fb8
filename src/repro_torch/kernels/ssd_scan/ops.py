"""Wrapper: the Mamba2 SSD chunked scan in the model layout (B, T, H, P)
-> the SSD scan kernels.

Counterpart of ``src/repro/kernels/ssd_scan/ops.py``.

``ssd_scan`` replaces the TPU kernel ``ssd_scan_pallas`` of
``src/repro/kernels/ssd_scan/kernel.py`` with the CUDA kernels of
``csrc/ssd_scan.cu``, which split the scan as the SSD paper does: every
chunk's own state in parallel with C B^T once per (batch, chunk) for all
heads, then every (chunk, 64-row block) of y in parallel, each block
passing the state over the chunks before its own as it stages it, all
products on the tensor cores (``launch_plan`` gives the grids and the
workspace).  One call of the C entry queues the two kernels
on the current stream.  The kernels read x, dt, B and C where the model keeps
them (through strides: no transpose to ``(B*H, T, P)``, no padded copy)
and treat positions past ``T`` as zero padding, so a ragged last chunk and
a prompt shorter than one chunk need nothing from the wrapper.  Their
arithmetic holds float32's where it has to: a float32 operand of a
tensor-core product is split into bf16 pieces, three for the chunk states
and two for y's products of bfloat16 inputs (three of every operand for
float32 inputs); ``y`` is rounded to x's type once.

Dispatch is by where the tensors lie: CPU tensors take the plain version
(``ssd_scan_plain``, the model's ``ssd_chunked``), CUDA tensors launch the
kernels or the call raises.  State dims ``STATE_DIMS`` and head dims
``HEAD_DIMS`` are built, chunks of 1 to ``MAX_CHUNK`` positions; anything
else raises.

Training differentiates through the kernels: where autograd records, the
call goes through ``SSDScanFn``, whose forward is the kernels and whose
backward recomputes the plain version (with its float64 cumsum) on the
saved inputs and differentiates it (``ssd_scan_vjp_plain``), as the JAX
package trains through ``ssd_chunked``.  There is no backward kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import _build
from ..flash_attention.ops import _on_device
from . import ref

ssd_scan_plain = ref.ssd
STATE_DIMS = (8, 16, 32, 64, 128)   # N, the instantiations in the CUDA source
HEAD_DIMS = (8, 16, 32, 64)         # P
MAX_CHUNK = 256                     # two positions per thread in the cumsum
ROWS = 64                           # positions per row block of a chunk
STATE_ROWS = 64                     # rows of the padded N per state block


class Plan(NamedTuple):
    """How one call is cut: ``n_chunks`` chunks; the chunk-state kernel's
    grid (batch * head, then one block per C B^T tile; chunk; slice of the
    padded N) and the output kernel's (batch * head, chunk, 64-row block);
    the float32 values of the three workspaces (every chunk's state, every
    position's cumsum, every chunk's C B^T in 64 x 64 tiles)."""
    n_chunks: int
    state_grid: Tuple[int, int, int]
    out_grid: Tuple[int, int, int]
    ws_state: int
    ws_cs: int
    ws_cb: int


def launch_plan(B: int, T: int, H: int, P: int, N: int, chunk: int) -> Plan:
    """The launch plan of ``csrc/ssd_scan.cu`` for x (B, T, H, P), a state
    dim ``N`` and ``chunk``: what the C entry launches for these shapes."""
    nc = -(-T // chunk)
    n_pad = max(N, 32)                   # N of 8 and 16 run padded to 32
    rb = -(-min(chunk, T) // ROWS)       # row blocks of a chunk
    tiles = B * rb * (rb + 1) // 2       # C B^T tiles at or below the diagonal
    return Plan(n_chunks=nc,
                state_grid=(B * H + tiles, nc, -(-n_pad // STATE_ROWS)),
                out_grid=(B * H, nc, rb),
                ws_state=B * H * nc * N * P, ws_cs=B * H * nc * chunk,
                ws_cb=B * nc * (rb * ROWS) ** 2)


def _device_kind(tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"ssd_scan: no implementation for tensors on "
                         f"{[str(t.device) for t in tensors]}; have cpu "
                         "(plain) and cuda (kernel)")
    return kinds.pop()


def _inner_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,P); dt: (B,T,H); A: (H,); Bm/Cm: (B,T,N).

    Returns (y (B,T,H,P) in x's type, final state (B,H,N,P) float32) —
    the contract of ``models.ssm.ssd_chunked``.  On the card one call of
    the C entry queues two kernels (the chunk states, then the outputs);
    ``ssd_scan.launches`` counts calls."""
    kind = _device_kind((x, dt, A, Bm, Cm))
    if kind == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)} are not (B,T,H,P), (B,T,H), "
                         "(H,), (B,T,N), (B,T,N)")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, T, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (B, T):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)} and B {tuple(Bm.shape)} do not "
                         "belong together")
    if N not in STATE_DIMS or P not in HEAD_DIMS:
        raise ValueError(f"state dim {N} and head dim {P}: the kernel is "
                         f"built for N in {STATE_DIMS}, P in {HEAD_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes 1 to {MAX_CHUNK}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes x, B and C in float32 or "
                        f"bfloat16, one type, got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if not (dt.is_floating_point() and A.is_floating_point()):
        raise TypeError(f"dt and A must be floating, got {dt.dtype}, "
                        f"{A.dtype}")
    dev = x.device
    if any(t.device != dev for t in (dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, B and C lie on different cards")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return SSDScanFn.apply(x, dt, A, Bm, Cm, chunk)
    return _launch(x, dt, A, Bm, Cm, chunk)


def _launch(x, dt, A, Bm, Cm, chunk: int):
    """One call of the C entry on checked CUDA tensors."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return y, state
    if T == 0:
        return y, state.zero_()
    x, Bm, Cm = (_inner_contiguous(t) for t in (x, Bm, Cm))
    dt = _inner_contiguous(dt.float())
    A = A.float().contiguous()
    plan = launch_plan(B, T, H, P, N, chunk)
    cs_len = -(-plan.ws_cs // 4) * 4      # C B^T on a 16-byte boundary
    ws = torch.empty(plan.ws_state + cs_len + plan.ws_cb,
                     dtype=torch.float32, device=dev)   # one allocation
    ws_cs = ws.data_ptr() + 4 * plan.ws_state
    with _on_device(dev):
        rc = _build.lib().rt_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            ws.data_ptr(), ws_cs, ws_cs + 4 * cs_len,
            B, T, H, P, N, int(chunk), plan.n_chunks,
            *x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:2],
            *Cm.stride()[:2],
            _build.DTYPE_CODES[str(x.dtype).split(".")[-1]],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("ssd_scan", rc)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


def ssd_scan_vjp_plain(x, dt, A, Bm, Cm, chunk: int, dy, dstate=None):
    """(dx, ddt, dA, dB, dC): the plain version's gradients at the inputs
    against ``dy`` and, unless it is None, the final state's gradient
    ``dstate``; each in its input's dtype."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_(True)
                    for t in (x, dt, A, Bm, Cm))
        y, state = ssd_scan_plain(*ins, chunk)
        outs, grads = (y,), (dy,)
        if dstate is not None:
            outs, grads = (y, state), (dy, dstate)
        return torch.autograd.grad(outs, ins, grads)


class SSDScanFn(torch.autograd.Function):
    """The kernels forward, the plain version's gradients backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _launch(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return (*ssd_scan_vjp_plain(x, dt, A, Bm, Cm, ctx.chunk, dy, dstate),
                None)
