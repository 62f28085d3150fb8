"""Plain PyTorch version of the SSD scan: the model's own chunked
implementation.

Counterpart of ``src/repro/kernels/ssd_scan/ref.py``."""
from __future__ import annotations

from typing import Tuple

import torch


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,P); dt: (B,T,H); A: (H,); Bm/Cm: (B,T,N)."""
    from ...models.ssm import ssd_chunked      # models.ssm imports the wrapper
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)
