"""RoboECC in PyTorch and CUDA — the port of ``src/repro`` for one NVIDIA
Hopper card.

Same directory and function names as the JAX package, so a reader finds
the counterpart of every module; plain functions over nested dicts of
tensors inside.  The package imports ``torch``, ``numpy`` and the standard
library only.  Entry points run on the card and raise when there is none;
callers that want the CPU (the tests) say ``device="cpu"``.
"""
from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """Resolve ``device`` and raise if it names a card that is not there.

    The port never moves work to the CPU on its own: a caller that wants
    the CPU asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_dtype(name) -> torch.dtype:
    """``cfg.dtype`` strings ("bfloat16", "float32") -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[str(name)]


__all__ = ["require_device", "to_dtype"]
