"""Checkpointing: atomic, retention-managed, asynchronous, restartable.

Counterpart of ``src/repro/checkpoint/ckpt.py`` in the same on-disk
format, so that either package reads what the other wrote:
``<dir>/step_<N>/arrays.npz`` + ``meta.json``, one array a leaf under its
``a/b/c`` key.  numpy has no bfloat16, so a leaf of a type numpy does not
hold is stored as its raw bytes (``uint8``, the last dim times the item
size) with the type's name under ``meta["dtypes"]``; the port turns bf16
into bytes and back through ``torch`` views, not ``ml_dtypes``.  Writes go
to a temporary directory and are renamed into place, so a crash in a save
never corrupts the latest checkpoint.

``load_checkpoint`` returns CPU tensors; ``restore_into`` copies them
into the live tensors of a tree.  ``AsyncCheckpointer.save`` copies the
tree to the host before it returns: the port's optimizer updates the
parameters in place, so a writer thread that read device tensors would
save a half-updated state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Any

# torch types numpy holds as they are; the rest travel as bytes
_NATIVE = {torch.float64, torch.float32, torch.float16, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool}
_BYTES = {"bfloat16": torch.bfloat16}


def _host(tree: Tree) -> Tree:
    """Every leaf as a CPU tensor of its own (a copy of a device or a CPU
    tensor; numpy arrays and numbers become tensors)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(tree))


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    out[prefix[:-1] if prefix.endswith("/") else prefix] = tree
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Tree:
    root: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _write(ckpt_dir: str, step: int, flat: Dict[str, torch.Tensor],
           extra: Optional[Dict], keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    enc, dtypes = {}, {}
    for k, v in flat.items():
        if v.dtype in _NATIVE:
            enc[k] = v.numpy()
            continue
        name = str(v.dtype).split(".")[-1]
        if name not in _BYTES:
            raise TypeError(f"{k}: no on-disk form for {v.dtype}")
        dtypes[k] = name
        enc[k] = v.contiguous().view(torch.uint8).numpy()
    np.savez(os.path.join(tmp, "arrays.npz"), **enc)
    meta = {"step": step, "time": time.time(), "extra": extra or {},
            "n_arrays": len(flat), "dtypes": dtypes}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _apply_retention(ckpt_dir, keep)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``tree`` (nested dicts of tensors, numpy arrays or numbers)
    as ``step_<step>``; keep the newest ``keep`` checkpoints."""
    return _write(ckpt_dir, step, _flatten(_host(tree)), extra, keep)


def _apply_retention(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(name.split("_", 1)[1]) for name in os.listdir(ckpt_dir)
            if name.startswith("step_") and name.split("_", 1)[1].isdigit()]


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None
                    ) -> Tuple[int, Tree, Dict]:
    """(step, tree of CPU tensors, extra) of ``step`` or the latest."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for k in z.files:
            v = torch.from_numpy(np.array(z[k]))
            if k in dtypes:
                if dtypes[k] not in _BYTES:
                    raise TypeError(f"{k}: stored as {dtypes[k]}, which the "
                                    "port does not read")
                v = v.view(_BYTES[dtypes[k]])
            flat[k] = v
    return step, _unflatten(flat), meta.get("extra", {})


@torch.no_grad()
def restore_into(tree_like: Tree, loaded: Tree) -> Tree:
    """Copy the loaded tensors into the live tensors of ``tree_like`` (same
    nesting and shapes; each keeps its dtype and device); returns
    ``tree_like``."""
    if isinstance(tree_like, dict):
        if set(tree_like) != set(loaded):
            raise KeyError(f"checkpoint keys {sorted(loaded)} != "
                           f"{sorted(tree_like)}")
        for k in tree_like:
            restore_into(tree_like[k], loaded[k])
        return tree_like
    if tuple(tree_like.shape) != tuple(loaded.shape):
        raise ValueError(f"shape {tuple(loaded.shape)} in the checkpoint, "
                         f"{tuple(tree_like.shape)} live")
    tree_like.copy_(loaded)
    return tree_like


class AsyncCheckpointer:
    """Background-thread writer; at most one save in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree: Tree, extra: Optional[Dict] = None):
        """Copy ``tree`` to the host now, then write it in the background;
        the caller may update its tensors as soon as this returns."""
        self.wait()
        flat = _flatten(_host(tree))

        def _run():
            self.last_path = _write(self.ckpt_dir, step, flat, extra,
                                    self.keep)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
