"""Work counts of the MoE FFN of a sparse-expert trunk, from the
configuration's widths, as ``work.py`` counts the rest: from the
operation's shapes, never the kernel that implements it.

Over ``T`` tokens a layer's routed experts run ``T * moe_top_k`` rows
through one SwiGLU each (three products of width ``moe_d_ff``), and its
shared experts ``T`` rows through one SwiGLU of width ``n_shared_experts *
moe_d_ff``.  Bytes: each weight read once, the rows read once and the
answers written once; the SwiGLU's intermediate is no input or output of
the operation.  The routed count takes every expert's weights as read:
at the cells' ``T`` (64 x 273 = 17 472 tokens, 104 832 choices) every one
of 64 experts is chosen.
"""
from __future__ import annotations

from typing import Dict, Tuple

BF16 = 2


def routed(c: Dict, T: int) -> Tuple[float, float]:
    """(operations, bytes) of one layer's routed expert products."""
    d, f, E, k = c["d_model"], c["moe_d_ff"], c["n_experts"], c["moe_top_k"]
    rows = T * k
    return (2 * rows * 3 * d * f,
            (E * 3 * d * f + 2 * rows * d) * BF16)


def shared(c: Dict, T: int) -> Tuple[float, float]:
    """(operations, bytes) of one layer's shared expert products."""
    d, f = c["d_model"], c["moe_d_ff"] * c["n_shared_experts"]
    return 2 * T * 3 * d * f, (3 * d * f + 2 * T * d) * BF16


def moe_layers(c: Dict) -> int:
    return c["n_layers"] - c["first_dense_layers"]
