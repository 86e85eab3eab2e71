"""Operations and bytes computed from a cell's shapes, and the card's
published peaks: the yardstick of the rooflines and of MFU.

Every count is the work the algorithm needs, not what a kernel happens
to do: each input byte read once, each output byte written once, and
only the causal (and windowed) pairs of attention.  A configuration is
the dict of its file (``colobench/configs/<name>.json``); what depends
on its family's layers comes from the family's adapter
(``colobench/families/<reference>.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

#: NVIDIA H100 SXM data sheet: dense bf16 tensor rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def head_dim(c: Dict) -> int:
    return c.get("head_dim") or c["d_model"] // c["n_heads"]


def causal_pairs(S: int, window: int = 0) -> int:
    """Query-key pairs that causal attention over ``S`` positions scores;
    with ``window`` > 0 each query sees at most ``window`` keys (itself
    included)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_flops(B: int, H: int, S: int, D: int, window: int = 0) -> int:
    """The score and value products of one causal attention call: two
    multiply-adds of length D a pair and head."""
    return 4 * D * B * H * causal_pairs(S, window)


def k2_work(B: int, H: int, Hkv: int, S: int, D: int, window: int = 0,
            elem_bytes: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one K2 call: q read and o written at H
    heads, k and v read at Hkv heads."""
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * elem_bytes
    return attention_flops(B, H, S, D, window), nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The roofline: the larger of the operations' and the bytes' time at
    the published peaks."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def prefill_model_flops(c: Dict, fam, B: int, S: int) -> int:
    """Model FLOPs of one prefill of B prompts of S tokens: 2 a weight a
    token through the layers (``fam.params_per_token``, the family's
    count), the head on each prompt's last position, and attention's
    score and value products (causal, windowed) in each of
    ``fam.attention_layers``."""
    n = fam.params_per_token(c)
    head = 2 * c["d_model"] * c["vocab"] * B
    attn = fam.attention_layers(c) * attention_flops(
        B, c["n_heads"], S, head_dim(c), c.get("sliding_window") or 0)
    return 2 * n * B * S + head + attn
