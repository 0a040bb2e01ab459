"""The yardstick's arithmetic: model FLOPs of the work a window did, the
bytes each kernel must move, and the card's published peaks.

Frozen here so that no change to the port moves it. Model FLOPs count the
work the model needs and nothing the program adds: per token the Q/K/V/O
projections, attention over the positions the token attends, the router,
its ``top_k`` routed experts and the shared experts (the padded slots a
dispatch computes are waste, and are not counted), and the head once for
each token whose logits are used. A multiply-add is 2 FLOPs.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

# bytes each launch moves, by kernel, per packed row of 256 64-bit words:
# parity encode reads the words and writes 32 parity bytes; the check
# reads the words and the parity, writes 32 error bytes and one int32 count
KERNEL_BYTES_PER_ROW = {
    "parity_encode": 256 * 8 + 32,
    "parity_check": 256 * 8 + 32 + 32 + 4,
}


def peak(device_kind: str, key: str):
    """The card's published peak ``key``, or None for a card not in the
    table."""
    return PEAKS.get(device_kind, {}).get(key)


def _dims(c: dict):
    D, H, K = c["d_model"], c["n_heads"], c["n_kv_heads"]
    return D, H, K, D // H


def token_flops(c: dict) -> float:
    """FLOPs of one token through every layer, attention scores aside."""
    D, H, K, dh = _dims(c)
    proj = 2 * D * H * dh + 2 * 2 * D * K * dh + 2 * H * dh * D
    moe = c.get("moe")
    if moe:
        E, Fe = moe["n_experts"], moe["d_expert"]
        ffn = 2 * D * E + moe["top_k"] * 3 * 2 * D * Fe \
            + 3 * 2 * D * moe.get("n_shared", 0) * Fe
    else:
        ffn = 3 * 2 * D * c["d_ff"]
    return float(c["n_layers"] * (proj + ffn))


def attn_flops(c: dict, positions: float) -> float:
    """FLOPs of attention (scores and the weighted sum) over ``positions``
    attended positions in total, every layer."""
    _, H, _, dh = _dims(c)
    return float(c["n_layers"] * 4 * H * dh * positions)


def head_flops(c: dict) -> float:
    return float(2 * c["d_model"] * c["vocab_size"])


def prefill_flops(c: dict, n: int) -> float:
    """A causal prefill of ``n`` prompt tokens whose last logits are used."""
    return n * token_flops(c) + attn_flops(c, n * (n + 1) / 2) \
        + head_flops(c)


def decode_flops(c: dict, n_tokens: int, attended: int) -> float:
    """``n_tokens`` decoded tokens that attend ``attended`` positions in
    all."""
    return n_tokens * (token_flops(c) + head_flops(c)) \
        + attn_flops(c, attended)


def query_flops(c: dict, batch: int, seq: int) -> float:
    """A causal forward of ``batch`` x ``seq`` tokens, logits at every
    position used."""
    return batch * (seq * (token_flops(c) + head_flops(c))
                    + attn_flops(c, seq * (seq + 1) / 2))
