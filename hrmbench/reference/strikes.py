"""Strikes the benchmark plants in a serving cell's memory once its window
has closed, and the response the cell's design point owes each.

A strike flips ``bits`` distinct bits in each of ``words`` distinct
8-byte words of one leaf, drawn from the run's seed and written straight
into the leaf's bytes (nothing of the port flips them). A codeword covers
one aligned 8-byte word: SEC-DED corrects one flipped bit and detects two,
after which the leaf is reloaded from its clean copy; Par+R detects one
flipped bit and reloads the leaf; parity on the KV pages detects one
flipped bit and, with no peer to copy from, leaves the word as it is.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

WORD = 8          # bytes in one codeword's data
COUNTERS = ("params_corrected", "params_detected", "recovery_events",
            "kv_corrected", "kv_detected")


def _response(s: dict) -> Dict[str, int]:
    """The counters one strike entry should move."""
    kv = s["leaf"].startswith("kv_cache/")
    n = int(s["words"])
    key = (s["tier"], int(s["bits"]), kv)
    if key == ("secded", 1, False):
        return {"params_corrected": n}
    if key in (("secded", 2, False), ("parity_r", 1, False)):
        return {"params_detected": n, "recovery_events": int(n > 0)}
    if key == ("parity_r", 1, True):
        return {"kv_detected": n}
    raise ValueError(f"no expected response for strike {s}")


def expected(strikes: List[dict]) -> Dict[str, int]:
    """The counters a scrub of the KV pages and then of the parameters
    should read after ``strikes`` (each entry on a leaf of its own)."""
    leaves = [s["leaf"] for s in strikes]
    if len(set(leaves)) != len(leaves):
        raise ValueError("each strike entry needs a leaf of its own")
    out = dict.fromkeys(COUNTERS, 0)
    for s in strikes:
        for k, v in _response(s).items():
            out[k] += v
    return out


def plant(strikes: List[dict], leaves: Dict[str, torch.Tensor],
          seed: int) -> List[dict]:
    """Flip the strikes' bits in place in ``leaves`` (path -> tensor, each
    contiguous); returns what was flipped, word by word."""
    rng = np.random.default_rng(seed)
    done = []
    for s in strikes:
        leaf = leaves[s["leaf"]]
        if not leaf.is_contiguous():
            raise ValueError(f"{s['leaf']} is not contiguous")
        raw = leaf.reshape(-1).view(torch.uint8)
        n_words = raw.numel() // WORD
        words = rng.choice(n_words, size=int(s["words"]), replace=False)
        masks: Dict[int, int] = {}
        for w in words:
            for bit in rng.choice(WORD * 8, size=int(s["bits"]),
                                  replace=False):
                byte = int(w) * WORD + int(bit) // 8
                masks[byte] = masks.get(byte, 0) | (1 << (int(bit) % 8))
        idx = torch.as_tensor(sorted(masks), dtype=torch.long,
                              device=raw.device)
        m = torch.as_tensor([masks[b] for b in sorted(masks)],
                            dtype=torch.uint8, device=raw.device)
        raw[idx] = raw[idx] ^ m
        done.append({"leaf": s["leaf"], "words": sorted(int(w)
                                                        for w in words)})
    return done
