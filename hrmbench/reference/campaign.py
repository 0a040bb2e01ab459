"""The Fig. 2 campaign as the paper defines it, for the reference's checks.

A chunk of ``n`` trials, seeded with ``seed``, draws from one numpy stream:
for each kind (soft, then hard), ``n`` times, a leaf chosen with
probability proportional to its bytes, then a word uniformly over the
leaf's packed 64-bit words (the leaf's bytes zero-padded to rows of 256
words, rows rounded up to a multiple of 128 past 128 rows) and a bit
uniformly over 64; with probability 0.02 a second bit of the same word,
the adjacent one with probability 0.5, else another uniformly. A bit past
the leaf's last byte is lost.

A soft trial queries once with the struck leaf. A hard trial queries
three times and re-applies the strike after each query; on read-only
weights the second application undoes the first, so the second query sees
clean weights. Each query is classified: crash (a negative token, the
crash marker), incorrect (tokens differ from the clean query's), masked
with the struck value still resident (logic) or gone (overwrite); a trial
takes its worst query.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

LANES, BLOCK_ROWS = 256, 128
MULTI_BIT, ADJACENT = 0.02, 0.5
ORDER = ("masked_overwrite", "masked_logic", "incorrect", "crash")


def _rows(nbytes: int) -> int:
    n64 = -(-nbytes // 8)
    rows = max(1, -(-n64 // LANES))
    if rows > BLOCK_ROWS:
        rows = -(-rows // BLOCK_ROWS) * BLOCK_ROWS
    return rows


def leaf_table(leaves: List[Tuple[Tuple[str, ...], torch.Tensor]]):
    """``[(path string, nbytes, rows)]`` in sorted path order."""
    out = []
    for path, leaf in leaves:
        nb = leaf.numel() * leaf.element_size()
        out.append(("/".join(path), nb, _rows(nb)))
    return out


def draws(table, n: int, seed: int) -> List[Tuple[str, str, List[int],
                                                  List[int]]]:
    """A chunk's ``[(kind, path, words, bits)]``, in trial order."""
    rng = np.random.default_rng(seed)
    w = np.array([nb for _, nb, _ in table], dtype=np.float64)
    w = w / w.sum()
    out = []
    for kind in ("soft", "hard"):
        for _ in range(n):
            path, _, rows = table[rng.choice(len(table), p=w)]
            words = rng.integers(0, rows * LANES, size=1)
            bits = rng.integers(0, 64, size=1)
            multi = rng.random(1) < MULTI_BIT
            ws, bs = [int(words[0])], [int(bits[0])]
            if multi[0]:
                adj = rng.random(1) < ADJACENT
                alt = rng.integers(0, 63, size=1)
                b = int(bits[0])
                b_adj = b + 1 if b < 63 else b - 1
                b_alt = int(alt[0]) + 1 if int(alt[0]) >= b else int(alt[0])
                ws.append(ws[0])
                bs.append(b_adj if adj[0] else b_alt)
            out.append((kind, path, ws, bs))
    return out


def flips(words: List[int], bits: List[int], nbytes: int
          ) -> Dict[int, int]:
    """{byte offset: xor mask} of a strike, bits past the leaf dropped."""
    out: Dict[int, int] = {}
    for w, b in zip(words, bits):
        byte = 8 * w + b // 8
        if byte < nbytes:
            out[byte] = out.get(byte, 0) ^ (1 << (b % 8))
    return {k: v for k, v in out.items() if v}


def struck(leaf: torch.Tensor, fl: Dict[int, int]) -> torch.Tensor:
    """A copy of ``leaf`` with the flips applied to its bytes."""
    out = leaf.clone()
    if fl:
        raw = out.view(-1).view(torch.uint8)
        idx = torch.tensor(sorted(fl), device=leaf.device)
        mask = torch.tensor([fl[k] for k in sorted(fl)], dtype=torch.uint8,
                            device=leaf.device)
        raw[idx] ^= mask
    return out


def query_outcome(tokens: torch.Tensor, golden: torch.Tensor,
                  resident: bool) -> str:
    if bool((tokens < 0).any()):
        return "crash"
    if not torch.equal(tokens, golden):
        return "incorrect"
    return "masked_logic" if resident else "masked_overwrite"


def trial_outcome(kind: str, outputs: List[torch.Tensor],
                  golden: torch.Tensor, resident: bool) -> str:
    """The worst of a trial's query outcomes; a hard trial's second query
    ran on clean weights."""
    res = [query_outcome(o, golden, resident and not (kind == "hard"
                                                      and i == 1))
           for i, o in enumerate(outputs)]
    return max(res, key=ORDER.index)
