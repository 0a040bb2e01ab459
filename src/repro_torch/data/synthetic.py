"""Deterministic synthetic data pipeline.

Counterpart of ``repro.data.synthetic`` for the token frontend: the same
numpy stream from the same seed (a Zipf-ish token process with periodic
copy spans), returned as int64 tensors on ``device`` (the card unless
given). The audio and vision batches wait for the families that read them
(ROADMAP.md, queue 1, item 12).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSpec


def lm_batch(cfg: ModelConfig, batch: int, seq: int, seed: int, *,
             device=None) -> Dict[str, torch.Tensor]:
    """Next-token LM batch: tokens + shifted labels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    # Zipf body with periodic copy spans -> learnable structure
    base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64) % (V - 1) + 1
    period = 17
    idx = np.arange(seq + 1)
    copy_from = np.maximum(idx - period, 0)
    mask = (idx % period) < (period // 2)
    stream = torch.from_numpy(np.where(mask[None, :], base[:, copy_from],
                                       base)).to(dev)
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def make_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
               batch_override: Optional[int] = None, *,
               device=None) -> Dict[str, torch.Tensor]:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"the {cfg.frontend!r} frontend's batches are not ported yet "
            "(ROADMAP.md, queue 1, item 12)")
    b = batch_override if batch_override is not None else shape.global_batch
    return lm_batch(cfg, b, shape.seq_len, seed, device=device)


def batch_stream(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, *,
                 device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite deterministic stream (step i derives from seed+i)."""
    i = 0
    shape = ShapeSpec("stream", seq, batch, "train")
    while True:
        yield make_batch(cfg, shape, seed=seed + i, batch_override=batch,
                         device=device)
        i += 1
