"""Deterministic synthetic data pipeline.

Counterpart of ``repro.data.synthetic``: the same numpy streams from the
same seed, returned on ``device`` (the card unless given), tokens and
labels as int64. The LM stream is a Zipf-ish token process with periodic
copy spans; the audio batch is float32 frame embeddings with per-frame
cluster labels; the vision batch is float32 patch embeddings and the
text tokens that follow them.
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


def audio_batch(cfg: ModelConfig, batch: int, seq: int, seed: int, *,
                device=None) -> Dict[str, torch.Tensor]:
    """``seq`` frame embeddings (B,seq,D) and a cluster label a frame."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq))
    return {"frames": torch.from_numpy(frames).to(dev),
            "labels": torch.from_numpy(labels).to(dev, torch.int64)}


def vlm_batch(cfg: ModelConfig, batch: int, seq: int, seed: int, *,
              device=None) -> Dict[str, torch.Tensor]:
    """``cfg.n_patches`` patch embeddings (B,P,D), then ``seq - P`` text
    tokens with their shifted labels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_p = cfg.n_patches
    s_text = seq - n_p
    if s_text <= 0:
        raise ValueError(f"seq={seq} leaves no text after {n_p} patches")
    tokens = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (batch, s_text + 1))).to(
            dev, torch.int64)
    patches = torch.from_numpy(rng.standard_normal(
        (batch, n_p, cfg.d_model), dtype=np.float32)).to(dev)
    return {"tokens": tokens[:, :-1], "patches": patches,
            "labels": tokens[:, 1:]}


def make_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
               batch_override: Optional[int] = None, *,
               device=None) -> Dict[str, torch.Tensor]:
    b = batch_override if batch_override is not None else shape.global_batch
    if cfg.frontend == "audio_frames":
        return audio_batch(cfg, b, shape.seq_len, seed, device=device)
    if cfg.frontend == "vision_patches":
        return vlm_batch(cfg, b, shape.seq_len, seed, device=device)
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
