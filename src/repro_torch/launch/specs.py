"""Shape-only stand-ins for every model input: tensors on the ``meta``
device, which carry a shape and a dtype and allocate nothing.

Counterpart of ``repro.launch.specs``, whose ``jax.ShapeDtypeStruct``
stand-ins come from ``jax.eval_shape``; here the port's own initialisers
run on ``meta`` (``init_params``, ``init_train_state``, ``init_cache``),
so every tree has the leaves, shapes and dtypes a real run would have.
Token and label ids are int64, as the port's batches carry them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, TrainConfig
from repro_torch.core import tree
from repro_torch.models import init_cache, init_params
from repro_torch.runtime.steps import init_train_state

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Training/prefill batch as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    ids = torch.int64
    if cfg.frontend == "audio_frames":
        return {"frames": _sds((B, S, cfg.d_model), torch.float32),
                "labels": _sds((B, S), ids)}
    if cfg.frontend == "vision_patches":
        s_text = S - cfg.n_patches
        return {"tokens": _sds((B, s_text), ids),
                "patches": _sds((B, cfg.n_patches, cfg.d_model),
                                torch.float32),
                "labels": _sds((B, s_text), ids)}
    return {"tokens": _sds((B, S), ids), "labels": _sds((B, S), ids)}


def params_shape(cfg: ModelConfig):
    return init_params(cfg, device=META)


def train_state_shape(cfg: ModelConfig, tcfg: TrainConfig):
    return init_train_state(0, cfg, tcfg, device=META)


def cache_shape(cfg: ModelConfig, batch: int, max_seq: int):
    return init_cache(cfg, batch, max_seq, device=META)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, int]:
    """(cache, token, pos) stand-ins for one serve step. The port's serve
    step takes the position as a Python int (the reference's is a traced
    int32 scalar): the last cached position, where a step at this cache
    length writes."""
    B, S = shape.global_batch, shape.seq_len
    return cache_shape(cfg, B, S), _sds((B,), torch.int64), S - 1


def default_train_config(cfg: ModelConfig, shape: ShapeSpec) -> TrainConfig:
    """Per-arch microbatching heuristic: keep activations + grad-accum
    buffers inside 16 GB/chip for the big dense configs."""
    n_params = param_count(cfg)
    if n_params >= 5e10:
        mb = 16
    elif n_params >= 5e9:
        mb = 8
    elif n_params >= 1e9:
        mb = 4
    else:
        mb = 1
    mb = min(mb, shape.global_batch)
    return TrainConfig(microbatches=mb, remat="full")


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(leaf.shape) for leaf in tree.leaves(
        params_shape(cfg)))
