"""Configuration of the port: copies of ``repro.configs.base``'s
``ModelConfig``, ``ShapeSpec`` and ``TrainConfig``.

The port keeps its own copy so that it imports nothing of the JAX package.
The sub-configurations of the other families (MoE, Mamba2, xLSTM) come
with the slices that port those families; until then their fields hold
``None``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition. One instance per assigned architecture."""

    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"          # swiglu | relu2 | gelu
    qkv_bias: bool = False
    causal: bool = True
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[Any] = None
    ssm: Optional[Any] = None
    xlstm: Optional[Any] = None
    attn_every: int = 0          # hybrid: shared attn block every k mixer layers
    frontend: str = "none"       # none | audio_frames | vision_patches
    n_patches: int = 0           # vlm: image patch embeddings prepended to text
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    shard_hints: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned workload shape (applies per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


@dataclass(frozen=True)
class TrainConfig:
    """Training-step hyperparameters (shape-independent). The reference's
    sharding knobs (``zero_moments``, ``scan_layers`` and its
    ``MeshConfig``) mean nothing on one device and are left out."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient accumulation
    remat: str = "full"          # none | full | dots (activation checkpoints)
    grad_compress: bool = False  # int8 gradients with error feedback

