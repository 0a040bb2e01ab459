"""Configuration of the port: copies of ``repro.configs.base``'s
``MoEConfig``, ``SSMConfig``, ``XLSTMConfig``, ``ModelConfig``,
``ShapeSpec`` with the shape table (``TRAIN_4K``, ``PREFILL_32K``,
``DECODE_32K``, ``LONG_500K``, ``SHAPES``, ``SHAPE_BY_NAME``,
``shape_applicability``), ``TrainConfig`` and ``MeshConfig`` with its
``SINGLE_POD`` and ``MULTI_POD`` meshes.

The port keeps its own copy so that it imports nothing of the JAX package.
The sub-configurations of the MoE, hybrid (Mamba2) and xLSTM families and
the frontend fields are the reference's, defaults included.
``shard_hints`` selects the MoE's per-group dispatch under an ambient mesh
(``models/mlp.py``); ``MoEConfig.dispatch`` is carried and, as in the
reference, read by nothing.

``MLAConfig`` is the port's own: a DeepSeek-V2 decoder, which the
reference does not have. It subclasses ``ModelConfig``, so every other
configuration's fields, and ``dataclasses.asdict`` of it, stay the
reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # always-on shared experts (DeepSeekMoE)
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25  # used by the dropping dispatch path
    dispatch: str = "dense"      # "dense" (einsum masking) | "a2a" (EP all-to-all)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer configuration."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64           # SSD head dim (P); n_ssm_heads = expand*d_model/head_dim
    chunk: int = 256             # chunk length for the chunked SSD scan


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block layout (mLSTM-dominant with periodic sLSTM)."""

    slstm_every: int = 8         # one sLSTM block per this many blocks (xLSTM[7:1])
    chunk: int = 256             # chunk length for the chunked mLSTM scan
    expand: int = 2              # mLSTM up-projection factor


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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
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

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "audio", "vlm") or self.attn_every > 0

    @property
    def has_kv_cache(self) -> bool:
        # encoder-only archs never decode; pure-SSM archs use recurrent state.
        return self.has_attention and self.causal

    @property
    def is_decoder(self) -> bool:
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True if sequence mixing is sub-quadratic (SSM / hybrid / linear attn)."""
        return self.family in ("hybrid", "ssm")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A DeepSeek-V2 decoder (arXiv:2405.04434): multi-head latent
    attention (MLA) under YaRN RoPE, ``n_dense_layers`` leading dense
    SwiGLU layers of width ``d_ff`` before the MoE layers, and top-k gates
    renormalised only under ``norm_topk_prob``.

    MLA caches one ``kv_lora_rank``-wide latent and one shared
    ``qk_rope_head_dim``-wide RoPE key a token; each head's query and key
    are ``qk_nope_head_dim + qk_rope_head_dim`` wide, its value
    ``v_head_dim``. The ``rope_*`` fields are the published
    ``rope_scaling`` (YaRN over ``rope_original_max`` positions), whose
    ``mscale`` equals ``mscale_all_dim``, so that the cos/sin factor is
    1 and only the scores' temperature remains."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_dense_layers: int = 1
    norm_topk_prob: bool = False
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale_all_dim: float = 0.707

    @property
    def latent_dim(self) -> int:
        """Values the cache holds a token and layer: latent and RoPE key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


def is_mla(cfg: ModelConfig) -> bool:
    return isinstance(cfg, MLAConfig)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned workload shape (applies per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicability(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Return None if the (arch, shape) cell runs, else a skip reason."""
    if shape.kind == "decode" and not cfg.is_decoder:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k requires sub-quadratic attention (full-attention arch)"
    return None


@dataclass(frozen=True)
class TrainConfig:
    """Training-step hyperparameters (shape-independent). The reference's
    sharding-only fields (``zero_moments``, ``scan_layers``) are read by
    nothing in one process and are left out."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient accumulation
    remat: str = "full"          # none | full | dots (activation checkpoints)
    grad_compress: bool = False  # int8 gradients with error feedback


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's axis sizes and names (``launch.mesh.make_mesh``)."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))

