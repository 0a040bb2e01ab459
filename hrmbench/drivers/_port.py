"""What the drivers take from the port: its configuration class, its
parameter tree (checked against the benchmark's layout on the ``meta``
device) and its kernel library."""
from __future__ import annotations

import time

import torch

from hrmbench import weights


def model_config(c: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import MoEConfig, ModelConfig
    keys = ("name", "family", "n_layers", "d_model", "n_heads",
            "n_kv_heads", "d_ff", "vocab_size", "act", "rope_theta",
            "norm_eps", "param_dtype", "compute_dtype")
    moe = c.get("moe")
    return ModelConfig(**{k: c[k] for k in keys},
                       moe=MoEConfig(**moe) if moe else None)


def check_layout(cfg, c: dict) -> None:
    """Fail unless the port's parameter tree is the benchmark's layout,
    path for path, shape and dtype."""
    from repro_torch.models import init_params
    meta = weights.flat_leaves(init_params(cfg, seed=0, device="meta"))
    port = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in meta]
    ours = sorted((p, tuple(s), d) for p, s, d, _ in weights.layout(c))
    if port != ours:
        raise RuntimeError(f"the port's parameter tree of {c['name']} is "
                           f"not the benchmark's layout:\n{port}\n{ours}")


def check_dropless(c: dict, max_tokens: int) -> None:
    """The port's MoE capacity must hold every token of the largest step
    (``models/mlp.py::_capacity``), or it drops routed tokens."""
    import math
    moe = c["moe"]
    cap = math.ceil(moe["top_k"] * max_tokens * moe["capacity_factor"]
                    / moe["n_experts"])
    if cap < max_tokens:
        raise RuntimeError(f"capacity {cap} < {max_tokens} tokens: the "
                           f"dispatch would drop tokens")


def build_kernels(device: torch.device) -> float:
    """Load the kernel library (building it on the first run in this
    checkout); returns the seconds it took."""
    t = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.library()
    return time.perf_counter() - t
