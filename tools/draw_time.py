#!/usr/bin/env python3
"""Time two ways of drawing llama3-8b's parameters at full width (8 of its
32 layers, as ``chip_smoke.py`` drives them: 2.80 B parameters, bf16) so
that the same seed gives the same values on the card and on the CPU.

    python3 tools/draw_time.py

- A: a CPU ``torch.Generator`` (mt19937) draws the uniforms, the
  truncated-normal transform (``erfinv``) runs on the CPU in float32, and
  each leaf is cast and moved to the card;
- B: ``repro_torch.draws`` on the card (``models.init_params``): integer
  hashes of counters and a tabulated inverse CDF, identical on any device.

Prints each route's wall seconds, the device synchronised, and the card's
name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N_LAYERS = 8


def route_a(cfg, dev) -> int:
    """Route A over the same leaf shapes; returns the parameter count."""
    gen = torch.Generator().manual_seed(0)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = [(L, D, H * dh), (L, D, K * dh), (L, D, K * dh), (L, H * dh, D),
              (L, D, F), (L, F, D), (L, D, F), (V, D), (D, V)]
    n = 0
    for shape in shapes:
        t = torch.empty(shape, dtype=torch.float32)
        t.uniform_(2 * lo - 1, 1 - 2 * lo, generator=gen)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(0.02)
        t.to(torch.bfloat16).to(dev)
        n += t.numel()
    torch.cuda.synchronize()
    return n


def main() -> int:
    if not torch.cuda.is_available():
        print("draw_time: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    cfg = get_config("llama3-8b").replace(n_layers=N_LAYERS)
    init_params(cfg.replace(n_layers=1, vocab_size=1024), device=dev)
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n_b = sum(x.numel() for x in tree.leaves(init_params(cfg,
                                                             device=dev)))
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t
        print(f"route B (repro_torch.draws on the card): {n_b} parameters "
              f"in {b_s:.2f} s")
    t = time.perf_counter()
    n_a = route_a(cfg, dev)
    print(f"route A (CPU torch.Generator, CPU erfinv, moved to the card): "
          f"{n_a} parameters in {time.perf_counter() - t:.2f} s "
          f"({torch.get_num_threads()} CPU threads)")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
