"""Serve a small model with batched requests under an HRM policy, with
errors injected mid-flight: the WebSearch/Memcached serving scenario.

Counterpart of ``examples/serve_kv.py``:

  PYTHONPATH=src python -m repro_torch.examples.serve_kv --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch._device import resolve_device
from repro_torch.configs import get_tiny
from repro_torch.core import detect_recover
from repro_torch.draws import Stream
from repro_torch.examples._common import add_device
from repro_torch.models import init_params
from repro_torch.runtime.serve_loop import serve_batch


def main(argv: Optional[List[str]] = None) -> int:
    ap = add_device(argparse.ArgumentParser(description=__doc__))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_tiny("llama3-8b")
    params = init_params(cfg, seed=0, device=device)
    prompts = Stream(1, device).randint(cfg.vocab_size, (4, 16))

    policy = detect_recover()
    object.__setattr__(policy, "scrub_interval", 4)

    toks, report = serve_batch(cfg, params, prompts, max_new_tokens=12,
                               policy=policy, error_rate_per_token=0.5,
                               seed=9)
    print("generated tokens:\n", toks.tolist())
    print(f"queries={report.queries} tokens={report.tokens_emitted} "
          f"injected={report.injected} detected={report.scrub_detected} "
          f"corrected={report.scrub_corrected} "
          f"sidecar_overhead={report.sidecar_overhead:.2%}")
    if tuple(toks.shape) != (4, 12):
        raise AssertionError(f"generated {tuple(toks.shape)}, not (4, 12)")
    print("SERVE_KV OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
