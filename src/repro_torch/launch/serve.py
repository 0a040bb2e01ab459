"""Serving launcher: batched prefill+decode with HRM protection live.

Counterpart of ``repro.launch.serve``, with ``--device`` (default: the
card). The parameters and prompts come from ``repro_torch.draws`` (seeds 0
and 1), the same on every device; they differ from the reference's
``jax.random`` draws.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --tiny --batch 4 --prompt-len 32 --new-tokens 16 \\
      --policy detect_recover --device cpu

Pass ``--no-tiny`` for the full-size architecture.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_tiny
from repro_torch.core import DESIGN_POINTS
from repro_torch.draws import Stream
from repro_torch.models import init_params
from repro_torch.runtime.serve_loop import serve_batch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--policy", choices=sorted(DESIGN_POINTS), default=None)
    ap.add_argument("--error-rate", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="device of the parameters and the decode "
                         "(default: the CUDA card)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    params = init_params(cfg, seed=0, device=device)
    prompts = Stream(1, device).randint(cfg.vocab_size,
                                        (args.batch, args.prompt_len))
    policy = DESIGN_POINTS[args.policy]() if args.policy else None
    toks, report = serve_batch(cfg, params, prompts, args.new_tokens,
                               policy=policy,
                               error_rate_per_token=args.error_rate)
    print("generated:", toks[:, :8].tolist())
    print(f"tokens={report.tokens_emitted} corrected="
          f"{report.scrub_corrected} detected={report.scrub_detected} "
          f"injected={report.injected}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
