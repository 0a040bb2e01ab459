"""Training launcher: the fault-tolerant train loop with HRM live.

Counterpart of ``repro.launch.train``, with the same flags plus
``--device`` (default: the card). Fault injection, scrubs, clean-copy
recovery, checkpoints and the restart drill all run. The parameters come
from ``repro_torch.draws`` (seed 0), the same on every device; they differ
from the reference's ``jax.random`` draws. Snapshots go to ``--ckpt-dir``;
a directory that already holds one resumes from its newest snapshot.

  PYTHONPATH=src python -m repro_torch.launch.train --arch lm-100m --tiny \\
      --steps 20 --policy detect_recover --error-rate 0.5 --fail-at 8 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_tiny
from repro_torch.configs.base import TrainConfig
from repro_torch.core import DESIGN_POINTS
from repro_torch.data.synthetic import batch_stream
from repro_torch.runtime.train_loop import LoopConfig, run_training


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--policy", choices=sorted(DESIGN_POINTS), default=None)
    ap.add_argument("--scrub-interval", type=int, default=20)
    ap.add_argument("--error-rate", type=float, default=0.0)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the train state (default: the CUDA "
                         "card)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    tcfg = TrainConfig(lr=args.lr, microbatches=args.microbatches,
                       grad_compress=args.grad_compress, remat="none")
    policy = None
    if args.policy:
        policy = DESIGN_POINTS[args.policy]()
        object.__setattr__(policy, "scrub_interval", args.scrub_interval)
    loop = LoopConfig(steps=args.steps, ckpt_interval=args.ckpt_interval,
                      ckpt_dir=args.ckpt_dir,
                      error_rate_per_step=args.error_rate,
                      node_failure_steps=tuple(args.fail_at), policy=policy)
    stream = batch_stream(cfg, args.batch, args.seq, device=device)
    report = run_training(cfg, tcfg, loop, stream, device=device)
    print(f"steps={len(report.losses)} loss: {report.losses[0]:.4f} -> "
          f"{report.losses[-1]:.4f}")
    print(f"injected={report.injected} corrected={report.scrub_corrected} "
          f"detected={report.scrub_detected} recoveries={report.recoveries} "
          f"restarts={report.restarts} stragglers={report.straggler_events}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
