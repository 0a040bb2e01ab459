"""End-to-end driver: train the ~100M-param example LM under an HRM policy
with live fault injection, scrubbing, clean-copy recovery,
checkpoint/restart and a simulated node failure.

Counterpart of ``examples/train_hrm.py``; the snapshots go to a temporary
directory that is removed at the end:

  PYTHONPATH=src python -m repro_torch.examples.train_hrm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_hrm --small \\
      --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_tiny
from repro_torch.configs.base import TrainConfig
from repro_torch.core import Response, detect_recover
from repro_torch.data.synthetic import batch_stream
from repro_torch.examples._common import add_device
from repro_torch.runtime.train_loop import LoopConfig, run_training


def main(argv: Optional[List[str]] = None) -> int:
    ap = add_device(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.small:
        cfg = get_tiny("lm-100m")
        steps = args.steps or 30
        batch, seq = 8, 64
    else:
        cfg = get_config("lm-100m")
        steps = args.steps or 300
        batch, seq = 8, 256

    tcfg = TrainConfig(lr=3e-4, remat="none")
    policy = detect_recover()
    object.__setattr__(policy, "scrub_interval", 10)

    with tempfile.TemporaryDirectory(prefix="repro_torch_train_hrm_") as ckpt:
        loop = LoopConfig(
            steps=steps,
            ckpt_interval=max(steps // 4, 10),
            ckpt_dir=ckpt,
            error_rate_per_step=0.2,            # a very error-prone "server"
            hard_error_fraction=0.3,
            node_failure_steps=(int(steps * 0.6),),
            policy=policy,
            response=Response.RELOAD_CLEAN_COPY,
        )
        stream = batch_stream(cfg, batch, seq, device=device)
        report = run_training(cfg, tcfg, loop, stream, device=device)

    first = sum(report.losses[:5]) / 5
    last = sum(report.losses[-5:]) / 5
    print(f"\nloss {first:.4f} -> {last:.4f} over {len(report.losses)} "
          f"steps")
    print(f"injected errors:      {report.injected}")
    print(f"scrub detections:     {report.scrub_detected}")
    print(f"clean-copy recoveries:{report.recoveries}")
    print(f"restarts (node fail): {report.restarts}")
    print(f"straggler events:     {report.straggler_events}")
    ds = report.domain_stats
    print(f"memory domain:        {ds['protected_leaves']} leaves, "
          f"sidecar {ds['sidecar_bytes']}B "
          f"({ds['overhead']:.2%} of {ds['payload_bytes']}B), "
          f"{ds['live_hard_errors']} live hard errors")
    if not last < first:
        raise AssertionError("training must make progress despite faults")
    if report.restarts < 1:
        raise AssertionError("the node-failure drill must have fired")
    print("TRAIN_HRM OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
