"""Readings that set a cell's limits: the program's compared numbers and
the control's, seed after seed in one process, on the card.

    python3 -m hrmbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 10

The control is the reference computed in float8 e4m3 (the precision below
the configuration's bfloat16), read on the same prompts and tokens as the
program's run. One JSON line a seed.
"""
import time

import argparse  # noqa: E402
import json  # noqa: E402

from hrmbench import harness  # noqa: E402
from hrmbench.run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("calibration needs a CUDA card")
    _, cell, config, mix = harness.cell_files(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        ctx = harness.Context(
            name=a.workload, cell=cell, config=config, mix=mix, seed=seed,
            seconds=a.seconds, trace=False, device=torch.device("cuda", 0),
            t0=time.perf_counter(),
            device_kind=torch.cuda.get_device_name(0), control=True)
        rec = harness.driver(cell["kind"]).run(ctx)
        print(json.dumps({"seed": seed, "checks": rec["checks"],
                          "program": rec["judged"],
                          "control": rec["control"],
                          "queries": rec.get("judged_queries"),
                          "reference_s": rec["reference_s"],
                          "attempted": rec["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
