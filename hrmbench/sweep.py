"""The knee of an online cell: its mix served at several rates, one after
the other in one process, on the card.

    python3 -m hrmbench.sweep --workload <cell> --rates 4,6,8 --seconds 30 --seed <n>

For each rate (the mix's calm-state ``rate``) one JSON line: requests, the
median and 95th percentile of TTFT and TPOT, the mean TTFT of each quarter
of the requests by arrival (a backlog that grows through the window shows
as rising quarters) and how long the last request finished after the
window. The knee is the highest rate whose quarters do not rise.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from hrmbench import harness, readers  # noqa: E402
from hrmbench.run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA card")
    _, cell, config, mix = harness.cell_files(a.workload)
    for rate in (float(r) for r in a.rates.split(",")):
        ctx = harness.Context(
            name=a.workload, cell=cell, config=config,
            mix=dict(mix, rate=rate), seed=a.seed, seconds=a.seconds,
            trace=False, device=torch.device("cuda", 0),
            t0=time.perf_counter(),
            device_kind=torch.cuda.get_device_name(0))
        rec = harness.driver(cell["kind"]).run(ctx)
        reqs = sorted(rec["requests"])
        ttft = np.array([(f - a_) * 1e3 for a_, _, f, _, _ in reqs])
        quarters = [float(q.mean()) for q in np.array_split(ttft, 4)]
        print(json.dumps({
            "rate": rate, "requests": len(reqs),
            "arrivals_per_s": len(reqs) / a.seconds,
            "ttft_p50_ms": readers.percentile(rec["ttft_ms"], 50),
            "ttft_p95_ms": readers.percentile(rec["ttft_ms"], 95),
            "tpot_p50_ms": readers.percentile(rec["tpot_ms"], 50),
            "tpot_p95_ms": readers.percentile(rec["tpot_ms"], 95),
            "ttft_mean_ms_by_quarter": quarters,
            "drain_s": max(d for _, _, _, d, _ in reqs) - a.seconds,
            "checks": rec["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
