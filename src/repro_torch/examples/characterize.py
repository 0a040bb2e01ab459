"""The paper's Fig.2 campaign on the three case-study applications (dense
LM as the web-search stand-in, the Memcached-analogue kv-store, and
PageRank graph mining), printing the Fig.3/Fig.4-style breakdown.

Counterpart of ``examples/characterize.py``:

  PYTHONPATH=src python -m repro_torch.examples.characterize --device cpu

``--trace`` replays a recorded error stream (``repro_torch.core.tracegen``)
instead of iid sampling: one trial per trace event, in arrival order,
with the trace deciding strike address, burst width, and hard/soft kind.
Bit-deterministic: the same trace prints the same table every run:

  PYTHONPATH=src python -m repro_torch.core.tracegen --out month.npz
  PYTHONPATH=src python -m repro_torch.examples.characterize \\
      --trace month.npz --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch._device import resolve_device
from repro_torch.configs import get_tiny
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import (ErrorTrace, HRMPolicy, MemoryDomain,
                              lm_eval_fn, run_campaign, run_trace_campaign)
from repro_torch.data.synthetic import make_batch
from repro_torch.draws import Stream
from repro_torch.examples._common import add_device
from repro_torch.graph import graph_state, pagerank_eval_fn, powerlaw_graph
from repro_torch.models import forward, init_params


def _lm_parts(device):
    cfg = get_tiny("llama3-8b")
    params = init_params(cfg, seed=0, device=device)
    batch = make_batch(cfg, ShapeSpec("c", 32, 2, "train"), device=device)
    return params, lm_eval_fn(cfg, batch, forward)


def lm_campaign(device):
    params, ev = _lm_parts(device)
    return run_campaign(ev, params, n_trials=30, seed=3)


def _kv_parts(device):
    """Memcached analogue: value table + read path; queries are lookups."""
    cfg = get_tiny("kvstore-demo")
    params = init_params(cfg, seed=1, device=device)
    keys = Stream(2, device).randint(cfg.vocab_size, (2, 32))
    return params, lm_eval_fn(cfg, {"tokens": keys}, forward)


def kvstore_campaign(device):
    params, ev = _kv_parts(device)
    return run_campaign(ev, params, n_trials=30, seed=4)


def _graph_parts(device):
    """PageRank on a power-law graph: queries are top-k rankings; the
    iterate masks errors through convergence, the topology does not."""
    g = powerlaw_graph(256, avg_degree=8, seed=5)
    domain = MemoryDomain.protect({"graph": graph_state(g, device=device)},
                                  HRMPolicy("campaign/graph", {}))
    return domain, pagerank_eval_fn(g.n, iters=12)


def graph_campaign(device):
    domain, ev = _graph_parts(device)
    return run_campaign(ev, domain, n_trials=20, seed=6)


def show(name, res):
    print(f"\n=== {name} ===")
    print(f"{'region':16s} {'kind':5s} {'crash':>7s} {'incorrect':>9s} "
          f"{'tolerance':>9s}")
    for (region, kind), s in sorted(res.stats.items()):
        print(f"{region:16s} {kind:5s} {s.crash_prob:7.3f} "
              f"{s.incorrect_prob:9.3f} {s.tolerance:9.3f}")
    print(f"overall: crash={res.crash_prob():.3f} "
          f"incorrect={res.incorrect_prob():.3f}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = add_device(argparse.ArgumentParser(
        description="Fig.2 error-emulation campaigns (iid, or replaying a "
                    "recorded trace with --trace)."))
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay a recorded error trace (.npz) instead of "
                         "iid strike sampling")
    ap.add_argument("--max-events", type=int, default=None,
                    help="cap the number of replayed trace events per app")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.trace:
        trace = ErrorTrace.load(args.trace)
        print(f"replaying {trace.summary()}")
        builders = (("dense LM (llama3-8b tiny)", _lm_parts),
                    ("kv-store (Memcached analogue)", _kv_parts),
                    ("graph mining (PageRank, power-law)", _graph_parts))
        for name, build in builders:
            state, ev = build(device)
            res = run_trace_campaign(ev, state, trace,
                                     max_events=args.max_events)
            show(name, res)
        print("\nCHARACTERIZE TRACE OK")
        return 0

    lm = lm_campaign(device)
    kv = kvstore_campaign(device)
    gr = graph_campaign(device)
    show("dense LM (llama3-8b tiny)", lm)
    show("kv-store (Memcached analogue)", kv)
    show("graph mining (PageRank, power-law)", gr)
    # Finding 1: tolerance varies across applications
    print("\ninter-app incorrect-rate ratio:",
          round(max(lm.incorrect_prob(), 1e-3)
                / max(kv.incorrect_prob(), 1e-3), 2))
    print("CHARACTERIZE OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
