"""Online serving plane launcher: drive the continuous-batching engine at
a target request rate while an error storm fires, and report measured SLOs
(throughput, TTFT/TPOT p50/p99, incorrect-response rate, availability).

Counterpart of ``repro.launch.serve_online``, with ``--device`` (default:
the card). The parameters come from ``repro_torch.draws`` (seed 0), the
same on every device; they differ from the reference's ``jax.random``
draws. The request trace and the storm draw the reference's numpy streams.

  # 50-request tiny burst, params under detect_recover, KV pages on parity
  PYTHONPATH=src python -m repro_torch.launch.serve_online --device cpu \\
      --requests 50 --rate 8 --policy detect_recover --kv-tier parity_r \\
      --storm-errors 540

  # golden (zero-injection) + storm pass on the same trace -> incorrect rate
  PYTHONPATH=src python -m repro_torch.launch.serve_online --device cpu \\
      --golden --policy detect_recover --kv-tier parity_r --storm-errors 540

Pass ``--no-tiny`` for the full-size architecture; ``--dry-run`` prints
the plan (trace, geometry, domains) without touching the model;
``--json PATH`` writes the SLO report to PATH.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_tiny
from repro_torch.core import DESIGN_POINTS, Tier
from repro_torch.models import init_params


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True)
    # traffic
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean arrival rate, requests/s")
    ap.add_argument("--process", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--prompt-lens", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--max-new", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--seed", type=int, default=0)
    # serving plane geometry
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages", type=int, default=None,
                    help="pool size; default slots*max_pages_per_slot+1")
    ap.add_argument("--max-prefills", type=int, default=2)
    ap.add_argument("--max-queue", type=int, default=None)
    # reliability
    ap.add_argument("--policy", choices=sorted(DESIGN_POINTS), default=None,
                    help="params design point (default: unprotected)")
    ap.add_argument("--kv-tier",
                    choices=[t.value for t in Tier], default="none",
                    help="tier over the paged KV pools")
    ap.add_argument("--storm-errors", type=int, default=0,
                    help="server-month error budget compressed into the run")
    ap.add_argument("--peer-recovery", action="store_true",
                    help="recover detected-uncorrectable errors from a "
                         "live data-parallel replica (in-memory gather, "
                         "peer-copy MTTR) instead of the disk reload")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay a recorded error trace (.npz from "
                         "repro_torch.core.tracegen) instead of the Poisson "
                         "storm: deterministic run-to-run")
    ap.add_argument("--scrub-every", type=int, default=None,
                    help="override the policy's params scrub cadence "
                         "(iterations)")
    # harness
    ap.add_argument("--clock", choices=("model", "wall"), default="model")
    ap.add_argument("--golden", action="store_true",
                    help="also run a zero-injection golden pass on the same "
                         "trace and report the incorrect-response rate")
    ap.add_argument("--json", default=None,
                    help="write the SLO report to this path")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the parameters, the KV pools and the "
                         "decode (default: the CUDA card)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.serve import TrafficConfig, generate_trace

    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    tc = TrafficConfig(n_requests=args.requests, rate=args.rate,
                       process=args.process,
                       prompt_len_choices=tuple(args.prompt_lens),
                       max_new_choices=tuple(args.max_new), seed=args.seed)
    trace = generate_trace(tc, cfg.vocab_size)
    kv_tier = Tier(args.kv_tier)
    policy = DESIGN_POINTS[args.policy]() if args.policy else None

    page = args.page_size
    max_pages = -(-(tc.max_prompt_len + tc.max_new_cap) // page)
    n_pages = args.pages or args.slots * max_pages + 1
    if args.dry_run:
        span = trace[-1].arrival if trace else 0.0
        toks = sum(r.footprint_tokens() for r in trace)
        print(f"plan: {cfg.name} ({'tiny' if args.tiny else 'full'}) "
              f"{len(trace)} requests over {span:.2f}s "
              f"({args.process}, rate={args.rate}/s), {toks} KV tokens")
        print(f"plane: slots={args.slots} pages={n_pages} x {page} tokens "
              f"(max {max_pages}/slot), prefills/step<={args.max_prefills}")
        storm = (f"trace:{args.trace}" if args.trace
                 else f"{args.storm_errors} errors")
        print(f"reliability: params={args.policy or 'none'} "
              f"kv={kv_tier.value} storm={storm}"
              f"{' peer-recovery' if args.peer_recovery else ''}")
        return 0

    from repro_torch.serve import OnlineEngine, incorrect_rate

    params = init_params(cfg, seed=0, device=device)

    def make_engine():
        return OnlineEngine(
            cfg, params, slots=args.slots, page_size=page,
            max_prompt_len=tc.max_prompt_len, max_new_cap=tc.max_new_cap,
            n_pages=args.pages, policy=policy, kv_tier=kv_tier,
            scrub_every=args.scrub_every, clock=args.clock,
            max_prefills_per_step=args.max_prefills,
            max_queue=args.max_queue, peer_recovery=args.peer_recovery,
            seed=args.seed)

    error_trace = None
    if args.trace:
        from repro_torch.core.trace import ErrorTrace
        error_trace = ErrorTrace.load(args.trace)
        print(f"replaying {error_trace.summary()}")

    engine = make_engine()
    print(engine.describe())
    golden = None
    if args.golden:
        g_report, golden = make_engine().run(trace, storm_errors=0)
        print("golden:", g_report.summary())
    report, responses = engine.run(trace, storm_errors=args.storm_errors,
                                   error_trace=error_trace)
    if golden is not None:
        report.incorrect_rate = incorrect_rate(golden, responses)
    stormy = args.storm_errors or error_trace is not None
    print("storm: " if stormy else "run:   ", report.summary())
    print(f"availability {report.availability:.4%} vs paper bar 99.90%: "
          f"{'PASS' if report.availability >= 0.9990 else 'FAIL'}")
    if args.json:
        report.write_json(args.json)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
