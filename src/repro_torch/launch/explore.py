"""Cross-workload Fig.5 design-point explorer: the single entry point for
pricing HRM over every workload the repo serves.

Counterpart of ``repro.launch.explore``. Sweeps {websearch, kvstore,
graph} x {typical_server, consumer_pc, detect_recover, less_tested,
detect_recover_l, dected_server, burst_dr_l, mirror_dr_l, peer_dr_l,
autopolicy} and emits one Fig.5-style table per workload: relative memory
cost (the capacity premium), memory/server savings, availability, crashes
and incorrect responses per month, from the cost model
(``core.costmodel``), the availability model (``core.availability``) and
the policy auto-tuner (``core.autopolicy``).

The replication-aware ``peer_dr_l`` point recovers detections from a live
data-parallel replica (``Response.PEER_COPY``): its table row bills the
in-memory peer-copy MTTR separately from disk reloads (the ``peer/mo``
column).

The strong-ECC design points (``dected_server``, ``burst_dr_l``,
``mirror_dr_l``) do not reuse the calibrated ECC outcome constants: their
per-tier outcome rates are *measured* by driving the DEC-TED, BURST and
parity kernels over injected single / random-double / adjacent-burst
strikes (``core.eccmeasure``), and each table row is tagged with its
ECC-outcome source (``ecc_src``: measured vs calibrated).

Vulnerability profiles per workload default to the calibrated constants
below (provenance: docs/DESIGN.md §8); ``--measure`` replaces them with a
live Fig.2 injection campaign (``core.characterize``) on the workload's
real state.

``--trace`` replays a recorded error trace (``core.trace``) and prints a
trace-driven table (``ecc_src=trace``) next to each analytic one.

The port's one addition is ``--device`` (default: the card), where the
workloads' state lives and the kernels run. The kv-store's random
parameters and keys come from ``repro_torch.draws`` seeded with the
workload's seed: the same on every device, and other than the
reference's ``jax.random`` draws.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.explore --workload graph
  PYTHONPATH=src python -m repro_torch.launch.explore --dry-run --device cpu
  PYTHONPATH=src python -m repro_torch.launch.explore --workload kvstore \\
      --measure
  PYTHONPATH=src python -m repro_torch.launch.explore --workload all \\
      --trace month.npz --device cpu
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_tiny
from repro_torch.core.autopolicy import tune_policy, vuln_from_campaign
from repro_torch.core.availability import (MULTI_BIT_FRACTION,
                                           WEBSEARCH_VULN, VulnProfile,
                                           evaluate_availability,
                                           paper_design_availability,
                                           replay_availability)
from repro_torch.core.characterize import lm_eval_fn, run_campaign
from repro_torch.core.costmodel import (_PAPER_POLICIES, MEMORY_COST_SHARE,
                                        WEBSEARCH, RegionProfile,
                                        paper_design_costs,
                                        policy_cost_saving, region_fractions)
from repro_torch.core.domain import MemoryDomain
from repro_torch.core.eccmeasure import measured_tier_rates
from repro_torch.core.errormodel import DEFAULT_ADJACENT_FRACTION
from repro_torch.core.policy import DESIGN_POINTS, HRMPolicy
from repro_torch.core.tiers import Tier
from repro_torch.core.trace import ErrorTrace
from repro_torch.draws import Stream
from repro_torch.graph import (bfs_eval_fn, graph_state, pagerank_eval_fn,
                               powerlaw_graph)
from repro_torch.models import forward, init_params

WORKLOADS = ("websearch", "kvstore", "graph")
DESIGNS = ("typical_server", "consumer_pc", "detect_recover",
           "less_tested", "detect_recover_l", "dected_server",
           "burst_dr_l", "mirror_dr_l", "peer_dr_l", "autopolicy")
# design points with a software recovery layer (Table 2); on the others an
# uncorrectable ECC error is a machine-check crash (the auto-tuned point
# always assumes the software layer and is handled separately)
_SOFTWARE_RESPONSE = {"detect_recover", "detect_recover_l", "consumer_pc",
                      "burst_dr_l", "mirror_dr_l", "peer_dr_l"}
# design points whose ECC outcomes are measured through the real kernels
MEASURED_ECC_DESIGNS = {"dected_server", "burst_dr_l", "mirror_dr_l"}
# design points recovering from a live data-parallel replica
# (Response.PEER_COPY): detections are billed the in-memory peer-copy
# MTTR, not the disk reload (core.availability.PEER_COPY_SECONDS)
PEER_RECOVERY_DESIGNS = {"peer_dr_l"}


def _measured_rates(device):
    """Per-tier outcome rates for the strong-ECC tiers, measured through
    the DEC-TED / BURST / MIRROR kernels on ``device`` under the
    availability model's incident mix (lru-cached downstream, so the
    kernels run once per process and device)."""
    return measured_tier_rates((Tier.DECTED, Tier.BURST, Tier.MIRROR),
                               MULTI_BIT_FRACTION,
                               DEFAULT_ADJACENT_FRACTION, device=device)


# Calibrated per-region vulnerability (docs/DESIGN.md §8). The kv-store
# mirrors the paper's Memcached: a huge tolerant value table, thin
# crash-prone index/metadata. The graph workload mirrors its GraphLab-style
# finding: pointer-heavy topology crashes, the numeric iterate self-heals.
KVSTORE_VULN = VulnProfile(
    p_crash={"params/embed": 0.03, "params/attn": 0.25, "params/mlp": 0.10,
             "params/norm": 0.35, "params/ssm": 0.10,
             "params/experts": 0.05},
    r_incorrect={"params/embed": 4.0, "params/attn": 1.0, "params/mlp": 1.5,
                 "params/norm": 0.5, "params/ssm": 1.0,
                 "params/experts": 2.0},
)
GRAPH_VULN = VulnProfile(
    p_crash={"graph/topology": 0.45, "graph/rank": 0.02,
             "graph/frontier": 0.10},
    r_incorrect={"graph/topology": 5.0, "graph/rank": 0.5,
                 "graph/frontier": 2.0},
)


@dataclass
class ExploreRow:
    workload: str
    design: str
    memory_cost_rel: float
    memory_saving: float
    server_saving: float
    availability: float
    crashes_per_month: float
    incorrect_per_million: float
    recoveries_per_month: float
    ecc_source: str = "calibrated"
    # in-memory replica gathers (PEER_COPY-recovering designs): charged
    # PEER_COPY_SECONDS each, separately from disk recoveries
    peer_recoveries_per_month: float = 0.0

    _FMT = ("{design:18s} {memory_cost_rel:8.3f} {memory_saving:9.2%} "
            "{server_saving:9.2%} {availability:9.4%} "
            "{crashes_per_month:9.2f} {incorrect_per_million:6.2f} "
            "{recoveries_per_month:9.1f} {peer_recoveries_per_month:9.1f} "
            "{ecc_source:>10s}")

    def row(self) -> str:
        return self._FMT.format(**vars(self))


@dataclass
class Workload:
    """One application under the explorer: a measured (or paper-given)
    region byte profile plus a per-region vulnerability profile."""
    name: str
    profile: RegionProfile
    vuln: VulnProfile
    paper: bool = False          # websearch: use the paper's policies
    vuln_source: str = "calibrated"


# ------------------------------------------------------------- workloads
def websearch_workload() -> Workload:
    """The paper's workload: Fig.5 exactly as published."""
    return Workload("websearch", WEBSEARCH, WEBSEARCH_VULN, paper=True,
                    vuln_source="paper")


def _kvstore_state(cfg, seed: int, device):
    """The kv-store's random parameters and its (2, 32) query keys."""
    params = init_params(cfg, seed=seed, device=device)
    keys = Stream(seed + 1, device).randint(cfg.vocab_size, (2, 32))
    return params, keys


def kvstore_workload(*, measure: bool = False, trials: int = 20,
                     seed: int = 0, device=None) -> Workload:
    """In-memory KV store (Memcached analogue): the tiny kvstore-demo
    model's value table + read path, profile measured from its params."""
    cfg = get_tiny("kvstore-demo")
    params, keys = _kvstore_state(cfg, seed, resolve_device(device))
    profile = region_fractions(params)
    vuln, source = KVSTORE_VULN, "calibrated"
    if measure:
        vuln = vuln_from_campaign(run_campaign(
            lm_eval_fn(cfg, {"tokens": keys}, forward), params,
            n_trials=trials, seed=seed))
        source = f"measured ({trials} trials)"
    return Workload("kvstore", profile, vuln, vuln_source=source)


def graph_workload(*, measure: bool = False, trials: int = 20,
                   n_nodes: int = 512, seed: int = 0,
                   node_block: Optional[int] = None,
                   device=None) -> Workload:
    """Graph mining (PageRank over a power-law graph): profile measured
    from a live graph ``MemoryDomain``. ``node_block`` builds the state
    in the node-blocked layout (``--graph-node-block``), so the campaign
    also covers the block-dispatch tables: structure whose corruption
    drops or reroutes whole edge tiles."""
    g = powerlaw_graph(n_nodes, avg_degree=8, seed=seed)
    state = graph_state(g, with_bfs=True, node_block=node_block,
                        device=device)
    domain = MemoryDomain.protect({"graph": state},
                                  HRMPolicy("explore/graph", {}))
    profile = domain.region_profile()
    vuln, source = GRAPH_VULN, "calibrated"
    if measure:
        # the query runs both algorithms so every protected region is
        # observable: PageRank reads topology+rank, BFS reads
        # topology+frontier
        pr_ev = pagerank_eval_fn(g.n, iters=10)
        bfs_ev = bfs_eval_fn(g.n)

        def ev(payload):
            toks, payload = pr_ev(payload)
            dist, payload = bfs_ev(payload)
            return torch.cat([toks, dist]), payload
        vuln = vuln_from_campaign(
            run_campaign(ev, domain, n_trials=trials, seed=seed))
        source = f"measured ({trials} trials, n={g.n})"
    return Workload("graph", profile, vuln, vuln_source=source)


def build_workload(name: str, **kw) -> Workload:
    if name == "websearch":
        return websearch_workload()
    if name == "kvstore":
        return kvstore_workload(**kw)
    if name == "graph":
        return graph_workload(**kw)
    raise ValueError(f"workload {name!r} not in {WORKLOADS}")


# ----------------------------------------------------------------- sweep
def _auto_point(w: Workload, availability_target: float,
                incorrect_target: float):
    """The auto-tuned point: cheapest feasible tier map over normally- and
    less-tested devices (the tuner explores the space the paper opens).
    Returns (ExploreRow, tuned HRMPolicy)."""
    best = None
    for less in (False, True):
        try:
            res = tune_policy(w.profile, w.vuln,
                              availability_target=availability_target,
                              incorrect_target_per_million=incorrect_target,
                              less_tested=less, name="autopolicy")
        except ValueError:
            continue
        if best is None or res.memory_cost_rel < best.memory_cost_rel:
            best = res
    if best is None:
        raise ValueError(f"no feasible autopolicy for {w.name} under "
                         f"avail>={availability_target} "
                         f"bad/M<={incorrect_target}")
    avail = evaluate_availability(
        "autopolicy", best.policy.tiers, w.profile, w.vuln,
        less_tested=best.policy.error_model.less_tested,
        software_response=True)
    row = ExploreRow(w.name, "autopolicy",
                     best.memory_cost_rel, best.memory_saving,
                     best.memory_saving * MEMORY_COST_SHARE,
                     avail.availability, avail.crashes_per_month,
                     avail.incorrect_per_million,
                     avail.recoveries_per_month)
    return row, best.policy


def explore_workload(w: Workload, designs: List[str], *,
                     availability_target: float = 0.9990,
                     incorrect_target: float = 12.0,
                     device=None) -> List[ExploreRow]:
    """One Fig.5-style row per design point on workload ``w``; measured
    ECC rates come from the kernels on ``device`` (the card unless
    given)."""
    rows: List[ExploreRow] = []
    need_measured = any(n in MEASURED_ECC_DESIGNS for n in designs)
    rates = _measured_rates(device) if need_measured else None
    paper_costs = paper_design_costs() if w.paper else None
    paper_avail = (paper_design_availability(tier_rates=rates)
                   if w.paper else None)
    for name in designs:
        source = "measured" if name in MEASURED_ECC_DESIGNS \
            else "calibrated"
        if name == "autopolicy":
            rows.append(_auto_point(w, availability_target,
                                    incorrect_target)[0])
            continue
        if w.paper:
            c, a = paper_costs[name], paper_avail[name]
            rows.append(ExploreRow(
                w.name, name, c.memory_cost_rel, c.memory_saving,
                c.server_saving, a.availability, a.crashes_per_month,
                a.incorrect_per_million, a.recoveries_per_month, source,
                a.peer_recoveries_per_month))
            continue
        policy = DESIGN_POINTS[name]()
        cost = policy_cost_saving(policy, w.profile)
        tiers = {r: policy.tier_of(r) for r in w.profile.fractions}
        a = evaluate_availability(
            name, tiers, w.profile, w.vuln,
            less_tested=policy.error_model.less_tested,
            software_response=name in _SOFTWARE_RESPONSE,
            peer_recovery=name in PEER_RECOVERY_DESIGNS,
            tier_rates=rates if name in MEASURED_ECC_DESIGNS else None)
        rows.append(ExploreRow(
            w.name, name, cost.memory_cost_rel, cost.memory_saving,
            cost.server_saving, a.availability, a.crashes_per_month,
            a.incorrect_per_million, a.recoveries_per_month, source,
            a.peer_recoveries_per_month))
    return rows


def _design_tiers(name: str, w: Workload) -> Dict[str, Tier]:
    """Region -> tier map of one design point on workload ``w``'s regions
    (websearch uses the paper's own region classes)."""
    if w.paper:
        return dict(_PAPER_POLICIES[name])
    policy = DESIGN_POINTS[name]()
    return {r: policy.tier_of(r) for r in w.profile.fractions}


def explore_workload_trace(w: Workload, designs: List[str],
                           trace: ErrorTrace, *,
                           availability_target: float = 0.9990,
                           incorrect_target: float = 12.0, seed: int = 0,
                           device=None) -> List[ExploreRow]:
    """The trace-driven twin of ``explore_workload``: costs are identical
    (capacity is capacity), availability/crash/incorrect columns come from
    replaying the recorded error stream (``replay_availability``) instead
    of the analytic incident budget. Rows are tagged ``ecc_src=trace``.
    Deterministic: the same trace and seed reproduce the table bit for
    bit."""
    rows: List[ExploreRow] = []
    need_measured = any(n in MEASURED_ECC_DESIGNS for n in designs)
    rates = _measured_rates(device) if need_measured else None
    paper_costs = paper_design_costs() if w.paper else None
    for name in designs:
        if name == "autopolicy":
            base, policy = _auto_point(w, availability_target,
                                       incorrect_target)
            tiers = {r: policy.tier_of(r) for r in w.profile.fractions}
            a = replay_availability(
                "autopolicy", tiers, w.profile, w.vuln, trace,
                software_response=True, seed=seed)
            rows.append(ExploreRow(
                w.name, "autopolicy", base.memory_cost_rel,
                base.memory_saving, base.server_saving, a.availability,
                a.crashes_per_month, a.incorrect_per_million,
                a.recoveries_per_month, "trace"))
            continue
        c = paper_costs[name] if w.paper else \
            policy_cost_saving(DESIGN_POINTS[name](), w.profile)
        a = replay_availability(
            name, _design_tiers(name, w), w.profile, w.vuln, trace,
            software_response=name in _SOFTWARE_RESPONSE,
            peer_recovery=name in PEER_RECOVERY_DESIGNS,
            tier_rates=rates if name in MEASURED_ECC_DESIGNS else None,
            seed=seed)
        rows.append(ExploreRow(
            w.name, name, c.memory_cost_rel, c.memory_saving,
            c.server_saving, a.availability, a.crashes_per_month,
            a.incorrect_per_million, a.recoveries_per_month, "trace",
            a.peer_recoveries_per_month))
    return rows


_HEADER = (f"{'design':18s} {'mem_cost':>8s} {'mem_save':>9s} "
           f"{'srv_save':>9s} {'avail':>9s} {'crash/mo':>9s} "
           f"{'bad/M':>6s} {'recov/mo':>9s} {'peer/mo':>9s} "
           f"{'ecc_src':>10s}")


def format_table(w: Workload, rows: List[ExploreRow]) -> str:
    lines = [f"== {w.name} — Fig.5 design-point sweep "
             f"(vuln: {w.vuln_source}) ==", _HEADER]
    lines += [r.row() for r in rows]
    return "\n".join(lines)


# ------------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Sweep HRM design points across workloads (Fig.5).")
    ap.add_argument("--workload", default="all",
                    choices=WORKLOADS + ("all",))
    ap.add_argument("--design", default="all",
                    choices=DESIGNS + ("all",))
    ap.add_argument("--measure", action="store_true",
                    help="measure vulnerability with a Fig.2 campaign "
                         "instead of the calibrated profiles")
    ap.add_argument("--trials", type=int, default=20,
                    help="campaign trials per error kind (with --measure)")
    ap.add_argument("--graph-nodes", type=int, default=512)
    ap.add_argument("--graph-node-block", type=int, default=None,
                    metavar="BN",
                    help="build the graph state in the node-blocked "
                         "layout with this block size (multiple of 128); "
                         "default: dense single-kernel layout")
    ap.add_argument("--availability-target", type=float, default=0.9990)
    ap.add_argument("--incorrect-target", type=float, default=12.0,
                    help="incorrect responses per million queries")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay a recorded error trace (.npz from "
                         "repro_torch.core.tracegen) and print a "
                         "trace-driven table next to the analytic one")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="salt for the deterministic per-event region "
                         "assignment during trace replay")
    ap.add_argument("--dry-run", action="store_true",
                    help="smallest sizes, no campaigns: wiring smoke test")
    ap.add_argument("--device", default=None,
                    help="device of the workloads' state and kernels "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    workloads = WORKLOADS if args.workload == "all" else (args.workload,)
    designs = list(DESIGNS) if args.design == "all" else [args.design]
    measure = args.measure and not args.dry_run
    n_nodes = 128 if args.dry_run else args.graph_nodes
    trace = None
    if args.trace:
        trace = ErrorTrace.load(args.trace)
        print(f"trace: {args.trace} — {len(trace)} events over "
              f"{trace.months:.2f} server-months")
        print()

    for name in workloads:
        kw: Dict = {}
        if name in ("kvstore", "graph"):
            kw = dict(measure=measure, trials=args.trials, device=device)
        if name == "graph":
            kw["n_nodes"] = n_nodes
            kw["node_block"] = args.graph_node_block
        w = build_workload(name, **kw)
        rows = explore_workload(
            w, designs, availability_target=args.availability_target,
            incorrect_target=args.incorrect_target, device=device)
        print(format_table(w, rows))
        print()
        if trace is not None:
            trows = explore_workload_trace(
                w, designs, trace,
                availability_target=args.availability_target,
                incorrect_target=args.incorrect_target,
                seed=args.trace_seed, device=device)
            print(f"-- {w.name}: trace-driven replay of the same design "
                  f"points (ecc_src=trace) --")
            print(format_table(w, trows))
            print()
    if args.dry_run:
        print("EXPLORE DRY-RUN OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
