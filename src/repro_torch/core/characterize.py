"""The error-emulation campaign (Fig. 2): golden run -> inject -> execute ->
classify per the Fig. 1 taxonomy -> repeat.

Counterpart of ``repro.core.characterize``. ``run_campaign`` is
application-agnostic: it takes an ``eval_fn`` mapping a state to output
token ids (any *non-negative* integer tensor, the "query response";
negative entries are the crash marker), a state, and a region filter, and
returns per-region ``OutcomeStats``. It draws the reference's numpy
stream: the struck leaf by ``rng.choice`` over byte weights, then
``InjectionPlan.sample``, so both packages strike the same ``(path,
plan)`` sequence from the same seed.

Classification:
  CRASH            eval raised, or produced non-finite / out-of-range output
                   (negative token ids: ``lm_eval_fn`` and the graph
                   eval_fns emit -1 when the query goes non-finite)
  INCORRECT        any output token differs from the golden response
  MASKED_OVERWRITE output identical AND the program overwrote the corrupted
                   value (final leaf == clean leaf)
  MASKED_LOGIC     output identical, corrupted value still resident

Outputs and leaves are compared where they lie: the golden response stays
on the device, and a trial reads its verdicts back once, however many
queries it makes. The query must be deterministic: a clean re-run has to
give the golden tokens bit for bit, or masked errors count as incorrect.

Only the errors a query can raise from corrupted data count as a crash.
Errors of the kernels (``KernelError``), the CUDA runtime or the device's
memory are faults of the program or the machine: they propagate, since a
sticky CUDA error would otherwise turn every later trial into a "crash".

``run_trace_campaign`` is the same loop driven by a recorded error stream
(``core.trace``): one trial per trace event, in arrival order.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import tree
from repro_torch.core.domain import LeafSpec, MemoryDomain
from repro_torch.core.errormodel import InjectionPlan
from repro_torch.core.policy import HRMPolicy
from repro_torch.core.taxonomy import Outcome, OutcomeStats
from repro_torch.core.trace import ErrorTrace, TraceReplayer
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.ops import LANES
from repro_torch.models.query_graph import QueryGraph


@dataclass
class CampaignResult:
    """per (region, error_kind) outcome statistics, and each trial's
    ``(leaf path, error kind, outcome)`` in trial order."""
    stats: Dict[Tuple[str, str], OutcomeStats] = field(default_factory=dict)
    trials: List[Tuple[str, str, Outcome]] = field(default_factory=list)

    def stat(self, region: str, kind: str) -> OutcomeStats:
        key = (region, kind)
        if key not in self.stats:
            self.stats[key] = OutcomeStats.zero()
        return self.stats[key]

    def _pooled(self, region: Optional[str], kind: Optional[str]
                ) -> OutcomeStats:
        agg = OutcomeStats.zero()
        for (r, k), s in self.stats.items():
            if (region is None or r == region) and (kind is None or k == kind):
                for o, n in s.counts.items():
                    agg.add(o, n)
        return agg

    def crash_prob(self, region: str = None, kind: str = None) -> float:
        return self._pooled(region, kind).crash_prob

    def incorrect_prob(self, region: str = None, kind: str = None) -> float:
        return self._pooled(region, kind).incorrect_prob

    def regions(self) -> List[str]:
        return sorted({r for r, _ in self.stats})


_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", KernelError)
_RUNTIME_MESSAGE = re.compile(r"cuda|cublas|cudnn", re.IGNORECASE)


def _program_fault(e: BaseException) -> bool:
    """An error of the kernels, the CUDA runtime or the device, which no
    corrupted value may be blamed for."""
    return isinstance(e, (KernelError, torch.OutOfMemoryError,
                          _ACCELERATOR_ERROR)) \
        or bool(_RUNTIME_MESSAGE.search(str(e)))


def _verdict(golden_out: torch.Tensor, out, clean_leaf: torch.Tensor,
             final_leaf: torch.Tensor) -> torch.Tensor:
    """(3,) bool on the device: the output is out of range (non-finite, or
    a negative id: the crash marker); it equals the golden output; the
    final leaf equals the clean leaf (by value, as ``np.array_equal``)."""
    out = torch.as_tensor(out, device=golden_out.device)
    bad = ~torch.isfinite(out).all() | (out < 0).any()
    no = bad.new_zeros(())
    same_out = (out == golden_out).all() \
        if out.shape == golden_out.shape else no
    same_leaf = (final_leaf == clean_leaf).all() \
        if final_leaf.shape == clean_leaf.shape else no
    return torch.stack([bad, same_out, same_leaf])


def _outcome(bad: bool, same_out: bool, same_leaf: bool) -> Outcome:
    if bad:
        return Outcome.CRASH
    if not same_out:
        return Outcome.INCORRECT
    if same_leaf:
        return Outcome.MASKED_OVERWRITE
    return Outcome.MASKED_LOGIC


def classify_trial(golden_out: torch.Tensor, out, clean_leaf, final_leaf,
                   crashed: bool) -> Outcome:
    if crashed:
        return Outcome.CRASH
    _, same_out, same_leaf = _verdict(golden_out, out, clean_leaf,
                                      final_leaf).tolist()
    return _outcome(False, same_out, same_leaf)


_OUTCOME_ORDER = [Outcome.MASKED_OVERWRITE, Outcome.MASKED_LOGIC,
                  Outcome.INCORRECT, Outcome.CRASH]


def _campaign_domain(state, root: str):
    """The (domain, wrapped, unwrap) triple of the campaign loop."""
    if isinstance(state, MemoryDomain):
        return state, False, (lambda p: p)
    wrapped = root != "params"
    domain = MemoryDomain.protect(
        {root: state} if wrapped else state,
        HRMPolicy(f"campaign/{root}", {}))
    unwrap = (lambda p: p[root]) if wrapped else (lambda p: p)
    return domain, wrapped, unwrap


def _campaign_strikes(domain: MemoryDomain, *, n_trials: int,
                      errors_per_trial: int, seed: int,
                      kinds: Tuple[str, ...],
                      region_filter: Optional[Callable[[str], bool]]
                      ) -> Iterator[Tuple[str, LeafSpec, InjectionPlan]]:
    """The campaign's ``(kind, leaf, plan)`` sequence: the reference's
    draws, in its order."""
    rng = np.random.default_rng(seed)
    specs = [s for s in domain.spec.protectable
             if region_filter is None or region_filter(s.region)]
    # sample leaves weighted by byte size (errors strike uniformly over bytes)
    weights = np.array([s.nbytes for s in specs], dtype=np.float64)
    weights = weights / weights.sum()
    for kind in kinds:
        hard = kind == "hard"
        for _ in range(n_trials):
            s = specs[rng.choice(len(specs), p=weights)]
            # unified strike mix: DEFAULT_MULTI_BIT_FRACTION of events add
            # a second flip (half adjacent), the campaign mix of the
            # reference
            plan = InjectionPlan.sample(rng, s.rows * LANES,
                                        errors_per_trial, hard)
            yield kind, s, plan


def _run_trial(domain: MemoryDomain, s: LeafSpec, plan: InjectionPlan,
               eval_fn: Callable, golden_out: torch.Tensor,
               unwrap: Callable, wrapped: bool, root: str, hard: bool,
               hard_repeat: int) -> Outcome:
    """One Fig.2 trial: corrupt a clean domain with ``plan``, evaluate
    (``hard_repeat`` consecutive queries for sticky errors, each followed
    by re-applying the plan to the state the query left; worst outcome
    wins), classify per the Fig.1 taxonomy."""
    with telemetry.span("campaign.trial", path=s.path,
                        kind="hard" if hard else "soft"):
        clean_leaf = domain.leaf(s.path)
        with telemetry.span("campaign.strike"):
            corrupted = domain.apply_plan(s.path, plan)   # outside the try
        verdicts = []
        reps = hard_repeat if hard else 1
        for r in range(reps):
            final_state = unwrap(corrupted.payload)
            try:
                out, final_state = eval_fn(final_state)
                final_leaf = tree.leaves(final_state)[s.pos] \
                    if final_state is not None else clean_leaf
                verdicts.append(_verdict(golden_out, out, clean_leaf,
                                         final_leaf))
            except (FloatingPointError, ZeroDivisionError, ValueError,
                    RuntimeError) as e:
                if _program_fault(e):
                    raise
                verdicts.append(golden_out.new_ones(3, dtype=torch.bool))
            if hard and r + 1 < reps:
                with telemetry.span("campaign.strike"):
                    corrupted = domain.adopt(
                        {root: final_state} if wrapped else final_state
                    ).apply_plan(s.path, plan)
        with telemetry.span("campaign.verdict"):
            rows = torch.stack(verdicts).tolist()   # the trial's one sync
    return max((_outcome(*row) for row in rows), key=_OUTCOME_ORDER.index)


def run_campaign(eval_fn: Callable, state, *, n_trials: int = 50,
                 errors_per_trial: int = 1, seed: int = 0,
                 kinds: Tuple[str, ...] = ("soft", "hard"),
                 hard_repeat: int = 3,
                 region_filter: Optional[Callable[[str], bool]] = None,
                 root: str = "params") -> CampaignResult:
    """Run the Fig.2 loop. ``eval_fn(state) -> (token_ids, final_state)``.

    ``final_state`` lets mutable-region experiments (caches) report the
    post-run leaf so overwrite-masking is detectable; for read-only params
    eval_fn may return the input state.

    Hard errors are re-asserted ``hard_repeat`` times (re-applied after each
    of ``hard_repeat`` consecutive queries): a sticky cell keeps biting.

    ``state`` may be a plain nested dict or a live ``MemoryDomain`` (its
    payload is characterized; ``root`` is ignored in that case since the
    domain already classified every leaf).
    """
    domain, wrapped, unwrap = _campaign_domain(state, root)
    golden_out = torch.as_tensor(eval_fn(unwrap(domain.payload))[0])
    result = CampaignResult()
    for kind, s, plan in _campaign_strikes(
            domain, n_trials=n_trials, errors_per_trial=errors_per_trial,
            seed=seed, kinds=kinds, region_filter=region_filter):
        outcome = _run_trial(domain, s, plan, eval_fn, golden_out, unwrap,
                             wrapped, root, kind == "hard", hard_repeat)
        result.stat(s.region, kind).add(outcome)
        result.trials.append((s.path, kind, outcome))
    return result


def run_trace_campaign(eval_fn: Callable, state, trace: ErrorTrace, *,
                       hard_repeat: int = 3,
                       region_filter: Optional[Callable[[str], bool]] = None,
                       root: str = "params",
                       max_events: Optional[int] = None) -> CampaignResult:
    """The Fig.2 campaign driven by a recorded error stream instead of iid
    sampling: one trial per trace event, in arrival order.

    The trace decides *where* each trial strikes (its (dimm, addr) mapped
    onto the domain's leaves: repeat-offender hard faults land on the same
    word every time), *how wide* (recorded adjacent-burst widths), and
    *which kind* (the trace's hard flag selects the sticky ``hard_repeat``
    protocol). Replay is bit-deterministic: the same trace on the same
    state classifies the same outcomes in every run.
    """
    domain, wrapped, unwrap = _campaign_domain(state, root)
    golden_out = torch.as_tensor(eval_fn(unwrap(domain.payload))[0])
    result = CampaignResult()
    strikes = TraceReplayer(trace, domain).strikes
    if max_events is not None:
        strikes = strikes[:max_events]
    for strike in strikes:
        s = domain.spec.by_path[strike.path]
        if region_filter is not None and not region_filter(s.region):
            continue
        kind = "hard" if strike.hard else "soft"
        outcome = _run_trial(domain, s, strike.plan(), eval_fn, golden_out,
                             unwrap, wrapped, root, strike.hard,
                             hard_repeat)
        result.stat(s.region, kind).add(outcome)
        result.trials.append((s.path, kind, outcome))
    return result


def lm_eval_fn(cfg, batch, forward):
    """Standard LM 'query': greedy tokens of a forward pass, or the -1
    crash marker everywhere when a logit is not finite (tested in the
    logits' own dtype: no float32 copy of the vocab-wide tensor). The
    query owns a ``QueryGraph``, ambient while it calls ``forward``: on
    the card the port's forward then replays one captured CUDA graph from
    the query's third run on (``models/query_graph.py``)."""
    graph = QueryGraph()

    def eval_fn(params):
        with telemetry.span("campaign.query"):     # enqueued, not waited on
            with graph.engaged():
                logits, _, _ = forward(params, batch, cfg)
            toks = torch.argmax(logits, dim=-1)
            return torch.where(torch.isfinite(logits).all(), toks, -1), params
    return eval_fn
