"""Fault-tolerant training loop with HRM as a first-class feature.

Counterpart of ``repro.runtime.train_loop``. The loop owns one
``MemoryDomain`` protecting the configured roots of the train state
(``params`` by default; add ``"opt"`` to ``protect_roots`` to cover the
optimizer moments too). Per step, in the reference's order:

  1. (fault sim) soft/hard errors strike protected and unprotected leaves
     (``domain.inject``, byte-weighted), drawn from the reference's numpy
     stream ``np.random.default_rng(loop.seed + 2)``, so both packages
     strike the same words from the same seed;
  2. every ``policy.scrub_interval`` steps: patrol scrub (one tier-batched
     kernel pass, ``domain.scrub``) corrects (SEC-DED) and detects
     (parity), and ``domain.recover`` reloads clean copies from the
     checkpoint or raises restart; recurring hard errors escalate to block
     retirement, which clears sticky cells;
  3. the train step;
  4. write-path ECC: ``domain.refresh`` re-encodes the sidecars of the
     updated roots in one batched encode per tier; sticky cells re-assert;
  5. checkpoint every ``ckpt_interval`` steps (the state copied to host
     memory, then written by a thread while the next steps compute);
  6. straggler detection: steps slower than ``straggler_factor`` x the
     median are logged.

Node failures are simulated as ``RestartRequired`` at given steps: the loop
restores the last checkpoint and replays. Where the reference builds a
fresh ``init_train_state`` as the restore template, the port restores into
the structure of the state it holds. Everything runs on ``device``, the
card unless the caller passes another.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import (HRMPolicy, MemoryDomain, Response,
                              RestartRequired, RetirementMap, tree)
from repro_torch.runtime.steps import init_train_state, make_train_step


@dataclass
class LoopConfig:
    steps: int = 100
    ckpt_interval: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    seed: int = 0
    # fault simulation
    error_rate_per_step: float = 0.0        # expected injected errors/step
    hard_error_fraction: float = 0.3
    node_failure_steps: tuple = ()          # steps at which a "node" dies
    # straggler mitigation
    straggler_factor: float = 3.0
    # HRM
    policy: Optional[HRMPolicy] = None
    response: Response = Response.RELOAD_CLEAN_COPY
    protect_roots: Tuple[str, ...] = ("params",)


@dataclass
class LoopReport:
    losses: List[float] = field(default_factory=list)
    scrub_corrected: int = 0
    scrub_detected: int = 0
    recoveries: int = 0
    restarts: int = 0
    straggler_events: int = 0
    injected: int = 0
    events: List[dict] = field(default_factory=list)
    domain_stats: Optional[dict] = None


def _sub(state, roots) -> Dict[str, Any]:
    return {r: state[r] for r in roots}


def run_training(cfg: ModelConfig, tcfg: TrainConfig, loop: LoopConfig,
                 batch_stream, *, state=None, device=None) -> LoopReport:
    """Train ``loop.steps`` steps on ``batch_stream``'s batches, from
    ``state`` (moved to ``device``) or, without one, from the newest
    checkpoint in ``loop.ckpt_dir`` or ``init_train_state(loop.seed)``."""
    dev = resolve_device(device)
    report = LoopReport()
    store = CheckpointStore(loop.ckpt_dir, device=dev)
    train_step = make_train_step(cfg, tcfg)

    if state is None:
        latest = store.latest_step()
        template = init_train_state(loop.seed, cfg, tcfg, device=dev)
        if latest is not None:
            state = store.load(latest, template)
            start_step = latest
            report.events.append({"restore": latest})
        else:
            state = template
            start_step = 0
            store.save(0, state)
    else:
        state = tree.map_leaves(lambda t: t.to(dev), state)
        start_step = 0
        store.save(0, state)

    policy = loop.policy
    roots = tuple(r for r in loop.protect_roots if r in state)
    # with no policy the domain still carries the leaf table + hard-error
    # map for fault simulation; no sidecar is materialized
    domain = MemoryDomain.protect(
        _sub(state, roots),
        policy if policy is not None else HRMPolicy("unprotected", {}))
    strikes: Dict[str, int] = {}
    retirement = RetirementMap()
    clean_copy = store.clean_copy_fn() if policy is not None else None
    rng = np.random.default_rng(loop.seed + 2)

    def sync(st, dom):
        return {**st, **{r: dom.root(r) for r in roots}}

    step_times: List[float] = []
    step = start_step
    pending_ckpt = None
    fired_failures = set()
    while step < loop.steps:
        t0 = time.time()
        try:
            # ---- 1. fault simulation strikes tensor memory
            if loop.error_rate_per_step > 0:
                n_err = rng.poisson(loop.error_rate_per_step)
                for _ in range(n_err):
                    hard = rng.random() < loop.hard_error_fraction
                    domain, ev = domain.inject(rng, 1, hard=hard)
                    report.injected += len(ev)
                if n_err:
                    state = sync(state, domain)

            # ---- 2. patrol scrub + recovery
            if policy is not None:
                domain, rep = domain.scrub(step)
                if rep is not None:
                    state = sync(state, domain)
                    c, u = rep.totals()
                    report.scrub_corrected += c
                    report.scrub_detected += u
                    if u:
                        needs = rep.needs_recovery()
                        domain, events = domain.recover(
                            rep, clean_copy=clean_copy,
                            response=loop.response, strikes=strikes,
                            retirement=retirement, needs=needs)
                        report.recoveries += len(needs)
                        report.events.extend(events)
                        state = sync(state, domain)

            # ---- simulated node failure (each failure fires once)
            if step in loop.node_failure_steps and \
                    step not in fired_failures:
                fired_failures.add(step)
                raise RestartRequired(f"node failure at step {step}")

            # ---- 3. the actual training step
            batch = next(batch_stream)
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            report.losses.append(loss)

            # ---- 4. write-path ECC for the updated roots, then sticky
            #         (hard) errors re-assert on the fresh state
            domain = domain.refresh(_sub(state, roots)).reassert_hard()
            state = sync(state, domain)

            # ---- 5. checkpoint (async)
            if step > 0 and step % loop.ckpt_interval == 0:
                if pending_ckpt is not None:
                    pending_ckpt.join()
                pending_ckpt = store.save_async(step, state)
                if policy is not None:
                    clean_copy = store.clean_copy_fn(step=None)

            # ---- 6. straggler detection
            dt = time.time() - t0
            if len(step_times) >= 5:
                med = float(np.median(step_times[-20:]))
                if dt > loop.straggler_factor * med:
                    report.straggler_events += 1
                    report.events.append({"straggler": step, "dt": dt,
                                          "median": med})
            step_times.append(dt)
            step += 1

        except RestartRequired as e:
            report.restarts += 1
            report.events.append({"restart_at": step, "why": str(e)})
            if pending_ckpt is not None:
                pending_ckpt.join()
                pending_ckpt = None
            latest = store.latest_step()
            state = store.load(latest, state)
            domain = domain.clear_hard().refresh(_sub(state, roots))
            step = latest

    if pending_ckpt is not None:
        pending_ckpt.join()
    st = domain.stats()
    report.domain_stats = {
        "payload_bytes": st.payload_bytes,
        "sidecar_bytes": st.sidecar_bytes,
        "overhead": st.overhead,
        "protected_leaves": st.n_protected,
        "live_hard_errors": st.n_hard_errors,
    }
    return report
