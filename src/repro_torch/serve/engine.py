"""The online serving engine: continuous batching over a paged,
HRM-protected KV cache, driven by a timestamped request trace while an
error storm fires live.

Counterpart of ``repro.serve.engine``. Two memory domains, mirroring the
paper's region split:

  params    the model weights: long-lived, crash-vulnerable, protected
            by any of the design-point policies (patrol-scrubbed on the
            policy cadence; Par+R detections reload from a clean copy
            and charge ``RECOVERY_SECONDS`` of measured downtime).
  kv_cache  the paged KV pools: the Fig. 4 largest, most error-tolerant
            region, under a configurable cheap tier. Unlike params, the
            pools are written every step, so ECC is emulated the way the
            hardware does it: the sidecar is re-encoded after each step's
            legitimate writes (write-path ECC) and *checked at the start
            of the next step* (access-path ECC). Injected strikes always
            land between a refresh and the next check, so they are
            detected (parity) or corrected (SEC-DED), never laundered.

The reference compiles its decode and prefill into jitted programs; here
they are the model layer's two plain functions on tensors,
``models.transformer.paged_decode_step`` and ``prefill_write``, over the
cache's named pools on the device the parameters lie on; the model
decides what the pools hold (K/V, or an ``MLAConfig``'s latents).
Prefill runs eagerly; the decode step runs through one ``DecodeGraph``,
which replays it as a CUDA graph on the card (``serve/decode_graph.py``).
Both write into the pools in place (the reference donates nothing and
returns new pools): the pools belong to the cache alone. The KV
domain's payload may be the same tensors, and the write-path refresh
re-encodes its sidecar right after; every other holder gets a clone. The
clean parameter copies and the peer's KV image are clones made before any
strike, and ``MemoryDomain.recover`` hands back a reloaded leaf in storage
of its own, so no in-place write reaches them. The clean copies stay on
the parameters' device: a reload is a device copy.

Inactive scheduler slots decode token 0 at position 0 into the null page,
all at the same offset. On CUDA the winner of duplicate scatter indices
is unspecified, so comparisons of pools skip page 0; nothing reads it
unmasked.

Time: the engine advances a virtual clock by a calibrated service model
(``clock="model"``, deterministic: the test path, which reads no wall
time into the report) or by measured wall time per step
(``clock="wall"``; each timed span ends with the host fetching the
step's result, which waits for the device). An error storm compresses one
server-month's error budget into the run; availability is computed from
*measured* recovery/crash events against that month. The storm and the
strikes draw the reference's numpy stream in the reference's order, so
both packages strike the same words from the same seed.

Spans (``repro_torch.telemetry``): each loop pass is an
``engine.iteration``, each HRM verb and step a span inside it, and a
request's wait from the poll that routed it to its admission an
``engine.queued`` interval. A latent decode step counts the positions
its slots attend (``mla_positions_attended``: Σ pos + 1 over the slots
a request holds) and those it gathers (``mla_positions_gathered``: every
slot's every page); a K/V decode step the positions its attention reads
(``attn_positions_read``: on the card Σ pos + 1 over every slot, idle
ones at pos 0 included; on the CPU every slot's every page). They
record only under ``torch.profiler`` or ``telemetry.recording()``, and
never wait for the device.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import HRMPolicy, MemoryDomain, Response, Tier, tree
from repro_torch.core.availability import MINUTES_PER_MONTH
from repro_torch.core.trace import BoundStrike, ErrorTrace, bind_trace
from repro_torch.kernels.paged_attn import positions_read
from repro_torch.models.transformer import paged_decode_step, prefill_write
from repro_torch.serve.decode_graph import DecodeGraph
from repro_torch.serve.metrics import SLOCounters, SLOReport, build_report
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.router import RequestRouter
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.serve.traffic import Request


# =====================================================================
# service-time model (virtual clock)
# =====================================================================
@dataclass(frozen=True)
class ServiceModel:
    """Per-step virtual costs, roughly a small-LLM accelerator: a decode
    step near 10 ms and prefill growing with prompt length."""
    prefill_base: float = 4e-3
    prefill_per_token: float = 5e-5
    decode_base: float = 9e-3
    decode_per_slot: float = 4e-4

    def prefill_cost(self, n_tokens: int) -> float:
        return self.prefill_base + n_tokens * self.prefill_per_token

    def decode_cost(self, n_active: int) -> float:
        return self.decode_base + n_active * self.decode_per_slot


def kv_policy(tier: Tier) -> HRMPolicy:
    """Policy for the KV domain: one region, one (cheap) tier."""
    tiers = {} if tier is Tier.NONE else {"kv_cache": tier}
    return HRMPolicy(f"kv_{tier.value}", tiers, default=Tier.NONE,
                     scrub_interval=1)


# the one step, under the two names the benchmark's fault plants patch
latent_decode_step = paged_decode_step


def _fetch(values: torch.Tensor, ok: torch.Tensor
           ) -> Tuple[np.ndarray, bool]:
    """(values, ok) on the host in one transfer: waits for the device."""
    host = torch.cat([values.reshape(-1),
                      ok.reshape(1).to(values.dtype)]).cpu().numpy()
    return host[:-1], bool(host[-1])


# =====================================================================
# the engine
# =====================================================================
class OnlineEngine:
    def __init__(self, cfg: ModelConfig, params, *,
                 slots: int = 4,
                 page_size: int = 8,
                 max_prompt_len: int = 16,
                 max_new_cap: int = 8,
                 n_pages: Optional[int] = None,
                 policy: Optional[HRMPolicy] = None,
                 kv_tier: Tier = Tier.NONE,
                 scrub_every: Optional[int] = None,
                 clock: str = "model",
                 service: Optional[ServiceModel] = None,
                 max_prefills_per_step: int = 2,
                 max_queue: Optional[int] = None,
                 peer_recovery: bool = False,
                 debug_invariants: bool = False,
                 seed: int = 0):
        self.cfg = cfg
        self.params_policy = policy
        self.kv_tier = kv_tier
        # replicated-engine mode: this engine is one data-parallel replica
        # of a fleet, so detected-uncorrectable errors recover by an
        # in-memory gather from a live replica (Response.PEER_COPY, billed
        # PEER_COPY_SECONDS) instead of the disk reload. The peer's params
        # image is the replica-identical clean copy; the KV pools keep a
        # post-refresh peer snapshot (the replica that didn't take the
        # strike) so flagged pool leaves recover in memory too.
        self.peer_recovery = peer_recovery
        self._kv_peer: Optional[Dict[str, torch.Tensor]] = None
        self.clock_mode = clock
        self.service = service or ServiceModel()
        self.max_prefills_per_step = max_prefills_per_step
        self.max_queue = max_queue
        self.debug_invariants = debug_invariants
        self.rng = np.random.default_rng(seed)

        leaves = tree.leaves(params)
        self.device = leaves[0].device
        max_pages = -(-(max_prompt_len + max_new_cap) // page_size)
        if n_pages is None:
            n_pages = slots * max_pages + 1          # +1: the null page
        self.cache = PagedKVCache(cfg, n_pages=n_pages,
                                  page_size=page_size, slots=slots,
                                  max_pages_per_slot=max_pages,
                                  device=self.device)
        self.sched = ContinuousBatchingScheduler(
            self.cache, max_prefills_per_step=max_prefills_per_step)
        # the decode step, replayed as one CUDA graph on the card
        self._decode = DecodeGraph(latent_decode_step if self.cache.latent
                                   else paged_decode_step)

        # params domain: full protection under the given policy, or a
        # sidecar-free leaf table (injection targeting only) when None
        self.param_domain = MemoryDomain.protect(
            params, policy if policy is not None
            else HRMPolicy("unprotected", {}))
        self._clean = {s.path: leaves[s.pos].clone()
                       for s in self.param_domain.spec.leaves}
        self.scrub_every = (scrub_every if scrub_every is not None
                            else (policy.scrub_interval if policy else 0))

        # KV domain: its own root over the page pools
        self.kv_domain = MemoryDomain.protect(self._kv_state(),
                                              kv_policy(kv_tier))
        self._page_size = page_size

    # ----------------------------------------------------------- helpers
    def _params(self):
        return self.param_domain.payload

    def _kv_state(self) -> dict:
        return {"kv_cache": dict(self.cache.pools)}

    def _advance(self, now: float, model_cost: float, t_wall: float
                 ) -> float:
        return now + (t_wall if self.clock_mode == "wall" else model_cost)

    def _as_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    def describe(self) -> str:
        ps = self.param_domain.stats()
        ks = self.kv_domain.stats()
        pol = self.params_policy.name if self.params_policy else "none"
        return (f"params[{pol}]: {ps.summary()}\n"
                f"kv_cache[{self.kv_tier.value}]: {ks.summary()}\n"
                f"pages={self.cache.n_pages} x {self._page_size} tokens, "
                f"slots={self.cache.slots}, "
                f"max_pages/slot={self.cache.max_pages_per_slot}")

    # ------------------------------------------------------------ prefill
    def _run_prefill(self, req: Request, pages: np.ndarray
                     ) -> Tuple[int, bool, float]:
        with telemetry.span("engine.prefill", rid=req.rid):
            telemetry.count("prefill_tokens", req.prompt_len)
            # only prompt pages are written at prefill; decode fills the
            # rest
            n_pp = -(-req.prompt_len // self._page_size)
            sb = n_pp * self._page_size
            tokens = np.zeros((1, sb), np.int64)
            tokens[0, :req.prompt_len] = req.prompt
            t0 = time.perf_counter()
            with telemetry.span("prefill.dispatch"):
                first, ok = prefill_write(
                    self._params(), self.cache.pools,
                    self._as_device(tokens),
                    req.prompt_len, self._as_device(pages[:n_pp]), self.cfg,
                    self._page_size)
            with telemetry.span("prefill.fetch"):
                first, ok = _fetch(first, ok)
            t_wall = time.perf_counter() - t0
        return int(first[0]), ok, t_wall

    # ------------------------------------------------------------ decode
    def _run_decode(self) -> Tuple[np.ndarray, bool, float]:
        """One decode step: its inputs to the device, the step enqueued,
        then the fetch of its tokens, which waits for the device. Counts
        the slots the step runs over and those a request holds."""
        with telemetry.span("engine.decode"):
            with telemetry.span("decode.inputs"):
                tokens, host_pos = self.sched.batch_inputs()
                t0 = time.perf_counter()
                table = self.cache.device_table()
                tokens, pos = (self._as_device(tokens),
                               self._as_device(host_pos))
            with telemetry.span("decode.dispatch"):
                nxt, ok = self._decode(self._params(), self.cache.pools,
                                       table, tokens, pos, self.cfg,
                                       self._page_size)
            with telemetry.span("decode.fetch"):
                nxt, ok = _fetch(nxt, ok)
            if telemetry.enabled():
                telemetry.count("slots_active", self.sched.n_active)
                telemetry.count("slots", self.cache.slots)
                if self.cache.latent:
                    telemetry.count("mla_positions_attended", sum(
                        s.pos + 1 for s in self.sched.slots
                        if s is not None))
                    telemetry.count("mla_positions_gathered",
                                    int(table.numel()) * self._page_size)
                else:
                    telemetry.count("attn_positions_read", positions_read(
                        table, host_pos, self._page_size))
        return nxt, ok, time.perf_counter() - t0

    # -------------------------------------------------------- fault plane
    def _adopt_kv(self) -> None:
        self.cache.adopt_pools(self.kv_domain.payload["kv_cache"])

    def _inject_one(self, counters: SLOCounters) -> None:
        pb = self.param_domain.stats().payload_bytes
        kb = self.kv_domain.stats().payload_bytes
        if self.rng.random() < pb / max(pb + kb, 1):
            self.param_domain, _ = self.param_domain.inject(self.rng, 1)
            counters.injected_params += 1
        else:
            self.kv_domain, _ = self.kv_domain.inject(self.rng, 1)
            self._adopt_kv()
            counters.injected_kv += 1

    def _inject_bound(self, strike: BoundStrike, counters: SLOCounters
                      ) -> None:
        """Fire one trace-bound strike into its resolved domain/leaf/word
        (the replay twin of ``_inject_one``)."""
        if strike.domain == "params":
            self.param_domain = self.param_domain.apply_plan(
                strike.path, strike.plan(), record_hard=strike.hard)
            counters.injected_params += 1
        else:
            self.kv_domain = self.kv_domain.apply_plan(
                strike.path, strike.plan(), record_hard=strike.hard)
            self._adopt_kv()
            counters.injected_kv += 1

    def _scrub_params(self, counters: SLOCounters) -> None:
        with telemetry.span("engine.params_scrub"):
            self.param_domain, rep = self.param_domain.scrub()
            c, u = rep.totals()
            counters.params_corrected += c
            counters.params_detected += u
            needs = rep.needs_recovery()
            if needs:
                # peer mode: params are data-parallel-replicated, so the
                # in-memory clean copy *is* the peer replica's image: same
                # bits as the disk reload, but billed at the peer-copy MTTR
                resp = (Response.PEER_COPY if self.peer_recovery
                        else Response.RELOAD_CLEAN_COPY)
                self.param_domain, events = self.param_domain.recover(
                    rep, clean_copy=self._clean.__getitem__, response=resp,
                    needs=needs)
                n_peer = sum(1 for e in events
                             if e["action"].startswith("peer_copy"))
                counters.charge_peer_recoveries(n_peer)
                counters.charge_recoveries(len(events) - n_peer)

    def _scrub_kv(self, counters: SLOCounters) -> None:
        """Access-path ECC: check the pools against the sidecar the last
        refresh wrote."""
        with telemetry.span("engine.kv_check"):
            self.kv_domain, rep = self.kv_domain.scrub()
            c, u = rep.totals()
            counters.kv_corrected += c
            counters.kv_detected += u
            changed = bool(c)                # SEC-DED repaired pool words
            needs = rep.needs_recovery()
            if self.peer_recovery and needs and self._kv_peer is not None:
                # the peer snapshot is the post-refresh pool image: the
                # state a replica that didn't take this storm's strikes
                # holds, so the gather restores flagged pool leaves
                # bit-identically without a disk round-trip
                self.kv_domain, events = self.kv_domain.recover(
                    rep, clean_copy=self._kv_peer.__getitem__,
                    response=Response.PEER_COPY, needs=needs)
                counters.charge_peer_recoveries(len(events))
                changed = True
            if changed:
                self._adopt_kv()

    def _refresh_kv(self) -> None:
        """Write-path ECC: re-encode the KV sidecar over this step's
        legitimate writes (or only adopt the pools when untiered)."""
        with telemetry.span("engine.kv_refresh"):
            if self.kv_tier is not Tier.NONE:
                self.kv_domain = self.kv_domain.refresh(self._kv_state())
            else:
                self.kv_domain = self.kv_domain.adopt(self._kv_state())
            if self.peer_recovery:
                # peer image: a replica that doesn't take this storm's
                # strikes holds exactly this post-write pool state; a clone,
                # since the next step writes the pools in place
                self._kv_peer = {f"kv_cache/{name}": pool.clone()
                                 for name, pool in self.cache.pools.items()}

    def _crash_reset(self, router: RequestRouter, counters: SLOCounters
                     ) -> None:
        """Non-finite logits: the server 'crashed'. Charge the MTTR,
        reload params from the clean copy, wipe the KV pools, and requeue
        every in-flight request from scratch."""
        counters.charge_crash()
        spec = self.param_domain.spec
        clean = {s.path for s in spec.leaves}
        payload = tree.unflatten(
            spec.treedef, [self._clean[s.path].clone() for s in spec.leaves])
        pol = (self.params_policy if self.params_policy is not None
               else HRMPolicy("unprotected", {}))
        self.param_domain = MemoryDomain.protect(payload, pol)
        assert clean == {s.path for s in self.param_domain.spec.leaves}
        for req in reversed(self.sched.evict_all()):
            router.requeue(req)
        self.cache.adopt_pools({name: torch.zeros_like(pool) for name, pool
                                in self.cache.pools.items()})
        self.kv_domain = MemoryDomain.protect(self._kv_state(),
                                              kv_policy(self.kv_tier))
        self._kv_peer = None             # stale after the restart

    def _iteration(self, it: int, now: float, router: RequestRouter,
                   counters: SLOCounters, storm: deque,
                   routed: Dict[int, int]) -> float:
        """One pass of ``run``'s loop; returns the clock after it."""
        # 1. access-path KV check: catches strikes injected after the
        #    previous refresh, before any re-encode can launder them
        if self.kv_tier is not Tier.NONE:
            self._scrub_kv(counters)
        # 2. params patrol scrub on the policy cadence
        if (self.params_policy is not None and self.scrub_every > 0
                and it > 0 and it % self.scrub_every == 0):
            self._scrub_params(counters)
        # 3. route arrivals, admit prefills into free slots
        with telemetry.span("engine.admit"):
            now = self._admit(now, router, counters, routed)
        # 4. one continuous-batching decode step over every slot
        if self.sched.n_active:
            nxt, ok, t_wall = self._run_decode()
            counters.decode_steps += 1
            now = self._advance(
                now, self.service.decode_cost(self.sched.n_active), t_wall)
            if ok:
                self.sched.record_step(nxt, now)
            else:
                self._crash_reset(router, counters)
        elif not router.queue:
            nxt_t = router.next_arrival()
            if nxt_t is not None:
                now = max(now, nxt_t)    # idle: jump to next arrival
        # 5. write-path ECC over this step's legitimate writes
        self._refresh_kv()
        # 6. the storm: fire every error due by the current clock
        if storm and storm[0][0] <= now:
            with telemetry.span("engine.strike"):
                while storm and storm[0][0] <= now:
                    _, strike = storm.popleft()
                    if strike is None:
                        self._inject_one(counters)
                    else:
                        self._inject_bound(strike, counters)
        if self.debug_invariants:
            self.cache.check_invariants()
        return now

    def _admit(self, now: float, router: RequestRouter,
               counters: SLOCounters, routed: Dict[int, int]) -> float:
        """Route the arrivals due by ``now`` and prefill up to
        ``max_prefills_per_step`` of the queue into free slots; returns
        the clock after them. While recording, each admitted request's
        wait from the poll that routed it is an ``engine.queued``
        interval."""
        n = router.poll(now)
        if n and telemetry.enabled():
            t = time.perf_counter_ns()
            for req in list(router.queue)[-n:]:
                routed[req.rid] = t
        admitted = 0
        while admitted < self.max_prefills_per_step:
            req = router.peek()
            if req is None:
                break
            if self.cache.pages_needed(req.footprint_tokens()) > \
                    self.cache.max_pages_per_slot:
                router.take()            # can never fit: shed it
                router.shed.append(req)
                continue
            if not self.sched.can_admit(req):
                break
            router.take()
            t_routed = routed.pop(req.rid, None)
            if t_routed is not None:
                telemetry.interval("engine.queued", t_routed,
                                   time.perf_counter_ns(), rid=req.rid)
            slot = self.sched.free_slot()
            pages = self.cache.alloc(slot, req.footprint_tokens())
            first, ok, t_wall = self._run_prefill(req, pages)
            counters.prefills += 1
            now = self._advance(
                now, self.service.prefill_cost(req.prompt_len), t_wall)
            if not ok:
                self.cache.release(slot)
                router.requeue(req)
                self._crash_reset(router, counters)
                break
            self.sched.admit(req, first, now)
            admitted += 1
        return now

    # ---------------------------------------------------------------- run
    def run(self, trace: List[Request], *, storm_errors: int = 0,
            error_trace: Optional[ErrorTrace] = None,
            month_minutes: float = MINUTES_PER_MONTH,
            max_iters: int = 200_000) -> Tuple[SLOReport, Dict[int,
                                                               List[int]]]:
        """Serve the trace to completion. Returns the SLO report and a
        ``{rid: generated tokens}`` map (for golden comparison).

        ``error_trace`` replaces the Poisson storm with a recorded error
        stream: its events are bound onto the params + KV domains (one
        shared physical address space), compressed onto the arrival
        window, and fired deterministically: two runs with the same
        trace produce identical availability/incorrect numbers."""
        router = RequestRouter(trace, max_queue=self.max_queue)
        counters = SLOCounters()
        last_arrival = max((r.arrival for r in trace), default=0.0)
        span = max(last_arrival, 1e-6)
        if error_trace is not None:
            bound = bind_trace(error_trace,
                               {"params": self.param_domain,
                                "kv_cache": self.kv_domain}, span=span)
            storm = deque((s.t, s) for s in bound)
        else:
            storm = deque((t, None) for t in np.sort(
                self.rng.uniform(0.0, span, storm_errors)))
        now = 0.0
        it = 0
        routed: Dict[int, int] = {}     # rid -> ns of the poll that routed it
        while not (router.drained and self.sched.n_active == 0):
            if it >= max_iters:
                raise RuntimeError(f"engine wedged after {max_iters} "
                                   f"iterations")
            with telemetry.span("engine.iteration", it=it):
                now = self._iteration(it, now, router, counters, storm,
                                      routed)
            it += 1
        # drain the storm tail + one final scrub so every injected error
        # is detected/recovered and accounted before availability is read
        while storm:
            _, strike = storm.popleft()
            if strike is None:
                self._inject_one(counters)
            else:
                self._inject_bound(strike, counters)
        if self.kv_tier is not Tier.NONE:
            self._scrub_kv(counters)
        if self.params_policy is not None:
            self._scrub_params(counters)
        report = build_report(
            self.sched.completed, n_requests=len(trace),
            shed=len(router.shed), elapsed=now, counters=counters,
            peak_active=self.sched.peak_active,
            peak_queue=router.peak_queue, month_minutes=month_minutes)
        responses = {c.req.rid: list(c.tokens)
                     for c in self.sched.completed}
        return report, responses
