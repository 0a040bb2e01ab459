"""SLO accounting for the online plane: latency percentiles, measured
availability, and the machine-readable report the benchmark regresses on.

Counterpart of ``repro.serve.metrics``, copied.

Availability follows the paper's Fig. 5 convention, but from *measured*
events instead of model outputs: an error storm compresses one
server-month's error budget into the run, every recovery observed charges
``RECOVERY_SECONDS``, every crash charges ``CRASH_MTTR_MIN``, and
availability is one minus measured downtime over the represented month.
With no storm there are no events and availability is exactly 1.0.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.availability import (
    CRASH_MTTR_MIN, MINUTES_PER_MONTH, PEER_COPY_SECONDS, RECOVERY_SECONDS)


def percentile(xs: Sequence[float], p: float) -> float:
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), p))


@dataclass
class SLOCounters:
    """Mutable tallies the engine bumps while serving."""
    decode_steps: int = 0
    prefills: int = 0
    injected_params: int = 0
    injected_kv: int = 0
    params_corrected: int = 0
    params_detected: int = 0
    kv_corrected: int = 0
    kv_detected: int = 0
    recovery_events: int = 0
    peer_recovery_events: int = 0
    crash_events: int = 0
    downtime_seconds: float = 0.0

    def charge_recoveries(self, n: int) -> None:
        self.recovery_events += n
        self.downtime_seconds += n * RECOVERY_SECONDS

    def charge_peer_recoveries(self, n: int) -> None:
        """In-memory replica gathers (Response.PEER_COPY): billed the
        peer-copy MTTR, NOT the disk-reload RECOVERY_SECONDS."""
        self.peer_recovery_events += n
        self.downtime_seconds += n * PEER_COPY_SECONDS

    def charge_crash(self) -> None:
        self.crash_events += 1
        self.downtime_seconds += CRASH_MTTR_MIN * 60.0


@dataclass
class SLOReport:
    """One run's measured service-level objectives."""
    n_requests: int
    completed: int
    shed: int
    elapsed_s: float
    throughput_rps: float
    tokens_per_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    tpot_p50_s: float
    tpot_p99_s: float
    availability: float
    downtime_min: float
    month_minutes: float
    incorrect_rate: Optional[float] = None
    counters: Dict[str, float] = field(default_factory=dict)
    peak_active: int = 0
    peak_queue: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    def summary(self) -> str:
        inc = ("n/a" if self.incorrect_rate is None
               else f"{self.incorrect_rate:.4%}")
        return (f"requests={self.completed}/{self.n_requests} "
                f"(+{self.shed} shed) "
                f"thr={self.throughput_rps:.2f} req/s "
                f"({self.tokens_per_s:.1f} tok/s) "
                f"ttft p50/p99={self.ttft_p50_s * 1e3:.1f}/"
                f"{self.ttft_p99_s * 1e3:.1f} ms "
                f"tpot p50/p99={self.tpot_p50_s * 1e3:.2f}/"
                f"{self.tpot_p99_s * 1e3:.2f} ms "
                f"avail={self.availability:.4%} incorrect={inc}")


def build_report(completed, *, n_requests: int, shed: int, elapsed: float,
                 counters: SLOCounters, peak_active: int, peak_queue: int,
                 month_minutes: float = MINUTES_PER_MONTH) -> SLOReport:
    """Fold the engine's per-request records + counters into an SLOReport.

    ``completed`` is a list of ``scheduler.CompletedRequest``.
    """
    ttft = [c.t_first_token - c.req.arrival for c in completed]
    tpot = [(c.t_done - c.t_first_token) / (len(c.tokens) - 1)
            for c in completed if len(c.tokens) > 1]
    n_tokens = sum(len(c.tokens) for c in completed)
    elapsed = max(elapsed, 1e-9)
    downtime_min = counters.downtime_seconds / 60.0
    return SLOReport(
        n_requests=n_requests,
        completed=len(completed),
        shed=shed,
        elapsed_s=elapsed,
        throughput_rps=len(completed) / elapsed,
        tokens_per_s=n_tokens / elapsed,
        ttft_p50_s=percentile(ttft, 50),
        ttft_p99_s=percentile(ttft, 99),
        tpot_p50_s=percentile(tpot, 50),
        tpot_p99_s=percentile(tpot, 99),
        availability=1.0 - downtime_min / month_minutes,
        downtime_min=downtime_min,
        month_minutes=month_minutes,
        counters=asdict(counters),
        peak_active=peak_active,
        peak_queue=peak_queue,
    )


def incorrect_rate(golden: Dict[int, List[int]],
                   observed: Dict[int, List[int]]) -> float:
    """Fraction of observed responses differing from the golden run
    (the measured incorrect-response rate under a storm)."""
    if not observed:
        return 0.0
    bad = sum(1 for rid, toks in observed.items()
              if golden.get(rid) != toks)
    return bad / len(observed)
