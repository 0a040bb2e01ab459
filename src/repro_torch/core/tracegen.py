"""Synthetic field-shaped error-trace generator.

Counterpart of ``repro.core.tracegen``: the same numpy stream, so the same
config and seed give the same arrays in both packages.

Calibrated to the *shape* of the DRAM field studies behind this repo's
error rates (Meza+15; the datacenter-scale study of arXiv:1901.03401) —
not to any one fleet's absolute numbers. Four properties of recorded
error streams that iid sampling misses, and how each is realized here
(constants and provenance: docs/DESIGN.md §8.3, "trace provenance"):

  temporal bursts     inter-arrival times are log-normal
                      (``arrival_sigma`` = 1.8: most gaps tiny, a heavy
                      tail of quiet spells), not exponential
  repeat offenders    each DIMM owns a small pool of faulty addresses
                      (``faults_per_dimm``); every *hard* event re-strikes
                      one of them, so a handful of rows produce most
                      events — the studies' "a small number of DIMMs/rows
                      dominate" finding
  spatial bursts      multi-bit events strike *adjacent* bits of one word
                      with widths 2..4 (``burst_widths``), the
                      wordline/bitline failure mode
  DIMM skew           per-DIMM incidence follows a Zipf law
                      (``dimm_skew``), shuffled per seed so the hot DIMM
                      isn't always id 0

The generated ``ErrorTrace`` is the replay input for campaigns
(``characterize.run_trace_campaign``) and the availability model
(``availability.replay_availability``, ``launch.explore --trace``). CLI::

    PYTHONPATH=src python -m repro_torch.core.tracegen --out trace.npz \\
        --events 540 --dimms 8 --days 30 --seed 0
"""
from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.errormodel import (DEFAULT_ADJACENT_FRACTION,
                                         DEFAULT_MULTI_BIT_FRACTION)
from repro_torch.core.trace import (DEFAULT_DIMM_BYTES, SECONDS_PER_MONTH,
                                    ErrorTrace)

# field-study-shaped defaults (provenance: docs/DESIGN.md §8.3)
ARRIVAL_SIGMA = 1.8            # log-normal inter-arrival shape
DIMM_SKEW = 1.3                # Zipf exponent of per-DIMM incidence
FAULTS_PER_DIMM = 3            # repeat-offender address pool per DIMM
HARD_FRACTION = 0.4            # sticky share, same split as ErrorModel
# adjacent-burst width distribution among multi-bit events: mostly
# double-bit, a tail of wider wordline bursts
BURST_WIDTHS: Tuple[int, ...] = (2, 3, 4)
BURST_WIDTH_P: Tuple[float, ...] = (0.80, 0.15, 0.05)


@dataclass(frozen=True)
class TraceGenConfig:
    n_events: int = 540                       # one server-month budget
    duration_s: float = SECONDS_PER_MONTH
    n_dimms: int = 8
    dimm_bytes: int = DEFAULT_DIMM_BYTES
    hard_fraction: float = HARD_FRACTION
    multi_bit_fraction: float = DEFAULT_MULTI_BIT_FRACTION
    adjacent_fraction: float = DEFAULT_ADJACENT_FRACTION
    arrival_sigma: float = ARRIVAL_SIGMA
    dimm_skew: float = DIMM_SKEW
    faults_per_dimm: int = FAULTS_PER_DIMM


def _dimm_weights(rng: np.random.Generator, n: int, skew: float
                  ) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** skew
    rng.shuffle(w)
    return w / w.sum()


def generate_error_trace(cfg: TraceGenConfig = TraceGenConfig(), *,
                         seed: int = 0) -> ErrorTrace:
    """Synthesize one field-shaped error stream (deterministic per seed)."""
    rng = np.random.default_rng(seed)
    n = cfg.n_events
    if n <= 0:
        return ErrorTrace(np.zeros(0), np.zeros(0, np.int32),
                          np.zeros(0, np.int64), np.zeros(0, np.int8),
                          np.ones(0, np.int8), np.zeros(0, np.bool_),
                          dimm_bytes=cfg.dimm_bytes,
                          duration_s=cfg.duration_s,
                          meta={"generator": asdict(cfg), "seed": seed})

    # temporal: log-normal gaps normalized onto the recording window
    gaps = rng.lognormal(mean=0.0, sigma=cfg.arrival_sigma, size=n)
    t = np.cumsum(gaps)
    t = t * (cfg.duration_s / t[-1])

    # spatial: Zipf-skewed DIMM incidence
    weights = _dimm_weights(rng, cfg.n_dimms, cfg.dimm_skew)
    dimm = rng.choice(cfg.n_dimms, size=n, p=weights).astype(np.int32)

    # hard events re-strike a per-DIMM repeat-offender pool; soft events
    # land uniformly (word-aligned: a strike hits one 64-bit word)
    n_words = cfg.dimm_bytes // 8
    pools = rng.integers(0, n_words,
                         size=(cfg.n_dimms, cfg.faults_per_dimm)) * 8
    hard = rng.random(n) < cfg.hard_fraction
    addr = rng.integers(0, n_words, size=n) * 8
    pool_pick = rng.integers(0, cfg.faults_per_dimm, size=n)
    addr = np.where(hard, pools[dimm, pool_pick], addr).astype(np.int64)

    # burst widths: multi-bit events are adjacent wordline bursts
    multi = rng.random(n) < cfg.multi_bit_fraction
    widths = rng.choice(BURST_WIDTHS, size=n,
                        p=np.asarray(BURST_WIDTH_P)).astype(np.int8)
    burst = np.where(multi, widths, np.int8(1)).astype(np.int8)
    bit = rng.integers(0, 64, size=n).astype(np.int8)
    bit = np.minimum(bit, 64 - burst.astype(np.int16)).astype(np.int8)

    return ErrorTrace(t, dimm, addr, bit, burst, hard,
                      dimm_bytes=cfg.dimm_bytes, duration_s=cfg.duration_s,
                      meta={"generator": asdict(cfg), "seed": seed})


# ------------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Generate a field-shaped synthetic error trace.")
    ap.add_argument("--out", default="trace.npz")
    ap.add_argument("--events", type=int, default=540,
                    help="incident error events (540 = one server-month)")
    ap.add_argument("--days", type=float, default=30.0,
                    help="recording span in days")
    ap.add_argument("--dimms", type=int, default=8)
    ap.add_argument("--hard-fraction", type=float, default=HARD_FRACTION)
    ap.add_argument("--multi-bit-fraction", type=float,
                    default=DEFAULT_MULTI_BIT_FRACTION)
    ap.add_argument("--dimm-skew", type=float, default=DIMM_SKEW)
    ap.add_argument("--arrival-sigma", type=float, default=ARRIVAL_SIGMA)
    ap.add_argument("--faults-per-dimm", type=int, default=FAULTS_PER_DIMM)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = TraceGenConfig(
        n_events=args.events, duration_s=args.days * 86400.0,
        n_dimms=args.dimms, hard_fraction=args.hard_fraction,
        multi_bit_fraction=args.multi_bit_fraction,
        dimm_skew=args.dimm_skew, arrival_sigma=args.arrival_sigma,
        faults_per_dimm=args.faults_per_dimm)
    trace = generate_error_trace(cfg, seed=args.seed)
    trace.save(args.out)
    print(trace.summary())
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
