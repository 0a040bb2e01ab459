"""Arithmetic shared by the metric readers in ``metrics/``: each reads a
run's record and returns a number, or None when the record holds nothing
to read (the harness then leaves the metric out)."""
from __future__ import annotations

from statistics import fmean
from typing import Optional

import numpy as np

from hrmbench import flops


def percentile(xs, p: float) -> Optional[float]:
    """The port's ``serve/metrics.py::percentile`` (numpy's linear
    interpolation), None for no values."""
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), p))


def mean(xs) -> Optional[float]:
    return fmean(xs) if len(xs) else None


def span_mean(rec: dict, name: str) -> Optional[float]:
    spans = rec.get("spans")
    return mean(spans[name]) if spans else None


def prefill_ms_per_ktok(rec: dict) -> Optional[float]:
    spans = rec.get("spans")
    if not spans or not spans["prefill"]:
        return None
    toks = sum(n for n, _ in spans["prefill"])
    return sum(ms for _, ms in spans["prefill"]) / toks * 1e3


def idle_share(rec: dict) -> Optional[float]:
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return (1 - prof["busy_s"] / prof["window_s"]) * 100


def mfu(rec: dict) -> Optional[float]:
    """Model FLOPs of the traced stretch over its length and the card's
    bf16 peak, in %."""
    prof = rec.get("profile")
    pk = flops.peak(rec.get("device_kind", ""), "bf16_flops_per_s")
    if not prof or not pk or prof["flops"] <= 0:
        return None
    return prof["flops"] / prof["window_s"] / pk * 100


def kernel_roofline(rec: dict, kernel: str, cuda_name: str
                    ) -> Optional[float]:
    """The bytes ``kernel`` must move in the traced stretch, over the
    card's HBM bandwidth, over its device time there, in %."""
    prof = rec.get("profile")
    bw = flops.peak(rec.get("device_kind", ""), "hbm_bytes_per_s")
    if not prof or not bw:
        return None
    secs = sum(s for name, (s, _) in prof["kernels"].items()
               if cuda_name in name)
    rows = prof["rows"].get(kernel, 0)
    if secs <= 0 or rows <= 0:
        return None
    return rows * flops.KERNEL_BYTES_PER_ROW[kernel] / bw / secs * 100
