"""95th percentile of time to first token (first token minus due time,
serving clock) over every request due in the window. A per-layer reading
of the traced run: the tail is set by queueing behind bursts, in whole
iterations, and swings too far from run to run to bound end to end."""
from hrmbench import readers


def read(rec):
    return readers.percentile(rec.get("ttft_ms", []), 95)
