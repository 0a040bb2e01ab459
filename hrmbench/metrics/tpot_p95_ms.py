"""95th percentile of time per output token ((done - first token) / (tokens
- 1), serving clock) over every request due in the window with two
tokens or more."""
from hrmbench import readers


def read(rec):
    return readers.percentile(rec.get("tpot_ms", []), 95)
