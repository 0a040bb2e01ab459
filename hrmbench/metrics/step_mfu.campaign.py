"""Model FLOPs of the queries in the traced stretch over its length and the
bf16 peak."""
from hrmbench import readers


def read(rec):
    return readers.mfu(rec)
