"""Model FLOPs of the prefills and decode steps in the traced stretch over
its length and the bf16 peak."""
from hrmbench import readers


def read(rec):
    return readers.mfu(rec)
