"""Model FLOPs of the prefills (decompressed) and decode steps (latent
form) in the traced stretch over its length and the bf16 peak."""
from hrmbench import readers


def read(rec):
    return readers.mfu(rec)
