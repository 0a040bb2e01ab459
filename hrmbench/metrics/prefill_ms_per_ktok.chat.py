"""Device-synchronised prefill ms over the prompt kilotokens prefilled."""
from hrmbench import readers


def read(rec):
    return readers.prefill_ms_per_ktok(rec)
