"""Device-synchronised prefill ms over the prompt kilotokens prefilled
(decompressed latent attention, 4k-16k prompts)."""
from hrmbench import readers


def read(rec):
    return readers.prefill_ms_per_ktok(rec)
