"""Mean ms an iteration of the latent KV pool's access-path check plus its
write-path refresh."""
from hrmbench import readers


def read(rec):
    k = readers.span_mean(rec, "kv_check")
    r = readers.span_mean(rec, "kv_refresh")
    return None if k is None or r is None else k + r
