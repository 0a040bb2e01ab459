"""Mean ms an iteration of the KV pools' access-path check plus their
write-path refresh."""
from hrmbench import readers


def read(rec):
    k = readers.span_mean(rec, "kv_check")
    r = readers.span_mean(rec, "kv_refresh")
    return None if k is None or r is None else k + r
