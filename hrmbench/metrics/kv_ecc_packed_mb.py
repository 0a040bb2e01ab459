"""MB (10^6 bytes) the KV pools' access-path check and write-path refresh
stage into packed rows in an iteration: the program's counter
``packed_bytes`` under ``engine.kv_check`` and under
``engine.kv_refresh``, each per span, summed (an iteration runs one of
each). None where the program records no spans."""


def read(rec):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.summary()["spans"]
    total = 0.0
    for k in ("engine.kv_check", "engine.kv_refresh"):
        if k not in spans:
            return None
        total += spans[k]["counters"].get("packed_bytes", 0) \
            / spans[k]["count"]
    return total / 1e6 or None
