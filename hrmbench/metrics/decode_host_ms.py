"""Mean host ms of a paged decode step before it waits for the device: the
program's spans ``decode.inputs`` and ``decode.dispatch`` (the latter
holds the layers' spans, which enqueue the step), whole. None where the
program records no spans."""


def read(rec):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.summary()["spans"]
    if "decode.inputs" not in spans or "decode.dispatch" not in spans:
        return None
    ms = sum(spans[k]["total_ms"] / spans[k]["count"]
             for k in ("decode.inputs", "decode.dispatch"))
    return ms or None
