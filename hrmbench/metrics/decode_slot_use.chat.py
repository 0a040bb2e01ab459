"""Share of the decode batch's slots that hold a request, over the decode
steps: the program's counters ``slots_active`` over ``slots``. None
where the program records no spans."""


def read(rec):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    c = telemetry.summary()["counters"]
    if not c.get("slots"):
        return None
    return c.get("slots_active", 0) / c["slots"] * 100 or None
