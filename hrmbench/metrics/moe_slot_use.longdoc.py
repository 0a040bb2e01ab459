"""Share of the expert slots the MoE dispatch computes that a routed token
fills, over the prefills and decode steps: the program's counters
``moe_routed`` (tokens x top-k) over ``moe_slots`` (experts x capacity).
None where the program records no spans."""


def read(rec):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    c = telemetry.summary()["counters"]
    if not c.get("moe_slots"):
        return None
    return c.get("moe_routed", 0) / c["moe_slots"] * 100 or None
