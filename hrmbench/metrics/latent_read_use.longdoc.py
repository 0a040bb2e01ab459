"""Share of the latent positions a decode step gathers that a slot
attends: the program's counters ``mla_positions_attended`` (Σ pos + 1
over the slots a request holds) over ``mla_positions_gathered`` (every
slot's every page), summed over the decode steps, in %. None where the
program records no such counter."""


def read(rec):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    c = telemetry.summary()["counters"]
    if not c.get("mla_positions_gathered"):
        return None
    return c.get("mla_positions_attended", 0) \
        / c["mla_positions_gathered"] * 100 or None
