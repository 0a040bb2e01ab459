"""Device-synchronised ms of the strikes (MemoryDomain.apply_plan, pack
copy and bit flip) per trial."""


def read(rec):
    return rec.get("strike_ms_per_trial")
