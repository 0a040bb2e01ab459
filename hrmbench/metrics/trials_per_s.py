"""Classified campaign trials over the wall time of the window."""


def read(rec):
    return rec.get("trials_per_s")
