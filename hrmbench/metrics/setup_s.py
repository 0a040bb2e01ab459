"""Seconds from the process start to the first timed instant: imports, the
card, the kernel library, the weights, protection and the warm-up."""


def read(rec):
    return rec.get("setup_s")
