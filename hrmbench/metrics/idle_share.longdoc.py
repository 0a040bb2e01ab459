"""Share of the traced stretch in which no operation ran on the device."""
from hrmbench import readers


def read(rec):
    return readers.idle_share(rec)
