"""Mean ms of a patrol scrub of the parameters, reloads included."""
from hrmbench import readers


def read(rec):
    return readers.span_mean(rec, "params_scrub")
