"""Mean device-synchronised wall ms of a latent paged decode step over
every slot."""
from hrmbench import readers


def read(rec):
    return readers.span_mean(rec, "decode")
