"""Mean device-synchronised ms of one LM query (forward, greedy tokens,
finiteness)."""
from hrmbench import readers


def read(rec):
    return readers.mean(rec.get("query_ms", []))
