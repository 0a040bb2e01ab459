"""Mean wait of a request before its prefill starts: admitted minus due,
less its own prefill."""
from hrmbench import readers


def read(rec):
    return readers.mean(rec.get("queue_wait_ms", []))
