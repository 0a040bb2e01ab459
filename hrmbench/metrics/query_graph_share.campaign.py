"""Share of the campaign's queries that replayed the captured CUDA graph:
the program's counters ``query_replays`` over ``query_replays`` plus
``query_eager``, in %. None where the program records no such counter."""


def read(rec):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    c = telemetry.summary()["counters"]
    replays = c.get("query_replays", 0)
    queries = replays + c.get("query_eager", 0)
    if not queries:
        return None
    return replays / queries * 100
