"""Mean host ms of one campaign query (the program's span
``campaign.query``): the forward, the greedy tokens and the finiteness
test enqueued; the query does not wait for the device. None where the
program records no spans."""


def read(rec):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    q = telemetry.summary()["spans"].get("campaign.query")
    if q is None:
        return None
    return q["total_ms"] / q["count"] or None
