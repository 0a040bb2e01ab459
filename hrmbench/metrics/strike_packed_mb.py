"""MB (10^6 bytes) a campaign trial's strikes stage into packed rows: the
program's counter ``packed_bytes`` under ``campaign.strike`` over the
``campaign.trial`` spans. None where the program records no spans."""


def read(rec):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.summary()["spans"]
    if "campaign.strike" not in spans or "campaign.trial" not in spans:
        return None
    packed = spans["campaign.strike"]["counters"].get("packed_bytes", 0)
    return packed / spans["campaign.trial"]["count"] / 1e6 or None
