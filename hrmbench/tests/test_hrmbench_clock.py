"""The serving clock: work the engine's own wall clock leaves out (here a
delay planted in the KV write-path refresh) shows in TTFT and TPOT on the
benchmark's clock, and not on the engine's ``clock="wall"``."""
import time

import numpy as np
import pytest

import tiny
from hrmbench import traffic, weights
from hrmbench.drivers import _serving

DELAY_S = 0.03


@pytest.fixture
def slow_refresh(monkeypatch):
    from repro_torch.serve.engine import OnlineEngine
    orig = OnlineEngine._refresh_kv

    def refresh(self):
        time.sleep(DELAY_S)
        return orig(self)
    monkeypatch.setattr(OnlineEngine, "_refresh_kv", refresh)


def test_planted_delay_shows_on_the_harness_clock_only(slow_refresh):
    """The same requests through the harness and through the engine on
    its own wall clock: the refresh's delay lies between most pairs of a
    request's tokens (the second token comes in the iteration of the
    prefill), and the engine's clock leaves it out."""
    from repro_torch.core import DESIGN_POINTS, Tier
    from repro_torch.serve.engine import OnlineEngine
    c, seconds = tiny.DEEPSEEK, 0.6
    rec = _serving.run(tiny.context(c, tiny.SERVE_CELL, tiny.CHAT_MIX,
                                    seconds=seconds), drain=True)
    reqs = traffic.cell_requests(tiny.CHAT_MIX, 12345, c["vocab_size"],
                                 seconds)
    eng = OnlineEngine(_serving._port.model_config(c),
                       weights.make(c, 12345, "cpu"), slots=4, page_size=8,
                       max_prompt_len=16, max_new_cap=8,
                       policy=DESIGN_POINTS["detect_recover_l"](),
                       kv_tier=Tier.PARITY_R, clock="wall")
    report, _ = eng.run(reqs)
    assert np.median(rec["tpot_ms"]) - report.tpot_p50_s * 1e3 \
        >= 0.5 * DELAY_S * 1e3
    assert np.median(rec["ttft_ms"]) - report.ttft_p50_s * 1e3 \
        >= 0.5 * DELAY_S * 1e3


def test_missing_hook_fails_loudly(monkeypatch):
    from repro_torch.serve.engine import OnlineEngine
    monkeypatch.delattr(OnlineEngine, "_advance")
    with pytest.raises(RuntimeError, match="_advance"):
        _serving.check_hooks()


def test_batch_cell_stops_its_clock_at_the_window():
    mix = dict(tiny.DOCS_MIX, n_requests=4000)
    rec = _serving.run(tiny.context(tiny.DEEPSEEK, dict(
        tiny.SERVE_CELL, sample_tokens=4,
        limits={"served_gap_mean": 1e-3, "served_tokens_judged": 4}), mix,
        seconds=0.5), drain=False)
    assert 0 < rec["requests_done"] < 4000
    assert rec["tokens_per_s"] > 0
    assert all(t <= 0.5 + 1e-9 for _, _, _, t, _ in rec["requests"])
