"""A run with the timed path broken underneath comes out not correct:
each fault the cells can have, planted in the port at a tiny size on the
CPU, the rest of the run as on the card (only the look for a card is
skipped). No cell spans chips, so no fault drops an exchange between
them."""
import pytest
import torch

import tiny
from hrmbench import harness
from hrmbench.drivers import _serving, campaign


def _correct(rec) -> bool:
    return all(c["ok"] for c in harness.check_rows(rec))


def _serve(drain=True):
    """A tiny cell loaded so that every slot serves (the faults below
    break some slots only)."""
    mix = dict(tiny.CHAT_MIX, rate=400.0) if drain \
        else dict(tiny.DOCS_MIX, n_requests=4000)
    cell = dict(tiny.SERVE_CELL, sample_tokens=80,
                limits={"served_gap_mean": 1e-3, "served_tokens_judged": 80})
    return _serving.run(tiny.context(tiny.DEEPSEEK, cell, mix,
                                     seconds=0.6), drain=drain)


def _campaign(batch=None):
    mix = dict(tiny.CAMPAIGN_MIX, batch=batch or tiny.CAMPAIGN_MIX["batch"])
    return campaign.run(tiny.context(tiny.GRANITE, tiny.CAMPAIGN_CELL, mix,
                                     seconds=1.0))


def _decode_fault(monkeypatch, fault):
    from repro_torch.serve import engine
    orig = engine.paged_decode_step

    def step(*a, **k):
        nxt, ok = orig(*a, **k)
        return fault(nxt.clone()), ok
    monkeypatch.setattr(engine, "paged_decode_step", step)


@pytest.mark.parametrize("drain", [True, False], ids=["online", "batch"])
def test_sound_serving_runs_are_correct(drain):
    assert _correct(_serve(drain))


def test_sound_campaign_is_correct():
    assert _correct(_campaign())


@pytest.mark.parametrize("drain", [True, False], ids=["online", "batch"])
def test_a_token_altered_where_it_is_produced(monkeypatch, drain):
    def alter(nxt):
        nxt[0] = (nxt[0] + 1) % tiny.DEEPSEEK["vocab_size"]
        return nxt
    _decode_fault(monkeypatch, alter)
    assert not _correct(_serve(drain))


def test_half_of_the_batch_left_out(monkeypatch):
    def half(nxt):
        n = nxt.shape[0] // 2
        nxt[n:] = nxt[:n]
        return nxt
    _decode_fault(monkeypatch, half)
    assert not _correct(_serve())


def test_a_kv_refresh_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core.domain import MemoryDomain
    monkeypatch.setattr(MemoryDomain, "refresh",
                        lambda self, state=None, paths=None: self)
    rec = _serve()
    assert not _correct(rec)
    assert dict((n, v) for n, v, _, _ in rec["checks"])["hrm_events"] > 0


def test_a_check_that_detects_nothing(monkeypatch):
    """A KV check and a params scrub that return their state unchanged
    and report nothing: no window strikes, so only the strikes planted
    after the window show it."""
    from repro_torch.core.domain import MemoryDomain
    from repro_torch.core.sidecar import ScrubReport
    monkeypatch.setattr(MemoryDomain, "scrub",
                        lambda self, step=None, paths=None:
                        (self, ScrubReport()))
    rec = _serve()
    checks = dict((n, v) for n, v, _, _ in rec["checks"])
    assert checks["hrm_events"] == 0
    assert checks["strike_responses_differing"] > 0
    assert not _correct(rec)


def test_a_strike_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core.domain import MemoryDomain
    monkeypatch.setattr(MemoryDomain, "apply_plan",
                        lambda self, path, plan, record_hard=False: self)
    assert not _correct(_campaign())


def test_a_query_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.core import characterize
    orig = characterize.lm_eval_fn

    def lm_eval_fn(cfg, batch, forward):
        ev = orig(cfg, batch, forward)

        def altered(params):
            toks, st = ev(params)
            toks = toks.clone()
            toks[0, 0] = (toks[0, 0] + 1) % cfg.vocab_size
            return toks, st
        return altered
    monkeypatch.setattr(characterize, "lm_eval_fn", lm_eval_fn)
    assert not _correct(_campaign())


def test_half_of_the_query_batch_left_out(monkeypatch):
    import repro_torch.models as models
    orig = models.forward

    def forward(p, batch, cfg, **k):
        t = batch["tokens"]
        n = t.shape[0] // 2
        logits, aux, cache = orig(p, {"tokens": t[:n]}, cfg, **k)
        return torch.cat([logits, logits]), aux, cache
    monkeypatch.setattr(models, "forward", forward)
    assert not _correct(_campaign())


def test_one_query_row_altered(monkeypatch):
    """The logits of one row of four shifted: three quarters of the
    positions are exact, so the median of all of them does not see it,
    and the median of each row does."""
    import repro_torch.models as models
    orig = models.forward

    def forward(p, batch, cfg, **k):
        logits, aux, cache = orig(p, batch, cfg, **k)
        logits = logits.clone()
        logits[0] += 0.05 * logits[0].std(-1, keepdim=True)
        return logits, aux, cache
    monkeypatch.setattr(models, "forward", forward)
    rec = _campaign(batch=4)
    assert rec["judged"]["median"] < 1e-3
    assert not _correct(rec)


def test_a_trial_classified_wrongly(monkeypatch):
    from repro_torch.core import characterize
    from repro_torch.core.taxonomy import Outcome
    monkeypatch.setattr(characterize, "_outcome", lambda *a: Outcome.CRASH)
    assert not _correct(_campaign())
