"""The plain reference against the port, on tiny deepseek and granite
configurations in float32 with dropless routing; the reference's campaign
draws against the port's."""
import math

import numpy as np
import pytest
import torch

import tiny
from hrmbench import weights
from hrmbench.drivers import _port
from hrmbench.reference import campaign as ref_campaign
from hrmbench.reference import judge
from hrmbench.reference import model as ref_model


@pytest.mark.parametrize("config", [tiny.DEEPSEEK, tiny.GRANITE],
                         ids=["deepseek", "granite"])
def test_reference_logits_equal_the_ports_forward(config):
    from repro_torch.models import forward
    cfg = _port.model_config(config)
    _port.check_layout(cfg, config)
    w = weights.make(config, 77, "cpu")
    toks = torch.randint(0, config["vocab_size"], (2, 24),
                         generator=torch.Generator().manual_seed(1))
    port, _, _ = forward(w, {"tokens": toks}, cfg)
    for b in range(2):
        ref = ref_model.logits(w, config, toks[b])
        torch.testing.assert_close(ref, port[b].float(), rtol=1e-4,
                                   atol=1e-4)
        assert float(judge.gaps(ref, port[b].argmax(-1)).max()) < 1e-4
    last = ref_model.logits(w, config, toks[0], last=5)
    torch.testing.assert_close(last, ref_model.logits(w, config, toks[0])[-5:])


def test_fp8_control_departs_from_float32():
    w = weights.make(tiny.DEEPSEEK, 3, "cpu")
    toks = torch.arange(40) % 256
    ref = ref_model.logits(w, tiny.DEEPSEEK, toks)
    low = ref_model.logits(w, tiny.DEEPSEEK, toks,
                           prec=ref_model.Precision(fp8=True))
    assert float(judge.control_gaps(ref, low).max()) > 0.1


def test_weights_are_the_seed_s_and_aligned():
    a = weights.make(tiny.DEEPSEEK, 5, "cpu")
    b = weights.make(tiny.DEEPSEEK, 5, "cpu")
    c = weights.make(tiny.DEEPSEEK, 6, "cpu")
    la, lb, lc = (weights.flat_leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not torch.equal(la[-1][1], lc[-1][1])
    assert all(t.data_ptr() % 64 == 0 for _, t in la)    # slices: 256 B
    assert sum(t.numel() for _, t in la) == sum(
        math.prod(shape) for _, shape, _, _ in weights.layout(tiny.DEEPSEEK))


def test_campaign_draws_equal_the_ports():
    from repro_torch.core.characterize import _campaign_domain, \
        _campaign_strikes
    w = weights.make(tiny.GRANITE, 1, "cpu")
    dom, _, _ = _campaign_domain(w, "params")
    port = list(_campaign_strikes(dom, n_trials=40, errors_per_trial=1,
                                  seed=99, kinds=("soft", "hard"),
                                  region_filter=None))
    ours = ref_campaign.draws(
        ref_campaign.leaf_table(weights.flat_leaves(w)), 40, 99)
    assert len(port) == len(ours) == 80
    multi = 0
    for (kind, s, plan), (k2, path, ws, bs) in zip(port, ours):
        keep = plan.word_idx >= 0
        assert (kind, s.path) == (k2, path)
        assert plan.word_idx[keep].tolist() == ws
        assert plan.bit_idx[keep].tolist() == bs
        multi += len(ws) > 1
    nb = {p: n for p, n, _ in ref_campaign.leaf_table(
        weights.flat_leaves(w))}
    assert all(ref_campaign.flips([0], [9], nb[p]) == {1: 2} for p in nb)
    assert ref_campaign.flips([10**9], [0], 16) == {}


def test_struck_leaf_is_the_ports_apply_plan():
    from repro_torch.core.domain import MemoryDomain
    from repro_torch.core.errormodel import InjectionPlan
    from repro_torch.core.policy import HRMPolicy
    w = weights.make(tiny.GRANITE, 2, "cpu")
    dom = MemoryDomain.protect(w, HRMPolicy("campaign/params", {}))
    plan = InjectionPlan(np.array([3, 3, 100, -1], np.int32),
                         np.array([5, 62, 17, 0], np.int32), False)
    port = dom.apply_plan("blocks/moe/wi", plan).leaf("blocks/moe/wi")
    leaf = w["blocks"]["moe"]["wi"]
    fl = ref_campaign.flips([3, 3, 100], [5, 62, 17],
                            leaf.numel() * leaf.element_size())
    assert torch.equal(_bits(port), _bits(ref_campaign.struck(leaf, fl)))


def _bits(t):
    return t.view(torch.int32)
