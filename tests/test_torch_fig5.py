"""Measured tier rates and the Fig. 5 rows of the PyTorch port against the
JAX reference: ``measure_class_rates`` for five tiers and three strike
classes, equal as floats (the same numpy stream through the port's plain
kernel versions and the reference's interpret-mode Pallas kernels); the
cost and availability rows of every design point, calibrated and with
measured rates; and the published numbers pinned by
``tests/test_explore.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jget_tiny
from repro.core import availability as javail
from repro.core import costmodel as jcost
from repro.core import eccmeasure as jecc
from repro.core.errormodel import DEFAULT_ADJACENT_FRACTION
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.core.tiers import Tier as JTier
from repro.models import init_params as jinit_params
from repro_torch.convert import state_from_numpy
from repro_torch.core import (DESIGN_POINTS, Tier, availability, costmodel,
                              eccmeasure, measured_tier_rates,
                              paper_design_availability, paper_design_costs,
                              region_fractions)

TIERS = ("parity_r", "secded", "dected", "burst", "mirror")


def _rates(r):
    return (r.corrected, r.detected, r.silent)


@pytest.mark.parametrize("strike", eccmeasure.STRIKE_CLASSES)
@pytest.mark.parametrize("tier", TIERS)
def test_class_rates_equal_reference(tier, strike):
    want = jecc.measure_class_rates(JTier(tier), strike, 128, 0)
    got = eccmeasure.measure_class_rates(Tier(tier), strike, 128, 0,
                                         device="cpu")
    assert _rates(got) == _rates(want)


@pytest.fixture(scope="module")
def rates():
    """The five tiers' rates under the explorer's incident mix, both sides."""
    mix = (availability.MULTI_BIT_FRACTION, DEFAULT_ADJACENT_FRACTION)
    want = jecc.measured_tier_rates([JTier(t) for t in TIERS], *mix)
    got = measured_tier_rates([Tier(t) for t in TIERS], *mix, device="cpu")
    return want, got


def test_measured_tier_rates_equal_reference(rates):
    want, got = rates
    assert {t.value: _rates(r) for t, r in got.items()} == \
        {t.value: _rates(r) for t, r in want.items()}
    # the strong tiers' contracts, as the reference measures them
    assert got[Tier.DECTED].corrected == 1.0
    assert got[Tier.BURST].silent == 0.0 and got[Tier.BURST].detected > 0


def test_paper_design_costs_equal_reference():
    want, got = jcost.paper_design_costs(), paper_design_costs()
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == \
            dataclasses.asdict(want[name]), name
        assert got[name].row() == want[name].row()


@pytest.mark.parametrize("measured", [False, True])
def test_paper_design_availability_equal_reference(rates, measured):
    want_rates, got_rates = rates
    want = javail.paper_design_availability(want_rates if measured else None)
    got = paper_design_availability(got_rates if measured else None)
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == \
            dataclasses.asdict(want[name]), name
        assert got[name].row() == want[name].row()
    if measured:
        assert got["dected_server"].availability == 1.0


def test_fig5_paper_pins():
    """The published Fig. 5 numbers: D&R 9.7 % memory / 2.9 % server, D&R/L
    15.5 % / 4.7 %, both >= 99.90 % availability."""
    costs = paper_design_costs()
    avail = paper_design_availability()
    assert abs(costs["detect_recover"].memory_saving - 0.097) < 0.005
    assert abs(costs["detect_recover"].server_saving - 0.029) < 0.005
    assert abs(costs["detect_recover_l"].memory_saving - 0.155) < 0.005
    assert abs(costs["detect_recover_l"].server_saving - 0.047) < 0.005
    assert avail["detect_recover"].availability >= 0.9990
    assert avail["detect_recover_l"].availability >= 0.9990
    assert avail["consumer_pc"].availability < 0.995
    assert costs["peer_dr_l"].memory_saving > \
        costs["detect_recover_l"].memory_saving
    assert avail["peer_dr_l"].availability >= 0.9990


def test_evaluate_availability_equal_reference(rates):
    """A region profile and tier map outside the paper's, through both
    branches: calibrated, and measured for the tiers that have rates."""
    want_rates, got_rates = rates
    profile = {"params/embed": 0.2, "params/attn": 0.3, "params/mlp": 0.45,
               "kv_cache": 0.05}
    tiers = {"params/embed": "dected", "params/attn": "burst",
             "params/mlp": "parity_r", "kv_cache": "secded"}
    vuln = javail.VulnProfile(
        p_crash={"params/embed": 0.02, "params/attn": 0.3},
        r_incorrect={"params/mlp": 2.0})
    for software in (False, True):
        for use_rates in (False, True):
            want = javail.evaluate_availability(
                "x", {r: JTier(t) for r, t in tiers.items()},
                jcost.RegionProfile(profile), vuln, less_tested=True,
                software_response=software,
                tier_rates=want_rates if use_rates else None)
            got = availability.evaluate_availability(
                "x", {r: Tier(t) for r, t in tiers.items()},
                costmodel.RegionProfile(profile),
                availability.VulnProfile(vuln.p_crash, vuln.r_incorrect),
                less_tested=True, software_response=software,
                tier_rates=got_rates if use_rates else None)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_region_fractions_and_policy_costs_equal_reference():
    jparams = jinit_params(jax.random.PRNGKey(0), jget_tiny("llama3-8b"))
    tparams = state_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    want = jcost.region_fractions(jparams)
    got = region_fractions(tparams)
    assert dict(got.fractions) == dict(want.fractions)
    for name in ("typical_server", "detect_recover_l", "dected_server",
                 "burst_dr_l", "mirror_dr_l"):
        assert dataclasses.asdict(costmodel.policy_cost_saving(
            DESIGN_POINTS[name](), got)) == dataclasses.asdict(
                jcost.policy_cost_saving(JDESIGN_POINTS[name](), want))


def test_measurement_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eccmeasure.measure_class_rates(Tier.DECTED, "single")
