"""The port's random draws (``repro_torch.draws``) on the CPU, pinned.

The draws are the same on the card as on the CPU (``chip_smoke.py`` phase
3c holds them equal bit for bit there); these tests pin the CPU side to
checksums recorded once, so a change of generator or transform shows here:
the int64 sum of each leaf's raw bytes of tiny llama3-8b's and tiny
kvstore-demo's seed-0 parameters, and the kv-store's query keys. Beside
them, the generator's own properties: counters hashed in chunks equal one
pass, the interpolated inverse CDF is within 1e-7 of the exact one, and a
large draw has the truncated normal's moments."""
import math

import numpy as np
import pytest
import torch

from repro_torch import draws
from repro_torch.configs import get_tiny
from repro_torch.core import tree
from repro_torch.launch.explore import _kvstore_state
from repro_torch.models import init_params

CPU = "cpu"
LEAF_BYTE_SUMS = {
    "llama3-8b": {
        "blocks/attn/wk": 2014826, "blocks/attn/wo": 4154786,
        "blocks/attn/wq": 4072660, "blocks/attn/wv": 2026087,
        "blocks/mlp/wg": 8125520, "blocks/mlp/wi": 8109871,
        "blocks/mlp/wo": 8090412, "blocks/norm1": 24448,
        "blocks/norm2": 24448, "embed": 8270533, "final_norm": 12224,
        "head": 8103783},
    "kvstore-demo": {
        "blocks/attn/wk": 511008, "blocks/attn/wo": 506187,
        "blocks/attn/wq": 499582, "blocks/attn/wv": 508596,
        "blocks/mlp/wi": 1031583, "blocks/mlp/wo": 1026663,
        "blocks/norm1": 6112, "blocks/norm2": 6112, "embed": 66050530,
        "final_norm": 6112, "head": 65035085},
}
KVSTORE_KEYS = [
    [2829, 1990, 2554, 3765, 1204, 3395, 434, 3116, 554, 1565, 1117, 920,
     140, 423, 3775, 547, 3651, 3730, 4009, 1536, 3794, 444, 2463, 3185,
     1133, 1849, 4038, 2083, 2542, 4073, 2504, 2958],
    [2112, 335, 2556, 1742, 3804, 2488, 2064, 981, 294, 122, 1079, 3886,
     303, 40, 1388, 3110, 4078, 2725, 3321, 485, 2811, 689, 400, 3877,
     1883, 1131, 2142, 2019, 1381, 397, 44, 2508]]
# standard deviation of the standard normal truncated to [-2, 2]
TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                      / math.erf(2 / math.sqrt(2)))


def _byte_sum(t: torch.Tensor) -> int:
    return int(t.contiguous().view(torch.uint8).to(torch.int64).sum())


@pytest.mark.parametrize("arch", sorted(LEAF_BYTE_SUMS))
def test_tiny_parameters_are_pinned(arch):
    params = init_params(get_tiny(arch), seed=0, device=CPU)
    flat, _ = tree.flatten_with_path(params)
    assert {"/".join(p): _byte_sum(t) for p, t in flat} == \
        LEAF_BYTE_SUMS[arch]


def test_kvstore_keys_are_pinned():
    _, keys = _kvstore_state(get_tiny("kvstore-demo"), 0, CPU)
    assert keys.dtype == torch.int64 and keys.tolist() == KVSTORE_KEYS


def test_chunked_hash_equals_one_pass(monkeypatch):
    """Counters hashed in chunks, across a 2**32 boundary, equal one pass;
    successive draws of a stream use fresh counters."""
    start = (1 << 32) - 40
    whole = draws.bits32(7, start, 100, CPU)
    normal = draws.Stream(7, CPU).truncated_normal((10, 10), 0.5,
                                                   torch.bfloat16)
    monkeypatch.setattr(draws, "_CHUNK", 16)
    assert torch.equal(draws.bits32(7, start, 100, CPU), whole)
    assert torch.equal(draws.Stream(7, CPU).truncated_normal(
        (10, 10), 0.5, torch.bfloat16), normal)
    assert int(whole.min()) >= 0 and int(whole.max()) < 1 << 32
    s = draws.Stream(7, CPU)
    s.counter = start
    assert torch.equal(torch.cat([s.bits32(30), s.bits32(70)]), whole)
    assert not torch.equal(draws.bits32(8, start, 100, CPU), whole)
    # the mix is the same on Python ints and on tensors
    assert [draws._mix32(int(x)) for x in whole[:4]] == \
        draws._mix32(whole[:4]).tolist()


def test_truncated_normal_is_the_inverse_cdf():
    values, steps = draws._inverse_cdf()
    s = torch.arange(values.numel(), dtype=torch.float64) / (values.numel()
                                                             - 1)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    p = lo + s * (1.0 - 2.0 * lo)
    exact = torch.erfinv(2.0 * p - 1.0) * math.sqrt(2.0)
    assert float((values.double() - exact).abs().max()) < 1e-7
    assert float(values[0]) == -2.0 and float(values[-1]) == 2.0
    # between the table's points: the midpoints of two neighbours' cells
    mid = (values[:-1].double() + steps.double() * 0.5)
    exact_mid = torch.erfinv(2.0 * (p[:-1] + (p[1] - p[0]) / 2) - 1.0) \
        * math.sqrt(2.0)
    assert float((mid - exact_mid).abs().max()) < 1e-7
    z = draws.Stream(3, CPU).truncated_normal((1 << 20,), 1.0,
                                              torch.float32)
    assert float(z.abs().max()) < 2.0
    assert abs(float(z.mean())) < 3e-3
    assert abs(float(z.std()) / TRUNC_STD - 1) < 3e-3


def test_randint_range():
    k = draws.Stream(0, CPU).randint(10, (4, 5000))
    assert k.shape == (4, 5000) and int(k.min()) == 0 and int(k.max()) == 9
    assert abs(float(k.double().mean()) - 4.5) < 0.1
    with pytest.raises(ValueError, match="2\\*\\*31"):
        draws.Stream(0, CPU).randint(1 << 31, (2,))
