"""The port's random draws (``repro_torch.draws``) on the CPU, pinned.

The draws are the same on the card as on the CPU (``chip_smoke.py`` phase
3c holds them equal bit for bit there); these tests pin the CPU side to
checksums recorded once, so a change of generator or transform shows here:
the int64 sum of each leaf's raw bytes of tiny llama3-8b's and tiny
kvstore-demo's seed-0 parameters, and of the four tiny MoE, hybrid and
xLSTM configs' (whose convs and sLSTM recurrent weights are normal draws),
the kv-store's query keys, and ``Stream.normal``'s draws. Beside them,
the generator's own properties: counters hashed in chunks equal one pass,
the interpolated inverse CDFs are within 1e-7 (truncated) and 8e-7
(normal) of the exact ones, and a large draw has the distribution's
moments."""
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
    "granite-moe-3b-a800m": {
        "blocks/attn/wk": 2014826, "blocks/attn/wo": 4154786,
        "blocks/attn/wq": 4072660, "blocks/attn/wv": 2026087,
        "blocks/moe/router": 519261, "blocks/moe/wg": 32451903,
        "blocks/moe/wi": 32496534, "blocks/moe/wo": 33284358,
        "blocks/norm1": 24448, "blocks/norm2": 24448, "embed": 8242402,
        "final_norm": 12224, "head": 8102969},
    "deepseek-moe-16b": {
        "blocks/attn/wk": 4040913, "blocks/attn/wo": 4143652,
        "blocks/attn/wq": 4072660, "blocks/attn/wv": 4053057,
        "blocks/moe/router": 506972, "blocks/moe/shared/wg": 4045314,
        "blocks/moe/shared/wi": 4041832, "blocks/moe/shared/wo": 4161934,
        "blocks/moe/wg": 32472322, "blocks/moe/wi": 32475548,
        "blocks/moe/wo": 33286745, "blocks/norm1": 24448,
        "blocks/norm2": 24448, "embed": 8235912, "final_norm": 12224,
        "head": 8103236},
    "zamba2-2.7b": {
        "blocks/mamba/A_log": 3860, "blocks/mamba/D_skip": 3056,
        "blocks/mamba/conv_b": 0, "blocks/mamba/conv_w": 1276092,
        "blocks/mamba/dt_bias": 3072, "blocks/mamba/in_proj": 37028315,
        "blocks/mamba/norm_w": 97792, "blocks/mamba/out_proj": 16452896,
        "blocks/norm": 48896, "embed": 8231034, "final_norm": 12224,
        "head": 8147263, "shared/attn/wk": 2027586,
        "shared/attn/wo": 2023826, "shared/attn/wq": 2011381,
        "shared/attn/wv": 2017575, "shared/mlp/wg": 4050761,
        "shared/mlp/wi": 4046463, "shared/mlp/wo": 4067950,
        "shared/norm1": 12224, "shared/norm2": 12224},
    "xlstm-350m": {
        "blocks_m/mlstm/b_f": 256, "blocks_m/mlstm/b_i": 384,
        "blocks_m/mlstm/conv_b": 0, "blocks_m/mlstm/conv_w": 256583,
        "blocks_m/mlstm/down_proj": 4089624,
        "blocks_m/mlstm/norm_w": 24448, "blocks_m/mlstm/up_proj": 8113573,
        "blocks_m/mlstm/w_if": 256569, "blocks_m/mlstm/wk": 8247587,
        "blocks_m/mlstm/wq": 8209465, "blocks_m/mlstm/wv": 8235934,
        "blocks_m/norm": 12224, "blocks_s/norm": 12224,
        "blocks_s/slstm/b": 20480, "blocks_s/slstm/norm_w": 12224,
        "blocks_s/slstm/out_proj": 2034510,
        "blocks_s/slstm/r_rec": 4082727, "blocks_s/slstm/w_in": 8134838,
        "embed": 8220765, "final_norm": 12224, "head": 8089420},
}
# Stream(11).normal((1000,), scale, dtype): its raw bytes' sum
NORMAL_SUMS = {(0.1, torch.bfloat16): 248809, (1.0, torch.float32): 507576}
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


@pytest.mark.parametrize("scale,dtype", sorted(NORMAL_SUMS, key=str))
def test_normal_is_pinned(scale, dtype):
    z = draws.Stream(11, CPU).normal((1000,), scale, dtype)
    assert z.dtype == dtype and _byte_sum(z) == NORMAL_SUMS[scale, dtype]


def test_normal_is_the_inverse_cdf():
    """Every one of the 2**24 points the normal can take is within 8e-7 of
    the exact inverse CDF at its cell's midpoint; the tails reach +-5.42
    and their exact cells mirror each other; a large draw has mean 0 and
    deviation 1."""
    values, steps, tail = draws._normal_tables()
    k = torch.arange(1 << 24, dtype=torch.int64)
    z = draws.Stream(0, CPU)
    z.bits32 = lambda n: (k << 8)[:n]             # every 24-bit point once
    got = z.normal((1 << 24,), 1.0, torch.float32).double()
    exact = torch.special.ndtri((k.double() + 0.5) / (1 << 24))
    assert float((got - exact).abs().max()) < 8e-7
    n = tail.numel()                              # the exact tail cells
    assert torch.equal(got[:n], -got.flip(0)[:n])
    assert 5.4 < float(got.max()) < 5.43
    x = draws.Stream(3, CPU).normal((1 << 20,), 1.0, torch.float32)
    assert abs(float(x.mean())) < 3e-3 and abs(float(x.std()) - 1) < 3e-3


def test_randint_range():
    k = draws.Stream(0, CPU).randint(10, (4, 5000))
    assert k.shape == (4, 5000) and int(k.min()) == 0 and int(k.max()) == 9
    assert abs(float(k.double().mean()) - 4.5) < 0.1
    with pytest.raises(ValueError, match="2\\*\\*31"):
        draws.Stream(0, CPU).randint(1 << 31, (2,))
