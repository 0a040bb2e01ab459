"""The benchmark's traffic: the copied generator draws the port's trace,
and every seed of a mix gets the same work."""
import numpy as np
import pytest

from hrmbench import traffic
from repro_torch.serve import traffic as port_traffic


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_copied_generator_equals_the_ports(seed):
    kw = dict(n_requests=60, rate=9.0, process="bursty", burst_mult=8.0,
              prompt_len_choices=(128, 256, 512, 1024),
              prompt_len_weights=(0.4, 0.3, 0.2, 0.1),
              max_new_choices=(64, 128, 256, 512),
              max_new_weights=(0.4, 0.3, 0.2, 0.1), seed=seed)
    ours = traffic.generate_trace(traffic.TrafficConfig(**kw), 102400)
    port = port_traffic.generate_trace(port_traffic.TrafficConfig(**kw),
                                       102400)
    assert len(ours) == len(port) == 60
    for a, b in zip(ours, port):
        assert (a.rid, a.arrival, a.max_new) == (b.rid, b.arrival, b.max_new)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_every_seed_gets_the_same_work():
    mix = {"process": "bursty", "rate": 8.0, "arrival_seed": 11,
           "prompt_len_choices": [128, 256, 512, 1024],
           "prompt_len_weights": [0.4, 0.3, 0.2, 0.1],
           "max_new_choices": [64, 128], "max_new_weights": [0.5, 0.5]}
    runs = [traffic.cell_requests(mix, s, 1000, 20.0)
            for s in (1, 2, 2**40 + 3)]
    arrivals = [[r.arrival for r in rs] for rs in runs]
    assert arrivals[0] == arrivals[1] == arrivals[2]
    assert max(arrivals[0]) < 20.0
    for key in ("prompt_len", "max_new"):
        counts = [sorted(getattr(r, key) for r in rs) for rs in runs]
        assert counts[0] == counts[1] == counts[2]
    assert [r.prompt_len for r in runs[0]] != [r.prompt_len for r in runs[1]]
    again = traffic.cell_requests(mix, 1, 1000, 20.0)
    assert all(np.array_equal(a.prompt, b.prompt)
               for a, b in zip(again, runs[0]))


def test_exact_shares_and_batch_arrivals():
    got = traffic.exact_shares(10, [1, 2, 3], [0.4, 0.3, 0.3])
    assert sorted(got.tolist()) == [1, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    mix = {"process": "batch", "n_requests": 5, "prompt_len_choices": [4],
           "prompt_len_weights": [1], "max_new_choices": [2],
           "max_new_weights": [1]}
    assert [r.arrival for r in traffic.cell_requests(mix, 3, 50, 9.0)] \
        == [0.0] * 5


def test_lm_query_is_the_ports_query_arithmetic():
    from repro_torch.configs import get_tiny
    from repro_torch.data.synthetic import lm_batch
    from hrmbench.seeds import derive
    cfg = get_tiny("granite-moe-3b-a800m")
    want = lm_batch(cfg, 4, 32, derive(9, traffic.QUERY_STREAM),
                    device="cpu")["tokens"].numpy()
    np.testing.assert_array_equal(
        traffic.lm_query(cfg.vocab_size, 4, 32, 9), want)
