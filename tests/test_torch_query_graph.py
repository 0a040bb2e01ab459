"""The campaign query's CUDA graph (``repro_torch/models/query_graph.py``).

On the CPU: the mirror's bookkeeping (which leaves a sync copies), where
the graph does not engage (outside ``lm_eval_fn``, on the CPU, for a
family it cannot capture, for a second batch shape: ``forward``'s result
is then the eager one, bit for bit), the order in which a query's runs
warm up, capture and replay, and ``telemetry.collecting``.

On the card (marked ``card``, skipped without one, decided inside the
test), at a tiny granite-shaped MoE config in bfloat16: replays equal the
eager forward bit for bit, logits and tokens, on a clean state, a struck
expert stack, an exponent flip that makes the logits non-finite (the
crash marker), and a campaign's soft and hard trials; a kept logits
tensor does not change under later replays; the counters equal the eager
run's. Run from the root of the repository:

    PYTHONPATH=src python3 -m pytest tests/test_torch_query_graph.py -m card
"""
import dataclasses
import importlib.util
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_tiny
from repro_torch.core import characterize
from repro_torch.kernels import ops
from repro_torch.models import forward, init_params, query_graph
from repro_torch.models.query_graph import Mirror, QueryGraph

ARCH = "granite-moe-3b-a800m"
METRICS = Path(__file__).resolve().parents[1] / "hrmbench" / "metrics"


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "query_graph_metric_" + name.replace(".", "_"),
        METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _tokens(cfg, shape, seed=8, device="cpu"):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape, dtype=np.int64)).to(device)


def _nbytes(t):
    return t.numel() * t.element_size()


# ------------------------------------------------------------- the mirror
def _same(leaves):
    """Nothing changes."""


def _new_tensor_at_1(leaves):
    leaves[1] = leaves[1] + 1


def _add_in_place_at_0(leaves):
    leaves[0].add_(1)


def _struck_then_clean_at_2(leaves, mirror):
    clean = leaves[2]
    leaves[2] = clean * 2
    mirror.sync(leaves)
    leaves[2] = clean


@pytest.mark.parametrize("change, copied", [
    (None, [0, 1, 2]),                     # the first sync copies all
    (_same, []),
    (_new_tensor_at_1, [1]),
    (_add_in_place_at_0, [0]),
    (_struck_then_clean_at_2, [2]),        # the clean object put back
], ids=["first", "same_objects", "new_tensor", "in_place", "clean_back"])
def test_mirror_copies_only_the_leaves_that_changed(change, copied):
    leaves = [torch.arange(6, dtype=torch.float32),
              torch.ones(2, 3, dtype=torch.bfloat16),
              torch.arange(5, dtype=torch.int64)]
    mirror = Mirror(leaves)
    if change is not None:
        assert mirror.sync(leaves) == sum(_nbytes(t) for t in leaves)
        if change is _struck_then_clean_at_2:
            change(leaves, mirror)
        else:
            change(leaves)
    assert mirror.sync(leaves) == sum(_nbytes(leaves[i]) for i in copied)
    for t, c in zip(leaves, mirror.copies):
        assert torch.equal(t, c)
        assert t.data_ptr() != c.data_ptr()     # never the caller's tensor
    assert mirror.sync(leaves) == 0


def test_mirror_holds_no_leaf_alive():
    """A struck leaf copied in is freed with its last caller's reference,
    and the leaf put in its place is copied."""
    leaves = [torch.zeros(4)]
    mirror = Mirror(leaves)
    mirror.sync(leaves)
    leaves[0] = torch.ones(4)
    mirror.sync(leaves)
    gone = weakref.ref(leaves[0])
    leaves[0] = torch.zeros(4)
    assert gone() is None
    assert mirror.sync(leaves) == 16
    assert torch.equal(mirror.copies[0], leaves[0])


# -------------------------------------------- where the graph stays away
def _cfg(arch):
    return get_tiny(arch)


@pytest.mark.parametrize("arch, card", [
    (ARCH, False),                   # on the CPU
    ("llama3-8b", False),
    ("xlstm-350m", True),            # a family it cannot capture
    ("zamba2-2.7b", True),
], ids=["granite_cpu", "dense_cpu", "ssm_family", "hybrid_family"])
def test_forward_stays_eager_where_the_graph_cannot_serve(
        arch, card, monkeypatch):
    """Inside a query the result is the eager forward's, bit for bit, and
    the query counts as eager; no capture is made (``card`` pretends the
    tokens' device captures, so only the family refuses)."""
    cfg = _cfg(arch)
    params = init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": _tokens(cfg, (2, 16))}
    want = forward(params, batch, cfg)
    if card:
        monkeypatch.setattr(query_graph, "_captures_on", lambda d: True)
    graph = QueryGraph()
    with telemetry.recording():
        with telemetry.span("q"), graph.engaged():
            got = forward(params, batch, cfg)
        with telemetry.span("q"), graph.engaged():
            again = forward(params, batch, cfg)
    counters = telemetry.summary()["spans"]["q"]["counters"]
    assert counters["query_eager"] == 2 and "query_replays" not in counters
    for out in (got, again):
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        assert out[2] is None
    assert graph._key is None and graph._graph is None
    assert query_graph.active is None


def test_forward_outside_a_query_never_reaches_a_graph(monkeypatch):
    """No graph is ambient outside ``engaged()``: a graph's own forward
    is never called, and the result is today's."""
    cfg = _cfg(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": _tokens(cfg, (2, 16))}
    want = forward(params, batch, cfg)
    calls = []
    monkeypatch.setattr(QueryGraph, "forward",
                        lambda *a, **k: calls.append(a))
    QueryGraph()
    got = forward(params, batch, cfg)
    assert calls == [] and torch.equal(got[0], want[0])


class _Recorded(QueryGraph):
    """The decision logic with the capture and replay recorded, on the
    CPU: a replay runs the eager forward over the mirror's copies."""

    def __init__(self):
        super().__init__()
        self.log = []

    def _capture(self, forward, flat, batch, cfg):
        self.log.append("capture")
        self._graph = "captured"
        self._mirror = Mirror([t for _, t in flat])
        self._fwd, self._cfg = forward, cfg

    def _replay(self, flat, batch):
        self.log.append("replay")
        self._mirror.sync([t for _, t in flat])
        weights = query_graph._nest([(p, c) for (p, _), c in
                                     zip(flat, self._mirror.copies)])
        with query_graph._ambient(None):
            return self._fwd(weights, batch, self._cfg)


def test_warm_up_then_capture_then_replays_and_a_second_shape_eager(
        monkeypatch):
    monkeypatch.setattr(query_graph, "_captures_on", lambda d: True)
    cfg = _cfg(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    a = {"tokens": _tokens(cfg, (2, 16))}
    b = {"tokens": _tokens(cfg, (2, 8))}
    graph = _Recorded()
    outs = []
    for batch, want in ((a, []), (a, ["capture", "replay"]),
                        (a, ["capture", "replay", "replay"]),
                        (b, ["capture", "replay", "replay"])):
        with graph.engaged():
            outs.append(forward(params, batch, cfg))
        assert graph.log == want
    for out, batch in zip(outs, (a, a, a, b)):
        assert torch.equal(out[0], forward(params, batch, cfg)[0])


@pytest.mark.parametrize("change", ["shape", "dtype", "path", "grad",
                                    "extra_input", "remat", "cache"])
def test_the_capture_key_refuses_another_call(change, monkeypatch):
    monkeypatch.setattr(query_graph, "_captures_on", lambda d: True)
    cfg = _cfg(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": _tokens(cfg, (2, 16))}
    key = query_graph.signature(params, batch, cfg)[1]
    p2, b2, kw = dict(params), dict(batch), {}
    if change == "shape":
        b2["tokens"] = _tokens(cfg, (2, 8))
    elif change == "dtype":
        p2["final_norm"] = params["final_norm"].to(torch.bfloat16)
    elif change == "path":
        p2["final_norm_"] = p2.pop("final_norm")
    elif change == "grad":
        p2["final_norm"] = params["final_norm"].clone().requires_grad_()
    elif change == "extra_input":
        b2["mask"] = torch.ones(2, 16)
    else:
        kw = {"remat": "full"} if change == "remat" \
            else {"return_cache": True}
    sig = query_graph.signature(p2, b2, cfg, **kw)
    assert sig is None or sig[1] != key


# -------------------------------------------------------------- telemetry
def test_collecting_gathers_counts_off_and_a_replay_adds_them():
    telemetry.reset()
    with telemetry.collecting() as got:
        telemetry.count("moe_slots", 3)
        telemetry.count("moe_slots", 4)
    assert got == {"moe_slots": 7}
    assert telemetry.summary()["counters"] == {}
    with telemetry.recording():
        with telemetry.span("outer"):
            with telemetry.span("campaign.query"):
                with telemetry.collecting() as inner:
                    telemetry.count("moe_routed", 5)    # not recorded
                for name, n in got.items():
                    telemetry.count(name, n)
    s = telemetry.summary()
    assert inner == {"moe_routed": 5}
    assert s["spans"]["campaign.query"]["counters"] == {"moe_slots": 7}
    assert s["counters"] == {"moe_slots": 7}


def test_query_graph_share_reads_replays_over_queries():
    read = _reader("query_graph_share.campaign")
    telemetry.reset()
    assert read({}) is None                       # nothing recorded
    with telemetry.recording():
        with telemetry.span("campaign.query"):
            telemetry.count("query_eager", 1)
        for _ in range(3):
            with telemetry.span("campaign.query"):
                telemetry.count("query_replays", 1)
    assert read({}) == pytest.approx(75.0, rel=1e-12)


# ---------------------------------------------------------------- the card
def _card_cfg():
    cfg = get_tiny(ARCH)
    moe = dataclasses.replace(cfg.moe, capacity_factor=(
        cfg.moe.n_experts / cfg.moe.top_k))           # dropless, as the cell
    return dataclasses.replace(cfg, param_dtype="bfloat16", moe=moe)


def _eager_query(cfg, toks):
    """``lm_eval_fn``'s query without a graph."""
    def ev(params):
        logits, _, _ = forward(params, {"tokens": toks}, cfg)
        t = torch.argmax(logits, dim=-1)
        return torch.where(torch.isfinite(logits).all(), t, -1), params
    return ev


def _with(params, path, leaf):
    out = {k: dict(v) if isinstance(v, dict) else v
           for k, v in params.items()}
    node = out
    for k in path[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    node[path[-1]] = leaf
    return out


@pytest.mark.card
def test_replay_equals_the_eager_forward_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, dev = _card_cfg(), torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev)
    toks = _tokens(cfg, (4, 64), device=dev)
    kept = []

    def fwd(p, batch, cfg, **kw):
        out = forward(p, batch, cfg, **kw)
        kept.append(out[0])
        return out
    graph_ev = characterize.lm_eval_fn(cfg, {"tokens": toks}, fwd)
    eager_ev = _eager_query(cfg, toks)

    runs = {}
    for name, ev in (("eager", eager_ev), ("graph", graph_ev)):
        outs = []

        def query(state, ev=ev, outs=outs):
            out = ev(state)
            outs.append(out[0])
            return out
        with telemetry.recording():
            res = characterize.run_campaign(query, params, n_trials=3,
                                            seed=5, hard_repeat=3)
        torch.cuda.synchronize()
        runs[name] = (res, outs, telemetry.summary()["counters"])
    (res_e, outs_e, cnt_e), (res_g, outs_g, cnt_g) = runs["eager"], \
        runs["graph"]
    n = len(outs_g)
    assert n == 1 + 3 + 3 * 3
    assert res_g.trials == res_e.trials
    assert all(torch.equal(a, b) for a, b in zip(outs_g, outs_e))
    assert cnt_g.pop("query_replays") == n - 1
    assert cnt_g.pop("query_eager") == 1
    assert cnt_g.pop("query_copied_bytes") > 0
    assert cnt_g == cnt_e

    # the states one by one: clean, a struck expert stack, an exponent
    # flip that makes the logits non-finite
    wi = params["blocks"]["moe"]["wi"]
    struck = ops.inject_bitflips(wi, [wi.numel() // 8 + 3, 17], [3, 9])
    # bit 14 of the first bfloat16 word: 1.0 (0x3f80) becomes inf (0x7f80)
    inf = ops.inject_bitflips(params["final_norm"], [0], [14])
    states = {"clean": params,
              "struck_expert": _with(params, ("blocks", "moe", "wi"),
                                     struck),
              "non_finite": _with(params, ("final_norm",), inf)}
    first = kept[2]
    snapshot = first.clone()
    for name, state in states.items():
        got, _ = graph_ev(state)
        logits = kept[-1]
        want_logits = forward(state, {"tokens": toks}, cfg)[0]
        want, _ = eager_ev(state)
        assert torch.equal(got, want), name
        assert torch.equal(logits, want_logits) or (
            name == "non_finite" and torch.equal(
                logits.isnan(), want_logits.isnan()) and torch.equal(
                logits.nan_to_num(), want_logits.nan_to_num())), name
        assert bool((got < 0).all()) == (name == "non_finite"), name
    assert torch.equal(first, snapshot)        # a kept result never moves

    # a second batch shape runs eagerly beside the captured one
    graph = QueryGraph()
    other = _tokens(cfg, (2, 32), device=dev)
    with telemetry.recording():
        for batch in ({"tokens": toks}, {"tokens": toks}, {"tokens": other},
                      {"tokens": toks}):
            with telemetry.span("q"), graph.engaged():
                out = forward(params, batch, cfg)
            assert torch.equal(out[0], forward(params, batch, cfg)[0])
    c = telemetry.summary()["counters"]
    assert (c["query_eager"], c["query_replays"]) == (2, 2)
