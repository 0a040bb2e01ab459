"""The paged decode's attention (``kernels/paged_attn.py``): each slot's
query against its own K/V pages, read through the page table up to its
position.

On the CPU: the plain version after the step's write into the pages
equals the gathered view with the new token inserted by ``torch.where``
and ``attention.attend`` over it, bit for bit (the order of the paged
decode before the kernel); the wrapper's refusals; the engine's
``attn_positions_read`` counter and ``positions_read`` on the plain
version and, on the card, on the kernel.

On the card (``card`` marker; run them on a machine with an H100 as
``PYTHONPATH=src python3 -m pytest tests/test_torch_paged_attn.py -m
card``): the kernel against the plain version, and a CUDA graph's replay
against the eager call.

Tolerances on the card. The kernel keeps scores, softmax and the V sum
in float32 and rounds o once to the compute dtype, so against the plain
version computed in float32 over the same values it lies within one
rounding of o (``finfo(dtype).eps`` x |o|) plus 1e-5 x max|o| for the
float32 sums taken in another order. Against the plain version in the
compute dtype, which rounds the scores, the softmax weights and o each to
that dtype (relative ``eps / 2`` each; scores of a few units at these
inputs), it lies within 4 x eps x max|v|.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_tiny
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import (paged_attn_decode,
                                            paged_attn_decode_plain,
                                            positions_read)
from repro_torch.models import init_params
from repro_torch.models.attention import attend
from repro_torch.serve import OnlineEngine, Request
from repro_torch.serve.paged_kv import NULL_PAGE

PAGE = 16


def _case(S, P, K, G, dh, dtype, pos, device="cpu", seed=0, extra_pages=1):
    """q (S, K, G, dh), pools of S * P + extra_pages pages (page 0 the null
    page), each slot's P pages distinct and shuffled, pos (S,)."""
    gen = torch.Generator().manual_seed(seed)
    n_pages = S * P + extra_pages

    def draw(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).to(device)
    q = draw(S, K, G, dh)
    pk, pv = draw(n_pages, PAGE, K, dh), draw(n_pages, PAGE, K, dh)
    perm = torch.randperm(n_pages - 1, generator=gen)[:S * P] + 1
    table = perm.reshape(S, P).to(torch.int64).to(device)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return q, pk, pv, table, pos


def _old_attention(q, k_new, v_new, pk, pv, table, pos, wo, cfg, dtype):
    """The paged decode's MHA attention before the kernel: every slot's
    pages gathered, the new token inserted by mask, ``attend``."""
    S, P = table.shape
    smax = P * PAGE
    cols = torch.arange(smax)
    upd = (cols[None, :] == pos[:, None])[:, :, None, None]
    valid = (cols[None, :] <= pos[:, None])[:, None, None, None, :]
    vk = pk[table].reshape(S, smax, *pk.shape[2:])
    vv = pv[table].reshape(S, smax, *pv.shape[2:])
    vk = torch.where(upd, k_new.to(vk.dtype), vk)
    vv = torch.where(upd, v_new.to(vv.dtype), vv)
    return attend({"wo": wo}, q[:, None], vk, vv, valid, cfg, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("at", [0, 15, 16, 3 * PAGE - 1],
                         ids=["pos0", "pos15", "pos16", "last"])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_after_the_write_equals_the_gathered_where_and_attend(
        G, at, dtype):
    """Route (a): the new K/V written into its page first, then the plain
    version over the pools, then ``o @ wo``: the old gathered view with the
    token inserted by ``where`` and ``attend``, bit for bit. Slot 0 sits at
    ``at``; the others at other positions, one idle at 0 in the null
    page."""
    S, P, K, dh = 4, 3, 2, 16
    q, pk, pv, table, _ = _case(S, P, K, G, dh, dtype, [0] * S)
    table[3] = NULL_PAGE                       # an idle slot
    pos = torch.tensor([at, 5, 2 * PAGE + 3, 0])
    gen = torch.Generator().manual_seed(1)
    k_new = torch.randn(S, 1, K, dh, generator=gen).to(dtype)
    v_new = torch.randn(S, 1, K, dh, generator=gen).to(dtype)
    wo = torch.randn(K * G * dh, 24, generator=gen).to(dtype)
    cfg = SimpleNamespace(head_dim=dh, n_heads=K * G)
    want = _old_attention(q, k_new, v_new, pk, pv, table, pos, wo, cfg,
                          dtype)
    pid = table.gather(1, (pos // PAGE)[:, None])[:, 0]
    pk[pid, pos % PAGE] = k_new[:, 0]
    pv[pid, pos % PAGE] = v_new[:, 0]
    o = paged_attn_decode(q, pk, pv, table, pos, PAGE)
    assert o.shape == (S, K * G * dh) and o.dtype == dtype
    got = o[:, None].to(dtype) @ wo.to(dtype)
    assert torch.equal(got, want)


def _refusal(kind):
    q, pk, pv, table, pos = _case(2, 2, 2, 1, 16, torch.bfloat16, [3, 7])
    if kind == "q_dtype":
        q = q.float()
    elif kind in ("f64", "f16"):
        dt = torch.float64 if kind == "f64" else torch.float16
        q, pk, pv = q.to(dt), pk.to(dt), pv.to(dt)
    elif kind == "pos_int32":
        pos = pos.int()
    elif kind == "pool_not_contiguous":
        pk = pk.transpose(2, 3).contiguous().transpose(2, 3)
    elif kind == "pool_shape":
        pv = pv[:, :, :1]
    elif kind == "dh_12":                  # 24 bytes: not whole 16-byte chunks
        q, pk, pv = q[..., :12].contiguous(), pk[..., :12].contiguous(), \
            pv[..., :12].contiguous()
    elif kind == "dh_512":
        q, pk, pv = (torch.cat([t] * 32, -1) for t in (q, pk, pv))
    elif kind == "table_int32":
        table = table.int()
    return q, pk, pv, table, pos


@pytest.mark.parametrize("kind", ["q_dtype", "f64", "f16", "pos_int32",
                                  "pool_not_contiguous", "pool_shape",
                                  "dh_12", "dh_512", "table_int32"])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind):
    q, pk, pv, table, pos = _refusal(kind)
    with pytest.raises(ValueError):
        paged_attn_decode(q, pk, pv, table, pos, PAGE)


def test_attn_positions_read_counted_on_the_plain_version():
    """On the CPU the attention reads every slot's every page: the counter
    is the decode steps x slots x pages a slot x the page size; a K/V cache
    counts no latent positions."""
    cfg = get_tiny("deepseek-moe-16b").replace(compute_dtype="float32")
    eng = OnlineEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                       slots=3, page_size=4, max_prompt_len=16,
                       max_new_cap=8)
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, arrival=0.01 * i,
                    prompt=rng.integers(0, cfg.vocab_size, int(n),
                                        dtype=np.int32), max_new=int(m))
            for i, (n, m) in enumerate([(5, 4), (9, 3), (3, 6), (12, 2)])]
    with telemetry.recording():
        eng.run(reqs)
    s = telemetry.summary()
    c = s["counters"]
    steps = s["spans"]["engine.decode"]["count"]
    assert steps > 0
    assert c["attn_positions_read"] == steps * 3 * \
        eng.cache.max_pages_per_slot * 4
    assert "mla_positions_attended" not in c


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.card)])
def test_positions_read_follows_the_wrapper_s_path(device):
    """The kernel reads 0..pos of every slot; its plain version every
    slot's every page."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    table = torch.zeros((5, 7), dtype=torch.int64, device=device)
    pos = np.array([0, 3, 40, 0, 111])
    want = int(pos.sum()) + 5 if device == "cuda" else 5 * 7 * PAGE
    assert positions_read(table, pos, PAGE) == want


# ------------------------------------------------------------- the card
CHAT = dict(S=64, P=96, K=16, G=1, dh=128, dtype=torch.bfloat16)
# the chat shape; GQA (llama3-8b, llava); and the port's other head sizes
# and types: granite (G 3), nemotron (dh 192, G 12), llama3-405b (G 16),
# the tiny configs in float32 (dh 8-24), dh 80 (zamba2's, hubert's:
# 10 chunks of 16 lanes), float32 at dh 192 (two 16-byte chunks a lane)
CARD_CASES = {
    "chat": CHAT,
    "gqa": dict(CHAT, K=8, G=4),
    "granite": dict(S=16, P=12, K=8, G=3, dh=64, dtype=torch.bfloat16),
    "nemotron": dict(S=8, P=10, K=8, G=12, dh=192, dtype=torch.bfloat16),
    "g16": dict(S=8, P=9, K=2, G=16, dh=128, dtype=torch.bfloat16),
    "tiny_f32": dict(S=16, P=6, K=2, G=2, dh=16, dtype=torch.float32),
    "dh8": dict(S=6, P=5, K=2, G=4, dh=8, dtype=torch.bfloat16),
    "dh24_f32": dict(S=6, P=5, K=2, G=2, dh=24, dtype=torch.float32),
    "dh80": dict(S=6, P=7, K=4, G=2, dh=80, dtype=torch.bfloat16),
    "f32_dh192": dict(S=6, P=7, K=2, G=4, dh=192, dtype=torch.float32),
}


def _positions(S, P, seed):
    """Random positions over the table, with 0, the page edges 15 and 16,
    and the last position among them."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, P * PAGE, S)
    for i, p in enumerate((0, 15, 16, P * PAGE - 1)):
        if i < S:
            pos[i] = p
    return pos


@pytest.mark.card
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernel_matches_its_plain_version_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = CARD_CASES[name]
    S, P, dtype = c["S"], c["P"], c["dtype"]
    q, pk, pv, table, pos = _case(S, P, c["K"], c["G"], c["dh"], dtype,
                                  _positions(S, P, 7), device="cuda")
    before = _build.LAUNCHES["paged_attn_decode"]
    got = paged_attn_decode(q, pk, pv, table, pos, PAGE)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_attn_decode"] == before + 1
    assert got.dtype == dtype and got.shape == (S, c["K"] * c["G"] * c["dh"])
    got = got.float()
    f32 = paged_attn_decode_plain(q.float(), pk.float(), pv.float(), table,
                                  pos, PAGE)
    eps = torch.finfo(dtype).eps
    tight = eps * f32.abs() + 1e-5 * float(f32.abs().max())
    assert bool(((got - f32).abs() <= tight).all()), \
        float((got - f32).abs().max())
    twin = paged_attn_decode_plain(q, pk, pv, table, pos, PAGE).float()
    assert float((got - twin).abs().max()) <= \
        4 * eps * float(pv.float().abs().max())


@pytest.mark.card
def test_kernel_replayed_in_a_cuda_graph_equals_its_eager_call():
    """Captured once over static buffers, replayed with new positions
    copied in: each replay equals the eager call on those positions, bit
    for bit (no atomics: the order of the sums is fixed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    S, P, K, G, dh = 12, 8, 4, 2, 128
    q, pk, pv, table, pos = _case(S, P, K, G, dh, torch.bfloat16,
                                  _positions(S, P, 1), device="cuda")
    static_pos = pos.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attn_decode(q, pk, pv, table, static_pos, PAGE)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attn_decode(q, pk, pv, table, static_pos, PAGE)
    for seed in (2, 3, 4):
        new = torch.as_tensor(_positions(S, P, seed)[::-1].copy(),
                              device="cuda")
        static_pos.copy_(new)
        graph.replay()
        want = paged_attn_decode(q, pk, pv, table, new, PAGE)
        torch.cuda.synchronize()
        assert torch.equal(out, want), seed
