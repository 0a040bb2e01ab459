"""The DeepSeek-V2 (latent attention) cell's pieces on the CPU: what its
driver and reference load, the algebra that lets the decode attend the
latent (W_UK absorbed into the query, W_UV after the weighted sum) equal to
the reference's decompressed attention in float64, its FLOPs against
hand-worked numbers, and a tiny run of ``drivers/online_mla.py``, sound
and with a token altered where it is produced."""
import json
import math
import subprocess
import sys

import pytest
import torch

import tiny
from hrmbench import harness, mla
from hrmbench.reference import mla as ref_mla
from hrmbench.reference import model as ref_model

TINY = dict(json.loads((harness.BENCH / "configs" / "deepseek-v2-lite.json")
                       .read_text()),
            name="deepseek-v2-lite-tiny", num_hidden_layers=3,
            hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            intermediate_size=96, vocab_size=256, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_routed_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=32, n_shared_experts=1,
            capacity_factor=4.0, param_dtype="float32",
            compute_dtype="float32")
CELL = dict(tiny.SERVE_CELL, strikes=[
    {"leaf": "embed", "tier": "secded", "bits": 1, "words": 2},
    {"leaf": "blocks/attn/wkv_a", "tier": "secded", "bits": 1, "words": 2},
    {"leaf": "dense_blocks/attn/wkv_b", "tier": "secded", "bits": 2,
     "words": 1},
    {"leaf": "dense_blocks/mlp/wi", "tier": "parity_r", "bits": 1,
     "words": 2},
    {"leaf": "blocks/moe/wo", "tier": "parity_r", "bits": 1, "words": 3},
    {"leaf": "kv_cache/latent", "tier": "parity_r", "bits": 1, "words": 4}])


def test_the_driver_and_reference_load_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
            "from hrmbench import harness, mla;"
            "from hrmbench.drivers import online_mla;"
            "from hrmbench.reference import mla as ref;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_absorbed_attention_is_the_decompressed_in_float64():
    """A layer's attention at the last position: the reference's
    decompressed heads against scores ``[q_nope W_UK^T, q_pe] . [c,
    k_pe]`` over the latent and the sum of latents through W_UV."""
    c = dict(TINY, num_hidden_layers=2)
    stacked = {k: v.double() for k, v in
               mla.make(c, 3, "cpu")["dense_blocks"]["attn"].items()}
    aw = {k: v[0] for k, v in stacked.items()}
    S, H, R = 13, c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    h = torch.randn(S, c["hidden_size"], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    want = ref_mla._attention(stacked, 0, h, c, ref_model.FLOAT64)[-1]
    pos = torch.arange(S)
    freqs = ref_mla.yarn_freqs(c, torch.float64)
    q = (h[-1] @ aw["wq"]).view(H, dn + dr)
    ckv = h @ aw["wkv_a"]
    lat = ref_model.rmsnorm(ckv[:, :R], aw["kv_norm"], c["rms_norm_eps"])
    k_pe = ref_mla.rope(ckv[:, None, R:], pos, freqs)[:, 0]
    q_pe = ref_mla.rope(q[None, :, dn:], pos[-1:], freqs)[0]
    wkv_b = aw["wkv_b"].view(R, H, dn + dv)
    q_lat = torch.einsum("hd,rhd->hr", q[:, :dn], wkv_b[..., :dn])
    s = (q_lat @ lat.T + q_pe @ k_pe.T) * ref_mla.softmax_scale(c)
    o_lat = torch.softmax(s, -1) @ lat                       # (H, R)
    o = torch.einsum("hr,rhd->hd", o_lat, wkv_b[..., dn:])
    got = o.reshape(-1) @ aw["wo"]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_flops_by_hand():
    # 2 layers (1 dense), D 8, 2 heads, R 4, nope 2, rope 2, v 2, 4
    # experts of 3 top-2, 1 shared, dense width 5, vocabulary 10
    c = {"num_hidden_layers": 2, "first_k_dense_replace": 1,
         "hidden_size": 8, "num_attention_heads": 2, "kv_lora_rank": 4,
         "qk_nope_head_dim": 2, "qk_rope_head_dim": 2, "v_head_dim": 2,
         "n_routed_experts": 4, "num_experts_per_tok": 2,
         "moe_intermediate_size": 3, "n_shared_experts": 1,
         "intermediate_size": 5, "vocab_size": 10}
    # a layer's projections: wq 2*8*8=128, wkv_a 2*8*6=96, wkv_b
    # 2*4*8=64, wo 2*4*8=64 -> 352; dense FFN 3*2*8*5=240; MoE: router
    # 64 + routed 2*3*2*8*3=288 + shared 144 -> 496
    assert mla.token_flops(c) == 2 * 352 + 240 + 496
    assert mla.head_flops(c) == 160
    # prefill of 3: decompressed heads of 2*(2+2+2) a position, 6 of them
    assert mla.prefill_flops(c, 3) == 3 * 1440 + 2 * 2 * 2 * 6 * 6 + 160
    # 2 decoded tokens over 11 positions: latent heads of 2*(4+2+4)
    assert mla.decode_flops(c, 2, 11) == 2 * (1440 + 160) \
        + 2 * 2 * 2 * 10 * 11


def test_parent_without_mla_fails_at_import(monkeypatch):
    import repro_torch.configs.base as base
    monkeypatch.delattr(base, "MLAConfig")
    monkeypatch.delitem(sys.modules, "hrmbench.drivers.online_mla",
                        raising=False)
    with pytest.raises(ImportError, match="latent attention"):
        harness.driver("online_mla")


def _run():
    """Loaded so that every slot serves (the fault below breaks slot 0)."""
    from hrmbench.drivers import online_mla
    cell = dict(CELL, sample_tokens=80,
                limits={"served_gap_mean": 1e-3, "served_tokens_judged": 80})
    return online_mla.run(tiny.context(
        TINY, cell, dict(tiny.CHAT_MIX, rate=400.0), seconds=0.6))


def test_a_sound_tiny_run_is_correct():
    rec = _run()
    assert all(c["ok"] for c in harness.check_rows(rec)), rec["checks"]
    assert rec["kv_pool_bytes"] > 0 and rec["strikes"]["got"] == \
        rec["strikes"]["want"]


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serve import engine
    orig = engine.latent_decode_step

    def step(*a, **k):
        nxt, ok = orig(*a, **k)
        nxt = nxt.clone()
        nxt[0] = (nxt[0] + 1) % TINY["vocab_size"]
        return nxt, ok
    monkeypatch.setattr(engine, "latent_decode_step", step)
    rec = _run()
    assert not all(c["ok"] for c in harness.check_rows(rec))


def test_prefill_flops_count_the_causal_half():
    n = 4096
    c = json.loads((harness.BENCH / "configs" / "deepseek-v2-lite.json")
                   .read_text())
    attn = mla.prefill_flops(c, n) - n * mla.token_flops(c) \
        - mla.head_flops(c)
    assert attn == pytest.approx(7 * 2 * 16 * 320 * n * (n + 1) / 2)
    assert math.isclose(mla.decode_flops(c, 1, 1) - mla.token_flops(c)
                        - mla.head_flops(c), 7 * 2 * 16 * 1088)
