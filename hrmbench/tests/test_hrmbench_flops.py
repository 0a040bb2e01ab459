"""The frozen yardstick against hand-worked numbers."""
import pytest

from hrmbench import flops

# d_model 8, 2 heads of 4, 1 KV head, 4 experts of width 3, top-2, one
# shared expert, vocabulary 10, 2 layers
C = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
     "vocab_size": 10, "moe": {"n_experts": 4, "top_k": 2, "d_expert": 3,
                               "n_shared": 1}}


def test_token_flops_by_hand():
    # projections: q 2*8*8=128, k and v 2*2*8*4=128, o 2*8*8=128 -> 384
    # router 2*8*4=64; routed 2*3*2*8*3=288; shared 3*2*8*3=144 -> 496
    assert flops.token_flops(C) == 2 * (384 + 496)


def test_attention_head_prefill_decode_query_by_hand():
    assert flops.attn_flops(C, 1) == 2 * 4 * 2 * 4           # 64
    assert flops.head_flops(C) == 2 * 8 * 10                  # 160
    # a prefill of 3: 3 tokens, 1+2+3 attended positions, one head
    assert flops.prefill_flops(C, 3) == 3 * 1760 + 6 * 64 + 160
    # 2 tokens decoded attending 5 and 6 positions
    assert flops.decode_flops(C, 2, 11) == 2 * (1760 + 160) + 11 * 64
    # a query of 2 x 3: every position's logits
    assert flops.query_flops(C, 2, 3) == 2 * (3 * (1760 + 160) + 6 * 64)


def test_dense_token_flops_and_kernel_bytes():
    dense = dict(C, moe=None, d_ff=5)
    assert flops.token_flops(dense) == 2 * (384 + 3 * 2 * 8 * 5)
    assert flops.KERNEL_BYTES_PER_ROW == {"parity_encode": 2080,
                                          "parity_check": 2116}


def test_peaks_of_the_h100_and_no_others():
    kind = "NVIDIA H100 80GB HBM3"
    assert flops.peak(kind, "bf16_flops_per_s") == pytest.approx(989e12)
    assert flops.peak(kind, "hbm_bytes_per_s") == pytest.approx(3.35e12)
    assert flops.peak("cpu", "bf16_flops_per_s") is None
