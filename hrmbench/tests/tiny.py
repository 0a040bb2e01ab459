"""Tiny configurations and cells for the CPU tests."""
import time

import torch

from hrmbench import harness

DEEPSEEK = {
    "name": "deepseek-moe-16b-tiny", "family": "moe", "n_layers": 2,
    "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 64,
    "vocab_size": 256, "act": "swiglu", "rope_theta": 10000.0,
    "norm_eps": 1e-6, "param_dtype": "float32", "compute_dtype": "float32",
    "moe": {"n_experts": 8, "top_k": 2, "d_expert": 64, "n_shared": 1,
            "capacity_factor": 4.0}}
GRANITE = {
    "name": "granite-moe-3b-a800m-tiny", "family": "moe", "n_layers": 2,
    "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 64,
    "vocab_size": 256, "act": "swiglu", "rope_theta": 10000.0,
    "norm_eps": 1e-6, "param_dtype": "float32", "compute_dtype": "float32",
    "moe": {"n_experts": 8, "top_k": 2, "d_expert": 64, "n_shared": 0,
            "capacity_factor": 4.0}}
CHAT_MIX = {"process": "bursty", "rate": 40.0, "burst_mult": 8.0,
            "p_enter_burst": 0.05, "p_exit_burst": 0.3, "arrival_seed": 3,
            "prompt_len_choices": [8, 16], "prompt_len_weights": [1, 1],
            "max_new_choices": [4, 8], "max_new_weights": [1, 1]}
DOCS_MIX = {"process": "batch", "n_requests": 40,
            "prompt_len_choices": [32, 64], "prompt_len_weights": [1, 1],
            "max_new_choices": [2, 4], "max_new_weights": [1, 1]}
CAMPAIGN_MIX = {"batch": 2, "seq": 16, "trials_per_chunk": 2}
SERVE_CELL = {"slots": 4, "page_size": 8, "prefills_per_step": 2,
              "policy": "detect_recover_l", "kv_tier": "parity_r",
              "trace_s": 0.5, "sample_tokens": 20,
              "strikes": [
                  {"leaf": "embed", "tier": "secded", "bits": 1, "words": 3},
                  {"leaf": "blocks/norm1", "tier": "secded", "bits": 1,
                   "words": 1},
                  {"leaf": "blocks/attn/wo", "tier": "secded", "bits": 2,
                   "words": 2},
                  {"leaf": "blocks/moe/wi", "tier": "parity_r", "bits": 1,
                   "words": 3},
                  {"leaf": "blocks/moe/shared/wo", "tier": "parity_r",
                   "bits": 1, "words": 1},
                  {"leaf": "kv_cache/k", "tier": "parity_r", "bits": 1,
                   "words": 2},
                  {"leaf": "kv_cache/v", "tier": "parity_r", "bits": 1,
                   "words": 2}],
              "limits": {"served_gap_mean": 1e-3, "served_tokens_judged": 20}}
CAMPAIGN_CELL = {"kind": "campaign", "trace_s": 0.5, "sample_trials": 3,
                 "sample_within": 8,
                 "limits": {"logit_error_row_median_max": 1e-3, "trials": 8,
                            "positions_judged": 64}}


def context(config, cell, mix, *, seconds=1.0, trace=False, seed=12345,
            control=False):
    return harness.Context(name="tiny", cell=cell, config=config, mix=mix,
                           seed=seed, seconds=seconds, trace=trace,
                           device=torch.device("cpu"),
                           t0=time.perf_counter(), control=control)
