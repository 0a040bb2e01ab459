#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for ``sm_90a``) and
``nvcc``; it exits non-zero, printing no result, without them. In order:

1. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, bit for
   bit, on 8 Mi random words with single-, double-, triple-bit, adjacent
   and check-bit strikes; then the conformance sweeps: every 1- and 2-bit
   pattern over DEC-TED's 79 codeword bits corrected, 4096 sampled 3-bit
   patterns flagged and none miscorrected, every BURST single and adjacent
   data pair corrected, and the BCH(72,64) t=1 code through the same BCH
   kernel;
3. drives the ``MemoryDomain`` main path (protect, inject, scrub, recover)
   at llama3-8b's full width with its depth cut to 8 layers, plus a KV
   cache, under the paper's design points and the strong-ECC
   ``dected_server`` and ``burst_dr_l``, and a hard-error retirement drill;
   checks the restored payload bit for bit, that an adjacent-burst storm on
   one DEC-TED and one BURST leaf is healed by ``scrub`` alone, and that
   each of these seven paths, its launches counted on their own, ran every
   kernel its tiers need;
3b. holds each kernel against its plain version, bit for bit, on every
   tier buffer those design points build (up to 6.66 GB), struck with
   single-, double- and check-bit errors; then profiles one warm scrub per
   tier mix;
4. times each kernel at its design point's full tier-buffer shape with
   CUDA events, beside its bound (the bytes it must move over the memory
   rate), the popcount limit of this implementation (its popcounts over
   the popcount rate) and its plain version's time; the bit-flip kernel,
   whose call time is host time, also by its device time alone (launches
   replayed from a CUDA graph); then the paged decode attention kernel
   (``kernels/paged_attn.py``, no Pallas site) at the chat cell's shapes
   and its mix's positions: held against its plain version computed in
   float32, its device time from launches replayed in a CUDA graph, its
   byte bound at those positions and the plain version's time;
5. measures the per-tier outcome rates (``core.eccmeasure``) of PARITY_R,
   SECDED, DECTED, BURST and MIRROR through the kernels, holds them equal
   to the same measurement on the CPU (the plain versions), and prints the
   Fig. 5 cost and availability rows with them;
6. the graph workload: holds the push, blocked-push and frontier kernels
   against their plain versions on 8 Mi edges (a hub of 10**6 in-edges,
   sentinel padding, struck ids and block tables; integer x bit for bit,
   float32 x within the stated tolerance), the pushes also on edge arrays
   from edge 1, cut short of whole groups and on different alignments,
   tiles of 100 edges and tiles that drop every edge; builds the Graph500
   scale-22
   graph (``powerlaw_graph(2**22, avg_degree=16)``) dense and in
   65,536-node blocks on the card, holds the kernels again on those
   tensors, then drives PageRank (dense, blocked), BFS (dense,
   frontier-sparse) and the scrubbed drills under ``detect_recover_l``,
   each path's launches counted on their own, against the plain versions'
   run and scipy's BFS; times the three kernels beside their byte bound,
   their plain versions and ``index_add_``, splits each push's call into
   its device events (memset, push, round) under ``torch.profiler``,
   counts the float64 atomics each push issues there, and prints the
   card's PageRank edges/s, sparse-BFS speedup and scrub-overlap
   overhead;
7. the Fig. 2 campaign (``core.characterize.run_campaign``) on the three
   applications at their real sizes, each path's launches counted on
   their own: the web-search LM (phase 3's llama3-8b parameters, the
   query the greedy tokens of ``lm_batch(cfg, 4, 256)``), the full
   kvstore-demo (a 2**20-key value table) and PageRank's top-8 on phase
   6's dense scale-22 state, 64, 64 and 32 trials of each error kind
   (three queries a hard trial). Before each, three clean re-runs must
   give the golden tokens bit for bit and a bit flipped twice must
   classify as masked; after the LM campaign its first 16 trials are
   re-run with the plain bit flip and must give the same outcomes. Each
   prints its Fig. 3 and Fig. 4 rows, trials per second and ms per trial
   split into strike (pack, flip, unpack), query and classify. Then
   ``python -m repro_torch.launch.explore --workload all --design all
   --measure`` runs in this process, its ECC rates measured anew. Then the
   trace engine: ``core.tracegen`` writes one server-month, and
   ``run_trace_campaign`` replays it twice on the full kvstore-demo, with
   equal outcomes; ``explore --workload all --trace`` prints the same text
   on the card as on the CPU; and the tiny kv-store's measured explorer
   rows on the card are set beside the CPU's (the first trial whose
   outcome differs is named, not failed: the two devices round the bf16
   forward differently);
8. serving at llama3-8b's full width (phase 3's 8-layer parameters):
   ``serve_batch`` over 8 prompts of 512 tokens, 128 new tokens, with no
   policy and under ``typical_server``, ``detect_recover`` and
   ``detect_recover_l`` (scrub every 16 tokens, 0.5 strikes a token, seed
   9), each also at error rate 0, where every policy's tokens must equal
   the unprotected run's; the first 16 decode positions' logits held
   against a ``forward`` over prompt and generated tokens; ``injected``
   equal to the strikes the loop's stream draws; under ``typical_server``
   every single-bit strike before the last scrub corrected and every
   double detected. Prints prefill ms, the median ms per decoded token,
   tokens/s, the scrub and inject ms inside the loop and peak memory,
   and splits one decode step's time under ``torch.profiler``.

9. training (``runtime.train_loop.run_training``), each run's launches
   counted on their own: (a) tiny lm-100m in ``tests/test_substrate.py``'s
   ``detect_recover`` scenario on the card and on the CPU from one seed,
   counters and events equal, losses within TINY_LOSS_RTOL; (b)
   ``examples/train_hrm.py``'s scenario at lm-100m's full config (12
   layers, d_model 512, vocab 32768, 84 M float32 parameters), 100 steps
   of batch 8 x 256 under ``detect_recover`` with 0.2 strikes a step (30 %
   hard), a scrub every 10 steps, a checkpoint every 25 and a node failure
   at step 60: one restart and the strikes its stream draws, run first
   with the example's seed 0 and, when that stream flips a parameter's
   top exponent bit (it does: ``params/head`` at step 17, after which no
   loss is finite, as in the reference), again with the first seed whose
   stream does not, where the loss must fall and every loss be finite;
   (c) ``detect_recover_l`` over params and optimizer moments at 1.0
   strikes a step, a scrub every 2 steps: SEC-DED corrects; then at error
   rate 0, under deterministic algorithms, the losses under
   ``typical_server``, ``detect_recover`` and ``detect_recover_l`` equal
   the unprotected run's bit for bit; (d) the checkpoint store on the card:
   the full train state (1.0 GB) saved and loaded bit for bit, and
   ``clean_copy`` falling back past a corrupted newest snapshot to the
   older one's bytes; (e) the median ms of a train step and of the scrub,
   refresh + reassert and strike inside the loop, peak memory, a profiled
   warm step (device-busy and idle share, device operations a step, top
   kernels) and the scrub overhead at intervals 10 and 20, (scrub ms +
   interval x refresh ms) / (interval x step ms); (f) llama3-8b's full
   width with 2 of its 32 layers (1.49 B bf16 parameters, float32
   moments), batch 4 x 512, ``typical_server`` on the parameters, 3 steps
   of ``make_train_step`` and ``MemoryDomain`` in the loop's stage order
   (strike, scrub, step, refresh) but not through ``run_training``, which
   saves a 15 GB snapshot at step 0. Snapshots go to a temporary directory
   outside the repository.

10. the online serving plane (``repro_torch.serve``), each pass's
   launches counted on their own: (a) ``benchmarks/serve_slo.py``'s
   golden and 540-error storm passes (40 bursty requests at 16/s, seed 7,
   4 slots of 8-token pages, ``detect_recover`` + KV ``parity_r``, a
   params scrub every 4 iterations) on tiny llama3-8b in float32 compute,
   on the card and on the CPU from one seed: reports and tokens equal at
   zero injection, counters equal under the storm unless a crash reset
   fired on one device only (then named, not failed); (b) llama3-8b's
   full width with phase 3's 8-layer parameters, 16 slots of 16-token
   pages (641 pages, two 168 MB pools), 64 bursty requests at 8/s
   (prompts 128/256/512, 32/64/128 new tokens), a golden and a 540-error
   storm pass under the model clock with ``debug_invariants`` under each
   of ``detect_recover`` + ``parity_r``, ``typical_server`` + ``secded``
   and ``detect_recover`` + ``parity_r`` with peer recovery: every
   request completed or shed, 540 strikes, under ``typical_server`` the
   params words struck once corrected and those struck twice flagged
   (counted between scrubs and crash resets), under peer recovery no
   disk reload; availability printed against 99.90 % and the incorrect
   rate against the golden pass; (c) in the first golden pass, the first
   16 decode steps' logits against ``decode_step`` (batch 1) on each
   active slot's gathered pages, tokens equal where the top-2 margin
   exceeds the difference, and four requests' tokens beside a solo
   ``serve_batch`` (mismatches counted); (d) a storm pass on the wall
   clock: requests/s, tokens/s, TTFT and TPOT p50/p99, the median ms of
   a decode step, of a prefill at each prompt length, of the KV access
   check and of the write-path refresh, their share of the decode step,
   peak memory; and four iterations of (b)'s ``detect_recover`` storm
   pass split under ``torch.profiler``.

11. sharded domains (``core.sharded.ShardedMemoryDomain``) and the port's
   example entry points, after phase 3's state is released, each path's
   launches counted on their own: (a) tiny llama3-8b as 2 replicas x 3
   shards under ``typical_server`` and ``peer_dr_l`` on the card and on
   the CPU from one seed: partitions, strikes, per-shard and merged
   reports, recovery events and restored bytes equal; (b) llama3-8b at
   its full config (32 layers, 8.03 B bf16 parameters, 16.06 GB; nothing
   cut) under ``peer_dr_l`` as 2 replicas x 4 shards (virtual): the
   per-shard bytes; single-bit plans on the 4 largest leaves of replica
   0 and of an unsharded ``MemoryDomain`` over the same tensors, merged
   reports equal path by path; ``examples/sharded_domain.py``'s 3
   strikes (seed 7) recovered by ``peer_copy`` from replica 1, bit-exact,
   a second scrub (0, 0); a leaf struck on both replicas reloaded from
   the clean copy (the untouched parameters); ``retire_after`` strikes of
   one leaf retiring its block under ``replica0/<path>``; (c)
   ``typical_server`` on 1 replica x {2, 4, 8} shards: a single-bit
   strike corrected, a double-bit strike flagged, one warm scrub's time
   and peak memory (the unsharded scrub is not run; its reckoning is
   printed); (d) the median wall ms of 5 warm calls of scrub, a 3-strike
   inject, recover and refresh, sharded (2 x 4) and unsharded, with each
   scrub's peak, ``physical_stats()`` and the sidecar overhead; (e) the
   examples ``quickstart``, ``serve_kv``, ``graph_pagerank``,
   ``train_hrm --small``, ``characterize`` (also ``--trace`` over a
   ``tracegen`` month) and ``sharded_domain --placement virtual`` on the
   card, each ending in its OK line, after the mesh placement has raised
   for want of 8 cards.

12. the MoE, hybrid (Mamba2) and xLSTM families, after phase 11, each
   path's launches counted on their own (``families_*``): (a) tiny
   granite-moe-3b-a800m, deepseek-moe-16b, zamba2-2.7b and xlstm-350m in
   float32 compute on the card and on the CPU from one seed: parameters
   equal bit for bit, ``forward`` logits and ``aux`` and 16
   ``decode_step`` logits within FAMILY_TINY_REL, ``serve_batch`` tokens
   and report equal under detect_recover with strikes, and tiny
   granite's 32-trial campaign equal trial by trial; (b) ``serve_batch``
   on granite-moe-3b-a800m, zamba2-2.7b and xlstm-350m whole and
   deepseek-moe-16b at full width with 4 of its 28 layers, phase 8's
   prompts, new tokens and strikes under typical_server and
   detect_recover, after decode is held against ``forward`` (MoE at a
   capacity factor that drops nothing): sizes, prefill ms, ms per token,
   tokens/s, peak memory, strikes drawn, corrected and flagged (every
   single-bit strike corrected under typical_server), sidecar overhead;
   (c) ``OnlineEngine`` on granite-moe-3b-a800m whole with phase 10's
   plane, trace and 540-error storm under detect_recover + parity_r
   (golden and storm passes, every request completed or shed,
   availability against 99.90 %), and at a no-drop capacity the first
   16 paged decode steps against ``decode_step`` on each slot's gathered
   pages; (d) the Fig. 2 campaign on granite-moe-3b-a800m and zamba2-2.7b
   whole, 32 single-error soft trials in each region (experts, attn,
   embed, norm; ssm, attn, mlp) after the determinism check: masked,
   incorrect and crash shares.

13. the audio and vision frontends, after phase 12, each path's launches
   counted on their own (``frontends_*``): (a) tiny hubert-xlarge and
   llava-next-mistral-7b in float32 compute on the card and on the CPU
   from one seed: parameters equal bit for bit, ``forward`` logits and
   (llava) 16 ``decode_step`` logits after a patch-prefixed prefill
   within FAMILY_TINY_REL, a 32-trial campaign equal trial by trial; (b)
   hubert-xlarge whole (48 layers, 946 M float32 parameters): 32 encoder
   queries (the greedy cluster id of each of 8 x 500 frames) under
   typical_server and detect_recover with phase 8's strike stream and a
   scrub between queries (every single-bit strike corrected under
   typical_server), ms per query, frames/s, peak memory; then 4
   ``run_training`` steps at batch 4 x 500 under typical_server with a
   scrub every 2 steps, ms per step and scrub overhead; (c)
   llava-next-mistral-7b at full width with 8 of its 32 layers:
   ``make_prefill_step`` on 2,880 patches + 512 tokens at batch 4, then
   128 ``make_serve_step`` tokens under typical_server and
   detect_recover with phase 8's strikes (``serve_batch`` takes tokens
   only, as the reference's does), after decode is held against
   ``forward`` on the extended sequence; 16 paged decode steps on a
   ``PagedKVCache`` of the VLM held against batch-1 ``decode_step`` on
   each slot's gathered pages; (d) the Fig. 2 campaign on hubert whole
   and llava at 8 layers, 32 single-error soft trials in each of the
   embed (frame or patch projection, embedding, head), attn, mlp and
   norm regions after the determinism check.

14. the 72-405 B dense configs and llava whole, after phase 13, each
   path's launches counted on their own (``dense_large_*``): (a) tiny
   qwen2-72b, nemotron-4-340b and llama3-405b in float32 compute on the
   card and on the CPU from one seed: parameters equal bit for bit,
   ``forward`` logits and 16 ``decode_step`` logits within 1e-5 x
   max|logit|, ``serve_batch`` on tiny qwen2-72b under detect_recover
   with strikes (tokens and report equal), and the per-group MoE dispatch
   (``_moe_apply_local``) at 1, 2 and 4 data groups on tiny
   granite-moe-3b-a800m; (b) at full width, qwen2-72b with 6 of its 80
   layers, llama3-405b with 1 of 126, nemotron-4-340b with 1 of 96 and
   llava-next-mistral-7b whole (32 layers): decode held against
   ``forward`` within 8 bf16 ulps, and a planted fault (every decode
   position one early) read beyond them, a clean run of 32 tokens after a
   prefill of 4 x 128 tokens (llava: 2,880 patches + 128 tokens), llava
   also under detect_recover as 1 replica x 8 shards (two strikes
   flagged, reloaded from the clean copy bit-exact); then
   ``ShardedMemoryDomain`` under typical_server, 1 replica x 8 shards: a
   single-bit strike corrected and a double-bit strike flagged, one warm
   scrub's time, resident bytes and peak, and the same 32 tokens from
   ``state(0)`` under phase 8's strike stream with a scrub every 8 tokens
   and one after the last (every single-bit strike corrected, every
   double-bit one flagged; the tokens beside the clean run's), ms per
   token and tokens/s; after the last scrub the payload equal bit for bit
   to the parameters made again from the seed, and a decode from it equal
   to the clean run's tokens; (c) host
   only: each registry config at its full size from ``meta`` shapes,
   placed by ``sharding.rules`` on ``AbstractMesh`` SINGLE_POD and
   MULTI_POD, with FSDP and ``tp_only``: one device's share of the
   parameters and of the parameters plus moments, beside the card's
   memory.
15. the last slice, after phase 14 (``legacy_*`` and ``elastic_store``
   launch paths): three dry-run cells start first, each in a host process
   of its own with the card hidden, and run beside (a) and (b). (a) The
   legacy per-leaf API (``build_sidecar``, ``scrub``, ``Injector``,
   ``Scrubber``, ``RecoveryManager``) at llama3-8b's full width with 2 of
   its 32 layers under typical_server, detect_recover_l and a DEC-TED /
   BURST policy: a single-bit hard strike from the Injector's seed into
   every leaf, the scrub, a Scrubber at stride 1 and 4, and the
   RecoveryManager's reloads; held against the same shims run with the
   kernels' plain versions on the card (sidecars, reports, passes and
   events equal, leaves bit-equal, no launch), against ``MemoryDomain``'s
   verbs on the same strikes (the same corrections), and restored bit
   for bit; then the per-leaf scrub's wall ms beside the domain's
   tier-batched scrub. (b) lm-100m's train state through the hardened
   store (its staging scrub on the parity kernels) onto a ``(1, 1)`` CUDA
   ``DeviceMesh`` over a world-size-1 NCCL group: the newest snapshot
   struck on disk, ``load(shardings=state_shardings(...))`` falling back
   to the older one and placing it as DTensors, and one
   ``relower_train_step`` step bit-equal to the unsharded step under
   deterministic algorithms; with two or more cards, the reshard drill of
   ``repro_torch.examples.elastic_reshard`` across them. (c) The dry-run
   cells ``llama3-8b`` ``train_4k`` and ``decode_32k`` and
   ``deepseek-moe-16b`` ``train_4k`` at SINGLE_POD on a fake 256-rank
   mesh: per-device FLOPs beside the model FLOPs, collective link bytes
   by kind, the roofline terms on the H100's published rates beside the
   card's name and power limit, and each cell's wall seconds.

Phase 3c holds the port's random draws (tiny llama3-8b and kvstore-demo
parameters, the kv-store's query keys, the four tiny MoE, hybrid and
xLSTM configs' parameters and 2**20 ``Stream.normal`` draws) made on the
card equal to those made on the CPU, bit for bit.

Its last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON: ``launches`` sums the main paths' counts, which
``launches_by_path`` lists. Any failure raises.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS reads its workspace setting once, at its first product; phase 9's
# bit-equality check runs under deterministic algorithms, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak
# 32-bit popcounts per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput)
POPC_PER_CLOCK_PER_SM = 16
SEED = 0
CHECK_ROWS = 32768             # 8 Mi words per kernel check
N_LAYERS = 8                   # of llama3-8b's 32: the depth driven here
KV_BATCH, KV_SEQ = 8, 4096
STRIKES = 64
DESIGN_POINTS_RUN = ("typical_server", "detect_recover", "detect_recover_l",
                     "mirror_dr_l", "dected_server", "burst_dr_l")
STORM_BURSTS = 64              # adjacent bursts on one DEC-TED / BURST leaf
TRIPLES = 4096                 # sampled 3-bit patterns in the DEC-TED sweep
CSRC = "src/repro_torch/kernels/csrc/"
# kernel -> (source, Pallas call it replaces)
KERNELS = {
    "secded_encode": (CSRC + "secded.cu", "src/repro/kernels/secded.py:87"),
    "secded_scrub": (CSRC + "secded.cu", "src/repro/kernels/secded.py:111"),
    "parity_encode": (CSRC + "parity.cu", "src/repro/kernels/parity.py:52"),
    "parity_check": (CSRC + "parity.cu", "src/repro/kernels/parity.py:71"),
    "bitflip": (CSRC + "bitflip.cu", "src/repro/kernels/bitflip.py:57"),
    "bch_encode": (CSRC + "bch.cu", "src/repro/kernels/bch.py:338"),
    "bch_scrub": (CSRC + "bch.cu", "src/repro/kernels/bch.py:363"),
    "burst_encode": (CSRC + "burst.cu", "src/repro/kernels/burst.py:143"),
    "burst_scrub": (CSRC + "burst.cu", "src/repro/kernels/burst.py:167"),
    "segsum_push": (CSRC + "segsum.cu", "src/repro/kernels/segsum.py:145"),
    "segsum_push_blocked": (CSRC + "segsum.cu",
                            "src/repro/kernels/segsum.py:278"),
    "frontier_update": (CSRC + "segsum.cu",
                        "src/repro/kernels/segsum.py:368"),
}
GRAPH_KERNELS = ("segsum_push", "segsum_push_blocked", "frontier_update")
GRAPH_SCALE = 22               # Graph500 problem scale: 2**22 vertices
GRAPH_DEGREE = 16              # Graph500 edge factor
GRAPH_NODE_BLOCK = 65536
PR_ITERS = 20
SCRUB_ITERS, SCRUB_SLICES = 16, 8
PUSH_CHECK_EDGES = 1 << 23     # 8 Mi edges per push-kernel check
HOT_EDGES = 10 ** 6            # in-edges of the checks' hot destination
# edges a warp of the push kernels sums before its atomics: 32 lanes x
# kEdges (8) in csrc/segsum.cu; their one-edge-a-thread forerunner, 32
PUSH_WARP_EDGES, ONE_EDGE_WARP_EDGES = 256, 32
BITFLIP_GRAPH_LAUNCHES = 100   # bit-flip launches captured in one CUDA graph
CAMPAIGN_BATCH, CAMPAIGN_SEQ = 4, 256   # the web-search LM's query
LM_TRIALS, KV_TRIALS, GRAPH_TRIALS = 64, 64, 32   # per error kind
HARD_REPEAT = 3                # queries of a hard trial
GRAPH_CAMPAIGN_ITERS = 12
DETERMINISM_RERUNS = 3
PLAIN_FLIP_TRIALS = 16
TRACE_SEED = 0                 # tracegen's seed for the server-month
EXPLORE_KV_TRIALS = 20         # the explorer's --measure default
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 512, 128
SERVE_POLICIES = (None, "typical_server", "detect_recover",
                  "detect_recover_l")
# examples/serve_kv.py's error rate and seed, its scrub interval scaled to
# the longer run
SERVE_SCRUB_INTERVAL, SERVE_ERROR_RATE, SERVE_SEED = 16, 0.5, 9
# phase 4: the paged decode attention at the chat cell's shapes
# (hrmbench deepseek-moe-16b.chat: 64 slots of 96 16-token pages, 16 KV
# heads of 128, one query head each, bfloat16), half the slots held
# (decode_slot_use.chat ~50 %) at the chat mix's positions: a prompt of
# 128/256/512/1024 tokens (0.4/0.3/0.2/0.1) and part of an answer of
# 64/128/256/512 (the same weights)
PA_SLOTS, PA_PAGES, PA_PAGE, PA_KV_HEADS, PA_GROUP, PA_HEAD = \
    64, 96, 16, 16, 1, 128
PA_HELD = 32
PA_LENS, PA_WEIGHTS = (128, 256, 512, 1024), (0.4, 0.3, 0.2, 0.1)
PA_NEW = (64, 128, 256, 512)
PA_GRAPH_LAUNCHES = 20
SERVE_KERNELS = {"secded_encode", "secded_scrub", "parity_encode",
                 "parity_check", "bitflip"}
LOGIT_CHECK_TOKENS = 16
# phase 10: the online plane at llama3-8b's full width (phase 3's
# parameters): 16 slots of 16-token pages, 40 pages a slot for a 512-token
# prompt and 128 new tokens, 641 pages (two pools of 168 MB); 64 requests
# of bursty traffic; one server-month's errors compressed into each storm
ONLINE_SLOTS, ONLINE_PAGE, ONLINE_PREFILLS = 16, 16, 2
ONLINE_PROMPTS, ONLINE_NEW = (128, 256, 512), (32, 64, 128)
ONLINE_REQUESTS, ONLINE_RATE, ONLINE_BURST, ONLINE_SEED = 64, 8.0, 8.0, 7
ONLINE_STORM, ONLINE_SCRUB = 540, 4
ONLINE_CONFIGS = (("detect_recover", "parity_r", False),   # (policy, KV
                  ("typical_server", "secded", False),      # tier, peer
                  ("detect_recover", "parity_r", True))     # recovery)
AVAILABILITY_BAR = 0.9990      # the paper's single-server bar
# (a): benchmarks/serve_slo.py's plane on tiny llama3-8b
SLO_REQUESTS, SLO_RATE, SLO_SLOTS, SLO_PAGE, SLO_SCRUB = 40, 16.0, 4, 8, 4
PAGED_CHECK_STEPS, SOLO_CHECK_REQUESTS = 16, 4
ONLINE_PROFILE_AT, ONLINE_PROFILE_ITERS = 300, 4
DECODE_PROFILE_STEPS = 8
# phase 9: examples/train_hrm.py's scenario at lm-100m's full config, cut
# from its 300 steps to 100
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 100
TRAIN_SCRUB, TRAIN_RATE, TRAIN_HARD, TRAIN_CKPT = 10, 0.2, 0.3, 25
TRAIN_FAIL_AT = int(TRAIN_STEPS * 0.6)
DRL_STEPS, DRL_RATE, DRL_SCRUB = 20, 1.0, 2     # detect_recover_l on opt
ZERO_STEPS, ZERO_SCRUB = 10, 2                  # the error-rate-0 runs
ZERO_POLICIES = (None, "typical_server", "detect_recover",
                 "detect_recover_l")
TRAIN_PROFILE_STEPS = 4
OVERHEAD_INTERVALS = (10, 20)
# (a): tests/test_substrate.py's detect_recover scenario, card vs CPU; bf16
# products rounded in another order on each device over 14 steps (measured
# 9.1e-4 on an H100, so about three times that)
TINY_LOSS_RTOL = 3e-3
LLAMA_TRAIN_LAYERS, LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ = 2, 4, 512
LLAMA_TRAIN_STEPS = 3
STAGING_KERNELS = {"parity_encode", "parity_check"}  # the store's scrub
# phase 11: sharded domains at llama3-8b's full config (32 layers, nothing
# cut) and the port's example entry points
SHARD_TINY = (2, 3)            # (a) replicas x shards, card vs CPU
SHARD_FULL = (2, 4)            # (b), (d): peer_dr_l, as examples/sharded_domain
SHARD_COUNTS = (2, 4, 8)       # (c): typical_server on one replica
SHARD_STRIKES, SHARD_SEED = 3, 7   # examples/sharded_domain.py's strikes
SHARD_PLAN_LEAVES = 4          # plan strikes on the largest leaves
SHARD_DRILL_LEAF = "blocks/attn/wk"
SHARD_RETIRE_AFTER = 3
VERB_REPS = 5
# phase 12: the MoE, hybrid and xLSTM families at full width
FAMILY_ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b", "zamba2-2.7b",
                "xlstm-350m")
# deepseek-moe-16b whole is 33.8 GB of bf16 parameters and the scrub holds
# about five copies of a payload: at 4 of its 28 layers it is 5.5 GB
FAMILY_DEPTH = {"deepseek-moe-16b": 4}
FAMILY_POLICIES = ("typical_server", "detect_recover")
FAMILY_NO_DROP = 16.0          # MoE capacity factor at which nothing drops
# (a): tiny configs card vs CPU in float32; products summed in other
# orders on each device
FAMILY_TINY_REL, FAMILY_TINY_TOKENS, FAMILY_DECODE_STEPS = 1e-4, 40, 16
FAMILY_TINY_TRIALS = 16        # per error kind: 32 trials
FAMILY_ONLINE_ARCH = "granite-moe-3b-a800m"
FAMILY_CHECK_REQUESTS = 16     # (c): the no-drop paged check's trace
FAMILY_REGION_TRIALS = 32      # (d): single-error soft trials a region
NORMAL_DRAWS = 1 << 20         # phase 3c: Stream.normal card vs CPU
FAMILY_REGIONS = {
    "granite-moe-3b-a800m": ("params/experts", "params/attn",
                             "params/embed", "params/norm"),
    "zamba2-2.7b": ("params/ssm", "params/attn", "params/mlp")}
# phase 13: the audio and vision frontends
AUDIO_ARCH, VLM_ARCH = "hubert-xlarge", "llava-next-mistral-7b"
# llava-next-mistral-7b whole is 14.52 GB of bf16 parameters and the
# unsharded scrub holds about six copies of a payload: at 8 of its 32
# layers (phase 3's cut of llama3-8b) it is 4.05 GB
VLM_LAYERS = N_LAYERS
AUDIO_BATCH, AUDIO_FRAMES = 8, 500     # 10 s clips of 50 Hz frames
AUDIO_QUERIES = 32                     # encoder queries a policy
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_STEPS, AUDIO_TRAIN_SCRUB = 4, 4, 2
AUDIO_TRAIN_RATE = 1.0                 # expected strikes a train step
VLM_BATCH, VLM_TEXT, VLM_NEW = 4, 512, 128   # + the config's 2,880 patches
VLM_PAGE, VLM_PAGED_STEPS = 16, 16
VLM_CAMPAIGN_BATCH = 2                 # (d): query of 2 x (2,880 + 256)
FRONTEND_REGIONS = ("params/embed", "params/attn", "params/mlp",
                    "params/norm")
# phase 14: the 72-405 B dense configs and llava whole, at full width
# through ShardedMemoryDomain (typical_server, 1 replica x 8 shards), the
# depth cut to keep the payload near llama3-8b's 16 GB (phase 11): the
# payload, the struck copy of a leaf and a shard's scrub buffers share the
# card
DENSE_LARGE = (("qwen2-72b", 6), ("llama3-405b", 1), ("nemotron-4-340b", 1),
               (VLM_ARCH, None))           # (arch, layers kept; None: whole)
DENSE_LARGE_TINY = ("qwen2-72b", "nemotron-4-340b", "llama3-405b")
DENSE_LARGE_SHARDS = 8
DENSE_LARGE_BATCH, DENSE_LARGE_PROMPT = 4, 128
DENSE_LARGE_NEW, DENSE_LARGE_SCRUB = 32, 8
DENSE_LARGE_TINY_REL = 1e-5            # (a) card vs CPU, float32 compute
DENSE_LARGE_MOE_GROUPS = (1, 2, 4)
# phase 15: the legacy per-leaf shims at llama3-8b's full width with 2 of
# its 32 layers, elastic on one card, and dry-run cells on the host
LEGACY_LAYERS = 2
LEGACY_STRIDES = (1, 4)                # Scrubber round robin
DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("llama3-8b", "decode_32k"),
                ("deepseek-moe-16b", "train_4k"))
DRYRUN_TIMEOUT = 900                   # a cell's host process, seconds
# decode vs forward, in bf16 ulps: above the sound decodes' readings and
# below a planted fault's (every step one position early), which each run
# reads too (PERF.md, PR 22)
DENSE_LARGE_ULPS, DENSE_LARGE_PLANTED_SHIFT = 8, -1
# push results are held to the plain version's at rtol + ATOL_REL x max|y|:
# both sum in float64 and round once, but the kernels' atomics add in an
# order that changes from run to run, which can move a rounding by one ulp
PUSH_RTOL, PUSH_ATOL_REL = 1e-5, 1e-7


def _sync():
    torch.cuda.synchronize()


def _timed(fn):
    """(fn(), wall ms), the device synchronised before and after."""
    _sync()
    t = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t) * 1e3


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _compare(got, want):
    """(mismatching elements, max abs byte difference) over output pairs."""
    mism, err = 0, 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.uint16:      # compared as the same bits in int16
            a, b = a.view(torch.int16), b.view(torch.int16)
        mism += int((a != b).sum())
        err = max(err, int((_bytes(a).int() - _bytes(b).int()).abs().max()))
    return mism, err


# ------------------------------------------------------------ 1. build
def build():
    from repro_torch.kernels import _build
    t = time.perf_counter()
    lib = _build.build()
    _build.library()
    dt = time.perf_counter() - t
    print(f"build: {dt:.1f} s, {lib.name}")
    log = lib.with_suffix(".log")
    if log.exists():
        print(log.read_text(), file=sys.stderr)


# --------------------------------------------------- 2. kernel checks
def _np_words(rng, n: int) -> np.ndarray:
    return rng.integers(0, 2**64, size=n, dtype=np.uint64)


def _card(a: np.ndarray, dev) -> torch.Tensor:
    """uint64 or uint16 numpy words -> (rows, 256) int64 or uint16 on the
    card."""
    view = np.int64 if a.dtype == np.uint64 else np.uint16
    return torch.from_numpy(np.ascontiguousarray(a).view(view).reshape(
        -1, 256)).to(dev)


def check_kernels(dev, rows: int = CHECK_ROWS):
    """Each kernel against its plain version on the same card inputs."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.bitflip import bitflip_words_
    from repro_torch.kernels.parity import (parity_check_plain,
                                            parity_check_words,
                                            parity_encode_words)
    from repro_torch.kernels.secded import (secded_encode_words,
                                            secded_scrub_plain,
                                            secded_scrub_words)
    rng = np.random.default_rng(SEED)
    n = rows * 256
    clean_np = _np_words(rng, n)
    # strikes: single-bit on 1/64 of the words, double-bit on 1/128, and a
    # flipped check bit on 1/256 of the ECC bytes
    idx = rng.permutation(n)
    k1, k2, k3 = n // 64, n // 128, n // 256
    one = np.uint64(1)
    bad_np = clean_np.copy()
    single, double = idx[:k1], idx[k1:k1 + k2]
    bad_np[single] ^= one << rng.integers(0, 64, k1).astype(np.uint64)
    b1 = rng.integers(0, 64, k2)
    b2 = (b1 + rng.integers(1, 64, k2)) % 64
    bad_np[double] ^= (one << b1.astype(np.uint64)) | \
        (one << b2.astype(np.uint64))

    clean, bad = _card(clean_np, dev), _card(bad_np, dev)
    ecc = ref.secded_encode_ref(clean)
    ecc_bad = ecc.reshape(-1).clone()
    check_bit = torch.from_numpy(idx[k1 + k2:k1 + k2 + k3]).to(dev)
    ecc_bad[check_bit] ^= torch.from_numpy(
        (1 << rng.integers(0, 8, k3)).astype(np.uint8)).to(dev)
    ecc_bad = ecc_bad.reshape(rows, 256)
    par = ref.parity_encode_ref(clean)
    # strikes: negative (inactive), past the buffer, and duplicated
    e = 1 << 20
    wi = torch.from_numpy(rng.integers(-n // 8, n + n // 8, e)).to(dev)
    bi = torch.from_numpy(rng.integers(0, 64, e)).to(dev)
    wi[e // 2:e // 2 + e // 8] = wi[:e // 8]
    bi[e // 2:e // 2 + e // 8] = bi[:e // 8]

    before = dict(_build.LAUNCHES)
    pairs = {
        "secded_encode": ((secded_encode_words(clean),),
                          (ref.secded_encode_ref(clean),)),
        "secded_scrub": (secded_scrub_words(bad, ecc_bad),
                         secded_scrub_plain(bad, ecc_bad)),
        "parity_encode": ((parity_encode_words(clean),), (par,)),
        "parity_check": (parity_check_words(bad, par),
                         parity_check_plain(bad, par)),
        "bitflip": ((bitflip_words_(clean.clone(), wi, bi),),
                    (ref.bitflip_ref(clean, wi, bi),)),
    }
    _sync()
    out, parts = {}, []
    for name, (got, want) in pairs.items():
        mism, err = _compare(got, want)
        launches = _build.LAUNCHES[name] - before[name]
        out[name] = {"words": n, "mismatches": mism, "max_abs_err": err,
                     "launches": launches}
        parts.append(f"{name} words={n} mismatches={mism} "
                     f"launches={launches}")
    print("kernels (tolerance: bit-exact): " + "; ".join(parts))
    _, _, corr, unc = pairs["secded_scrub"][0]
    if (int(corr.sum()), int(unc.sum())) != (k1 + k3, k2):
        raise AssertionError(f"scrub counts {int(corr.sum())}, "
                             f"{int(unc.sum())}; want {k1 + k3}, {k2}")
    if int(pairs["parity_check"][0][1].sum()) != k1:
        raise AssertionError("parity check missed single-bit strikes")
    bad_kernels = [k for k, v in out.items()
                   if v["mismatches"] or not v["launches"]]
    if bad_kernels:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"or did not launch: {bad_kernels}")
    return out


def _apply_patterns(words: np.ndarray, ecc: np.ndarray, pats: np.ndarray):
    """Strike word i with pattern ``pats[i]`` (codeword positions, -1 for
    none): position p < 64 is data bit p, p >= 64 check bit p - 64."""
    words, ecc = words.copy(), ecc.copy()
    one = np.uint64(1)
    for col in pats.T:
        data = (col >= 0) & (col < 64)
        words[data] ^= one << col[data].astype(np.uint64)
        chk = col >= 64
        ecc[chk] ^= (1 << (col[chk] - 64)).astype(np.uint16)
    return words, ecc


def check_strong_kernels(dev, rows: int = CHECK_ROWS):
    """The BCH (DEC-TED code) and burst kernels against their plain versions
    on the same card inputs: 8 Mi random words, a single-bit strike on 1/64
    of them, a random double on 1/128, a check-bit flip on 1/256, a
    triple-bit strike on 1/256 and an adjacent pair on another 1/256."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.bch import bch_scrub_plain
    from repro_torch.kernels.burst import (burst_encode_plain,
                                           burst_encode_words,
                                           burst_scrub_plain,
                                           burst_scrub_words)
    from repro_torch.kernels.dected import (DECTED_CODE, dected_encode_words,
                                            dected_scrub_words)
    rng = np.random.default_rng(SEED + 3)
    n = rows * 256
    clean_np = _np_words(rng, n)
    idx = rng.permutation(n)
    k1, k2, k4 = n // 64, n // 128, n // 256
    sets = np.split(idx[:k1 + k2 + 3 * k4],
                    np.cumsum([k1, k2, k4, k4]))   # 1, 2, check, 3, adjacent
    pats = np.full((n, 3), -1, dtype=np.int64)
    pats[sets[0], 0] = rng.integers(0, 64, k1)
    pats[sets[1], :2] = np.argsort(rng.random((k2, 64)), axis=1)[:, :2]
    pats[sets[3], :3] = np.argsort(rng.random((k4, 64)), axis=1)[:, :3]
    b = rng.integers(0, 63, k4)
    pats[sets[4], :2] = np.stack([b, b + 1], axis=1)
    clean = _card(clean_np, dev)
    out, parts = {}, []
    before = dict(_build.LAUNCHES)
    for kernel, code_r, encode, encode_ref, scrub, scrub_plain in (
            ("bch", DECTED_CODE.r, dected_encode_words,
             lambda w: ref.bch_encode_ref(w, DECTED_CODE), dected_scrub_words,
             lambda w, e: bch_scrub_plain(w, e, DECTED_CODE)),
            ("burst", 14, burst_encode_words, burst_encode_plain,
             burst_scrub_words, burst_scrub_plain)):
        ecc_np = encode_ref(clean).cpu().numpy().reshape(-1)
        p = pats.copy()
        p[sets[2], 0] = 64 + rng.integers(0, code_r, k4)
        bad_np, bad_ecc_np = _apply_patterns(clean_np, ecc_np, p)
        bad, bad_ecc = _card(bad_np, dev), _card(bad_ecc_np, dev)
        pairs = {
            kernel + "_encode": ((encode(clean),), (encode_ref(clean),)),
            kernel + "_scrub": (scrub(bad, bad_ecc),
                                scrub_plain(bad, bad_ecc)),
        }
        _sync()
        for name, (got, want) in pairs.items():
            mism, err = _compare(got, want)
            launches = _build.LAUNCHES[name] - before[name]
            out[name] = {"words": n, "mismatches": mism, "max_abs_err": err,
                         "launches": launches}
            parts.append(f"{name} words={n} mismatches={mism} "
                         f"launches={launches}")
        _, _, corr, unc = pairs[kernel + "_scrub"][0]
        corr, unc = int(corr.sum()), int(unc.sum())
        struck = k1 + k2 + 3 * k4
        if kernel == "bch" and (corr, unc) != (struck - k4, k4):
            raise AssertionError(f"DEC-TED scrub counts {corr}, {unc}; want "
                                 f"{struck - k4}, {k4}")
        if kernel == "burst" and corr + unc != struck:
            raise AssertionError(f"BURST scrub flagged {corr} + {unc} words "
                                 f"of {struck} struck")
    print("strong kernels (tolerance: bit-exact): " + "; ".join(parts))
    bad_kernels = [k for k, v in out.items()
                   if v["mismatches"] or not v["launches"]]
    if bad_kernels:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"or did not launch: {bad_kernels}")
    return out


def _sweep(name, encode, scrub, scrub_plain, pats: np.ndarray, dev, rng,
           outcome: str):
    """One random word per pattern (rows padded with clean words), struck
    and scrubbed on the card. The kernel's outputs must equal the plain
    version's, and ``outcome`` must hold for every struck word:
    "corrected" (word and code restored, counted corrected) or "flagged"
    (word and code untouched, counted uncorrectable, none corrected)."""
    n = -(-len(pats) // 256) * 256
    pats = np.concatenate([pats, np.full((n - len(pats), pats.shape[1]),
                                         -1)])
    clean_np = _np_words(rng, n)
    clean = _card(clean_np, dev)
    ecc = encode(clean)
    bad_np, bad_ecc_np = _apply_patterns(
        clean_np, ecc.cpu().numpy().reshape(-1), pats)
    bad, bad_ecc = _card(bad_np, dev), _card(bad_ecc_np, dev)
    got = scrub(bad, bad_ecc)
    mism, _ = _compare(got, scrub_plain(bad, bad_ecc))
    words2, ecc2, corr, unc = got
    struck = int((pats >= 0).any(1).sum())
    counts = (int(corr.sum()), int(unc.sum()))
    if outcome == "corrected":
        ok = counts == (struck, 0) and not _compare(
            [words2, ecc2], [clean, ecc])[0]
    else:
        ok = counts == (0, struck) and not _compare(
            [words2, ecc2], [bad, bad_ecc])[0]
    print(f"sweep {name}: patterns={struck} {outcome} corrected={counts[0]} "
          f"uncorrectable={counts[1]} mismatches_vs_plain={mism} "
          f"{'ok' if ok and not mism else 'FAILED'}")
    if mism or not ok:
        raise AssertionError(f"conformance sweep {name} failed")


def conformance_sweeps(dev):
    """DEC-TED: every 1-bit (79) and every 2-bit (3081) pattern over its 79
    codeword bits corrected, 4096 sampled 3-bit patterns flagged; BURST:
    every single (78) and every adjacent data pair (63) corrected; the
    BCH(72,64) t=1 code through the same BCH kernel: every single (72)
    corrected, sampled doubles flagged."""
    from itertools import combinations
    from repro_torch.kernels.bch import (bch_encode_words, bch_scrub_plain,
                                         bch_scrub_words, make_code)
    from repro_torch.kernels.burst import (burst_encode_words,
                                           burst_scrub_plain,
                                           burst_scrub_words)
    from repro_torch.kernels.dected import DECTED_CODE
    rng = np.random.default_rng(SEED + 4)

    def positions(code):
        return list(range(code.k)) + [64 + j for j in range(code.r)]

    def sampled(pos, size, count):
        return np.array([rng.choice(pos, size, replace=False)
                         for _ in range(count)])

    for label, code, cases in (
            ("dected", DECTED_CODE, (
                ("1-bit", 1, "corrected"), ("2-bit", 2, "corrected"),
                ("3-bit sampled", 3, "flagged"))),
            ("bch72_t1", make_code(64, 1, 7, True), (
                ("1-bit", 1, "corrected"), ("2-bit sampled", 2, "flagged")))):
        pos = positions(code)
        for case, size, outcome in cases:
            pats = np.array(list(combinations(pos, size))) \
                if "sampled" not in case else sampled(pos, size, TRIPLES)
            _sweep(f"{label} {case}",
                   lambda w, c=code: bch_encode_words(w, c),
                   lambda w, e, c=code: bch_scrub_words(w, e, c),
                   lambda w, e, c=code: bch_scrub_plain(w, e, c),
                   pats, dev, rng, outcome)
    pos = list(range(64 + 14))
    for case, pats in (("single", np.array([[p] for p in pos])),
                       ("adjacent data pair",
                        np.array([[b, b + 1] for b in range(63)]))):
        _sweep(f"burst {case}", burst_encode_words, burst_scrub_words,
               burst_scrub_plain, pats, dev, rng, "corrected")


# ------------------------------------------------------- 3. main path
def model_state(dev):
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import init_cache, init_params
    cfg = get_config("llama3-8b")
    print(f"reduced: n_layers {cfg.n_layers}->{N_LAYERS} (at full depth the "
          f"scrub's peak, about five copies of the payload, passes 80 GB)")
    cfg = cfg.replace(n_layers=N_LAYERS)
    params = init_params(cfg, seed=SEED, device=dev)
    cache = init_cache(cfg, KV_BATCH, KV_SEQ, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for v in cache.values():           # a filled cache, as in decoding
        v.normal_(generator=gen)
    state = {"params": params, "kv_cache": cache}
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"model: llama3-8b d_model={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"layers={cfg.n_layers} params={n_params} ({cfg.param_dtype}) "
          f"kv_cache={KV_BATCH}x{KV_SEQ}")
    return state


def check_draws(dev) -> None:
    """Phase 3c: tiny llama3-8b and kvstore-demo parameters and the
    kv-store's query keys, the four tiny MoE, hybrid and xLSTM configs'
    parameters, and NORMAL_DRAWS of ``Stream.normal`` made on the card
    equal those made on the CPU, bit for bit."""
    from repro_torch.configs import get_tiny
    from repro_torch.core import tree
    from repro_torch.draws import Stream
    from repro_torch.launch.explore import _kvstore_state
    from repro_torch.models import init_params

    def made_on(device):
        out = []
        for arch in ("llama3-8b", "kvstore-demo"):
            params, keys = _kvstore_state(get_tiny(arch), SEED, device)
            out += [*tree.leaves(params), keys]
        for arch in FAMILY_ARCHS:
            out += tree.leaves(init_params(get_tiny(arch), seed=SEED,
                                           device=device))
        out.append(Stream(SEED, device).normal((NORMAL_DRAWS,), 1.0,
                                               torch.float32))
        return out

    unequal = total = 0
    for a, b in zip(made_on(dev), made_on("cpu")):
        a = a.cpu().reshape(a.numel(), -1).view(torch.uint8)
        b = b.reshape(b.numel(), -1).view(torch.uint8)
        unequal += int((a != b).any(dim=1).sum())
        total += a.shape[0]
    print(f"draws: unequal_elements={unequal} of {total} (tiny llama3-8b "
          f"and kvstore-demo parameters and kv-store keys, the four tiny "
          f"MoE/hybrid/xLSTM configs' parameters, {NORMAL_DRAWS} normal "
          f"draws; card vs cpu)")
    if unequal:
        raise AssertionError("the card's draws differ from the CPU's")


def _check_restored(dom, original, events, report):
    """Protected leaves carry their original bytes; the correcting tiers
    (SEC-DED, DEC-TED, BURST, MIRROR) left nothing uncorrectable after
    single-bit strikes; a Tier NONE leaf differs only if struck."""
    from repro_torch.core import Tier
    correcting = (Tier.SECDED, Tier.DECTED, Tier.BURST, Tier.MIRROR)
    struck = {e["path"] for e in events}
    for s in dom.spec.leaves:
        same = torch.equal(_bytes(dom.leaf(s.path)),
                           _bytes(original.leaf(s.path)))
        if s.tier is not Tier.NONE and not same:
            raise AssertionError(f"{s.path} ({s.tier.value}) not restored")
        if s.tier is Tier.NONE and s.path not in struck and not same:
            raise AssertionError(f"{s.path} changed without a strike")
        if s.tier in correcting and \
                int(report.detected_uncorrectable[s.path]):
            raise AssertionError(f"{s.path} left uncorrectable words")


def _needed_kernels(dom) -> set:
    """The kernels a protect/inject/scrub/recover run of ``dom`` must
    launch: bit-flip for the strikes, and each of its tiers' codec."""
    from repro_torch.core import Tier
    need = {"bitflip"}
    for tier in dom.spec.groups:
        if tier is Tier.SECDED:
            need |= {"secded_encode", "secded_scrub"}
        elif tier is Tier.DECTED:
            need |= {"bch_encode", "bch_scrub"}
        elif tier is Tier.BURST:
            need |= {"burst_encode", "burst_scrub"}
        elif tier in (Tier.PARITY_R, Tier.MIRROR):
            need |= {"parity_encode", "parity_check"}
    return need


def _path_launches(name: str, need: set, by_path: dict,
                   earlier: dict | None = None) -> None:
    """Record the launches of path ``name`` (counted since its reset, plus
    ``earlier``: the counts of its windows before another path's run cut
    in) and fail if it skipped a kernel of ``need``."""
    from repro_torch.kernels import _build
    by_path[name] = {k: v + (earlier or {}).get(k, 0)
                     for k, v in _build.LAUNCHES.items()}
    missing = sorted(k for k in need if not by_path[name][k])
    print(f"launches {name}: " + json.dumps(by_path[name]))
    if missing:
        raise AssertionError(f"{name} never launched {missing}")


def _burst_storm(dom, rng) -> str:
    """Strike the largest DEC-TED or BURST leaf of ``dom`` with STORM_BURSTS
    adjacent double-bit bursts (at full width two land in one word with
    odds below 1e-3); ``scrub`` alone must bring it back bit for bit,
    leaving nothing for recovery. Returns the printed summary ("" when the
    domain has neither tier)."""
    from repro_torch.core import InjectionPlan, Tier
    strong = [s for s in dom.spec.leaves
              if s.tier in (Tier.DECTED, Tier.BURST)]
    if not strong:
        return ""
    leaf = max(strong, key=lambda s: s.nbytes)
    n_words = leaf.rows * 256
    # the leaf's whole words, so no burst falls in pad bytes lost on
    # unpacking
    in_leaf = leaf.nbytes // 8
    plan = InjectionPlan.adjacent_burst(rng, in_leaf, STORM_BURSTS)
    struck = dom.apply_plan(leaf.path, plan)
    (healed, report), t_scrub = _timed(struck.scrub)
    corr, unc = report.totals()
    bursts = len(set(plan.word_idx[plan.word_idx >= 0].tolist()))
    if not torch.equal(_bytes(healed.leaf(leaf.path)),
                       _bytes(dom.leaf(leaf.path))) \
            or unc or report.needs_recovery() or corr != bursts:
        raise AssertionError(f"adjacent-burst storm on {leaf.path} "
                             f"({leaf.tier.value}): corrected {corr} of "
                             f"{bursts} bursts, {unc} uncorrectable")
    return (f" storm={leaf.path}({leaf.tier.value},{n_words} words):"
            f"bursts={bursts},corrected={corr},uncorrectable=0,"
            f"scrub_ms={t_scrub:.1f},healed_by_scrub=bit-exact")


def run_main_path(state):
    """Drive each design point, then the hard drill, through the verbs.
    Every path's launches are counted on their own (the counters are reset
    just before it); returns {path: {kernel: launches}}."""
    from repro_torch.core import (DESIGN_POINTS, MemoryDomain, RetirementMap,
                                  Tier)
    from repro_torch.kernels import _build
    rng = np.random.default_rng(SEED)
    by_path, peaks = {}, []
    for name in DESIGN_POINTS_RUN:
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        dom, t_protect = _timed(
            lambda: MemoryDomain.protect(state, DESIGN_POINTS[name]()))
        clean = {p: dom.leaf(p) for p in dom.paths()}
        (bad, events), t_inject = _timed(
            lambda: dom.inject(rng, STRIKES, multi_bit_fraction=0.0))
        (fixed, report), t_scrub = _timed(bad.scrub)
        corr, unc = report.totals()
        (rec, rev), t_recover = _timed(
            lambda: fixed.recover(report, clean_copy=clean.__getitem__))
        _check_restored(rec, dom, events, report)
        del bad, fixed, rec        # the storm strikes the clean domain
        storm = _burst_storm(dom, rng)
        _path_launches(name, _needed_kernels(dom), by_path)
        none_hits = sum(dom.tier_of(e["path"]) is Tier.NONE for e in events)
        st = dom.stats()
        peaks.append(torch.cuda.max_memory_allocated())
        print(f"{name}: payload={st.payload_bytes} sidecar={st.sidecar_bytes}"
              f" protect_ms={t_protect:.1f} inject_ms={t_inject:.1f} "
              f"scrub_ms={t_scrub:.1f} recover_ms={t_recover:.1f} "
              f"corrected={corr} uncorrectable={unc} reloaded={len(rev)} "
              f"strikes_on_unprotected={none_hits} peak_bytes={peaks[-1]} "
              f"restored=bit-exact" + storm)
        del dom, clean, report
    # hard errors: sticky strikes re-bite after each reload until their
    # blocks are retired
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    dom = MemoryDomain.protect(state, DESIGN_POINTS["detect_recover"]())
    par = dom.paths(protected_only=True)
    bad, _ = dom.inject(rng, 4, hard=True, paths=par, multi_bit_fraction=0.0)
    clean = {p: dom.leaf(p) for p in dom.paths()}
    strikes, retired = {}, RetirementMap()
    t = time.perf_counter()
    for _ in range(3):
        fixed, report = bad.scrub()
        if not report.needs_recovery():
            raise AssertionError("hard errors went undetected")
        bad, rev = fixed.recover(report, clean_copy=clean.__getitem__,
                                 strikes=strikes, retirement=retired,
                                 retire_after=3)
        bad = bad.reassert_hard()
    _sync()
    _path_launches("hard_drill", _needed_kernels(dom), by_path)
    _check_restored(bad, dom, [], report)
    if retired.count() < 1 or bad.hard_errors:
        raise AssertionError(f"retired {retired.count()} blocks, "
                             f"{len(bad.hard_errors)} sticky leaves left")
    print(f"hard drill: retired_blocks={retired.count()} over "
          f"{len(retired.blocks)} leaves, sticky_left=0, "
          f"wall_ms={(time.perf_counter() - t) * 1e3:.1f}")
    del dom, bad, fixed, clean
    peaks.append(torch.cuda.max_memory_allocated())
    print(f"peak_memory_bytes={max(peaks)} (the main path's largest run)")
    return by_path


# ------------------------------------- 3b. kernels at main-path shapes
def _agree(got, plain, inputs, chunk_rows: int):
    """(mismatching elements, max abs byte difference) of a kernel's
    whole-buffer outputs ``got`` against ``plain`` run over row chunks of
    the same ``inputs``, chunk by chunk."""
    mism, err = 0, 0
    for a in range(0, inputs[0].shape[0], chunk_rows):
        want = plain(*(t[a:a + chunk_rows] for t in inputs))
        m, e = _compare([g[a:a + chunk_rows] for g in got], want)
        mism, err = mism + m, max(err, e)
    return mism, err


def _strike_plan(n: int, gen):
    """Strikes on a buffer of ``n`` words, on disjoint word classes: a
    single-bit flip on every 64th word, a double-bit flip on every 128th
    (offset 17), a duplicated strike (it cancels) on every 256th (offset
    41), plus inactive (< 0) and out-of-range slots. Returns (word_idx,
    bit_idx, single-bit words, double-bit words)."""
    dev = gen.device

    def bits(k):
        return torch.randint(0, 64, (k,), generator=gen, device=dev)

    single = torch.arange(0, n, 64, device=dev)
    double = torch.arange(17, n, 128, device=dev)
    dup = torch.arange(41, n, 256, device=dev)
    b1 = bits(double.numel())
    b2 = (b1 + 1 + torch.randint(0, 63, b1.shape, generator=gen,
                                 device=dev)) % 64
    b_dup = bits(dup.numel())
    k = max(n // 1024, 1)
    inactive = -1 - torch.randint(0, n, (k,), generator=gen, device=dev)
    past = n + torch.randint(0, n, (k,), generator=gen, device=dev)
    wi = torch.cat([single, double, double, dup, dup, inactive, past])
    bi = torch.cat([bits(single.numel()), b1, b2, b_dup, b_dup, bits(k),
                    bits(k)])
    return wi, bi, single.numel(), double.numel()


def _ecc_codecs():
    """ECC tier -> (kernel prefix, plain encode, scrub wrapper, plain scrub,
    check bits)."""
    from repro_torch.core import Tier
    from repro_torch.kernels import ref
    from repro_torch.kernels.bch import bch_scrub_plain
    from repro_torch.kernels.burst import (burst_encode_plain,
                                           burst_scrub_plain,
                                           burst_scrub_words)
    from repro_torch.kernels.dected import DECTED_CODE, dected_scrub_words
    from repro_torch.kernels.secded import (secded_scrub_plain,
                                            secded_scrub_words)
    return {
        Tier.SECDED: ("secded", ref.secded_encode_ref, secded_scrub_words,
                      secded_scrub_plain, 8),
        Tier.DECTED: ("bch", lambda w: ref.bch_encode_ref(w, DECTED_CODE),
                      dected_scrub_words,
                      lambda w, e: bch_scrub_plain(w, e, DECTED_CODE),
                      DECTED_CODE.r),
        Tier.BURST: ("burst", burst_encode_plain, burst_scrub_words,
                     burst_scrub_plain, 14),
    }


def check_main_shapes(state, dev, chunk_rows: int = 1 << 16):
    """Each kernel against its plain version at the shapes the main path
    gives it: every tier buffer of every design point run (the
    typical_server SEC-DED and dected_server DEC-TED buffers are all 6.66
    GB of payload, past 4 GB of byte offsets). The encode kernels' sidecars
    are the ones ``protect`` made; the bit-flip kernel strikes the buffer
    (``_strike_plan``), one ECC word in 256 (offset 33) gets a flipped
    check bit, and the scrub or check kernel runs on the struck buffer. The
    plain versions run over row chunks of the same card tensors."""
    from repro_torch.core import DESIGN_POINTS, MemoryDomain, Tier
    from repro_torch.core.domain import _gather_packed, _whole
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitflip import bitflip_words_
    from repro_torch.kernels.parity import (parity_check_plain,
                                            parity_check_words)
    codecs = _ecc_codecs()
    out = {k: {"words": 0, "mismatches": 0, "max_abs_err": 0}
           for k in KERNELS if k not in GRAPH_KERNELS}

    def tally(kernel, words, agree):
        rec = out[kernel]
        rec["words"] += words
        rec["mismatches"] += agree[0]
        rec["max_abs_err"] = max(rec["max_abs_err"], agree[1])

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    parts = []
    for name in DESIGN_POINTS_RUN:
        dom = MemoryDomain.protect(state, DESIGN_POINTS[name]())
        leaves = dom._leaves()
        for tier, (rows, sel) in sorted(dom.spec.groups.items(),
                                        key=lambda g: g[0].value):
            words = _gather_packed(leaves, _whole(sel), rows)
            sc = dom.sidecar[tier.value]
            n = rows * 256
            codec = codecs.get(tier)
            if codec is not None:
                code, encode_ref, scrub, scrub_plain, n_check = codec
                side = sc["ecc"]
            else:
                code, encode_ref, side = "parity", ref.parity_encode_ref, \
                    sc["par"]
            tally(code + "_encode", n,
                  _agree([side], lambda w: (encode_ref(w),), [words],
                         chunk_rows))
            wi, bi, k1, k2 = _strike_plan(n, gen)
            want = ref.bitflip_ref(words, wi, bi)
            bitflip_words_(words, wi, bi)             # words now struck
            tally("bitflip", n,
                  _agree([words], lambda w: (w,), [want], chunk_rows))
            del want, wi, bi
            if codec is not None:
                ecc = side.clone().reshape(-1)
                # uint16 has no XOR on the card: flip through an int16 view
                bits = ecc.view(torch.int16) if ecc.dtype == torch.uint16 \
                    else ecc
                chk = torch.arange(33, n, 256, device=ecc.device)
                k3 = chk.numel()
                bits[chk] ^= torch.bitwise_left_shift(
                    torch.ones(k3, dtype=torch.int64, device=ecc.device),
                    torch.randint(0, n_check, (k3,), generator=gen,
                                  device=ecc.device)).to(bits.dtype)
                ecc = ecc.reshape(rows, 256)
                got = scrub(words, ecc)
                tally(code + "_scrub", n, _agree(
                    got, scrub_plain, [words, ecc], chunk_rows))
                counts = (int(got[2].sum()), int(got[3].sum()))
                # SEC-DED flags the doubles, DEC-TED corrects them, BURST
                # corrects those that split across its two sub-codes
                ok = {Tier.SECDED: counts == (k1 + k3, k2),
                      Tier.DECTED: counts == (k1 + k2 + k3, 0),
                      Tier.BURST: sum(counts) == k1 + k2 + k3
                      and counts[1] <= k2}[tier]
                if not ok:
                    raise AssertionError(
                        f"{name} {tier.value} scrub counts {counts} for "
                        f"{k1} single, {k2} double and {k3} check-bit "
                        f"strikes")
            else:
                got = parity_check_words(words, side)
                tally("parity_check", n, _agree(
                    got, parity_check_plain, [words, side], chunk_rows))
                if int(got[1].sum()) != k1:
                    raise AssertionError(f"{name} {tier.value} parity "
                                         f"check missed single-bit strikes")
            del got, words
            parts.append(f"{name}/{tier.value} rows={rows}")
        del dom, leaves
    print("kernels at main-path shapes (tolerance: bit-exact; "
          + ", ".join(parts) + "): " + "; ".join(
              f"{k} words={v['words']} mismatches={v['mismatches']}"
              for k, v in out.items()))
    bad = [k for k, v in out.items() if v["mismatches"] or not v["words"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at the main path's shapes: {bad}")
    return out


def profile_scrub(state):
    """Where a scrub's time goes: one warm scrub per policy, timed alone,
    then again under ``torch.profiler``, with device time by kernel and the
    device's idle share of the traced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import DESIGN_POINTS, MemoryDomain
    for name in ("typical_server", "mirror_dr_l", "dected_server",
                 "burst_dr_l"):
        dom = MemoryDomain.protect(state, DESIGN_POINTS[name]())
        bad, _ = dom.inject(np.random.default_rng(SEED), 8,
                            multi_bit_fraction=0.0)
        _, cold_ms = _timed(bad.scrub)
        _, warm_ms = _timed(bad.scrub)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            (_, rep), traced_ms = _timed(bad.scrub)
            rep.totals()
        # device-side events only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        print(f"profile {name} scrub: cold_ms={cold_ms:.1f} "
              f"warm_ms={warm_ms:.1f} traced_ms={traced_ms:.1f} "
              f"device_busy_ms={busy_ms:.2f} "
              f"idle_share={1 - busy_ms / traced_ms:.3f}")
        for e in top:
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:90]}")
        del dom, bad


# ---------------------------------------------------- 4. kernel times
def _cuda_ms(fn, reps: int) -> float:
    fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, launches: int, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events, so no host
    time falls between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _cuda_ms(graph.replay, reps) / launches


def _popc_per_s() -> float:
    """The card's peak rate of 32-bit popcounts: SMs x POPC_PER_CLOCK_PER_SM
    x the maximum SM clock nvidia-smi reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"popcount peak: {sms} SMs x {POPC_PER_CLOCK_PER_SM}/clock x "
          f"{mhz} MHz")
    return sms * POPC_PER_CLOCK_PER_SM * mhz * 1e6


def _tier_buffer(state, design: str, tier):
    """(packed words, sidecar) of ``tier``'s full buffer under ``design``,
    as ``protect`` builds them."""
    from repro_torch.core import DESIGN_POINTS, MemoryDomain
    from repro_torch.core.domain import _gather_packed, _whole
    dom = MemoryDomain.protect(state, DESIGN_POINTS[design]())
    rows, sel = dom.spec.groups[tier]
    return (_gather_packed(dom._leaves(), _whole(sel), rows),
            dom.sidecar[tier.value])


def time_kernels(state, chunk_rows: int = 1 << 16):
    """Each kernel and its plain version at its design point's full tier
    buffer: typical_server's SEC-DED buffer (the whole payload in one
    (rows, 256) word buffer) for the SEC-DED, parity and bit-flip kernels,
    dected_server's DEC-TED buffer (the same rows) for the BCH kernels and
    burst_dr_l's BURST buffer for the burst kernels. The plain versions run
    over row chunks of ``chunk_rows`` to bound their temporaries; their
    time is that of the whole buffer. The bound is the bytes the function
    must move (each input read once, each output written once) over the
    memory rate: its operations need no popcount (a code is also an XOR of
    byte-indexed table entries), so they bound nothing below that. Beside
    it, ``ops_bound_ms`` is the popcount limit of these kernels: one 32-bit
    popcount per check bit per word (the word's masked halves XOR-folded
    first) over the popcount rate; the scrubs run on clean buffers, so no
    word needs a second encode."""
    from repro_torch.core import InjectionPlan, Tier
    from repro_torch.kernels import ref
    from repro_torch.kernels.bch import bch_scrub_plain
    from repro_torch.kernels.bitflip import bitflip_words_
    from repro_torch.kernels.burst import (burst_encode_plain,
                                           burst_encode_words,
                                           burst_scrub_plain,
                                           burst_scrub_words)
    from repro_torch.kernels.dected import (DECTED_CODE, dected_encode_words,
                                            dected_scrub_words)
    from repro_torch.kernels.parity import (parity_check_plain,
                                            parity_check_words,
                                            parity_encode_words)
    from repro_torch.kernels.secded import (secded_encode_words,
                                            secded_scrub_plain,
                                            secded_scrub_words)
    popc_per_s = _popc_per_s()
    words, sc = _tier_buffer(state, "typical_server", Tier.SECDED)
    ecc = sc["ecc"]
    d_ecc = _tier_buffer(state, "dected_server", Tier.DECTED)[1]["ecc"]
    b_words, b_sc = _tier_buffer(state, "burst_dr_l", Tier.BURST)
    b_ecc = b_sc["ecc"]
    par = parity_encode_words(words)
    rows, b_rows = words.shape[0], b_words.shape[0]
    plan = InjectionPlan.sample(np.random.default_rng(SEED), rows * 256, 1,
                                False, 0.0)
    wi = torch.from_numpy(plan.word_idx).to(words.device, torch.int64)
    bi = torch.from_numpy(plan.bit_idx).to(words.device, torch.int64)
    n, e, bn = rows * 256, int(plan.word_idx.size), b_rows * 256
    # bit-flip reads 16 B of indices per slot, and read-modify-writes 8 B
    # only for a strike that lands in the buffer
    hits = int(((wi >= 0) & (wi < n) & (bi >= 0) & (bi < 64)).sum())
    flip_bytes = 16 * e + 16 * hits
    r_d = DECTED_CODE.r

    def chunked(fn, *bufs):
        def run():
            for a in range(0, bufs[0].shape[0], chunk_rows):
                fn(*(b[a:a + chunk_rows] for b in bufs))
        return run

    # kernel -> (launch, plain version, rows, bytes moved, popcounts)
    cases = {
        "secded_encode": (lambda: secded_encode_words(words),
                          chunked(ref.secded_encode_ref, words), rows,
                          n * 9, n * 8),
        "secded_scrub": (lambda: secded_scrub_words(words, ecc),
                         chunked(secded_scrub_plain, words, ecc), rows,
                         n * 18 + rows * 8, n * 8),
        "parity_encode": (lambda: parity_encode_words(words),
                          chunked(ref.parity_encode_ref, words), rows,
                          n * 8 + rows * 32, n),
        "parity_check": (lambda: parity_check_words(words, par),
                         chunked(parity_check_plain, words, par), rows,
                         n * 8 + rows * 32 * 2 + rows * 4, n),
        # in place: the same 8-strike plan toggles its bits each launch
        "bitflip": (lambda: bitflip_words_(words, wi, bi),
                    lambda: ref.bitflip_ref(words, wi, bi), rows,
                    flip_bytes, 0),
        "bch_encode": (lambda: dected_encode_words(words),
                       chunked(lambda w: ref.bch_encode_ref(w, DECTED_CODE),
                               words), rows, n * 10, n * r_d),
        "bch_scrub": (lambda: dected_scrub_words(words, d_ecc),
                      chunked(lambda w, c: bch_scrub_plain(w, c, DECTED_CODE),
                              words, d_ecc), rows,
                      n * 20 + rows * 8, n * r_d),
        "burst_encode": (lambda: burst_encode_words(b_words),
                         chunked(burst_encode_plain, b_words), b_rows,
                         bn * 10, bn * 14),
        "burst_scrub": (lambda: burst_scrub_words(b_words, b_ecc),
                        chunked(burst_scrub_plain, b_words, b_ecc), b_rows,
                        bn * 20 + b_rows * 8, bn * 14),
    }
    out = {}
    for name, (kern, plain, r, nbytes, popc) in cases.items():
        ms = _cuda_ms(kern, reps=10)
        plain_ms = _cuda_ms(plain, reps=1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = popc / popc_per_s * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bytes_ms,
                     "bound_by": "bytes",
                     "ops_bound_ms": ops_ms, "bytes": nbytes,
                     "popcounts": popc, "rows": r}
        extra = ""
        if name == "bitflip":
            # ms is a call's host and launch time; beside it the kernel's
            # own time, from launches replayed in a CUDA graph
            extra = (f" strikes={e} hits={hits} device_ms="
                     f"{_graph_ms(kern, BITFLIP_GRAPH_LAUNCHES):.5f} "
                     f"(CUDA graph of {BITFLIP_GRAPH_LAUNCHES} launches)")
        print(f"time {name}: rows={r} words={r * 256} ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bytes_ms:.4f} "
              f"(bytes={nbytes}) ops_bound_ms={ops_ms:.4f} "
              f"(popcounts={popc}) of_bound={bytes_ms / ms:.3f} "
              f"of_ops_bound={ops_ms / ms:.3f}" + extra)
    return out


def time_paged_attn(dev):
    """The paged decode attention kernel at the chat cell's shapes and
    positions (PA_*): its output against the plain version computed in
    float32 over the same values, within one rounding of o to bfloat16
    plus 1e-5 x max|o| (float32 sums in another order); its device time,
    launches replayed from a CUDA graph as the decode graph replays them;
    its byte bound (the K/V rows of positions 0..pos of every slot, their
    page ids, q, pos and o, each once); the plain version's time in
    bfloat16 (the gathered views and einsums the paged decode ran
    before)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attn import (paged_attn_decode,
                                                paged_attn_decode_plain)
    S, P, ps, K, G, dh = (PA_SLOTS, PA_PAGES, PA_PAGE, PA_KV_HEADS,
                          PA_GROUP, PA_HEAD)
    rng = np.random.default_rng(SEED)
    pos = np.zeros(S, np.int64)
    held = rng.choice(S, PA_HELD, replace=False)
    pos[held] = (rng.choice(PA_LENS, PA_HELD, p=PA_WEIGHTS)
                 + rng.integers(0, rng.choice(PA_NEW, PA_HELD,
                                              p=PA_WEIGHTS)))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_pages = S * P + 1                  # page 0 the null page

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    q = draw(S, K, G, dh)
    pk, pv = draw(n_pages, ps, K, dh), draw(n_pages, ps, K, dh)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:S * P]
             + 1).reshape(S, P)
    pos_t = torch.as_tensor(pos, device=dev)
    launched = _build.LAUNCHES["paged_attn_decode"]
    got = paged_attn_decode(q, pk, pv, table, pos_t, ps).float()
    want = paged_attn_decode_plain(q.float(), pk.float(), pv.float(), table,
                                   pos_t, ps)
    err = (got - want).abs()
    top = float(want.abs().max())
    limit = torch.finfo(torch.bfloat16).eps * want.abs() + 1e-5 * top
    over, outputs = int((err > limit).sum()), got.numel()
    del want
    ms = _graph_ms(lambda: paged_attn_decode(q, pk, pv, table, pos_t, ps),
                   PA_GRAPH_LAUNCHES)
    plain_ms = _cuda_ms(lambda: paged_attn_decode_plain(q, pk, pv, table,
                                                        pos_t, ps), reps=3)
    read = int((pos + 1).sum())
    pages = int(((pos + ps) // ps).sum())
    nbytes = (read * K * dh * 2 * 2 + pages * 8 + 2 * q.numel() * 2
              + S * 8)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    launches = _build.LAUNCHES["paged_attn_decode"] - launched
    print(f"time paged_attn_decode: slots={S} held={PA_HELD} pages/slot={P} "
          f"page={ps} kv_heads={K} G={G} dh={dh} positions_read={read} "
          f"ms={ms:.5f} (CUDA graph of {PA_GRAPH_LAUNCHES} launches) "
          f"bound_ms={bound_ms:.5f} (bytes={nbytes}) of_bound="
          f"{bound_ms / ms:.3f} plain_ms={plain_ms:.3f} launches="
          f"{launches} max_abs_err={float(err.max()):.3g} (max|o| {top:.3g}) "
          f"mismatches={over} of {outputs} outputs")
    if over:
        raise AssertionError(f"paged_attn_decode: {over} of {outputs} "
                             f"outputs beyond the float32 plain version's "
                             f"rounding (max |diff| {float(err.max())})")
    del pk, pv
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "bytes": nbytes, "positions": read,
            "max_abs_err": float(err.max()), "mismatches": over,
            "outputs": outputs, "launches": launches}


def measured_fig5(dev):
    """Per-tier outcome rates measured through the kernels on the card,
    held equal (as floats) to the same measurement on CPU tensors, which
    runs the plain versions; then the Fig. 5 rows with them. Returns the
    launches of the card's measurement."""
    from repro_torch.core import (Tier, availability, eccmeasure,
                                  paper_design_availability,
                                  paper_design_costs)
    from repro_torch.core.errormodel import DEFAULT_ADJACENT_FRACTION
    from repro_torch.kernels import _build
    tiers = (Tier.PARITY_R, Tier.SECDED, Tier.DECTED, Tier.BURST,
             Tier.MIRROR)
    _build.reset_launches()
    card, cpu = {}, {}
    for tier in tiers:
        for strike in eccmeasure.STRIKE_CLASSES:
            card[tier, strike] = eccmeasure.measure_class_rates(
                tier, strike, 128, SEED, device=dev)
            cpu[tier, strike] = eccmeasure.measure_class_rates(
                tier, strike, 128, SEED, device="cpu")
    mix = (availability.MULTI_BIT_FRACTION, DEFAULT_ADJACENT_FRACTION)
    rates = eccmeasure.measured_tier_rates(tiers, *mix, 128, SEED,
                                           device=dev)
    cpu_rates = eccmeasure.measured_tier_rates(tiers, *mix, 128, SEED,
                                               device="cpu")
    launches = dict(_build.LAUNCHES)
    for (tier, strike), r in card.items():
        print(f"rates {tier.value} {strike}: corrected={r.corrected} "
              f"detected={r.detected} silent={r.silent}")
    for tier in tiers:
        r = rates[tier]
        print(f"rates {tier.value} mixed (multi_bit={mix[0]}, "
              f"adjacent={mix[1]}): corrected={r.corrected!r} "
              f"detected={r.detected!r} silent={r.silent!r}")
    if card != cpu or rates != cpu_rates:
        raise AssertionError("the card's measured rates differ from the "
                             "CPU's")
    missing = [k for k in ("bch_encode", "bch_scrub", "burst_encode",
                           "burst_scrub", "secded_encode", "secded_scrub",
                           "parity_encode", "parity_check")
               if not launches[k]]
    if missing:
        raise AssertionError(f"rate measurement never launched {missing}")
    print("rates: card == cpu for 5 tiers x 3 strike classes; launches "
          + json.dumps(launches))
    print("fig5 costs:")
    for row in paper_design_costs().values():
        print("  " + row.row())
    for label, tr in (("calibrated", None), ("measured", rates)):
        print(f"fig5 availability ({label}):")
        for row in paper_design_availability(tr).values():
            print("  " + row.row())
    return launches


# ------------------------------------------------------------ 6. graph
def _hold(got: torch.Tensor, want: torch.Tensor, exact: bool):
    """(mismatching elements, max abs difference) of a kernel's output
    against its plain version's: equal bits when ``exact``, else within
    PUSH_RTOL and PUSH_ATOL_REL x max|want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    diff = (got.double() - want.double()).abs()
    if exact:
        bad = got != want
    else:
        atol = PUSH_ATOL_REL * float(want.abs().max())
        bad = diff > PUSH_RTOL * want.double().abs() + atol
    return int(bad.sum()), float(diff.max()) if diff.numel() else 0.0


def _tally(out: dict, name: str, count: int, held) -> None:
    rec = out.setdefault(name, {"words": 0, "mismatches": 0,
                                "max_abs_err": 0.0})
    rec["words"] += count
    rec["mismatches"] += held[0]
    rec["max_abs_err"] = max(rec["max_abs_err"], held[1])


def push_keys(topo: dict, n: int) -> torch.Tensor:
    """(E,) int32: each edge's destination where the push kernels test it
    in range (dense: 0 <= dst < n; blocked: in its tile's clipped
    destination block), else -1, as ``csrc/segsum.cu`` keys its runs."""
    from repro_torch.graph.generate import node_block_of
    dst = topo["dst"]
    blocks = topo.get("blocks")
    if blocks is None:
        return torch.where((dst >= 0) & (dst < n), dst, -1)
    db = blocks["dst_block"]
    bn = node_block_of({"topology": topo})
    d0 = (db.long().clamp(0, n // bn - 1) * bn).repeat_interleave(
        dst.shape[0] // db.shape[0])
    return torch.where((dst >= d0) & (dst < d0 + bn), dst, -1)


def push_atomics(key: torch.Tensor, group: int) -> int:
    """Float64 atomics a push issues when each run of equal key >= 0 is
    added once per ``group`` consecutive edges (a warp's edges: 32 x K)."""
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    head[::group] = True
    return int((head & (key >= 0)).sum())


def profile_split(fn, tries: int = 5) -> list:
    """[(device event, ms, count)] of one warm call of ``fn`` under
    ``torch.profiler``: the memset, kernels and copies it ran. On an H100
    a profiling session late in a long process sometimes returns none of
    a short call's device events (or a part of them), so the session is
    repeated, up to
    ``tries`` times, until the events add up to within 15 % of the call's
    CUDA-event time; [] if no session did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    want = _cuda_ms(fn, reps=5)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            _sync()
        split = [(e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0]
        if abs(sum(ms for _, ms, _ in split) - want) <= 0.15 * want:
            return split
    return []


def _check_push_pair(out, name, kernel, plain, xs) -> None:
    """``kernel(x)`` against ``plain(x)`` for each (x, exact) of ``xs``."""
    for x, exact in xs:
        _tally(out, name, 0, _hold(kernel(x), plain(x), exact))


def _frontier_inputs(rng, n: int, dev):
    """pushed (zeros, positive, negative, NaN and infinite mass), visited
    (0/1 and a few struck values) and dist, (1, n) on the card."""
    pushed = rng.random(n).astype(np.float32)
    pushed[rng.random(n) < 0.6] = 0.0
    special = rng.choice(n, 4 * 1024, replace=False)
    pushed[special] = np.repeat(np.float32([-1.0, np.nan, np.inf, -np.inf]),
                                1024)
    visited = (rng.random(n) < 0.5).astype(np.int32)
    visited[rng.choice(n, 1024, replace=False)] = 1 << 20
    dist = np.where(visited > 0, rng.integers(0, 7, n), -1).astype(np.int32)
    return tuple(torch.from_numpy(a.reshape(1, n)).to(dev)
                 for a in (pushed, visited, dist))


def check_graph_kernels(dev):
    """Kernels 10-12 against their plain versions on the card: 8 Mi edges
    over 2**22 nodes sorted by destination, HOT_EDGES of them into one
    node, 1/64 sentinel padding, 1/256 struck ids (negative and far out of
    range); the blocked push on the same edges bucketed in 65,536-node
    blocks with struck ids and 64 struck ``src_block`` entries; integer x
    (every order sums it exactly: bit for bit) and random float32 x
    (within the push tolerance); the frontier step on 2**22 nodes, exact.
    The pushes also on the shapes their K-edge groups must handle: edge
    arrays from edge 1 (not 16-byte aligned, E - 1 edges), cut 3 short of
    E, and with src and dst on different alignments; the blocked push
    with 64 tiles whose ``dst_block`` moved (every edge drops), and on the
    same edges in tiles of 100 (the general tile path), also from edge 1."""
    from repro_torch.graph import bucket_edges
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.segsum import (edge_segment_push,
                                            edge_segment_push_blocked,
                                            frontier_update)
    rng = np.random.default_rng(SEED + 6)
    n, e, bn = 1 << GRAPH_SCALE, PUSH_CHECK_EDGES, GRAPH_NODE_BLOCK
    hub = n // 3
    src = rng.integers(0, n, e)
    dst = np.sort(np.concatenate([rng.integers(0, n, e - HOT_EDGES),
                                  np.full(HOT_EDGES, hub)]))
    bsrc, bdst, tsb, tdb = bucket_edges(src, dst, n, bn)
    odd = list(bucket_edges(src, dst, n, bn, edge_tile=100))
    src[-e // 64:] = n
    dst[-e // 64:] = n

    def strike(ids, k):
        hit = rng.choice(ids.size, k, replace=False)
        ids[hit] = rng.integers(-4 * n, 4 * n, k)

    for ids in (src, dst, bsrc, bdst):
        strike(ids, e // 512)
    tsb[rng.choice(tsb.size, 64, replace=False)] = rng.integers(
        -8, n // bn + 8, 64)
    card = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (src, dst, bsrc, bdst, tsb, tdb)]
    xs = [(torch.from_numpy(rng.integers(0, 8, (1, n)).astype(
              np.float32)).to(dev), True),
          (torch.from_numpy(rng.random((1, n)).astype(np.float32)).to(dev),
           False)]
    # the edge cases draw from their own generator, so the cases above
    # keep their inputs
    rng_odd = np.random.default_rng(SEED + 8)

    def moved(tables_db, k):
        """dst_block with k tiles moved one block on: they drop every
        edge."""
        db = tables_db.copy()
        hit = rng_odd.choice(db.size, k, replace=False)
        db[hit] = (db[hit] + 1) % (n // bn)
        return db

    for ids in odd[:2]:
        hit = rng_odd.choice(ids.size, e // 512, replace=False)
        ids[hit] = rng_odd.integers(-4 * n, 4 * n, e // 512)
    odd[3] = moved(odd[3], 64)
    odd = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in odd]
    t_odd = odd[2].shape[0] - 1
    cases = {
        "segsum_push": {
            "whole": (card[0], card[1]),
            "from edge 1": (card[0][1:], card[1][1:]),
            "E - 3 edges": (card[0][:-3], card[1][:-3]),
            "src, dst unaligned apart": (card[0][1:-1], card[1][2:])},
        "segsum_push_blocked": {
            "tiles of 512": tuple(card[2:]),
            "64 dst_block moved": (card[2], card[3], card[4], torch.from_numpy(
                moved(tdb, 64).astype(np.int32)).to(dev)),
            "tiles of 100": tuple(odd),
            "tiles of 100 from edge 1": (
                odd[0][1:1 + 100 * t_odd], odd[1][1:1 + 100 * t_odd],
                odd[2][:t_odd], odd[3][:t_odd])}}
    kernels = {
        "segsum_push": (edge_segment_push, ref.edge_segment_push_ref, {}),
        "segsum_push_blocked": (edge_segment_push_blocked,
                                ref.edge_segment_push_blocked_ref,
                                {"node_block": bn})}
    before = dict(_build.LAUNCHES)
    out, lines = {}, []
    for name, by_case in cases.items():
        kernel, plain, kw = kernels[name]
        for case, args in by_case.items():
            seen = out.get(name, {}).get("mismatches", 0)
            _check_push_pair(out, name, lambda x: kernel(*args, x, **kw),
                             lambda x: plain(*args, x, **kw), xs)
            out[name]["words"] += int(args[0].shape[0])
            lines.append(f"{name} [{case}] edges={args[0].shape[0]} "
                         f"mismatches={out[name]['mismatches'] - seen}")
    print("push edge cases (integer x bit-exact, float32 x within the push "
          "tolerance): " + "; ".join(lines))
    fr = _frontier_inputs(rng, n, dev)
    for level in (1, 7):
        for got, want in zip(frontier_update(*fr, level),
                             ref.frontier_update_ref(*fr, level)):
            _tally(out, "frontier_update", n, _hold(got, want, True))
    _sync()
    hub_in = int((card[1] == hub).sum())
    for name, rec in out.items():
        rec["launches"] = _build.LAUNCHES[name] - before[name]
    print("graph kernels (push: integer x bit-exact, float32 x within "
          f"rtol {PUSH_RTOL} + {PUSH_ATOL_REL} x max|y| of the plain "
          "version's float64 sums; frontier bit-exact; hub in-edges "
          f"{hub_in}): " + "; ".join(
              f"{k} edges_or_nodes={v['words']} mismatches={v['mismatches']} "
              f"max_abs_err={v['max_abs_err']!r} launches={v['launches']}"
              for k, v in out.items()))
    bad = [k for k, v in out.items() if v["mismatches"] or not v["launches"]]
    if bad:
        raise AssertionError(f"graph kernels disagree with their plain "
                             f"versions or did not launch: {bad}")
    return out


def graph_build(dev):
    """Graph500 scale 22, edge factor 16: ``powerlaw_graph(2**22,
    avg_degree=16)`` on the host, then its dense and node-blocked states
    on the card."""
    from repro_torch.graph import graph_state, powerlaw_graph
    t = time.perf_counter()
    g = powerlaw_graph(1 << GRAPH_SCALE, avg_degree=GRAPH_DEGREE, seed=SEED)
    gen_s = time.perf_counter() - t
    (dense, dense_ms) = _timed(lambda: graph_state(g, with_bfs=True,
                                                   source=0, device=dev))
    (blocked, blocked_ms) = _timed(lambda: graph_state(
        g, with_bfs=True, source=0, node_block=GRAPH_NODE_BLOCK,
        device=dev))
    tiles = int(blocked["topology"]["blocks"]["src_block"].shape[0])
    print(f"graph: powerlaw_graph(2**{GRAPH_SCALE}, avg_degree="
          f"{GRAPH_DEGREE}, seed={SEED}) nodes={g.n} edges={g.n_edges} "
          f"max_in_degree={g.max_in_degree} max_out_degree="
          f"{int(g.out_degree.max())} dense_edges_padded="
          f"{dense['topology']['src'].shape[0]} blocked_edges_padded="
          f"{blocked['topology']['src'].shape[0]} tiles={tiles} "
          f"node_block={GRAPH_NODE_BLOCK} host_generate_s={gen_s:.1f} "
          f"dense_state_s={dense_ms / 1e3:.1f} blocked_state_s="
          f"{blocked_ms / 1e3:.1f} (bucketing included)")
    return g, dense, blocked


def _pagerank_x(state) -> torch.Tensor:
    """The push's input of PageRank's first iteration on ``state``."""
    outdeg = state["topology"]["outdeg"].float()
    rank = state["rank"]["rank"]
    return torch.where(outdeg > 0, rank / outdeg.clamp_min(1.0), 0.0)


def check_graph_main_shapes(g, dense, blocked):
    """Kernels 10-12 against their plain versions on the main path's
    tensors: both pushes over the whole graph with integer x (bit for bit)
    and with PageRank's first input (within the push tolerance), the
    frontier step over the 2**22-node vectors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segsum import (edge_segment_push,
                                            edge_segment_push_blocked,
                                            frontier_update)
    gen = torch.Generator(device=dense["rank"]["rank"].device)
    gen.manual_seed(SEED + 7)
    out = {}
    for name, state, kernel, plain in (
            ("segsum_push", dense,
             lambda t, x: edge_segment_push(t["src"], t["dst"], x),
             lambda t, x: ref.edge_segment_push_ref(t["src"], t["dst"], x)),
            ("segsum_push_blocked", blocked,
             lambda t, x: edge_segment_push_blocked(
                 t["src"], t["dst"], t["blocks"]["src_block"],
                 t["blocks"]["dst_block"], x, node_block=GRAPH_NODE_BLOCK),
             lambda t, x: ref.edge_segment_push_blocked_ref(
                 t["src"], t["dst"], t["blocks"]["src_block"],
                 t["blocks"]["dst_block"], x, node_block=GRAPH_NODE_BLOCK))):
        topo = state["topology"]
        x_int = torch.randint(0, 8, state["rank"]["rank"].shape,
                              generator=gen, device=gen.device).float()
        _check_push_pair(out, name, lambda x: kernel(topo, x),
                         lambda x: plain(topo, x),
                         [(x_int, True), (_pagerank_x(state), False)])
        out[name]["words"] = int(topo["src"].shape[0])
    fr = blocked["frontier"]
    topo = blocked["topology"]
    pushed = edge_segment_push_blocked(
        topo["src"], topo["dst"], topo["blocks"]["src_block"],
        topo["blocks"]["dst_block"], fr["frontier"].float(),
        node_block=GRAPH_NODE_BLOCK)
    for got, want in zip(frontier_update(pushed, fr["visited"], fr["dist"],
                                         1),
                         ref.frontier_update_ref(pushed, fr["visited"],
                                                 fr["dist"], 1)):
        _tally(out, "frontier_update", got.numel(), _hold(got, want, True))
    _sync()
    print("graph kernels at main-path shapes: " + "; ".join(
        f"{k} edges_or_nodes={v['words']} mismatches={v['mismatches']} "
        f"max_abs_err={v['max_abs_err']!r}" for k, v in out.items()))
    bad = [k for k, v in out.items() if v["mismatches"]]
    if bad:
        raise AssertionError(f"graph kernels disagree with their plain "
                             f"versions at the main path's shapes: {bad}")
    return out


def _bfs_golden(g) -> torch.Tensor:
    """BFS distances from node 0 by scipy's shortest paths on the CSR
    (edge u -> v is row u, column v), -1 where unreached."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path
    adj = sp.csr_matrix((np.ones(g.n_edges, np.int8), g.indices, g.indptr),
                        shape=(g.n, g.n)).T.tocsr()
    d = shortest_path(adj, directed=True, unweighted=True, indices=0)
    return torch.from_numpy(np.where(np.isfinite(d), d, -1).astype(np.int32))


def _same_domain(a, b) -> bool:
    """Two domains hold the same payload and sidecar bytes."""
    if any(not torch.equal(_bytes(a.leaf(p)), _bytes(b.leaf(p)))
           for p in a.paths()):
        return False
    return all(torch.equal(_bytes(a.sidecar[t][k]), _bytes(b.sidecar[t][k]))
               for t in a.sidecar for k in a.sidecar[t])


def _graph_scrubbed(g, blocked, golden_top, golden_dist):
    """Under detect_recover_l (topology on SEC-DED, rank and frontier on
    Par+R): a single-bit strike into a ``src`` id, healed by
    ``pagerank_scrubbed``'s slices with the top-8 equal to golden;
    ``bfs_scrubbed`` with ``dist`` equal to golden (on the clean domain:
    a BFS level can cross a struck edge before its slice is scrubbed); 16
    strikes scrubbed by the 8 cursors of ``scrub_partial``, equal bit for
    bit to one ``scrub``. Returns the printed summary."""
    from repro_torch.core import InjectionPlan, MemoryDomain, detect_recover_l
    from repro_torch.graph import bfs_scrubbed, pagerank_scrubbed, top_k
    dom = MemoryDomain.protect({"graph": blocked}, detect_recover_l())
    src_words = dom.spec.by_path["graph/topology/src"].rows * 256
    plan = InjectionPlan(np.array([src_words // 3], np.int32),
                         np.array([20], np.int32), hard=False)
    struck = dom.apply_plan("graph/topology/src", plan)
    (healed, rank, _, rep), pr_ms = _timed(lambda: pagerank_scrubbed(
        struck, g.n, iters=SCRUB_ITERS, scrub_slices=SCRUB_SLICES))
    corr, unc = rep.totals()
    topo_ok = all(torch.equal(healed.leaf(p), dom.leaf(p))
                  for p in dom.paths() if "/topology/" in p)
    top_ok = torch.equal(top_k(rank, g.n, 8).cpu(), golden_top)
    (_, dist, brep), bfs_ms = _timed(lambda: bfs_scrubbed(
        dom, scrub_slices=SCRUB_SLICES))
    bcorr, bunc = brep.totals()
    dist_ok = torch.equal(dist[0, :g.n].cpu(), golden_dist)
    bad, _ = dom.inject(np.random.default_rng(SEED), 16,
                        multi_bit_fraction=0.0)
    full, frep = bad.scrub()
    part, total = bad, 0
    for c in range(SCRUB_SLICES):
        part, prep = part.scrub_partial(c, slices=SCRUB_SLICES)
        total += prep.totals()[0]
    cycle_ok = _same_domain(full, part) and total == frep.totals()[0]
    summary = (f"graph_scrubbed (detect_recover_l): strike "
               f"graph/topology/src word {src_words // 3} bit 20; "
               f"pagerank_scrubbed iters={SCRUB_ITERS} slices="
               f"{SCRUB_SLICES} corrected={corr} uncorrectable={unc} "
               f"topology_restored={topo_ok} top8_equal_golden={top_ok} "
               f"ms={pr_ms:.1f}; bfs_scrubbed corrected={bcorr} "
               f"uncorrectable={bunc} "
               f"dist_equal_golden={dist_ok} ms={bfs_ms:.1f}; scrub_partial "
               f"x{SCRUB_SLICES} == scrub: {cycle_ok} (corrected {total})")
    if not (corr >= 1 and not unc and topo_ok and top_ok and not bcorr
            and not bunc and dist_ok and cycle_ok and total):
        raise AssertionError(summary)
    return summary


def run_graph_paths(g, dense, blocked, by_path: dict):
    """The graph workload's main paths, each with its launch counters
    reset just before it: PageRank (20 iterations) dense and node-blocked,
    BFS from node 0 dense and frontier-sparse, and the scrubbed drills;
    then each result held against the plain versions' run on the card
    (ranks within the push tolerance, top-8 equal; distances equal, and
    equal to scipy's)."""
    from repro_torch.core import DESIGN_POINTS, MemoryDomain
    from repro_torch.graph import bfs, pagerank, top_k
    from repro_torch.kernels import _build
    n = g.n
    graph_dom = MemoryDomain.protect({"graph": blocked},
                                     DESIGN_POINTS["detect_recover_l"]())
    need_scrub = _needed_kernels(graph_dom) | {"segsum_push_blocked",
                                               "frontier_update"}
    del graph_dom
    golden_dist = _bfs_golden(g)
    _, gold_rank, _ = pagerank(blocked, n, iters=SCRUB_ITERS)
    golden_top = top_k(gold_rank, n, 8).cpu()
    del gold_rank
    results, lines = {}, []
    for name, need, fn in (
            ("pagerank_dense", {"segsum_push"},
             lambda: pagerank(dense, n, iters=PR_ITERS)[1]),
            ("pagerank_blocked", {"segsum_push_blocked"},
             lambda: pagerank(blocked, n, iters=PR_ITERS)[1]),
            ("bfs_dense", {"segsum_push", "frontier_update"},
             lambda: bfs(dense)[1]),
            ("bfs_sparse", {"segsum_push_blocked", "frontier_update"},
             lambda: bfs(blocked)[1]),
            ("graph_scrubbed", need_scrub,
             lambda: _graph_scrubbed(g, blocked, golden_top, golden_dist))):
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        results[name], ms = _timed(fn)
        _path_launches(name, need, by_path)
        lines.append(f"{name}: wall_ms={ms:.1f} peak_bytes="
                     f"{torch.cuda.max_memory_allocated()}")
    print(results.pop("graph_scrubbed"))
    for line in lines:
        print(line)
    plain = {"pagerank_dense": pagerank(dense, n, iters=PR_ITERS,
                                        backend="segment_sum")[1],
             "pagerank_blocked": pagerank(blocked, n, iters=PR_ITERS,
                                          backend="segment_sum")[1],
             "bfs_dense": bfs(dense, backend="segment_sum")[1],
             "bfs_sparse": bfs(blocked, backend="segment_sum")[1]}
    top_plain = top_k(plain["pagerank_dense"], n, 8)
    checks = {}
    for name in ("pagerank_dense", "pagerank_blocked"):
        mism, err = _hold(results[name], plain[name], False)
        checks[name + " vs plain"] = not mism
        checks[name + " top8"] = torch.equal(top_k(results[name], n, 8),
                                             top_plain)
        print(f"{name}: rank vs plain version mismatches={mism} "
              f"max_abs_err={err!r} "
              f"top8={top_k(results[name], n, 8).tolist()}")
    checks["pagerank dense vs blocked"] = not _hold(
        results["pagerank_dense"], results["pagerank_blocked"], False)[0]
    for name in ("bfs_dense", "bfs_sparse"):
        checks[name + " vs plain"] = torch.equal(results[name], plain[name])
        checks[name + " vs scipy"] = torch.equal(
            results[name][0, :n].cpu(), golden_dist)
    checks["bfs dense vs sparse"] = torch.equal(results["bfs_dense"],
                                                results["bfs_sparse"])
    levels = int(results["bfs_sparse"].max())
    print(f"graph checks (levels={levels}, reached="
          f"{int((golden_dist >= 0).sum())}): " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"graph paths disagree: {checks}")


def time_graph(g, dense, blocked):
    """Kernels 10-12 and their plain versions at the main path's shapes
    (CUDA events; PageRank's first push input, the first BFS level), each
    beside its byte bound and, for the pushes, one ``index_add_`` of the
    pre-masked contributions into N + 1 bins, timed as a yardstick only.
    The bound is the bytes: a push does one float64 add per counted edge
    (``ops``, printed) against 8 bytes of ids, the frontier step a compare
    per node against 24 bytes, so no operation bound is computed and the
    kernels line carries ``ops_bound_ms`` null for them. Each push's call
    is also split into its device events under ``torch.profiler`` and its
    float64 atomics counted from ``dst`` (one per run of equal destination
    per warp's edges, this design's and the one-edge-a-thread one's).
    Then the card's
    versions of ``BENCH_graph_scale.json``'s quantities:
    PageRank edges/s dense and blocked, frontier-sparse over dense-blocked
    BFS speedup, and ``pagerank_scrubbed``'s overhead per iteration over
    the plain loop."""
    from repro_torch.core import MemoryDomain, detect_recover_l
    from repro_torch.graph import bfs, pagerank, pagerank_scrubbed
    from repro_torch.kernels import ref
    from repro_torch.kernels.segsum import (edge_segment_push,
                                            edge_segment_push_blocked,
                                            frontier_update)
    n_pad = dense["rank"]["rank"].shape[1]
    out = {}
    for name, state in (("segsum_push", dense),
                        ("segsum_push_blocked", blocked)):
        topo = state["topology"]
        src, dst = topo["src"], topo["dst"]
        x = _pagerank_x(state)
        e = src.shape[0]
        nbytes = e * 8 + n_pad * 8
        if name == "segsum_push":
            kern = lambda: edge_segment_push(src, dst, x)
            plain = lambda: ref.edge_segment_push_ref(src, dst, x)
            ok = (src >= 0) & (src < n_pad) & (dst >= 0) & (dst < n_pad)
        else:
            sb, db = topo["blocks"]["src_block"], topo["blocks"]["dst_block"]
            kern = lambda: edge_segment_push_blocked(
                src, dst, sb, db, x, node_block=GRAPH_NODE_BLOCK)
            plain = lambda: ref.edge_segment_push_blocked_ref(
                src, dst, sb, db, x, node_block=GRAPH_NODE_BLOCK)
            nbytes += sb.shape[0] * 8
            te = e // sb.shape[0]
            bn = GRAPH_NODE_BLOCK
            sbe = sb.long().repeat_interleave(te) * bn
            dbe = db.long().repeat_interleave(te) * bn
            ok = (src >= sbe) & (src < sbe + bn) & (dst >= dbe) & \
                (dst < dbe + bn)
            del sbe, dbe
        contrib = torch.where(ok, x[0, src.clamp(0, n_pad - 1).long()], 0.0)
        seg = torch.where(ok, dst, n_pad)
        adds = int(ok.sum())
        del ok

        def library():
            return torch.zeros(n_pad + 1, device=x.device).index_add_(
                0, seg, contrib)

        out[name] = {"ms": _cuda_ms(kern, reps=20),
                     "plain_ms": _cuda_ms(plain, reps=3),
                     "library_ms": _cuda_ms(library, reps=20),
                     "bytes": nbytes, "ops": adds}
        del contrib, seg
        split = profile_split(kern)
        print(f"profile {name} (one warm call, device time): " + ("; ".join(
            f"{key[:48]} {ms:.4f} ms" for key, ms, _ in split) or
            "not measured: no profiling session returned the call's device "
            "events"))
        key = push_keys(topo, n_pad)
        print(f"atomics {name} (float64, counted on the card from dst): "
              f"{push_atomics(key, PUSH_WARP_EDGES)} at {PUSH_WARP_EDGES}-"
              f"edge warps; {push_atomics(key, ONE_EDGE_WARP_EDGES)} at "
              f"{ONE_EDGE_WARP_EDGES}-edge warps (one edge a thread)")
        del key
    fr = blocked["frontier"]
    pushed = edge_segment_push_blocked(
        blocked["topology"]["src"], blocked["topology"]["dst"],
        blocked["topology"]["blocks"]["src_block"],
        blocked["topology"]["blocks"]["dst_block"], fr["frontier"].float(),
        node_block=GRAPH_NODE_BLOCK)
    args = (pushed, fr["visited"], fr["dist"], 1)
    out["frontier_update"] = {
        "ms": _cuda_ms(lambda: frontier_update(*args), reps=50),
        "plain_ms": _cuda_ms(lambda: ref.frontier_update_ref(*args), reps=10),
        "library_ms": None, "bytes": n_pad * 24, "ops": n_pad,
        # a call's time is host-bound: beside it the kernel's own time,
        # from launches replayed in a CUDA graph (as the bit-flip kernel's)
        "device_ms": _graph_ms(lambda: frontier_update(*args),
                               BITFLIP_GRAPH_LAUNCHES)}
    for name, rec in out.items():
        rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
        rec["ops_bound_ms"] = None
        lib = rec["library_ms"]
        print(f"time {name}: ms={rec['ms']:.4f} plain_ms="
              f"{rec['plain_ms']:.3f} library_ms="
              f"{'null' if lib is None else f'{lib:.4f}'} bound_ms="
              f"{rec['bound_ms']:.4f} (bytes={rec['bytes']}) ops="
              f"{rec['ops']} of_bound={rec['bound_ms'] / rec['ms']:.3f}"
              + (f" device_ms={rec['device_ms']:.5f} (CUDA graph of "
                 f"{BITFLIP_GRAPH_LAUNCHES} launches) of_bound_device="
                 f"{rec['bound_ms'] / rec['device_ms']:.3f}"
                 if "device_ms" in rec else ""))
    # BENCH_graph_scale.json's quantities, warm, on the card
    n = g.n
    per_iter = {}
    for name, state in (("dense", dense), ("blocked", blocked)):
        pagerank(state, n, iters=1)
        _, ms = _timed(lambda: pagerank(state, n, iters=PR_ITERS))
        per_iter[name] = ms / PR_ITERS
    bfs(blocked)
    (_, dist), sparse_ms = _timed(lambda: bfs(blocked))
    bfs(blocked, sparse=False)
    _, blocked_dense_ms = _timed(lambda: bfs(blocked, sparse=False))
    _, dense_ms = _timed(lambda: bfs(dense))
    dom = MemoryDomain.protect({"graph": blocked}, detect_recover_l())
    pagerank_scrubbed(dom, n, iters=SCRUB_SLICES, scrub_slices=SCRUB_SLICES)
    _, scrub_ms = _timed(lambda: pagerank_scrubbed(
        dom, n, iters=SCRUB_ITERS, scrub_slices=SCRUB_SLICES))
    _, plain_ms = _timed(lambda: pagerank(blocked, n, iters=SCRUB_ITERS))
    scrub_iter, plain_iter = scrub_ms / SCRUB_ITERS, plain_ms / SCRUB_ITERS
    print(f"graph_scale (card): pagerank_iter_ms dense={per_iter['dense']:.3f}"
          f" blocked={per_iter['blocked']:.3f} edges_per_s dense="
          f"{g.n_edges / per_iter['dense'] * 1e3:.4g} blocked="
          f"{g.n_edges / per_iter['blocked'] * 1e3:.4g}; bfs levels="
          f"{int(dist.max())} sparse_ms={sparse_ms:.1f} "
          f"dense_blocked_ms={blocked_dense_ms:.1f} dense_layout_ms="
          f"{dense_ms:.1f} sparse_speedup={blocked_dense_ms / sparse_ms:.3f}"
          f"; pagerank_scrubbed iter_ms={scrub_iter:.3f} plain_iter_ms="
          f"{plain_iter:.3f} overhead_pct="
          f"{100 * (scrub_iter - plain_iter) / plain_iter:.1f} "
          f"(detect_recover_l, slices={SCRUB_SLICES})")
    return out


# ------------------------------------------------------- 7. campaigns
def _timed_eval(ev, log: list):
    """``ev`` with each query's wall ms, the device synchronised before and
    after, appended to ``log``."""
    def timed(state):
        out, ms = _timed(lambda: ev(state))
        log.append(ms)
        return out
    return timed


def _check_query(name: str, ev, dom, unwrap) -> None:
    """Before the campaign: DETERMINISM_RERUNS clean re-runs give the golden
    tokens bit for bit, and a plan that flips one bit of the largest leaf
    twice classifies as masked."""
    from repro_torch.core import InjectionPlan, Outcome, characterize
    golden = ev(unwrap(dom.payload))[0]
    for i in range(DETERMINISM_RERUNS):
        if not torch.equal(ev(unwrap(dom.payload))[0], golden):
            raise AssertionError(f"{name}: clean re-run {i + 1} gave other "
                                 "tokens than the golden run")
    leaf = max(dom.spec.protectable, key=lambda s: s.nbytes)
    twice = InjectionPlan(np.array([0, 0] + [-1] * 6, np.int32),
                          np.array([5, 5] + [0] * 6, np.int32), False)
    o = characterize._run_trial(dom, leaf, twice, ev, golden, unwrap,
                                False, "params", False, 1)
    if o not in (Outcome.MASKED_OVERWRITE, Outcome.MASKED_LOGIC):
        raise AssertionError(f"{name}: a bit flipped twice classified {o}")
    print(f"{name}: determinism: {DETERMINISM_RERUNS} clean re-runs == "
          f"golden bit for bit; {leaf.path} bit flipped twice -> {o.value}")


def _strike_split(dom, strikes) -> dict:
    """Mean ms per trial of the campaign's strikes, replayed on the clean
    domain (each hard trial applies its plan HARD_REPEAT times): the whole
    ``apply_plan``, and its pack, flip (with the plan's copy to the card)
    and unpack, each timed alone with the device synchronised."""
    from repro_torch.core.domain import _strikes
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitflip import bitflip_words_
    tot = dict.fromkeys(("apply", "pack", "flip", "unpack"), 0.0)
    for kind, s, plan in strikes:
        leaf = dom.leaf(s.path)
        for _ in range(HARD_REPEAT if kind == "hard" else 1):
            tot["apply"] += _timed(lambda: dom.apply_plan(s.path, plan))[1]
            words, ms = _timed(lambda: ops.pack_words(leaf))
            tot["pack"] += ms
            tot["flip"] += _timed(lambda: bitflip_words_(
                words, *_strikes(plan, leaf.device)))[1]
            tot["unpack"] += _timed(lambda: ops.unpack_words(
                words, s.shape, s.torch_dtype))[1]
            del words
    return {k: v / len(strikes) for k, v in tot.items()}


def _print_figs(name: str, res) -> None:
    """The Fig. 3 row (crash and incorrect rates by error kind) and the
    Fig. 4 rows (per region and kind)."""
    print(f"fig3 {name}: " + "; ".join(
        f"{kind} crash={res.crash_prob(kind=kind):.4f} "
        f"incorrect={res.incorrect_prob(kind=kind):.4f}"
        for kind in ("soft", "hard")) + f"; all crash="
        f"{res.crash_prob():.4f} incorrect={res.incorrect_prob():.4f}")
    for (region, kind), st in sorted(res.stats.items()):
        print(f"fig4 {name}: {region:16s} {kind:4s} crash="
              f"{st.crash_prob:.4f} incorrect={st.incorrect_prob:.4f} "
              f"tolerance={st.tolerance:.4f} n={st.total}")


def _campaign(name: str, ev, state, n_trials: int, need: set,
              by_path: dict):
    """One application's Fig. 2 campaign through ``run_campaign``
    (n_trials soft and n_trials hard trials, HARD_REPEAT queries a hard
    trial), its launches counted on their own; prints its rates, trials
    per second and ms per trial split into strike, query and classify
    (the rest of the trial: verdicts, the device sync, domain glue).
    Returns (domain, unwrap, result, strikes)."""
    from repro_torch.core import characterize
    from repro_torch.kernels import _build
    dom, _, unwrap = characterize._campaign_domain(state, "params")
    _check_query(name, ev, dom, unwrap)
    evals: list = []
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res, wall_ms = _timed(lambda: characterize.run_campaign(
        _timed_eval(ev, evals), dom, n_trials=n_trials, seed=SEED,
        hard_repeat=HARD_REPEAT))
    _path_launches(name, need, by_path)
    peak = torch.cuda.max_memory_allocated()
    strikes = list(characterize._campaign_strikes(
        dom, n_trials=n_trials, errors_per_trial=1, seed=SEED,
        kinds=("soft", "hard"), region_filter=None))
    if [s.path for _, s, _ in strikes] != [p for p, _, _ in res.trials]:
        raise AssertionError(f"{name}: the replayed strikes differ")
    split = _strike_split(dom, strikes)
    trials = len(res.trials)
    run_ms = wall_ms - evals[0]             # the golden query excluded
    trial_ms = run_ms / trials
    eval_ms = sum(evals[1:]) / trials
    counts = {o.value: sum(t[2] is o for t in res.trials)
              for o in characterize.Outcome}
    print(f"campaign {name}: trials={trials} ({n_trials} soft, {n_trials} "
          f"hard x{HARD_REPEAT} queries) queries={len(evals) - 1} "
          f"wall_s={run_ms / 1e3:.3f} trials_per_s={trials / run_ms * 1e3:.2f}"
          f" ms_per_trial={trial_ms:.3f} strike_ms={split['apply']:.3f} "
          f"(pack={split['pack']:.3f} flip={split['flip']:.3f} "
          f"unpack={split['unpack']:.4f}) eval_ms={eval_ms:.3f} "
          f"(golden query {evals[0]:.2f} ms; one query "
          f"{sum(evals[1:]) / (len(evals) - 1):.3f} ms) classify_ms="
          f"{trial_ms - eval_ms - split['apply']:.3f} peak_bytes={peak} "
          f"outcomes={json.dumps(counts)}")
    _print_figs(name, res)
    return dom, unwrap, res, strikes


def _plain_bitflip(words, word_idx, bit_idx):
    """``bitflip_words_`` by the plain version, on any device."""
    from repro_torch.kernels import ref
    words.copy_(ref.bitflip_ref(words, word_idx, bit_idx))
    return words


def _plain_flip_rerun(name: str, ev, dom, unwrap, res, strikes) -> None:
    """Re-run the first PLAIN_FLIP_TRIALS trials with the plain bit flip in
    place of the kernel (``ops.bitflip_words_`` swapped for the length of
    the re-run); their outcomes must equal the campaign's."""
    from repro_torch.core import characterize
    from repro_torch.kernels import _build, ops
    golden = ev(unwrap(dom.payload))[0]
    launched = _build.LAUNCHES["bitflip"]
    kernel_flip, ops.bitflip_words_ = ops.bitflip_words_, _plain_bitflip
    try:
        plain = [characterize._run_trial(dom, s, plan, ev, golden, unwrap,
                                         False, "params", kind == "hard",
                                         HARD_REPEAT)
                 for kind, s, plan in strikes[:PLAIN_FLIP_TRIALS]]
    finally:
        ops.bitflip_words_ = kernel_flip
    kernel = [o for _, _, o in res.trials[:PLAIN_FLIP_TRIALS]]
    same = plain == kernel and _build.LAUNCHES["bitflip"] == launched
    print(f"{name}: first {PLAIN_FLIP_TRIALS} trials re-run with the plain "
          f"bit flip: outcomes identical to the kernel's: {same} "
          f"({[o.value for o in plain]})")
    if not same:
        raise AssertionError(f"{name}: plain and kernel bit flips disagree")


def _lm_sensitivity(cfg, batch, dom, strikes) -> None:
    """What an LM trial's verdict reads: the golden logits' top-2 margins
    over the vocabulary beside their scale, and how many of the query's
    positions change their greedy token under each of the first
    PLAIN_FLIP_TRIALS strikes (applied once)."""
    from repro_torch.models import forward
    logits = forward(dom.payload, batch, cfg)[0]
    top2 = logits.topk(2, dim=-1).values.float()
    margin = (top2[..., 0] - top2[..., 1]).reshape(-1)
    golden = logits.argmax(-1)
    scale = float(logits.abs().max())
    del logits, top2
    changed = [int((forward(dom.apply_plan(s.path, plan).payload, batch,
                            cfg)[0].argmax(-1) != golden).sum())
               for _, s, plan in strikes[:PLAIN_FLIP_TRIALS]]
    print(f"campaign_lm sensitivity: golden top-2 margin min="
          f"{float(margin.min()):.3g} median={float(margin.median()):.3g} "
          f"max|logit|={scale:.3g}; positions changed (of "
          f"{golden.numel()}) under the first {PLAIN_FLIP_TRIALS} strikes:"
          f" {changed}")


def campaign_lm(params, by_path: dict) -> None:
    """Web-search LM: llama3-8b at full width, N_LAYERS layers (phase 3's
    parameters), the query greedy tokens of ``lm_batch(cfg,
    CAMPAIGN_BATCH, CAMPAIGN_SEQ, SEED)``."""
    from repro_torch.configs import get_config
    from repro_torch.core import lm_eval_fn
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import forward
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products are on: the queries would not "
                             "be the float32 model")
    cfg = get_config("llama3-8b").replace(n_layers=N_LAYERS)
    batch = lm_batch(cfg, CAMPAIGN_BATCH, CAMPAIGN_SEQ, SEED)
    ev = lm_eval_fn(cfg, batch, forward)
    print(f"campaign_lm: llama3-8b layers={cfg.n_layers} query=lm_batch("
          f"{CAMPAIGN_BATCH}x{CAMPAIGN_SEQ}) compute={cfg.compute_dtype}")
    dom, unwrap, res, strikes = _campaign("campaign_lm", ev, params,
                                          LM_TRIALS, {"bitflip"}, by_path)
    _plain_flip_rerun("campaign_lm", ev, dom, unwrap, res, strikes)
    _lm_sensitivity(cfg, batch, dom, strikes)


def campaign_kvstore(dev, by_path: dict) -> None:
    """kv-store: kvstore-demo at its full config (a 2**20-key float32
    value table and head), keys (2, 32) from a seeded generator."""
    from repro_torch.configs import get_config
    from repro_torch.core import lm_eval_fn, tree
    from repro_torch.models import forward, init_params
    cfg = get_config("kvstore-demo")
    params = init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    keys = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                         device=dev)
    ev = lm_eval_fn(cfg, {"tokens": keys}, forward)
    print(f"campaign_kvstore: kvstore-demo vocab={cfg.vocab_size} d_model="
          f"{cfg.d_model} params={sum(t.numel() for t in tree.leaves(params))} "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}) keys=2x32")
    _campaign("campaign_kvstore", ev, params, KV_TRIALS, {"bitflip"},
              by_path)


def campaign_graph(g, dense, by_path: dict) -> None:
    """Graph mining: the scale-22 dense state under ``HRMPolicy(
    "campaign/graph", {})``, the query the top-8 of 12 PageRank
    iterations."""
    from repro_torch.core import HRMPolicy, MemoryDomain
    from repro_torch.graph import pagerank_eval_fn
    dom = MemoryDomain.protect({"graph": dense},
                               HRMPolicy("campaign/graph", {}))
    ev = pagerank_eval_fn(g.n, iters=GRAPH_CAMPAIGN_ITERS)
    print(f"campaign_graph: nodes={g.n} edges={g.n_edges} query=top-8 of "
          f"pagerank_eval_fn(iters={GRAPH_CAMPAIGN_ITERS})")
    _campaign("campaign_graph", ev, dom, GRAPH_TRIALS,
              {"bitflip", "segsum_push"}, by_path)


def run_explore(by_path: dict) -> None:
    """``python -m repro_torch.launch.explore --workload all --design all
    --measure`` at the reference's default sizes, in this process so its
    launches are counted on their own; the measured ECC rates' cache is
    cleared first, so the explorer measures them through the kernels."""
    from repro_torch.core import eccmeasure
    from repro_torch.kernels import _build
    from repro_torch.launch import explore
    eccmeasure._class_rates.cache_clear()
    _build.reset_launches()
    rc, ms = _timed(lambda: explore.main(
        ["--workload", "all", "--design", "all", "--measure"]))
    _path_launches("explore", {
        "bitflip", "parity_encode", "parity_check", "bch_encode",
        "bch_scrub", "burst_encode", "burst_scrub", "segsum_push",
        "frontier_update"}, by_path)
    if rc:
        raise AssertionError(f"explore exited {rc}")
    print(f"explore --workload all --design all --measure: wall_s="
          f"{ms / 1e3:.3f}")


# ------------------------------------------------------- 7. trace engine
def _stdout_of(fn, *args) -> str:
    """What ``fn(*args)`` prints; it must return 0."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    if rc:
        raise AssertionError(f"{fn.__module__}.{fn.__name__} exited {rc}")
    return buf.getvalue()


def run_trace(dev, by_path: dict) -> None:
    """``core.tracegen`` writes one server-month (540 events); the Fig. 2
    campaign replays it on the full kvstore-demo (keys (2, 32)) twice, its
    first run's launches counted on their own, and both runs must classify
    every event alike; then ``explore --workload all --trace`` on the card
    must print what the same call prints with ``--device cpu``."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ErrorTrace, characterize, lm_eval_fn,
                                  tracegen)
    from repro_torch.kernels import _build
    from repro_torch.launch import explore
    from repro_torch.models import forward
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "month.npz"
    print("tracegen: " + _stdout_of(tracegen.main, [
        "--out", str(path), "--seed", str(TRACE_SEED)]).strip().replace(
        "\n", "; "))
    trace = ErrorTrace.load(path)
    cfg = get_config("kvstore-demo")
    params, keys = explore._kvstore_state(cfg, SEED, dev)
    ev = lm_eval_fn(cfg, {"tokens": keys}, forward)
    _build.reset_launches()
    first, ms = _timed(lambda: characterize.run_trace_campaign(
        ev, params, trace, hard_repeat=HARD_REPEAT))
    _path_launches("trace_campaign", {"bitflip"}, by_path)
    again = characterize.run_trace_campaign(ev, params, trace,
                                            hard_repeat=HARD_REPEAT)
    if first.trials != again.trials or len(first.trials) != len(trace):
        raise AssertionError("two replays of one trace classified "
                             "differently")
    counts = {o.value: sum(t[2] is o for t in first.trials)
              for o in characterize.Outcome}
    print(f"trace_campaign kvstore-demo: events={len(trace)} (hard "
          f"{int(trace.hard.sum())}, multi-bit {int((trace.burst > 1).sum())})"
          f" wall_s={ms / 1e3:.3f} trials_per_s={len(trace) / ms * 1e3:.2f} "
          f"outcomes={json.dumps(counts)} replayed twice: identical")
    _print_figs("trace_campaign", first)
    argv = ["--workload", "all", "--design", "all", "--trace", str(path)]
    card = _stdout_of(explore.main, argv)
    cpu = _stdout_of(explore.main, argv + ["--device", "cpu"])
    if card != cpu:
        raise AssertionError("explore --trace: the card's rows differ from "
                             "the CPU's")
    print(f"explore --workload all --trace: {card.count('ecc_src=trace')} "
          f"trace tables, {len(card.splitlines())} lines, card == cpu")


def kvstore_card_vs_cpu(dev) -> None:
    """The explorer's measured kv-store rows (``--workload kvstore
    --measure``) on the card beside the CPU's, now that both draw the same
    parameters and keys. Where the two campaigns' outcomes differ, prints
    the first differing trial and whether the bf16 forward's golden and
    struck tokens differ there; a difference is reported, not failed."""
    from repro_torch.configs import get_tiny
    from repro_torch.core import characterize, lm_eval_fn
    from repro_torch.launch import explore
    from repro_torch.models import forward
    argv = ["--workload", "kvstore", "--design", "all", "--measure"]
    card = _stdout_of(explore.main, argv)
    cpu = _stdout_of(explore.main, argv + ["--device", "cpu"])
    row = {}
    for name, text in (("card", card), ("cpu", cpu)):
        row[name] = next(line for line in text.splitlines()
                         if line.startswith("consumer_pc"))
        print(f"explore kvstore --measure {name}: {row[name]}")
    cfg = get_tiny("kvstore-demo")
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        params, keys = explore._kvstore_state(cfg, SEED, d)
        ev = lm_eval_fn(cfg, {"tokens": keys}, forward)
        res = characterize.run_campaign(ev, params,
                                        n_trials=EXPLORE_KV_TRIALS, seed=SEED)
        runs[name] = (params, ev, res)
    diff = [i for i, (a, b) in enumerate(zip(runs["card"][2].trials,
                                               runs["cpu"][2].trials))
            if a != b]
    line = (f"kvstore campaign card vs cpu: rows equal: {card == cpu}; "
            f"trials differing: {len(diff)} of "
            f"{len(runs['cpu'][2].trials)}")
    if diff:
        i = diff[0]
        dom, _, _ = characterize._campaign_domain(runs["cpu"][0], "params")
        kind, s, plan = list(characterize._campaign_strikes(
            dom, n_trials=EXPLORE_KV_TRIALS, errors_per_trial=1, seed=SEED,
            kinds=("soft", "hard"), region_filter=None))[i]
        toks = {}
        for name, (params, ev, _) in runs.items():
            d, _, _ = characterize._campaign_domain(params, "params")
            toks[name] = (ev(params)[0].cpu(),
                          ev(d.apply_plan(s.path, plan).payload)[0].cpu())
        golden_same = torch.equal(toks["card"][0], toks["cpu"][0])
        struck_same = torch.equal(toks["card"][1], toks["cpu"][1])
        line += (f"; first: trial {i} ({kind}, {s.path}) card "
                 f"{runs['card'][2].trials[i][2].value} cpu "
                 f"{runs['cpu'][2].trials[i][2].value}; golden tokens equal:"
                 f" {golden_same}; struck tokens equal: {struck_same}")
    print(line)


# ------------------------------------------------------------ 8. serving
def _serve_strikes(spec, policy, n_tokens: int, rate: float, seed: int):
    """The serve loop's strikes, drawn again from its stream: one uniform a
    token, then ``MemoryDomain.inject``'s draws. Returns [(token, leaf,
    plan)]."""
    from repro_torch.core import InjectionPlan
    em = policy.error_model
    rng = np.random.default_rng(seed + 1)
    out = []
    for t in range(n_tokens):
        if rate > 0 and rng.random() < rate:
            s = spec.protectable[rng.choice(len(spec.protectable),
                                            p=spec._byte_weights)]
            out.append((t, s, InjectionPlan.sample(
                rng, s.rows * 256, 1, False, em.multi_bit_fraction,
                em.adjacent_fraction)))
    return out


def _secded_expected(strikes, last_scrub: int):
    """(single-bit, double-bit) struck words that a SEC-DED scrub at or
    after ``last_scrub`` must correct and flag: the bits that landed in the
    leaves' bytes (a pad bit is lost on unpacking), counted per word."""
    words = {}
    for t, s, plan in strikes:
        if t > last_scrub:
            continue
        for w, b in zip(plan.word_idx.tolist(), plan.bit_idx.tolist()):
            if w >= 0 and w * 64 + b < s.nbytes * 8:
                words[(s.path, w)] = words.get((s.path, w), 0) + 1
    return (sum(n == 1 for n in words.values()),
            sum(n == 2 for n in words.values()))


class _ServeTimer:
    """Wraps what ``serve_batch`` calls (prefill, each decode step,
    ``MemoryDomain.inject`` and ``scrub``) with device-synchronised wall
    times, for the length of a ``with`` block."""

    def __init__(self):
        self.ms = {"prefill": [], "token": [], "inject": [], "scrub": []}
        self.spec = None

    def _wrap(self, key, fn):
        def timed(*a, **k):
            if key == "inject":
                self.spec = a[0].spec
            out, ms = _timed(lambda: fn(*a, **k))
            self.ms[key].append(ms)
            return out
        return timed

    def __enter__(self):
        from repro_torch.core import MemoryDomain
        from repro_torch.runtime import serve_loop
        self._saved = (serve_loop.make_prefill_step,
                       serve_loop.make_serve_step, MemoryDomain.inject,
                       MemoryDomain.scrub)
        pre, step, inject, scrub = self._saved
        serve_loop.make_prefill_step = \
            lambda cfg: self._wrap("prefill", pre(cfg))
        serve_loop.make_serve_step = \
            lambda cfg: self._wrap("token", step(cfg))
        MemoryDomain.inject = self._wrap("inject", inject)
        MemoryDomain.scrub = self._wrap("scrub", scrub)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import MemoryDomain
        from repro_torch.runtime import serve_loop
        (serve_loop.make_prefill_step, serve_loop.make_serve_step,
         MemoryDomain.inject, MemoryDomain.scrub) = self._saved


def _prefilled(cfg, params, prompts, new_tokens: int):
    """The prefill's greedy token and its cache, padded for ``new_tokens``
    decode steps, as ``serve_batch`` starts its loop."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.serve_loop import _with_headroom
    from repro_torch.runtime.steps import make_prefill_step
    S0 = prompts.shape[1]
    last, cache = make_prefill_step(cfg)(params, {"tokens": prompts})
    full = init_cache(cfg, prompts.shape[0], S0 + new_tokens,
                      device=prompts.device)
    return torch.argmax(last, dim=-1), _with_headroom(cache, full)


def _check_decode_logits(cfg, params, prompts, name: str = "serve",
                         shift: int = 0) -> tuple:
    """The first LOGIT_CHECK_TOKENS decode positions against a teacher-
    forced ``forward`` over the prompt and the generated tokens: prints the
    max |diff| of the logits; the greedy tokens must agree wherever the
    forward's top-2 margin exceeds it. Returns (max |diff|, max|logit|).
    ``shift`` plants a fault: each step decodes at its position plus
    ``shift`` (cache slot and RoPE offset both), and the token check is not
    made."""
    from repro_torch.models import decode_step, forward
    S0 = prompts.shape[1]
    token, full = _prefilled(cfg, params, prompts, LOGIT_CHECK_TOKENS)
    gen, dec = [], []
    for t in range(LOGIT_CHECK_TOKENS):
        gen.append(token)
        lg, full = decode_step(params, token, S0 + t + shift, full, cfg)
        dec.append(lg.float())
        token = torch.argmax(lg, dim=-1)
    seq = torch.cat([prompts, torch.stack(gen, dim=1)], dim=1)
    ref = forward(params, {"tokens": seq}, cfg)[0][:, S0:].float()
    dec = torch.stack(dec, dim=1)
    diff = float((dec - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > diff
    agree = bool((dec.argmax(-1) == ref.argmax(-1))[clear].all())
    print(f"{name} decode vs forward ({LOGIT_CHECK_TOKENS} positions x "
          f"{prompts.shape[0]}): max|diff|={diff:.4g} max|logit|="
          f"{float(ref.abs().max()):.4g} positions with top-2 margin above "
          f"it: {int(clear.sum())} of {clear.numel()}, tokens equal there: "
          f"{agree}")
    if not agree and not shift:
        raise AssertionError(f"{name}: decode and forward disagree on a "
                             "clear token")
    return diff, float(ref.abs().max())


def profile_decode(cfg, params, prompts) -> None:
    """Where a decode step's time goes: DECODE_PROFILE_STEPS warm steps
    (unprotected parameters) under ``torch.profiler``: wall and device-busy
    ms a step, the device's idle share, kernels launched a step, and
    device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    S0, n = prompts.shape[1], DECODE_PROFILE_STEPS
    token, full = _prefilled(cfg, params, prompts, n + 1)
    lg, full = decode_step(params, token, S0, full, cfg)       # warm
    token = torch.argmax(lg, dim=-1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync()
        t = time.perf_counter()
        for i in range(n):
            lg, full = decode_step(params, token, S0 + 1 + i, full, cfg)
            token = torch.argmax(lg, dim=-1)
        _sync()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    kernels = sum(e.count for e in events) / n
    print(f"profile decode step (batch {prompts.shape[0]}, {n} steps): "
          f"wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
          f"idle_share={1 - busy_ms / wall_ms:.3f} device_ops_per_step="
          f"{kernels:.0f}")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"x{e.count // n:<4d} {e.key[:90]}")


def run_serve(params, dev, by_path: dict) -> None:
    """Phase 8: ``serve_batch`` at llama3-8b's full width (N_LAYERS layers)
    under SERVE_POLICIES, each at error rate 0 and SERVE_ERROR_RATE, the
    latter twice: once for wall time and once split by ``_ServeTimer``.
    Every run's launches count into the ``serve`` path."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import DESIGN_POINTS, HRMPolicy
    from repro_torch.draws import Stream
    from repro_torch.kernels import _build
    from repro_torch.runtime.serve_loop import serve_batch
    cfg = get_config("llama3-8b").replace(n_layers=N_LAYERS)
    prompts = Stream(SEED + 1, dev).randint(cfg.vocab_size,
                                            (SERVE_BATCH, SERVE_PROMPT))
    print(f"serve: llama3-8b layers={cfg.n_layers} batch={SERVE_BATCH} "
          f"prompt={SERVE_PROMPT} new_tokens={SERVE_NEW} scrub_interval="
          f"{SERVE_SCRUB_INTERVAL} error_rate={SERVE_ERROR_RATE} seed="
          f"{SERVE_SEED} compute={cfg.compute_dtype}")
    _check_decode_logits(cfg, params, prompts)
    profile_decode(cfg, params, prompts)
    _build.reset_launches()
    base = None
    n_tok = SERVE_BATCH * SERVE_NEW
    last_scrub = (SERVE_NEW - 1) // SERVE_SCRUB_INTERVAL \
        * SERVE_SCRUB_INTERVAL
    for name in SERVE_POLICIES:
        policy = None if name is None else dataclasses.replace(
            DESIGN_POINTS[name](), scrub_interval=SERVE_SCRUB_INTERVAL)

        def run(rate, policy=policy):
            return serve_batch(cfg, params, prompts, SERVE_NEW,
                               policy=policy, error_rate_per_token=rate,
                               seed=SERVE_SEED)
        (clean, _), clean_ms = _timed(lambda: run(0.0))
        if base is None:
            base = clean
        elif not torch.equal(clean, base):
            raise AssertionError(f"serve {name}: error rate 0 gave other "
                                 "tokens than the unprotected run")
        torch.cuda.reset_peak_memory_stats()
        (toks, rep), wall_ms = _timed(lambda: run(SERVE_ERROR_RATE))
        peak = torch.cuda.max_memory_allocated()
        with _ServeTimer() as timer:
            toks2, rep2 = run(SERVE_ERROR_RATE)
        if not torch.equal(toks, toks2) or rep != rep2:
            raise AssertionError(f"serve {name}: two runs of one seed "
                                 "differ")
        strikes = _serve_strikes(
            timer.spec, policy or HRMPolicy("unprotected", {}), SERVE_NEW,
            SERVE_ERROR_RATE, SERVE_SEED)
        if rep.injected != len(strikes) or not strikes:
            raise AssertionError(f"serve {name}: injected {rep.injected}, "
                                 f"the stream draws {len(strikes)}")
        expect = ""
        if name == "typical_server":
            single, double = _secded_expected(strikes, last_scrub)
            if (rep.scrub_corrected, rep.scrub_detected) != (single, double):
                raise AssertionError(
                    f"serve typical_server: corrected {rep.scrub_corrected}"
                    f" detected {rep.scrub_detected}, strikes before the "
                    f"last scrub: {single} single-bit, {double} double-bit "
                    "words")
            expect = (f" (expected: {single} single-bit, {double} double-bit"
                      f" words struck by step {last_scrub})")
        ms = timer.ms
        tok = sorted(ms["token"])
        print(f"serve {name or 'none'}: prefill_ms={ms['prefill'][0]:.2f} "
              f"ms_per_token_median={tok[len(tok) // 2]:.3f} "
              f"(min {tok[0]:.3f} max {tok[-1]:.3f}) tokens_per_s="
              f"{n_tok / wall_ms * 1e3:.1f} (wall_ms={wall_ms:.1f}, prefill "
              f"and protect included; error rate 0: "
              f"{n_tok / clean_ms * 1e3:.1f}) decode_tokens_per_s="
              f"{SERVE_BATCH / tok[len(tok) // 2] * 1e3:.1f} "
              f"scrubs={len(ms['scrub'])} scrub_ms_mean="
              f"{np.mean(ms['scrub'] or [0]):.2f} injects="
              f"{len(ms['inject'])} inject_ms_mean="
              f"{np.mean(ms['inject'] or [0]):.3f} injected={rep.injected} "
              f"corrected={rep.scrub_corrected} detected="
              f"{rep.scrub_detected}{expect} sidecar_overhead="
              f"{rep.sidecar_overhead:.4f} peak_bytes={peak} tokens_equal_"
              f"clean={bool(torch.equal(toks, base))}")
    _path_launches("serve", SERVE_KERNELS, by_path)


# ------------------------------------------------------ 10. online plane
def _online_traffic(cfg, **kw):
    """(TrafficConfig, trace): ONLINE_* unless ``kw`` overrides."""
    from repro_torch.serve import TrafficConfig, generate_trace
    tc = TrafficConfig(**{**dict(
        n_requests=ONLINE_REQUESTS, rate=ONLINE_RATE, process="bursty",
        burst_mult=ONLINE_BURST, prompt_len_choices=ONLINE_PROMPTS,
        max_new_choices=ONLINE_NEW, seed=ONLINE_SEED), **kw})
    return tc, generate_trace(tc, cfg.vocab_size)


def _online_engine(cfg, params, tc, policy, kv_tier, peer=False, **kw):
    """An ``OnlineEngine`` over ``params`` under design point ``policy``
    and KV tier ``kv_tier``, with the phase's geometry unless ``kw``
    overrides it."""
    from repro_torch.core import DESIGN_POINTS, Tier
    from repro_torch.serve import OnlineEngine
    geometry = {**dict(slots=ONLINE_SLOTS, page_size=ONLINE_PAGE,
                       max_prefills_per_step=ONLINE_PREFILLS,
                       scrub_every=ONLINE_SCRUB, seed=ONLINE_SEED,
                       debug_invariants=True), **kw}
    return OnlineEngine(cfg, params, max_prompt_len=tc.max_prompt_len,
                        max_new_cap=tc.max_new_cap,
                        policy=DESIGN_POINTS[policy](),
                        kv_tier=Tier(kv_tier), peer_recovery=peer,
                        **geometry)


class _OnlineLog:
    """What one engine does, in order, for the length of a ``with`` block:
    each params strike with its leaf and plan ("I"), each params scrub
    ("S") and each crash reset ("C"); device-synchronised wall ms of its
    decode steps, prefills (by prompt length), KV access checks, KV
    write-path refreshes, params scrubs and crash resets; and the wall
    time at the start of each iteration (its first call, the KV check)."""

    def __init__(self, eng):
        self.eng = eng
        self.events = []
        self.ms = {"decode": [], "prefill": {}, "scrub_kv": [],
                   "refresh_kv": [], "scrub_params": [], "crash": []}
        self.iter_t = []
        self.on_iteration = None     # called with the iteration index

    def _timed_method(self, name, key, event=None):
        fn = getattr(self.eng, name)

        def wrapped(*a, **k):
            if event is not None:
                self.events.append((event,))
            out, ms = _timed(lambda: fn(*a, **k))
            if key == "prefill":
                self.ms[key].setdefault(a[0].prompt_len, []).append(ms)
            else:
                self.ms[key].append(ms)
            return out
        setattr(self.eng, name, wrapped)

    def __enter__(self):
        from repro_torch.core import InjectionPlan, MemoryDomain
        eng, log = self.eng, self
        self._saved = (MemoryDomain.inject, InjectionPlan.__dict__["sample"])
        inject, sample = MemoryDomain.inject, InjectionPlan.sample
        plans = []

        def sample_rec(*a, **k):
            plans.append(sample(*a, **k))
            return plans[-1]

        def inject_rec(dom, *a, **k):
            start = len(plans)
            out = inject(dom, *a, **k)
            if dom is eng.param_domain:
                for ev, plan in zip(out[1], plans[start:]):
                    log.events.append(("I", dom.spec.by_path[ev["path"]],
                                       plan))
            return out
        MemoryDomain.inject = inject_rec
        InjectionPlan.sample = sample_rec
        scrub_kv = eng._scrub_kv

        def iteration(*a, **k):
            _sync()
            log.iter_t.append(time.perf_counter())
            if log.on_iteration is not None:
                log.on_iteration(len(log.iter_t) - 1)
            out, ms = _timed(lambda: scrub_kv(*a, **k))
            log.ms["scrub_kv"].append(ms)
            return out
        eng._scrub_kv = iteration
        self._timed_method("_run_decode", "decode")
        self._timed_method("_run_prefill", "prefill")
        self._timed_method("_refresh_kv", "refresh_kv")
        self._timed_method("_scrub_params", "scrub_params", "S")
        self._timed_method("_crash_reset", "crash", "C")
        return self

    def __exit__(self, *exc):
        from repro_torch.core import InjectionPlan, MemoryDomain
        MemoryDomain.inject, InjectionPlan.sample = self._saved
        for name in ("_scrub_kv", "_run_decode", "_run_prefill",
                     "_refresh_kv", "_scrub_params", "_crash_reset"):
            delattr(self.eng, name)

    def secded_expected(self):
        """(single-bit, double-bit) struck params words that the scrubs
        must correct and flag: the words each scrub finds struck once or
        twice since the last scrub or crash reset (a reset reloads every
        leaf), counting only bits inside the leaves' bytes (a pad bit is
        lost on unpacking)."""
        single = double = 0
        pending = {}
        for ev in self.events:
            if ev[0] == "I":
                _, s, plan = ev
                for w, b in zip(plan.word_idx.tolist(),
                                plan.bit_idx.tolist()):
                    if w >= 0 and w * 64 + b < s.nbytes * 8:
                        pending[(s.path, w)] = pending.get((s.path, w), 0) + 1
                continue
            if ev[0] == "S":
                single += sum(n == 1 for n in pending.values())
                double += sum(n == 2 for n in pending.values())
            pending = {}
        return single, double


def _med(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def _first_diff(a: dict, b: dict):
    """The first request id whose tokens differ between two response maps
    (None when they agree)."""
    for rid in sorted(set(a) | set(b)):
        if a.get(rid) != b.get(rid):
            return rid
    return None


def online_card_vs_cpu(dev, by_path: dict) -> None:
    """(a) ``benchmarks/serve_slo.py``'s golden and storm passes on tiny
    llama3-8b (float32 compute, so that the two devices' greedy tokens do
    not hang on a bf16 rounding), on the card and on the CPU from one
    seed. At zero injection the reports and tokens must be equal; under
    the storm the counters must be equal unless a crash reset fired on one
    device only, which is named, with the first request whose tokens
    differ, and not failed."""
    from repro_torch.configs import get_tiny
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    cfg = get_tiny("llama3-8b").replace(compute_dtype="float32")
    tc, trace = _online_traffic(
        cfg, n_requests=SLO_REQUESTS, rate=SLO_RATE, burst_mult=8.0,
        prompt_len_choices=(8, 16), max_new_choices=(4, 8))
    runs = {}
    for where in ("card", "cpu"):
        params = init_params(cfg, seed=SEED,
                             device=dev if where == "card" else "cpu")
        for storm in (0, ONLINE_STORM):
            _build.reset_launches()
            eng = _online_engine(cfg, params, tc, "detect_recover",
                                 "parity_r", slots=SLO_SLOTS,
                                 page_size=SLO_PAGE,
                                 scrub_every=SLO_SCRUB)
            runs[where, storm] = eng.run(trace, storm_errors=storm)
            if where == "card" and storm:
                _path_launches("serve_online_tiny", _needed_kernels(
                    eng.param_domain) | _needed_kernels(eng.kv_domain)
                    | {"paged_attn_decode"}, by_path)
    (card0, ctok0), (cpu0, ptok0) = runs["card", 0], runs["cpu", 0]
    (card, ctok), (cpu, ptok) = (runs["card", ONLINE_STORM],
                                 runs["cpu", ONLINE_STORM])
    other = sum(ctok.get(r) != ptok.get(r) for r in ptok)
    print(f"online tiny card vs cpu (serve_slo: {SLO_REQUESTS} requests, "
          f"bursty {SLO_RATE}/s, seed {ONLINE_SEED}, {SLO_SLOTS} slots, "
          f"page {SLO_PAGE}, detect_recover + parity_r, scrub every "
          f"{SLO_SCRUB}): zero-injection reports equal="
          f"{card0.to_dict() == cpu0.to_dict()} tokens equal="
          f"{ctok0 == ptok0}; storm {ONLINE_STORM}: counters equal="
          f"{card.counters == cpu.counters} crash_events card/cpu="
          f"{card.counters['crash_events']}/{cpu.counters['crash_events']} "
          f"requests with other tokens={other} "
          f"(first: {_first_diff(ctok, ptok)}) card: {card.summary()}")
    if card0.to_dict() != cpu0.to_dict() or ctok0 != ptok0:
        raise AssertionError(f"online tiny: card and CPU differ at zero "
                             f"injection (first request: "
                             f"{_first_diff(ctok0, ptok0)})")
    if card.counters != cpu.counters and \
            card.counters["crash_events"] == cpu.counters["crash_events"]:
        raise AssertionError(f"online tiny storm: counters differ: "
                             f"{card.counters} vs {cpu.counters}")


def _paged_logit_check(cfg, checks: list):
    """A stand-in for ``models.transformer.paged_decode_logits`` (where
    ``paged_decode_step`` looks it up) that, for its first
    PAGED_CHECK_STEPS calls, also runs ``models.decode_step`` for each
    active slot (batch 1, its own position) on that slot's pages gathered
    into a contiguous cache before the step, and records (max |diff|, max
    |logit|, tokens agreeing where the top-2 margin exceeds the diff) per
    step."""
    from repro_torch.models import decode_step, transformer
    real = transformer.paged_decode_logits

    def checked(params, pools, table, tokens, pos, cfg_, ps):
        if len(checks) >= PAGED_CHECK_STEPS:
            return real(params, pools, table, tokens, pos, cfg_, ps)
        active = [int(i) for i in (pos > 0).nonzero()[:, 0].tolist()]
        P = table.shape[1]
        caches = [{name: pool[:, table[i]].reshape(
                       pool.shape[0], 1, P * ps, *pool.shape[3:])
                   for name, pool in pools.items()}
                  for i in active]
        logits = real(params, pools, table, tokens, pos, cfg_, ps)
        diff = top = 0.0
        agree = True
        for i, cache in zip(active, caches):
            lg, _ = decode_step(params, tokens[i:i + 1], int(pos[i]), cache,
                                cfg)
            want, got = lg[0].float(), logits[i].float()
            d = float((want - got).abs().max())
            t2 = want.topk(2).values
            if float(t2[0] - t2[1]) > d:
                agree &= bool(want.argmax() == got.argmax())
            diff, top = max(diff, d), max(top, float(want.abs().max()))
        checks.append((len(active), diff, top, agree))
        return logits
    return real, checked


def online_full_width(params, dev, by_path: dict) -> dict:
    """(b) and (c): a golden and a storm pass of ONLINE_REQUESTS requests
    under each of ONLINE_CONFIGS, model clock, each pass's launches
    counted on their own; the first golden pass also holds paged decode
    against contiguous decode, and four of its requests against a solo
    ``serve_batch``. Returns the detect_recover storm pass's iteration
    start times and its ``_IterationProfile``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime.serve_loop import serve_batch
    from repro_torch.models import transformer
    from repro_torch.serve import engine as engine_mod, incorrect_rate
    cfg = get_config("llama3-8b").replace(n_layers=N_LAYERS)
    tc, trace = _online_traffic(cfg)
    eng = _online_engine(cfg, params, tc, "detect_recover", "parity_r")
    pool_bytes = eng.cache.pool_k.numel() * eng.cache.pool_k.element_size()
    print(f"online plane: llama3-8b layers={cfg.n_layers} slots="
          f"{ONLINE_SLOTS} page_size={ONLINE_PAGE} pages="
          f"{eng.cache.n_pages} (max {eng.cache.max_pages_per_slot}/slot) "
          f"pool_bytes=2x{pool_bytes} prompts={ONLINE_PROMPTS} max_new="
          f"{ONLINE_NEW} prefills/step<={ONLINE_PREFILLS} requests="
          f"{ONLINE_REQUESTS} bursty {ONLINE_RATE}/s x{ONLINE_BURST} seed "
          f"{ONLINE_SEED} span={trace[-1].arrival:.3f}s scrub_every="
          f"{ONLINE_SCRUB} storm={ONLINE_STORM}")
    print(eng.describe())
    del eng
    profiled = None
    for policy, tier, peer in ONLINE_CONFIGS:
        tag = f"{policy}{'_peer' if peer else ''}"
        golden = None
        for storm in (0, ONLINE_STORM):
            eng = _online_engine(cfg, params, tc, policy, tier, peer)
            need = _needed_kernels(eng.param_domain) | \
                _needed_kernels(eng.kv_domain) | {"paged_attn_decode"}
            if not storm:
                need.discard("bitflip")
            checks = []
            first = golden is None and not peer and policy == \
                ONLINE_CONFIGS[0][0]
            if first:
                real, checked = _paged_logit_check(cfg, checks)
                transformer.paged_decode_logits = checked
                # the check reads the step on the host: decode eagerly, not
                # through the engine's decode graph, which would capture it
                eng._decode = engine_mod.paged_decode_step
            _build.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            try:
                with _OnlineLog(eng) as log:
                    if storm and policy == "detect_recover" and not peer:
                        log.on_iteration = profile = _IterationProfile()
                    rep, resp = eng.run(trace, storm_errors=storm)
                _sync()
            finally:
                if first:
                    transformer.paged_decode_logits = real
            wall_s = time.perf_counter() - t
            name = f"serve_online_{tag}_{'storm' if storm else 'golden'}"
            _path_launches(name, need, by_path)
            c = rep.counters
            if rep.completed + rep.shed != rep.n_requests:
                raise AssertionError(f"{name}: {rep.completed} completed + "
                                     f"{rep.shed} shed of {rep.n_requests}")
            if storm:
                if c["injected_params"] + c["injected_kv"] != storm:
                    raise AssertionError(f"{name}: injected {c}")
                rep.incorrect_rate = incorrect_rate(golden, resp)
            else:
                golden = resp
            expect = ""
            if storm and policy == "typical_server":
                single, double = log.secded_expected()
                if (c["params_corrected"], c["params_detected"]) != \
                        (single, double):
                    raise AssertionError(
                        f"{name}: params corrected {c['params_corrected']} "
                        f"detected {c['params_detected']}, struck: {single} "
                        f"single-bit, {double} double-bit words")
                expect = (f" (expected: {single} single-bit, {double} "
                          f"double-bit params words)")
            if storm and peer and (c["recovery_events"] or
                                   not c["peer_recovery_events"]):
                raise AssertionError(f"{name}: peer recovery billed "
                                     f"{c['recovery_events']} disk reloads, "
                                     f"{c['peer_recovery_events']} peer")
            crash = "".join(f" crash_reset_ms={x:.1f}"
                            for x in log.ms["crash"])
            bar = "PASS" if rep.availability >= AVAILABILITY_BAR else "FAIL"
            print(f"{name}: wall_s={wall_s:.2f} iterations="
                  f"{len(log.iter_t)} {rep.summary()} "
                  f"availability_vs_99.90%={bar}"
                  f" counters={json.dumps(c)}{expect}{crash} peak_bytes="
                  f"{torch.cuda.max_memory_allocated()}")
            if first:
                _print_paged_check(checks)
                _solo_check(cfg, params, trace, golden, dev)
            if log.on_iteration is not None:
                profiled = (log.iter_t, profile)
            del eng, log
    return profiled


def _print_paged_check(checks) -> None:
    slots = sum(n for n, _, _, _ in checks)
    diff = max(d for _, d, _, _ in checks)
    top = max(t for _, _, t, _ in checks)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    agree = all(a for _, _, _, a in checks)
    print(f"online paged vs contiguous decode (first {len(checks)} decode "
          f"steps, {slots} slot-steps, engine batch {ONLINE_SLOTS} vs "
          f"decode_step batch 1): max|diff|={diff:.4g} max|logit|="
          f"{top:.4g} = {diff / ulp:.2f} bf16 ulps at max|logit|, tokens "
          f"equal where the top-2 margin exceeds the diff: {agree}")
    if not agree or len(checks) < PAGED_CHECK_STEPS:
        raise AssertionError("paged decode disagrees with contiguous "
                             "decode on a clear token")


def _solo_check(cfg, params, trace, golden, dev) -> None:
    """SOLO_CHECK_REQUESTS requests of the golden pass beside a solo
    ``serve_batch`` of each: mismatching tokens counted, not failed (a
    batch of one lets cuBLAS choose other kernels)."""
    from repro_torch.runtime.serve_loop import serve_batch
    out = []
    for req in trace[:SOLO_CHECK_REQUESTS]:
        prompt = torch.as_tensor(req.prompt[None], dtype=torch.int64,
                                 device=dev)
        solo, _ = serve_batch(cfg, params, prompt, req.max_new)
        got = golden[req.rid]
        out.append((req.rid, sum(a != b for a, b in
                                 zip(solo[0].tolist(), got)), len(got)))
    print("online engine vs solo serve_batch (rid: mismatched/tokens): "
          + ", ".join(f"{r}: {m}/{n}" for r, m, n in out))


class _IterationProfile:
    """An ``on_iteration`` hook of ``_OnlineLog``: runs iterations
    ONLINE_PROFILE_AT to ONLINE_PROFILE_AT + ONLINE_PROFILE_ITERS - 1 under
    ``torch.profiler`` and keeps the device events and the traced wall ms
    an iteration."""

    def __init__(self):
        self.prof = None
        self.events = None
        self.traced_ms = None

    def __call__(self, i: int) -> None:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        if i == ONLINE_PROFILE_AT:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t = time.perf_counter()
        elif i == ONLINE_PROFILE_AT + ONLINE_PROFILE_ITERS and self.prof:
            self.traced_ms = (time.perf_counter() - self.t) * 1e3 \
                / ONLINE_PROFILE_ITERS
            self.prof.__exit__(None, None, None)
            self.events = [e for e in self.prof.key_averages()
                           if e.device_type == DeviceType.CUDA
                           and e.self_device_time_total > 0]
            self.prof = None


def online_wall(params, dev, by_path: dict, profiled) -> None:
    """(d) one storm pass under detect_recover + parity_r on the wall
    clock: throughput, TTFT and TPOT, the median ms of each stage of an
    iteration, the KV write-path ECC's share of a decode step, peak
    memory; then the profiled iterations of (b)'s model-clock storm pass
    (the profiler's own host work stays out of every timed number)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    cfg = get_config("llama3-8b").replace(n_layers=N_LAYERS)
    tc, trace = _online_traffic(cfg)
    eng = _online_engine(cfg, params, tc, "detect_recover", "parity_r",
                         clock="wall")
    need = _needed_kernels(eng.param_domain) | \
        _needed_kernels(eng.kv_domain) | {"paged_attn_decode"}
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with _OnlineLog(eng) as log:
        rep, _ = eng.run(trace, storm_errors=ONLINE_STORM)
    _sync()
    wall_s = time.perf_counter() - t
    _path_launches("serve_online_wall", need, by_path)
    peak = torch.cuda.max_memory_allocated()
    ms = log.ms
    dec, kv, rf = _med(ms["decode"]), _med(ms["scrub_kv"]), \
        _med(ms["refresh_kv"])
    prefill = {n: round(_med(x), 3) for n, x in sorted(ms["prefill"].items())}
    crash = "".join(f" crash_reset_ms={x:.1f}" for x in ms["crash"])
    print(f"online wall (detect_recover + parity_r, storm {ONLINE_STORM}): "
          f"wall_s={wall_s:.2f} iterations={len(log.iter_t)} "
          f"throughput_rps={rep.throughput_rps:.3f} tokens_per_s="
          f"{rep.tokens_per_s:.1f} (over the prefill and decode time, "
          f"elapsed_s={rep.elapsed_s:.3f}) ttft_p50/p99_ms="
          f"{rep.ttft_p50_s * 1e3:.1f}/{rep.ttft_p99_s * 1e3:.1f} "
          f"tpot_p50/p99_ms={rep.tpot_p50_s * 1e3:.2f}/"
          f"{rep.tpot_p99_s * 1e3:.2f} decode_ms_median={dec:.3f} "
          f"prefill_ms_median={json.dumps(prefill)} kv_check_ms_median="
          f"{kv:.3f} kv_refresh_ms_median={rf:.3f} write_path_ecc_share="
          f"{(kv + rf) / dec:.4f} params_scrub_ms_median="
          f"{_med(ms['scrub_params']):.3f} ({len(ms['scrub_params'])} "
          f"scrubs){crash} availability={rep.availability:.6f} "
          f"peak_bytes={peak}")
    if profiled is None or profiled[1].events is None:
        raise AssertionError("the storm pass ran no profiled iteration")
    t, prof = profiled
    n = ONLINE_PROFILE_ITERS
    wall_ms = (t[ONLINE_PROFILE_AT] - t[ONLINE_PROFILE_AT - n]) * 1e3 / n
    busy_ms = sum(e.self_device_time_total for e in prof.events) / 1e3 / n
    ops = sum(e.count for e in prof.events) / n
    print(f"profile online iteration (detect_recover + parity_r storm pass, "
          f"model clock, iterations {ONLINE_PROFILE_AT}-"
          f"{ONLINE_PROFILE_AT + n - 1}): wall_ms={wall_ms:.3f} (iterations "
          f"{ONLINE_PROFILE_AT - n}-{ONLINE_PROFILE_AT - 1}, unprofiled) "
          f"traced_wall_ms={prof.traced_ms:.3f} device_busy_ms={busy_ms:.3f} "
          f"idle_share={1 - busy_ms / wall_ms:.3f} device_ops_per_iteration="
          f"{ops:.0f}")
    for e in sorted(prof.events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"x{e.count // n:<4d} {e.key[:90]}")


def run_online(params, dev, by_path: dict) -> None:
    """Phase 10 (a)-(d): each part runs, and the phase fails after the last
    if any part failed its checks."""
    failed, profiled = [], None
    for part in (online_card_vs_cpu, online_full_width, online_wall):
        try:
            if part is online_card_vs_cpu:
                part(dev, by_path)
            elif part is online_full_width:
                profiled = part(params, dev, by_path)
            else:
                part(params, dev, by_path, profiled)
        except AssertionError as e:
            print(f"FAILED {part.__name__}: {e}")
            failed.append(part.__name__)
    if failed:
        raise AssertionError(f"phase 10 parts failed: {failed}")


# ----------------------------------------------------------- 9. training
class _TrainTimer:
    """Device-synchronised wall times of what ``run_training`` calls on the
    main thread, for the length of a ``with`` block: each train step, each
    strike, each scheduled scrub of the loop's domain, and the write path's
    ``refresh`` (with a state) and ``reassert_hard``. The checkpoint's
    staging domain and its thread are left out."""

    def __init__(self):
        self.ms = {"step": [], "inject": [], "scrub": [], "refresh": [],
                   "reassert": []}

    @staticmethod
    def _ours(dom) -> bool:
        import threading
        return threading.current_thread() is threading.main_thread() and \
            dom.spec.policy.name != "ckpt_staging"

    def _wrap(self, key, fn, when=lambda *a, **k: True):
        def timed(*a, **k):
            if not when(*a, **k):
                return fn(*a, **k)
            out, ms = _timed(lambda: fn(*a, **k))
            if key != "scrub" or out[1] is not None:
                self.ms[key].append(ms)
            return out
        return timed

    def __enter__(self):
        from repro_torch.core import MemoryDomain
        from repro_torch.runtime import train_loop
        self._saved = (train_loop.make_train_step, MemoryDomain.inject,
                       MemoryDomain.scrub, MemoryDomain.refresh,
                       MemoryDomain.reassert_hard)
        make, inject, scrub, refresh, reassert = self._saved
        train_loop.make_train_step = \
            lambda cfg, tcfg: self._wrap("step", make(cfg, tcfg))
        MemoryDomain.inject = self._wrap(
            "inject", inject, lambda d, *a, **k: self._ours(d))
        MemoryDomain.scrub = self._wrap(
            "scrub", scrub, lambda d, *a, **k: self._ours(d))
        MemoryDomain.refresh = self._wrap(
            "refresh", refresh, lambda d, *a, **k: self._ours(d) and bool(a))
        MemoryDomain.reassert_hard = self._wrap(
            "reassert", reassert, lambda d, *a, **k: self._ours(d))
        return self

    def __exit__(self, *exc):
        from repro_torch.core import MemoryDomain
        from repro_torch.runtime import train_loop
        (train_loop.make_train_step, MemoryDomain.inject, MemoryDomain.scrub,
         MemoryDomain.refresh, MemoryDomain.reassert_hard) = self._saved

    def summary(self) -> dict:
        ms = self.ms
        med = (lambda xs: float(np.median(xs)) if xs else 0.0)
        out = {"step_ms_median": med(ms["step"]),
               "scrub_ms_median": med(ms["scrub"]),
               "refresh_reassert_ms_median": med(ms["refresh"])
               + med(ms["reassert"]),
               "inject_ms_median": med(ms["inject"]),
               "steps_timed": len(ms["step"]), "scrubs": len(ms["scrub"]),
               "injects": len(ms["inject"])}
        for iv in OVERHEAD_INTERVALS:
            out[f"scrub_overhead_{iv}"] = (
                out["scrub_ms_median"]
                + iv * out["refresh_reassert_ms_median"]) / (
                iv * out["step_ms_median"])
        return out


def _train_need(state, roots, policy, strikes: bool = True) -> set:
    """The kernels a train run must launch: its domain's codecs, bit-flip
    when it strikes, and the checkpoint's Par+R staging scrub. Protects a
    throwaway domain: call it before the counters are reset."""
    from repro_torch.core import HRMPolicy, MemoryDomain
    dom = MemoryDomain.protect({r: state[r] for r in roots},
                               policy or HRMPolicy("unprotected", {}))
    need = _needed_kernels(dom) | STAGING_KERNELS
    if not strikes:
        need.discard("bitflip")
    return need


def _loop(cfg, policy_name, steps, ckpt_dir, *, scrub=None, **kw):
    """``LoopConfig`` of ``policy_name`` (None: unprotected) with its scrub
    interval set to ``scrub``."""
    import dataclasses
    from repro_torch.core import DESIGN_POINTS
    from repro_torch.runtime.train_loop import LoopConfig
    policy = None
    if policy_name is not None:
        policy = dataclasses.replace(DESIGN_POINTS[policy_name](),
                                     scrub_interval=scrub)
    return LoopConfig(steps=steps, ckpt_dir=ckpt_dir, policy=policy, **kw)


def _report_line(name, rep) -> str:
    return (f"{name}: steps={len(rep.losses)} loss {rep.losses[0]:.4f} -> "
            f"{rep.losses[-1]:.4f} injected={rep.injected} corrected="
            f"{rep.scrub_corrected} detected={rep.scrub_detected} "
            f"recoveries={rep.recoveries} restarts={rep.restarts} "
            f"stragglers={rep.straggler_events} sidecar_overhead="
            f"{rep.domain_stats['overhead']:.4f}")


def _no_stragglers(events) -> list:
    return [e for e in events if "straggler" not in e]


def train_card_vs_cpu(dev, by_path: dict) -> None:
    """(a) tiny lm-100m in ``tests/test_substrate.py``'s detect_recover
    scenario (14 steps, checkpoint every 5, 0.5 strikes a step, node
    failure at 8, scrub every 4, seed 3) on the CPU and on the card, from
    one seed: counters and events equal, losses within TINY_LOSS_RTOL."""
    import tempfile
    from repro_torch.configs import get_tiny
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import DESIGN_POINTS
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.kernels import _build
    from repro_torch.runtime.steps import init_train_state
    from repro_torch.runtime.train_loop import run_training
    cfg = get_tiny("lm-100m")
    tcfg = TrainConfig(remat="none")
    need = _train_need(init_train_state(3, cfg, tcfg, device=dev),
                       ("params",), DESIGN_POINTS["detect_recover"]())
    reports = {}
    for where in ("cpu", dev):
        if where is dev:
            _build.reset_launches()
        with tempfile.TemporaryDirectory() as ck:
            loop = _loop(cfg, "detect_recover", 14, ck, scrub=4,
                         ckpt_interval=5, error_rate_per_step=0.5,
                         node_failure_steps=(8,), seed=3)
            reports[str(where)] = run_training(
                cfg, tcfg, loop, batch_stream(cfg, 4, 32, device=where),
                device=where)
    _path_launches("train_card_vs_cpu", need, by_path)
    cpu, card = reports["cpu"], reports[str(dev)]

    def counters(r):
        return (r.injected, r.scrub_corrected, r.scrub_detected,
                r.recoveries, r.restarts, len(r.losses), r.domain_stats,
                _no_stragglers(r.events))
    rel = float(np.max(np.abs(np.array(card.losses) - cpu.losses)
                       / np.abs(cpu.losses)))
    print(_report_line("train tiny card", card))
    print(f"train tiny card vs cpu: counters_equal="
          f"{counters(card) == counters(cpu)} events="
          f"{len(_no_stragglers(card.events))} "
          f"loss_max_rel_diff={rel:.3e} (tolerance {TINY_LOSS_RTOL})")
    if counters(card) != counters(cpu):
        raise AssertionError(f"card {counters(card)} vs cpu "
                             f"{counters(cpu)}")
    if rel > TINY_LOSS_RTOL or card.restarts != 1 or not card.injected:
        raise AssertionError("tiny train scenario: losses apart or the "
                             "drill did not fire")


def _lm100m(dev):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree
    from repro_torch.runtime.steps import init_train_state
    cfg = get_config("lm-100m")
    tcfg = TrainConfig(lr=3e-4, remat="none")    # examples/train_hrm.py's
    state = init_train_state(SEED, cfg, tcfg, device=dev)
    n = sum(t.numel() for t in tree.leaves(state["params"]))
    nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(state))
    print(f"train model: lm-100m layers={cfg.n_layers} d_model="
          f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size} params={n} "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}) "
          f"train_state_bytes={nbytes}")
    return cfg, tcfg, state


def _train_strikes(spec, loop) -> list:
    """The train loop's strikes, drawn again from its stream: a Poisson
    count a step, then per strike one uniform for hard and
    ``MemoryDomain.inject``'s draws; the node failure sends the step back
    to the last checkpoint, whose steps draw anew. Returns [(step, leaf,
    hard, plan)]."""
    from repro_torch.core import InjectionPlan
    em = loop.policy.error_model
    rng = np.random.default_rng(loop.seed + 2)
    out, step, fired = [], 0, set()
    while step < loop.steps:
        for _ in range(rng.poisson(loop.error_rate_per_step)):
            hard = rng.random() < loop.hard_error_fraction
            s = spec.protectable[rng.choice(len(spec.protectable),
                                            p=spec._byte_weights)]
            out.append((step, s, hard, InjectionPlan.sample(
                rng, s.rows * 256, 1, hard, em.multi_bit_fraction,
                em.adjacent_fraction)))
        if step in loop.node_failure_steps and step not in fired:
            fired.add(step)
            step = step // loop.ckpt_interval * loop.ckpt_interval
            continue
        step += 1
    return out


def _top_exponent(strikes) -> list:
    """The strikes that flip bit 30 of a float32, the top exponent bit: a
    weight near 1 or below becomes about 2**128 times larger (a norm weight
    of 1.0 becomes inf), which no step survives."""
    return [(step, s.path, hard) for step, s, hard, plan in strikes
            if any(w >= 0 and b % 32 == 30
                   for w, b in zip(plan.word_idx, plan.bit_idx))]


def _train_hrm_loop(cfg, ck, seed: int):
    from repro_torch.core import Response
    return _loop(cfg, "detect_recover", TRAIN_STEPS, ck, scrub=TRAIN_SCRUB,
                 ckpt_interval=TRAIN_CKPT, error_rate_per_step=TRAIN_RATE,
                 hard_error_fraction=TRAIN_HARD,
                 node_failure_steps=(TRAIN_FAIL_AT,),
                 response=Response.RELOAD_CLEAN_COPY, seed=seed)


def train_hrm(dev, by_path: dict) -> None:
    """(b) examples/train_hrm.py at lm-100m's full config, TRAIN_STEPS
    steps, timed stage by stage (e). First with the example's seed (0),
    then, when that stream sets a parameter's top exponent bit, with the
    first seed whose stream does not: the loss must fall and stay finite
    in a run that no such strike hits, and the strikes of both runs must
    be the ones their streams draw."""
    import tempfile
    from repro_torch.core import DESIGN_POINTS, MemoryDomain
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.kernels import _build
    from repro_torch.runtime.train_loop import run_training
    cfg, tcfg, state = _lm100m(dev)
    print(f"reduced: train_hrm steps 300->{TRAIN_STEPS} (phase 9's share "
          "of the run's time limit)")
    policy = DESIGN_POINTS["detect_recover"]()
    need = _train_need(state, ("params",), policy)
    spec = MemoryDomain.protect({"params": state["params"]}, policy).spec
    seed = 0
    while True:
        with tempfile.TemporaryDirectory() as ck:
            loop = _train_hrm_loop(cfg, ck, seed)
            strikes = _train_strikes(spec, loop)
            top = _top_exponent(strikes)
            name = "train_hrm" if seed == 0 else "train_hrm_clean"
            _build.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            with _TrainTimer() as timer:
                rep, wall_ms = _timed(lambda: run_training(
                    cfg, tcfg, loop, batch_stream(
                        cfg, TRAIN_BATCH, TRAIN_SEQ, device=dev),
                    state=state, device=dev))
        peak = torch.cuda.max_memory_allocated()
        _path_launches(name, need, by_path)
        losses = np.array(rep.losses)
        bad = np.flatnonzero(~np.isfinite(losses))
        first, last = losses[:5].mean(), losses[-5:].mean()
        t = timer.summary()
        print(_report_line(f"{name} lm-100m detect_recover seed {seed}",
                           rep))
        print(f"{name}: loss_first5={first:.4f} loss_last5={last:.4f} "
              f"losses_every_10={np.round(losses[::10], 3).tolist()} "
              f"first_nonfinite_step_index="
              f"{int(bad[0]) if bad.size else None} strikes_drawn="
              f"{len(strikes)} top_exponent_strikes(step,leaf,hard)={top} "
              f"wall_s={wall_ms / 1e3:.1f} peak_bytes={peak} events="
              f"{len(_no_stragglers(rep.events))} "
              + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in t.items()))
        if rep.restarts != 1 or not rep.injected or \
                rep.injected != len(strikes):
            raise AssertionError(f"{name}: restarts {rep.restarts}, "
                                 f"injected {rep.injected} of the "
                                 f"{len(strikes)} its stream draws")
        if not top:
            break
        seed += 1
        while _top_exponent(_train_strikes(spec, _train_hrm_loop(
                cfg, "", seed))):
            seed += 1
    if not last < first or bad.size:
        raise AssertionError(f"{name}: the loss did not fall or a loss is "
                             "not finite")


def train_protect_opt(dev, by_path: dict) -> None:
    """(c) detect_recover_l over params and optimizer moments, DRL_RATE
    strikes a step, a scrub every DRL_SCRUB: corrections happen. Then
    ZERO_POLICIES at error rate 0 under deterministic algorithms: every
    policy's losses equal the unprotected run's bit for bit."""
    import tempfile
    import warnings
    from repro_torch.core import DESIGN_POINTS
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.kernels import _build
    from repro_torch.runtime.train_loop import run_training
    cfg, tcfg, state = _lm100m(dev)
    roots = ("params", "opt")
    need = _train_need(state, roots, DESIGN_POINTS["detect_recover_l"]())
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as ck, _TrainTimer() as timer:
        loop = _loop(cfg, "detect_recover_l", DRL_STEPS, ck, scrub=DRL_SCRUB,
                     ckpt_interval=10, error_rate_per_step=DRL_RATE,
                     protect_roots=roots)
        rep = run_training(cfg, tcfg, loop, batch_stream(
            cfg, TRAIN_BATCH, TRAIN_SEQ, device=dev), state=state,
            device=dev)
    _path_launches("train_dr_l", need, by_path)
    print(_report_line("train detect_recover_l params+opt", rep) + " "
          + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in timer.summary().items()))
    if not rep.scrub_corrected or not np.all(np.isfinite(rep.losses)):
        raise AssertionError("detect_recover_l corrected nothing")
    losses, stamp = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i, name in enumerate(ZERO_POLICIES + (None,)):
                label = (name or "none") + (
                    " again" if i == len(ZERO_POLICIES) else "")
                policy = DESIGN_POINTS[name]() if name else None
                need = _train_need(state, roots, policy, strikes=False)
                _build.reset_launches()
                with tempfile.TemporaryDirectory() as ck, \
                        _TrainTimer() as timer:
                    loop = _loop(cfg, name, ZERO_STEPS, ck, scrub=ZERO_SCRUB,
                                 ckpt_interval=ZERO_STEPS,
                                 protect_roots=roots)
                    r = run_training(cfg, tcfg, loop, batch_stream(
                        cfg, TRAIN_BATCH, TRAIN_SEQ, device=dev),
                        state=state, device=dev)
                _path_launches(f"train_rate0_{label.replace(' ', '_')}",
                               need, by_path)
                losses[label] = r.losses
                stamp[label] = timer.summary()
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message)[:120] for w in caught
                     if "deterministic" in str(w.message)})
    base = losses["none"]
    for label, ls in losses.items():
        t = stamp[label]
        print(f"train rate0 {label}: losses_bit_equal_unprotected="
              f"{ls == base} first={ls[0]!r} last={ls[-1]!r} "
              + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in t.items()))
    print(f"train rate0: nondeterministic_op_warnings={nondet}")
    if any(ls != base for ls in losses.values()):
        raise AssertionError("at error rate 0 a policy changed the losses")


def _flip_byte(path: Path) -> None:
    with open(path, "r+b") as f:
        f.seek(path.stat().st_size // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def _same_bytes(a, b) -> bool:
    from repro_torch.core import tree
    fa, fb = tree.flatten_with_path(a), tree.flatten_with_path(b)
    return fa[1] == fb[1] and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bytes(x), _bytes(y))
        for (_, x), (_, y) in zip(fa[0], fb[0]))


def train_store(dev, by_path: dict) -> None:
    """(d) the full lm-100m train state (after one and two steps, so the
    moments are real) through the store on the card: save, load bit for
    bit, save_async, and clean_copy falling back past a corrupted newest
    snapshot to the older one's bytes."""
    import tempfile
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.kernels import _build
    from repro_torch.runtime.steps import make_train_step
    cfg, tcfg, state = _lm100m(dev)
    step = make_train_step(cfg, tcfg)
    batches = batch_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, device=dev)
    older, _ = step(state, next(batches))
    newer, _ = step(older, next(batches))
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        store = CheckpointStore(d, device=dev)
        _, save_ms = _timed(lambda: store.save(1, older))
        store.save(2, newer)
        size = sum(f.stat().st_size for f in (Path(d) / "step_00000002")
                   .iterdir())
        loaded, load_ms = _timed(lambda: store.load(2, newer))
        exact = _same_bytes(loaded, newer)
        del loaded
        t = time.perf_counter()
        thread = store.save_async(3, newer)
        async_ms = (time.perf_counter() - t) * 1e3
        thread.join()
        async_total_ms = (time.perf_counter() - t) * 1e3
        _flip_byte(Path(d) / "step_00000003" / "data.npz")
        _flip_byte(Path(d) / "step_00000002" / "data.npz")
        copy = store.clean_copy_fn()
        got, copy_ms = _timed(lambda: copy("params/embed"))
        fell_back = store.last_loaded_step
        wi = copy("blocks/mlp/wi")         # a path relative to params
        ok = torch.equal(_bytes(got), _bytes(older["params"]["embed"])) \
            and torch.equal(_bytes(wi),
                            _bytes(older["params"]["blocks"]["mlp"]["wi"]))
    _path_launches("train_store", STAGING_KERNELS, by_path)
    print(f"train store: snapshot_bytes={size} save_ms={save_ms:.1f} "
          f"load_ms={load_ms:.1f} save_async_return_ms={async_ms:.1f} "
          f"save_async_total_ms={async_total_ms:.1f} "
          f"loaded_bit_exact={exact} clean_copy_ms={copy_ms:.1f} "
          f"clean_copy_fell_back_to={fell_back} clean_copy_bit_exact={ok}")
    if not exact or not ok or fell_back != 1:
        raise AssertionError("the store did not round-trip or fall back")


def profile_train_step(dev, by_path: dict) -> None:
    """(e) TRAIN_PROFILE_STEPS warm lm-100m train steps (batch 8 x 256),
    timed without the profiler and then again under ``torch.profiler``:
    wall ms a step both ways, device-busy ms a step, the device's idle
    share against the unprofiled wall time (and against the traced one,
    which the profiler's own host work inflates), device operations a
    step, and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tree
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.runtime.steps import make_train_step
    cfg, tcfg, state = _lm100m(dev)
    step = make_train_step(cfg, tcfg)
    batch = next(batch_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, device=dev))
    state, m = step(state, batch)
    float(m["loss"])
    n = TRAIN_PROFILE_STEPS
    _sync()
    t = time.perf_counter()
    for _ in range(n):
        state, m = step(state, batch)
        float(m["loss"])
    _sync()
    wall_ms = (time.perf_counter() - t) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync()
        t = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
            float(m["loss"])
        _sync()
        traced_ms = (time.perf_counter() - t) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    ops = sum(e.count for e in events) / n
    flop = 6 * sum(t.numel() for t in tree.leaves(state["params"])) \
        * TRAIN_BATCH * TRAIN_SEQ
    print(f"profile train step (lm-100m, batch {TRAIN_BATCH}x{TRAIN_SEQ}, "
          f"{n} steps): wall_ms={wall_ms:.3f} traced_wall_ms="
          f"{traced_ms:.3f} device_busy_ms={busy_ms:.3f} idle_share="
          f"{1 - busy_ms / wall_ms:.3f} idle_share_traced="
          f"{1 - busy_ms / traced_ms:.3f} device_ops_per_step="
          f"{ops:.0f} model_tflop_per_step={flop / 1e12:.3f} (6 x params x "
          f"tokens)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"x{e.count // n:<4d} {e.key[:90]}")


def train_llama_width(dev, by_path: dict) -> None:
    """(f) llama3-8b's full width, LLAMA_TRAIN_LAYERS of its 32 layers (bf16
    parameters, float32 moments), batch 4 x 512: LLAMA_TRAIN_STEPS steps
    under typical_server on the parameters. It drives ``make_train_step``
    and ``MemoryDomain`` in the loop's stage order (one single-bit strike,
    scrub, train step, refresh + reassert), not ``run_training``, whose
    step-0 checkpoint would be a 15 GB snapshot."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import DESIGN_POINTS, MemoryDomain, tree
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.kernels import _build
    from repro_torch.runtime.steps import init_train_state, make_train_step
    cfg = get_config("llama3-8b")
    print(f"reduced: train llama3-8b n_layers {cfg.n_layers}->"
          f"{LLAMA_TRAIN_LAYERS} (full width through the backward pass)")
    cfg = cfg.replace(n_layers=LLAMA_TRAIN_LAYERS)
    tcfg = TrainConfig(remat="none")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(SEED, cfg, tcfg, device=dev)
    n = sum(t.numel() for t in tree.leaves(state["params"]))
    mom = sum(t.numel() * t.element_size()
              for t in tree.leaves(state["opt"]))
    policy = DESIGN_POINTS["typical_server"]()
    rng = np.random.default_rng(SEED + 2)
    step = make_train_step(cfg, tcfg)
    batches = batch_stream(cfg, LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ,
                           device=dev)
    _build.reset_launches()
    domain = MemoryDomain.protect({"params": state["params"]}, policy)
    losses, step_ms, corrected = [], [], 0
    for _ in range(LLAMA_TRAIN_STEPS):
        t = time.perf_counter()
        domain, _ = domain.inject(rng, 1, multi_bit_fraction=0.0)
        domain, rep = domain.scrub()
        corrected += rep.totals()[0]
        state = {**state, "params": domain.root("params")}
        state, m = step(state, next(batches))
        losses.append(float(m["loss"]))
        domain = domain.refresh({"params": state["params"]}).reassert_hard()
        state = {**state, "params": domain.root("params")}
        _sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    _path_launches("train_llama", _needed_kernels(domain), by_path)
    print(f"train llama3-8b width: layers={cfg.n_layers} params={n} "
          f"({cfg.param_dtype}) moment_bytes={mom} batch={LLAMA_TRAIN_BATCH}"
          f"x{LLAMA_TRAIN_SEQ} ms_per_step={[round(x, 1) for x in step_ms]} "
          f"losses={[round(x, 4) for x in losses]} corrected={corrected} "
          f"peak_bytes={peak}")
    if not np.all(np.isfinite(losses)) or corrected != LLAMA_TRAIN_STEPS:
        raise AssertionError("llama3-8b-width training: a loss is not "
                             "finite or a single-bit strike went "
                             "uncorrected")


def run_train(dev, by_path: dict) -> None:
    """Phase 9 (a)-(f): each part runs, and the phase fails after the last
    if any part failed its checks."""
    failed = []
    for part in (train_card_vs_cpu, train_hrm, profile_train_step,
                 train_protect_opt, train_store, train_llama_width):
        try:
            part(dev, by_path)
        except AssertionError as e:
            print(f"FAILED {part.__name__}: {e}")
            failed.append(part.__name__)
    if failed:
        raise AssertionError(f"phase 9 parts failed: {failed}")


# ------------------------------------------ 11. sharded domains, examples
def _gb(n: int) -> str:
    return f"{n / 1e9:.3f} GB"


def _counts(rep) -> tuple:
    """A ScrubReport's counts as ({path: int}, {path: int})."""
    return ({k: int(v) for k, v in rep.corrected.items()},
            {k: int(v) for k, v in rep.detected_uncorrectable.items()})


def _sharded_need(sh) -> set:
    need = set()
    for cell in sh.shards[0]:
        need |= _needed_kernels(cell)
    return need


def _shard_loads(sh) -> list:
    loads = [0] * sh.n_shards
    for path, s in sh.shard_of.items():
        leaf = sh.leaf(path)
        loads[s] += leaf.numel() * leaf.element_size()
    return loads


def _plan(word: int, bits) -> "object":
    from repro_torch.core import InjectionPlan
    bits = list(bits)
    return InjectionPlan(np.full(len(bits), word, np.int32),
                         np.array(bits, np.int32), hard=False)


def _words(sh, path: str) -> int:
    """The whole 64-bit words of a leaf."""
    leaf = sh.leaf(path)
    return leaf.numel() * leaf.element_size() // 8


def _largest(sh, n: int) -> list:
    size = {p: sh.leaf(p).numel() * sh.leaf(p).element_size()
            for p in sh.paths(protected_only=True)}
    return sorted(size, key=lambda p: (-size[p], p))[:n]


def _sharded_drill(policy_name: str, device) -> dict:
    """Phase 11 (a) on one device: tiny llama3-8b, 2 replicas x 3 shards;
    strikes, scrub, recovery and a second scrub. Returns what must be
    equal on the card and the CPU."""
    from repro_torch.configs import get_tiny
    from repro_torch.core import (DESIGN_POINTS, ShardedMemoryDomain, Tier,
                                  tree)
    from repro_torch.models import init_params
    params = init_params(get_tiny("llama3-8b"), seed=SEED, device=device)
    sh = ShardedMemoryDomain.protect(params, DESIGN_POINTS[policy_name](),
                                     n_replicas=SHARD_TINY[0],
                                     n_shards=SHARD_TINY[1])
    originals = dict(zip(sh.order, tree.leaves(params)))
    sh, events = sh.inject(np.random.default_rng(SEED), 4, replica=0)
    # replica 1: a strike the tier flags (two bits under SEC-DED, one
    # under parity), so that recovery finds work on both replicas
    path = _largest(sh, 1)[0]
    double = sh.tier_of(path) is Tier.SECDED
    sh = sh.apply_plan(path, _plan(5, (3, 9) if double else (3,)), replica=1)
    sh, rep = sh.scrub()
    sh, rec = sh.recover(rep, clean_copy=originals.__getitem__)
    _, rep2 = sh.scrub()
    return {"shard_of": sh.shard_of, "events": events,
            "per_shard": [[_counts(r) for r in row] for row in rep.per_shard],
            "merged": _counts(rep.domain_report()), "totals": rep.totals(),
            "needs": rep.needs_recovery(), "recover": rec,
            "second": rep2.totals(), "need": _sharded_need(sh),
            "bytes": [_bytes(x).cpu() for r in range(sh.n_replicas)
                      for x in tree.leaves(sh.state(r))]}


def sharded_card_vs_cpu(dev, by_path: dict) -> None:
    """Phase 11 (a): the tiny drill under typical_server and peer_dr_l on
    the CPU, then on the card (its launches counted on their own): equal
    partitions, strikes, per-shard and merged reports, recovery events and
    restored bytes."""
    from repro_torch.kernels import _build
    for name in ("typical_server", "peer_dr_l"):
        cpu = _sharded_drill(name, "cpu")
        _build.reset_launches()
        card = _sharded_drill(name, dev)
        _path_launches(f"sharded_tiny_{name}", card["need"], by_path)
        diff = [k for k in cpu if k != "bytes" and cpu[k] != card[k]]
        same_bytes = all(torch.equal(a, b)
                         for a, b in zip(cpu["bytes"], card["bytes"]))
        print(f"sharded tiny {name} {SHARD_TINY[0]}x{SHARD_TINY[1]}: "
              f"totals={card['totals']} recovered="
              f"{[(e['replica'], e['path'], e['action']) for e in card['recover']]}"
              f" second_scrub={card['second']} card == cpu: "
              f"{'yes' if not diff and same_bytes else diff}")
        if diff or not same_bytes:
            raise AssertionError(f"sharded {name}: the card differs from the "
                                 f"CPU in {diff or 'the restored bytes'}")


def sharded_full_depth(params, dev, by_path: dict) -> None:
    """Phase 11 (b): peer_dr_l over llama3-8b's 32 layers as 2 replicas x 4
    shards: plan strikes against the unsharded domain, drawn strikes
    recovered from the peer, a leaf struck on both replicas reloaded from
    the clean copy (the caller's untouched tensors), and retirement under
    the replica's key."""
    from repro_torch.core import (MemoryDomain, RetirementMap,
                                  ShardedMemoryDomain, peer_dr_l, tree)
    from repro_torch.examples._common import same_bits
    from repro_torch.kernels import _build
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sh, t_protect = _timed(lambda: ShardedMemoryDomain.protect(
        params, peer_dr_l(), n_replicas=SHARD_FULL[0],
        n_shards=SHARD_FULL[1]))
    originals = dict(zip(sh.order, tree.leaves(params)))
    print(f"sharded full {sh!r}: protect_ms={t_protect:.1f} per-shard "
          f"bytes={[_gb(x) for x in _shard_loads(sh)]}")
    # 2. the same single-bit plans on replica 0 and on an unsharded domain
    rng = np.random.default_rng(SHARD_SEED)
    plans = [(p, _plan(int(rng.integers(0, _words(sh, p))),
                       (int(rng.integers(0, 64)),)))
             for p in _largest(sh, SHARD_PLAN_LEAVES)]
    struck = sh
    for path, plan in plans:
        struck = struck.apply_plan(path, plan, replica=0)
    _, rep = struck.scrub()
    sharded = (_counts(rep.domain_report()), rep.needs_recovery())
    del struck, rep
    # the unsharded domain's launches are its own path's, not the
    # sharded path's: the sharded window so far is set aside
    sharded_window = dict(_build.LAUNCHES)
    _build.reset_launches()
    single = MemoryDomain.protect(params, peer_dr_l())
    for path, plan in plans:
        single = single.apply_plan(path, plan)
    _, s_rep = single.scrub()
    unsharded = (_counts(s_rep), {0: s_rep.needs_recovery()})
    _path_launches("unsharded_full", _needed_kernels(single),
                   by_path)
    del single, s_rep
    _build.reset_launches()
    print(f"sharded full plans on {[p for p, _ in plans]}: merged "
          f"detected={sharded[0][1]} unsharded detected={unsharded[0][1]}")
    if sharded != unsharded:
        raise AssertionError("the sharded merged report differs from the "
                             "unsharded domain's")
    # 3. drawn strikes on replica 0, recovered from replica 1
    struck, events = sh.inject(np.random.default_rng(SHARD_SEED),
                               SHARD_STRIKES, replica=0)
    fixed, rep = struck.scrub()
    del struck
    healed, rec = fixed.recover(rep)
    del fixed
    _, rep2 = healed.scrub()
    exact = same_bits(healed.state(0), params)
    print(f"sharded full strikes: {[(e['path'], e['words']) for e in events]}"
          f" scrub={rep.totals()} recovered="
          f"{[(e['action'], e['path'], e.get('donor')) for e in rec]} "
          f"state(0) bit-exact={exact} second_scrub={rep2.totals()}")
    if not rec or any(e["action"] != "peer_copy" or e["donor"] != 1
                      for e in rec) or not exact or rep2.totals() != (0, 0):
        raise AssertionError("the drawn strikes were not all healed by "
                             "peer copies from replica 1")
    del healed, rep, rep2
    # 4. the same leaf struck on both replicas: the disk path
    path = SHARD_DRILL_LEAF
    plan = _plan(_words(sh, path) // 3, (17,))
    both = sh.apply_plan(path, plan, replica=0)
    both = both.apply_plan(path, plan, replica=1)
    both, rep = both.scrub()
    both, rec = both.recover(rep, clean_copy=originals.__getitem__)
    exact = all(same_bits(both.state(r), params) for r in range(2))
    print(f"sharded full both replicas struck on {path}: recovered="
          f"{[(e['replica'], e['action']) for e in rec]} bit-exact={exact}")
    if [e["action"] for e in rec] != ["reload_clean_copy"] * 2 or not exact:
        raise AssertionError("a leaf struck on every replica was not "
                             "reloaded from the clean copy")
    del both, rep
    # 5. the same leaf struck retire_after times: retired under replica 0
    strikes, retired = {}, RetirementMap()
    cur, actions = sh, []
    for _ in range(SHARD_RETIRE_AFTER):
        cur = cur.apply_plan(path, _plan(130, (3,)), replica=0)
        cur, rep = cur.scrub()
        cur, rec = cur.recover(rep, strikes=strikes, retirement=retired,
                               retire_after=SHARD_RETIRE_AFTER)
        actions += [e["action"] for e in rec]
    exact = same_bits(cur.state(0), params)
    print(f"sharded full retirement: actions={actions} strikes={strikes} "
          f"retired={ {k: sorted(v) for k, v in retired.blocks.items()} } "
          f"bit-exact={exact}")
    if actions[-1] != "peer_copy+retire" or \
            set(retired.blocks) != {f"replica0/{path}"} or not exact:
        raise AssertionError("retirement did not key the blocks by replica")
    del cur
    _path_launches("sharded_full", _sharded_need(sh), by_path,
                   earlier=sharded_window)
    print(f"sharded full peak_bytes={torch.cuda.max_memory_allocated()}")


def _median_ms(fn) -> float:
    """Median wall ms of VERB_REPS calls after one warm-up call."""
    out, _ = _timed(fn)
    del out
    times = []
    for _ in range(VERB_REPS):
        out, ms = _timed(fn)
        del out
        times.append(ms)
    return _med(times)


def _verb_times(dom, clean_copy, **inject_kw) -> dict:
    """Median ms of scrub, a 3-strike inject, recover (peer copies for a
    sharded domain, reloads from ``clean_copy`` for a plain one) and
    refresh of ``dom``, and one warm scrub's peak."""
    rng = lambda: np.random.default_rng(SHARD_SEED)  # noqa: E731
    struck, _ = dom.inject(rng(), SHARD_STRIKES, **inject_kw)
    flagged, rep = struck.scrub()
    del struck
    out = {"scrub_ms": _median_ms(dom.scrub),
           "inject_ms": _median_ms(lambda: dom.inject(
               rng(), SHARD_STRIKES, **inject_kw)),
           "recover_ms": _median_ms(lambda: flagged.recover(
               rep, clean_copy=clean_copy)),
           "refresh_ms": _median_ms(dom.refresh)}
    del flagged, rep
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    scrubbed = dom.scrub()
    _sync()
    out["scrub_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["resident_bytes"] = resident
    del scrubbed
    return out


def sharded_verbs(params, by_path: dict) -> None:
    """Phase 11 (d): the verbs' median wall ms at 32 layers under peer_dr_l,
    sharded 2 x 4 (both replicas scrubbed and refreshed) and unsharded,
    with each scrub's peak; the fleet's footprint and sidecar overhead."""
    from repro_torch.core import (MemoryDomain, ShardedMemoryDomain,
                                  peer_dr_l, tree)
    from repro_torch.kernels import _build
    _build.reset_launches()
    sh = ShardedMemoryDomain.protect(params, peer_dr_l(),
                                     n_replicas=SHARD_FULL[0],
                                     n_shards=SHARD_FULL[1])
    originals = dict(zip(sh.order, tree.leaves(params)))
    t_sh = _verb_times(sh, originals.__getitem__, replica=0)
    phys, st = sh.physical_stats(), sh.stats()
    _path_launches("sharded_verbs", _sharded_need(sh), by_path)
    del sh
    single = MemoryDomain.protect(params, peer_dr_l())
    t_one = _verb_times(single, originals.__getitem__)
    s_st = single.stats()
    del single
    print(f"sharded verbs peer_dr_l {SHARD_FULL[0]}x{SHARD_FULL[1]} "
          f"(median of {VERB_REPS} warm calls, wall ms): "
          + json.dumps({k: round(v, 3) if k.endswith("_ms") else v
                        for k, v in t_sh.items()}))
    print(f"unsharded verbs peer_dr_l (the same, one replica): "
          + json.dumps({k: round(v, 3) if k.endswith("_ms") else v
                        for k, v in t_one.items()}))
    print(f"sharded physical_stats={json.dumps(phys)} "
          f"logical payload={st.payload_bytes} sidecar={st.sidecar_bytes} "
          f"overhead={st.overhead:.4%}; unsharded sidecar="
          f"{s_st.sidecar_bytes} overhead={s_st.overhead:.4%}")


def sharded_typical_server(params, by_path: dict) -> None:
    """Phase 11 (c): typical_server over the 32 layers, 1 replica x {2, 4,
    8} shards: a single-bit strike corrected, a double-bit strike flagged,
    and one warm scrub's time and peak memory per shard count. The
    unsharded scrub is not run; its reckoning is printed."""
    from repro_torch.core import ShardedMemoryDomain, tree, typical_server
    from repro_torch.kernels import _build
    payload = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    for n in SHARD_COUNTS:
        _build.reset_launches()
        sh = ShardedMemoryDomain.protect(params, typical_server(),
                                         n_replicas=1, n_shards=n)
        one, two = _largest(sh, 2)
        struck = sh.apply_plan(one, _plan(_words(sh, one) // 3, (11,)))
        struck = struck.apply_plan(two, _plan(_words(sh, two) // 2,
                                              (20, 21)))
        fixed, rep = struck.scrub()
        del struck, fixed
        corr, unc = _counts(rep.domain_report())
        ok = (corr[one] == 1 and sum(corr.values()) == 1
              and unc[two] == 1 and sum(unc.values()) == 1
              and rep.needs_recovery() == {0: {two: 1}})
        del rep
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, ms = _timed(sh.scrub)
        peak = torch.cuda.max_memory_allocated()
        del out
        _path_launches(f"sharded_typical_server_{n}", _sharded_need(sh),
                       by_path)
        print(f"sharded typical_server 1x{n}: per-shard bytes="
              f"{[_gb(x) for x in _shard_loads(sh)]} single-bit on {one} "
              f"corrected={corr[one]} double-bit on {two} flagged={unc[two]}"
              f" warm_scrub_ms={ms:.1f} resident={resident} "
              f"scrub_peak_bytes={peak} ({_gb(peak)})")
        del sh
        if not ok:
            raise AssertionError(f"typical_server 1x{n}: corrected {corr}, "
                                 f"flagged {unc}")
    # resident payload and check bytes, then the packed words, the
    # corrected words and the new check bytes of the one tier buffer
    print(f"unsharded typical_server scrub at 32 layers: not run; reckoned "
          f"peak {_gb(payload)} x (1 + 1/8 + 1 + 1 + 1/8) = "
          f"{_gb(int(payload * 3.25))}")


def run_sharded(dev, by_path: dict) -> None:
    """Phase 11 (a)-(d): each part runs, and the phase fails after the last
    if any part failed its checks."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import init_params
    failed = []

    def part(fn, *args):
        try:
            fn(*args)
        except AssertionError as e:
            print(f"FAILED {fn.__name__}: {e}")
            failed.append(fn.__name__)

    part(sharded_card_vs_cpu, dev, by_path)
    cfg = get_config("llama3-8b")
    params, ms = _timed(lambda: init_params(cfg, seed=SEED, device=dev))
    leaves = tree.leaves(params)
    print(f"sharded model: llama3-8b at its full config, layers="
          f"{cfg.n_layers} params={sum(t.numel() for t in leaves)} bytes="
          f"{sum(t.numel() * t.element_size() for t in leaves)} "
          f"({cfg.param_dtype}) init_ms={ms:.1f}; nothing cut")
    del leaves
    part(sharded_full_depth, params, dev, by_path)
    part(sharded_verbs, params, by_path)
    part(sharded_typical_server, params, by_path)
    if failed:
        raise AssertionError(f"phase 11 parts failed: {failed}")


def run_examples(dev, by_path: dict) -> None:
    """Phase 11 (e): the port's examples on the card at their own sizes,
    each path's launches counted on their own; each must end with its OK
    line. The mesh placement of ``sharded_domain`` needs 8 cards and must
    raise on fewer."""
    from repro_torch.core import tracegen
    from repro_torch.examples import (characterize, graph_pagerank,
                                      quickstart, serve_kv, sharded_domain,
                                      train_hrm)
    from repro_torch.kernels import _build
    codec = {"parity_encode", "parity_check", "bitflip"}
    secded = {"secded_encode", "secded_scrub"}
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    month = out / "examples_month.npz"
    tracegen.main(["--out", str(month), "--seed", str(TRACE_SEED)])
    n_cards = torch.cuda.device_count()
    print(f"examples: torch.cuda.device_count()={n_cards}; sharded_domain "
          f"--placement mesh needs 8 CUDA devices (2 replicas x 4 shards), "
          f"so it runs with --placement virtual")
    if n_cards < 8:
        try:
            sharded_domain.main([])
        except ValueError as e:
            print(f"examples sharded_domain --placement mesh raised: {e}")
        else:
            raise AssertionError("the mesh placement ran on fewer than 8 "
                                 "cards")
    runs = (("quickstart", quickstart, [], codec | secded),
            ("serve_kv", serve_kv, [], codec),
            ("graph_pagerank", graph_pagerank, [],
             codec | secded | set(GRAPH_KERNELS)),
            ("train_hrm", train_hrm, ["--small"], codec),
            ("characterize", characterize, [], {"bitflip", "segsum_push"}),
            ("characterize_trace", characterize, ["--trace", str(month)],
             {"bitflip", "segsum_push"}),
            ("sharded_domain", sharded_domain, ["--placement", "virtual"],
             codec))
    for name, module, argv, need in runs:
        _build.reset_launches()
        text, ms = _timed(lambda: _stdout_of(module.main, argv))
        lines = text.strip().splitlines()
        print(f"examples {name} {' '.join(argv)}: wall_s={ms / 1e3:.3f} "
              f"last={lines[-1]!r}")
        print("  | " + "\n  | ".join(lines[-6:-1]))
        _path_launches(f"examples_{name}", need, by_path)
        if not lines[-1].endswith(" OK"):
            raise AssertionError(f"example {name} did not end with its OK "
                                 "line")


# ------------------------------------------------ 12. the other families
def _family_cfg(arch: str):
    """The arch's full config, its depth cut where FAMILY_DEPTH says."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in FAMILY_DEPTH:
        cfg = cfg.replace(n_layers=FAMILY_DEPTH[arch])
    return cfg


def _no_drop(cfg):
    """``cfg`` at a capacity factor under which no MoE token is dropped."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=FAMILY_NO_DROP))


def _leaf_bytes(tree_) -> int:
    from repro_torch.core import tree
    return sum(t.numel() * t.element_size() for t in tree.leaves(tree_))


def _tiny_run(cfg, device, campaign: bool):
    """Tiny ``cfg`` on one device from one seed: (parameters, forward
    logits, aux, FAMILY_DECODE_STEPS decode logits, serve_batch tokens and
    report, the campaign's outcomes when ``campaign``), results on the
    CPU."""
    import dataclasses
    from repro_torch.core import DESIGN_POINTS, characterize
    from repro_torch.draws import Stream
    from repro_torch.models import decode_step, forward, init_cache, \
        init_params
    from repro_torch.runtime.serve_loop import serve_batch
    p = init_params(cfg, seed=SEED, device=device)
    toks = Stream(SEED + 2, device).randint(
        cfg.vocab_size, (2, FAMILY_TINY_TOKENS))
    logits, aux, _ = forward(p, {"tokens": toks}, cfg)
    cache = init_cache(cfg, 2, FAMILY_DECODE_STEPS, device=device)
    dec = []
    for t in range(FAMILY_DECODE_STEPS):
        lg, cache = decode_step(p, toks[:, t], t, cache, cfg)
        dec.append(lg)
    prompts = Stream(SEED + 1, device).randint(cfg.vocab_size, (4, 16))
    policy = dataclasses.replace(DESIGN_POINTS["detect_recover"](),
                                 scrub_interval=4)
    gen, rep = serve_batch(cfg, p, prompts, 12, policy=policy,
                           error_rate_per_token=SERVE_ERROR_RATE,
                           seed=SERVE_SEED)
    outcomes = None
    if campaign:
        ev = characterize.lm_eval_fn(cfg, {"tokens": toks}, forward)
        outcomes = [(path, kind, o.value) for path, kind, o in
                    characterize.run_campaign(
                        ev, p, n_trials=FAMILY_TINY_TRIALS,
                        seed=SEED).trials]
    return (p, logits.float().cpu(), float(aux), torch.stack(dec, 1).cpu(),
            gen.cpu(), rep, outcomes)


def families_card_vs_cpu(dev, by_path: dict) -> None:
    """(a) The four tiny configs in float32 compute, on the card and on the
    CPU from one seed: parameters equal bit for bit; ``forward`` logits,
    ``aux`` and FAMILY_DECODE_STEPS ``decode_step`` logits within
    FAMILY_TINY_REL x max|value|; ``serve_batch`` tokens and report equal
    under detect_recover with strikes; tiny granite's campaign
    (FAMILY_TINY_TRIALS soft and as many hard trials) equal trial by
    trial."""
    from repro_torch.configs import get_tiny
    from repro_torch.core import tree
    from repro_torch.kernels import _build
    _build.reset_launches()
    for arch in FAMILY_ARCHS:
        cfg = get_tiny(arch).replace(compute_dtype="float32")
        campaign = arch == FAMILY_ONLINE_ARCH
        card = _tiny_run(cfg, dev, campaign)
        cpu = _tiny_run(cfg, torch.device("cpu"), campaign)
        unequal = sum(
            not torch.equal(_bytes(a.cpu()), _bytes(b))
            for a, b in zip(tree.leaves(card[0]), tree.leaves(cpu[0])))
        lg = float((card[1] - cpu[1]).abs().max()) / float(
            cpu[1].abs().max())
        dec = float((card[3] - cpu[3]).abs().max()) / float(
            cpu[3].abs().max())
        aux = abs(card[2] - cpu[2]) / max(abs(cpu[2]), 1e-30)
        same_tokens = torch.equal(card[4], cpu[4])
        same_report = card[5] == cpu[5]
        same_trials = card[6] == cpu[6]
        trials = "" if cpu[6] is None else (
            f" campaign trials={len(cpu[6])} outcomes equal trial by trial="
            f"{same_trials} (card: " + json.dumps(
                {o: sum(t[2] == o for t in card[6])
                 for o in sorted({t[2] for t in card[6]})}) + ")")
        print(f"families tiny {arch} card vs cpu (float32): unequal "
              f"parameter leaves={unequal} of {len(tree.leaves(cpu[0]))} "
              f"forward max|diff|/max|logit|={lg:.3g} aux rel diff={aux:.3g}"
              f" ({card[2]:.6g}) decode {FAMILY_DECODE_STEPS} steps max|diff|"
              f"/max|logit|={dec:.3g} serve_batch tokens equal={same_tokens}"
              f" report equal={same_report} (injected={card[5].injected} "
              f"detected={card[5].scrub_detected}){trials}")
        if unequal or lg > FAMILY_TINY_REL or dec > FAMILY_TINY_REL or \
                aux > FAMILY_TINY_REL or not same_tokens or \
                not same_report or not same_trials:
            raise AssertionError(f"families tiny {arch}: card and CPU differ")
    _path_launches("families_tiny", {"bitflip", "parity_encode",
                                     "parity_check"}, by_path)


def families_serve(dev, by_path: dict) -> None:
    """(b) ``serve_batch`` on the four configs at full width
    (deepseek-moe-16b's depth cut), SERVE_BATCH prompts of SERVE_PROMPT
    tokens and SERVE_NEW new tokens under FAMILY_POLICIES with phase 8's
    strikes; decode against ``forward`` first (at a no-drop capacity for
    MoE). Under typical_server every single-bit strike must be corrected
    and every double-bit one flagged. Each arch's launches are a path."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import DESIGN_POINTS, tree
    from repro_torch.draws import Stream
    from repro_torch.kernels import _build
    from repro_torch.models import init_cache, init_params
    from repro_torch.runtime.serve_loop import serve_batch
    last_scrub = (SERVE_NEW - 1) // SERVE_SCRUB_INTERVAL \
        * SERVE_SCRUB_INTERVAL
    n_tok = SERVE_BATCH * SERVE_NEW
    for arch in FAMILY_ARCHS:
        cfg = _family_cfg(arch)
        params = init_params(cfg, seed=SEED, device=dev)
        prompts = Stream(SEED + 1, dev).randint(cfg.vocab_size,
                                                (SERVE_BATCH, SERVE_PROMPT))
        cache_bytes = _leaf_bytes(init_cache(
            cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW, device="meta"))
        n_params = sum(t.numel() for t in tree.leaves(params))
        cut = (f" depth cut {get_config(arch).n_layers}->{cfg.n_layers}"
               if arch in FAMILY_DEPTH else " nothing cut")
        print(f"families serve {arch}: family={cfg.family} layers="
              f"{cfg.n_layers}{cut} d_model={cfg.d_model} params={n_params}"
              f" bytes={_leaf_bytes(params)} ({cfg.param_dtype}) cache_bytes"
              f"={cache_bytes} (batch {SERVE_BATCH} x "
              f"{SERVE_PROMPT + SERVE_NEW}) compute={cfg.compute_dtype}")
        _check_decode_logits(_no_drop(cfg), params, prompts)
        _build.reset_launches()
        for name in FAMILY_POLICIES:
            policy = dataclasses.replace(
                DESIGN_POINTS[name](), scrub_interval=SERVE_SCRUB_INTERVAL)
            torch.cuda.reset_peak_memory_stats()
            with _ServeTimer() as timer:
                (toks, rep), wall_ms = _timed(lambda: serve_batch(
                    cfg, params, prompts, SERVE_NEW, policy=policy,
                    error_rate_per_token=SERVE_ERROR_RATE, seed=SERVE_SEED))
            peak = torch.cuda.max_memory_allocated()
            strikes = _serve_strikes(timer.spec, policy, SERVE_NEW,
                                     SERVE_ERROR_RATE, SERVE_SEED)
            if rep.injected != len(strikes) or not strikes:
                raise AssertionError(f"families serve {arch} {name}: "
                                     f"injected {rep.injected}, the stream "
                                     f"draws {len(strikes)}")
            if toks.shape != (SERVE_BATCH, SERVE_NEW) or \
                    int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
                raise AssertionError(f"families serve {arch} {name}: "
                                     f"tokens {tuple(toks.shape)} out of "
                                     "range")
            expect = ""
            if name == "typical_server":
                single, double = _secded_expected(strikes, last_scrub)
                if (rep.scrub_corrected, rep.scrub_detected) != \
                        (single, double):
                    raise AssertionError(
                        f"families serve {arch} typical_server: corrected "
                        f"{rep.scrub_corrected} detected "
                        f"{rep.scrub_detected}, struck before the last "
                        f"scrub: {single} single-bit, {double} double-bit "
                        "words")
                expect = (f" (expected: {single} single-bit, {double} "
                          f"double-bit words struck by step {last_scrub})")
            tok = sorted(timer.ms["token"])
            print(f"families serve {arch} {name}: prefill_ms="
                  f"{timer.ms['prefill'][0]:.2f} ms_per_token_median="
                  f"{tok[len(tok) // 2]:.3f} tokens_per_s="
                  f"{n_tok / wall_ms * 1e3:.1f} (wall_ms={wall_ms:.1f}, "
                  f"prefill and protect included) decode_tokens_per_s="
                  f"{SERVE_BATCH / tok[len(tok) // 2] * 1e3:.1f} strikes_"
                  f"drawn={len(strikes)} injected={rep.injected} corrected="
                  f"{rep.scrub_corrected} flagged={rep.scrub_detected}"
                  f"{expect} scrubs={len(timer.ms['scrub'])} scrub_ms_mean="
                  f"{np.mean(timer.ms['scrub'] or [0]):.2f} sidecar_overhead"
                  f"={rep.sidecar_overhead:.4f} peak_bytes={peak}")
        _path_launches(f"families_serve_{arch}", SERVE_KERNELS, by_path)
        del params, prompts
        torch.cuda.empty_cache()


def families_online(dev, by_path: dict) -> None:
    """(c) ``OnlineEngine`` on granite-moe-3b-a800m whole with phase 10's
    plane, trace and storm under detect_recover + parity_r (a golden and a
    storm pass, model clock, ``debug_invariants``; each pass a path), then
    a FAMILY_CHECK_REQUESTS-request golden pass at a no-drop capacity
    whose first PAGED_CHECK_STEPS decode steps are held against
    ``decode_step`` on each active slot's gathered pages."""
    from repro_torch.kernels import _build
    from repro_torch.models import init_params, transformer
    from repro_torch.serve import engine as engine_mod, incorrect_rate
    cfg = _family_cfg(FAMILY_ONLINE_ARCH)
    params = init_params(cfg, seed=SEED, device=dev)
    tc, trace = _online_traffic(cfg)
    golden = None
    for storm in (0, ONLINE_STORM):
        eng = _online_engine(cfg, params, tc, "detect_recover", "parity_r")
        need = _needed_kernels(eng.param_domain) | \
            _needed_kernels(eng.kv_domain) | {"paged_attn_decode"}
        if not storm:
            need.discard("bitflip")
            pool = eng.cache.pool_k
            print(f"families online {FAMILY_ONLINE_ARCH}: pages="
                  f"{eng.cache.n_pages} pool_bytes=2x"
                  f"{pool.numel() * pool.element_size()} requests="
                  f"{ONLINE_REQUESTS} bursty {ONLINE_RATE}/s seed "
                  f"{ONLINE_SEED} storm={ONLINE_STORM} capacity_factor="
                  f"{cfg.moe.capacity_factor}")
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (rep, resp), ms = _timed(lambda: eng.run(trace, storm_errors=storm))
        name = f"families_online_{'storm' if storm else 'golden'}"
        _path_launches(name, need, by_path)
        c = rep.counters
        if rep.completed + rep.shed != rep.n_requests:
            raise AssertionError(f"{name}: {rep.completed} completed + "
                                 f"{rep.shed} shed of {rep.n_requests}")
        if storm:
            if c["injected_params"] + c["injected_kv"] != storm:
                raise AssertionError(f"{name}: injected {c}")
            rep.incorrect_rate = incorrect_rate(golden, resp)
        else:
            golden = resp
        bar = "PASS" if rep.availability >= AVAILABILITY_BAR else "FAIL"
        print(f"{name}: wall_s={ms / 1e3:.2f} {rep.summary()} "
              f"availability_vs_99.90%={bar} counters={json.dumps(c)} "
              f"peak_bytes={torch.cuda.max_memory_allocated()}")
        del eng
    cfg16 = _no_drop(cfg)
    tc16, trace16 = _online_traffic(cfg16, n_requests=FAMILY_CHECK_REQUESTS)
    eng = _online_engine(cfg16, params, tc16, "detect_recover", "parity_r")
    eng._decode = engine_mod.paged_decode_step   # eager: the check syncs
    checks = []
    real, checked = _paged_logit_check(cfg16, checks)
    transformer.paged_decode_logits = checked
    try:
        rep, _ = eng.run(trace16, storm_errors=0)
    finally:
        transformer.paged_decode_logits = real
    print(f"families online {FAMILY_ONLINE_ARCH} capacity_factor="
          f"{FAMILY_NO_DROP}: {rep.summary()}")
    _print_paged_check(checks)
    if not all(a for _, _, _, a in checks):
        raise AssertionError("families online: paged and contiguous decode "
                             "disagree on a clear token")


def families_campaign(dev, by_path: dict) -> None:
    """(d) The Fig. 2 campaign at full width on FAMILY_REGIONS' configs:
    the query the greedy tokens of ``lm_batch(cfg, CAMPAIGN_BATCH,
    CAMPAIGN_SEQ, SEED)``, after phase 7's determinism check;
    FAMILY_REGION_TRIALS single-error soft trials in each region (one
    ``run_campaign`` a region), masked / incorrect / crash shares
    printed. Each config's launches are a path."""
    from repro_torch.core import Outcome, characterize, lm_eval_fn
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import _build
    from repro_torch.models import forward, init_params
    for arch, regions in FAMILY_REGIONS.items():
        cfg = _family_cfg(arch)
        params = init_params(cfg, seed=SEED, device=dev)
        batch = lm_batch(cfg, CAMPAIGN_BATCH, CAMPAIGN_SEQ, SEED,
                         device=dev)
        ev = lm_eval_fn(cfg, batch, forward)
        name = f"families_campaign_{arch}"
        dom, _, unwrap = characterize._campaign_domain(params, "params")
        _check_query(name, ev, dom, unwrap)
        _build.reset_launches()
        for region in regions:
            res, ms = _timed(lambda: characterize.run_campaign(
                ev, dom, n_trials=FAMILY_REGION_TRIALS, seed=SEED,
                kinds=("soft",), region_filter=lambda r: r == region))
            n = len(res.trials)
            masked = sum(o in (Outcome.MASKED_OVERWRITE, Outcome.MASKED_LOGIC)
                         for _, _, o in res.trials)
            wrong = sum(o is Outcome.INCORRECT for _, _, o in res.trials)
            crash = sum(o is Outcome.CRASH for _, _, o in res.trials)
            if n != FAMILY_REGION_TRIALS or \
                    {dom.spec.by_path[p].region for p, _, _ in
                     res.trials} != {region}:
                raise AssertionError(f"{name}: {n} trials outside {region}")
            print(f"{name}: region={region} soft trials={n} masked="
                  f"{masked / n:.4f} incorrect={wrong / n:.4f} crash="
                  f"{crash / n:.4f} wall_s={ms / 1e3:.2f}")
        _path_launches(name, {"bitflip"}, by_path)
        del dom, params
        torch.cuda.empty_cache()


def run_families(dev, by_path: dict) -> None:
    """Phase 12 (a)-(d): each part runs, and the phase fails after the last
    if any part failed its checks."""
    print(f"families: {card_line()}")
    failed = []
    for part in (families_card_vs_cpu, families_serve, families_online,
                 families_campaign):
        try:
            part(dev, by_path)
        except AssertionError as e:
            print(f"FAILED {part.__name__}: {e}")
            failed.append(part.__name__)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 12 parts failed: {failed}")


# ------------------------------------------- 13. the audio and vision frontends
def _frontend_cfg(arch: str):
    """The arch's full config, llava's depth cut to VLM_LAYERS."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.replace(n_layers=VLM_LAYERS) if arch == VLM_ARCH else cfg


def _vlm_prefill(cfg, params, batch, new: int):
    """``make_prefill_step`` on the batch's tokens and patches: (the greedy
    next token, the cache padded for ``new`` decode steps, S0, ms)."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.serve_loop import _with_headroom
    from repro_torch.runtime.steps import make_prefill_step
    inputs = {"tokens": batch["tokens"], "patches": batch["patches"]}
    (last, cache), ms = _timed(lambda: make_prefill_step(cfg)(params,
                                                              inputs))
    B, S0 = batch["tokens"].shape[0], cfg.n_patches + \
        batch["tokens"].shape[1]
    full = init_cache(cfg, B, S0 + new, device=batch["tokens"].device)
    return torch.argmax(last, dim=-1), _with_headroom(cache, full), S0, ms


def _tiny_frontend_run(cfg, device):
    """Tiny ``cfg`` on one device from one seed: (parameters, forward
    logits, FAMILY_DECODE_STEPS decode logits after a patch-prefixed
    prefill (vlm; None for audio), campaign outcomes), results on the
    CPU."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import characterize
    from repro_torch.data.synthetic import make_batch
    from repro_torch.draws import Stream
    from repro_torch.models import decode_step, forward, init_params
    p = init_params(cfg, seed=SEED, device=device)
    batch = make_batch(cfg, ShapeSpec("t", FAMILY_TINY_TOKENS, 2, "train"),
                       seed=SEED + 2, device=device)
    logits = forward(p, batch, cfg)[0]
    dec = None
    if cfg.family == "vlm":
        _, cache, S0, _ = _vlm_prefill(cfg, p, batch, FAMILY_DECODE_STEPS)
        toks = Stream(SEED + 1, device).randint(cfg.vocab_size,
                                                (2, FAMILY_DECODE_STEPS))
        dec = []
        for t in range(FAMILY_DECODE_STEPS):
            lg, cache = decode_step(p, toks[:, t], S0 + t, cache, cfg)
            dec.append(lg)
        dec = torch.stack(dec, 1).cpu()
    ev = characterize.lm_eval_fn(cfg, batch, forward)
    outcomes = [(path, kind, o.value) for path, kind, o in
                characterize.run_campaign(ev, p, n_trials=FAMILY_TINY_TRIALS,
                                          seed=SEED).trials]
    return p, logits.cpu(), dec, outcomes


def frontends_card_vs_cpu(dev, by_path: dict) -> None:
    """(a) Tiny hubert-xlarge and llava-next-mistral-7b in float32 compute,
    on the card and on the CPU from one seed: parameters equal bit for
    bit; ``forward`` logits and (llava) FAMILY_DECODE_STEPS ``decode_step``
    logits after a patch-prefixed prefill within FAMILY_TINY_REL x
    max|logit|; a campaign of FAMILY_TINY_TRIALS soft and as many hard
    trials equal trial by trial."""
    from repro_torch.configs import get_tiny
    from repro_torch.core import tree
    from repro_torch.kernels import _build
    _build.reset_launches()
    for arch in (AUDIO_ARCH, VLM_ARCH):
        cfg = get_tiny(arch).replace(compute_dtype="float32")
        card = _tiny_frontend_run(cfg, dev)
        cpu = _tiny_frontend_run(cfg, torch.device("cpu"))
        unequal = sum(
            not torch.equal(_bytes(a.cpu()), _bytes(b))
            for a, b in zip(tree.leaves(card[0]), tree.leaves(cpu[0])))
        lg = float((card[1] - cpu[1]).abs().max()) / float(
            cpu[1].abs().max())
        dec = 0.0 if cpu[2] is None else float(
            (card[2] - cpu[2]).abs().max()) / float(cpu[2].abs().max())
        same_trials = card[3] == cpu[3]
        outcomes = json.dumps({o: sum(t[2] == o for t in card[3])
                               for o in sorted({t[2] for t in card[3]})})
        print(f"frontends tiny {arch} card vs cpu (float32): unequal "
              f"parameter leaves={unequal} of {len(tree.leaves(cpu[0]))} "
              f"forward max|diff|/max|logit|={lg:.3g}" + (
                  "" if cpu[2] is None else
                  f" decode {FAMILY_DECODE_STEPS} steps after "
                  f"{cfg.n_patches} patches + "
                  f"{FAMILY_TINY_TOKENS - cfg.n_patches} tokens "
                  f"max|diff|/max|logit|={dec:.3g}")
              + f" campaign trials={len(cpu[3])} outcomes equal trial by "
              f"trial={same_trials} (card: {outcomes})")
        if unequal or lg > FAMILY_TINY_REL or dec > FAMILY_TINY_REL or \
                not same_trials:
            raise AssertionError(f"frontends tiny {arch}: card and CPU "
                                 "differ")
    _path_launches("frontends_tiny", {"bitflip"}, by_path)


def _policy(name: str, interval: int):
    import dataclasses
    from repro_torch.core import DESIGN_POINTS
    return dataclasses.replace(DESIGN_POINTS[name](),
                               scrub_interval=interval)


def _expect_secded(name: str, rep, strikes, last_scrub: int) -> str:
    """Under typical_server, the words struck once before the last scrub
    must be corrected and those struck twice flagged."""
    if name != "typical_server":
        return ""
    single, double = _secded_expected(strikes, last_scrub)
    if (rep.scrub_corrected, rep.scrub_detected) != (single, double):
        raise AssertionError(
            f"typical_server: corrected {rep.scrub_corrected} detected "
            f"{rep.scrub_detected}, struck before the last scrub: {single} "
            f"single-bit, {double} double-bit words")
    return (f" (expected: {single} single-bit, {double} double-bit words "
            f"struck by step {last_scrub})")


def _fault_plane(domain, rep, rng, t: int, interval: int):
    """Step ``t`` of ``serve_batch``'s fault plane: a strike with
    probability SERVE_ERROR_RATE, then a scrub every ``interval`` steps
    after the first, counted into ``rep``. Returns the domain."""
    if rng.random() < SERVE_ERROR_RATE:
        domain, events = domain.inject(rng, 1)
        rep.injected += len(events)
    if t > 0 and t % interval == 0:
        domain, r = domain.scrub()
        c, u = r.totals()
        rep.scrub_corrected += c
        rep.scrub_detected += u
    return domain


def _audio_queries(cfg, params, ev, golden, name: str):
    """AUDIO_QUERIES encoder queries under policy ``name`` with phase 8's
    strike stream (one uniform a query, then ``MemoryDomain.inject``) and
    a scrub before every query after the first: (report, ms per query,
    queries equal to the golden ids, the strikes drawn, peak bytes)."""
    from repro_torch.core import MemoryDomain
    from repro_torch.runtime.serve_loop import ServeReport
    policy = _policy(name, 1)
    torch.cuda.reset_peak_memory_stats()
    domain = MemoryDomain.protect(params, policy)
    rep = ServeReport(sidecar_overhead=domain.stats().overhead)
    rng = np.random.default_rng(SERVE_SEED + 1)
    ms, same = [], 0
    for t in range(AUDIO_QUERIES):
        domain = _fault_plane(domain, rep, rng, t, 1)
        ids, q_ms = _timed(lambda: ev(domain.payload)[0])
        ms.append(q_ms)
        same += bool(torch.equal(ids, golden))
        rep.queries += 1
    strikes = _serve_strikes(domain.spec, policy, AUDIO_QUERIES,
                             SERVE_ERROR_RATE, SERVE_SEED)
    return rep, ms, same, strikes, torch.cuda.max_memory_allocated()


def _audio_train(cfg, params, by_path: dict) -> None:
    """AUDIO_TRAIN_STEPS ``run_training`` steps at batch AUDIO_TRAIN_BATCH x
    AUDIO_FRAMES under typical_server with a scrub every AUDIO_TRAIN_SCRUB
    steps and AUDIO_TRAIN_RATE strikes a step (hard ones included); the
    step-0 snapshot goes to a temporary directory outside the repository.
    Prints ms per step, the scrub and write-path ms and the scrub overhead
    at this interval, (scrub ms + interval x refresh ms) / (interval x step
    ms)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import batch_stream
    from repro_torch.kernels import _build
    from repro_torch.runtime.train_loop import run_training
    need = _train_need({"params": params}, ("params",),
                       _policy("typical_server", AUDIO_TRAIN_SCRUB))
    save, saves = CheckpointStore.save, []

    def timed_save(store, *a, **k):
        out, ms = _timed(lambda: save(store, *a, **k))
        saves.append(ms)
        return out
    with tempfile.TemporaryDirectory() as ck:
        free = shutil.disk_usage(ck).free
        loop = _loop(cfg, "typical_server", AUDIO_TRAIN_STEPS, ck,
                     scrub=AUDIO_TRAIN_SCRUB,
                     error_rate_per_step=AUDIO_TRAIN_RATE,
                     ckpt_interval=10 ** 6)
        stream = batch_stream(cfg, AUDIO_TRAIN_BATCH, AUDIO_FRAMES,
                              seed=SEED, device=params["head"].device)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        CheckpointStore.save = timed_save
        try:
            with _TrainTimer() as timer:
                rep, wall_ms = _timed(lambda: run_training(
                    cfg, TrainConfig(remat="none"), loop, stream,
                    device=params["head"].device))
        finally:
            CheckpointStore.save = save
        peak = torch.cuda.max_memory_allocated()
    _path_launches("frontends_audio_train", need, by_path)
    s = timer.summary()
    overhead = (s["scrub_ms_median"] + AUDIO_TRAIN_SCRUB
                * s["refresh_reassert_ms_median"]) / (
                    AUDIO_TRAIN_SCRUB * s["step_ms_median"])
    print(_report_line(f"frontends audio train {AUDIO_ARCH}", rep)
          + f" batch={AUDIO_TRAIN_BATCH}x{AUDIO_FRAMES} ms_per_step="
          f"{[round(x, 1) for x in timer.ms['step']]} step_ms_median="
          f"{s['step_ms_median']:.1f} scrub_ms_median="
          f"{s['scrub_ms_median']:.2f} refresh_reassert_ms_median="
          f"{s['refresh_reassert_ms_median']:.2f} scrub_overhead_"
          f"{AUDIO_TRAIN_SCRUB}={100 * overhead:.3f}% snapshot_ms="
          f"{[round(x) for x in saves]} (step 0, train state "
          f"{_leaf_bytes(params) * 3} bytes; {free} bytes free there) "
          f"wall_s={wall_ms / 1e3:.1f} peak_bytes={peak}")
    if len(rep.losses) != AUDIO_TRAIN_STEPS or rep.restarts or \
            not np.all(np.isfinite(rep.losses)):
        raise AssertionError("frontends audio train: a step is missing or "
                             "a loss is not finite")


def frontends_audio(dev, by_path: dict) -> None:
    """(b) hubert-xlarge whole: the encoder query (``lm_eval_fn``'s greedy
    cluster id a frame) over AUDIO_BATCH x AUDIO_FRAMES frames,
    AUDIO_QUERIES queries under each of FAMILY_POLICIES with phase 8's
    strikes and a scrub between queries (under typical_server every
    single-bit strike corrected); then ``_audio_train``."""
    from repro_torch.core import lm_eval_fn, tree
    from repro_torch.data.synthetic import audio_batch
    from repro_torch.kernels import _build
    from repro_torch.models import forward, init_params
    cfg = _frontend_cfg(AUDIO_ARCH)
    params = init_params(cfg, seed=SEED, device=dev)
    batch = audio_batch(cfg, AUDIO_BATCH, AUDIO_FRAMES, SEED, device=dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"frontends audio {AUDIO_ARCH}: family={cfg.family} causal="
          f"{cfg.causal} layers={cfg.n_layers} nothing cut d_model="
          f"{cfg.d_model} params={n_params} bytes={_leaf_bytes(params)} "
          f"({cfg.param_dtype}) compute={cfg.compute_dtype} query="
          f"{AUDIO_BATCH}x{AUDIO_FRAMES} frames")
    ev = lm_eval_fn(cfg, batch, forward)
    golden = ev(params)[0]
    if tuple(golden.shape) != (AUDIO_BATCH, AUDIO_FRAMES) or \
            int(golden.min()) < 0 or int(golden.max()) >= cfg.vocab_size:
        raise AssertionError(f"frontends audio: cluster ids "
                             f"{tuple(golden.shape)} out of range")
    _build.reset_launches()
    last_scrub = AUDIO_QUERIES - 1
    for name in FAMILY_POLICIES:
        rep, ms, same, strikes, peak = _audio_queries(cfg, params, ev,
                                                      golden, name)
        if rep.injected != len(strikes) or not strikes:
            raise AssertionError(f"frontends audio {name}: injected "
                                 f"{rep.injected}, the stream draws "
                                 f"{len(strikes)}")
        expect = _expect_secded(name, rep, strikes, last_scrub)
        med = float(np.median(ms))
        print(f"frontends audio {AUDIO_ARCH} {name}: queries={len(ms)} "
              f"ms_per_query_median={med:.3f} (min {min(ms):.3f} max "
              f"{max(ms):.3f}) frames_per_s="
              f"{AUDIO_BATCH * AUDIO_FRAMES / med * 1e3:.1f} strikes_drawn="
              f"{len(strikes)} injected={rep.injected} corrected="
              f"{rep.scrub_corrected} flagged={rep.scrub_detected}{expect} "
              f"queries_equal_golden={same} sidecar_overhead="
              f"{rep.sidecar_overhead:.4f} peak_bytes={peak}")
    _path_launches("frontends_audio_query", SERVE_KERNELS, by_path)
    _audio_train(cfg, params, by_path)


def _vlm_serve(cfg, params, batch, name: str):
    """``make_prefill_step`` on tokens and patches, then VLM_NEW
    ``make_serve_step`` tokens under policy ``name``, composed as
    ``serve_batch`` composes them for tokens (which the reference does
    not do for patches): phase 8's strike stream and scrub interval.
    Returns (tokens, report, prefill ms, ms a token, strikes, wall ms)."""
    from repro_torch.core import MemoryDomain
    from repro_torch.runtime.serve_loop import ServeReport
    from repro_torch.runtime.steps import make_serve_step
    policy = _policy(name, SERVE_SCRUB_INTERVAL)
    serve = make_serve_step(cfg)
    _sync()
    t0 = time.perf_counter()
    token, cache, pos, prefill_ms = _vlm_prefill(cfg, params, batch,
                                                 VLM_NEW)
    domain = MemoryDomain.protect(params, policy)
    rep = ServeReport(sidecar_overhead=domain.stats().overhead)
    rng = np.random.default_rng(SERVE_SEED + 1)
    out, tok_ms = [], []
    for t in range(VLM_NEW):
        domain = _fault_plane(domain, rep, rng, t, SERVE_SCRUB_INTERVAL)
        out.append(token)
        (cache, token, pos), ms = _timed(
            lambda: serve(domain.payload, cache, token, pos))
        tok_ms.append(ms)
        rep.tokens_emitted += token.shape[0]
    _sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rep.queries += token.shape[0]
    strikes = _serve_strikes(domain.spec, policy, VLM_NEW,
                             SERVE_ERROR_RATE, SERVE_SEED)
    return torch.stack(out, 1), rep, prefill_ms, tok_ms, strikes, wall_ms


def _vlm_decode_check(cfg, params, batch, name: str = "frontends vlm",
                      shift: int = 0) -> tuple:
    """The first LOGIT_CHECK_TOKENS decode positions after the
    patch-prefixed prefill against a ``forward`` over the patches, the
    text and the generated tokens: max |diff| printed; greedy tokens equal
    wherever the forward's top-2 margin exceeds it. Returns (max |diff|,
    max|logit|). ``shift`` plants a fault as ``_check_decode_logits``'s
    does."""
    from repro_torch.models import decode_step, forward
    token, cache, S0, _ = _vlm_prefill(cfg, params, batch,
                                       LOGIT_CHECK_TOKENS)
    gen, dec = [], []
    for t in range(LOGIT_CHECK_TOKENS):
        gen.append(token)
        lg, cache = decode_step(params, token, S0 + t + shift, cache, cfg)
        dec.append(lg.float())
        token = torch.argmax(lg, dim=-1)
    del cache
    seq = torch.cat([batch["tokens"], torch.stack(gen, 1)], 1)
    ref = forward(params, {"tokens": seq, "patches": batch["patches"]},
                  cfg)[0][:, S0:].float()
    dec = torch.stack(dec, 1)
    diff = float((dec - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > diff
    agree = bool((dec.argmax(-1) == ref.argmax(-1))[clear].all())
    print(f"{name} decode vs forward ({LOGIT_CHECK_TOKENS} positions"
          f" x {seq.shape[0]} after {S0} prefilled): max|diff|={diff:.4g} "
          f"max|logit|={float(ref.abs().max()):.4g} positions with top-2 "
          f"margin above it: {int(clear.sum())} of {clear.numel()}, tokens "
          f"equal there: {agree}")
    if not agree and not shift:
        raise AssertionError(f"{name}: decode and forward disagree on a "
                             "clear token")
    return diff, float(ref.abs().max())


def _vlm_paged_check(cfg, params, batch, by_path: dict) -> None:
    """VLM_PAGED_STEPS ``paged_decode_logits`` steps on a
    ``PagedKVCache(vlm)`` whose pages hold the patch-prefixed prefill's
    K/V (``prefill_write`` takes no patches, in the reference neither),
    each slot held against ``decode_step`` (batch 1) on its gathered pages
    before the step: max |diff| and greedy tokens equal where the top-2
    margin exceeds it. The steps' launches are the path
    ``frontends_vlm_paged``, which must launch the paged attention."""
    from repro_torch.kernels import _build
    from repro_torch.serve import PagedKVCache
    B = batch["tokens"].shape[0]
    token, cache, S0, _ = _vlm_prefill(cfg, params, batch, 0)
    per_slot = -(-(S0 + VLM_PAGED_STEPS) // VLM_PAGE)
    kv = PagedKVCache(cfg, n_pages=B * per_slot + 1, page_size=VLM_PAGE,
                      slots=B, max_pages_per_slot=per_slot,
                      device=token.device)
    n_pp = S0 // VLM_PAGE
    for i in range(B):
        pages = torch.as_tensor(kv.alloc(i, S0 + VLM_PAGED_STEPS),
                                dtype=torch.int64, device=token.device)
        for name, pool in kv.pools.items():
            pool[:, pages[:n_pp]] = cache[name][:, i].reshape(
                pool.shape[0], n_pp, VLM_PAGE, *pool.shape[3:])
    del cache
    kv.check_invariants()
    checks = []
    _, checked = _paged_logit_check(cfg, checks)
    table = kv.device_table()
    pos = torch.full((B,), S0, dtype=torch.int64, device=token.device)
    _build.reset_launches()
    for _ in range(VLM_PAGED_STEPS):
        logits = checked(params, kv.pools, table, token, pos, cfg,
                         VLM_PAGE)
        token = torch.argmax(logits, dim=-1)
        pos = pos + 1
    diff = max(d for _, d, _, _ in checks)
    top = max(t for _, _, t, _ in checks)
    agree = all(a for _, _, _, a in checks)
    print(f"frontends vlm paged vs contiguous decode ({len(checks)} steps x "
          f"{B} slots, {kv.n_pages} pages of {VLM_PAGE}, pool_bytes=2x"
          f"{kv.pool_k.numel() * kv.pool_k.element_size()}; decode_step "
          f"batch 1 on each slot's gathered pages): max|diff|={diff:.4g} "
          f"max|logit|={top:.4g} tokens equal where the top-2 margin "
          f"exceeds the diff: {agree}")
    _path_launches("frontends_vlm_paged", {"paged_attn_decode"}, by_path)
    if not agree:
        raise AssertionError("frontends vlm: paged and contiguous decode "
                             "disagree on a clear token")


def frontends_vlm(dev, by_path: dict) -> None:
    """(c) llava-next-mistral-7b at full width with VLM_LAYERS layers: the
    decode check against ``forward``, then ``_vlm_serve`` at VLM_BATCH x
    (2,880 patches + VLM_TEXT tokens) and VLM_NEW new tokens under
    FAMILY_POLICIES (every single-bit strike corrected under
    typical_server), then the paged decode check."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.synthetic import vlm_batch
    from repro_torch.kernels import _build
    from repro_torch.models import init_cache, init_params
    cfg = _frontend_cfg(VLM_ARCH)
    params = init_params(cfg, seed=SEED, device=dev)
    batch = vlm_batch(cfg, VLM_BATCH, cfg.n_patches + VLM_TEXT, SEED,
                      device=dev)
    S = cfg.n_patches + VLM_TEXT + VLM_NEW
    cache_bytes = _leaf_bytes(init_cache(cfg, VLM_BATCH, S, device="meta"))
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"reduced: {VLM_ARCH} n_layers {get_config(VLM_ARCH).n_layers}->"
          f"{cfg.n_layers} (whole it is 14.52 GB of bf16 parameters; its "
          f"full depth goes through ShardedMemoryDomain, ROADMAP queue 1, "
          f"item 12b)")
    print(f"frontends vlm {VLM_ARCH}: family={cfg.family} layers="
          f"{cfg.n_layers} d_model={cfg.d_model} params={n_params} bytes="
          f"{_leaf_bytes(params)} ({cfg.param_dtype}) compute="
          f"{cfg.compute_dtype} batch={VLM_BATCH} patches={cfg.n_patches} "
          f"text={VLM_TEXT} new={VLM_NEW} cache_bytes={cache_bytes} "
          f"({S} positions)")
    _vlm_decode_check(cfg, params, batch)
    _build.reset_launches()
    last_scrub = (VLM_NEW - 1) // SERVE_SCRUB_INTERVAL * SERVE_SCRUB_INTERVAL
    n_tok = VLM_BATCH * VLM_NEW
    for name in FAMILY_POLICIES:
        torch.cuda.reset_peak_memory_stats()
        toks, rep, prefill_ms, tok_ms, strikes, wall_ms = _vlm_serve(
            cfg, params, batch, name)
        peak = torch.cuda.max_memory_allocated()
        if rep.injected != len(strikes) or not strikes:
            raise AssertionError(f"frontends vlm {name}: injected "
                                 f"{rep.injected}, the stream draws "
                                 f"{len(strikes)}")
        if toks.shape != (VLM_BATCH, VLM_NEW) or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"frontends vlm {name}: tokens "
                                 f"{tuple(toks.shape)} out of range")
        expect = _expect_secded(name, rep, strikes, last_scrub)
        med = float(np.median(tok_ms))
        print(f"frontends vlm {VLM_ARCH} {name}: prefill_ms={prefill_ms:.2f}"
              f" ({VLM_BATCH}x{cfg.n_patches + VLM_TEXT} positions) "
              f"ms_per_token_median={med:.3f} (min {min(tok_ms):.3f} max "
              f"{max(tok_ms):.3f}) tokens_per_s={n_tok / wall_ms * 1e3:.1f}"
              f" (wall_ms={wall_ms:.1f}, prefill and protect included) "
              f"decode_tokens_per_s={VLM_BATCH / med * 1e3:.1f} "
              f"strikes_drawn={len(strikes)} injected={rep.injected} "
              f"corrected={rep.scrub_corrected} flagged="
              f"{rep.scrub_detected}{expect} sidecar_overhead="
              f"{rep.sidecar_overhead:.4f} peak_bytes={peak}")
    _path_launches("frontends_vlm_serve", SERVE_KERNELS, by_path)
    _vlm_paged_check(cfg, params, batch, by_path)


def frontends_campaign(dev, by_path: dict) -> None:
    """(d) The Fig. 2 campaign on hubert-xlarge whole (query: the cluster
    ids of AUDIO_BATCH x AUDIO_FRAMES frames) and llava at VLM_LAYERS
    layers (query: the greedy tokens of VLM_CAMPAIGN_BATCH x (2,880
    patches + CAMPAIGN_SEQ tokens)), after phase 7's determinism check:
    FAMILY_REGION_TRIALS single-error soft trials in each of
    FRONTEND_REGIONS, masked / incorrect / crash shares printed. Each
    config's launches are a path."""
    from repro_torch.core import Outcome, characterize, lm_eval_fn
    from repro_torch.data.synthetic import audio_batch, vlm_batch
    from repro_torch.kernels import _build
    from repro_torch.models import forward, init_params
    for arch in (AUDIO_ARCH, VLM_ARCH):
        cfg = _frontend_cfg(arch)
        params = init_params(cfg, seed=SEED, device=dev)
        batch = audio_batch(cfg, AUDIO_BATCH, AUDIO_FRAMES, SEED, device=dev) \
            if arch == AUDIO_ARCH else vlm_batch(
                cfg, VLM_CAMPAIGN_BATCH, cfg.n_patches + CAMPAIGN_SEQ, SEED,
                device=dev)
        ev = lm_eval_fn(cfg, batch, forward)
        name = f"frontends_campaign_{arch}"
        dom, _, unwrap = characterize._campaign_domain(params, "params")
        _check_query(name, ev, dom, unwrap)
        _build.reset_launches()
        for region in FRONTEND_REGIONS:
            res, ms = _timed(lambda: characterize.run_campaign(
                ev, dom, n_trials=FAMILY_REGION_TRIALS, seed=SEED,
                kinds=("soft",), region_filter=lambda r: r == region))
            n = len(res.trials)
            masked = sum(o in (Outcome.MASKED_OVERWRITE, Outcome.MASKED_LOGIC)
                         for _, _, o in res.trials)
            wrong = sum(o is Outcome.INCORRECT for _, _, o in res.trials)
            crash = sum(o is Outcome.CRASH for _, _, o in res.trials)
            paths = {p for p, _, _ in res.trials}
            if n != FAMILY_REGION_TRIALS or \
                    {dom.spec.by_path[p].region for p in paths} != {region}:
                raise AssertionError(f"{name}: {n} trials outside {region}")
            print(f"{name}: region={region} soft trials={n} masked="
                  f"{masked / n:.4f} incorrect={wrong / n:.4f} crash="
                  f"{crash / n:.4f} leaves struck={sorted(paths)} wall_s="
                  f"{ms / 1e3:.2f}")
        _path_launches(name, {"bitflip"}, by_path)
        del dom, params
        torch.cuda.empty_cache()


def run_frontends(dev, by_path: dict) -> None:
    """Phase 13 (a)-(d): each part runs, and the phase fails after the last
    if any part failed its checks."""
    print(f"frontends: {card_line()}")
    failed = []
    for part in (frontends_card_vs_cpu, frontends_audio, frontends_vlm,
                 frontends_campaign):
        try:
            part(dev, by_path)
        except AssertionError as e:
            print(f"FAILED {part.__name__}: {e}")
            failed.append(part.__name__)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 13 parts failed: {failed}")


# ------------------------------------ 14. the 72-405 B dense configs, llava
def _dense_large_tiny_run(cfg, device):
    """Tiny ``cfg`` on one device from one seed: (parameters, forward
    logits, FAMILY_DECODE_STEPS decode logits), results on the CPU."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.draws import Stream
    from repro_torch.models import decode_step, forward, init_cache, \
        init_params
    p = init_params(cfg, seed=SEED, device=device)
    batch = lm_batch(cfg, 2, FAMILY_TINY_TOKENS, SEED + 2, device=device)
    logits = forward(p, batch, cfg)[0]
    toks = Stream(SEED + 1, device).randint(cfg.vocab_size,
                                            (2, FAMILY_DECODE_STEPS))
    cache = init_cache(cfg, 2, FAMILY_DECODE_STEPS, device=device)
    dec = []
    for t in range(FAMILY_DECODE_STEPS):
        lg, cache = decode_step(p, toks[:, t], t, cache, cfg)
        dec.append(lg)
    return p, logits.cpu(), torch.stack(dec, 1).cpu()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, on the CPU."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / float(b.abs().max())


def dense_large_card_vs_cpu(dev, by_path: dict) -> None:
    """(a) Tiny qwen2-72b, nemotron-4-340b and llama3-405b in float32
    compute on the card and on the CPU from one seed: parameters equal bit
    for bit, ``forward`` logits and FAMILY_DECODE_STEPS ``decode_step``
    logits within DENSE_LARGE_TINY_REL x max|logit|; ``serve_batch`` on
    tiny qwen2-72b (QKV bias) under detect_recover with strikes, tokens
    and report equal; ``_moe_apply_local`` at DENSE_LARGE_MOE_GROUPS data
    groups on tiny granite-moe-3b-a800m, y and aux within
    DENSE_LARGE_TINY_REL."""
    import dataclasses
    from repro_torch.configs import get_tiny
    from repro_torch.core import DESIGN_POINTS, tree
    from repro_torch.draws import Stream
    from repro_torch.kernels import _build
    from repro_torch.sharding.mesh import AbstractMesh
    from repro_torch.models import init_params, mlp
    from repro_torch.runtime.serve_loop import serve_batch
    _build.reset_launches()
    bad = []
    for arch in DENSE_LARGE_TINY:
        cfg = get_tiny(arch).replace(compute_dtype="float32")
        card = _dense_large_tiny_run(cfg, dev)
        cpu = _dense_large_tiny_run(cfg, torch.device("cpu"))
        unequal = sum(
            not torch.equal(_bytes(a.cpu()), _bytes(b))
            for a, b in zip(tree.leaves(card[0]), tree.leaves(cpu[0])))
        lg, dec = _rel(card[1], cpu[1]), _rel(card[2], cpu[2])
        print(f"dense_large tiny {arch} card vs cpu (float32): unequal "
              f"parameter leaves={unequal} of {len(tree.leaves(cpu[0]))} "
              f"forward max|diff|/max|logit|={lg:.3g} decode "
              f"{FAMILY_DECODE_STEPS} steps max|diff|/max|logit|={dec:.3g}")
        if unequal or lg > DENSE_LARGE_TINY_REL or dec > DENSE_LARGE_TINY_REL:
            bad.append(arch)
    cfg = get_tiny("qwen2-72b").replace(compute_dtype="float32")
    policy = dataclasses.replace(DESIGN_POINTS["detect_recover"](),
                                 scrub_interval=4)
    runs = []
    for device in (dev, torch.device("cpu")):
        p = init_params(cfg, seed=SEED, device=device)
        prompts = Stream(SEED + 1, device).randint(cfg.vocab_size, (4, 16))
        toks, rep = serve_batch(cfg, p, prompts, 12, policy=policy,
                                error_rate_per_token=0.5, seed=SERVE_SEED)
        runs.append((toks.cpu(), rep))
    same = torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    print(f"dense_large tiny qwen2-72b serve_batch detect_recover card vs "
          f"cpu: tokens and report equal={same} report={runs[0][1]}")
    if not same or not runs[0][1].injected:
        bad.append("serve_batch")
    cfg = get_tiny("granite-moe-3b-a800m").replace(compute_dtype="float32")
    x = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    layer0 = [(d, tree.map_leaves(lambda t: t[0], init_params(
        cfg, seed=SEED, device=d)["blocks"]["moe"]))
        for d in (dev, torch.device("cpu"))]
    for g in DENSE_LARGE_MOE_GROUPS:
        mesh = AbstractMesh((g, 1), ("data", "model"))
        out = [mlp._moe_apply_local(p, x.to(d), cfg, mesh, "data")
               for d, p in layer0]
        y, aux = _rel(out[0][0], out[1][0]), abs(
            float(out[0][1]) - float(out[1][1])) / abs(float(out[1][1]))
        print(f"dense_large tiny _moe_apply_local granite g={g} card vs cpu:"
              f" y max|diff|/max|y|={y:.3g} aux rel diff={aux:.3g}")
        if y > DENSE_LARGE_TINY_REL or aux > DENSE_LARGE_TINY_REL:
            bad.append(f"moe g={g}")
    _path_launches("dense_large_tiny", {"parity_encode", "parity_check",
                                        "bitflip"}, by_path)
    if bad:
        raise AssertionError(f"dense_large tiny: card and CPU differ in "
                             f"{bad}")


def _dense_large_inputs(cfg, dev) -> dict:
    """DENSE_LARGE_BATCH prompts of DENSE_LARGE_PROMPT tokens; for the VLM
    its 2,880 patches before them (``vlm_batch``, as phase 13 composes
    it)."""
    from repro_torch.data.synthetic import vlm_batch
    from repro_torch.draws import Stream
    if cfg.family == "vlm":
        return vlm_batch(cfg, DENSE_LARGE_BATCH,
                         cfg.n_patches + DENSE_LARGE_PROMPT, SEED, device=dev)
    return {"tokens": Stream(SEED + 1, dev).randint(
        cfg.vocab_size, (DENSE_LARGE_BATCH, DENSE_LARGE_PROMPT))}


def _dense_large_decode(cfg, params_of, batch, fault=None):
    """The prefill (with the patches of a VLM), then DENSE_LARGE_NEW
    ``make_serve_step`` tokens, each from ``params_of()``; ``fault(t)``
    runs before step t. Returns (tokens, prefill ms, ms a token)."""
    from repro_torch.runtime.steps import make_serve_step
    serve = make_serve_step(cfg)
    if cfg.family == "vlm":
        token, cache, pos, prefill_ms = _vlm_prefill(
            cfg, params_of(), batch, DENSE_LARGE_NEW)
    else:
        (token, cache), prefill_ms = _timed(lambda: _prefilled(
            cfg, params_of(), batch["tokens"], DENSE_LARGE_NEW))
        pos = batch["tokens"].shape[1]
    out, tok_ms = [], []
    for t in range(DENSE_LARGE_NEW):
        if fault is not None:
            fault(t)
        out.append(token)
        (cache, token, pos), ms = _timed(
            lambda: serve(params_of(), cache, token, pos))
        tok_ms.append(ms)
    return torch.stack(out, 1), prefill_ms, tok_ms


class _ShardedFaults:
    """Phase 8's strike stream on a sharded domain's replica 0: one uniform
    a token, a strike with probability SERVE_ERROR_RATE on a protectable
    leaf drawn byte-weighted across the shards (as
    ``ShardedMemoryDomain.inject`` draws it) with the policy's error model,
    its plan kept; a scrub every DENSE_LARGE_SCRUB tokens after the
    first."""

    def __init__(self, sh):
        self.sh = sh
        self.rng = np.random.default_rng(SERVE_SEED + 1)
        self.specs = [ls for dom in sh.shards[0]
                      for ls in dom.spec.protectable]
        w = np.array([ls.nbytes for ls in self.specs], dtype=np.float64)
        self.w = w / w.sum()
        self.strikes, self.scrub_ms, self.scrub_steps = [], [], []
        self.corrected = self.flagged = 0

    def scrub(self, t: int) -> None:
        """One scrub of the domain after step ``t``'s strike, its counts
        added up."""
        (self.sh, rep), ms = _timed(self.sh.scrub)
        c, u = rep.totals()
        self.corrected += c
        self.flagged += u
        self.scrub_ms.append(ms)
        self.scrub_steps.append(t)

    def expected(self) -> tuple:
        """(corrected, flagged) that the scrubs so far must have counted:
        each word struck by one bit corrected once, at the first scrub
        after it; a word struck by two left as it is, so flagged again at
        every later scrub."""
        last = self.scrub_steps[-1]
        return (_secded_expected(self.strikes, last)[0],
                sum(_secded_expected(self.strikes, t)[1]
                    for t in self.scrub_steps))

    def undo_doubles(self) -> int:
        """Strikes the bits of every word struck by two back out (XOR is
        its own inverse), as a reload of those words would; returns how
        many words."""
        from repro_torch.core import InjectionPlan
        bits = {}
        for _, s, plan in self.strikes:
            for w, b in zip(plan.word_idx.tolist(), plan.bit_idx.tolist()):
                if w >= 0 and w * 64 + b < s.nbytes * 8:
                    bits.setdefault((s.path, w), []).append(b)
        doubles = [(k, b) for k, b in bits.items() if len(b) == 2]
        for (path, w), b in doubles:
            self.sh = self.sh.apply_plan(path, InjectionPlan(
                np.full(2, w, np.int32), np.array(b, np.int32), hard=False))
        return len(doubles)

    def __call__(self, t: int) -> None:
        from repro_torch.core import InjectionPlan
        em = self.sh.policy.error_model
        if self.rng.random() < SERVE_ERROR_RATE:
            s = self.specs[self.rng.choice(len(self.specs), p=self.w)]
            plan = InjectionPlan.sample(self.rng, s.rows * 256, 1, False,
                                        em.multi_bit_fraction,
                                        em.adjacent_fraction)
            self.sh = self.sh.apply_plan(s.path, plan)
            self.strikes.append((t, s, plan))
        if t > 0 and t % DENSE_LARGE_SCRUB == 0:
            self.scrub(t)


def _bf16_ulps(diff: float, top: float) -> float:
    """``diff`` in bf16 ulps at magnitude ``top`` (8 significant bits)."""
    return diff / 2.0 ** (np.floor(np.log2(top)) - 7)


def _dense_large_parity(params, arch: str, by_path: dict) -> None:
    """detect_recover over ``params`` as 1 replica x DENSE_LARGE_SHARDS:
    a single-bit strike on each of the two largest leaves flagged by the
    parity check, both reloaded from the clean copy (the untouched
    parameters) bit-exact, a second scrub clean."""
    from repro_torch.core import ShardedMemoryDomain, detect_recover, tree
    from repro_torch.examples._common import same_bits
    from repro_torch.kernels import _build
    _build.reset_launches()
    sh = ShardedMemoryDomain.protect(params, detect_recover(), n_replicas=1,
                                     n_shards=DENSE_LARGE_SHARDS)
    originals = dict(zip(sh.order, tree.leaves(params)))
    one, two = _largest(sh, 2)
    struck = sh.apply_plan(one, _plan(_words(sh, one) // 3, (11,)))
    struck = struck.apply_plan(two, _plan(_words(sh, two) // 2, (40,)))
    struck, rep = struck.scrub()
    flagged = rep.needs_recovery()
    healed, rec = struck.recover(rep, clean_copy=originals.__getitem__)
    del struck
    exact = same_bits(healed.state(0), params)
    _, rep2 = healed.scrub()
    del healed
    _path_launches(f"dense_large_{arch}_detect_recover", _sharded_need(sh),
                   by_path)
    print(f"dense_large {arch} detect_recover 1x{DENSE_LARGE_SHARDS}: "
          f"flagged={flagged} recovered="
          f"{[(e['path'], e['action']) for e in rec]} bit-exact={exact} "
          f"second_scrub={rep2.totals()}")
    if flagged != {0: {one: 1, two: 1}} or exact is not True or \
            [e["action"] for e in rec] != ["reload_clean_copy"] * 2 or \
            rep2.totals() != (0, 0):
        raise AssertionError(f"dense_large {arch} detect_recover: the "
                             "strikes were not flagged and reloaded")


def dense_large_full(dev, by_path: dict, arch: str, layers) -> None:
    """(b) ``arch`` at full width, ``layers`` of its layers (None: whole):
    decode held against ``forward`` within DENSE_LARGE_ULPS, and a planted
    fault (decode positions shifted by DENSE_LARGE_PLANTED_SHIFT) beyond
    it; a clean run of DENSE_LARGE_NEW tokens after a prefill of
    DENSE_LARGE_BATCH x DENSE_LARGE_PROMPT (plus the VLM's patches); for
    the VLM the detect_recover drill; then the parameters under
    typical_server as 1 replica x DENSE_LARGE_SHARDS: a single-bit strike
    corrected and a double-bit strike flagged, one warm scrub's time and
    peak, and the same decode from ``state(0)`` under phase 8's strike
    stream with a scrub every DENSE_LARGE_SCRUB tokens and one after the
    last (every single-bit strike corrected, every double-bit one
    flagged), its tokens beside the clean run's. After that scrub, with
    the double-struck words struck back, the payload must equal the
    parameters made again from the seed bit for bit, and a decode from it
    must give the clean run's tokens: the tokens of the struck run may
    differ only where a step read a strike before the scrub after it."""
    from repro_torch.configs import get_config
    from repro_torch.core import ShardedMemoryDomain, tree, typical_server
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    whole = get_config(arch)
    cfg = whole if layers is None else whole.replace(n_layers=layers)
    params, init_ms = _timed(lambda: init_params(cfg, seed=SEED, device=dev))
    n_params = sum(t.numel() for t in tree.leaves(params))
    payload = _leaf_bytes(params)
    whole_bytes = _leaf_bytes(init_params(whole, device="meta"))
    if layers is not None:
        print(f"reduced: {arch} n_layers {whole.n_layers}->{layers} (whole "
              f"it is {_gb(whole_bytes)} of {whole.param_dtype} "
              f"parameters; width unchanged)")
    batch = _dense_large_inputs(cfg, dev)
    S0 = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm"
                                     else 0)
    print(f"dense_large {arch}: family={cfg.family} layers={cfg.n_layers} "
          f"of {whole.n_layers} d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} vocab={cfg.vocab_size} "
          f"act={cfg.act} qkv_bias={cfg.qkv_bias} params={n_params} bytes="
          f"{payload} ({cfg.param_dtype}) init_ms={init_ms:.1f} batch="
          f"{DENSE_LARGE_BATCH} prefill={S0} positions new="
          f"{DENSE_LARGE_NEW}")
    check = _vlm_decode_check if cfg.family == "vlm" else \
        (lambda c, p, b, name, shift=0: _check_decode_logits(
            c, p, b["tokens"], name, shift))
    diff, top = check(cfg, params, batch, name=f"dense_large {arch}")
    planted, _ = check(cfg, params, batch, f"dense_large {arch} planted "
                       f"fault (shift {DENSE_LARGE_PLANTED_SHIFT})",
                       shift=DENSE_LARGE_PLANTED_SHIFT)
    ulps, planted_ulps = _bf16_ulps(diff, top), _bf16_ulps(planted, top)
    print(f"dense_large {arch} decode vs forward: {ulps:.2f} bf16 ulps at "
          f"max|logit| {top:.4g} (limit {DENSE_LARGE_ULPS}); planted fault "
          f"{planted_ulps:.2f}")
    if ulps > DENSE_LARGE_ULPS or planted_ulps <= DENSE_LARGE_ULPS:
        raise AssertionError(f"dense_large {arch}: decode is {ulps:.1f} "
                             f"bf16 ulps from forward, the planted fault "
                             f"{planted_ulps:.1f}; the limit "
                             f"{DENSE_LARGE_ULPS} must lie between")
    clean, _, clean_ms = _dense_large_decode(cfg, lambda: params, batch)
    if cfg.family == "vlm":
        _dense_large_parity(params, arch, by_path)
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sh, protect_ms = _timed(lambda: ShardedMemoryDomain.protect(
        params, typical_server(), n_replicas=1,
        n_shards=DENSE_LARGE_SHARDS))
    del params            # the domain holds the only copy from here
    # the drill strikes the two largest layer leaves: a struck copy of
    # nemotron's 9.44 GB embedding or head would not fit beside the scrub
    one, two = [p for p in _largest(sh, len(sh.order))
                if p.startswith("blocks/")][:2]
    struck = sh.apply_plan(one, _plan(_words(sh, one) // 3, (11,)))
    struck = struck.apply_plan(two, _plan(_words(sh, two) // 2, (20, 21)))
    fixed, rep = struck.scrub()
    del struck, fixed
    corr, unc = _counts(rep.domain_report())
    drill = (corr[one] == 1 and sum(corr.values()) == 1
             and unc[two] == 1 and sum(unc.values()) == 1)
    del rep
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, scrub_ms = _timed(sh.scrub)
    scrub_peak = torch.cuda.max_memory_allocated()
    del out
    print(f"dense_large {arch} typical_server 1x{DENSE_LARGE_SHARDS}: "
          f"protect_ms={protect_ms:.1f} per-shard bytes="
          f"{[_gb(x) for x in _shard_loads(sh)]} single-bit on {one} "
          f"corrected={corr[one]} double-bit on {two} flagged={unc[two]} "
          f"warm_scrub_ms={scrub_ms:.1f} resident={resident} "
          f"scrub_peak_bytes={scrub_peak} ({_gb(scrub_peak)})")
    faults = _ShardedFaults(sh)
    del sh
    torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.perf_counter()
    toks, prefill_ms, tok_ms = _dense_large_decode(
        cfg, lambda: faults.sh.state(0), batch, faults)
    wall_ms = (time.perf_counter() - t0) * 1e3
    serve_peak = torch.cuda.max_memory_allocated()
    faults.scrub(DENSE_LARGE_NEW)      # the strikes after the last step's
    single, double = faults.expected()
    undone = faults.undo_doubles()
    again = init_params(cfg, seed=SEED, device=dev)
    unequal = [p for p, t in zip(faults.sh.order, tree.leaves(again))
               if not torch.equal(_bytes(faults.sh.leaf(p)), _bytes(t))]
    del again
    torch.cuda.empty_cache()
    redo = _dense_large_decode(cfg, lambda: faults.sh.state(0), batch)[0]
    redo_equal = bool(torch.equal(redo, clean))
    first_strike = min(t for t, _, _ in faults.strikes) \
        if faults.strikes else DENSE_LARGE_NEW
    same = (toks == clean).all(0)
    first_diff = int((~same).nonzero()[0]) if not bool(same.all()) \
        else None
    med = float(np.median(tok_ms))
    n_tok = DENSE_LARGE_BATCH * DENSE_LARGE_NEW
    _path_launches(f"dense_large_{arch}_typical_server",
                   _sharded_need(faults.sh), by_path)
    print(f"dense_large {arch} serve typical_server: prefill_ms="
          f"{prefill_ms:.2f} ({DENSE_LARGE_BATCH}x{S0} positions) "
          f"ms_per_token_median={med:.3f} (min {min(tok_ms):.3f} max "
          f"{max(tok_ms):.3f}; clean run {float(np.median(clean_ms)):.3f}) "
          f"tokens_per_s={n_tok / wall_ms * 1e3:.1f} (wall_ms={wall_ms:.1f},"
          f" prefill, strikes and scrubs included) decode_tokens_per_s="
          f"{DENSE_LARGE_BATCH / med * 1e3:.1f} strikes={len(faults.strikes)}"
          f" corrected={faults.corrected} flagged={faults.flagged} "
          f"(expected {single} and {double} over the scrubs after steps "
          f"{faults.scrub_steps}) scrub_ms_median="
          f"{float(np.median(faults.scrub_ms)):.1f} first_strike_step="
          f"{first_strike} tokens_equal_clean={first_diff is None} "
          f"first_differing_step={first_diff} serve_peak_bytes={serve_peak}"
          f" ({_gb(serve_peak)})")
    print(f"dense_large {arch} after the last scrub ({undone} double-struck "
          f"words struck back): payload bit-equal to the parameters made "
          f"again from the seed={not unequal} (unequal leaves {unequal}); "
          f"decode from it equals the clean run's tokens={redo_equal}")
    if not drill:
        raise AssertionError(f"dense_large {arch}: corrected {corr}, "
                             f"flagged {unc}")
    if (faults.corrected, faults.flagged) != (single, double) or \
            not faults.strikes:
        raise AssertionError(f"dense_large {arch}: corrected "
                             f"{faults.corrected} flagged {faults.flagged}, "
                             f"expected {single} and {double}")
    if first_diff is not None and first_diff <= first_strike:
        raise AssertionError(f"dense_large {arch}: tokens differ from the "
                             f"clean run at step {first_diff}, before the "
                             f"first strike (step {first_strike})")
    if unequal or not redo_equal:
        raise AssertionError(f"dense_large {arch}: after the last scrub the"
                             f" payload differs in {unequal} or its decode "
                             "from the clean run's tokens")
    if toks.shape != (DENSE_LARGE_BATCH, DENSE_LARGE_NEW) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"dense_large {arch}: tokens "
                             f"{tuple(toks.shape)} out of range")


def dense_large_placements(dev, by_path: dict) -> None:
    """(c) Host only, nothing allocated: each registry config at its full
    size from ``meta`` shapes, on ``AbstractMesh`` SINGLE_POD and
    MULTI_POD, with FSDP and with ``tp_only``: one device's share of the
    parameters (``param_shardings``; every spec divides its dim, so every
    device holds as much) and of the parameters plus the AdamW moments
    (``opt_shardings``, in the config's moment dtype), beside this card's
    memory."""
    from repro_torch.configs import MULTI_POD, SINGLE_POD, get_config, \
        list_archs
    from repro_torch.core import tree
    from repro_torch.sharding.mesh import AbstractMesh
    from repro_torch.models import init_params
    from repro_torch.models.common import dtype_of
    from repro_torch.sharding import rules
    cap = torch.cuda.get_device_properties(0).total_memory
    print(f"dense_large placements (per device; card memory {cap} bytes)")

    def per_device(shardings, leaves, itemsize=None) -> int:
        return sum(int(np.prod(s.shard_shape(tuple(t.shape))))
                   * (itemsize or t.element_size())
                   for s, t in zip(tree.leaves(shardings), leaves))
    for arch in list_archs():
        cfg = get_config(arch)
        p = init_params(cfg, device="meta")
        leaves = tree.leaves(p)
        msize = dtype_of(cfg.moment_dtype).itemsize
        for name, mc in (("SINGLE_POD", SINGLE_POD), ("MULTI_POD", MULTI_POD)):
            mesh = AbstractMesh(mc.shape, mc.axes)
            moments = 2 * per_device(rules.opt_shardings(None, p, mesh, cfg)
                                     ["m"], leaves, msize)
            cols = []
            for layout, tp_only in (("fsdp", False), ("tp_only", True)):
                pb = per_device(rules.param_shardings(p, mesh, cfg,
                                                      tp_only=tp_only), leaves)
                cols.append(f"{layout} params={_gb(pb)} (fits: {pb <= cap})"
                            f" +moments={_gb(pb + moments)} (fits: "
                            f"{pb + moments <= cap})")
            print(f"placement {arch} {name} (whole {_gb(_leaf_bytes(p))}, "
                  f"{cfg.param_dtype}; moments {cfg.moment_dtype}) per "
                  f"device: " + "; ".join(cols))


def run_dense_large(dev, by_path: dict) -> None:
    """Phase 14 (a)-(c): each part runs, and the phase fails after the
    last if any part failed its checks."""
    print(f"dense_large: {card_line()}")
    parts = [(dense_large_card_vs_cpu, ())] + \
        [(dense_large_full, cut) for cut in DENSE_LARGE] + \
        [(dense_large_placements, ())]
    failed = []
    for fn, args in parts:
        t = time.perf_counter()
        try:
            fn(dev, by_path, *args)
        except AssertionError as e:
            print(f"FAILED {fn.__name__}{args}: {e}")
            failed.append(f"{fn.__name__}{args}")
        torch.cuda.empty_cache()
        print(f"dense_large part {fn.__name__}{args}: wall_s="
              f"{time.perf_counter() - t:.1f}")
    if failed:
        raise AssertionError(f"phase 14 parts failed: {failed}")


# ------------------------------------------------ 15. the last slice
_DRYRUN_CELL = """
import json, sys, time
t = time.perf_counter()
from repro_torch.launch import dryrun
rec = dryrun.lower_cell(sys.argv[1], sys.argv[2], multi_pod=False)
rec["wall_s"] = round(time.perf_counter() - t, 1)
rec.pop("trace", None)
print(json.dumps(rec))
"""


def _start_dryruns() -> list:
    """(c) starts each DRYRUN_CELLS cell in a host process of its own, the
    card hidden from it: the cells take a minute of host CPU each and run
    beside (a) and (b)."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"), CUDA_VISIBLE_DEVICES="")
    return [(arch, shape, subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CELL, arch, shape], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for arch, shape in DRYRUN_CELLS]


def _legacy_policies() -> dict:
    from repro_torch.core import DESIGN_POINTS, HRMPolicy, Tier
    return {"typical_server": DESIGN_POINTS["typical_server"](),
            "detect_recover_l": DESIGN_POINTS["detect_recover_l"](),
            "dected_burst": HRMPolicy("dected_burst", {
                "params/embed": Tier.BURST, "params/attn": Tier.DECTED,
                "params/mlp": Tier.DECTED, "params/norm": Tier.SECDED})}


class _PlainOps:
    """``kernels.ops``' word functions swapped for their plain versions for
    the length of a ``with``: the legacy shims run through them on the
    card's tensors and launch no kernel."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels.bch import bch_scrub_plain
        from repro_torch.kernels.burst import (burst_encode_plain,
                                               burst_scrub_plain)
        from repro_torch.kernels.dected import DECTED_CODE
        from repro_torch.kernels.parity import parity_check_plain
        from repro_torch.kernels.secded import secded_scrub_plain
        plain = {
            "secded_encode_words": ref.secded_encode_ref,
            "secded_scrub_words": secded_scrub_plain,
            "dected_encode_words": lambda w: ref.bch_encode_ref(
                w, DECTED_CODE),
            "dected_scrub_words": lambda w, e: bch_scrub_plain(
                w, e, DECTED_CODE),
            "burst_encode_words": burst_encode_plain,
            "burst_scrub_words": burst_scrub_plain,
            "parity_encode_words": ref.parity_encode_ref,
            "parity_check_words": parity_check_plain,
            "bitflip_words_": _plain_bitflip}
        self.saved = {k: getattr(ops, k) for k in plain}
        for k, fn in plain.items():
            setattr(ops, k, fn)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import ops
        for k, fn in self.saved.items():
            setattr(ops, k, fn)


def _legacy_need(sidecar) -> set:
    need = {"bitflip"}
    for entry in sidecar.values():
        need |= {"secded": {"secded_encode", "secded_scrub"},
                 "dected": {"bch_encode", "bch_scrub"},
                 "burst": {"burst_encode", "burst_scrub"},
                 "parity_r": {"parity_encode", "parity_check"},
                 "mirror": {"parity_encode", "parity_check"}}[entry["tier"]]
    return need


def _legacy_run(params, policy, stride: int) -> dict:
    """One pass of the legacy per-leaf API over ``params``: the sidecar, a
    single-bit hard strike into every leaf from the Injector's seed, the
    scrub, a Scrubber over ``stride`` passes of the struck state, and the
    RecoveryManager's reloads from the clean parameters."""
    import warnings
    from repro_torch.core import (Injector, RecoveryManager, Scrubber,
                                  build_sidecar, scrub)
    from repro_torch.core.sidecar import leaf_index
    clean = {p: e["leaf"] for p, e in leaf_index(params).items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sc = build_sidecar(params, policy)
        inj = Injector.seeded(SEED)
        bad = params
        for path in clean:
            bad = inj.sample_into(bad, path, hard=True,
                                  multi_bit_fraction=0.0)
        fixed, sc2, rep = scrub(bad, sc, policy)
        scr = Scrubber(policy, dict(sc), stride=stride)
        state = bad
        for _ in range(stride):
            state, _ = scr.scrub_now(state)
        rm = RecoveryManager(clean.__getitem__)
        healed = rm.respond(fixed, rep, Scrubber(policy, dict(sc2)))
    _sync()
    return {"sidecar": sc, "report": rep, "fixed": fixed,
            "healed": healed, "passes": scr.history, "events": rm.events,
            "plans": [(e.path, e.plan) for e in inj.live],
            "stride_state": state}


def _same_sidecars(a, b) -> bool:
    return list(a) == list(b) and all(
        a[p]["tier"] == b[p]["tier"] and all(
            torch.equal(_bytes(a[p][k]), _bytes(b[p][k]))
            for k in a[p] if k != "tier") for p in a)


def legacy_shims(dev, by_path: dict) -> None:
    """(a) the legacy per-leaf API at llama3-8b's full width with
    LEGACY_LAYERS of its layers, under each of _legacy_policies: the
    kernels' run held against the same shims on the plain versions (the
    card's tensors, no launch) and against ``MemoryDomain``'s verbs on the
    same strikes; then the per-leaf scrub's wall time beside the domain's
    tier-batched scrub."""
    import warnings
    from repro_torch.configs import get_config
    from repro_torch.core import MemoryDomain, scrub
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    cfg = get_config("llama3-8b").replace(n_layers=LEGACY_LAYERS)
    params = init_params(cfg, seed=SEED, device=dev)
    n = sum(t.numel() for t in _leaves(params))
    print(f"legacy model: llama3-8b width, {LEGACY_LAYERS} of 32 layers, "
          f"params={n} ({cfg.param_dtype}) bytes={_leaf_bytes(params)}")
    for name, policy in _legacy_policies().items():
        for stride in LEGACY_STRIDES:
            _build.reset_launches()
            got = _legacy_run(params, policy, stride)
            if stride == LEGACY_STRIDES[0]:
                _path_launches(f"legacy_{name}", _legacy_need(
                    got["sidecar"]), by_path)
            else:
                by_path[f"legacy_{name}"] = {
                    k: v + by_path[f"legacy_{name}"][k]
                    for k, v in _build.LAUNCHES.items()}
            launched = dict(_build.LAUNCHES)
            with _PlainOps():
                plain = _legacy_run(params, policy, stride)
            if dict(_build.LAUNCHES) != launched:
                raise AssertionError("the plain run launched a kernel")
            same = (_same_sidecars(got["sidecar"], plain["sidecar"])
                    and _counts(got["report"]) == _counts(plain["report"])
                    and _same_bytes(got["fixed"], plain["fixed"])
                    and _same_bytes(got["healed"], plain["healed"])
                    and _same_bytes(got["stride_state"],
                                    plain["stride_state"])
                    and got["passes"] == plain["passes"]
                    and got["events"] == plain["events"])
            dom = MemoryDomain.protect(params, policy)
            for path, plan in got["plans"]:
                dom = dom.apply_plan(path, plan)
            dom, drep = dom.scrub()
            as_domain = _counts(drep) == _counts(got["report"]) and all(
                torch.equal(_bytes(dom.leaf(p)), _bytes(leaf))
                for p, leaf in _flat_paths(got["fixed"]).items())
            healed = _same_bytes(got["healed"], params)
            corr, unc = got["report"].totals()
            print(f"legacy {name} stride={stride}: strikes="
                  f"{len(got['plans'])} corrected={corr} detected={unc} "
                  f"reloaded={len(got['events'])} passes={got['passes']} "
                  f"card==plain: {same} same corrections as MemoryDomain: "
                  f"{as_domain} restored bit-exact: {healed}")
            if not (same and as_domain and healed):
                raise AssertionError(f"legacy {name} stride={stride} failed")
            del got, plain, dom
        sc = _legacy_run(params, policy, 1)["sidecar"]
        dom = MemoryDomain.protect(params, policy)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            leaf_ms = _median_ms(lambda: scrub(params, sc, policy))
        dom_ms = _median_ms(dom.scrub)
        print(f"legacy {name} scrub wall ms: per-leaf={leaf_ms:.2f} "
              f"({len(sc)} leaves, a launch per leaf) tier-batched "
              f"MemoryDomain={dom_ms:.2f} ({len(dom.spec.groups)} tiers, a "
              f"launch per tier) ratio={leaf_ms / dom_ms:.2f} "
              f"({card_line()})")
        del sc, dom
        torch.cuda.empty_cache()


def _leaves(t) -> list:
    from repro_torch.core import tree
    return tree.leaves(t)


def _flat_paths(t) -> dict:
    from repro_torch.core import tree
    return {"/".join(p): x for p, x in tree.flatten_with_path(t)[0]}


def elastic_one_card(dev, by_path: dict) -> None:
    """(b) lm-100m's train state through the hardened store onto a (1, 1)
    CUDA mesh: two snapshots (the staging scrub on the parity kernels),
    the newest struck on disk, ``load(shardings=state_shardings(...))``
    falling back to the older one and placing it as DTensors, and one
    ``relower_train_step`` step bit-equal to the unsharded step from the
    same snapshot, under deterministic algorithms."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import _build
    from repro_torch.runtime.elastic import (relower_train_step,
                                             state_shardings)
    from repro_torch.runtime.steps import make_train_step
    cfg, tcfg, state = _lm100m(dev)
    step = make_train_step(cfg, tcfg)
    batch = lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED, device=dev)
    newer, _ = step(state, batch)
    with tempfile.TemporaryDirectory() as d:
        _build.reset_launches()
        store = CheckpointStore(Path(d) / "ck", device=dev)
        store.save(1, state)
        store.save(2, newer)
        _path_launches("elastic_store", STAGING_KERNELS, by_path)
        _flip_byte(Path(d) / "ck" / "step_00000002" / "data.npz")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{d}/pg", rank=0, world_size=1)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            mesh = init_device_mesh(dev.type, (1, 1),
                                    mesh_dim_names=("data", "model"))
            placed, load_ms = _timed(lambda: store.load(
                2, state, shardings=state_shardings(state, mesh, cfg)))
            fell_back = store.last_loaded_step
            on_mesh = all(isinstance(t, DTensor) and t.device_mesh == mesh
                          for t in _leaves(placed))
            local = _flat_paths(placed)
            exact = all(torch.equal(_bytes(local[p].to_local()), _bytes(t))
                        for p, t in _flat_paths(state).items())
            run = relower_train_step(step, placed, batch, mesh, cfg)
            (got, m), sharded_ms = _timed(lambda: run(placed, batch))
            (want, wm), plain_ms = _timed(lambda: step(state, batch))
            got_local = {p: t.to_local() for p, t in
                         _flat_paths(got).items()}
            same = all(torch.equal(_bytes(got_local[p]), _bytes(t))
                       for p, t in _flat_paths(want).items()) \
                and float(m["loss"]) == float(wm["loss"])
        finally:
            torch.use_deterministic_algorithms(False)
            dist.destroy_process_group()
    print(f"elastic (1, 1) mesh on one card: load(shardings=) fell back to "
          f"step {fell_back}, placed as DTensors: {on_mesh}, bytes equal: "
          f"{exact}, load_ms={load_ms:.1f}; relowered step loss="
          f"{float(m['loss']):.6f} bit-equal to the unsharded step: {same} "
          f"(step_ms sharded={sharded_ms:.1f} unsharded={plain_ms:.1f})")
    if fell_back != 1 or not (on_mesh and exact and same):
        raise AssertionError("elastic on one card failed")
    n = torch.cuda.device_count()
    if n >= 2:
        from repro_torch.examples import elastic_reshard
        ranks = n - n % 2
        with tempfile.TemporaryDirectory() as d:
            res = elastic_reshard.run(ranks, "cuda", str(Path(d) / "e.npz"))
        print(f"elastic reshard between meshes on {ranks} cards: losses "
              f"{res['losses'].tolist()} unsharded "
              f"{res['plain_losses'].tolist()} misplaced blocks "
              f"{int(res['mismatches'])}")
        if int(res["mismatches"]) or not np.allclose(
                res["losses"], res["plain_losses"],
                rtol=elastic_reshard.LOSS_RTOL, atol=0):
            raise AssertionError("the reshard drill failed on the cards")
    else:
        print("elastic reshard between meshes: held on 8 CPU gloo ranks by "
              "tests/test_torch_elastic.py; one card visible")


def dryrun_cells(procs: list) -> None:
    """(c) the DRYRUN_CELLS records from their host processes: per-device
    FLOPs beside the model FLOPs, the collective link bytes by kind, and
    the roofline terms on this card's published rates."""
    from repro_torch.launch import step_cost
    card = card_line()
    bad = []
    for arch, shape, proc in procs:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
        if proc.returncode:
            print(err[-2000:], file=sys.stderr)
            bad.append(f"{arch}|{shape}")
            continue
        rec = json.loads(out.strip().splitlines()[-1])
        hlo, roof = rec["hlo"], rec["roofline"]
        n = rec["n_devices"]
        print(f"dryrun {arch} {shape} {rec['mesh']}: status={rec['status']} "
              f"flops/dev={hlo['flops']:.6e} model_flops/dev="
              f"{rec['model_flops_global'] / n:.6e} (global "
              f"{rec['model_flops_global']:.6e}) hbm_bytes/dev="
              f"{hlo['hbm_bytes']:.6e} (analytic floor "
              f"{rec['analytic_bytes_per_device']:.6e}) coll_link_bytes="
              f"{json.dumps(hlo['coll_link_bytes'])} wall_s={rec['wall_s']}")
        print(f"dryrun {arch} {shape} roofline on {card} (H100 SXM data "
              f"sheet: {step_cost.PEAK_FLOPS:.3e} FLOP/s bf16, "
              f"{step_cost.HBM_BW:.3e} B/s HBM, {step_cost.LINK_BW:.3e} B/s "
              f"NVLink a direction): compute_s={roof['compute_s']:.6f} "
              f"memory_s={roof['memory_s']:.6f} collective_s="
              f"{roof['collective_s']:.6f} dominant={roof['dominant']}")
        if rec["status"] != "ok" or not hlo["flops"] > 0:
            bad.append(f"{arch}|{shape}")
    if bad:
        raise AssertionError(f"dry-run cells failed: {bad}")


def run_last_slice(dev, by_path: dict) -> None:
    """Phase 15 (a)-(c): the dry-run processes start first and run on the
    host beside (a) and (b); every process is stopped before the phase
    ends, and the phase fails after the last part if any part failed."""
    print(f"last slice: {card_line()}")
    procs = _start_dryruns()
    failed = []
    try:
        for fn, args in ((legacy_shims, (dev, by_path)),
                         (elastic_one_card, (dev, by_path)),
                         (dryrun_cells, (procs,))):
            t = time.perf_counter()
            try:
                fn(*args)
            except AssertionError as e:
                print(f"FAILED {fn.__name__}: {e}")
                failed.append(fn.__name__)
            torch.cuda.empty_cache()
            print(f"last slice part {fn.__name__}: wall_s="
                  f"{time.perf_counter() - t:.1f}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError(f"phase 15 parts failed: {failed}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside the repository)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        _sync()
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    phase("1_build", build)
    checks = phase("2_check", check_kernels, dev)
    checks.update(phase("2_check_strong", check_strong_kernels, dev))
    phase("2_sweeps", conformance_sweeps, dev)
    state = phase("3_model", model_state, dev)
    phase("3c_draws", check_draws, dev)
    by_path = phase("3_main_path", run_main_path, state)
    full = phase("3b_main_shapes", check_main_shapes, state, dev)
    phase("3b_profile", profile_scrub, state)
    times = phase("4_times", time_kernels, state)
    paged = phase("4_paged_attn", time_paged_attn, dev)
    phase("5_rates_fig5", measured_fig5, dev)
    checks.update(phase("6_graph_check", check_graph_kernels, dev))
    graph = phase("6_graph_build", graph_build, dev)
    full.update(phase("6_graph_main_shapes", check_graph_main_shapes,
                      *graph))
    phase("6_graph_paths", run_graph_paths, *graph, by_path)
    times.update(phase("6_graph_times", time_graph, *graph))
    phase("7_campaign_lm", campaign_lm, state["params"], by_path)
    phase("7_campaign_kvstore", campaign_kvstore, dev, by_path)
    phase("7_campaign_graph", campaign_graph, *graph[:2], by_path)
    del graph
    phase("7_explore", run_explore, by_path)
    phase("7_trace", run_trace, dev, by_path)
    phase("7_kvstore_card_vs_cpu", kvstore_card_vs_cpu, dev)
    phase("8_serve", run_serve, state["params"], dev, by_path)
    phase("10_online", run_online, state["params"], dev, by_path)
    phase("9_train", run_train, dev, by_path)
    # phase 11 holds llama3-8b's full 16 GB parameters: phase 3's state goes
    del state
    torch.cuda.empty_cache()
    phase("11_sharded", run_sharded, dev, by_path)
    phase("11_examples", run_examples, dev, by_path)
    phase("12_families", run_families, dev, by_path)
    phase("13_frontends", run_frontends, dev, by_path)
    phase("14_dense_large", run_dense_large, dev, by_path)
    phase("15_last_slice", run_last_slice, dev, by_path)
    print(f"phase_s={json.dumps(phase_s)}")
    print(f"peak_memory_bytes_run={torch.cuda.max_memory_allocated()}")
    print(f"wall_s={time.perf_counter() - t0:.1f}")
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(n[name] for n in by_path.values()),
         "launches_by_path": {p: n[name] for p, n in by_path.items()},
         "max_abs_err": float(max(checks[name]["max_abs_err"],
                                  full[name]["max_abs_err"])),
         "mismatches": checks[name]["mismatches"] + full[name]["mismatches"],
         "words_checked": checks[name]["words"] + full[name]["words"],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "ops_bound_ms": times[name]["ops_bound_ms"],
         "library_ms": times[name].get("library_ms")}
        for name, (src, rep) in KERNELS.items()] + [
        {"name": "paged_attn_decode", "route": "cuda",
         "source": CSRC + "paged_attn.cu", "replaces": None,
         "launches": sum(n.get("paged_attn_decode", 0)
                         for n in by_path.values()),
         "launches_by_path": {p: n.get("paged_attn_decode", 0)
                              for p, n in by_path.items()},
         "max_abs_err": paged["max_abs_err"],
         "mismatches": paged["mismatches"],
         "outputs_checked": paged["outputs"],
         "positions_read": paged["positions"], "ms": paged["ms"],
         "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
         "bound_by": "bytes", "ops_bound_ms": None, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
