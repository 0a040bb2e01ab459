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
   replayed from a CUDA graph);
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
   overhead.

Its last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON: ``launches`` sums the main paths' counts, which
``launches_by_path`` lists. Any failure raises.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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


def _path_launches(name: str, need: set, by_path: dict) -> None:
    """Record the launches of path ``name`` (counted since its reset) and
    fail if it skipped a kernel of ``need``."""
    from repro_torch.kernels import _build
    by_path[name] = dict(_build.LAUNCHES)
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
        "library_ms": None, "bytes": n_pad * 24, "ops": n_pad}
    for name, rec in out.items():
        rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
        rec["ops_bound_ms"] = None
        lib = rec["library_ms"]
        print(f"time {name}: ms={rec['ms']:.4f} plain_ms="
              f"{rec['plain_ms']:.3f} library_ms="
              f"{'null' if lib is None else f'{lib:.4f}'} bound_ms="
              f"{rec['bound_ms']:.4f} (bytes={rec['bytes']}) ops="
              f"{rec['ops']} of_bound={rec['bound_ms'] / rec['ms']:.3f}")
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
    by_path = phase("3_main_path", run_main_path, state)
    full = phase("3b_main_shapes", check_main_shapes, state, dev)
    phase("3b_profile", profile_scrub, state)
    times = phase("4_times", time_kernels, state)
    phase("5_rates_fig5", measured_fig5, dev)
    checks.update(phase("6_graph_check", check_graph_kernels, dev))
    graph = phase("6_graph_build", graph_build, dev)
    full.update(phase("6_graph_main_shapes", check_graph_main_shapes,
                      *graph))
    phase("6_graph_paths", run_graph_paths, *graph, by_path)
    times.update(phase("6_graph_times", time_graph, *graph))
    del graph
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
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
