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
   the popcount rate) and its plain version's time;
5. measures the per-tier outcome rates (``core.eccmeasure``) of PARITY_R,
   SECDED, DECTED, BURST and MIRROR through the kernels, holds them equal
   to the same measurement on the CPU (the plain versions), and prints the
   Fig. 5 cost and availability rows with them.

Its last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON: ``launches`` sums the seven paths' counts, which
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
}


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


def _path_launches(name: str, dom, by_path: dict) -> None:
    """Record the launches of path ``name`` (counted since its reset) and
    fail if it skipped a kernel its tiers need."""
    from repro_torch.kernels import _build
    by_path[name] = dict(_build.LAUNCHES)
    missing = sorted(k for k in _needed_kernels(dom) if not by_path[name][k])
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
        _path_launches(name, dom, by_path)
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
    _path_launches("hard_drill", dom, by_path)
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
    from repro_torch.core.domain import _gather_packed
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitflip import bitflip_words_
    from repro_torch.kernels.parity import (parity_check_plain,
                                            parity_check_words)
    codecs = _ecc_codecs()
    out = {k: {"words": 0, "mismatches": 0, "max_abs_err": 0}
           for k in KERNELS}

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
            words = _gather_packed(leaves, sel, rows)
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
    from repro_torch.core.domain import _gather_packed
    dom = MemoryDomain.protect(state, DESIGN_POINTS[design]())
    rows, sel = dom.spec.groups[tier]
    return _gather_packed(dom._leaves(), sel, rows), dom.sidecar[tier.value]


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
        print(f"time {name}: rows={r} words={r * 256} ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bytes_ms:.4f} "
              f"(bytes={nbytes}) ops_bound_ms={ops_ms:.4f} "
              f"(popcounts={popc}) of_bound={bytes_ms / ms:.3f} "
              f"of_ops_bound={ops_ms / ms:.3f}"
              + (f" strikes={e} hits={hits}" if name == "bitflip" else ""))
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
         "library_ms": None}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
