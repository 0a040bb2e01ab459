#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for ``sm_90a``) and
``nvcc``; it exits non-zero, printing no result, without them. In order:

1. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, bit for
   bit, on 8 Mi random words with single- and double-bit strikes;
3. drives the ``MemoryDomain`` main path (protect, inject, scrub, recover)
   at llama3-8b's full width with its depth cut to 8 layers, plus a KV
   cache, under the paper's design points, and a hard-error retirement
   drill; checks the restored payload bit for bit, and that each of these
   five paths, its launches counted on their own, ran every kernel its
   tiers need;
3b. holds each kernel against its plain version, bit for bit, on every
   tier buffer those design points build (up to 6.66 GB), struck with
   single-, double- and check-bit errors; then profiles one warm scrub per
   tier mix;
4. times each kernel at the main path's full tier-buffer shape with CUDA
   events, beside its memory bound and its plain version's time.

Its last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON: ``launches`` sums the five paths' counts, which
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
SEED = 0
CHECK_ROWS = 32768             # 8 Mi words per kernel check
N_LAYERS = 8                   # of llama3-8b's 32: the depth driven here
KV_BATCH, KV_SEQ = 8, 4096
STRIKES = 64
DESIGN_POINTS_RUN = ("typical_server", "detect_recover", "detect_recover_l",
                     "mirror_dr_l")
CSRC = "src/repro_torch/kernels/csrc/"
# kernel -> (source, Pallas call it replaces)
KERNELS = {
    "secded_encode": (CSRC + "secded.cu", "src/repro/kernels/secded.py:87"),
    "secded_scrub": (CSRC + "secded.cu", "src/repro/kernels/secded.py:111"),
    "parity_encode": (CSRC + "parity.cu", "src/repro/kernels/parity.py:52"),
    "parity_check": (CSRC + "parity.cu", "src/repro/kernels/parity.py:71"),
    "bitflip": (CSRC + "bitflip.cu", "src/repro/kernels/bitflip.py:57"),
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
    clean_np = rng.integers(0, 2**64, size=n, dtype=np.uint64)
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

    def card(a):
        return torch.from_numpy(a.view(np.int64).reshape(rows, 256)).to(dev)

    clean, bad = card(clean_np), card(bad_np)
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
    """Protected leaves carry their original bytes; SEC-DED and MIRROR left
    nothing uncorrectable; a Tier NONE leaf differs only if struck."""
    from repro_torch.core import Tier
    struck = {e["path"] for e in events}
    for s in dom.spec.leaves:
        same = torch.equal(_bytes(dom.leaf(s.path)),
                           _bytes(original.leaf(s.path)))
        if s.tier is not Tier.NONE and not same:
            raise AssertionError(f"{s.path} ({s.tier.value}) not restored")
        if s.tier is Tier.NONE and s.path not in struck and not same:
            raise AssertionError(f"{s.path} changed without a strike")
        if s.tier in (Tier.SECDED, Tier.MIRROR) and \
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


def run_main_path(state):
    """Drive each design point, then the hard drill, through the verbs.
    Every path's launches are counted on their own (the counters are reset
    just before it); returns {path: {kernel: launches}}."""
    from repro_torch.core import (DESIGN_POINTS, MemoryDomain, RetirementMap,
                                  Tier)
    from repro_torch.kernels import _build
    rng = np.random.default_rng(SEED)
    by_path = {}
    torch.cuda.reset_peak_memory_stats()
    for name in DESIGN_POINTS_RUN:
        _build.reset_launches()
        dom, t_protect = _timed(
            lambda: MemoryDomain.protect(state, DESIGN_POINTS[name]()))
        clean = {p: dom.leaf(p) for p in dom.paths()}
        (bad, events), t_inject = _timed(
            lambda: dom.inject(rng, STRIKES, multi_bit_fraction=0.0))
        (fixed, report), t_scrub = _timed(bad.scrub)
        corr, unc = report.totals()
        (rec, rev), t_recover = _timed(
            lambda: fixed.recover(report, clean_copy=clean.__getitem__))
        _path_launches(name, dom, by_path)
        _check_restored(rec, dom, events, report)
        none_hits = sum(dom.tier_of(e["path"]) is Tier.NONE for e in events)
        st = dom.stats()
        print(f"{name}: payload={st.payload_bytes} sidecar={st.sidecar_bytes}"
              f" protect_ms={t_protect:.1f} inject_ms={t_inject:.1f} "
              f"scrub_ms={t_scrub:.1f} recover_ms={t_recover:.1f} "
              f"corrected={corr} uncorrectable={unc} reloaded={len(rev)} "
              f"strikes_on_unprotected={none_hits} restored=bit-exact")
        del dom, clean, bad, fixed, rec, report
    # hard errors: sticky strikes re-bite after each reload until their
    # blocks are retired
    _build.reset_launches()
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
    print(f"peak_memory_bytes={torch.cuda.max_memory_allocated()}")
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


def check_main_shapes(state, dev, chunk_rows: int = 1 << 16):
    """Each kernel against its plain version at the shapes the main path
    gives it: every tier buffer of every design point run (the
    typical_server SEC-DED buffer is all 6.66 GB of payload, past 4 GB of
    byte offsets). The encode kernels' sidecars are the ones ``protect``
    made; the bit-flip kernel strikes the buffer (``_strike_plan``), one
    ECC byte in 256 (offset 33) gets a flipped check bit, and the scrub or
    check kernel runs on the struck buffer. The plain versions run over
    row chunks of the same card tensors."""
    from repro_torch.core import DESIGN_POINTS, MemoryDomain, Tier
    from repro_torch.core.domain import _gather_packed
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitflip import bitflip_words_
    from repro_torch.kernels.parity import (parity_check_plain,
                                            parity_check_words)
    from repro_torch.kernels.secded import (secded_scrub_plain,
                                            secded_scrub_words)
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
            code = "secded" if tier is Tier.SECDED else "parity"
            side = sc["ecc"] if tier is Tier.SECDED else sc["par"]
            encode_ref = ref.secded_encode_ref if tier is Tier.SECDED \
                else ref.parity_encode_ref
            tally(code + "_encode", n,
                  _agree([side], lambda w: (encode_ref(w),), [words],
                         chunk_rows))
            wi, bi, k1, k2 = _strike_plan(n, gen)
            want = ref.bitflip_ref(words, wi, bi)
            bitflip_words_(words, wi, bi)             # words now struck
            tally("bitflip", n,
                  _agree([words], lambda w: (w,), [want], chunk_rows))
            del want, wi, bi
            if tier is Tier.SECDED:
                ecc = side.clone().reshape(-1)
                chk = torch.arange(33, n, 256, device=ecc.device)
                k3 = chk.numel()
                ecc[chk] ^= torch.bitwise_left_shift(
                    torch.ones(k3, dtype=torch.uint8, device=ecc.device),
                    torch.randint(0, 8, (k3,), generator=gen,
                                  device=ecc.device, dtype=torch.uint8))
                ecc = ecc.reshape(rows, 256)
                got = secded_scrub_words(words, ecc)
                tally("secded_scrub", n, _agree(
                    got, secded_scrub_plain, [words, ecc], chunk_rows))
                counts = (int(got[2].sum()), int(got[3].sum()))
                if counts != (k1 + k3, k2):
                    raise AssertionError(
                        f"{name} {tier.value} scrub counts {counts}, want "
                        f"{(k1 + k3, k2)}")
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
    for name in ("typical_server", "mirror_dr_l"):
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


def time_kernels(state, chunk_rows: int = 1 << 16):
    """Each kernel and its plain version at the typical_server tier buffer:
    the whole payload packed into one (rows, 256) word buffer. The plain
    versions run over row chunks of ``chunk_rows`` to bound their
    temporaries; their time is that of the whole buffer."""
    from repro_torch.core import DESIGN_POINTS, InjectionPlan, MemoryDomain, \
        Tier
    from repro_torch.core.domain import _gather_packed
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitflip import bitflip_words_
    from repro_torch.kernels.parity import (parity_check_plain,
                                            parity_check_words,
                                            parity_encode_words)
    from repro_torch.kernels.secded import (secded_encode_words,
                                            secded_scrub_plain,
                                            secded_scrub_words)
    dom = MemoryDomain.protect(state, DESIGN_POINTS["typical_server"]())
    rows, sel = dom.spec.groups[Tier.SECDED]
    words = _gather_packed(dom._leaves(), sel, rows)
    ecc = dom.sidecar[Tier.SECDED.value]["ecc"]
    del dom
    par = parity_encode_words(words)
    plan = InjectionPlan.sample(np.random.default_rng(SEED), rows * 256, 1,
                                False, 0.0)
    wi = torch.from_numpy(plan.word_idx).to(words.device, torch.int64)
    bi = torch.from_numpy(plan.bit_idx).to(words.device, torch.int64)
    n, e = rows * 256, int(plan.word_idx.size)
    # bit-flip reads 16 B of indices per slot, and read-modify-writes 8 B
    # only for a strike that lands in the buffer
    hits = int(((wi >= 0) & (wi < n) & (bi >= 0) & (bi < 64)).sum())
    flip_bytes = 16 * e + 16 * hits

    def chunked(fn, *bufs):
        def run():
            for a in range(0, rows, chunk_rows):
                fn(*(b[a:a + chunk_rows] for b in bufs))
        return run

    cases = {
        "secded_encode": (lambda: secded_encode_words(words),
                          chunked(ref.secded_encode_ref, words), n * 9),
        "secded_scrub": (lambda: secded_scrub_words(words, ecc),
                         chunked(secded_scrub_plain, words, ecc),
                         n * 18 + rows * 8),
        "parity_encode": (lambda: parity_encode_words(words),
                          chunked(ref.parity_encode_ref, words),
                          n * 8 + rows * 32),
        "parity_check": (lambda: parity_check_words(words, par),
                         chunked(parity_check_plain, words, par),
                         n * 8 + rows * 32 * 2 + rows * 4),
        # in place: the same 8-strike plan toggles its bits each launch
        "bitflip": (lambda: bitflip_words_(words, wi, bi),
                    lambda: ref.bitflip_ref(words, wi, bi), flip_bytes),
    }
    out = {}
    for name, (kern, plain, nbytes) in cases.items():
        ms = _cuda_ms(kern, reps=10)
        plain_ms = _cuda_ms(plain, reps=1)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bytes": nbytes}
        print(f"time {name}: rows={rows} words={n} strikes={e} hits={hits} "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
              f"(bytes={nbytes}) of_bound={bound_ms / ms:.3f}")
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
    build()
    checks = check_kernels(dev)
    state = model_state(dev)
    by_path = run_main_path(state)
    full = check_main_shapes(state, dev)
    profile_scrub(state)
    times = time_kernels(state)
    card = card_line()
    print(f"card: {card}")
    print(f"wall_s={time.perf_counter() - t0:.1f}")
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(n[name] for n in by_path.values()),
         "launches_by_path": {p: n[name] for p, n in by_path.items()},
         "max_abs_err": float(max(checks[name]["max_abs_err"],
                                  full[name]["max_abs_err"])),
         "mismatches": checks[name]["mismatches"] + full[name]["mismatches"],
         "words_checked": checks[name]["words"] + full[name]["words"],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": None}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
