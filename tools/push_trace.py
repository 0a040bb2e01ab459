#!/usr/bin/env python3
"""Trace the graph push kernels on one GPU and time variants of them.

    python3 tools/push_trace.py [--scale 22] [--reps 20]

Needs one CUDA card (the kernels build for ``sm_90a``) and ``nvcc``. It
builds ``tools/push_variants.cu`` (the port's ``segsum.cu`` plus the
one-edge-a-thread pushes it replaced and variants that isolate their
parts), then the Graph500 graph
``powerlaw_graph(2**scale, avg_degree=16, seed=0)`` on the card, dense and
in 65,536-node blocks, as ``chip_smoke.py`` phase 6 builds it, and with
PageRank's first push input:

1. splits one warm call of each push into its device events under
   ``torch.profiler`` (the memset of the float64 scratch, the push kernel,
   the round pass), for the port's pushes and the one-edge-a-thread ones;
2. times each variant's push kernel alone with CUDA events, in two rounds,
   the second in reverse order;
3. counts the float64 atomics each grouping issues on this graph, and the
   distinct 32-byte sectors of x the gathers touch within each window of
   consecutive edges (and, blocked, within each bucket): the share of
   gathers an SM's L1 could serve if it held a window's sectors;
4. holds each full variant against the plain version with integer x, bit
   for bit, and fails if one differs.

Prints the card's name and power limit first and last.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# variant -> (entry point variant code, K); timed push kernel alone. "kK"
# is the library's design at K edges a thread; "one_edge*" the
# one-edge-a-thread kernels it replaced;
# "_lib_" the library's design in parts; the others K-edge variants with
# 256 threads a block and ld.global.nc ids unless they say otherwise
# (b1024: 1024 threads a block; x2, x4: blocks an SM; ids_cs, ids_no_l1,
# x_last, max_l1: cache hints; walk: a persistent grid).
COMMON = {
    "one_edge": (1, 0), "k4": (0, 4), "k8": (0, 8), "k16": (0, 16),
    "k32": (0, 32), "k8_lib_no_gather": (80, 8),
    "k8_lib_no_atomics": (81, 8), "k8_lib_ids_only": (82, 8),
    "k16_no_gather": (4, 16), "k16_no_atomics": (8, 16),
    "k16_ids_only": (5, 16), "k8_ldg": (20, 8), "k16_ldg": (20, 16),
    "k8_ids_cs": (21, 8), "k16_ids_cs": (21, 16), "k8_ids_no_l1": (22, 8),
    "k8_ids_no_l1_x_last": (23, 8), "k8_b1024": (40, 8),
    "k16_b1024": (40, 16), "k16_b1024_ids_cs": (41, 16),
    "k8_b1024_max_l1": (60, 8), "k8_b512_ids_cs": (51, 8),
    "k8_b1024x2_ids_cs": (70, 8), "k8_b512x4_ids_cs": (71, 8),
    "k8_walk1024": (10, 8), "k8_walk256": (12, 8),
}
DENSE = {"one_edge_no_scan": (2, 0), "one_edge_no_gather": (3, 0),
         "k8_scalar_ids": (6, 8), **COMMON}
BLOCKED = {"k8_general_tiles": (7, 8), **COMMON}
# the variants that compute the push whole (the others leave parts out)
CHECKED = tuple(v for v in {**DENSE, **BLOCKED}
                if not v.endswith(("no_scan", "no_gather", "no_atomics",
                                   "ids_only")) or v == "one_edge_no_scan")


def build() -> ctypes.CDLL:
    nvcc = "/usr/local/cuda/bin/nvcc"
    out = Path(tempfile.mkdtemp()) / "libpush_variants.so"
    run = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
         "-o", str(out), str(ROOT / "tools" / "push_variants.cu")],
        capture_output=True, text=True)
    # registers and spills of the kernels timed here
    for line in run.stderr.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print("ptxas:", line.strip()[:160])
    if run.returncode:
        print(run.stderr[-4000:])
        raise SystemExit("nvcc failed")
    lib = ctypes.CDLL(str(out))
    p, i64, c = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.var_push.argtypes = (c, c, c, p, p, p, p, p, i64, i64, p)
    lib.var_push_blocked.argtypes = (c, c, c, p, p, p, p, p, p, p, i64, i64,
                                     i64, i64, p)
    return lib


def caller(lib, topo, x, variant: int, k: int, full: bool):
    """A function that runs the variant on ``topo`` and returns y."""
    n = x.shape[1]
    y = torch.empty_like(x)
    acc = torch.zeros(n, dtype=torch.float64, device=x.device)
    src, dst = topo["src"], topo["dst"]
    blocks = topo.get("blocks")

    def run():
        st = torch.cuda.current_stream().cuda_stream
        if blocks is None:
            rc = lib.var_push(variant, k, int(full), src.data_ptr(),
                              dst.data_ptr(), x.data_ptr(), y.data_ptr(),
                              acc.data_ptr(), src.shape[0], n, st)
        else:
            sb, db = blocks["src_block"], blocks["dst_block"]
            bn = cs.GRAPH_NODE_BLOCK
            rc = lib.var_push_blocked(
                variant, k, int(full), src.data_ptr(), dst.data_ptr(),
                sb.data_ptr(), db.data_ptr(), x.data_ptr(), y.data_ptr(),
                acc.data_ptr(), src.shape[0], src.shape[0] // sb.shape[0],
                n // bn, bn, st)
        if rc:
            raise RuntimeError(f"variant {variant} K={k}: CUDA error {rc}")
        return y
    return run


def gather_sectors(topo, key: torch.Tensor, n: int, window: int) -> int:
    """Distinct (window, 32-byte sector of x) pairs over the counted edges;
    ``window`` 0 takes the buckets of a blocked layout as windows."""
    ok = key >= 0
    src = topo["src"]
    if window:
        win = torch.arange(src.shape[0], device=src.device) // window
    else:
        sb, db = topo["blocks"]["src_block"], topo["blocks"]["dst_block"]
        change = torch.ones_like(sb, dtype=torch.bool)
        change[1:] = (sb[1:] != sb[:-1]) | (db[1:] != db[:-1])
        win = torch.cumsum(change.long(), 0).repeat_interleave(
            src.shape[0] // sb.shape[0])
    pairs = win[ok] * (n // 8 + 1) + (src[ok].long() >> 3)
    return int(torch.unique(pairs).numel())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=cs.GRAPH_SCALE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("push_trace: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.graph import graph_state, powerlaw_graph
    from repro_torch.kernels import ref
    from repro_torch.kernels.segsum import (edge_segment_push,
                                            edge_segment_push_blocked)
    print(cs.card_line())
    lib = build()
    dev = torch.device("cuda")
    g = powerlaw_graph(1 << args.scale, avg_degree=cs.GRAPH_DEGREE,
                       seed=cs.SEED)
    states = {"dense": graph_state(g, device=dev),
              "blocked": graph_state(g, node_block=cs.GRAPH_NODE_BLOCK,
                                     device=dev)}
    n = states["dense"]["rank"]["rank"].shape[1]
    print(f"graph: 2**{args.scale} nodes, {g.n_edges} edges, dense "
          f"{states['dense']['topology']['src'].shape[0]} padded, blocked "
          f"{states['blocked']['topology']['src'].shape[0]}")
    bn = cs.GRAPH_NODE_BLOCK
    wrappers = {
        "dense": lambda t, x: edge_segment_push(t["src"], t["dst"], x),
        "blocked": lambda t, x: edge_segment_push_blocked(
            t["src"], t["dst"], t["blocks"]["src_block"],
            t["blocks"]["dst_block"], x, node_block=bn)}
    plains = {
        "dense": lambda t, x: ref.edge_segment_push_ref(t["src"], t["dst"],
                                                        x),
        "blocked": lambda t, x: ref.edge_segment_push_blocked_ref(
            t["src"], t["dst"], t["blocks"]["src_block"],
            t["blocks"]["dst_block"], x, node_block=bn)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 7)
    bad = []
    for layout, variants in (("dense", DENSE), ("blocked", BLOCKED)):
        state = states[layout]
        topo = state["topology"]
        x = cs._pagerank_x(state)
        # 1. the device events of one warm call, the port's push and the
        # one-edge-a-thread one's
        for label, fn in (("port", lambda: wrappers[layout](topo, x)),
                          ("one_edge", caller(lib, topo, x, 1, 0, True))):
            split = cs.profile_split(fn)
            total = sum(ms for _, ms, _ in split)
            print(f"split {layout} {label}: device_ms={total:.4f}")
            for key, ms, count in split:
                print(f"  {ms:8.4f} ms x{count} {key[:100]}")
        # 2. each variant's push kernel alone, two rounds in turns
        order = list(variants)
        times = {v: [] for v in order}
        for rnd in (order, order[::-1]):
            for v in rnd:
                code, k = variants[v]
                times[v].append(cs._cuda_ms(
                    caller(lib, topo, x, code, k, False), args.reps))
        for v in order:
            a, b = times[v]
            print(f"time {layout} {v}: ms={a:.4f} {b:.4f} "
                  f"mean={(a + b) / 2:.4f}")
        # 3. atomics by grouping
        key = cs.push_keys(topo, n)
        counted = int((key >= 0).sum())
        print(f"atomics {layout}: per counted edge {counted}; "
              + "; ".join(f"warp of {gsz} edges {cs.push_atomics(key, gsz)}"
                          for gsz in (32, 128, 256, 512, 1024)))
        windows = (4096, 16384) + ((0,) if layout == "blocked" else ())
        print(f"gather sectors {layout} (distinct per window / counted "
              "edges): " + "; ".join(
                  f"{'bucket' if w == 0 else f'{w} edges'} "
                  f"{gather_sectors(topo, key, n, w) / counted:.4f}"
                  for w in windows))
        del key
        # 4. integer x, bit for bit against the plain version
        x_int = torch.randint(0, 8, x.shape, generator=gen, device=dev,
                              dtype=torch.int32).float()
        want = plains[layout](topo, x_int)
        for v in CHECKED:
            if v in variants:
                code, k = variants[v]
                ok = torch.equal(caller(lib, topo, x_int, code, k, True)(),
                                 want)
                print(f"check {layout} {v}: equal={ok}")
                if not ok:
                    bad.append((layout, v))
        print(f"check {layout} wrapper: equal="
              f"{torch.equal(wrappers[layout](topo, x_int), want)}")
    print(cs.card_line())
    if bad:
        raise SystemExit(f"variants differ from the plain version: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
