"""Graph-mining workload: PageRank + BFS on a power-law graph under an HRM
policy, with errors injected into topology vs iterate regions: the
paper's third case-study application.

Counterpart of ``examples/graph_pagerank.py``; the reference's
``backend="pallas"`` is the port's ``backend="kernel"``:

  PYTHONPATH=src python -m repro_torch.examples.graph_pagerank --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import MemoryDomain, detect_recover_l
from repro_torch.examples._common import add_device
from repro_torch.graph import (bfs, bfs_reference, bfs_scrubbed, graph_state,
                               node_block_of, pagerank, pagerank_scrubbed,
                               powerlaw_graph, top_k)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv: Optional[List[str]] = None) -> int:
    ap = add_device(argparse.ArgumentParser(description=__doc__))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = powerlaw_graph(512, avg_degree=8, seed=0)
    print(f"graph: n={g.n} edges={g.n_edges} "
          f"max_in_degree={g.max_in_degree}")
    ref_dist = bfs_reference(g, 0).to(device)

    # 1. the graph state is a MemoryDomain like any other workload: CSR
    #    topology on SEC-DED (crash-vulnerable pointers), rank on Par+R
    #    (numeric iterate self-heals), frontier on Par+R
    state = graph_state(g, with_bfs=True, source=0, device=device)
    domain = MemoryDomain.protect({"graph": state}, detect_recover_l())
    stats = domain.stats()
    print("tiers:", {r: t for r, t in sorted(stats.region_tiers.items())
                     if r.startswith("graph/")})
    print(f"sidecar overhead: {stats.overhead:.2%}")

    # 2. golden run through the segment-sum push kernel
    _, rank, delta = pagerank(state, g.n, iters=25, backend="kernel")
    golden = top_k(rank, g.n, 8)
    print("top-8:", golden.tolist(), f"residual={float(delta):.2e}")
    _, dist = bfs(state, backend="kernel")
    _check(torch.equal(dist[0, :g.n], ref_dist),
           "BFS levels differ from the CSR reference")
    print("BFS levels match the CSR reference")

    # 3. a soft error in the rank iterate self-heals under convergence...
    corrupted, ev = domain.inject(np.random.default_rng(3), 1,
                                  paths=["graph/rank/rank"])
    _, rank2, _ = pagerank(corrupted.payload["graph"], g.n, iters=25)
    healed = bool(torch.isfinite(rank2).all()) and \
        torch.equal(top_k(rank2, g.n, 8), golden)
    print(f"rank strike at {ev[0]['path']}: top-8 preserved={healed}")

    # 4. ...while the scrub catches topology strikes before they rewire
    #    edges
    corrupted2, ev2 = domain.inject(np.random.default_rng(4), 1,
                                    paths=["graph/topology/src"])
    fixed, report = corrupted2.scrub()
    print(f"topology strike at {ev2[0]['path']}: scrub corrected="
          f"{report.totals()[0]}")
    _, rank3, _ = pagerank(fixed.payload["graph"], g.n, iters=25)
    _check(torch.equal(top_k(rank3, g.n, 8), golden),
           "the scrubbed topology changed the top-8")

    # 5. at scale: the node-blocked layout runs the same API, edges
    #    bucketed by (dst_block, src_block), frontier-sparse BFS, and the
    #    scrub sliced between iterations so protection stays off the
    #    critical path (pagerank_scrubbed)
    blocked = graph_state(g, with_bfs=True, source=0, node_block=256,
                          device=device)
    print(f"\nnode-blocked layout: BN={node_block_of(blocked)} "
          f"tiles={blocked['topology']['blocks']['src_block'].shape[0]}")
    _, rank_b, delta_b = pagerank(blocked, g.n, iters=25, fori=True)
    _check(torch.equal(top_k(rank_b, g.n, 8), golden),
           "the blocked top-8 differs from the dense one")
    print("blocked top-8 matches dense", f"residual={float(delta_b):.2e}")
    dom_b = MemoryDomain.protect({"graph": blocked}, detect_recover_l())
    dom_b, _, _, _ = pagerank_scrubbed(dom_b, g.n, iters=8, scrub_slices=4)
    dom_b, dist_b, _ = bfs_scrubbed(dom_b, scrub_slices=4)
    _check(torch.equal(dist_b[0, :g.n], ref_dist),
           "the scrubbed BFS differs from the CSR reference")
    print("scrub-overlapped PageRank+BFS reproduce the unprotected results")
    print("GRAPH_PAGERANK OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
