"""BFS over the tiled-CSR graph state: the push SpMV carries frontier mass
along edges and the frontier kernel (``repro_torch.kernels.segsum``)
thresholds it, masks visited nodes and stamps levels into ``dist``.

Counterpart of ``repro.graph.bfs``. BFS state is control state: a flipped
``visited`` bit or a rewired ``dst`` changes which vertices are reached,
and distances do not heal.

On node-blocked states the push is frontier-sparse by default: the host
reads which source blocks hold frontier nodes (the level loop reads the
frontier back anyway), keeps only the edge tiles whose source block is
active, and pushes those. The kept-tile count is padded to a power of two
with inert sentinel tiles, as the reference dispatches it. Skipped tiles
would have gathered exact zeros, so the result equals the dense push.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sidecar import ScrubReport
from repro_torch.graph.generate import node_block_of
from repro_torch.graph.pagerank import (_accumulate, _check_backend, _push,
                                        _region_paths)
from repro_torch.kernels import ref
from repro_torch.kernels.segsum import (edge_segment_push_blocked,
                                        frontier_update)


def active_src_blocks(frontier: torch.Tensor,
                      node_block: int) -> torch.Tensor:
    """(n_blocks,) bool: which node blocks hold an active frontier node."""
    nb = frontier.shape[1] // node_block
    return (frontier.reshape(nb, node_block) > 0).any(dim=1)


def _sparse_push(topo: dict, x: torch.Tensor, backend: str) -> torch.Tensor:
    """Frontier-sparse blocked push: only the edge tiles whose source
    block intersects the frontier. Equal to the dense blocked push."""
    _check_backend(backend)
    blocks = topo["blocks"]
    bn = node_block_of({"topology": topo})
    n = x.shape[1]
    nb = n // bn
    sb_np = blocks["src_block"].cpu().numpy()
    active = active_src_blocks(x, bn).cpu().numpy()
    idx = np.nonzero(active[np.clip(sb_np, 0, nb - 1)])[0]
    if idx.size == 0:
        return torch.zeros_like(x)
    t = sb_np.shape[0]
    te = topo["src"].shape[0] // t
    # kept tiles padded to a power of two with sentinel tiles whose block
    # coordinates are the last kept tile's
    pad = (1 << (int(idx.size) - 1).bit_length()) - idx.size
    gather = torch.from_numpy(idx).to(x.device)
    src_sel = topo["src"].reshape(t, te).index_select(0, gather)
    dst_sel = topo["dst"].reshape(t, te).index_select(0, gather)
    sb_sel = blocks["src_block"].index_select(0, gather)
    db_sel = blocks["dst_block"].index_select(0, gather)
    if pad:
        sentinel = torch.full((pad, te), n, dtype=torch.int32,
                              device=x.device)
        src_sel = torch.cat([src_sel, sentinel])
        dst_sel = torch.cat([dst_sel, sentinel])
        sb_sel = torch.cat([sb_sel, sb_sel[-1:].expand(pad)])
        db_sel = torch.cat([db_sel, db_sel[-1:].expand(pad)])
    push = edge_segment_push_blocked if backend == "kernel" \
        else ref.edge_segment_push_blocked_ref
    return push(src_sel.reshape(-1), dst_sel.reshape(-1), sb_sel, db_sel, x,
                node_block=bn)


def bfs_step(state: dict, level: int, *, backend: str = "kernel",
             sparse: Optional[bool] = None) -> dict:
    """Advance the frontier one level; returns the state with the
    ``frontier`` group replaced. ``sparse=None`` pushes frontier-sparse on
    node-blocked states."""
    topo = state["topology"]
    fr = state["frontier"]
    blocked = "blocks" in topo
    if sparse is None:
        sparse = blocked
    f32 = fr["frontier"].to(torch.float32)
    if blocked and sparse:
        pushed = _sparse_push(topo, f32, backend)
    else:
        pushed = _push(topo, f32, backend)
    update = frontier_update if backend == "kernel" \
        else ref.frontier_update_ref
    frontier, visited, dist = update(pushed, fr["visited"], fr["dist"],
                                     level)
    return {**state, "frontier": {"frontier": frontier,
                                  "visited": visited, "dist": dist}}


def _frontier_empty(state: dict) -> bool:
    return not bool((state["frontier"]["frontier"] > 0).any())


def bfs(state: dict, *, max_levels: int = 0, backend: str = "kernel",
        sparse: Optional[bool] = None) -> Tuple[dict, torch.Tensor]:
    """Run BFS to exhaustion (or ``max_levels``) from the state's frontier
    (seeded by ``graph_state(..., with_bfs=True, source=s)``).

    Returns (final state, dist (1, n_pad) int32, -1 = unreached)."""
    levels = max_levels or state["frontier"]["dist"].shape[1]
    for level in range(1, levels + 1):
        state = bfs_step(state, level, backend=backend, sparse=sparse)
        if _frontier_empty(state):
            break
    return state, state["frontier"]["dist"]


_FRONTIER_PATHS = ("graph/frontier/frontier", "graph/frontier/visited",
                   "graph/frontier/dist")


def bfs_scrubbed(domain, *, max_levels: int = 0, backend: str = "kernel",
                 sparse: Optional[bool] = None, scrub_slices: int = 8,
                 regions: Iterable[str] = ("graph/topology",
                                           "graph/rank")):
    """BFS with the scrub spread over the levels: after each level the
    rewritten frontier sidecars are re-encoded and one slice
    (``MemoryDomain.scrub_partial``) of the long-lived regions is scrubbed,
    a full pass every ``scrub_slices`` levels.

    ``domain`` protects a ``{"graph": graph_state(..., with_bfs=True)}``
    payload. Returns (domain, dist, merged ScrubReport)."""
    paths = _region_paths(domain, regions)
    refresh_paths = [p for p in domain.paths(protected_only=True)
                     if p in _FRONTIER_PATHS]
    corrected: dict = {}
    uncorrectable: dict = {}
    levels = max_levels or domain.payload["graph"]["frontier"]["dist"].shape[1]
    for level in range(1, levels + 1):
        state = bfs_step(domain.payload["graph"], level, backend=backend,
                         sparse=sparse)
        domain = domain.refresh({**domain.payload, "graph": state},
                                paths=refresh_paths)
        domain, rep = domain.scrub_partial(level - 1, slices=scrub_slices,
                                           paths=paths)
        _accumulate(corrected, rep.corrected)
        _accumulate(uncorrectable, rep.detected_uncorrectable)
        if _frontier_empty(domain.payload["graph"]):
            break
    return (domain, domain.payload["graph"]["frontier"]["dist"],
            ScrubReport(corrected=corrected,
                        detected_uncorrectable=uncorrectable))


def bfs_reference(g, source: int) -> torch.Tensor:
    """Plain-numpy CSR BFS over a ``CSRGraph`` (in-edge CSR: each level
    scans the rows for frontier sources); (n,) int32 on the CPU."""
    n = g.n
    indptr, indices = g.indptr, g.indices
    dist = np.full(n, -1, np.int32)
    dist[source] = 0
    frontier = {source}
    level = 0
    while frontier:
        level += 1
        nxt = set()
        for v in range(n):
            if dist[v] >= 0:
                continue
            row = indices[indptr[v]:indptr[v + 1]]
            if any(u in frontier for u in row.tolist()):
                dist[v] = level
                nxt.add(v)
        frontier = nxt
    return torch.from_numpy(dist)


def bfs_eval_fn(n: int, *, max_levels: int = 0, backend: str = "kernel"):
    """Fig. 2 ``eval_fn``: the answer is the distance vector of the real
    nodes, unreached nodes reporting ``n`` (a negative output is the crash
    marker)."""
    def eval_fn(payload):
        state, dist = bfs(payload["graph"], max_levels=max_levels,
                          backend=backend)
        d = dist[0, :n]
        return torch.where(d < 0, n, d), {**payload, "graph": state}
    return eval_fn
