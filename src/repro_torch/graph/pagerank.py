"""PageRank over the tiled-CSR graph state: one push SpMV per power
iteration through the segment-sum kernels (``repro_torch.kernels.segsum``).

Counterpart of ``repro.graph.pagerank``. The iterate is the damped power
iteration

    rank' = (1-d)/n + d * (push(rank/outdeg) + dangling_mass/n)

over the real (unpadded) nodes. Soft errors in ``graph/rank`` decay by
``d`` per iteration; errors in ``graph/topology`` rewire or drop edges and
move the stationary distribution itself, which the top-k answer shows.

Backends: ``"kernel"`` calls the kernel wrappers (the CUDA kernels on the
card, their plain versions on CPU tensors); ``"segment_sum"`` calls the
plain versions on any device, the yardstick the kernel path is held to.
States built with ``graph_state(..., node_block=BN)`` go through the
node-blocked push. ``pagerank_scrubbed`` runs one incremental scrub slice
(``MemoryDomain.scrub_partial``) after each iteration, so a full scrub
pass completes every ``scrub_slices`` iterations.

``pagerank_eval_fn`` answers with the top-k ranking, or the -1 crash
marker when a rank is not finite.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from repro_torch.core.sidecar import ScrubReport
from repro_torch.graph.generate import node_block_of
from repro_torch.kernels import ref
from repro_torch.kernels.segsum import (edge_segment_push,
                                        edge_segment_push_blocked)

BACKENDS = ("kernel", "segment_sum")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def _push(topo: dict, x: torch.Tensor, backend: str) -> torch.Tensor:
    """Push SpMV over a topology group: the node-blocked push when a
    ``blocks`` table is present, the dense one otherwise."""
    _check_backend(backend)
    src, dst = topo["src"], topo["dst"]
    blocks = topo.get("blocks")
    if blocks is not None:
        push = edge_segment_push_blocked if backend == "kernel" \
            else ref.edge_segment_push_blocked_ref
        return push(src, dst, blocks["src_block"], blocks["dst_block"], x,
                    node_block=node_block_of({"topology": topo}))
    push = edge_segment_push if backend == "kernel" \
        else ref.edge_segment_push_ref
    return push(src, dst, x)


def _step_math(topo: dict, rank: torch.Tensor, n: int, damping: float,
               backend: str) -> torch.Tensor:
    """One power iteration on the rank vector."""
    n_pad = rank.shape[1]
    real = (torch.arange(n_pad, device=rank.device) < n).reshape(1, n_pad)
    outdeg = topo["outdeg"].to(torch.float32)
    contrib = torch.where(real & (outdeg > 0),
                          rank / outdeg.clamp_min(1.0), 0.0)
    pushed = _push(topo, contrib, backend)
    dangling = torch.where(real & (outdeg <= 0), rank, 0.0).sum()
    new = torch.where(real, (1.0 - damping) / n
                      + damping * (pushed + dangling / n), 0.0)
    return new.to(torch.float32)


def pagerank_step(state: dict, n: int, *, damping: float = 0.85,
                  backend: str = "kernel") -> dict:
    """One power iteration; returns the state with ``rank`` replaced."""
    new = _step_math(state["topology"], state["rank"]["rank"], n, damping,
                     backend)
    return {**state, "rank": {"rank": new}}


def pagerank(state: dict, n: int, *, iters: int = 20,
             damping: float = 0.85, backend: str = "kernel",
             fori: bool = False
             ) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """Run ``iters`` power iterations from the state's current rank.

    The loop reads nothing back to the host, so ``fori=True`` (the
    reference's one-program loop) runs the same loop and gives the same
    bits. Returns (final state, rank (1, n_pad), L1 delta of the last
    step)."""
    del fori
    prev = state["rank"]["rank"]
    for _ in range(iters):
        prev = state["rank"]["rank"]
        state = pagerank_step(state, n, damping=damping, backend=backend)
    rank = state["rank"]["rank"]
    return state, rank, (rank - prev).abs().sum()


def _region_paths(domain, regions: Iterable[str]):
    want = set(regions)
    return [p for p in domain.paths(protected_only=True)
            if domain.region_of(p) in want]


def _accumulate(total: Dict[str, torch.Tensor], counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def pagerank_scrubbed(domain, n: int, *, iters: int = 20,
                      damping: float = 0.85, backend: str = "kernel",
                      scrub_slices: int = 8,
                      regions: Iterable[str] = ("graph/topology",
                                                "graph/rank")):
    """Power iteration with the scrub spread over the iterations: after each
    iteration the rank sidecar is re-encoded (the rank was legitimately
    rewritten) and one slice (``MemoryDomain.scrub_partial``) of the
    topology and rank regions is scrubbed, so a full pass completes every
    ``scrub_slices`` iterations.

    ``domain`` protects a ``{"graph": graph_state(...)}`` payload. Returns
    (domain, rank (1, n_pad), L1 delta, merged ScrubReport)."""
    paths = _region_paths(domain, regions)
    corrected: dict = {}
    uncorrectable: dict = {}
    prev = domain.payload["graph"]["rank"]["rank"]
    for it in range(iters):
        prev = domain.payload["graph"]["rank"]["rank"]
        state = pagerank_step(domain.payload["graph"], n, damping=damping,
                              backend=backend)
        domain = domain.refresh({**domain.payload, "graph": state},
                                paths=["graph/rank/rank"])
        domain, rep = domain.scrub_partial(it, slices=scrub_slices,
                                           paths=paths)
        _accumulate(corrected, rep.corrected)
        _accumulate(uncorrectable, rep.detected_uncorrectable)
    rank = domain.payload["graph"]["rank"]["rank"]
    return domain, rank, (rank - prev).abs().sum(), ScrubReport(
        corrected=corrected, detected_uncorrectable=uncorrectable)


def top_k(rank: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Top-k node ids by rank (stable order; ties break by node id)."""
    return torch.argsort(-rank[0, :n], stable=True)[:k].to(torch.int32)


def pagerank_eval_fn(n: int, *, iters: int = 20, k: int = 8,
                     damping: float = 0.85, backend: str = "kernel"):
    """Fig. 2 ``eval_fn`` over a ``{"graph": graph_state}`` payload: run
    PageRank from the (possibly corrupted) state and answer with the top-k
    ranking, or the -1 crash marker when a rank is not finite."""
    def eval_fn(payload):
        state, rank, _ = pagerank(payload["graph"], n, iters=iters,
                                  damping=damping, backend=backend)
        toks = torch.where(torch.isfinite(rank).all(), top_k(rank, n, k),
                           -1)
        return toks, {**payload, "graph": state}
    return eval_fn
