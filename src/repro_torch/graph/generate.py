"""Synthetic power-law graphs in CSR layout: the graph workload's input.

Counterpart of ``repro.graph.generate``; the generator and the bucketing are
its numpy, so the same seed gives the same CSR and the same buckets.

``powerlaw_graph`` draws out-degrees from a truncated power law and wires
destinations preferentially (popularity weights are themselves power-law
over a random node permutation), so both degree tails are heavy. The CSR
stores **in-edges**: row ``v`` holds the sources of edges into ``v``.

``graph_state`` expands the CSR into the tensors the kernels
(``repro_torch.kernels.segsum``) read, grouped into the HRM regions of
``repro_torch.core.policy``:

    graph/topology   src, dst (the tiled CSR expansion), outdeg, and the
                     per-tile block tables of the node-blocked layout
    graph/rank       the PageRank iterate
    graph/frontier   BFS frontier/visited/dist

With ``node_block=BN`` the edges are bucketed by ``(dst_block,
src_block)`` (``bucket_edges``), each bucket sentinel-padded to whole edge
tiles, and the per-tile block coordinates stored under
``topology/blocks``. The block size is the *shape* of the ``bn_lanes``
marker leaf (``node_block_of``), so a struck bit in its payload cannot
change the layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.segsum import (EDGE_TILE, NODE_LANES, _round_up,
                                        pad_edges)

# below this node count the O(n^2) legacy sampling loop keeps its exact
# edge stream; above it the vectorized single draw keeps generation
# O(E log E)
_VECTORIZE_MIN_N = 4096


@dataclass(frozen=True)
class CSRGraph:
    """In-edge CSR: ``indices[indptr[v]:indptr[v+1]]`` = sources into v."""
    n: int
    indptr: np.ndarray        # (n+1,) int32
    indices: np.ndarray       # (nnz,) int32, row-sorted
    out_degree: np.ndarray    # (n,) int32

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def max_in_degree(self) -> int:
        return int(np.diff(self.indptr).max()) if self.n else 0


def _choice(rng: np.random.Generator, n: int, size: int,
            p: np.ndarray) -> np.ndarray:
    """The draws of ``rng.choice(n, size=size, p=p)``, as int64: numpy's
    inverse-CDF lookup (the cumulative weights, one uniform per draw,
    ``searchsorted(side="right")``) with the lookups spread over the host's
    cores by ``torch.searchsorted``; numpy's own takes minutes at 2**22
    nodes."""
    cdf = p.cumsum()
    cdf /= cdf[-1]
    u = torch.from_numpy(rng.random(size))
    return torch.searchsorted(torch.from_numpy(cdf), u, right=True).numpy()


def powerlaw_graph(n: int, *, avg_degree: float = 8.0, alpha: float = 2.1,
                   seed: int = 0,
                   vectorized: Optional[bool] = None) -> CSRGraph:
    """Deterministic power-law digraph: out-degrees follow a truncated
    ``k^{-alpha}`` law, destinations are drawn preferentially, self-loops
    and duplicate edges are removed.

    ``vectorized=None`` keeps the per-node sampling loop (and its exact
    edge stream) below ``_VECTORIZE_MIN_N`` nodes and switches to one
    batched draw above it: the same degree law and popularity weights, a
    different (still seed-deterministic) edge stream."""
    if vectorized is None:
        vectorized = n >= _VECTORIZE_MIN_N
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    # out-degree targets: power-law weights over the permuted node ranks
    w = (np.arange(n, dtype=np.float64) + 1.0) ** (-1.0 / (alpha - 1.0))
    deg = np.maximum(1, np.round(avg_degree * w / w.mean())).astype(np.int64)
    deg = np.minimum(deg, max(1, n // 2))[order]
    # destination popularity: an independent permuted power law
    pop = w[rng.permutation(n)]
    p = pop / pop.sum()
    if vectorized:
        src_all = np.repeat(np.arange(n, dtype=np.int64), deg)
        dst_all = _choice(rng, n, int(deg.sum()), p)
        keep = src_all != dst_all                  # no self loops
        # dedupe (u, v) pairs, sorted by (v, u): row-sorted (by dst). A
        # sort and a neighbour test give np.unique's result; numpy 2.3's
        # np.unique takes minutes on 67 M keys
        pair = np.sort(dst_all[keep] * n + src_all[keep])
        pair = pair[np.concatenate([[True], pair[1:] != pair[:-1]])]
        src, dst = pair % n, pair // n
    else:
        srcs, dsts = [], []
        for u in range(n):
            d = rng.choice(n, size=int(deg[u]), p=p)   # with replacement;
            d = np.unique(d[d != u])                   # dedupe + no loops
            srcs.append(np.full(d.shape[0], u, np.int64))
            dsts.append(d)
        src = np.concatenate(srcs)
        dst = np.concatenate(dsts)
        order = np.lexsort((src, dst))                 # row-sorted (by dst)
        src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(dst, minlength=n))
    out_degree = np.bincount(src, minlength=n)
    return CSRGraph(n, indptr.astype(np.int32), src.astype(np.int32),
                    out_degree.astype(np.int32))


def bucket_edges(src, dst, n_pad: int, node_block: int, *,
                 edge_tile: int = EDGE_TILE
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bucket (E,) edge arrays by ``(dst_block, src_block)`` for the
    node-blocked push.

    Every bucket is sentinel-padded (id ``n_pad``, outside every block) to
    whole ``edge_tile`` tiles, so each tile lies in exactly one bucket;
    buckets are laid out dst-block-major. Returns ``(src, dst,
    tile_src_block, tile_dst_block)``: edge arrays of shape (T*edge_tile,)
    and the (T,) per-tile block tables, all int32 numpy."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    nb = n_pad // node_block
    if src.size == 0:                       # degenerate: one sentinel tile
        pad = np.full(edge_tile, n_pad, np.int32)
        return pad, pad.copy(), np.zeros(1, np.int32), np.zeros(1, np.int32)
    key = (dst // node_block) * nb + (src // node_block)
    order = np.argsort(key, kind="stable")
    src, dst, key = src[order], dst[order], key[order]
    uk, cnt = np.unique(key, return_counts=True)
    padded = np.maximum(edge_tile, -(-cnt // edge_tile) * edge_tile)
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    in_bucket = np.arange(src.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    pos = np.repeat(starts, cnt) + in_bucket
    total = int(padded.sum())
    out_src = np.full(total, n_pad, np.int32)
    out_dst = np.full(total, n_pad, np.int32)
    out_src[pos] = src
    out_dst[pos] = dst
    tiles_per = padded // edge_tile
    tile_db = np.repeat(uk // nb, tiles_per).astype(np.int32)
    tile_sb = np.repeat(uk % nb, tiles_per).astype(np.int32)
    return out_src, out_dst, tile_sb, tile_db


def graph_state(g: CSRGraph, *, with_bfs: bool = False, source: int = 0,
                edge_tile: int = EDGE_TILE,
                node_block: Optional[int] = None, device=None) -> dict:
    """The graph's tensors on ``device`` (the card unless given), as
    ``MemoryDomain`` classifies them once wrapped as ``{"graph": ...}``.

    ``dst`` is the CSR row expansion of ``indptr`` and ``src`` its
    ``indices``, tiled and padded with the sentinel ``n_pad``. With
    ``node_block`` set (a multiple of ``NODE_LANES``) the edges are
    bucketed by ``(dst_block, src_block)`` and the per-tile block tables
    are added under ``topology/blocks``."""
    dev = resolve_device(device)
    dst_rows = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    if node_block is None:
        n_pad = _round_up(max(g.n, 1), NODE_LANES)
        src, dst = pad_edges(torch.from_numpy(g.indices),
                             torch.from_numpy(dst_rows.astype(np.int32)),
                             n_pad, edge_tile=edge_tile)
        topology = {"src": src.to(dev), "dst": dst.to(dev)}
    else:
        if node_block % NODE_LANES:
            raise ValueError(f"node_block {node_block} must be a multiple "
                             f"of NODE_LANES ({NODE_LANES})")
        n_pad = _round_up(max(g.n, 1), node_block)
        bsrc, bdst, tsb, tdb = bucket_edges(g.indices, dst_rows, n_pad,
                                            node_block, edge_tile=edge_tile)
        topology = {
            "src": torch.from_numpy(bsrc).to(dev),
            "dst": torch.from_numpy(bdst).to(dev),
            "blocks": {
                "src_block": torch.from_numpy(tsb).to(dev),
                "dst_block": torch.from_numpy(tdb).to(dev),
                # layout marker: the block size is this leaf's *shape*
                # (times NODE_LANES), see node_block_of
                "bn_lanes": torch.zeros(node_block // NODE_LANES,
                                        dtype=torch.int32, device=dev),
            },
        }
    outdeg = np.zeros((1, n_pad), np.int32)
    outdeg[0, :g.n] = g.out_degree
    topology["outdeg"] = torch.from_numpy(outdeg).to(dev)
    rank = np.zeros((1, n_pad), np.float32)
    rank[0, :g.n] = np.float32(1.0 / g.n)
    state = {"topology": topology, "rank": {"rank": torch.from_numpy(
        rank).to(dev)}}
    if with_bfs:
        onehot = (np.arange(n_pad) == source).astype(np.int32)[None]
        state["frontier"] = {
            "frontier": torch.from_numpy(onehot).to(dev),
            "visited": torch.from_numpy(onehot.copy()).to(dev),
            "dist": torch.from_numpy(np.where(onehot > 0, 0, -1).astype(
                np.int32)).to(dev),
        }
    return state


def n_padded(state: dict) -> int:
    """Padded node-vector length of a ``graph_state``."""
    return int(state["rank"]["rank"].shape[1])


def node_block_of(state: dict) -> Optional[int]:
    """Node-block size of a ``graph_state``, or ``None`` for the dense
    layout, read from the ``bn_lanes`` marker's shape (no device read, and
    no dependence on corruptible payload bytes)."""
    blocks = state["topology"].get("blocks")
    if blocks is None:
        return None
    return int(blocks["bn_lanes"].shape[0]) * NODE_LANES
