"""Segment-sum push SpMV and the BFS frontier step: the compute core of the
graph workload (``repro_torch.graph``).

Counterpart of ``repro.kernels.segsum``. A CSR graph is expanded into edge
arrays ``src``/``dst`` of shape (E,) int32, sorted by destination and padded
to whole edge tiles with the sentinel id ``n_pad``, which matches no node.
Node vectors are (1, N) with N a multiple of ``NODE_LANES``.

On CUDA tensors the wrappers launch the kernels of ``csrc/segsum.cu``; on
CPU tensors they run the plain versions of ``ref.py``. Both sum in
float64 and round once to float32: the kernels add with atomics, in an
order that changes from run to run, so the two agree to within one ulp,
and exactly when every partial sum is an integer below 2**24. Which edges
drop is the same in both.

The reference's ``*_oracle`` push functions replay the TPU kernel's
one-hot tile order to pin its bits; that order means nothing here, so they
have no counterpart.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref

EDGE_TILE = 512          # edges per tile; a multiple of the 128-lane tile
NODE_LANES = 128         # node vectors padded to a multiple of this


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def fit_edge_tile(e: int, max_tile: int = EDGE_TILE) -> int:
    """Largest tile <= ``max_tile`` dividing the padded edge count ``e``, so
    arrays padded with any ``edge_tile`` recover a valid tiling."""
    if e <= 0:
        return 1
    if e <= max_tile:
        return e
    if e % max_tile == 0:
        return max_tile
    # largest divisor of e that is <= max_tile, via trial division: every
    # divisor d <= sqrt(e) also names its cofactor e // d
    best = 1
    d = 1
    while d * d <= e:
        if e % d == 0:
            for cand in (d, e // d):
                if best < cand <= max_tile:
                    best = cand
        d += 1
    return best


def pad_edges(src: torch.Tensor, dst: torch.Tensor, n_pad: int, *,
              edge_tile: int = EDGE_TILE):
    """Pad (E,) edge arrays to a multiple of ``edge_tile`` (at least one
    tile) with the sentinel id ``n_pad``; returns them as int32."""
    e = src.shape[0]
    pad = max(edge_tile, _round_up(e, edge_tile)) - e
    if pad:
        src = torch.cat([src, src.new_full((pad,), n_pad)])
        dst = torch.cat([dst, dst.new_full((pad,), n_pad)])
    return src.to(torch.int32), dst.to(torch.int32)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"expected a contiguous {dim}-d {dtype} {name}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_nodes(x: torch.Tensor, name: str, dtype: torch.dtype) -> int:
    _check(x, name, dtype, 2)
    if x.shape[0] != 1 or x.shape[1] % NODE_LANES:
        raise ValueError(f"{name} must be (1, N) with N a multiple of "
                         f"{NODE_LANES}, got {tuple(x.shape)}")
    return x.shape[1]


def _check_edges(src: torch.Tensor, dst: torch.Tensor) -> int:
    _check(src, "src", torch.int32, 1)
    _check(dst, "dst", torch.int32, 1)
    if src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)} differ")
    return src.shape[0]


def edge_segment_push(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor
                      ) -> torch.Tensor:
    """src, dst: (E,) int32, sentinel-padded; x: (1, N) float32,
    N % 128 == 0. Returns y (1, N) float32 with
    ``y[j] = sum_{e: dst[e]==j} x[src[e]]``; ids outside [0, N) drop. E
    need not be whole tiles, and the edge arrays may start anywhere (a
    slice such as ``src[1:]``)."""
    e = _check_edges(src, dst)
    n = _check_nodes(x, "x", torch.float32)
    if not _build.on_card(src, dst, x):
        return ref.edge_segment_push_ref(src, dst, x)
    y = torch.empty_like(x)
    acc = torch.empty(n, dtype=torch.float64, device=x.device)
    _build.launch("segsum_push", src.data_ptr(), dst.data_ptr(),
                  x.data_ptr(), y.data_ptr(), acc.data_ptr(), e, n)
    return y


def edge_segment_push_blocked(src: torch.Tensor, dst: torch.Tensor,
                              src_block: torch.Tensor,
                              dst_block: torch.Tensor, x: torch.Tensor, *,
                              node_block: int) -> torch.Tensor:
    """Node-blocked push: ``y[j] = sum_{e in-bucket: dst[e]==j} x[src[e]]``.

    src, dst: (T*TE,) int32 global node ids, bucketed by
    ``(dst_block, src_block)`` and sentinel-padded per bucket so every TE
    tile lies in one bucket; src_block, dst_block: (T,) int32 per-tile
    block coordinates; x: (1, N) float32 with N % node_block == 0.

    An edge counts only if its src lies in its tile's source block and its
    dst in its destination block, the coordinates clipped to the node
    vector's blocks, so a struck id or table drops or reroutes an edge and
    never reads outside ``x``. Blocks no edge reaches come out exactly 0.
    The kernel finds tiles in 32-bit arithmetic: fewer than 2**32 edges.
    """
    e = _check_edges(src, dst)
    if e >> 32:
        raise ValueError(f"{e} edges: the blocked push takes fewer than "
                         "2**32")
    n = _check_nodes(x, "x", torch.float32)
    _check(src_block, "src_block", torch.int32, 1)
    _check(dst_block, "dst_block", torch.int32, 1)
    t = src_block.shape[0]
    if dst_block.shape[0] != t or t == 0 or e % t:
        raise ValueError(f"{e} edges do not split into the {t} tiles of "
                         f"src_block and {dst_block.shape[0]} of dst_block")
    bn = node_block
    if bn <= 0 or n % bn:
        raise ValueError(f"N = {n} is not whole blocks of {bn}")
    if not _build.on_card(src, dst, src_block, dst_block, x):
        return ref.edge_segment_push_blocked_ref(src, dst, src_block,
                                                 dst_block, x, node_block=bn)
    y = torch.empty_like(x)
    acc = torch.empty(n, dtype=torch.float64, device=x.device)
    _build.launch("segsum_push_blocked", src.data_ptr(), dst.data_ptr(),
                  src_block.data_ptr(), dst_block.data_ptr(), x.data_ptr(),
                  y.data_ptr(), acc.data_ptr(), e, e // t, n // bn, bn)
    return y


def frontier_update(pushed: torch.Tensor, visited: torch.Tensor,
                    dist: torch.Tensor, level: int):
    """BFS step: nodes reached by ``pushed`` frontier mass and not yet
    visited become the next frontier, stamped with ``level`` in ``dist``.

    pushed (1, N) float32; visited, dist (1, N) int32. Returns (frontier,
    visited, dist), all (1, N) int32."""
    n = _check_nodes(pushed, "pushed", torch.float32)
    for t, name in ((visited, "visited"), (dist, "dist")):
        if _check_nodes(t, name, torch.int32) != n:
            raise ValueError(f"{name} {tuple(t.shape)} is not (1, {n})")
    if not _build.on_card(pushed, visited, dist):
        return ref.frontier_update_ref(pushed, visited, dist, level)
    outs = tuple(torch.empty_like(visited) for _ in range(3))
    _build.launch("frontier_update", pushed.data_ptr(), visited.data_ptr(),
                  dist.data_ptr(), *(o.data_ptr() for o in outs), int(level),
                  n)
    return outs
