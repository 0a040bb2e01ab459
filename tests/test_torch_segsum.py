"""Segment-sum push and frontier step of the PyTorch port against the JAX
reference (``repro.kernels.segsum``), on the CPU, where the port's wrappers
run their plain versions.

The reference runs as its own tests run it: its ``*_ref`` functions and its
Pallas kernels in interpret mode. Tolerances: float pushes are held to
rtol 1e-5 and atol 1e-7 x max|y| (a segment sum in another order rounds
differently); integer-valued inputs, which every order sums exactly, are
held bit for bit, and so is which edges drop. The frontier step is exact.
The reference's ``*_oracle`` pushes pin its TPU tile order and have no
counterpart in the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.generate import bucket_edges
from repro.kernels import segsum as jseg
from repro_torch.kernels import ref
from repro_torch.kernels import segsum as tseg

RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    atol = 1e-7 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dense_edges(seed: int, n: int, e: int, tile: int):
    """Sentinel-padded dst-sorted edges over n_pad nodes, both packages'."""
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    src = rng.integers(0, n, e)
    dst = np.sort(rng.integers(0, n, e))
    js, jd = jseg.pad_edges(jnp.asarray(src), jnp.asarray(dst), n_pad,
                            edge_tile=tile)
    ts, td = tseg.pad_edges(torch.from_numpy(src), torch.from_numpy(dst),
                            n_pad, edge_tile=tile)
    return rng, n_pad, (js, jd), (ts, td)


def _blocked(seed, n, e, bn, te, corrupt=False):
    """Random bucketed edges and block tables (numpy), optionally struck
    after bucketing: ids anywhere (negative and far out of range too) and
    one ``src_block`` entry, as ``test_graph_blocked._random_blocked``."""
    rng = np.random.default_rng(seed)
    n_pad = ((max(n, 1) + bn - 1) // bn) * bn
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    bsrc, bdst, tsb, tdb = bucket_edges(src, dst, n_pad, bn, edge_tile=te)
    if corrupt:
        bsrc, bdst, tsb = bsrc.copy(), bdst.copy(), tsb.copy()
        for _ in range(4):
            bsrc[rng.integers(0, bsrc.size)] = rng.integers(-n_pad, 4 * n_pad)
            bdst[rng.integers(0, bdst.size)] = rng.integers(-n_pad, 4 * n_pad)
        tsb[rng.integers(0, tsb.size)] = rng.integers(-8, 8 + n_pad // bn)
    return rng, n_pad, (bsrc, bdst, tsb, tdb)


# ----------------------------------------------------------- layout
def test_fit_edge_tile_matches_reference():
    for e in list(range(0, 600)) + [1024, 1536, 2048, 9973 * 2, 7919,
                                    56_632_832]:
        for max_tile in (128, 512):
            assert tseg.fit_edge_tile(e, max_tile) == \
                jseg.fit_edge_tile(e, max_tile), (e, max_tile)


@pytest.mark.parametrize("e,tile", [(0, 512), (1, 128), (511, 512),
                                    (512, 512), (1700, 256)])
def test_pad_edges_matches_reference(e, tile):
    _, _, (js, jd), (ts, td) = _dense_edges(e, 300, e, tile)
    assert ts.dtype == td.dtype == torch.int32
    _equal(ts, js)
    _equal(td, jd)


# ------------------------------------------------------- dense push
@pytest.mark.parametrize("seed,n,e,tile", [(0, 384, 1700, 128),
                                           (1, 300, 900, 256),
                                           (2, 128, 512, 512)])
def test_push_matches_ref_and_pallas(seed, n, e, tile):
    rng, n_pad, (js, jd), (ts, td) = _dense_edges(seed, n, e, tile)
    x = rng.random((1, n_pad)).astype(np.float32)
    y = tseg.edge_segment_push(ts, td, _t(x))
    assert y.dtype == torch.float32 and tuple(y.shape) == (1, n_pad)
    _close(y, jseg.edge_segment_push_ref(js, jd, jnp.asarray(x)))
    _close(y, jseg.edge_segment_push(js, jd, jnp.asarray(x),
                                     edge_tile=tile))


def test_push_drops_bad_ids_exactly():
    """Sentinel, negative and far out-of-range ids drop the same edges as
    in the reference: integer x sums exactly, so the results are equal."""
    rng, n_pad, (js, jd), _ = _dense_edges(3, 384, 1700, 128)
    src, dst = np.array(js), np.array(jd)
    hit = rng.choice(src.size, 64, replace=False)
    src[hit[:32]] = rng.integers(-4 * n_pad, 4 * n_pad, 32)
    dst[hit[32:]] = rng.integers(-4 * n_pad, 4 * n_pad, 32)
    x = rng.integers(0, 1000, (1, n_pad)).astype(np.float32)
    want = jseg.edge_segment_push_ref(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(x))
    _equal(tseg.edge_segment_push(_t(src), _t(dst), _t(x)),
           want)
    _close(tseg.edge_segment_push(_t(src), _t(dst), _t(x)),
           jseg.edge_segment_push(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(x), edge_tile=128))


def test_push_non_finite_x_follows_ref():
    """A non-finite x reaches only the nodes its edges land on, as in the
    ``_ref`` form. The Pallas one-hot form multiplies it by 0 everywhere
    and spreads NaN over every node: a reference trap, not followed."""
    rng, n_pad, (js, jd), (ts, td) = _dense_edges(4, 300, 1200, 128)
    x = rng.random((1, n_pad)).astype(np.float32)
    x[0, int(np.asarray(js)[0])] = np.inf
    x[0, int(np.asarray(js)[1])] = np.nan
    y = tseg.edge_segment_push(ts, td, _t(x)).numpy()
    want = np.asarray(jseg.edge_segment_push_ref(js, jd, jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(y), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(y), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(y[fin], want[fin], rtol=RTOL)
    assert 0 < int((~fin).sum()) < n_pad // 4
    pallas = np.asarray(jseg.edge_segment_push(js, jd, jnp.asarray(x),
                                               edge_tile=128))
    assert int(np.isnan(pallas).sum()) > int((~fin).sum())


# ----------------------------------------------------- blocked push
@pytest.mark.parametrize("seed,n,e,bn,te,corrupt", [
    (0, 300, 400, 128, 128, False), (1, 300, 400, 128, 128, True),
    (2, 200, 250, 256, 256, True), (3, 500, 2000, 128, 256, False),
    (4, 17, 9, 128, 128, True)])
def test_blocked_push_matches_ref_and_pallas(seed, n, e, bn, te, corrupt):
    rng, n_pad, arrs = _blocked(seed, n, e, bn, te, corrupt)
    x = rng.random((1, n_pad)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in arrs] + [jnp.asarray(x)]
    y = tseg.edge_segment_push_blocked(*map(_t, arrs), _t(x), node_block=bn)
    _close(y, jseg.edge_segment_push_blocked_ref(*jargs, node_block=bn))
    _close(y, jseg.edge_segment_push_blocked(*jargs, node_block=bn))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_blocked_push_drops_the_same_edges(seed):
    """Struck ids (negative, far out of range) and a struck ``src_block``
    entry: with integer x the port equals the reference exactly, so the
    same edges dropped or rerouted; blocks no edge reaches are exactly 0."""
    rng, n_pad, arrs = _blocked(seed, 600, 1500, 128, 128, corrupt=True)
    x = rng.integers(1, 100, (1, n_pad)).astype(np.float32)
    want = jseg.edge_segment_push_blocked_ref(
        *[jnp.asarray(a) for a in arrs], jnp.asarray(x), node_block=128)
    y = tseg.edge_segment_push_blocked(*map(_t, arrs), _t(x),
                                       node_block=128)
    _equal(y, want)
    ones = tseg.edge_segment_push_blocked(
        *map(_t, arrs), torch.ones((1, n_pad)), node_block=128)
    _equal(ones, jseg.edge_segment_push_blocked_ref(
        *[jnp.asarray(a) for a in arrs], jnp.ones((1, n_pad)),
        node_block=128))


def test_blocked_push_struck_dst_block_follows_ref():
    """A struck ``dst_block`` entry that breaks the dst-block-major order:
    the port sums every in-bucket edge, as ``_ref`` does. The Pallas
    kernel's first-visit test re-zeroes the block it revisits and loses
    the earlier tiles' sums: a reference trap, not followed."""
    n_pad, bn, te = 256, 128, 128
    rng = np.random.default_rng(8)
    src = rng.integers(0, n_pad, 400)
    dst = rng.integers(0, n_pad, 400)
    bsrc, bdst, tsb, tdb = bucket_edges(src, dst, n_pad, bn, edge_tile=te)
    assert list(tdb) == sorted(tdb) and tdb[0] == 0 and tdb[-1] == 1
    tdb = tdb.copy()
    tdb[-1] = 0                  # block 0 again after block 1's tiles
    arrs = (bsrc, bdst, tsb, tdb)
    x = rng.integers(1, 50, (1, n_pad)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in arrs] + [jnp.asarray(x)]
    want = np.asarray(jseg.edge_segment_push_blocked_ref(*jargs,
                                                         node_block=bn))
    y = tseg.edge_segment_push_blocked(*map(_t, arrs), _t(x), node_block=bn)
    _equal(y, want)
    pallas = np.asarray(jseg.edge_segment_push_blocked(*jargs,
                                                       node_block=bn))
    assert not np.array_equal(pallas[0, :bn], want[0, :bn])


def test_blocked_push_non_finite_x_follows_ref():
    rng, n_pad, arrs = _blocked(9, 300, 600, 128, 128)
    x = rng.random((1, n_pad)).astype(np.float32)
    x[0, int(arrs[0][0])] = np.nan
    y = tseg.edge_segment_push_blocked(*map(_t, arrs), _t(x),
                                       node_block=128).numpy()
    want = np.asarray(jseg.edge_segment_push_blocked_ref(
        *[jnp.asarray(a) for a in arrs], jnp.asarray(x), node_block=128))
    np.testing.assert_array_equal(np.isnan(y), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(y[fin], want[fin], rtol=RTOL)
    assert 0 < int(np.isnan(want).sum()) < n_pad // 4


# ------------------------------------ the kernels' K-edge group shapes
def _hub_edges(seed: int, n_pad: int, e: int):
    """Dst-sorted edges with runs of 1,300 and 600 edges into two hubs
    (longer than the 512 edges a tile or a warp's groups hold), sentinel
    padding at the end and a few struck ids, as numpy int32."""
    rng = np.random.default_rng(seed)
    dst = np.sort(np.concatenate([rng.integers(0, n_pad - 1, e - 1900),
                                  np.full(1300, 7), np.full(600, 200)]))
    src = rng.integers(0, n_pad - 1, e)
    src[-40:] = dst[-40:] = n_pad
    hit = rng.choice(e - 40, 16, replace=False)
    src[hit[:8]] = rng.integers(-4 * n_pad, 4 * n_pad, 8)
    dst[hit[8:]] = rng.integers(-4 * n_pad, 4 * n_pad, 8)
    return rng, src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("start,stop", [(1, None), (2, None), (3, -5),
                                        (0, -3), (1, -1), (5, 21), (9, 10)])
def test_push_on_slices_matches_ref(start, stop):
    """Edge arrays that start off a 16-byte boundary (``src[1:]``) or end
    off a whole group (counts not a multiple of 4 or 16), runs of up to
    1,300 edges: integer x equal to the reference, float x within RTOL."""
    rng, src, dst = _hub_edges(10 + start, 384, 4004)
    s, d = src[start:stop], dst[start:stop]
    assert s.size % 4 or start % 4
    ts, td = torch.from_numpy(src)[start:stop], torch.from_numpy(dst)[
        start:stop]
    assert ts.is_contiguous() and ts.storage_offset() == start
    for x, check in ((rng.integers(0, 8, (1, 384)).astype(np.float32),
                      _equal),
                     (rng.random((1, 384)).astype(np.float32), _close)):
        check(tseg.edge_segment_push(ts, td, _t(x)),
              jseg.edge_segment_push_ref(jnp.asarray(s), jnp.asarray(d),
                                         jnp.asarray(x)))


def test_push_with_src_and_dst_on_different_alignments():
    """src and dst sliced at different offsets (``src[1:-1]``, ``dst[2:]``):
    the kernel then loads every id alone; the sums are the reference's."""
    rng, src, dst = _hub_edges(20, 384, 2500)
    x = rng.integers(0, 8, (1, 384)).astype(np.float32)
    want = jseg.edge_segment_push_ref(jnp.asarray(src[1:-1]),
                                      jnp.asarray(dst[2:]), jnp.asarray(x))
    _equal(tseg.edge_segment_push(torch.from_numpy(src)[1:-1],
                                  torch.from_numpy(dst)[2:], _t(x)), want)


@pytest.mark.parametrize("te,offset,moved", [
    (3, 0, 8), (17, 0, 4), (100, 0, 16), (100, 1, 16), (1000, 0, 1),
    (512, 0, 3), (512, 1, 3), (16, 3, 0)])
def test_blocked_push_odd_tiles_and_dropped_tiles_match_ref(te, offset,
                                                             moved):
    """Tiles of any size (the kernel's general tile path), edge arrays from
    ``offset`` with the tiles counted from there (the tables one shorter),
    a 1,300-edge run into one node, and ``moved`` tiles whose
    ``dst_block`` moved one block on, so every edge of theirs drops:
    integer x equal to the reference."""
    rng = np.random.default_rng(te + offset)
    n_pad, bn = 512, 128
    src = rng.integers(0, n_pad, 3000)
    dst = np.concatenate([rng.integers(0, n_pad, 1700), np.full(1300, 300)])
    bsrc, bdst, tsb, tdb = bucket_edges(src, dst, n_pad, bn, edge_tile=te)
    tdb = tdb.copy()
    hit = rng.choice(tdb.size, moved, replace=False)
    tdb[hit] = (tdb[hit] + 1) % (n_pad // bn)
    t = tsb.size - (offset > 0)
    arrs = (bsrc[offset:offset + t * te], bdst[offset:offset + t * te],
            tsb[:t], tdb[:t])
    x = rng.integers(0, 8, (1, n_pad)).astype(np.float32)
    want = jseg.edge_segment_push_blocked_ref(
        *[jnp.asarray(a) for a in arrs], jnp.asarray(x), node_block=bn)
    y = tseg.edge_segment_push_blocked(
        torch.from_numpy(bsrc)[offset:offset + t * te],
        torch.from_numpy(bdst)[offset:offset + t * te],
        _t(tsb[:t]), _t(tdb[:t]), _t(x), node_block=bn)
    _equal(y, want)
    assert float(np.asarray(want)[0, 300]) > 0


def test_blocked_push_every_tile_dropped_is_zero():
    """Every tile's ``dst_block`` moved one block on: no edge counts, and
    every node comes out exactly 0, as in the reference."""
    rng, n_pad, arrs = _blocked(11, 500, 1200, 128, 100)
    bsrc, bdst, tsb, tdb = arrs
    tdb = (tdb + 1) % (n_pad // 128)
    x = rng.random((1, n_pad)).astype(np.float32)
    want = jseg.edge_segment_push_blocked_ref(
        jnp.asarray(bsrc), jnp.asarray(bdst), jnp.asarray(tsb),
        jnp.asarray(tdb), jnp.asarray(x), node_block=128)
    y = tseg.edge_segment_push_blocked(_t(bsrc), _t(bdst), _t(tsb),
                                       _t(tdb), _t(x), node_block=128)
    _equal(y, want)
    assert not y.any()


def test_blocked_push_refuses_2_32_edges():
    """The blocked kernel finds tiles in 32-bit arithmetic; the wrapper
    refuses 2**32 edges (meta tensors: nothing is allocated)."""
    e = torch.empty(1 << 32, dtype=torch.int32, device="meta")
    tiles = torch.empty(1 << 23, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=r"2\*\*32"):
        tseg.edge_segment_push_blocked(e, e, tiles, tiles,
                                       torch.empty((1, 256), device="meta"),
                                       node_block=128)


# ---------------------------------------------------- frontier step
@pytest.mark.parametrize("n,level", [(128, 1), (1408, 7), (4096, 2)])
def test_frontier_update_matches_oracle_and_pallas(n, level):
    rng = np.random.default_rng(n)
    pushed = (rng.random((1, n)) * (rng.random((1, n)) < 0.3)).astype(
        np.float32)
    pushed[0, :3] = [np.nan, -1.0, np.inf]
    visited = (rng.random((1, n)) < 0.4).astype(np.int32)
    dist = np.where(visited > 0, rng.integers(0, level, (1, n)),
                    -1).astype(np.int32)
    jargs = (jnp.asarray(pushed), jnp.asarray(visited), jnp.asarray(dist))
    got = tseg.frontier_update(_t(pushed), _t(visited), _t(dist), level)
    for g, w, p in zip(got, jseg.frontier_update_oracle(*jargs, level),
                       jseg.frontier_update(*jargs, level)):
        assert g.dtype == torch.int32
        _equal(g, w)
        _equal(g, p)


# ---------------------------------------------------------- wrappers
_E = torch.zeros(512, dtype=torch.int32)
_X = torch.zeros((1, 256))
_TILES = torch.zeros(4, dtype=torch.int32)
_I32 = torch.zeros((1, 256), dtype=torch.int32)
_BAD_CALLS = {
    "push int64 src": lambda: tseg.edge_segment_push(_E.long(), _E, _X),
    "push src/dst lengths": lambda: tseg.edge_segment_push(_E, _E[:256],
                                                           _X),
    "push 2-d edges": lambda: tseg.edge_segment_push(
        _E.reshape(2, 256), _E.reshape(2, 256), _X),
    "push float64 x": lambda: tseg.edge_segment_push(_E, _E, _X.double()),
    "push N not lanes": lambda: tseg.edge_segment_push(
        _E, _E, torch.zeros((1, 200))),
    "push 1-d x": lambda: tseg.edge_segment_push(_E, _E, torch.zeros(256)),
    "push 2-row x": lambda: tseg.edge_segment_push(
        _E, _E, torch.zeros((2, 256))),
    "push strided src": lambda: tseg.edge_segment_push(
        torch.zeros(1024, dtype=torch.int32)[::2], _E, _X),
    "blocked int64 table": lambda: tseg.edge_segment_push_blocked(
        _E, _E, _TILES.long(), _TILES, _X, node_block=128),
    "blocked table lengths": lambda: tseg.edge_segment_push_blocked(
        _E, _E, _TILES, _TILES[:3], _X, node_block=128),
    "blocked edges not tiles": lambda: tseg.edge_segment_push_blocked(
        _E, _E, _TILES[:3], _TILES[:3], _X, node_block=128),
    "blocked N not blocks": lambda: tseg.edge_segment_push_blocked(
        _E, _E, _TILES, _TILES, _X, node_block=96),
    "blocked zero block": lambda: tseg.edge_segment_push_blocked(
        _E, _E, _TILES, _TILES, _X, node_block=0),
    "frontier int64 visited": lambda: tseg.frontier_update(
        _X, _I32.long(), _I32, 1),
    "frontier int pushed": lambda: tseg.frontier_update(_X.int(), _I32,
                                                        _I32, 1),
    "frontier lengths": lambda: tseg.frontier_update(_X, _I32,
                                                     _I32[:, :128], 1),
}


@pytest.mark.parametrize("case", sorted(_BAD_CALLS))
def test_wrappers_reject_wrong_dtypes_and_shapes(case):
    with pytest.raises(ValueError):
        _BAD_CALLS[case]()


def test_plain_versions_on_cpu_and_no_device_mix():
    """CPU tensors take the plain versions (no kernel is built or counted);
    tensors on two devices are refused."""
    from repro_torch.kernels import _build
    before = dict(_build.LAUNCHES)
    src = torch.tensor([0, 1, 256, -3] * 128, dtype=torch.int32)
    dst = torch.tensor([1, 1, 2, 2] * 128, dtype=torch.int32)
    x = torch.arange(256, dtype=torch.float32).reshape(1, 256)
    y = tseg.edge_segment_push(src, dst, x)
    assert torch.equal(y, ref.edge_segment_push_ref(src, dst, x))
    assert y[0, 1].item() == 128.0 and y[0, 2].item() == 0.0
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError):
        _build.on_card(x, torch.empty(1, device="meta"))
