"""Plain PyTorch versions of the port's kernels: the tier codecs, with the
semantics of ``repro.kernels.ref``, and the graph push and frontier step,
with those of ``repro.kernels.segsum``'s ``*_ref`` and ``*_oracle``
functions.

Words are int64 tensors, one 64-bit word per element, holding the same bits
as the reference's ``(lo, hi)`` uint32 lane pairs. PyTorch on the CPU has
no popcount and no shifts on unsigned 32-bit integers, so these functions
split a word into its 32-bit halves held in int64 (where an arithmetic
shift of a non-negative value is a logical one) and fold parities by hand.

The BCH and burst scrubs decode only the words whose syndrome is nonzero,
gathered by index: the same function as decoding every word, without a
Chien search's ~80 passes over a clean buffer. The uint16 sidecars of those
tiers are widened to int64 before any arithmetic (PyTorch on the CPU has no
comparisons on uint16) and narrowed at the end.

On the CPU the kernel wrappers run these. On the card only
``chip_smoke.py`` runs them, to hold each kernel against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import hsiao

_M32 = 0xFFFFFFFF


def _halves(words: torch.Tensor):
    return words & _M32, (words >> 32) & _M32


def _parity32(x: torch.Tensor) -> torch.Tensor:
    """Parity (0/1, int64) of each value in [0, 2**32)."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def _checks(words: torch.Tensor, mask_lo, mask_hi) -> torch.Tensor:
    """Check bit j of each word (int64) is the parity of
    ``word & (mask_hi[j] << 32 | mask_lo[j])``."""
    lo, hi = _halves(words)
    ecc = torch.zeros_like(words)
    for j, (mlo, mhi) in enumerate(zip(mask_lo, mask_hi)):
        ecc |= _parity32((lo & int(mlo)) ^ (hi & int(mhi))) << j
    return ecc


def secded_encode_ref(words: torch.Tensor) -> torch.Tensor:
    """The 8 Hsiao check bits of each word, as uint8 of the words' shape."""
    return _checks(words, hsiao.MASK_LO, hsiao.MASK_HI).to(torch.uint8)


def secded_scrub_ref(words: torch.Tensor, ecc: torch.Tensor):
    """Syndrome-decode and correct.

    Returns ``(words', ecc' uint8, corrected, uncorrectable)``, the last two
    boolean per word. An uncorrectable word keeps its data and its code.
    """
    synd = secded_encode_ref(words).to(torch.int64) ^ ecc.to(torch.int64)
    action = torch.as_tensor(hsiao.SYNDROME_ACTION, dtype=torch.int64,
                             device=words.device)[synd]
    data = (action >= 0) & (action < hsiao.N_DATA)
    flip = torch.where(data, torch.bitwise_left_shift(
        torch.ones_like(action), action.clamp(0, 63)), 0)
    unc = action == -2
    words2 = words ^ flip
    ecc2 = torch.where(unc, ecc, secded_encode_ref(words2))
    corrected = (synd != 0) & ~unc
    return words2, ecc2, corrected, unc


def _match_columns(s: torch.Tensor, data_cols, r: int, bit_of=None):
    """Single-error match of syndromes ``s`` against the data columns and
    the r check columns. Returns ``(matched bool, data flips int64)``; data
    column i flips word bit ``bit_of(i)`` (default i), a check column
    flips nothing."""
    matched = torch.zeros_like(s, dtype=torch.bool)
    flip = torch.zeros_like(s)
    for i, col in enumerate(data_cols):
        eq = s == col
        matched |= eq
        flip |= eq.to(torch.int64) << (i if bit_of is None else bit_of(i))
    for j in range(r):
        matched |= s == (1 << j)
    return matched, flip


def _gf_mulx(code, v: torch.Tensor) -> torch.Tensor:
    """v * alpha in GF(2^m)."""
    full = (1 << code.m) - 1
    top = (v >> (code.m - 1)) & 1
    return ((v << 1) & full) ^ (top * (code.poly & full))


def _gf_mul(code, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b in GF(2^m), m Russian-peasant steps."""
    res = torch.zeros_like(a)
    for _ in range(code.m):
        res ^= torch.where((b & 1) != 0, a, 0)
        b = b >> 1
        a = _gf_mulx(code, a)
    return res


def _chien_double(code, s: torch.Tensor):
    """Two-error location from syndromes ``s`` (t=2): ``(ok, data flips)``,
    ok where S1 != 0 and the locator has exactly two roots among the n
    codeword degrees. Roots at check degrees (< r) flip no data bit."""
    s1 = torch.zeros_like(s)
    s3 = torch.zeros_like(s)
    for j in range(code.r):
        sel = (s >> j) & 1
        s1 ^= sel * code.alpha1[j]
        s3 ^= sel * code.alpha3[j]
    q = _gf_mul(code, s1, s1)                       # S1^2 * alpha^p
    t = s3 ^ _gf_mul(code, q, s1)                   # S3 + S1^3
    w = s1                                          # S1 * alpha^{2p}
    nroots = torch.zeros_like(s)
    flip = torch.zeros_like(s)
    for p in range(code.n):
        root = ((w ^ q ^ t) == 0).to(torch.int64)
        nroots += root
        if p >= code.r:
            flip |= root << (p - code.r)
        w = _gf_mulx(code, _gf_mulx(code, w))
        q = _gf_mulx(code, q)
    return (s1 != 0) & (nroots == 2), flip


def _scrub_nonzero(words, ecc, checks, decode):
    """Shared scrub frame of the BCH and burst codes. ``checks(words)`` is
    the code's encode (int64); ``decode(s)`` maps nonzero syndromes to
    ``(corrected, uncorrectable, data flips)``, flips zero where
    uncorrectable. Returns ``(words', ecc' uint16, corrected,
    uncorrectable)``, the last two boolean per word."""
    e = ecc.to(torch.int64).reshape(-1)
    fresh = checks(words).reshape(-1)
    s = fresh ^ e
    idx = torch.nonzero(s).squeeze(1)
    corr_g, unc_g, flip = decode(s[idx])
    words2 = words.clone().reshape(-1)
    words2[idx] ^= flip
    ecc2 = fresh
    ecc2[idx] = torch.where(unc_g, e[idx], checks(words2[idx]))
    corrected = torch.zeros_like(s, dtype=torch.bool)
    uncorrectable = torch.zeros_like(corrected)
    corrected[idx] = corr_g
    uncorrectable[idx] = unc_g
    return (words2.reshape(words.shape), ecc2.to(torch.uint16).reshape(
        words.shape), corrected.reshape(words.shape),
        uncorrectable.reshape(words.shape))


def bch_encode_ref(words: torch.Tensor, code) -> torch.Tensor:
    """The r check bits of shortened-BCH ``code`` for each word, as uint16
    of the words' shape."""
    return _checks(words, code.mask_lo, code.mask_hi).to(torch.uint16)


def bch_scrub_ref(words: torch.Tensor, ecc: torch.Tensor, code):
    """Syndrome-decode and correct under ``code``.

    A syndrome matching one column is a single error (a check column flips
    no data). For t=2, a syndrome of even weight (with the parity factor)
    or one matching no column (without it) goes to the Chien search, and
    two roots flip both bits. Anything else is uncorrectable: data and
    code kept. Returns ``(words', ecc' uint16, corrected,
    uncorrectable)``, the last two boolean per word.
    """
    def decode(s):
        single, flip = _match_columns(s, code.data_cols, code.r)
        corrected = single
        if code.t == 2:
            cand = (_parity32(s) == 0) if code.parity else ~single
            ci = torch.nonzero(cand).squeeze(1)
            ok, flip2 = _chien_double(code, s[ci])
            flip[ci] |= torch.where(ok, flip2, 0)
            corrected = corrected.clone()
            corrected[ci] |= ok
        return corrected, ~corrected, flip

    return _scrub_nonzero(
        words, ecc, lambda w: _checks(w, code.mask_lo, code.mask_hi), decode)


def burst_encode_ref(words: torch.Tensor, mask_lo, mask_hi) -> torch.Tensor:
    """The 14 interleaved SEC-DAEC check bits of each word, as uint16:
    check bit j is the parity of the word under ``(mask_lo[j],
    mask_hi[j])``, the sub-code masks spread onto the even (A) and odd (B)
    data bits."""
    return _checks(words, mask_lo, mask_hi).to(torch.uint16)


def burst_scrub_ref(words: torch.Tensor, ecc: torch.Tensor, mask_lo,
                    mask_hi, sub_code):
    """Two t=1 sub-decodes under ``sub_code``, sub-code A (check bits
    0..r-1) over the even data bits and B (r..2r-1) over the odd ones. If
    either is uncorrectable the word and its code are kept. Returns
    ``(words', ecc' uint16, corrected, uncorrectable)``, the last two
    boolean per word."""
    cols, r = sub_code.data_cols, sub_code.r
    sub = (1 << r) - 1

    def decode(s):
        sa, sb = s & sub, (s >> r) & sub
        ma, fa = _match_columns(sa, cols, r, lambda i: 2 * i)
        mb, fb = _match_columns(sb, cols, r, lambda i: 2 * i + 1)
        unc = ((sa != 0) & ~ma) | ((sb != 0) & ~mb)
        corrected = ((sa != 0) | (sb != 0)) & ~unc
        return corrected, unc, torch.where(unc, 0, fa | fb)

    return _scrub_nonzero(
        words, ecc, lambda w: _checks(w, mask_lo, mask_hi), decode)


def parity_bits(words: torch.Tensor) -> torch.Tensor:
    """Parity (0/1, int64) of each 64-bit word."""
    lo, hi = _halves(words)
    return _parity32(lo ^ hi)


def parity_encode_ref(words: torch.Tensor) -> torch.Tensor:
    """1 parity bit per word, packed 8 words per byte: (..., W) int64 ->
    (..., W // 8) uint8, bit k of byte b for word 8b+k."""
    bits = parity_bits(words)
    grp = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
    return (grp << torch.arange(8, device=words.device)).sum(-1).to(
        torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Packed bits (..., W // 8) uint8 -> (..., W) bool."""
    bits = (packed.to(torch.int64)[..., None]
            >> torch.arange(8, device=packed.device)) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,)).bool()


def parity_check_ref(words: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """Per-word parity-error mask (..., W) bool against stored parity."""
    return unpack_bits(parity_encode_ref(words) ^ par)


def bitflip_ref(words: torch.Tensor, word_idx: torch.Tensor,
                bit_idx: torch.Tensor) -> torch.Tensor:
    """Flip bit ``bit_idx[e]`` of flat word ``word_idx[e]`` for each strike.

    Returns new words. ``word_idx < 0`` is an inactive slot; a word past the
    buffer or a bit outside [0, 64) drops; duplicate strikes cancel.
    """
    flat = words.reshape(-1)
    w = word_idx.to(device=words.device, dtype=torch.int64).reshape(-1)
    b = bit_idx.to(device=words.device, dtype=torch.int64).reshape(-1)
    ok = (w >= 0) & (w < flat.numel()) & (b >= 0) & (b < 64)
    key, counts = torch.unique(w[ok] * 64 + b[ok], return_counts=True)
    key = key[counts % 2 == 1]              # an even number of flips cancels
    hit, inv = torch.unique(key // 64, return_inverse=True)
    # distinct bits of one word: their sum is their OR (no carries)
    masks = torch.zeros_like(hit).index_add_(
        0, inv, torch.bitwise_left_shift(torch.ones_like(key), key % 64))
    out = flat.clone()
    out[hit] ^= masks
    return out.reshape(words.shape)


# ------------------------------------------------------- graph kernels
def _segment_sum(contrib: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Sum ``contrib`` into ``n + 1`` bins by ``seg`` (bin ``n`` takes the
    dropped edges) and return the first ``n`` as (1, n).

    The sums are taken in float64 and rounded once to ``contrib``'s dtype,
    as the push kernels take them, so the order of the additions does not
    show: a float32 sum over a hub's ~10**6 in-edges, added one by one,
    drifts by some 2e-5 of its value."""
    y = torch.zeros(n + 1, dtype=torch.float64, device=contrib.device)
    y.index_add_(0, seg, contrib.to(torch.float64))
    return y[:n].to(contrib.dtype).reshape(1, n)


def edge_segment_push_ref(src: torch.Tensor, dst: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """``y[j] = sum_{e: dst[e]==j} x[src[e]]`` for x (1, n): a masked
    gather, then a segment sum. An edge with an id outside [0, n) (the
    sentinel padding, a struck or negative id) drops."""
    n = x.shape[1]
    src, dst = src.long(), dst.long()
    src_ok = (src >= 0) & (src < n)
    contrib = torch.where(src_ok, x[0, src.clamp(0, n - 1)], 0.0)
    seg = torch.where((dst >= 0) & (dst < n), dst, n)
    return _segment_sum(contrib, seg, n)


def edge_segment_push_blocked_ref(src: torch.Tensor, dst: torch.Tensor,
                                  src_block: torch.Tensor,
                                  dst_block: torch.Tensor, x: torch.Tensor, *,
                                  node_block: int) -> torch.Tensor:
    """The node-blocked push: edge e of tile t counts only if its src lies
    in source block ``src_block[t]`` and its dst in destination block
    ``dst_block[t]``, the block coordinates clipped to the node vector's
    blocks; any other edge drops."""
    bn = node_block
    n = x.shape[1]
    t = src_block.shape[0]
    te = src.shape[0] // t
    nb = n // bn
    sb = src_block.long().clamp(0, nb - 1).repeat_interleave(te)
    db = dst_block.long().clamp(0, nb - 1).repeat_interleave(te)
    src, dst = src.long(), dst.long()
    src_ok = (src >= sb * bn) & (src < (sb + 1) * bn)
    dst_ok = (dst >= db * bn) & (dst < (db + 1) * bn)
    contrib = torch.where(src_ok, x[0, src.clamp(0, n - 1)], 0.0)
    return _segment_sum(contrib, torch.where(dst_ok, dst, n), n)


def frontier_update_ref(pushed: torch.Tensor, visited: torch.Tensor,
                        dist: torch.Tensor, level: int):
    """One BFS step: nodes reached by ``pushed`` mass and not yet visited
    become the frontier, stamped with ``level``. Returns (frontier,
    visited, dist), all int32."""
    newly = ((pushed > 0) & (visited == 0)).to(torch.int32)
    return newly, visited | newly, torch.where(newly > 0, level, dist)
