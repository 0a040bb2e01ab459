"""Shortened-BCH codes over packed words: the construction behind the
DEC-TED and BURST tiers, and the encode/scrub wrappers around the CUDA
kernels of ``csrc/bch.cu``.

Counterpart of ``repro.kernels.bch``. The construction (``make_code`` and
its helpers) is a copy of the reference's: plain ints, no framework, so
the tables are equal by construction (``tests/test_torch_ecc.py`` holds
them field by field). Instances in use:

  * ``make_code(64, 2, 7, True)``: the (79,64) DEC-TED code of
    ``kernels/dected.py``;
  * ``make_code(32, 1, 6, True)``: the (39,32) sub-code that
    ``kernels/burst.py`` interleaves twice;
  * ``make_code(64, 1, 7, True)``: BCH(72,64), a t=1 conformance instance.

Data bit i of a 64-bit word sits at polynomial degree r+i and check bit j
at degree j; encode is r masked-popcount parities. Scrub computes the
syndrome, matches single columns, and for t=2 locates double errors with a
Chien search over the n codeword degrees (see ``ref.bch_scrub_ref``, whose
function the kernel computes bit for bit).

On a CUDA tensor the wrappers launch the kernels, with the code passed by
value as a launch argument; on a CPU tensor they run the plain versions of
``ref.py``. The sidecar is uint16, so the port takes codes with r <= 16
check bits (every instance above).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

_PRIMITIVE_POLYS = {
    5: 0b100101,            # x^5 + x^2 + 1
    6: 0b1000011,           # x^6 + x + 1
    7: 0b10001001,          # x^7 + x^3 + 1
    8: 0b100011101,         # x^8 + x^4 + x^3 + x^2 + 1
}


# ------------------------------------------------------------ construction
def _antilog_table(m: int, poly: int) -> Tuple[int, ...]:
    """alpha^i for i in [0, 2^m-1); asserts ``poly`` is primitive."""
    n = (1 << m) - 1
    tab = []
    a = 1
    for _ in range(n):
        tab.append(a)
        a <<= 1
        if a >> m:
            a ^= poly
    assert len(set(tab)) == n, "polynomial is not primitive"
    return tuple(tab)


def _minimal_poly(j: int, m: int, poly: int) -> int:
    """Minimal polynomial of alpha^j over GF(2), as a bit-polynomial int."""
    n = (1 << m) - 1
    antilog = _antilog_table(m, poly)
    log = {v: i for i, v in enumerate(antilog)}

    def mul(a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return antilog[(log[a] + log[b]) % n]

    coset = []
    c = j % n
    while c not in coset:
        coset.append(c)
        c = (2 * c) % n
    p = [1]                                   # index = degree, GF coeffs
    for c in coset:
        root = antilog[c]
        q = [0] * (len(p) + 1)
        for d, coef in enumerate(p):
            q[d + 1] ^= coef
            q[d] ^= mul(coef, root)
        p = q
    assert all(v in (0, 1) for v in p), "minimal poly not over GF(2)"
    return sum(bit << d for d, bit in enumerate(p))


def _polymul2(a: int, b: int) -> int:
    r, d = 0, 0
    while b >> d:
        if (b >> d) & 1:
            r ^= a << d
        d += 1
    return r


def _polymod2(a: int, g: int) -> int:
    dg = g.bit_length() - 1
    while a and a.bit_length() - 1 >= dg:
        a ^= g << (a.bit_length() - 1 - dg)
    return a


@dataclass(frozen=True)
class BCHCode:
    """Hashable code spec (all-tuple fields -> usable as a cache key)."""
    m: int                      # GF(2^m)
    t: int                      # designed correction radius (1 or 2)
    k: int                      # data bits per word (<= 64)
    parity: bool                # overall-parity factor (x+1) in g
    poly: int                   # primitive polynomial of the field
    r: int                      # check bits = deg g
    n: int                      # codeword length = k + r
    gen: int                    # generator polynomial g(x) as bit-int
    data_cols: Tuple[int, ...]  # (k,) syndrome column of data bit i
    check_cols: Tuple[int, ...]  # (r,) unit vectors
    mask_lo: Tuple[int, ...]    # (r,) encode parity masks over data bits
    mask_hi: Tuple[int, ...]
    alpha1: Tuple[int, ...]     # (r,) alpha^j      — S1 = s(alpha)
    alpha3: Tuple[int, ...]     # (r,) alpha^{3j}   — S3 = s(alpha^3)

    @property
    def d_min(self) -> int:
        """Designed minimum distance (BCH bound + parity extension)."""
        return 2 * self.t + 1 + (1 if self.parity else 0)


@functools.lru_cache(maxsize=None)
def make_code(k: int, t: int, m: int, parity: bool = True) -> BCHCode:
    """Build a shortened BCH(n=k+r, k) code over GF(2^m), t in {1, 2}."""
    assert t in (1, 2), "decode paths implemented for t=1 and t=2 only"
    assert 1 <= k <= 64
    poly = _PRIMITIVE_POLYS[m]
    n_field = (1 << m) - 1
    g = 1
    seen = set()
    for j in range(1, 2 * t, 2):              # odd powers 1, 3, ..., 2t-1
        mp = _minimal_poly(j, m, poly)
        if mp not in seen:
            seen.add(mp)
            g = _polymul2(g, mp)
    if parity:
        g = _polymul2(g, 0b11)                # * (x + 1)
    r = g.bit_length() - 1
    n = k + r
    assert n <= n_field, f"(n={n}) exceeds field length {n_field}"

    data_cols = tuple(_polymod2(1 << (r + i), g) for i in range(k))
    check_cols = tuple(1 << j for j in range(r))
    # d_min >= 3 guarantees all n single-error syndromes are distinct.
    assert len(set(data_cols) | set(check_cols)) == n
    if parity:
        # (x+1) | g  =>  every column has odd weight: doubles can't
        # miscorrect onto singles.
        assert all(bin(c).count("1") % 2 == 1 for c in data_cols)

    mask64 = [0] * r
    for i, c in enumerate(data_cols):
        for j in range(r):
            if (c >> j) & 1:
                mask64[j] |= 1 << i
    antilog = _antilog_table(m, poly)
    return BCHCode(
        m=m, t=t, k=k, parity=parity, poly=poly, r=r, n=n, gen=g,
        data_cols=data_cols, check_cols=check_cols,
        mask_lo=tuple(v & 0xFFFFFFFF for v in mask64),
        mask_hi=tuple(v >> 32 for v in mask64),
        alpha1=tuple(antilog[j % n_field] for j in range(r)),
        alpha3=tuple(antilog[(3 * j) % n_field] for j in range(r)),
    )


# ------------------------------------------------- kernel launch argument
MAX_R = 16          # check bits a uint16 sidecar holds
MAX_K = 64


class _CodeArg(ctypes.Structure):
    """The code as ``csrc/bch.cu``'s ``BchCode``, passed by value."""
    _fields_ = [("m", ctypes.c_int32), ("t", ctypes.c_int32),
                ("r", ctypes.c_int32), ("n", ctypes.c_int32),
                ("k", ctypes.c_int32), ("parity", ctypes.c_int32),
                ("poly", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("mask", ctypes.c_uint64 * MAX_R),
                ("data_cols", ctypes.c_uint16 * MAX_K),
                ("alpha1", ctypes.c_uint8 * MAX_R),
                ("alpha3", ctypes.c_uint8 * MAX_R)]


assert ctypes.sizeof(_CodeArg) == 320       # static_assert in bch.cu


def _check_code(code: BCHCode) -> None:
    if code.r > MAX_R:
        raise ValueError(f"{code.r} check bits do not fit the uint16 sidecar "
                         f"(at most {MAX_R})")


@functools.lru_cache(maxsize=None)
def _code_arg(code: BCHCode) -> _CodeArg:
    """The code's launch argument, cached so its memory outlives the call."""
    arg = _CodeArg(m=code.m, t=code.t, r=code.r, n=code.n, k=code.k,
                   parity=int(code.parity), poly=code.poly)
    for j in range(code.r):
        arg.mask[j] = code.mask_lo[j] | (code.mask_hi[j] << 32)
        arg.alpha1[j] = code.alpha1[j]
        arg.alpha3[j] = code.alpha3[j]
    for i, col in enumerate(code.data_cols):
        arg.data_cols[i] = col
    return arg


# ---------------------------------------------------------------- wrappers
def bch_encode_words(words: torch.Tensor, code: BCHCode) -> torch.Tensor:
    """words (rows, 256) int64 -> ecc (rows, 256) uint16 (r valid bits)."""
    _build.check_words(words)
    _check_code(code)
    if not _build.on_card(words):
        return ref.bch_encode_ref(words, code)
    ecc = torch.empty(words.shape, dtype=torch.uint16, device=words.device)
    _build.launch("bch_encode", ctypes.addressof(_code_arg(code)),
                  words.data_ptr(), ecc.data_ptr(), words.shape[0])
    return ecc


def bch_scrub_plain(words: torch.Tensor, ecc: torch.Tensor, code: BCHCode):
    """The plain version of ``bch_scrub_words``, with its outputs."""
    words2, ecc2, corr, unc = ref.bch_scrub_ref(words, ecc, code)
    return (words2, ecc2, corr.sum(1, dtype=torch.int32),
            unc.sum(1, dtype=torch.int32))


def bch_scrub_words(words: torch.Tensor, ecc: torch.Tensor, code: BCHCode):
    """Scrub and correct. Returns ``(words', ecc', corrected,
    uncorrectable)``, the counts per row as (rows,) int32. An uncorrectable
    word keeps its data and its code."""
    _build.check_words(words)
    _build.check_side(ecc, words, words.shape[1], "ecc", torch.uint16)
    _check_code(code)
    if not _build.on_card(words, ecc):
        return bch_scrub_plain(words, ecc, code)
    words2 = torch.empty_like(words)
    ecc2 = torch.empty_like(ecc)
    corr = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    unc = torch.empty_like(corr)
    _build.launch("bch_scrub", ctypes.addressof(_code_arg(code)),
                  words.data_ptr(), ecc.data_ptr(), words2.data_ptr(),
                  ecc2.data_ptr(), corr.data_ptr(), unc.data_ptr(),
                  words.shape[0])
    return words2, ecc2, corr, unc
