"""SEC-DAEC adjacent-burst code over packed 64-bit words.

Counterpart of ``repro.kernels.burst``. Bit-interleaved construction: two
copies of the (39,32) shortened-BCH SEC-DED sub-code of ``kernels/bch.py``
(t=1, GF(2^6), overall parity), sub-code A over the even data bits
{0, 2, ..., 62} and sub-code B over the odd ones. 14 check bits per word,
stored as uint16 (bits 0..6 = A, 7..13 = B).

An adjacent double (i, i+1) puts one bit in each sub-code, so both see a
single and correct it. Guarantees: corrects every single-bit error (data
or check) and every adjacent data-bit double; detects, and never
miscorrects, a double that lands in one sub-code.

On a CUDA tensor the wrappers launch the kernels of ``csrc/burst.cu``,
the spread masks and sub-code columns passed by value as a launch
argument; on a CPU tensor they run the plain versions of ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bch import make_code

SUB_CODE = make_code(k=32, t=1, m=6, parity=True)
N_SUB = SUB_CODE.r                             # 7 check bits per sub-code
N_CHECK = 2 * N_SUB                            # 14


def _spread_masks(offset: int):
    """Sub-code parity masks spread onto original 64-bit positions.

    Sub-bit i maps to original bit 2*i + offset (offset 0 = A/even,
    1 = B/odd); returns (mask_lo, mask_hi) tuples of length N_SUB.
    """
    mask_lo, mask_hi = [], []
    for j in range(N_SUB):
        sub = SUB_CODE.mask_lo[j]              # k=32: all sub-bits in lo
        m64 = 0
        for i in range(32):
            if (sub >> i) & 1:
                m64 |= 1 << (2 * i + offset)
        mask_lo.append(m64 & 0xFFFFFFFF)
        mask_hi.append(m64 >> 32)
    return tuple(mask_lo), tuple(mask_hi)


_MASKS = (_spread_masks(0), _spread_masks(1))
# the 14 masks in check-bit order (A's 7, then B's 7)
MASK_LO = _MASKS[0][0] + _MASKS[1][0]
MASK_HI = _MASKS[0][1] + _MASKS[1][1]


class _CodeArg(ctypes.Structure):
    """The code as ``csrc/burst.cu``'s ``BurstCode``, passed by value."""
    _fields_ = [("mask", ctypes.c_uint64 * N_CHECK),
                ("sub_cols", ctypes.c_uint8 * 32)]


@functools.cache
def _code_arg() -> _CodeArg:
    """The launch argument, cached so its memory outlives the call."""
    arg = _CodeArg()
    for j in range(N_CHECK):
        arg.mask[j] = MASK_LO[j] | (MASK_HI[j] << 32)
    for i, col in enumerate(SUB_CODE.data_cols):
        arg.sub_cols[i] = col
    return arg


def burst_encode_words(words: torch.Tensor) -> torch.Tensor:
    """words (rows, 256) int64 -> ecc (rows, 256) uint16 (14 valid bits)."""
    _build.check_words(words)
    if not _build.on_card(words):
        return burst_encode_plain(words)
    ecc = torch.empty(words.shape, dtype=torch.uint16, device=words.device)
    _build.launch("burst_encode", ctypes.addressof(_code_arg()),
                  words.data_ptr(), ecc.data_ptr(), words.shape[0])
    return ecc


def burst_encode_plain(words: torch.Tensor) -> torch.Tensor:
    """The plain version of ``burst_encode_words``."""
    return ref.burst_encode_ref(words, MASK_LO, MASK_HI)


def burst_scrub_plain(words: torch.Tensor, ecc: torch.Tensor):
    """The plain version of ``burst_scrub_words``, with its outputs."""
    words2, ecc2, corr, unc = ref.burst_scrub_ref(words, ecc, MASK_LO,
                                                  MASK_HI, SUB_CODE)
    return (words2, ecc2, corr.sum(1, dtype=torch.int32),
            unc.sum(1, dtype=torch.int32))


def burst_scrub_words(words: torch.Tensor, ecc: torch.Tensor):
    """Scrub and correct. Returns ``(words', ecc', corrected,
    uncorrectable)``, the counts per row as (rows,) int32. A word with
    either sub-code uncorrectable keeps its data and its code."""
    _build.check_words(words)
    _build.check_side(ecc, words, words.shape[1], "ecc", torch.uint16)
    if not _build.on_card(words, ecc):
        return burst_scrub_plain(words, ecc)
    words2 = torch.empty_like(words)
    ecc2 = torch.empty_like(ecc)
    corr = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    unc = torch.empty_like(corr)
    _build.launch("burst_scrub", ctypes.addressof(_code_arg()),
                  words.data_ptr(), ecc.data_ptr(), words2.data_ptr(),
                  ecc2.data_ptr(), corr.data_ptr(), unc.data_ptr(),
                  words.shape[0])
    return words2, ecc2, corr, unc
