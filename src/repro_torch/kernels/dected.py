"""DEC-TED(79,64): double-error-correct, triple-error-detect.

Counterpart of ``repro.kernels.dected``: the shortened BCH code over
GF(2^7) with an overall-parity factor, built by ``kernels/bch.py``, and
thin wrappers over its kernels (no kernel of its own). 15 check bits per
64-bit word, stored as uint16 (25 % sidecar capacity).

Guarantees: corrects every 1-bit and every 2-bit error pattern over the 79
codeword bits (data or check) and flags every 3-bit pattern
detected-uncorrectable, never miscorrecting.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bch import bch_encode_words, bch_scrub_words, \
    make_code

DECTED_CODE = make_code(k=64, t=2, m=7, parity=True)
N_CHECK = DECTED_CODE.r                        # 15


def dected_encode_words(words: torch.Tensor) -> torch.Tensor:
    """words (rows, 256) int64 -> ecc (rows, 256) uint16 (15 valid bits)."""
    return bch_encode_words(words, DECTED_CODE)


def dected_scrub_words(words: torch.Tensor, ecc: torch.Tensor):
    """Scrub and correct. Returns ``(words', ecc', corrected,
    uncorrectable)``, the counts per row as (rows,) int32."""
    return bch_scrub_words(words, ecc, DECTED_CODE)
