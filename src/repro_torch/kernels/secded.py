"""Hsiao SEC-DED(72,64) encode and scrub over packed words.

Counterpart of ``repro.kernels.secded``. On a CUDA tensor the wrappers
launch the kernels of ``csrc/secded.cu``; on a CPU tensor they run the
plain versions of ``ref.py``. The ECC sidecar is uint8 on both sides.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def secded_encode_words(words: torch.Tensor) -> torch.Tensor:
    """words (rows, 256) int64 -> ecc (rows, 256) uint8."""
    _build.check_words(words)
    if not _build.on_card(words):
        return ref.secded_encode_ref(words)
    ecc = torch.empty(words.shape, dtype=torch.uint8, device=words.device)
    _build.launch("secded_encode", words.data_ptr(), ecc.data_ptr(),
                  words.shape[0])
    return ecc


def secded_scrub_plain(words: torch.Tensor, ecc: torch.Tensor):
    """The plain version of ``secded_scrub_words``, with its outputs."""
    words2, ecc2, corr, unc = ref.secded_scrub_ref(words, ecc)
    return (words2, ecc2, corr.sum(1, dtype=torch.int32),
            unc.sum(1, dtype=torch.int32))


def secded_scrub_words(words: torch.Tensor, ecc: torch.Tensor):
    """Scrub and correct. Returns ``(words', ecc', corrected, uncorrectable)``,
    the counts per row as (rows,) int32."""
    _build.check_words(words)
    _build.check_side(ecc, words, words.shape[1], "ecc")
    if not _build.on_card(words, ecc):
        return secded_scrub_plain(words, ecc)
    words2 = torch.empty_like(words)
    ecc2 = torch.empty_like(ecc)
    corr = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    unc = torch.empty_like(corr)
    _build.launch("secded_scrub", words.data_ptr(), ecc.data_ptr(),
                  words2.data_ptr(), ecc2.data_ptr(), corr.data_ptr(),
                  unc.data_ptr(), words.shape[0])
    return words2, ecc2, corr, unc
