"""Word parity encode and check over packed words (the Par+R tier, and the
detector of the MIRROR tier).

Counterpart of ``repro.kernels.parity``. On a CUDA tensor the wrappers
launch the kernels of ``csrc/parity.cu``; on a CPU tensor they run the
plain versions of ``ref.py``. Parity is packed 8 words per byte, uint8.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _row_bytes(words: torch.Tensor) -> int:
    return words.shape[1] // 8


def parity_encode_words(words: torch.Tensor) -> torch.Tensor:
    """words (rows, 256) int64 -> packed parity (rows, 32) uint8."""
    _build.check_words(words)
    if not _build.on_card(words):
        return ref.parity_encode_ref(words)
    par = torch.empty((words.shape[0], _row_bytes(words)), dtype=torch.uint8,
                      device=words.device)
    _build.launch("parity_encode", words.data_ptr(), par.data_ptr(),
                  words.shape[0])
    return par


def parity_check_plain(words: torch.Tensor, par: torch.Tensor):
    """The plain version of ``parity_check_words``, with its outputs."""
    err = ref.parity_encode_ref(words) ^ par
    return err, ref.unpack_bits(err).sum(1, dtype=torch.int32)


def parity_check_words(words: torch.Tensor, par: torch.Tensor):
    """Returns (packed error bits (rows, 32) uint8, per-row count of words
    whose parity mismatches (rows,) int32)."""
    _build.check_words(words)
    _build.check_side(par, words, _row_bytes(words), "parity")
    if not _build.on_card(words, par):
        return parity_check_plain(words, par)
    err = torch.empty_like(par)
    cnt = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    _build.launch("parity_check", words.data_ptr(), par.data_ptr(),
                  err.data_ptr(), cnt.data_ptr(), words.shape[0])
    return err, cnt
