"""Controlled bit-flip injection into packed words (the paper's Fig. 2
error-emulation step).

Counterpart of ``repro.kernels.bitflip``. On a CUDA tensor the wrapper
launches the kernel of ``csrc/bitflip.cu``; on a CPU tensor it runs the
plain version of ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def bitflip_words_(words: torch.Tensor, word_idx, bit_idx) -> torch.Tensor:
    """Flip bit ``bit_idx[e]`` of flat word ``word_idx[e]`` of ``words``
    (rows, 256) int64, in place, and return ``words``.

    ``word_idx < 0`` is an inactive slot; a word past the buffer or a bit
    outside [0, 64) drops; duplicate strikes cancel. The callers flip a
    buffer they have just packed, so working in place costs no copy and
    leaves every verb functional.
    """
    _build.check_words(words)
    word_idx = torch.as_tensor(word_idx, dtype=torch.int64,
                               device=words.device).reshape(-1).contiguous()
    bit_idx = torch.as_tensor(bit_idx, dtype=torch.int64,
                              device=words.device).reshape(-1).contiguous()
    if word_idx.shape != bit_idx.shape:
        raise ValueError(f"{word_idx.shape[0]} word indices but "
                         f"{bit_idx.shape[0]} bit indices")
    if not _build.on_card(words):
        words.copy_(ref.bitflip_ref(words, word_idx, bit_idx))
        return words
    _build.launch("bitflip", words.data_ptr(), words.numel(),
                  word_idx.data_ptr(), bit_idx.data_ptr(), word_idx.numel())
    return words
