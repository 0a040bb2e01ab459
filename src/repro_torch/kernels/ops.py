"""Packed word layout and per-leaf wrappers around the tier kernels.

Counterpart of ``repro.kernels.ops``. A leaf of any dtype packs into a
``(rows, LANES)`` int64 buffer: the leaf's little-endian bytes, zero-padded
to whole rows and read as 64-bit words. These are exactly the words of the
reference's ``(lo, hi)`` uint32 lane pairs (``lo`` is a word's low 32
bits), so packing is a byte view with no per-dtype bitcast. Rows are padded
as the reference pads them (``_round_rows``), so row counts, sidecar shapes
and injection word spaces are the same in both packages.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import telemetry
from repro_torch.kernels.bitflip import bitflip_words_
from repro_torch.kernels.burst import burst_encode_words, burst_scrub_words
from repro_torch.kernels.dected import dected_encode_words, dected_scrub_words
from repro_torch.kernels.parity import parity_check_words, parity_encode_words
from repro_torch.kernels.ref import unpack_bits
from repro_torch.kernels.secded import secded_encode_words, secded_scrub_words

LANES = 256          # words per packed row
BLOCK_ROWS = 128


def _round_rows(rows: int) -> int:
    """Rows padded as the reference pads them: tensors larger than one
    block round up to a multiple of BLOCK_ROWS."""
    rows = max(1, rows)
    if rows > BLOCK_ROWS:
        rows = -(-rows // BLOCK_ROWS) * BLOCK_ROWS
    return rows


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def words_per_tensor(x: torch.Tensor) -> int:
    """Number of (M, LANES)-padded 64-bit words used for tensor ``x``."""
    n64 = -(-_nbytes(x) // 8)
    return _round_rows(-(-n64 // LANES)) * LANES


def pack_words_into(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Write ``x``'s bytes into the packed rows ``out`` (a contiguous int64
    row range) and zero the rest of them. Counts the rows' bytes as
    ``packed_bytes``."""
    dst = out.reshape(-1).view(torch.uint8)
    telemetry.count("packed_bytes", dst.numel())
    n = _nbytes(x)
    if n > dst.numel():
        raise ValueError(f"{n} bytes do not fit {tuple(out.shape)} words")
    dst[:n] = x.reshape(-1).view(torch.uint8)
    dst[n:].zero_()
    return out


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """Tensor -> (M, LANES) int64 words, zero-padded to full rows."""
    rows = words_per_tensor(x) // LANES
    out = torch.empty((rows, LANES), dtype=torch.int64, device=x.device)
    return pack_words_into(out, x)


def unpack_words(words: torch.Tensor, shape, dtype: torch.dtype
                 ) -> torch.Tensor:
    """Packed words -> tensor of ``shape`` and ``dtype``: a view of the
    words' leading bytes, not a copy."""
    n = dtype.itemsize
    for d in shape:
        n *= int(d)
    flat = words.reshape(-1).view(torch.uint8)[:n]
    return flat.view(dtype).reshape(tuple(shape))


# --------------------------------------------------------------- SEC-DED
def secded_encode(x: torch.Tensor) -> torch.Tensor:
    """ECC sidecar for tensor ``x``: (M, LANES) uint8 (12.5% capacity)."""
    return secded_encode_words(pack_words(x))


def secded_scrub(x: torch.Tensor, ecc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Scrub tensor against its ECC sidecar.

    Returns (corrected tensor, corrected ecc, n_corrected, n_uncorrectable).
    """
    words, ecc2, corr, unc = secded_scrub_words(pack_words(x), ecc)
    return (unpack_words(words, x.shape, x.dtype), ecc2, corr.sum(),
            unc.sum())


# --------------------------------------------------------------- DEC-TED
def dected_encode(x: torch.Tensor) -> torch.Tensor:
    """DEC-TED sidecar for tensor ``x``: (M, LANES) uint16 (25% capacity,
    15 valid code bits per 64-bit word)."""
    return dected_encode_words(pack_words(x))


def dected_scrub(x: torch.Tensor, ecc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Scrub tensor against its DEC-TED sidecar.

    Returns (corrected tensor, corrected ecc (uint16), n_corrected,
    n_uncorrectable). Corrects all 1/2-bit word errors, detects 3-bit.
    """
    words, ecc2, corr, unc = dected_scrub_words(pack_words(x), ecc)
    return (unpack_words(words, x.shape, x.dtype), ecc2, corr.sum(),
            unc.sum())


# ------------------------------------------------------------ burst/DAEC
def burst_encode(x: torch.Tensor) -> torch.Tensor:
    """SEC-DAEC sidecar for tensor ``x``: (M, LANES) uint16 (25% capacity,
    14 valid code bits per 64-bit word)."""
    return burst_encode_words(pack_words(x))


def burst_scrub(x: torch.Tensor, ecc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Scrub tensor against its SEC-DAEC sidecar.

    Returns (corrected tensor, corrected ecc (uint16), n_corrected,
    n_uncorrectable). Corrects singles and adjacent doubles.
    """
    words, ecc2, corr, unc = burst_scrub_words(pack_words(x), ecc)
    return (unpack_words(words, x.shape, x.dtype), ecc2, corr.sum(),
            unc.sum())


# ---------------------------------------------------------------- parity
def parity_encode(x: torch.Tensor) -> torch.Tensor:
    """Packed parity sidecar: (M, LANES // 8) uint8 (1.6% capacity)."""
    return parity_encode_words(pack_words(x))


def parity_check(x: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """Number of 64-bit words whose parity mismatches (detected errors)."""
    return parity_check_words(pack_words(x), par)[1].sum()


def parity_error_words(x: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """Per-word boolean error mask, shape (M, LANES)."""
    return unpack_bits(parity_check_words(pack_words(x), par)[0])


def restore_words(x: torch.Tensor, good: torch.Tensor,
                  word_mask: torch.Tensor) -> torch.Tensor:
    """Replace the 64-bit words of ``x`` flagged in ``word_mask`` with the
    corresponding words of ``good`` (mirror-repair primitive)."""
    words = torch.where(word_mask, pack_words(good), pack_words(x))
    return unpack_words(words, x.shape, x.dtype)


# --------------------------------------------------------------- bitflip
def inject_bitflips(x: torch.Tensor, word_idx, bit_idx) -> torch.Tensor:
    """Flip bits (word_idx[e], bit_idx[e]) of tensor ``x`` (packed space).

    ``word_idx`` entries < 0 are inactive slots. A flip in a pad word past
    the leaf's last byte is lost on unpacking, as in the reference.
    """
    words = bitflip_words_(pack_words(x), word_idx, bit_idx)
    return unpack_words(words, x.shape, x.dtype)
