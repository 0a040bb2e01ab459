"""Plain PyTorch versions of the tier kernels, with the semantics of
``repro.kernels.ref``.

Words are int64 tensors, one 64-bit word per element, holding the same bits
as the reference's ``(lo, hi)`` uint32 lane pairs. PyTorch on the CPU has
no popcount and no shifts on unsigned 32-bit integers, so these functions
split a word into its 32-bit halves held in int64 (where an arithmetic
shift of a non-negative value is a logical one) and fold parities by hand.

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


def secded_encode_ref(words: torch.Tensor) -> torch.Tensor:
    """The 8 Hsiao check bits of each word, as uint8 of the words' shape."""
    lo, hi = _halves(words)
    ecc = torch.zeros_like(words)
    for j in range(hsiao.N_CHECK):
        mlo, mhi = int(hsiao.MASK_LO[j]), int(hsiao.MASK_HI[j])
        ecc |= _parity32((lo & mlo) ^ (hi & mhi)) << j
    return ecc.to(torch.uint8)


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
