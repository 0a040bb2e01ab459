"""Paged attention for one decode step: every slot's query against its own
K/V pages, read in place through the page table up to the slot's position.

No counterpart in ``repro.kernels``: the reference decodes over a
contiguous cache. On CUDA tensors ``paged_attn_decode`` launches the kernel
of ``csrc/paged_attn.cu``; on CPU tensors it runs
``paged_attn_decode_plain``, which gathers each slot's pages into the
contiguous view ``models.transformer.decode_step``'s cache holds and applies
``models.attention.attend``'s score, mask and softmax to it, op for op, so
the CPU path is that of the contiguous decode bit for bit.

The kernel takes bfloat16 and float32 (the port's compute dtypes on the
card) and head sizes of whole 16-byte chunks up to 256 elements; the
wrapper refuses anything else on either device, so the CPU tests run what
the card runs. It keeps scores, softmax and the V sum in float32 and
rounds once;
the plain version rounds the scores and the weights to the compute dtype
as ``attend`` does. It reads no position past a slot's ``pos``, so a
non-finite value there, which the plain version's weighted sum carries
into its output (0 x inf), does not reach the kernel's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# positions a block of the kernel reads, at most: whole pages, at least one
# and at most kMaxSplitPages (128) of them. 64 and 256 read 10 % and 3 %
# slower at the chat cell's shapes (H100)
SPLIT_TOKENS = 128
# dtype -> code of the C entry point
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attn_decode_plain(q: torch.Tensor, pk: torch.Tensor,
                            pv: torch.Tensor, table: torch.Tensor,
                            pos: torch.Tensor, page_size: int
                            ) -> torch.Tensor:
    """The plain version of ``paged_attn_decode``: the slots' pages gathered
    into (S, P * page_size, K, dh) views, ``attend``'s math over positions
    ``<= pos``."""
    S, P = table.shape
    smax = P * page_size
    vk = pk[table].reshape(S, smax, *pk.shape[2:])
    vv = pv[table].reshape(S, smax, *pv.shape[2:])
    cols = torch.arange(smax, device=pos.device)
    valid = (cols[None, :] <= pos[:, None])[:, None, None, None, :]
    q = q[:, None]                                      # (S, 1, K, G, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q,
                          vk.to(q.dtype)).to(torch.float32)
    scores = scores / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~valid, -math.inf)
    w = torch.softmax(scores, dim=-1).to(vv.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, vv)
    return o.reshape(S, -1).to(q.dtype)


def _check(q, pk, pv, table, pos, page_size: int) -> None:
    if q.dtype not in _DTYPES or pk.dtype != q.dtype or pv.dtype != q.dtype:
        raise ValueError(f"q, pk, pv must share one of {list(_DTYPES)}, got "
                         f"{q.dtype}, {pk.dtype}, {pv.dtype}")
    if table.dtype != torch.int64 or pos.dtype != torch.int64:
        raise ValueError(f"table and pos must be int64, got {table.dtype}, "
                         f"{pos.dtype}")
    if q.dim() != 4 or table.dim() != 2 or pos.dim() != 1:
        raise ValueError(f"expected q (S, K, G, dh), table (S, P), pos "
                         f"(S,), got {tuple(q.shape)}, {tuple(table.shape)}, "
                         f"{tuple(pos.shape)}")
    S, K, _, dh = q.shape
    want = (pk.shape[0], page_size, K, dh)
    for t, name in ((pk, "pk"), (pv, "pv")):
        if t.dim() != 4 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be (n_pages, {page_size}, {K}, "
                             f"{dh}), got {tuple(t.shape)}")
    if table.shape[0] != S or pos.shape[0] != S:
        raise ValueError(f"table {tuple(table.shape)} and pos "
                         f"{tuple(pos.shape)} are not over the {S} slots")
    for t, name in ((q, "q"), (pk, "pk"), (pv, "pv"), (table, "table"),
                    (pos, "pos")):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dh * q.element_size() % 16 or dh > 256:
        raise ValueError(f"head size {dh} in {q.dtype}: the kernel takes "
                         f"whole 16-byte chunks, at most 256 elements")


def positions_read(table: torch.Tensor, pos, page_size: int) -> int:
    """The K/V positions ``paged_attn_decode`` reads over ``table`` at the
    slots' positions ``pos`` (host integers): on the card the kernel's,
    0..pos of every slot, idle slots at pos 0 included; on the CPU its
    plain version's, every slot's every page."""
    if _build.on_card(table):
        return int(pos.sum()) + len(pos)
    return int(table.numel()) * page_size


def paged_attn_decode(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                      table: torch.Tensor, pos: torch.Tensor, page_size: int
                      ) -> torch.Tensor:
    """q (S, K, G, dh): each slot's query; pk, pv (n_pages, page_size, K,
    dh): one layer's pools, in q's dtype; table (S, P) int64 page ids; pos
    (S,) int64, each slot's position, whose K/V is already in its page.
    Returns o (S, K * G * dh) in q's dtype, the heads in ``attend``'s
    order, before the output projection."""
    _check(q, pk, pv, table, pos, page_size)
    if not _build.on_card(q, pk, pv, table, pos):
        return paged_attn_decode_plain(q, pk, pv, table, pos, page_size)
    for t, name in ((q, "q"), (pk, "pk"), (pv, "pv")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    S, K, G, dh = q.shape
    P = table.shape[1]
    sp = max(1, min(P, SPLIT_TOKENS // page_size))
    n_splits = -(-P // sp)
    dev = q.device
    part_m = torch.empty((S, K, n_splits, G), dtype=torch.float32,
                         device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((S, K, n_splits, G, dh), dtype=torch.float32,
                           device=dev)
    out = torch.empty((S, K * G * dh), dtype=q.dtype, device=dev)
    _build.launch("paged_attn_decode", q.data_ptr(), pk.data_ptr(),
                  pv.data_ptr(), table.data_ptr(), pos.data_ptr(),
                  part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                  out.data_ptr(), S, P, page_size, K, G, dh, sp,
                  _DTYPES[q.dtype])
    return out
