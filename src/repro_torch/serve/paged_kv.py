"""Paged KV cache: fixed-size pages, a host-side free-list allocator, and
device pools that register as their own ``MemoryDomain`` root.

Counterpart of ``repro.serve.paged_kv``, for the attention-cache families
dense, MoE and VLM. The hybrid and xLSTM families keep recurrent state,
not pages, and the audio family does not decode: they raise the
reference's ``ValueError``.
Layout: named pools, the model's decode cache with pages as its batch
(``init_cache(cfg, n_pages, page_size)``), in the compute dtype on the
device the cache was made for: ``k`` and ``v``, each ``(n_layers,
n_pages, page_size, n_kv_heads, head_dim)``, or under an ``MLAConfig``
(latent attention, the port's own) the one pool ``latent``, ``(n_layers,
n_pages, page_size, latent_dim)``. Page 0 is the reserved *null* page:
page-table slots that a request has not grown into yet point at it, and
decode steps of inactive scheduler slots write their K/V there. The null
page is only ever read at attention positions past a slot's current
length, where the validity mask zeroes its weight exactly, so its
contents never reach an output.

The pools are the Fig. 4 "most error-tolerant, largest" region: the
engine wraps them in a second ``MemoryDomain`` (root ``kv_cache``) so the
KV pages can run under a cheap tier (none/parity/SEC-DED) while the
params domain stays strongly protected.

Allocation is per-request and up-front: a request's full footprint
(prompt + max_new positions, rounded up to whole pages) is reserved at
admission, so an admitted request can never deadlock mid-decode waiting
for pages. ``check_invariants`` asserts the two safety properties the
tests pin: no page is mapped by two slots (no cross-request KV aliasing)
and the free list and page tables exactly partition the pool (no leaks).
The allocator and the invariants are the reference's, line for line.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_cache

NULL_PAGE = 0


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, *, n_pages: int, page_size: int,
                 slots: int, max_pages_per_slot: int, device=None):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"paged KV serving supports attention-cache families "
                f"(dense/moe/vlm), not {cfg.family!r}")
        if n_pages < 2:
            raise ValueError("need at least one real page beside the null "
                             "page")
        self.pools: Dict[str, torch.Tensor] = init_cache(
            cfg, n_pages, page_size, device=device)
        self.latent = "latent" in self.pools
        self.page_size = page_size
        self.n_pages = n_pages
        self.slots = slots
        self.max_pages_per_slot = max_pages_per_slot
        # LIFO free list over real pages; page 0 stays out as the null page
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self.table = np.full((slots, max_pages_per_slot), NULL_PAGE,
                             np.int32)
        self._owner: Dict[int, int] = {}          # page -> slot

    @property
    def pool_k(self) -> torch.Tensor:
        return self.pools["k"]

    @property
    def pool_v(self) -> torch.Tensor:
        return self.pools["v"]

    @property
    def device(self) -> torch.device:
        return next(iter(self.pools.values())).device

    @property
    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.pools.values())

    # ------------------------------------------------------------- sizing
    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_admit(self, tokens: int) -> bool:
        n = self.pages_needed(tokens)
        return n <= self.max_pages_per_slot and n <= self.free_pages

    # --------------------------------------------------------- allocation
    def alloc(self, slot: int, tokens: int) -> np.ndarray:
        """Reserve the full page footprint for one request in ``slot``."""
        n = self.pages_needed(tokens)
        if n > self.max_pages_per_slot:
            raise ValueError(f"request needs {n} pages > max_pages_per_slot"
                             f"={self.max_pages_per_slot}")
        if n > len(self._free):
            raise MemoryError(f"out of KV pages: need {n}, "
                              f"free {len(self._free)}")
        if (self.table[slot] != NULL_PAGE).any():
            raise RuntimeError(f"slot {slot} already holds pages")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = slot
        self.table[slot, :n] = pages
        return np.asarray(pages, np.int32)

    def release(self, slot: int) -> List[int]:
        """Return every page mapped by ``slot`` to the free list."""
        pages = [int(p) for p in self.table[slot] if p != NULL_PAGE]
        for p in pages:
            assert self._owner.pop(p) == slot
            self._free.append(p)
        self.table[slot] = NULL_PAGE
        return pages

    def release_all(self) -> None:
        for s in range(self.slots):
            self.release(s)

    # ------------------------------------------------------------- device
    def device_table(self) -> torch.Tensor:
        """The page table as int64 on the pools' device."""
        return torch.as_tensor(self.table, dtype=torch.int64,
                               device=self.device)

    def adopt_pools(self, pools: Dict[str, torch.Tensor]) -> None:
        """Take the pools a domain verb returned (struck, corrected or
        reloaded), by name, as the cache's own."""
        if set(pools) != set(self.pools):
            raise KeyError(f"pools {sorted(pools)} are not the cache's "
                           f"{sorted(self.pools)}")
        self.pools = {name: pools[name] for name in self.pools}

    def contiguous_view(self, slot: int, length: int) -> tuple:
        """Gather one slot's first ``length`` positions back into the
        contiguous ``(L, 1, length, ...)`` layout, a tensor a pool (``k``
        and ``v``, or ``latent``; test oracle glue)."""
        n = self.pages_needed(length)
        pages = torch.as_tensor(self.table[slot, :n], dtype=torch.int64,
                                device=self.device)
        return tuple(pool[:, pages].reshape(pool.shape[0], 1, -1,
                                            *pool.shape[3:])[:, :, :length]
                     for pool in self.pools.values())

    # --------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        mapped = [int(p) for row in self.table for p in row
                  if p != NULL_PAGE]
        assert len(mapped) == len(set(mapped)), \
            "cross-request KV page aliasing"
        assert NULL_PAGE not in self._free, "null page on the free list"
        assert not (set(mapped) & set(self._free)), \
            "page both mapped and free"
        assert len(mapped) + len(self._free) == self.n_pages - 1, \
            "page leak: mapped + free != pool"
        assert set(self._owner) == set(mapped), "owner map out of sync"
