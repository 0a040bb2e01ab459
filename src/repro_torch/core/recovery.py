"""Software responses to detected memory errors (Table 2, middle block).

Counterpart of the parts of ``repro.core.recovery`` that
``MemoryDomain.recover`` uses. The legacy per-leaf ``RecoveryManager`` is
not ported.

  RELOAD_CLEAN_COPY  Par+R: fetch the leaf's clean bytes from the durable
                     store (checkpoint).
  PEER_COPY          fetch from a data-parallel replica (an in-memory
                     gather, billed ``PEER_COPY_SECONDS``).
  RETIRE             block retirement: mark the leaf's faulty 512-byte
                     blocks and stop counting their recurring errors.
  RESTART            abandon the step and restart from the last checkpoint.
  CONSUME            do nothing (measurement mode).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


class Response(enum.Enum):
    RELOAD_CLEAN_COPY = "reload_clean_copy"
    PEER_COPY = "peer_copy"
    RETIRE = "retire"
    RESTART = "restart"
    CONSUME = "consume"


class RestartRequired(RuntimeError):
    """Raised when the policy's response to an uncorrectable error is a
    restart-from-checkpoint; the runtime loop catches it."""


BLOCK_BYTES = 512


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def flagged_blocks(current: torch.Tensor, clean, *,
                   block_bytes: int = BLOCK_BYTES) -> List[int]:
    """Indices of the ``block_bytes``-sized blocks whose bytes differ
    between a flagged leaf and its clean replacement.

    The diff runs on the leaf's device; only the block ids come to the host.
    """
    ref = torch.as_tensor(clean, device=current.device).reshape(
        current.shape).to(current.dtype)
    diff = torch.nonzero(_bytes(current) != _bytes(ref)).reshape(-1)
    return torch.unique(diff // block_bytes).tolist()


@dataclass
class RetirementMap:
    """Per-leaf retired-block bitmap (512-byte blocks)."""
    blocks: Dict[str, set] = field(default_factory=dict)

    def retire(self, path: str, block: int) -> None:
        self.blocks.setdefault(path, set()).add(block)

    def count(self, path: Optional[str] = None) -> int:
        if path is not None:
            return len(self.blocks.get(path, ()))
        return sum(len(b) for b in self.blocks.values())
