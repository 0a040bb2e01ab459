"""Software responses to detected memory errors (Table 2, middle block).

Counterpart of ``repro.core.recovery``. ``Response``,
``RestartRequired`` and ``RetirementMap`` are shared with
``MemoryDomain.recover``; ``RecoveryManager`` answers a
``core.scrubber.Scrubber``'s reports on the legacy per-leaf path. New
code should use ``MemoryDomain.recover``, which reloads, re-encodes the
touched sidecar rows, and retires sticky cells in one call.

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
from typing import Callable, Dict, List, Optional

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


@dataclass
class RecoveryManager:
    clean_copy: Callable[[str], object]       # path -> clean leaf
    response: Response = Response.RELOAD_CLEAN_COPY
    retirement: RetirementMap = field(default_factory=RetirementMap)
    events: List[dict] = field(default_factory=list)
    # recurring-error bookkeeping for retirement escalation
    strike_counts: Dict[str, int] = field(default_factory=dict)
    retire_after: int = 3

    def respond(self, state, report, scrubber, root: str = "params"):
        """Handle every leaf the scrub flagged uncorrectable: ``report`` is
        a ``ScrubReport``, ``scrubber`` the ``Scrubber`` whose sidecar
        entries are re-encoded after each reload."""
        from repro_torch.core.sidecar import _set_leaf, leaf_index
        needs = report.needs_recovery()
        if not needs:
            return state
        if self.response == Response.CONSUME:
            self.events.append({"action": "consume", "paths": list(needs)})
            return state
        if self.response == Response.RESTART:
            self.events.append({"action": "restart", "paths": list(needs)})
            raise RestartRequired(str(list(needs)))
        for path, n in needs.items():
            self.strike_counts[path] = self.strike_counts.get(path, 0) + 1
            clean = self.clean_copy(path)
            action = ("peer_copy" if self.response == Response.PEER_COPY
                      else "reload_clean_copy")
            cur = leaf_index(state, root)[path]["leaf"]
            clean = torch.as_tensor(clean, device=cur.device)
            if self.strike_counts[path] >= self.retire_after:
                # recurring errors at the same leaf: retire its faulty
                # 512-byte blocks (diffed against the clean copy) so the
                # hard fault stops re-biting (page-offlining analogue)
                for block in flagged_blocks(cur, clean):
                    self.retirement.retire(path, block)
                action += "+retire"
            state = _set_leaf(state, path, clean)
            self.events.append({"action": action, "path": path,
                                "words": int(n)})
            scrubber.refresh(state, paths=[path])
        return state
