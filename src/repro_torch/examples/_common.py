"""What the examples share: the ``--device`` flag and bit-for-bit tree
comparison."""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import tree


def add_device(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default=None,
                    help="device of the example's tensors (default: the "
                         "CUDA card)")
    return ap


def same_bits(a, b) -> bool:
    """Two trees of tensors hold the same structure and the same bytes,
    wherever each leaf lies."""
    la, lb = tree.flatten_with_path(a), tree.flatten_with_path(b)
    if la[1] != lb[1]:
        return False
    return all(torch.equal(_bytes(x), _bytes(y).to(x.device))
               for (_, x), (_, y) in zip(la[0], lb[0]))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)
