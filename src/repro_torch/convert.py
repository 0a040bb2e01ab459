"""Carry state between the JAX reference and the port through numpy.

``state_from_numpy`` turns a nested dict of numpy arrays (the reference's
state after ``np.asarray`` on each leaf) into the port's tensors: a
parameter tree, a ``MemoryDomain`` payload, or a whole train state
(``params``; ``opt`` with its moments ``m``, ``v`` and the 0-d int32
``count``; ``ef`` under gradient compression). The
``*_to_numpy`` functions turn the port's results back into numpy in the
reference's layout, for byte comparison: the MIRROR tier's int64 word copy
comes back as the reference's ``copy_lo``/``copy_hi`` uint32 lanes.

numpy has no bfloat16 of its own: JAX's bf16 arrays carry an ``ml_dtypes``
dtype, which this module recognises by name and moves as int16 bits, so the
port never imports ``ml_dtypes``. bf16 tensors come back as uint16 bits.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.tree import map_leaves


def _from_numpy(arr, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)      # a writable copy: the tensor never aliases it
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def state_from_numpy(tree, device=None):
    """Nested dict of numpy arrays -> the port's state on ``device`` (the
    card unless given)."""
    dev = resolve_device(device)
    return map_leaves(lambda a: _from_numpy(a, dev), tree)


def state_to_numpy(tree):
    """The port's state -> nested dict of numpy arrays (bf16 as uint16)."""
    return map_leaves(_to_numpy, tree)


def sidecar_to_numpy(sidecar) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-tier sidecars in the reference's names and dtypes: ``ecc`` uint8
    (rows, 256) for SEC-DED and uint16 (rows, 256) for DEC-TED and BURST,
    both returned as they are; ``par`` uint8 (rows, 32); and the MIRROR
    copy as ``copy_lo``/``copy_hi`` uint32 (rows, 256)."""
    out = {}
    for tier, bufs in sidecar.items():
        out[tier] = {}
        for name, t in bufs.items():
            if name == "copy":
                u = _to_numpy(t).view(np.uint64)
                out[tier]["copy_lo"] = (u & np.uint64(0xFFFFFFFF)).astype(
                    np.uint32)
                out[tier]["copy_hi"] = (u >> np.uint64(32)).astype(np.uint32)
            else:
                out[tier][name] = _to_numpy(t)
    return out


def hard_errors_to_numpy(hard) -> Dict[str, Dict[str, np.ndarray]]:
    """Hard-error map -> ``{path: {"word": int32, "bit": int32}}``."""
    return {path: {k: _to_numpy(v).astype(np.int32) for k, v in err.items()}
            for path, err in hard.items()}
