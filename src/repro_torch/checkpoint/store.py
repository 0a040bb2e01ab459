"""Checkpoint store: atomic snapshots of nested-dict state + the Par+R
clean-copy source.

Counterpart of ``repro.checkpoint.store``, with the same bytes on disk, so
that each package verifies and loads the other's snapshots. One directory
per step holds

* ``data.npz``: one uint8 array of each leaf's raw bytes, keyed by its path
  with ``/`` written as ``|``;
* ``meta.json``: ``{path: {"shape", "dtype", "crc32"}}`` in the
  reference's (sorted) flatten order, dtypes spelled as numpy spells them
  (``"bfloat16"``, ``"float32"``, ``"int32"``), then ``__manifest__``:
  the SHA-256 of every (path, shape, dtype, crc32) record and the step.

Writes are atomic (staging dir + rename), so a failure mid-write never
corrupts the latest snapshot; staging dirs left by crashed writers
(``.tmp_*``) are swept on construction.

Integrity, as in the reference: at ``save`` every leaf is checksummed and
the staging buffers are held in a Par+R ``MemoryDomain`` and scrubbed just
before they reach the disk, on the store's device (the card unless the
caller asks otherwise), so the parity kernels run there. At ``load`` and
``clean_copy`` every byte is checked again; a snapshot that fails raises
``SnapshotCorruptError`` and the store falls back to the newest older
snapshot that verifies, else raises ``RestartRequired``. Legacy snapshots
without CRCs load (verification is vacuous).

Leaves are read back from raw bytes by dtype name into torch tensors, never
through numpy's dtype of that name: the port has no ``ml_dtypes``. A dtype
torch cannot hold (the reference's ``uint4``) raises ``TypeError`` naming
it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import tree
from repro_torch.core.recovery import RestartRequired

MANIFEST_KEY = "__manifest__"

# numpy's dtype names of the torch dtypes a snapshot can hold
_DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "uint16", "uint32", "uint64")}
_DTYPES["bool"] = torch.bool
_NAMES = {dt: name for name, dt in _DTYPES.items()}


class SnapshotCorruptError(RuntimeError):
    """A snapshot failed CRC/manifest verification (or is unreadable)."""


def _flatten(state) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` in the reference's flatten order."""
    flat, _ = tree.flatten_with_path(state)
    return {"/".join(str(k) for k in path): leaf for path, leaf in flat}


def _manifest_sha(meta_leaves: Dict[str, Dict]) -> str:
    """SHA-256 binding every (path, shape, dtype, crc32) record."""
    h = hashlib.sha256()
    for k in sorted(meta_leaves):
        m = meta_leaves[k]
        h.update(f"{k}:{m['shape']}:{m['dtype']}:{m.get('crc32', '')}\n"
                 .encode())
    return h.hexdigest()


def _torch_dtype(name: str, path: str) -> torch.dtype:
    if name not in _DTYPES:
        raise TypeError(f"snapshot leaf {path!r} has dtype {name!r}, which "
                        "torch cannot hold")
    return _DTYPES[name]


def _host_bytes(leaf: torch.Tensor) -> Tuple[torch.Tensor, list, str]:
    """(the leaf's raw bytes as a uint8 CPU tensor, shape, dtype name)."""
    if leaf.dtype not in _NAMES:
        raise TypeError(f"a snapshot cannot hold dtype {leaf.dtype}")
    raw = leaf.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return raw, list(leaf.shape), _NAMES[leaf.dtype]


def _scrub_staged(buffers: Dict[str, torch.Tensor], device
                  ) -> Dict[str, np.ndarray]:
    """Hold the staging buffers in a cheap Par+R ``MemoryDomain`` on
    ``device`` and scrub once just before the write hits disk. A bit
    flipped between serialization and write is detected here (and healed
    from the just-computed source bytes) instead of being checksummed into
    the snapshot as truth."""
    from repro_torch.core.domain import MemoryDomain
    from repro_torch.core.policy import HRMPolicy
    from repro_torch.core.tiers import Tier

    staged = {"ckpt": {k: v.to(device) for k, v in buffers.items()}}
    dom = MemoryDomain.protect(
        staged, HRMPolicy("ckpt_staging", {}, default=Tier.PARITY_R,
                          scrub_interval=1))
    dom, rep = dom.scrub()
    needs = rep.needs_recovery()
    if needs:
        dom, _ = dom.recover(
            rep, clean_copy=lambda p: buffers[p.split("/")[-1]],
            needs=needs)
    out = dom.payload["ckpt"]
    return {k: out[k].cpu().numpy() for k in buffers}


class CheckpointStore:
    def __init__(self, directory, keep: int = 3, *, device=None):
        """Snapshots under ``directory``; the staging scrub and loaded
        leaves go to ``device``, the card unless given."""
        self.device = resolve_device(device)
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self.last_loaded_step: Optional[int] = None
        self._sweep_tmp()

    def _sweep_tmp(self) -> None:
        """Remove staging dirs left behind by crashed mid-write savers:
        they are invisible to ``steps()`` but leak disk forever."""
        for p in self.dir.glob(".tmp_*"):
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state) -> Path:
        with self._lock:
            meta, buffers = {}, {}
            for k, leaf in _flatten(state).items():
                raw, shape, dtype = _host_bytes(leaf)
                meta[k] = {"shape": shape, "dtype": dtype,
                           "crc32": zlib.crc32(raw.numpy())}
                buffers[k.replace("/", "|")] = raw
            arrays = _scrub_staged(buffers, self.device)
            meta[MANIFEST_KEY] = {"sha256": _manifest_sha(
                {k: m for k, m in meta.items() if k != MANIFEST_KEY}),
                "step": step}
            tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
            np.savez(tmp / "data.npz", **arrays)
            (tmp / "meta.json").write_text(json.dumps(meta))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
            return final

    def save_async(self, step: int, state) -> threading.Thread:
        """Overlap checkpoint IO with the next step's compute. The state is
        copied to host memory before the thread starts, so no later write
        to ``state``'s tensors can race the snapshot."""
        host_state = tree.map_leaves(
            lambda t: t.detach().to("cpu", copy=True), state)
        t = threading.Thread(target=self.save, args=(step, host_state),
                             daemon=True)
        t.start()
        return t

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------- load
    def steps(self):
        out = []
        for p in self.dir.iterdir():
            if p.name.startswith("step_"):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def _read(self, step: int, *, verify: bool = True
              ) -> Tuple[Dict[str, np.ndarray], Dict]:
        d = self.dir / f"step_{step:08d}"
        try:
            meta = json.loads((d / "meta.json").read_text())
            with np.load(d / "data.npz") as z:
                data = {k: z[k] for k in z.files}
        except Exception as e:
            raise SnapshotCorruptError(
                f"snapshot step {step} unreadable: {e}") from e
        manifest = meta.pop(MANIFEST_KEY, None)
        if verify:
            self._verify(step, data, meta, manifest)
        return data, meta

    @staticmethod
    def _verify(step: int, data: Dict[str, np.ndarray], meta: Dict,
                manifest: Optional[Dict]) -> None:
        if manifest is not None:
            if manifest.get("sha256") != _manifest_sha(meta):
                raise SnapshotCorruptError(
                    f"snapshot step {step}: manifest hash mismatch")
        for k, m in meta.items():
            key = k.replace("/", "|")
            if key not in data:
                raise SnapshotCorruptError(
                    f"snapshot step {step}: missing buffer {k!r}")
            crc = m.get("crc32")
            if crc is None:        # legacy snapshot without checksums
                continue
            if zlib.crc32(np.ascontiguousarray(data[key])) != crc:
                raise SnapshotCorruptError(
                    f"snapshot step {step}: CRC mismatch on {k!r}")

    def verifies(self, step: int) -> bool:
        """True iff ``step`` exists and passes full verification."""
        try:
            self._read(step, verify=True)
            return True
        except SnapshotCorruptError:
            return False

    def _fallback_step(self, bad_step: int) -> int:
        """Newest older snapshot that verifies; RestartRequired if none."""
        for s in reversed(self.steps()):
            if s >= bad_step:
                continue
            if self.verifies(s):
                return s
        raise RestartRequired(
            f"no checkpoint verifies at or below step {bad_step}: "
            f"cold restart required")

    def load_flat(self, step: int, *, verify: bool = True
                  ) -> Dict[str, torch.Tensor]:
        """``{path: CPU tensor}`` of snapshot ``step``, each leaf its saved
        bytes viewed as its dtype."""
        data, meta = self._read(step, verify=verify)
        out = {}
        for k, m in meta.items():
            dt = _torch_dtype(m["dtype"], k)
            raw = torch.from_numpy(
                np.ascontiguousarray(data[k.replace("/", "|")]))
            out[k] = raw.view(dt).reshape(m["shape"])
        return out

    def load(self, step: int, like_state, shardings=None, *,
             verify: bool = True, fallback: bool = True):
        """Restore into the structure of ``like_state``, each leaf on the
        device of the leaf it replaces (the store's device where that is
        not a tensor). With ``shardings`` (``runtime.elastic.
        state_shardings`` over a ``DeviceMesh``: the elastic-rescale
        path), each restored leaf is then placed on that mesh as a DTensor
        (``runtime.elastic.place_tree``); the bytes on disk do not change.

        With ``verify``, a snapshot failing CRC/manifest checks is
        refused; ``fallback`` then retries the newest older verifying
        snapshot (``last_loaded_step`` records which one actually
        loaded), raising ``RestartRequired`` when none survives."""
        try:
            flat = self.load_flat(step, verify=verify)
        except SnapshotCorruptError:
            if not fallback:
                raise
            step = self._fallback_step(step)
            flat = self.load_flat(step, verify=verify)
        self.last_loaded_step = step
        paths, treedef = tree.flatten_with_path(like_state)
        ordered = []
        for path, like in paths:
            dev = like.device if isinstance(like, torch.Tensor) \
                else self.device
            ordered.append(flat["/".join(str(k) for k in path)].to(dev))
        state = tree.unflatten(treedef, ordered)
        if shardings is not None:
            from repro_torch.runtime.elastic import place_tree
            state = place_tree(state, shardings)
        return state

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------- Par+R clean copy
    def clean_copy_fn(self, step: Optional[int] = None):
        """Returns path -> leaf loader bound to one checkpoint step.

        Every call re-reads and re-verifies the snapshot; a corrupted
        snapshot is refused and the loader falls back to the newest older
        verifying one, so the recovery path never hands corrupted bytes to
        a ``MemoryDomain``. ``RestartRequired`` propagates when no
        snapshot verifies."""
        step = self.latest_step() if step is None else step
        assert step is not None, "no checkpoint available for recovery"

        def clean_copy(path: str):
            s = step
            try:
                flat = self.load_flat(s, verify=True)
            except SnapshotCorruptError:
                s = self._fallback_step(s)
                flat = self.load_flat(s, verify=True)
            self.last_loaded_step = s
            # recovery paths are relative to the wrapped root (params)
            for cand in (path, f"params/{path}"):
                if cand in flat:
                    return flat[cand].to(self.device)
            raise KeyError(path)
        return clean_copy
