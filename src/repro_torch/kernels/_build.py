"""Build the port's CUDA kernels and call them through ctypes.

The sources in ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` (H100) at
first use, one ``nvcc`` process per source started together, then linked
into one shared library with a plain C interface. The library's file name
carries a hash of the sources and flags, so a stale build is never loaded.
It lands in ``build/repro_torch/`` at the repository root.

Each C entry point takes device pointers, sizes and a CUDA stream, launches
on that stream, and returns ``cudaGetLastError()``. ``launch`` raises when
that is nonzero and counts every launch by kernel name in ``LAUNCHES``. A
failed build or launch raises ``KernelError``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import hsiao

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("secded.cu", "parity.cu", "bitflip.cu", "bch.cu", "burst.cu",
           "segsum.cu", "paged_attn.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every tier kernel runs one 256-thread block per packed row (= ops.LANES)
ROW_WORDS = 256

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# C entry point -> argument types (the stream comes last in every one)
_SIGNATURES = {
    "hrm_secded_set_tables": (_P, _P),
    "hrm_secded_encode": (_P, _P, _I64, _P),
    "hrm_secded_scrub": (_P, _P, _P, _P, _P, _P, _I64, _P),
    "hrm_parity_encode": (_P, _P, _I64, _P),
    "hrm_parity_check": (_P, _P, _P, _P, _I64, _P),
    "hrm_bitflip": (_P, _I64, _P, _P, _I64, _P),
    # the BCH and burst entry points take the code by pointer, first
    "hrm_bch_encode": (_P, _P, _P, _I64, _P),
    "hrm_bch_scrub": (_P, _P, _P, _P, _P, _P, _P, _I64, _P),
    "hrm_burst_encode": (_P, _P, _P, _I64, _P),
    "hrm_burst_scrub": (_P, _P, _P, _P, _P, _P, _P, _I64, _P),
    # graph kernels: pointers, then sizes (and the BFS level) as int64
    "hrm_segsum_push": (_P, _P, _P, _P, _P, _I64, _I64, _P),
    "hrm_segsum_push_blocked": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                                _I64, _I64, _P),
    "hrm_frontier_update": (_P, _P, _P, _P, _P, _P, _I64, _I64, _P),
    # paged decode attention: nine pointers, then sizes and the dtype's code
    "hrm_paged_attn_decode": (_P,) * 9 + (_I64,) * 8 + (_P,),
}



class KernelError(RuntimeError):
    """The kernels could not be built, loaded or launched: a fault of the
    program or the machine, never an outcome of the data."""


# kernel name -> launches in this process
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "secded_encode", "secded_scrub", "parity_encode", "parity_check",
    "bitflip", "bch_encode", "bch_scrub", "burst_encode", "burst_scrub",
    "segsum_push", "segsum_push_blocked", "frontier_update",
    "paged_attn_decode")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libhrm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless a build of these sources exists.
    Returns its path; the compiler's output is kept beside it as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== nvcc {name}\n{out}")
            if p.returncode:
                raise KernelError(f"nvcc failed on {name}:\n{out}")
        out_so = tmp / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(out_so),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode:
            raise KernelError(f"nvcc link failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text("".join(log))
        out_so.replace(lib)          # atomic: readers never see a partial file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; the SEC-DED code
    tables are copied into its constant memory once, here."""
    lib = ctypes.CDLL(str(build()))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    masks = ((hsiao.MASK_HI.astype(np.uint64) << np.uint64(32))
             | hsiao.MASK_LO.astype(np.uint64))
    action = hsiao.SYNDROME_ACTION.astype(np.int8)   # -2, -1, 0..71 all fit
    rc = lib.hrm_secded_set_tables(masks.ctypes.data, action.ctypes.data)
    if rc:
        raise KernelError(f"copying the SEC-DED tables failed: CUDA error {rc}")
    return lib


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (take the plain version); raises otherwise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def launch(kernel: str, *args) -> None:
    """Call C entry point ``hrm_<kernel>`` on the current stream of the
    current device, raise on a launch error and count the launch."""
    fn = getattr(library(), "hrm_" + kernel)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise KernelError(f"{kernel} kernel launch failed: CUDA error {rc}")
    LAUNCHES[kernel] += 1


def check_words(words: torch.Tensor) -> None:
    """Packed words: contiguous int64 of shape (rows, ROW_WORDS)."""
    if words.dtype != torch.int64 or words.dim() != 2 \
            or words.shape[1] != ROW_WORDS or not words.is_contiguous():
        raise ValueError(f"expected contiguous int64 (rows, {ROW_WORDS}) "
                         f"words, got {words.dtype} {tuple(words.shape)}")


def check_side(side: torch.Tensor, words: torch.Tensor, width: int,
               name: str, dtype: torch.dtype = torch.uint8) -> None:
    """A sidecar of ``dtype`` and shape (rows, width) beside ``words``:
    uint8 for parity and SEC-DED, uint16 for DEC-TED and BURST."""
    if side.dtype != dtype or tuple(side.shape) != (
            words.shape[0], width) or not side.is_contiguous():
        raise ValueError(f"expected contiguous {dtype} {name} of shape "
                         f"({words.shape[0]}, {width}), got {side.dtype} "
                         f"{tuple(side.shape)}")
