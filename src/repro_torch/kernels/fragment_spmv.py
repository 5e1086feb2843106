"""CUDA kernel for Hopper: fused fragment join-aggregate (one relationship hop).

y[dst] ⊕= w[src] ⊗ m over the edge list of a GQ-Fast index — the frontier SpMV
that every ⋈/⋉+γ hop lowers to. The combine op ⊕ is a parameter (``op``:
'sum' | 'min' | 'max' | 'bool'), matching the executor's semiring plug-in
point. The kernel is ``csrc/fragment_spmv.cu`` (its header says what bounds it
and how it is built around that); this module builds it with ``nvcc`` for
``sm_90a`` at first use, loads it through ``ctypes`` and launches it on the
current stream.

Build: the source is compiled into ``_build/`` beside this file, named by the
hash of the source, so an edited kernel rebuilds and an unchanged one loads
the cached library. ``nvcc`` is found on ``PATH`` or under ``CUDA_HOME``
(default ``/usr/local/cuda``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .ref import IDENTITY

SOURCE = Path(__file__).resolve().parent / "csrc" / "fragment_spmv.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_OP_CODE = {"sum": 0, "min": 1, "max": 2, "bool": 3}

#: Kernel launches since import (or since a caller reset it): one per launch,
#: counted nowhere else — the evidence that a run went through the kernel.
LAUNCHES = 0

#: What the last build printed (``-Xptxas -v``: registers, spills) and how
#: long it took; ``None`` until the library was built in this process.
BUILD_LOG: str | None = None
BUILD_SECONDS: float | None = None

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the fragment_spmv CUDA "
        "kernel is built from source at first use"
    )


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _lib, BUILD_LOG, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"fragment_spmv-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            BUILD_SECONDS = time.perf_counter() - t0
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n{BUILD_LOG}")
            os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
        lib = ctypes.CDLL(str(so))
        fn = lib.fragment_spmv_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (materialise broadcasts first)")


def fragment_spmv(
    weights: torch.Tensor,  # f32[n_src], CUDA
    src_ids: torch.Tensor,  # i32[E], src-sorted CSR order
    dst_ids: torch.Tensor,  # i32[E]
    measures: torch.Tensor | None,  # f32[E] | None (measure 1 on every edge)
    n_dst: int,
    op: str = "sum",
) -> torch.Tensor:
    """Launch the hop kernel; returns f32[n_dst] starting from the
    ⊕-identity. Raises on anything the kernel does not take — it never falls
    back to the plain version."""
    global LAUNCHES
    if op not in _OP_CODE:
        raise ValueError(f"unknown combine op {op!r}")
    dev = weights.device if isinstance(weights, torch.Tensor) else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"fragment_spmv's CUDA kernel needs CUDA tensors, got {dev}")
    _check(weights, "weights", torch.float32, dev)
    _check(src_ids, "src_ids", torch.int32, dev)
    _check(dst_ids, "dst_ids", torch.int32, dev)
    E = src_ids.shape[0]
    if dst_ids.shape[0] != E:
        raise ValueError(f"dst_ids has {dst_ids.shape[0]} edges, src_ids {E}")
    if measures is not None:
        _check(measures, "measures", torch.float32, dev)
        if measures.shape[0] != E:
            raise ValueError(f"measures has {measures.shape[0]} edges, src_ids {E}")
    n_dst = int(n_dst)
    if n_dst < 0 or n_dst >= 2**31 or weights.shape[0] >= 2**31:
        raise ValueError(f"domain sizes must fit int32: n_src={weights.shape[0]}, n_dst={n_dst}")
    y = torch.full((n_dst,), IDENTITY[op], dtype=torch.float32, device=dev)
    if E == 0 or n_dst == 0:  # a grid of 0 blocks is an invalid launch
        return y
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fragment_spmv_launch(
            weights.data_ptr(), weights.shape[0], src_ids.data_ptr(),
            dst_ids.data_ptr(), measures.data_ptr() if measures is not None else None,
            E, y.data_ptr(), n_dst, _OP_CODE[op], stream,
        )
    if err != 0:
        raise RuntimeError(f"fragment_spmv kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y
