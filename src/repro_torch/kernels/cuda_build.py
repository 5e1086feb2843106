"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded through ``ctypes``. The library goes
into ``_build/`` beside this file, named by the hash of its source and of the
headers in ``csrc/``, so an edited kernel rebuilds and an unchanged one loads
the cached file. ``nvcc`` is found on ``PATH`` or under ``CUDA_HOME`` (default
``/usr/local/cuda``). Nothing is built when a module is imported: a library is
built at its first launch, or by :func:`build_all`, which starts one ``nvcc``
for each source at once (every library of the package by default:
``fragment_spmv``, ``fragment_spmv_packed``, ``fragment_spmv_fused``,
``fragment_spmm``, ``fragment_spmm_packed``, ``bitunpack``, ``bitmap_ops``,
``block_list``, ``crc32c``) and waits for all of them. A kernel that does
not build, load or launch raises :class:`KernelError`, which no caller turns
into a run of the plain version.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: Every CudaLibrary made so far, in the order the kernel modules made them.
LIBRARIES: list["CudaLibrary"] = []


class KernelError(RuntimeError):
    """A hand-written kernel failed to build (no ``nvcc``, a compile error),
    to load (``ctypes``) or to launch (a nonzero CUDA error code)."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are built "
        "from source at first use"
    )


class CudaLibrary:
    """One ``csrc/<name>.cu`` and its C entry points ``{fn: argtypes}`` (each
    returns a CUDA error code as ``int``). ``defines`` (``"NAME=value"``
    strings) are passed to nvcc as ``-D``: a build of the same source with
    another compile-time setting, in a library file of its own. ``source``
    names a ``.cu`` file elsewhere (a measurement script's own kernel), built
    the same way with ``csrc/`` on the include path."""

    def __init__(self, name: str, functions: dict[str, list], defines=(),
                 source: Path | None = None):
        self.name = name
        self.source = Path(source) if source is not None else CSRC / f"{name}.cu"
        self.functions = functions
        self.defines = tuple(defines)
        #: What the build printed (``-Xptxas -v``: registers, spills) and how
        #: long nvcc took; ``None`` until it was built in this process.
        self.build_log: str | None = None
        self.build_seconds: float | None = None
        self._lib = None
        self._lock = threading.Lock()
        LIBRARIES.append(self)

    def _so(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for hdr in sorted(CSRC.glob("*.cuh")):
            h.update(hdr.read_bytes())
        h.update(" ".join(self.defines).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start(self):
        """Start nvcc unless the library is loaded or cached: ``(proc, tmp,
        so, t0)`` or ``None``."""
        so = self._so()
        if self._lib is not None or so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in self.defines), f"-I{CSRC}",
             "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp, so, time.perf_counter()

    def finish(self, started) -> None:
        proc, tmp, so, t0 = started
        out, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        self.build_log = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelError(f"nvcc failed building {self.source.name}:\n{out}")
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; idempotent."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            started = self.start()
            if started is not None:
                self.finish(started)
            try:
                lib = ctypes.CDLL(str(self._so()))
                for fn, argtypes in self.functions.items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            except (OSError, AttributeError) as e:
                raise KernelError(f"loading {self.source.name}'s library failed: {e}") from e
            self._lib = lib
            return lib


def build_all(libraries=None) -> list[CudaLibrary]:
    """Build every library at once (one nvcc each, all started together),
    then load them; raises on the first that fails. ``None`` means every
    library of the package. Returns the libraries."""
    if libraries is None:
        from . import ops  # noqa: F401  (imports every kernel module)

        libraries = list(LIBRARIES)
    started = [(lib, lib.start()) for lib in libraries if lib._lib is None]
    for lib, s in started:
        if s is not None:
            lib.finish(s)
    for lib in libraries:
        lib.load()
    return libraries


def check_tensor(t, name: str, dtype: torch.dtype, device, ndim: int = 1) -> None:
    """What every kernel wrapper demands of a tensor argument: a contiguous
    ``ndim``-D tensor (1-D unless said) of ``dtype`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (materialise broadcasts first)")


def cuda_device(t, kernel: str) -> torch.device:
    """The CUDA device of ``t``; anything else raises (no CPU fallback)."""
    dev = t.device if isinstance(t, torch.Tensor) else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"{kernel}'s CUDA kernel needs CUDA tensors, got {dev}")
    return dev


def stream_of(dev: torch.device) -> int:
    """The handle of ``dev``'s current stream, as
    ``torch.cuda.current_stream(dev).cuda_stream`` gives it, without making
    a Stream object."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


#: Zeroed buffers that a kernel leaves zero after every launch (a last-CTA
#: ticket, a running sum), one for each (name, device, stream): launches on
#: one stream, which run in order, share a buffer, and launches on two
#: streams never do.
_STREAM_SCRATCH: dict[tuple[str, int, int], torch.Tensor] = {}


def stream_scratch(name: str, numel: int, dtype: torch.dtype, dev: torch.device,
                   stream: int) -> torch.Tensor:
    """The scratch ``name`` of ``stream``, the current stream of ``dev``: made
    zero (one ``torch.zeros``) at its first use, and kept zero from then on by
    the kernels that take it. Threads that launch on one stream share its
    buffer: two that both miss it store theirs by ``dict.setdefault`` (atomic
    under the interpreter lock), so both launch with the one stored, and
    their launches run in the stream's order."""
    key = (name, dev.index, stream)
    buf = _STREAM_SCRATCH.get(key)
    if buf is None:
        buf = _STREAM_SCRATCH.setdefault(key, torch.zeros(numel, dtype=dtype, device=dev))
    return buf


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise KernelError(f"{kernel} kernel launch failed: CUDA error {err}")


def launch(fn, kernel: str, dev: torch.device, *args) -> None:
    """The launch path of every kernel wrapper: the C entry ``fn`` (a
    function of a :class:`CudaLibrary`, returning a CUDA error code) called
    with ``args`` on ``dev``, and a :class:`KernelError` naming ``kernel`` on a
    nonzero code. ``dev`` is made the current device only when it is not
    already: the switch there and back is host time on every call (PERF.md
    §5 has what each piece of this path costs)."""
    if torch._C._cuda_getDevice() == dev.index:
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    raise_on(err, kernel)
