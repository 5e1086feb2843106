"""Structured span tracing for the query lifecycle (DESIGN.md §Observability).

A :class:`Tracer` records a tree of :class:`Span`\\s — prepare phases
(``parse`` / ``plan`` / ``lower`` / ``compile``), per-execution ``execute``
spans, and the per-IR-op spans the profiling walk emits from
``core.executor.walk_ir``. The active tracer lives in a :mod:`contextvars`
ContextVar, so recording composes with nested calls and never leaks across
threads/async contexts.

Zero-overhead contract: tracing is **off by default** and the disabled fast
path allocates nothing — :func:`span` returns the module-level
:data:`NULL_SPAN` singleton (a no-op context manager with ``__slots__ = ()``),
and :func:`annotate` is one ContextVar read plus a ``None`` check. Nothing in
this module imports torch at module load; :meth:`Span.fence` imports it lazily.

PyTorch runs eagerly and CUDA launches return before the device finishes, so
a span's wall time measures enqueue; :meth:`Span.fence` synchronises the card
to record device-done time.
"""
from __future__ import annotations

import json
import time
from contextvars import ContextVar

_TRACER: ContextVar["Tracer | None"] = ContextVar("repro_obs_tracer", default=None)


class Span:
    """One timed node: wall time (``__exit__`` − ``__enter__``) plus the
    optional device-sync'd kernel time recorded by :meth:`fence` — the
    ``torch.cuda.synchronize``-fenced duration from span entry to device-done."""

    __slots__ = ("name", "meta", "children", "status", "t0", "wall_ms", "kernel_ms")

    def __init__(self, name: str, **meta):
        self.name = name
        self.meta = dict(meta)
        self.children: list[Span] = []
        self.status = "ok"
        self.t0 = 0.0
        self.wall_ms: float | None = None
        self.kernel_ms: float | None = None

    def annotate(self, **kv) -> None:
        self.meta.update(kv)

    def fence(self, value):
        """Block until the device work backing ``value`` completes and record
        the fenced duration since span entry as ``kernel_ms``. Returns
        ``value`` so call sites can fence inline. CPU tensors need no fence;
        once CUDA is initialised the whole device is synchronised."""
        sync()
        self.kernel_ms = (time.perf_counter() - self.t0) * 1e3
        return value

    def __enter__(self) -> "Span":
        tr = _TRACER.get()
        if tr is not None:
            tr._attach(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.wall_ms = (time.perf_counter() - self.t0) * 1e3
        if exc_type is not None:
            self.status = f"error:{exc_type.__name__}"
        tr = _TRACER.get()
        if tr is not None:
            tr._detach(self)
        return False  # never swallow the exception

    def self_wall_ms(self) -> float | None:
        """Wall time minus direct children — the span's own share."""
        if self.wall_ms is None:
            return None
        child = sum(c.wall_ms or 0.0 for c in self.children)
        return max(self.wall_ms - child, 0.0)

    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "status": self.status}
        if self.wall_ms is not None:
            d["wall_ms"] = round(self.wall_ms, 4)
        if self.kernel_ms is not None:
            d["kernel_ms"] = round(self.kernel_ms, 4)
        if self.meta:
            d["meta"] = {
                k: (v if isinstance(v, (int, float, str, bool, type(None))) else str(v))
                for k, v in self.meta.items()
            }
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


def sync() -> None:
    """Wait for the card's queued work, once CUDA is initialised (a CPU-only
    run has nothing to wait for)."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _NullSpan:
    """The disabled-tracer fast path: a shared, allocation-free no-op span."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def annotate(self, **kv) -> None:
        pass

    def fence(self, value):
        return value


NULL_SPAN = _NullSpan()


class Tracer:
    """Span sink: roots + the open-span stack. Exception-safe by construction:
    ``Span.__exit__`` pops everything above (and including) itself, so a span
    abandoned by an exception mid-subtree cannot corrupt later nesting."""

    def __init__(self):
        self.roots: list[Span] = []
        self._stack: list[Span] = []

    def _attach(self, sp: Span) -> None:
        (self._stack[-1].children if self._stack else self.roots).append(sp)
        self._stack.append(sp)

    def _detach(self, sp: Span) -> None:
        while self._stack:
            top = self._stack.pop()
            if top is sp:
                break

    def current_span(self) -> Span | None:
        return self._stack[-1] if self._stack else None

    def iter_spans(self):
        """All spans, preorder."""
        stack = list(reversed(self.roots))
        while stack:
            sp = stack.pop()
            yield sp
            stack.extend(reversed(sp.children))

    def to_dict(self) -> dict:
        return {"spans": [sp.to_dict() for sp in self.roots]}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)


def current() -> Tracer | None:
    """The active tracer, or None when tracing is disabled (the default)."""
    return _TRACER.get()


def enabled() -> bool:
    return _TRACER.get() is not None


def span(name: str, **meta):
    """Open a span under the active tracer; the :data:`NULL_SPAN` no-op when
    tracing is disabled. Use as ``with span("lower") as sp: ...``."""
    if _TRACER.get() is None:
        return NULL_SPAN
    return Span(name, **meta)


def annotate(**kv) -> None:
    """Attach metadata to the innermost open span (no-op when disabled)."""
    tr = _TRACER.get()
    if tr is not None and tr._stack:
        tr._stack[-1].meta.update(kv)


class recording:
    """``with recording() as tracer: ...`` — install a tracer for the block.

    Nests: an inner ``recording`` shadows the outer one for its extent (the
    outer tracer resumes afterwards — ContextVar token reset)."""

    def __init__(self, tracer: Tracer | None = None):
        self.tracer = tracer if tracer is not None else Tracer()
        self._token = None

    def __enter__(self) -> Tracer:
        self._token = _TRACER.set(self.tracer)
        return self.tracer

    def __exit__(self, exc_type, exc, tb) -> bool:
        _TRACER.reset(self._token)
        return False
