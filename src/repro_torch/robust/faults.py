"""Deterministic, seedable fault injection.

Mirrors ``obs/trace.py``'s design: the active :class:`FaultPlan` lives in a
:mod:`contextvars` ContextVar, the disabled fast path is one ContextVar read
returning immediately, and activation is a context manager (:class:`active`)
so plans never leak across tests/threads. The site names, modes and seeding
are the reference's (``repro.robust.faults``), so one chaos plan addresses
both packages alike.

Injection sites are plain function calls threaded through the codebase::

    from repro_torch.robust import faults
    faults.fire("ops.fragment_spmv")          # may raise or sleep
    out = faults.corrupt("storage.materialize", out)   # may transform value

Registered sites (the site registry below is the documentation contract —
chaos tests address faults by these names):

    engine.prepare          parse/plan/lower/compile of one query
    ops.fragment_spmv       SpMV kernel dispatch (single-query hop)
    ops.fragment_spmv_packed    decode-fused SpMV dispatch
    ops.fragment_spmm       SpMM kernel dispatch (batched hop)
    ops.fragment_spmm_packed    decode-fused SpMM dispatch
    ops.fragment_spmv_fused / ops.fragment_spmm_fused
                            a fused region's launch (only where it fuses)
    storage.materialize     whole-column decode in the device column store
    snapshot.load           snapshot restore (fire at entry; corrupt applies
                            to each loaded array *before* checksum verify)
    scrub.verify            scrubber encoded-bytes re-read (corrupt emulates
                            at-rest device corruption for one verification)
    runner.execute          one ladder-rung execution attempt
    serve.request           one micro-batch of the serve loop, before it
                            runs (``launch/serve.py``)

The ``ops.*`` sites fire whenever the caller asked for the kernel
(``use_kernel=True``), before the dispatch decides where it runs, so a plan
poisons the kernel path on the CPU (where the plain versions run) as on the
card. PyTorch runs eagerly: a site fires on every call, not once per
compile as in the traced reference.

Sites match by exact name or prefix: a spec with ``site="ops."`` fires at
every kernel-dispatch site. Determinism: each :class:`FaultSpec` draws from
its own ``random.Random`` stream seeded by ``(plan_seed, spec_index)``, so a
given (seed, call sequence) always fires the same faults regardless of which
other specs exist.

Modes:

    raise    — raise a retryable :class:`repro_torch.robust.errors.ExecutionError`
               (code ``FAULT_INJECTED``), or a caller-supplied exception.
    delay    — ``time.sleep(delay_ms)``: trips deadlines without failing.
    corrupt  — transform a value flowing through a ``corrupt()`` site
               (default: numeric negation). Corrupt-then-restore by
               construction: the transformation applies to the *returned*
               value only; caches/stored arrays keep the original, so the
               corruption vanishes when the plan deactivates.
"""
from __future__ import annotations

import random
import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Callable

from .errors import ExecutionError

_PLAN: ContextVar["FaultPlan | None"] = ContextVar("repro_torch_fault_plan", default=None)

MODES = ("raise", "delay", "corrupt")


@dataclass
class FaultSpec:
    """One fault: where (``site`` exact name or prefix), what (``mode``),
    how often (``prob`` per matching call), and bounds (skip the first
    ``after`` matching calls, fire at most ``max_fires`` times; None ⇒
    unbounded)."""

    site: str
    mode: str = "raise"
    prob: float = 1.0
    delay_ms: float = 0.0
    after: int = 0
    max_fires: int | None = None
    error: Callable[[], BaseException] | None = None
    mutate: Callable[[Any], Any] | None = None
    # runtime state (owned by the enclosing plan)
    calls: int = field(default=0, repr=False)
    fires: int = field(default=0, repr=False)
    _rng: random.Random = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"fault mode must be one of {MODES}, got {self.mode!r}")

    def matches(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site)

    def should_fire(self) -> bool:
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self.fires += 1
        return True


class FaultPlan:
    """A seeded set of :class:`FaultSpec`\\s. Stats (``calls``/``fires`` per
    spec) accumulate while the plan is active — chaos tests assert on them."""

    def __init__(self, seed: int = 0, specs: list[FaultSpec] | None = None):
        self.seed = int(seed)
        self.specs: list[FaultSpec] = []
        for s in specs or []:
            self.add(s)

    def add(self, spec: FaultSpec) -> "FaultPlan":
        spec._rng = random.Random(self.seed * 1_000_003 + len(self.specs))
        self.specs.append(spec)
        return self

    def total_fires(self) -> int:
        return sum(s.fires for s in self.specs)

    def stats(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {}
        for s in self.specs:
            d = out.setdefault(f"{s.site}:{s.mode}", {"calls": 0, "fires": 0})
            d["calls"] += s.calls
            d["fires"] += s.fires
        return out


def current() -> FaultPlan | None:
    return _PLAN.get()


class active:
    """``with active(plan): ...`` — install a fault plan for the block."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._token = None

    def __enter__(self) -> FaultPlan:
        self._token = _PLAN.set(self.plan)
        return self.plan

    def __exit__(self, exc_type, exc, tb) -> bool:
        _PLAN.reset(self._token)
        return False


def fire(site: str, **ctx: Any) -> None:
    """Raise-or-delay injection point. One ContextVar read when no plan is
    active (the production fast path)."""
    plan = _PLAN.get()
    if plan is None:
        return
    for spec in plan.specs:
        if spec.mode == "corrupt" or not spec.matches(site):
            continue
        if not spec.should_fire():
            continue
        if spec.mode == "delay":
            time.sleep(spec.delay_ms / 1e3)
            continue
        if spec.error is not None:
            raise spec.error()
        raise ExecutionError(
            f"injected fault at {site}", code="FAULT_INJECTED",
            retryable=True, site=site, **ctx,
        )


def corrupt(site: str, value: Any) -> Any:
    """Value-transforming injection point. Returns ``value`` untouched unless
    a corrupt-mode spec matches and fires; the caller must pass the result
    onward without storing it (corrupt-then-restore contract)."""
    plan = _PLAN.get()
    if plan is None:
        return value
    for spec in plan.specs:
        if spec.mode != "corrupt" or not spec.matches(site):
            continue
        if not spec.should_fire():
            continue
        value = spec.mutate(value) if spec.mutate is not None else -value
    return value
