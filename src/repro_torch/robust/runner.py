"""Deadline + degradation-ladder execution of prepared queries.

:func:`run_with_policy` executes a :class:`repro_torch.core.engine.
PreparedQuery` under a fault-tolerance policy instead of letting exceptions
escape:

  * **Deadline** — a per-query wall-clock budget. Installed in a ContextVar
    (:func:`deadline_scope`) so the executor's IR walk checks it at each op's
    entry, in the plain fold and in the recorded one, and the
    ``fragment_loop`` walk once per chunk of paths (``core.executor`` calls
    :func:`check_deadline`); checked again after the device fence of every
    attempt. A query that overruns raises
    :class:`repro_torch.robust.errors.DeadlineExceeded`.

  * **Degradation ladder** — on ``ExecutionError`` / ``ResourceError`` /
    deadline pressure, execution falls to the next cheaper-or-safer rung and
    the result is annotated degraded::

        active          the prepared executable as compiled (the block list
                        where engaged, fused regions where the fusion pass
                        formed them)
        unfused         the same plan with fused regions expanded back to
                        per-hop kernel calls (fusion="off") — sheds the
                        fused kernels, keeps block skipping
        scan            full-scan hop kernels (block_skipping="off") — sheds
                        the block list
        xla             the plain PyTorch versions (use_kernel=False) on the
                        same device — sheds the CUDA kernels entirely (the
                        reference's name for its XLA fallback, kept so that
                        counters and outcomes read alike)
        fragment_loop   the fragment-at-a-time walk (plain versions where the
                        plan falls back to the frontier) — the terminus

    Every rung below ``active`` interprets the *unfused* twin of the prepared
    plan (``core.fuse.unfuse_plan``), so a fault in the fused dispatch does
    not follow the query down the ladder. Results agree under the parity
    contract: exact for counts, MIN, MAX and EXISTS; float sums within
    float reordering (the card's atomics add in no fixed order).

  * **Retry** — failures whose ``retryable`` flag is set retry on the same
    rung with capped exponential backoff + deterministic jitter
    (:class:`RetryPolicy`) before demoting.

  * **Kernel faults are terminal** — a kernel that does not build, load or
    launch (``kernels.cuda_build.KernelError``), or a device fault at an
    attempt's fence, ends the query with a :class:`repro_torch.robust.errors.
    KernelFault` on the rung it hit: no retry, no demotion, so no query is
    answered by the plain versions because a kernel failed. The ladder
    demotes on the failures the fault sites inject, on ``ResourceError``
    and on deadlines.

Every execution attempt passes the ``runner.execute`` fault-injection site,
so chaos tests can fail/delay attempts without touching kernel internals.
Outcomes are returned, never raised: :class:`QueryOutcome` carries the value,
the rung that produced it, degradation status, and the terminal
:class:`QueryError` when all rungs failed.
"""
from __future__ import annotations

import random
import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..obs.metrics import REGISTRY, MetricsRegistry
from . import faults
from .admission import AdmissionController
from ..kernels.cuda_build import KernelError
from .errors import (
    DeadlineExceeded,
    KernelFault,
    QueryError,
    ValidationError,
    wrap_execution_error,
)

#: Rungs in demotion order. ``run_with_policy`` starts at the first rung and
#: walks right on failure; see module docstring for what each sheds.
LADDER = ("active", "unfused", "scan", "xla", "fragment_loop")


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

_DEADLINE: ContextVar["Deadline | None"] = ContextVar(
    "repro_torch_query_deadline", default=None
)


class Deadline:
    """Wall-clock budget anchored at construction time."""

    __slots__ = ("deadline_ms", "t0")

    def __init__(self, deadline_ms: float):
        self.deadline_ms = float(deadline_ms)
        self.t0 = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def remaining_ms(self) -> float:
        return self.deadline_ms - self.elapsed_ms()

    def expired(self) -> bool:
        return self.remaining_ms() <= 0.0

    def check(self, where: str = "op") -> None:
        el = self.elapsed_ms()
        if el > self.deadline_ms:
            raise DeadlineExceeded(
                f"deadline of {self.deadline_ms:.0f}ms exceeded at {where}",
                deadline_ms=self.deadline_ms, elapsed_ms=round(el, 3),
                where=where,
            )


class deadline_scope:
    """``with deadline_scope(dl): ...`` — install ``dl`` (or nothing when
    None) as the ambient deadline for the block. The executor's walk consults
    it between IR ops via :func:`check_deadline`."""

    def __init__(self, deadline: Deadline | None):
        self.deadline = deadline
        self._token = None

    def __enter__(self) -> "Deadline | None":
        self._token = _DEADLINE.set(self.deadline)
        return self.deadline

    def __exit__(self, exc_type, exc, tb) -> bool:
        _DEADLINE.reset(self._token)
        return False


def current_deadline() -> Deadline | None:
    return _DEADLINE.get()


def check_deadline(where: str = "op") -> None:
    """One ContextVar read when no deadline is active (the production fast
    path); raises :class:`DeadlineExceeded` past the budget otherwise."""
    dl = _DEADLINE.get()
    if dl is not None:
        dl.check(where)


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter: attempt k sleeps
    ``min(cap_ms, base_ms · 2^(k−1)) · (1 + jitter·u)``, u ∈ [−1, 1] drawn
    from a ``seed``-determined stream (reproducible chaos runs)."""

    max_attempts: int = 3
    base_ms: float = 5.0
    cap_ms: float = 200.0
    jitter: float = 0.2
    seed: int = 0

    def backoff_ms(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.cap_ms, self.base_ms * (2.0 ** max(attempt - 1, 0)))
        return raw * (1.0 + self.jitter * rng.uniform(-1.0, 1.0))


@dataclass
class RobustPolicy:
    """Everything :func:`run_with_policy` needs: retry knobs, the ladder (a
    subsequence of :data:`LADDER`), optional admission control, a default
    deadline, and the metrics registry demotion/error counters land on."""

    retry: RetryPolicy = field(default_factory=RetryPolicy)
    ladder: tuple[str, ...] = LADDER
    admission: AdmissionController | None = None
    deadline_ms: float | None = None
    registry: MetricsRegistry = field(default_factory=lambda: REGISTRY)

    def __post_init__(self):
        unknown = [r for r in self.ladder if r not in LADDER]
        if unknown:
            raise ValueError(f"unknown ladder rungs {unknown}; valid: {LADDER}")
        self._rng = random.Random(self.retry.seed)


@dataclass
class QueryOutcome:
    """The structured result of one policy-governed execution. ``status`` is
    ``ok`` (first rung, first attempt), ``degraded`` (answered, but after a
    retry/demotion — ``rung``/``demotions`` say how far it fell), or
    ``error`` (``error`` holds the terminal :class:`QueryError`)."""

    status: str
    value: np.ndarray | None
    rung: str
    attempts: int = 1
    demotions: tuple[str, ...] = ()
    error: QueryError | None = None
    elapsed_ms: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status != "error"

    @property
    def degraded(self) -> bool:
        return self.status == "degraded"

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "status": self.status, "rung": self.rung,
            "attempts": self.attempts, "elapsed_ms": round(self.elapsed_ms, 3),
        }
        if self.demotions:
            d["demotions"] = list(self.demotions)
        if self.error is not None:
            d.update(self.error.to_dict())
        return d


# ---------------------------------------------------------------------------
# Rung executables
# ---------------------------------------------------------------------------


def rung_fn(prepared, rung: str, batched: bool = False):
    """The executable for one ladder rung, compiled lazily from the prepared
    query's own device DB + lowered plan and cached on the PreparedQuery, so
    repeated degraded requests pay one compile per (rung, batched) pair. It
    returns a tensor on the DB's device, without synchronising."""
    cache = prepared.__dict__.setdefault("_rung_fns", {})
    key = (rung, batched)
    if key in cache:
        return cache[key]
    from ..core import executor as X
    from ..core.fuse import unfuse_plan

    db, phys = prepared.device_db, prepared.phys
    # every rung below "active" runs the unfused twin of the plan: a fault in
    # the fused kernel dispatch must not follow the query down the ladder
    uphys = unfuse_plan(phys) if phys is not None else phys
    frontier = X.compile_frontier_batched if batched else X.compile_frontier
    if rung == "active":
        fn = prepared.batched_fn if batched else prepared.fn
        if fn is None:
            raise ValidationError("batched execution needs at least one query parameter")
    elif rung == "unfused":
        fn = frontier(db, uphys, block_skipping=prepared.block_skipping, fusion="off")
    elif rung == "scan":
        fn = frontier(db, uphys, block_skipping="off", fusion="off")
    elif rung == "xla":
        fn = frontier(db, uphys, block_skipping="off", use_kernel=False, fusion="off")
    elif rung == "fragment_loop":
        loop = X.compile_fragment_loop_batched if batched else X.compile_fragment_loop
        fn = loop(db, uphys, block_skipping="off", use_kernel=False)
    else:
        raise ValueError(f"unknown ladder rung {rung!r}; valid: {LADDER}")
    cache[key] = fn
    return fn


# ---------------------------------------------------------------------------
# The policy-governed execution loop
# ---------------------------------------------------------------------------


def _attempt(prepared, rung: str, args, deadline: Deadline | None,
             batched: bool):
    """One execution attempt on one rung: fault site → compile/lookup →
    call → device fence → deadline check. The fence (a synchronise of the
    result's device) surfaces an asynchronous CUDA fault inside the attempt,
    where it is wrapped as a kernel fault. Raises QueryError on any failure:
    :class:`KernelFault` for a kernel that failed or a device fault."""
    import torch

    faults.fire("runner.execute", rung=rung, query=prepared.sql.strip()[:80])
    try:
        with deadline_scope(deadline):
            fn = rung_fn(prepared, rung, batched=batched)
            out = fn(*args)
            if out.device.type == "cuda":
                try:
                    torch.cuda.synchronize(out.device)
                except RuntimeError as e:
                    raise KernelError(f"device fault at the fence: {e}") from e
    except QueryError:
        raise
    except KernelError as e:
        fault = KernelFault(str(e), rung=rung, strategy=prepared.strategy)
        raise fault from e
    except Exception as e:  # noqa: BLE001 — normalize foreign exceptions
        raise wrap_execution_error(e, rung=rung, strategy=prepared.strategy)
    if deadline is not None:
        deadline.check("device fence")
    return out.cpu().numpy()


def _run_ladder(prepared, args, policy: RobustPolicy,
                deadline: Deadline | None, batched: bool,
                t0: float) -> QueryOutcome:
    reg = policy.registry
    attempts, demotions = 0, []
    last_err: QueryError | None = None
    for rung in policy.ladder:
        retries = 0
        while True:
            attempts += 1
            try:
                value = _attempt(prepared, rung, args, deadline, batched)
                status = (
                    "ok" if attempts == 1 and not demotions else "degraded"
                )
                if status == "degraded":
                    reg.counter("robust.degraded_results").inc()
                return QueryOutcome(
                    status, value, rung, attempts, tuple(demotions),
                    elapsed_ms=(time.perf_counter() - t0) * 1e3,
                )
            except QueryError as e:
                last_err = e.with_context(rung=rung)
                reg.counter(f"robust.errors.{e.code}").inc()
                if isinstance(e, DeadlineExceeded):
                    reg.counter("robust.deadline_exceeded").inc()
                # a spent deadline is terminal: no rung can answer in time;
                # a kernel fault is too: the rungs below are no fallback
                if isinstance(e, KernelFault) or (
                        deadline is not None and deadline.expired()):
                    return QueryOutcome(
                        "error", None, rung, attempts, tuple(demotions),
                        error=last_err,
                        elapsed_ms=(time.perf_counter() - t0) * 1e3,
                    )
                if e.retryable and retries < policy.retry.max_attempts - 1:
                    retries += 1
                    reg.counter("robust.retries").inc()
                    wait = policy.retry.backoff_ms(retries, policy._rng)
                    if deadline is None or deadline.remaining_ms() > wait:
                        time.sleep(wait / 1e3)
                        continue
                break  # exhausted retries (or no time to back off): demote
        demotions.append(rung)
        reg.counter("robust.demotions").inc()
        reg.counter(f"robust.demotions.{rung}").inc()
    return QueryOutcome(
        "error", None, policy.ladder[-1], attempts, tuple(demotions),
        error=last_err, elapsed_ms=(time.perf_counter() - t0) * 1e3,
    )


def run_with_policy(prepared, params: dict, deadline_ms: float | None = None,
                    policy: RobustPolicy | None = None) -> QueryOutcome:
    """Execute one parameter binding of ``prepared`` under ``policy``.
    Returns a :class:`QueryOutcome`; never raises for query-shaped failures
    (validation, admission, execution, deadline) — those come back as
    ``status="error"`` with the typed error attached."""
    policy = policy if policy is not None else RobustPolicy()
    t0 = time.perf_counter()
    dms = deadline_ms if deadline_ms is not None else policy.deadline_ms
    deadline = Deadline(dms) if dms is not None else None
    try:
        prepared.validate_params(params)
        if policy.admission is not None:
            policy.admission.admit(prepared, batch=1)
    except QueryError as e:
        policy.registry.counter(f"robust.errors.{e.code}").inc()
        return QueryOutcome(
            "error", None, policy.ladder[0], 0, error=e,
            elapsed_ms=(time.perf_counter() - t0) * 1e3,
        )
    args = [params[n] for n in prepared.param_names]
    return _run_ladder(prepared, args, policy, deadline, False, t0)


def run_batch_with_policy(
    prepared, param_arrays: dict, deadline_ms: float | None = None,
    policy: RobustPolicy | None = None,
) -> list[QueryOutcome]:
    """Policy-governed form of ``PreparedQuery.execute_batch``: B parameter
    bindings in one pass, one :class:`QueryOutcome` per binding (all rows of
    a surviving batch share status/rung; a rejected/failed batch yields per-
    row error outcomes). Admission may *demote* an over-budget batch to
    serial single-query execution — degraded, but within budget."""
    from ..core.engine import batch_bucket

    policy = policy if policy is not None else RobustPolicy()
    t0 = time.perf_counter()
    dms = deadline_ms if deadline_ms is not None else policy.deadline_ms
    deadline = Deadline(dms) if dms is not None else None
    try:
        args, B = prepared._batch_args(param_arrays)
    except QueryError as e:
        policy.registry.counter(f"robust.errors.{e.code}").inc()
        n = _best_effort_batch_len(param_arrays)
        out = QueryOutcome("error", None, policy.ladder[0], 0, error=e)
        return [out] * max(n, 1)
    serial = False
    if policy.admission is not None:
        try:
            decision = policy.admission.admit(prepared, batch=B,
                                              allow_demote=True)
            serial = decision.action == "demote"
        except QueryError as e:
            policy.registry.counter(f"robust.errors.{e.code}").inc()
            out = QueryOutcome("error", None, policy.ladder[0], 0, error=e)
            return [out] * B
    if serial:
        policy.registry.counter("robust.degraded_results").inc(B)
        outs = []
        for b in range(B):
            params = {
                n: np.asarray(a[b]).item()
                for n, a in zip(prepared.param_names, args)
            }
            oc = run_with_policy(prepared, params, deadline_ms=dms,
                                 policy=policy)
            if oc.status == "ok":  # serial demotion is itself a degradation
                oc.status = "degraded"
            outs.append(oc)
        return outs
    bucket = batch_bucket(B)
    if bucket != B:
        args = [
            np.concatenate([a, np.repeat(a[-1:], bucket - B, axis=0)])
            for a in args
        ]
    oc = _run_ladder(prepared, args, policy, deadline, True, t0)
    if oc.value is not None:
        rows = oc.value[:B]
        return [
            QueryOutcome(oc.status, rows[b], oc.rung, oc.attempts,
                         oc.demotions, elapsed_ms=oc.elapsed_ms)
            for b in range(B)
        ]
    return [oc] * B


def _best_effort_batch_len(param_arrays: dict) -> int:
    for v in param_arrays.values():
        try:
            return len(v)
        except TypeError:
            continue
    return 1
