"""Typed error taxonomy for the query lifecycle (DESIGN.md §Robustness).

Every failure the engine can produce surfaces as a :class:`QueryError`
subclass carrying a machine-readable ``code``, a ``retryable`` flag (may a
caller expect a different outcome from simply trying again?), and a free-form
``context`` dict (query text / token position / op id / strategy / byte
estimates — whatever the raise site knows). ``to_dict()`` is the wire form
the serve loop returns for failed requests.

Compatibility contract: each subclass *also* inherits the builtin exception
class the pre-taxonomy code raised (``ParseError`` is a ``SyntaxError``,
``PlanError``/``ValidationError`` are ``ValueError``s, …) so callers written
against the old surface — including the existing test suite — keep working.
The hierarchy:

    QueryError
    ├── ParseError         (SyntaxError)   code=PARSE        retryable=False
    ├── PlanError          (ValueError)    code=PLAN         retryable=False
    ├── ValidationError    (ValueError,
    │                       TypeError)     code=VALIDATION   retryable=False
    ├── ResourceError      (RuntimeError)  code=RESOURCE     retryable=False
    ├── DeadlineExceeded   (TimeoutError)  code=DEADLINE     retryable=True
    ├── ExecutionError     (RuntimeError)  code=EXECUTION    retryable=True
    │   └── KernelFault                    code=KERNEL       retryable=False
    └── IntegrityError     (RuntimeError)  code=INTEGRITY    retryable=False

``retryable`` defaults are per-class but overridable per-raise (e.g. an
injected transient kernel fault is a retryable ExecutionError, a shape
mismatch inside the same class is not). This module is dependency-free —
anything in the repo may import it without cycles.
"""
from __future__ import annotations

from typing import Any


class QueryError(Exception):
    """Base of the taxonomy. ``code`` is stable and machine-readable;
    ``context`` carries raise-site details; ``retryable`` drives the runner's
    backoff policy (robust/runner.py)."""

    code: str = "QUERY"
    default_retryable: bool = False

    def __init__(self, message: str, *, code: str | None = None,
                 retryable: bool | None = None, **context: Any):
        super().__init__(message)
        self.message = message
        if code is not None:
            self.code = code
        self.retryable = (
            self.default_retryable if retryable is None else bool(retryable)
        )
        self.context: dict[str, Any] = dict(context)

    def with_context(self, **kv: Any) -> "QueryError":
        """Attach context discovered above the raise site (e.g. the engine
        adds the query text to a planner error) without clobbering what the
        raise site already recorded. Returns self for re-raise chaining."""
        for k, v in kv.items():
            self.context.setdefault(k, v)
        return self

    def to_dict(self) -> dict[str, Any]:
        """Wire form for structured error responses (launch/serve.py)."""
        return {
            "error": type(self).__name__,
            "code": self.code,
            "message": self.message,
            "retryable": self.retryable,
            "context": {
                k: (v if isinstance(v, (int, float, str, bool, type(None))) else str(v))
                for k, v in self.context.items()
            },
        }

    def __str__(self) -> str:
        if not self.context:
            return self.message
        ctx = ", ".join(f"{k}={v!r}" for k, v in self.context.items())
        return f"{self.message} [{ctx}]"


class ParseError(QueryError, SyntaxError):
    """SQL text rejected by the tokenizer/parser. Context: ``position``
    (character offset), ``near`` (the offending text), ``query``."""

    code = "PARSE"


class PlanError(QueryError, ValueError):
    """Query parsed but the normalizer/lowering rejected it: outside the
    relationship-query class, unknown table/column, unresolvable ref."""

    code = "PLAN"


class ValidationError(QueryError, ValueError, TypeError):
    """Bad execution-time inputs: missing/extra/ragged parameters, unknown
    knob values. Inherits both ValueError and TypeError because the
    pre-taxonomy surface raised either depending on the site."""

    code = "VALIDATION"


class ResourceError(QueryError, RuntimeError):
    """Admission control rejection or resource exhaustion: the query's
    predicted (or actual) footprint exceeds the configured budget. Context:
    ``predicted_bytes``, ``limit_bytes``, ``batch``."""

    code = "RESOURCE"


class DeadlineExceeded(QueryError, TimeoutError):
    """The per-query deadline expired. Context: ``deadline_ms``,
    ``elapsed_ms``, ``where`` (which lifecycle checkpoint tripped).
    Retryable by default: the same query may finish under a fresh deadline
    on a less loaded system or a cheaper ladder rung."""

    code = "DEADLINE"
    default_retryable = True


class ExecutionError(QueryError, RuntimeError):
    """Failure inside compiled execution or kernel dispatch. Context:
    ``op``, ``strategy``, ``site``. Retryable by default — transient device
    failures are this class's main production occupant; wrap-sites that know
    the failure is deterministic pass ``retryable=False``."""

    code = "EXECUTION"
    default_retryable = True


class KernelFault(ExecutionError):
    """A hand-written CUDA kernel did not build, load or launch, or the card
    faulted while a query ran (``kernels.cuda_build.KernelError`` and the
    device fence's error, chained). Terminal: the runner neither retries
    nor demotes on it, because the rungs below answer from the plain
    versions, which no query falls back to when a kernel fails. Context:
    ``rung``, ``strategy``."""

    code = "KERNEL"
    default_retryable = False


class IntegrityError(QueryError, RuntimeError):
    """Checksum mismatch on durable or device-resident data: a snapshot file
    whose bytes no longer hash to the manifest entry, a device column whose
    decoded view disagrees with its recorded digest, or a read of a
    quarantined column. Never retryable — retrying a read of corrupted data
    cannot yield a different answer; the remedy is restore/heal (the
    scrubber's quarantine → reload-from-snapshot → re-verify cycle), not
    another attempt. Context: ``table``/``key``/``column`` naming the
    offending column (or ``path``/``array`` for snapshot files),
    ``expected_crc``, ``actual_crc``, ``generation``."""

    code = "INTEGRITY"


def wrap_execution_error(exc: BaseException, **context: Any) -> QueryError:
    """Normalize an arbitrary exception escaping the execute path: QueryErrors
    pass through (context merged), anything else becomes a non-retryable
    ExecutionError chained to the original."""
    if isinstance(exc, QueryError):
        return exc.with_context(**context)
    err = ExecutionError(
        f"{type(exc).__name__}: {exc}", retryable=False, **context
    )
    err.__cause__ = exc
    return err
