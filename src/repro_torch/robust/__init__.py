"""Fault-tolerant query lifecycle.

``errors``    — the typed :class:`QueryError` taxonomy every layer raises.
``admission`` — pre-execute memory budgeting + the prepared-query LRU.
``runner``    — deadlines, retry/backoff, and the degradation ladder.
``faults``    — deterministic, seedable fault injection for chaos tests.
``scrub``     — background integrity scrubbing + heal-from-snapshot.
"""
from .admission import (  # noqa: F401
    AdmissionController,
    AdmissionDecision,
    MemoryBudget,
    PreparedCache,
    estimate_query_bytes,
)
from .errors import (  # noqa: F401
    DeadlineExceeded,
    ExecutionError,
    IntegrityError,
    KernelFault,
    ParseError,
    PlanError,
    QueryError,
    ResourceError,
    ValidationError,
    wrap_execution_error,
)
from .scrub import Scrubber  # noqa: F401
from .runner import (  # noqa: F401
    LADDER,
    Deadline,
    QueryOutcome,
    RetryPolicy,
    RobustPolicy,
    check_deadline,
    deadline_scope,
    run_batch_with_policy,
    run_with_policy,
    rung_fn,
)
