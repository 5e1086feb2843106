"""Query lifecycle errors and caches.

``errors``    — the typed :class:`QueryError` taxonomy every layer raises.
``admission`` — the prepared-query LRU.
"""
from .admission import PreparedCache  # noqa: F401
from .errors import (  # noqa: F401
    DeadlineExceeded,
    ExecutionError,
    IntegrityError,
    ParseError,
    PlanError,
    QueryError,
    ResourceError,
    ValidationError,
    wrap_execution_error,
)
