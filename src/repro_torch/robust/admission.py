"""The prepared-query cache: a fixed-size LRU that bounds the engine's
prepared-query cache under many distinct query shapes; evictions are counted
on the shared metrics registry."""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any

from ..obs.metrics import REGISTRY, MetricsRegistry


class PreparedCache:
    """Fixed-capacity LRU for prepared queries: bounds cache growth under
    many distinct query shapes (each entry pins a lowered plan bound to
    device tensors). Eviction order is least-recently-*used* — ``get``
    refreshes.

    Thread-safe: concurrent callers touch one cache; an unguarded
    ``move_to_end`` during ``popitem`` corrupts the OrderedDict."""

    def __init__(self, capacity: int = 64,
                 registry: MetricsRegistry | None = None):
        if capacity < 1:
            raise ValueError(f"PreparedCache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.registry = registry if registry is not None else REGISTRY
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.RLock()

    def get(self, key):
        with self._lock:
            v = self._data.get(key)
            if v is not None:
                self._data.move_to_end(key)
        if v is not None:
            self.registry.counter("engine.prepared_cache_hits").inc()
        return v

    def put(self, key, value) -> None:
        evictions = 0
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evictions += 1
        if evictions:
            self.registry.counter("engine.prepared_cache_evictions").inc(evictions)

    def clear(self) -> int:
        """Drop every entry (device arrays were swapped under the prepared
        executables — a heal or generation reload). Returns entries dropped."""
        with self._lock:
            n = len(self._data)
            self._data.clear()
        if n:
            self.registry.counter("engine.prepared_cache_invalidations").inc(n)
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data
