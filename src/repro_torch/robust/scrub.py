"""Incremental integrity scrubbing of the device column store.

A flipped bit in one packed BCA word silently poisons every query that
streams the column — the worst failure mode an analytics engine has, because
nothing crashes. The scrubber closes the detection gap the verified-read
path (storage/columns.py) leaves open: reads verify the *decoded* view at
materialize time, but columns consumed only through fused packed kernels are
never materialized, and at-rest corruption between reads goes unnoticed
until it is served. :class:`Scrubber` walks every device column round-robin,
a budgeted few per tick, re-hashing

  * the **encoded bytes** (packed words / dictionary / dense array — exactly
    what HBM holds) against the manifest ``encoded_crc``, and
  * the **decode memo** (``_dense``), when present, against ``decoded_crc``
    — a corrupted memo is healed for free by dropping it (the encoded truth
    re-decodes on next use).

Detection → containment → repair: a column whose encoded bytes fail is
immediately **quarantined** (every read raises
:class:`~repro_torch.robust.errors.IntegrityError` — wrong answers become
typed errors), then **healed** from the latest checksummed snapshot
(``storage/snapshot.py``) by swapping in the snapshot's verified arrays as
new tensors on the column's device, and **re-verified** before the
quarantine lifts. Plans lowered before the heal still hold the old tensors:
the owner calls ``GQFastEngine.invalidate_prepared()`` (``on_heal`` is the
hook) and a new prepare reads the healed bytes. A column that cannot be healed
(no snapshot configured, or the snapshot read itself fails) stays
quarantined — detected-and-contained beats silent corruption.

Every hash runs on the column's device (``storage.integrity.crc32c``: the
CUDA kernel on the card), launched on the calling thread's current stream —
the scrubber's own thread when :meth:`Scrubber.start` runs it — and read
back (a synchronise of that stream) before it is compared.

Fault site ``scrub.verify``: ``raise``/``delay`` fire per scrubbed column;
``corrupt`` transforms the scrubber's *read* of the encoded bytes (the
stored arrays are untouched), emulating at-rest corruption for exactly the
fired verifications — how chaos tests run a detect→heal→re-verify cycle.

Metrics (``robust.integrity.*``): ``cols_verified``, ``scrub_detected``,
``scrub_repairs``, ``scrub_failures``, ``memo_drops``, and the per-tick
latency histogram ``scrub_ms``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ..kernels.cuda_build import KernelError
from ..obs.metrics import REGISTRY, MetricsRegistry
from . import faults as _faults
from .errors import IntegrityError

# NOTE: ..storage imports stay function-local throughout this module —
# storage.columns imports the robust package (fault sites), so a module-level
# import here would cycle.

#: Re-reads of the encoded bytes before a mismatch counts as real (absorbs
#: fault-injected transient read corruption without a spurious heal cycle).
VERIFY_RETRIES = 2

#: Post-heal verification attempts before declaring the repair failed.
REPAIR_RETRIES = 3


def _read_encoded(col) -> list:
    """The scrubber's view of a column's stored bytes — routed through the
    ``scrub.verify`` corrupt site so chaos plans can flip what the scrubber
    *sees* without touching what the store *holds*."""
    from ..storage.integrity import encoded_parts

    return [_faults.corrupt("scrub.verify", p) for p in encoded_parts(col)]


class Scrubber:
    """Budget-bounded background scrubber over one database's device columns.

    ``cols_per_tick`` bounds the work (hashing + potential decode) done per
    :meth:`tick` so scrubbing steals bounded time from serving;
    :meth:`start`/:meth:`stop` run ticks on a daemon thread,
    :meth:`scrub_full` drives one complete pass synchronously (the serve
    loop's pre-serving gate). ``on_heal(addr)`` fires after a successful
    repair — the serve loop uses it to invalidate prepared executables that
    may have closed over the replaced arrays."""

    def __init__(self, db, snapshot_dir: str | None = None,
                 generation: int | None = None, cols_per_tick: int = 2,
                 registry: MetricsRegistry = REGISTRY,
                 on_heal: Callable[[str], None] | None = None):
        from ..storage.integrity import attach_manifest

        self.db = db
        self.snapshot_dir = snapshot_dir
        self.generation = generation
        self.cols_per_tick = max(1, int(cols_per_tick))
        self.registry = registry
        self.on_heal = on_heal
        if getattr(db.device, "integrity", None) is None:
            attach_manifest(db.device)
        self._cursor = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _columns(self) -> list[tuple[str, tuple[str, str], str, Any]]:
        from ..storage.integrity import iter_columns

        return [
            (addr, tk, name, col)
            for addr, tk, name, col in iter_columns(self.db.device)
            if addr in (self.db.device.integrity or {})
        ]

    def _count(self, name: str, n: int = 1) -> None:
        self.registry.counter(f"robust.integrity.{name}").inc(n)

    # ------------------------------------------------------------------
    def verify_column(self, addr: str, tk: tuple[str, str], name: str,
                      col) -> bool:
        """Verify one column's encoded bytes (+ memo), healing on mismatch.
        Returns True when the column is good (possibly after repair)."""
        from ..storage.integrity import crc32c_parts

        _faults.fire("scrub.verify", column=addr)
        dig = self.db.device.integrity[addr]
        expected = int(dig["encoded_crc"])
        ok = False
        for _ in range(1 + VERIFY_RETRIES):
            if crc32c_parts(_read_encoded(col)) == expected:
                ok = True
                break
        if not ok:
            self._count("scrub_detected")
            ok = self._heal(addr, tk, name, col, dig)
        if ok:
            self._verify_memo(col, dig)
            self._count("cols_verified")
        return ok

    def _verify_memo(self, col, dig: dict[str, Any]) -> None:
        """A corrupted decode memo never needs the snapshot: drop it and the
        verified encoded bytes re-decode on the next materialize."""
        from ..storage.integrity import crc32c

        memo = getattr(col, "_dense", None)
        if memo is None or memo is getattr(col, "array", None):
            return
        if crc32c(memo) != int(dig["decoded_crc"]):
            col._dense = None
            self._count("memo_drops")

    def _heal(self, addr: str, tk: tuple[str, str], name: str, col,
              dig: dict[str, Any]) -> bool:
        """Quarantine → reload encoded arrays from the snapshot → re-verify →
        lift quarantine. Snapshot reads here deliberately bypass the
        ``snapshot.load`` fault site (``load_column_arrays``): the heal path
        must not be re-corrupted by a chaos spec aimed at full restores. The
        healed tensors are new ones on the column's device."""
        from ..storage.columns import DenseColumn, DictPackedColumn
        from ..storage.integrity import crc32c, crc32c_parts, decode_fresh, encoded_parts
        from ..storage.snapshot import column_from_arrays, latest_generation, load_column_arrays

        t, k = tk
        col._quarantined = True
        if self.snapshot_dir is None:
            self._count("scrub_failures")
            return False
        try:
            gen = self.generation
            if gen is None:
                gen = latest_generation(self.snapshot_dir)
            if gen is None:
                raise FileNotFoundError(
                    f"no snapshot generations in {self.snapshot_dir}"
                )
            device = encoded_parts(col)[0].device
            arrays, cmeta = load_column_arrays(self.snapshot_dir, gen, t, k, name,
                                               device=device)
            fresh = column_from_arrays(arrays, cmeta, device, addr)
            if isinstance(col, DenseColumn):
                col.array = fresh.array
            else:
                col.words = fresh.words
                if isinstance(col, DictPackedColumn):
                    col.dictionary = fresh.dictionary.to(col.dictionary.dtype)
                col._dense = None
            for _ in range(REPAIR_RETRIES):
                if (crc32c_parts(_read_encoded(col)) == int(dig["encoded_crc"])
                        and crc32c(decode_fresh(col)) == int(dig["decoded_crc"])):
                    col._quarantined = False
                    self._count("scrub_repairs")
                    if self.on_heal is not None:
                        self.on_heal(addr)
                    return True
            raise IntegrityError(
                f"column {addr} still fails verification after snapshot heal",
                table=t, key=k, column=name,
                expected_crc=int(dig["encoded_crc"]),
            )
        except KernelError:
            raise  # a kernel that fails is the deployment's fault, not the column's
        except Exception:  # noqa: BLE001 — a failed heal must not kill the loop
            self._count("scrub_failures")
            return False  # stays quarantined: contained, not silent

    # ------------------------------------------------------------------
    def tick(self) -> dict[str, int]:
        """Scrub the next ``cols_per_tick`` columns (round-robin). Returns
        ``{"verified": n_ok, "healed": ..., "failed": ...}`` for this tick."""
        t0 = time.perf_counter()
        stats = {"verified": 0, "healed": 0, "failed": 0}
        with self._lock:
            cols = self._columns()
            if not cols:
                return stats
            for _ in range(min(self.cols_per_tick, len(cols))):
                addr, tk, name, col = cols[self._cursor % len(cols)]
                self._cursor += 1
                before = self.registry.counter(
                    "robust.integrity.scrub_repairs"
                ).value
                if self.verify_column(addr, tk, name, col):
                    after = self.registry.counter(
                        "robust.integrity.scrub_repairs"
                    ).value
                    stats["healed" if after > before else "verified"] += 1
                else:
                    stats["failed"] += 1
        self.registry.histogram("robust.integrity.scrub_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
        return stats

    def scrub_full(self) -> dict[str, int]:
        """One synchronous pass over every column — the pre-serving gate."""
        total = {"verified": 0, "healed": 0, "failed": 0}
        n = len(self._columns())
        ticks = (n + self.cols_per_tick - 1) // self.cols_per_tick
        for _ in range(ticks):
            for k, v in self.tick().items():
                total[k] += v
        return total

    # ------------------------------------------------------------------
    def start(self, interval_s: float = 1.0) -> None:
        """Run :meth:`tick` every ``interval_s`` on a daemon thread. The
        caller's context (including any active chaos ``FaultPlan`` — a
        ContextVar, which threads do NOT inherit by default) is copied into
        the thread so ``scrub.verify`` faults fire there too."""
        import contextvars

        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — scrubbing must not crash serve
                    self._count("scrub_failures")

        self._stop.clear()
        ctx = contextvars.copy_context()
        self._thread = threading.Thread(
            target=lambda: ctx.run(loop), name="scrubber", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None
