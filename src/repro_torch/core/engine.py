"""GQ-Fast engine facade (paper Fig. 4 architecture), on PyTorch.

``GQFastDatabase`` = Loader: builds both fragment indices per relationship table
and ships them to the device. ``GQFastEngine`` = Query Processor: SQL → RQNA
(parse + normalize/verify) → physical chain plan → lowered IR bound to device
tensors (prepare once / execute many, as JDBC-style prepared statements).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``; a
request for CUDA on a machine without it raises rather than running on the CPU.
The defaults are the reference's storage, skipping and fusion:
``device_encodings="auto"`` (bit-packed keys, decoded inside the hop kernel)
and ``prepare(block_skipping="auto", fusion="auto")``. Batched serving
(``PreparedQuery.execute_batch``, ``GQFastEngine.query_topk_batch``) answers
B parameter bindings in one pass whose hops each stream the edges once for
the whole batch. ``GQFastEngine(strategy=...)`` runs the frontier, the
fragment-at-a-time walk (``"fragment_loop"``) or picks between them per plan
(``"auto"``, from the selectivity estimate or a profile's observed
fractions); ``PreparedQuery.profile()`` and ``explain(analyze=True)`` time
every op and hold the estimate against what a run touched. Under a mesh
(``GQFastEngine(db, mesh=make_mesh(...))``, one process a rank over
``torch.distributed``) every query runs the ``distributed`` strategy: edges
sharded across the ranks, one all_reduce a hop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..kernels import params as KP
from ..obs import trace as T
from ..robust import faults as _faults
from ..robust.admission import PreparedCache
from ..robust.errors import QueryError, ValidationError
from . import executor as X
from .algebra import ChainPlan, RelHop, SeedIds
from .fragments import FragmentIndex, build_index
from .fuse import fuse_plan, fusion_groups, has_fused
from .lower import PhysicalPlan, lower
from .planner import plan_query
from .schema import Schema
from .sql import parse

#: The strategies ``GQFastEngine`` runs: the two compilers of
#: ``executor.STRATEGIES`` and ``"auto"``, which picks one of them per plan.
STRATEGY_MODES = ("frontier", "fragment_loop", "auto")


def resolve_device(device) -> torch.device:
    """``None`` means CUDA. CUDA requested where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValidationError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU",
            device=str(dev),
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValidationError(
            f"device must be 'cuda' or 'cpu', got {str(dev)!r}", device=str(dev)
        )
    return dev


class GQFastDatabase:
    """In-memory GQ-Fast database: both directions of every relationship table.

    ``device_encodings`` selects the device column store's per-column
    layout (``repro_torch.storage.policy``): ``"auto"`` (default — the §5-style
    chooser: BCA-packed keys, dict/packed measures where smaller),
    ``"dense"`` (decoded-CSR baseline), ``"packed"`` (BCA wherever it fits),
    or a per-column dict keyed by ``(table, key, column)``.

    ``keep_packed`` (default True, matching ``fragments.build_index``) keeps
    the host-side bit-packed words on each ``ColumnFragments``; the storage
    policy ships those same words to the device instead of re-packing.
    ``device`` is where the indexes live: ``None`` means ``"cuda"``."""

    def __init__(
        self,
        schema: Schema,
        encodings: dict[tuple[str, str, str], str] | None = None,
        account_space: bool = True,
        keep_packed: bool = True,
        device_encodings: str | dict = "auto",
        device=None,
    ):
        X.check_device_encodings(device_encodings)
        dev = resolve_device(device)
        schema.validate()
        self.schema = schema
        self.host_indexes: dict[tuple[str, str], FragmentIndex] = {}
        for rel in schema.relationships.values():
            for key in (rel.fk1, rel.fk2):
                enc = {
                    col: e
                    for (t, k, col), e in (encodings or {}).items()
                    if t == rel.name and k == key
                }
                self.host_indexes[(rel.name, key)] = build_index(
                    schema, rel, key, enc or None,
                    keep_packed=keep_packed, account_space=account_space,
                )
        self.device = X.build_device_db(
            schema, self.host_indexes, device_encodings, device=dev
        )

    @classmethod
    def from_parts(cls, schema: Schema, host_indexes, device) -> "GQFastDatabase":
        """Assemble a database from already-built parts (host indexes and a
        :class:`~repro_torch.core.executor.DeviceDB`, e.g. one made by
        :func:`repro_torch.convert.device_db_from_numpy`) without re-running
        index construction."""
        schema.validate()
        db = cls.__new__(cls)
        db.schema = schema
        db.host_indexes = host_indexes
        db.device = device
        return db

    def space_report(self) -> dict[str, Any]:
        """Host byte-array accounting (paper §5 analytic model) plus the
        ``device`` section: real bytes the device column store holds, per
        column, with the decoded-CSR baseline for the compression ratio."""
        from ..storage import device_space_report

        rep: dict[str, Any] = {"indexes": {}, "total_bytes": 0}
        for (t, k), idx in self.host_indexes.items():
            cols = {
                c: {"encoding": cf.encoding, "bytes": cf.encoded_bytes}
                for c, cf in idx.columns.items()
            }
            b = idx.total_bytes()
            rep["indexes"][f"I_{t}.{k}"] = {
                "columns": cols, "lookup_bytes": idx.lookup_bytes(), "bytes": b,
            }
            rep["total_bytes"] += b
        rep["device"] = device_space_report(self.device)
        return rep


#: Ragged batches pad up to one of these sizes, as the reference's do: powers
#: of two up to 64, then multiples of 64 (a B = 65 burst runs the 128 bucket).
BATCH_BUCKET_CAP = 64


def batch_bucket(b: int) -> int:
    """Smallest bucket ≥ b: the next power of two up to BATCH_BUCKET_CAP,
    then the next multiple of BATCH_BUCKET_CAP."""
    if b <= BATCH_BUCKET_CAP:
        return 1 << (b - 1).bit_length()
    return -(-b // BATCH_BUCKET_CAP) * BATCH_BUCKET_CAP


@dataclass
class PreparedQuery:
    sql: str
    plan: ChainPlan
    fn: Callable[..., Any]
    param_names: list[str]
    group_entity: str | None
    phys: PhysicalPlan | None = None  # lowered IR
    strategy: str = "frontier"
    block_skipping: str = "auto"  # frontier-sparsity mode baked into fn
    fusion: str = "auto"  # multi-hop fusion mode baked into fn
    hop_estimates: list[dict] | None = None  # per-hop selectivity estimates
    batched_fn: Callable[..., Any] | None = None  # the batched entry
    plan_sig: str | None = None  # unfused op signature (the calibration key)
    calibration: Any = None  # the engine's CalibrationStore (shared)
    device_db: Any = None  # the device DB, for the profile's memory report
    # the distributed strategy's mesh, shard axes and this rank's shard
    # (shared by the engine's prepares), for the prefix-delta profile and
    # the runner's agreed decisions
    mesh: Any = None
    shard_axes: tuple = ("data",)
    sharded_db: Any = None

    def validate_params(self, params: dict) -> None:
        """Typed parameter-binding validation: every declared parameter bound,
        no unknown names — callers get a :class:`ValidationError` instead of a
        raw KeyError out of the argument zip."""
        missing = [n for n in self.param_names if n not in params]
        if missing:
            raise ValidationError(
                f"missing parameters: {missing}",
                missing=missing, expected=list(self.param_names),
                query=" ".join(self.sql.split()),
            )
        extra = [n for n in params if n not in self.param_names]
        if extra:
            raise ValidationError(
                f"unknown parameters: {extra}",
                unknown=extra, expected=list(self.param_names),
                query=" ".join(self.sql.split()),
            )

    def __call__(self, **params) -> np.ndarray:
        """Execute with the given bindings; returns the dense result as a host
        numpy array (the copy to the host waits for the device)."""
        self.validate_params(params)
        args = [params[n] for n in self.param_names]
        if T.current() is None:  # the zero-overhead default path
            return self.fn(*args).cpu().numpy()
        with T.span("execute", strategy=self.strategy,
                    query=" ".join(self.sql.split())) as sp:
            out = sp.fence(self.fn(*args))  # kernel_ms: device-done
            return out.cpu().numpy()

    def profile(self, reps: int = 3, **params) -> Any:
        """Execute under instrumentation and return a
        :class:`repro_torch.obs.profile.QueryProfile`: per-IR-op wall and
        fenced times, predicted against observed hop fractions (a hop off by
        more than 2× adds to the ``strategy_mispredict`` counter), the device
        memory report and the fenced median of ``reps`` runs. The observed
        fractions feed the engine's calibration store. The result comes from
        the executable ``__call__`` runs, with the same arguments."""
        from ..obs.profile import profile_prepared

        return profile_prepared(self, params, reps=reps)

    def explain(self, analyze: bool = False, **params) -> str:
        """Human-readable execution summary: the op pipeline, the resolved
        strategy, the block-skipping and fusion modes, and per-hop estimated
        active fractions. ``analyze=True`` (EXPLAIN ANALYZE) also runs the
        query with the given bindings and appends the :meth:`profile`
        report."""
        lines = [
            f"query: {' '.join(self.sql.split())}",
            f"strategy: {self.strategy}",
            f"block_skipping: {self.block_skipping}",
            f"fusion: {self.fusion}",
            f"params: {self.param_names}",
        ]
        if self.phys is not None:
            sig = " -> ".join(type(op).__name__ for op in self.phys.ops)
            lines.append(f"ops: {sig}")
            for g in fusion_groups(self.phys):
                lines.append(f"  fused region: {g}")
        for h in self.hop_estimates or []:
            lines.append(
                f"  hop I_{h['table']}.{h['src_key']}: "
                f"est_active_fraction={h['est_active_fraction']:.4g}"
            )
        if analyze:
            lines.append(self.profile(**params).render())
        return "\n".join(lines)

    def _batch_args(self, param_arrays: dict) -> tuple[list[np.ndarray], int]:
        """Validate one ``[B]`` array (or Python list) per parameter: every
        parameter present, none scalar, all 1-D and of the same length, not
        empty."""
        if not self.param_names:
            raise ValidationError(
                "execute_batch needs a parameterized query (this one has none);"
                " call the prepared query directly instead"
            )
        missing = [n for n in self.param_names if n not in param_arrays]
        if missing:
            raise ValidationError(
                f"execute_batch missing parameter arrays: {missing}",
                missing=missing, expected=list(self.param_names),
            )
        args, B = [], None
        for n in self.param_names:
            a = np.asarray(param_arrays[n])
            if a.ndim == 0:
                raise ValidationError(
                    f"execute_batch parameter {n!r} is a scalar; pass a list or"
                    " 1-D array with one value per query (a scalar would"
                    " silently broadcast to every query in the batch)",
                    param=n,
                )
            if a.ndim != 1:
                raise ValidationError(
                    f"execute_batch parameter {n!r} must be 1-D, got shape {a.shape}",
                    param=n, shape=a.shape,
                )
            if B is None:
                B = a.shape[0]
            elif a.shape[0] != B:
                raise ValidationError(
                    f"ragged batch: parameter {n!r} has length {a.shape[0]} but"
                    f" {self.param_names[0]!r} has length {B}; all parameter"
                    " arrays must have one entry per query",
                    param=n,
                )
            args.append(a)
        if B == 0:
            raise ValidationError("execute_batch got empty parameter arrays")
        return args, B

    def execute_batch(self, **param_arrays) -> np.ndarray:
        """Answer B parameter bindings of this query in one pass → ``[B,
        out_dom]`` on the host. On the frontier each hop streams the index's
        edges once for the whole batch (``compile_frontier_batched``); the
        scalar walk carries every row's paths at once
        (``compile_fragment_loop_batched``). A ragged B pads up
        to its bucket (:func:`batch_bucket`) by repeating the last row; the
        pad rows are sliced off on the device, before the copy to the host."""
        args, B = self._batch_args(param_arrays)
        bucket = batch_bucket(B)
        if bucket != B:
            args = [np.concatenate([a, np.repeat(a[-1:], bucket - B)]) for a in args]
        if T.current() is None:
            return self.batched_fn(*args)[:B].cpu().numpy()
        with T.span("execute_batch", strategy=self.strategy, batch=B, bucket=bucket,
                    query=" ".join(self.sql.split())) as sp:
            out = sp.fence(self.batched_fn(*args)[:B])
            return out.cpu().numpy()


class CalibrationStore:
    """Observed per-hop active fractions keyed by (unfused) plan signature.

    ``profile()`` records what a run touched; the next ``prepare`` of a query
    lowering to the same op shape under ``strategy="auto"`` picks from the
    observation instead of the fanout model (:meth:`GQFastEngine.
    _pick_strategy`). Bounded: the oldest entry goes past ``max_entries``."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._obs: dict[str, list[float]] = {}

    def record(self, plan_sig: str, fractions: list) -> None:
        vals = [float(f) for f in fractions if f is not None]
        if not vals:
            return
        self._obs.pop(plan_sig, None)
        self._obs[plan_sig] = vals
        while len(self._obs) > self.max_entries:
            self._obs.pop(next(iter(self._obs)))

    def get(self, plan_sig: str) -> list[float] | None:
        return self._obs.get(plan_sig)

    def __len__(self) -> int:
        return len(self._obs)


class GQFastEngine:
    """The query processor. ``mesh`` (a ``torch.distributed`` DeviceMesh,
    :mod:`repro_torch.launch.mesh`) runs every query edge-sharded over the
    mesh's ``shard_axes``: each rank builds the engine and runs the same
    queries with the same arguments, in the same order."""

    def __init__(self, db: GQFastDatabase, strategy: str = "frontier",
                 mesh=None, shard_axes: tuple[str, ...] = ("data",),
                 max_prepared: int = 64):
        X.require_supported("strategy", strategy, STRATEGY_MODES)
        self.db = db
        self.strategy = strategy
        self.mesh = mesh
        self.shard_axes = tuple(shard_axes)
        # this rank's shard: the group made once here (collective), the
        # edges sharded at the first prepare and shared by every prepare
        self._shard_spec = (X.shard_spec(mesh, self.shard_axes, db.device.device)
                            if mesh is not None else None)
        self._sharded = None
        # fixed-size LRU: each entry pins a lowered plan bound to device
        # tensors, so the prepare cache must not grow without bound
        self._cache: PreparedCache = PreparedCache(max_prepared)
        # per-plan-signature observed active fractions (fed by profile runs)
        self.calibration = CalibrationStore()

    def invalidate_prepared(self) -> int:
        """Drop every cached prepared query. Required after the device tensors
        under the prepared plans change — a scrubber heal or a snapshot
        generation swap — because a lowered plan holds the tensors it was
        bound to; the next prepare reads the new ones (and a mesh's shards
        are cut again). Returns the number of entries dropped."""
        self._sharded = None
        return self._cache.clear()

    def sharded_db(self):
        """This rank's shard of the device DB under the engine's mesh, cut
        at the first call and shared by every prepare."""
        if self._sharded is None:
            self._sharded = X.shard_edges(self.db.device, self.mesh, self.shard_axes,
                                          spec=self._shard_spec)
        return self._sharded

    def prepare(self, sql: str, block_skipping: str = "auto",
                fusion: str = "auto") -> PreparedQuery:
        """Parse, plan and lower ``sql`` once for repeated execution.
        ``block_skipping`` ('auto' | 'on' | 'off') sets the frontier-sparsity
        mode of every hop: 'auto' follows the active-block list while few
        blocks survive and scans otherwise (decided on the device), 'on'
        always follows it, 'off' always scans. ``fusion`` ('auto' | 'on' |
        'off') collapses adjacent hops (and constant-mask filters) into
        pipelined regions run in one launch each: 'on' every eligible region,
        'auto' those whose reach matrix is sparse and whose intermediate fits
        the scratch budget, 'off' none. Frontier strategy only: a
        fragment_loop plan, and every plan under a mesh, runs unfused. Under ``strategy="auto"`` the
        strategy is picked here, once (:meth:`_pick_strategy`)."""
        X.require_supported("block_skipping", block_skipping, X.BLOCK_SKIPPING_MODES)
        X.require_supported("fusion", fusion, X.FUSION_MODES)
        key = (sql, self.strategy, block_skipping, fusion)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        _faults.fire("engine.prepare", query=" ".join(sql.split()))
        with T.span("prepare", query=" ".join(sql.split())):
            try:
                with T.span("parse"):
                    ast = parse(sql)
                with T.span("plan"):
                    plan = plan_query(self.db.schema, ast)
                # lower once: the per-execute ref-resolution and constant-mask
                # work is hoisted out of the hot path
                with T.span("lower"):
                    phys = lower(self.db.device, plan)
            except QueryError as e:
                # every prepare-stage failure carries the query text
                raise e.with_context(query=" ".join(sql.split()))
            # the UNFUSED signature keys the calibration store, so a fused
            # and an unfused prepare of the same shape share observations
            plan_sig = " -> ".join(phys.op_signature())
            strategy = "distributed" if self.mesh is not None else self.strategy
            if strategy == "auto":
                strategy = self._pick_strategy(plan, plan_sig)
            sdb = None
            with T.span("compile") as csp:
                if strategy == "distributed":  # unfused, no skipping: sharded hops
                    sdb = self.sharded_db()
                    fn = X.compile_frontier_distributed(
                        self.db.device, phys, self.mesh, self.shard_axes, sharded_db=sdb)
                    bfn = X.compile_frontier_distributed(
                        self.db.device, phys, self.mesh, self.shard_axes, batched=True,
                        sharded_db=sdb) if phys.param_names else None
                elif strategy == "frontier":
                    if fusion != "off":
                        with T.span("fuse"):
                            phys = fuse_plan(phys, fusion)
                    fn = X.compile_frontier(self.db.device, phys,
                                            block_skipping=block_skipping, fusion=fusion)
                    # the batched serving entry, sharing the reach copies
                    bfn = X.compile_frontier_batched(
                        self.db.device, phys, block_skipping=block_skipping,
                        fusion=fusion, reach=fn.reach,
                    ) if phys.param_names else None
                else:
                    single, batched = X.STRATEGIES[strategy]
                    fn = single(self.db.device, phys, block_skipping=block_skipping)
                    bfn = batched(self.db.device, phys, block_skipping=block_skipping
                                  ) if phys.param_names else None
                csp.annotate(strategy=strategy, n_ops=len(phys.ops),
                             fused=has_fused(phys))
            pq = PreparedQuery(
                sql, plan, fn, list(phys.param_names), plan.group_entity, phys,
                strategy=strategy, block_skipping=block_skipping,
                fusion=fusion, hop_estimates=self._hop_fractions(plan),
                batched_fn=bfn, plan_sig=plan_sig, calibration=self.calibration,
                device_db=self.db.device, mesh=self.mesh, shard_axes=self.shard_axes,
                sharded_db=sdb,
            )
        self._cache.put(key, pq)
        return pq

    def _hop_fractions(self, plan: ChainPlan) -> list[dict]:
        """Per-hop estimated active fraction: seed cardinality pushed through
        p90 fanouts. ``frontier_est × p90(degree)`` edges are expected to be
        touched out of E — the 90th-percentile fragment length rather than
        the mean, because graph degree distributions are heavy-tailed and a
        seed that lands on a hub makes the *average* a serious
        under-prediction of touched work. The reached-destination count caps
        at the dst domain, and a mask seed starts whole-domain (fraction 1).
        The selectivity model behind the explain() report."""
        if isinstance(plan.seed, SeedIds):
            ids = plan.seed.ids if isinstance(plan.seed.ids, list) else [plan.seed.ids]
            frontier_est: float | None = float(len(ids))
        else:
            frontier_est = None  # mask seed: whole-domain support
        hops = []
        for s in plan.steps:
            if not isinstance(s, RelHop) or s.degree_filter:
                continue
            idx = self.db.host_indexes[(s.table, s.src_key)]
            E = max(idx.num_edges, 1)
            h = max(idx.indptr.shape[0] - 1, 1)
            degrees = np.diff(np.asarray(idx.indptr))
            fanout = float(np.percentile(degrees, 90)) if degrees.size else 0.0
            fanout = max(fanout, E / h)  # p90 never below the mean edge share
            if frontier_est is None:
                frontier_est = float(h)
            touched = min(frontier_est * fanout, float(E))
            hops.append({
                "table": s.table,
                "src_key": s.src_key,
                "est_active_fraction": touched / E,
            })
            frontier_est = min(touched, float(self.db.schema.domain_size(s.dst_entity)))
        return hops

    def _pick_strategy(self, plan: ChainPlan, plan_sig: str | None = None) -> str:
        """Cost-based strategy choice: the fragment walk touches only the
        reached fragments (work-efficient), the frontier streams whole
        indexes (throughput-efficient). An id-seeded plan whose worst hop
        touches less than ``params.FRAGMENT_LOOP_CROSSOVER`` of its index's
        edges walks fragments; any other runs the frontier. The fractions are
        the ones a ``profile()`` of the same plan signature observed, when
        the calibration store holds them, else :meth:`_hop_fractions`'
        estimate."""
        if not isinstance(plan.seed, SeedIds):
            return "frontier"  # a mask seed is whole-domain already
        fracs = self.calibration.get(plan_sig) if plan_sig is not None else None
        if fracs is None:
            fracs = [h["est_active_fraction"] for h in self._hop_fractions(plan)]
        worst = max(fracs, default=1.0)
        return "fragment_loop" if worst < KP.FRAGMENT_LOOP_CROSSOVER else "frontier"

    def query(self, sql: str, **params) -> np.ndarray:
        return self.prepare(sql)(**params)

    def query_topk(self, sql: str, k: int = 10, **params) -> list[tuple[int, float]]:
        scores = self.query(sql, **params)
        return self._topk(scores, k)

    def query_topk_batch(self, sql: str, k: int = 10,
                         **param_arrays) -> list[list[tuple[int, float]]]:
        """Batched :meth:`query_topk`: one ``[B]`` array per parameter, one
        pass, one top-k list per row (ranked on the host, as the reference
        ranks them, so ties order alike)."""
        scores = self.prepare(sql).execute_batch(**param_arrays)
        return [self._topk(row, k) for row in scores]

    @staticmethod
    def _topk(scores: np.ndarray, k: int) -> list[tuple[int, float]]:
        idx = np.argsort(-scores)[:k]
        return [(int(i), float(scores[i])) for i in idx if scores[i] != 0]
