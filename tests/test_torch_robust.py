"""The PyTorch port's fault-tolerant query lifecycle on the CPU, case for case
with ``tests/test_robust.py``, held against the JAX package on the same
seeded graph: the typed error taxonomy, admission control (its estimate equal
to the reference's for frontier plans) and the prepared-query LRU, deadlines
(in the plain walk, the recorded walk and between the ``fragment_loop``
walk's chunks), the degradation ladder (every rung against the JAX engine and
the numpy oracle ``run_sql``), deterministic fault injection at the port's
sites and an in-process chaos serve smoke.

Parity contract: counts, MIN, MAX and EXISTS exact; float sums within
rtol=atol=1e-4. The ``ops.*`` sites fire whenever the kernel is asked for, so
on the CPU (where the plain versions run) they poison the kernel rungs as on
the card. PyTorch runs eagerly, so a site fires on every call rather than
once per trace.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.robust import estimate_query_bytes as j_estimate_query_bytes  # noqa: E402
from repro_torch.core import executor as X  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.fuse import has_fused  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import params as KP  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import recording  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    LADDER,
    AdmissionController,
    Deadline,
    DeadlineExceeded,
    ExecutionError,
    KernelFault,
    MemoryBudget,
    ParseError,
    PlanError,
    PreparedCache,
    QueryError,
    ResourceError,
    RetryPolicy,
    RobustPolicy,
    ValidationError,
    estimate_query_bytes,
    run_batch_with_policy,
    run_with_policy,
    wrap_execution_error,
)
from repro_torch.robust import admission, faults  # noqa: E402
from repro_torch.robust import runner as R  # noqa: E402
from repro_torch.robust.runner import rung_fn  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

GRAPH = dict(n_docs=60, n_terms=40, n_authors=30, seed=0)

CASES = [
    ("SD", SG.QUERY_SD, {"d0": 3}),
    ("FSD", SG.QUERY_FSD, {"d0": 3}),
    ("AS", SG.QUERY_AS, {"a0": 2}),
    ("AD", SG.QUERY_AD, {"t1": 2, "t2": 3}),
    ("FAD", SG.QUERY_FAD, {"t1": 2, "t2": 3}),
]
IDS = [c[0] for c in CASES]
EXACT = ("SD", "AD")  # counts and memberships


@pytest.fixture(scope="module")
def pubmed():
    return SG.make_pubmed(**GRAPH)


@pytest.fixture(scope="module")
def db(pubmed):
    return GQFastDatabase(pubmed, device="cpu")


@pytest.fixture(scope="module")
def engine(db):
    return GQFastEngine(db)


@pytest.fixture(scope="module")
def prepared_sd(engine):
    return engine.prepare(SG.QUERY_SD)


@pytest.fixture(scope="module")
def jengine():
    return JEngine(JDatabase(JSG.make_pubmed(**GRAPH)))


@pytest.fixture(scope="module")
def jax_results(jengine):
    return {name: np.asarray(jengine.prepare(q)(**p)) for name, q, p in CASES}


def _check(got, want, exact, what):
    got = np.asarray(got)
    assert got.shape == want.shape, what
    if exact:
        np.testing.assert_array_equal(got, np.asarray(want, np.float32), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=what)


def _no_retry():
    return RobustPolicy(retry=RetryPolicy(max_attempts=1))


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


def test_taxonomy_codes_and_compat():
    cases = [
        (ParseError, "PARSE", (SyntaxError,)),
        (PlanError, "PLAN", (ValueError,)),
        (ValidationError, "VALIDATION", (ValueError, TypeError)),
        (ResourceError, "ADMISSION_OR_RESOURCE", (RuntimeError,)),
        (DeadlineExceeded, "DEADLINE", (TimeoutError,)),
        (ExecutionError, "EXECUTION", (RuntimeError,)),
    ]
    for cls, _, bases in cases:
        e = cls("boom", extra=1)
        assert isinstance(e, QueryError)
        for b in bases:
            assert isinstance(e, b), (cls, b)
        assert e.code
        assert e.retryable in (True, False)
        d = e.to_dict()
        assert d["code"] == e.code and d["retryable"] == e.retryable
        assert d["context"]["extra"] == 1
        assert "boom" in str(e)


def test_with_context_setdefault_semantics():
    e = ExecutionError("x", op="HopOp")
    e.with_context(op="other", rung="scan")
    assert e.context["op"] == "HopOp"
    assert e.context["rung"] == "scan"


def test_wrap_execution_error_passthrough_and_foreign():
    orig = ValidationError("bad")
    assert wrap_execution_error(orig, rung="scan") is orig
    wrapped = wrap_execution_error(KeyError("k"), rung="scan")
    assert isinstance(wrapped, ExecutionError) and not wrapped.retryable
    assert isinstance(wrapped.__cause__, KeyError)


def test_prepare_failures_are_typed_with_query_context(engine):
    with pytest.raises(ParseError) as ei:
        engine.prepare("SELECT FROM x")
    assert ei.value.context.get("position") is not None
    with pytest.raises(PlanError) as ei:
        engine.prepare("SELECT x.A FROM Nope x WHERE x.A = 1")
    assert "query" in ei.value.context
    with pytest.raises(PlanError):
        engine.prepare(
            "SELECT dt.Doc, COUNT(*) FROM DT dt WHERE dt.Doc = 1"
            " GROUP BY zz.Doc"
        )


def test_param_validation(engine, prepared_sd):
    with pytest.raises(ValidationError, match="missing"):
        prepared_sd()
    with pytest.raises(ValidationError, match="unknown"):
        prepared_sd(d0=1, nope=2)
    pad = engine.prepare(SG.QUERY_AD)
    with pytest.raises(ValidationError, match="ragged"):
        pad._batch_args({"t1": [1, 2], "t2": [1]})
    with pytest.raises(ValidationError, match="scalar"):
        prepared_sd._batch_args({"d0": 3})
    with pytest.raises(TypeError, match="missing"):
        prepared_sd._batch_args({})


def test_bad_block_skipping_is_validation_error(engine):
    with pytest.raises(ValidationError, match="block_skipping"):
        engine.prepare(SG.QUERY_SD, block_skipping="sometimes")


# ---------------------------------------------------------------------------
# Admission control + prepared LRU
# ---------------------------------------------------------------------------


def test_estimate_monotonic_in_batch(prepared_sd):
    e1 = estimate_query_bytes(prepared_sd, 1)
    e64 = estimate_query_bytes(prepared_sd, 64)
    assert e1["resident_bytes"] == e64["resident_bytes"] > 0
    assert e64["working_bytes"] > e1["working_bytes"] > 0


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("name,q,params", CASES, ids=IDS)
def test_estimate_equals_the_reference_for_frontier_plans(engine, jengine, name, q,
                                                          params, batch):
    """The reference's working term equal byte for byte (the port's own is
    at least it); the resident term is the column store's bytes (equal)
    plus whatever decoded copies each package's memo pins at the time (the
    reference decodes while it traces)."""
    from repro.storage import device_space_report as j_space
    from repro_torch.storage import device_space_report

    got = estimate_query_bytes(engine.prepare(q), batch)
    want = j_estimate_query_bytes(jengine.prepare(q), batch)
    assert got["reference_working_bytes"] == int(want["working_bytes"]), name
    assert got["working_bytes"] >= got["reference_working_bytes"], name
    mine, theirs = device_space_report(engine.db.device), j_space(jengine.db.device)
    assert mine["total_bytes"] == int(theirs["total_bytes"])
    assert got["resident_bytes"] == mine["total_bytes"] + mine["materialized_bytes"]
    assert int(want["resident_bytes"]) == theirs["total_bytes"] + theirs["materialized_bytes"]


class _LiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """The peak of the bytes that tensors made inside the mode hold: a
    storage counts from the op that made it until the last tensor on it
    dies (storages of the inputs, such as the column store, never count)."""

    def __init__(self):
        super().__init__()
        self.storages: dict[int, list[int]] = {}
        self.now = self.peak = 0

    def _drop(self, key):
        held = self.storages.get(key)
        if held is not None:
            held[1] -= 1
            if held[1] == 0:
                self.now -= held[0]
                del self.storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import weakref

        from torch.utils._pytree import tree_flatten

        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr() for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st.data_ptr()
            if key in self.storages:
                self.storages[key][1] += 1
            elif key in ins:
                continue
            else:
                self.storages[key] = [st.nbytes(), 1]
                self.now += st.nbytes()
                self.peak = max(self.peak, self.now)
            weakref.finalize(t, self._drop, key)
        return out


BOUND_CASES = CASES + [
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 2, "t2": 3, "y": 2005}),
    ("SD_RECENT", SG.QUERY_SD_RECENT, {"d0": 3}),
    ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 2}),
]


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("fusion", ["auto", "on"])
@pytest.mark.parametrize("name,q,params", BOUND_CASES, ids=[c[0] for c in BOUND_CASES])
def test_estimate_bounds_what_the_walk_holds(engine, monkeypatch, name, q, params,
                                             fusion, batch):
    """The working term is an upper bound on what the walk allocates. Each
    hop entry is replaced by a stand-in that allocates only its output, as a
    kernel does (its values do not change the walk's allocations), so the
    peak measured on the CPU is the walk's own; the card's peak beside the
    estimate is measured by ``chip_smoke.py`` (path m)."""
    def out(w, n_dst):
        return torch.zeros(tuple(w.shape[:-1]) + (n_dst,))

    for entry in ("fragment_spmv", "fragment_spmm"):
        monkeypatch.setattr(K, entry, lambda w, s, d, m, n_dst, **kw: out(w, n_dst))
    for entry in ("fragment_spmv_packed", "fragment_spmm_packed"):
        monkeypatch.setattr(K, entry, lambda w, *a, n_dst, **kw: out(w, n_dst))
    for entry in ("fragment_spmv_fused", "fragment_spmm_fused"):
        monkeypatch.setattr(K, entry, lambda w, h1, h2, mask, **kw: out(w, (h2 or h1).n_dst))
    pq = engine.prepare(q, fusion=fusion)
    if batch == 1:
        run = lambda: pq(**params)  # noqa: E731
    else:
        rows = {k: np.arange(batch) + v for k, v in params.items()}
        run = lambda: pq.execute_batch(**rows)  # noqa: E731
    run()  # decode memos fill on the first run, as on the card
    mode = _LiveBytes()
    with mode:
        run()
    est = estimate_query_bytes(pq, batch)
    assert mode.peak > 0
    assert est["working_bytes"] >= admission._walk_live_bytes(pq.phys, batch) >= mode.peak, \
        (name, est, mode.peak)


def test_estimate_adds_the_walks_chunk_of_paths(db, monkeypatch):
    monkeypatch.setattr(KP, "FRAGMENT_LOOP_MAX_PATHS", 1000)
    loop = GQFastEngine(db, strategy="fragment_loop")
    frontier = GQFastEngine(db)
    for q, walks in ((SG.QUERY_SD, True), (SG.QUERY_AD, False)):
        pl, pf = loop.prepare(q), frontier.prepare(q)
        assert X.walks_scalar(pl.phys) == walks
        for batch in (1, 8):
            el, ef = estimate_query_bytes(pl, batch), estimate_query_bytes(pf, batch)
            extra = 1000 * admission.FRAGMENT_LOOP_PATH_BYTES * batch if walks else 0
            assert el["resident_bytes"] == ef["resident_bytes"]
            assert el["working_bytes"] == ef["working_bytes"] + extra


def test_admission_admit_demote_reject(prepared_sd):
    reg = MetricsRegistry()
    est1 = estimate_query_bytes(prepared_sd, 1)["total_bytes"]
    est64 = estimate_query_bytes(prepared_sd, 64)["total_bytes"]
    mid = AdmissionController(
        MemoryBudget(limit_bytes=int((est1 + est64) / 2 / 0.9)), reg
    )
    assert mid.decide(prepared_sd, 1).action == "admit"
    assert mid.decide(prepared_sd, 64).action == "demote"
    with pytest.raises(ResourceError):
        mid.admit(prepared_sd, 64)
    assert mid.admit(prepared_sd, 64, allow_demote=True).action == "demote"
    tiny = AdmissionController(MemoryBudget(limit_bytes=16), reg)
    assert tiny.decide(prepared_sd, 1).action == "reject"
    with pytest.raises(ResourceError) as ei:
        tiny.admit(prepared_sd, 1)
    assert ei.value.code == "ADMISSION"
    assert reg.counter("robust.admission_rejections").snapshot() >= 1
    assert reg.counter("robust.admission_demotions").snapshot() >= 1
    free = AdmissionController(MemoryBudget(), reg)
    assert free.decide(prepared_sd, 4096).action == "admit"


def test_prepared_cache_lru():
    reg = MetricsRegistry()
    c = PreparedCache(capacity=2, registry=reg)
    c.put("a", 1), c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert "b" not in c and "a" in c and "c" in c
    assert reg.counter("engine.prepared_cache_evictions").snapshot() == 1
    assert reg.counter("engine.prepared_cache_hits").snapshot() == 1
    with pytest.raises(ValueError):
        PreparedCache(capacity=0)


def test_engine_prepare_cache_bounded(db):
    eng = GQFastEngine(db, max_prepared=2)
    a = eng.prepare(SG.QUERY_SD)
    assert eng.prepare(SG.QUERY_SD) is a
    eng.prepare(SG.QUERY_AD)
    eng.prepare(SG.QUERY_FAD)
    assert eng.prepare(SG.QUERY_SD) is not a


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------


def test_deadline_object():
    dl = Deadline(10_000.0)
    dl.check("nowhere")
    dl2 = Deadline(0.0)
    assert dl2.expired()
    with pytest.raises(DeadlineExceeded) as ei:
        dl2.check("op[HopOp]")
    assert ei.value.context["where"] == "op[HopOp]"


def test_deadline_trips_on_injected_delay(prepared_sd):
    plan = faults.FaultPlan(seed=1).add(
        faults.FaultSpec(site="runner.execute", mode="delay", delay_ms=60.0)
    )
    with faults.active(plan):
        oc = run_with_policy(prepared_sd, {"d0": 3}, deadline_ms=25.0)
    assert oc.status == "error" and oc.error.code == "DEADLINE"
    oc = run_with_policy(prepared_sd, {"d0": 3}, deadline_ms=10_000.0)
    assert oc.status == "ok"


@pytest.mark.parametrize("recorded", [False, True])
def test_deadline_read_at_each_op_entry(prepared_sd, recorded):
    """A spent deadline stops the walk at the first op, in the plain fold
    and in the recorded walk (whose label is the op signature)."""
    with R.deadline_scope(Deadline(0.0)):
        if recorded:
            with recording(), pytest.raises(DeadlineExceeded) as ei:
                prepared_sd.fn(3)
            assert ei.value.context["where"] == prepared_sd.phys.op_signature()[0]
        else:
            with pytest.raises(DeadlineExceeded) as ei:
                prepared_sd.fn(3)
            assert ei.value.context["where"] == type(prepared_sd.phys.ops[0]).__name__


def test_deadline_trips_between_the_walks_chunks(db, monkeypatch):
    """``fragment_loop`` at a cap of one path a chunk walks AS in hundreds of
    chunks; the deadline, read before each chunk, stops it part way. The
    clock is the count of deadline reads (one millisecond each), so the trip
    is deterministic."""
    monkeypatch.setattr(KP, "FRAGMENT_LOOP_MAX_PATHS", 1)
    reads = {"n": 0, "chunks": 0}
    real = X.check_deadline

    def counted(where="op"):
        reads["chunks"] += where == "fragment_loop chunk"
        return real(where)

    def elapsed_ms(self):
        reads["n"] += 1
        return float(reads["n"])

    monkeypatch.setattr(X, "check_deadline", counted)
    pq = GQFastEngine(db).prepare(SG.QUERY_AS)
    full = rung_fn(pq, "fragment_loop")(2)  # no deadline: the whole walk
    chunks = reads["chunks"]
    assert chunks > 100, "degenerate test: too few chunks"
    reads["chunks"] = 0
    monkeypatch.setattr(Deadline, "elapsed_ms", elapsed_ms)
    pol = RobustPolicy(ladder=("fragment_loop",), retry=RetryPolicy(max_attempts=1))
    oc = run_with_policy(pq, {"a0": 2}, deadline_ms=40.0, policy=pol)
    assert oc.status == "error" and oc.error.code == "DEADLINE", oc.to_dict()
    assert 0 < reads["chunks"] < chunks, "the deadline must trip inside the walk"
    assert oc.error.context["rung"] == "fragment_loop"
    # the same walk without a deadline equals the frontier's answer
    _check(full.numpy(), pq(a0=2), False, "AS fragment_loop rung vs active")


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rung", LADDER)
@pytest.mark.parametrize("name,q,params", CASES, ids=IDS)
def test_ladder_rungs_match_jax_and_oracle(pubmed, engine, jax_results, name, q, params,
                                           rung):
    p = engine.prepare(q)
    args = [params[n] for n in p.param_names]
    got = rung_fn(p, rung)(*args).cpu().numpy()
    exact = name in EXACT
    _check(got, jax_results[name], exact, f"{name} {rung} vs the JAX engine")
    _check(got, run_sql(pubmed, q, params), exact, f"{name} {rung} vs run_sql")
    _check(got, p(**params), exact, f"{name} {rung} vs active")
    assert (got != 0).any(), "degenerate test: empty result"


def test_ladder_rungs_agree_batched(engine):
    p = engine.prepare(SG.QUERY_FSD)
    d0 = np.array([3, 5, 7])
    want = p.execute_batch(d0=d0)
    for rung in LADDER:
        got = rung_fn(p, rung, batched=True)(d0).cpu().numpy()
        _check(got, want, False, f"FSD batched {rung}")


def test_retry_then_success_is_degraded(prepared_sd):
    reg = MetricsRegistry()
    plan = faults.FaultPlan(seed=2).add(
        faults.FaultSpec(site="runner.execute", mode="raise", max_fires=1)
    )
    pol = RobustPolicy(retry=RetryPolicy(max_attempts=3, base_ms=0.1),
                       registry=reg)
    with faults.active(plan):
        oc = run_with_policy(prepared_sd, {"d0": 3}, policy=pol)
    assert oc.status == "degraded" and oc.rung == "active"
    assert oc.attempts == 2 and not oc.demotions
    assert reg.counter("robust.retries").snapshot() == 1
    assert np.array_equal(oc.value, prepared_sd(d0=3))


def test_exhausted_retries_demote_down_ladder(prepared_sd):
    reg = MetricsRegistry()
    plan = faults.FaultPlan(seed=2).add(
        faults.FaultSpec(site="runner.execute", mode="raise", max_fires=3)
    )
    pol = RobustPolicy(retry=RetryPolicy(max_attempts=2, base_ms=0.1),
                       registry=reg)
    with faults.active(plan):
        oc = run_with_policy(prepared_sd, {"d0": 3}, policy=pol)
    assert oc.status == "degraded" and oc.demotions == ("active",)
    assert oc.rung == "unfused"
    assert reg.counter("robust.demotions.active").snapshot() == 1
    assert np.array_equal(oc.value, prepared_sd(d0=3))


def test_all_rungs_failing_returns_typed_error(prepared_sd):
    plan = faults.FaultPlan(seed=2).add(
        faults.FaultSpec(site="runner.execute", mode="raise")
    )
    with faults.active(plan):
        oc = run_with_policy(prepared_sd, {"d0": 3}, policy=_no_retry())
    assert oc.status == "error" and not oc.ok
    assert oc.error.code == "FAULT_INJECTED"
    assert oc.demotions == LADDER


def test_run_with_policy_never_raises_on_bad_params(prepared_sd):
    oc = run_with_policy(prepared_sd, {"wrong": 1})
    assert oc.status == "error" and oc.error.code == "VALIDATION"


def test_batch_policy_matches_execute_batch(prepared_sd):
    arr = np.arange(6)
    ocs = run_batch_with_policy(prepared_sd, {"d0": arr})
    ref = prepared_sd.execute_batch(d0=arr)
    assert len(ocs) == 6 and all(o.status == "ok" and o.rung == "active" for o in ocs)
    for i, o in enumerate(ocs):
        assert np.array_equal(o.value, ref[i])


def test_batch_admission_demotes_to_serial(prepared_sd):
    est1 = estimate_query_bytes(prepared_sd, 1)["total_bytes"]
    est64 = estimate_query_bytes(prepared_sd, 64)["total_bytes"]
    ctl = AdmissionController(
        MemoryBudget(limit_bytes=int((est1 + est64) / 2 / 0.9)),
        MetricsRegistry(),
    )
    pol = RobustPolicy(admission=ctl, registry=MetricsRegistry())
    arr = np.arange(64)
    ocs = run_batch_with_policy(prepared_sd, {"d0": arr}, policy=pol)
    ref = prepared_sd.execute_batch(d0=arr)
    assert all(o.status == "degraded" for o in ocs)
    for i, o in enumerate(ocs):
        assert np.array_equal(o.value, ref[i])


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


def test_fault_determinism_and_counting():
    def run(seed):
        plan = faults.FaultPlan(seed=seed).add(
            faults.FaultSpec(site="x", mode="raise", prob=0.5, max_fires=50)
        )
        seq = []
        with faults.active(plan):
            for _ in range(30):
                try:
                    faults.fire("x")
                    seq.append(0)
                except ExecutionError:
                    seq.append(1)
        return seq, plan

    s5, p5 = run(5)
    s5b, _ = run(5)
    s6, _ = run(6)
    assert s5 == s5b and s5 != s6
    assert p5.total_fires() == sum(s5)
    assert p5.stats()["x:raise"]["calls"] == 30


def test_fault_seeding_equals_the_reference():
    """One seed fires the same calls in both packages (the chaos plans of
    either address the other's sites alike)."""
    from repro.robust import faults as jfaults

    def run(mod):
        plan = mod.FaultPlan(seed=11).add(
            mod.FaultSpec(site="ops.", mode="raise", prob=0.3, after=2))
        seq = []
        with mod.active(plan):
            for i in range(40):
                try:
                    mod.fire("ops.fragment_spmv" if i % 2 else "ops.fragment_spmm")
                    seq.append(0)
                except Exception:  # noqa: BLE001 — each package's ExecutionError
                    seq.append(1)
        return seq

    assert run(faults) == run(jfaults)


def test_fault_prefix_after_and_max_fires():
    plan = faults.FaultPlan().add(
        faults.FaultSpec(site="ops.", mode="raise", after=2, max_fires=1)
    )
    with faults.active(plan):
        faults.fire("ops.fragment_spmv")
        faults.fire("ops.fragment_spmm")
        with pytest.raises(ExecutionError) as ei:
            faults.fire("ops.fragment_spmv_packed")
        assert ei.value.retryable and ei.value.code == "FAULT_INJECTED"
        faults.fire("ops.fragment_spmv")
        faults.fire("other.site")
    assert plan.total_fires() == 1


def test_fire_is_noop_without_plan():
    faults.fire("ops.fragment_spmv")
    assert faults.corrupt("storage.materialize", 7) == 7


def _hop_inputs():
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.random(8), dtype=torch.float32)
    s = torch.tensor(np.sort(rng.integers(0, 8, 40)), dtype=torch.int32)
    d = torch.tensor(rng.integers(0, 6, 40), dtype=torch.int32)
    return w, s, d


@pytest.mark.parametrize("site", ["ops.fragment_spmv", "ops.fragment_spmv_packed",
                                  "ops.fragment_spmm", "ops.fragment_spmm_packed",
                                  "ops.fragment_spmv_fused", "ops.fragment_spmm_fused"])
def test_ops_sites_fire_when_the_kernel_is_asked_for(site):
    w, s, d = _hop_inputs()
    W = torch.stack([w, w])
    hop = K.FusedHopOperands(s, d, n_dst=6, hot_share=0.0)
    calls = {
        "ops.fragment_spmv": lambda uk: K.fragment_spmv(w, s, d, None, 6, use_kernel=uk),
        "ops.fragment_spmv_packed": lambda uk: K.fragment_spmv_packed(
            w, s, d, n_dst=6, use_kernel=uk),
        "ops.fragment_spmm": lambda uk: K.fragment_spmm(W, s, d, None, 6, use_kernel=uk),
        "ops.fragment_spmm_packed": lambda uk: K.fragment_spmm_packed(
            W, s, d, n_dst=6, use_kernel=uk),
        "ops.fragment_spmv_fused": lambda uk: K.fragment_spmv_fused(
            w, hop, fusion="on", use_kernel=uk),
        "ops.fragment_spmm_fused": lambda uk: K.fragment_spmm_fused(
            W, hop, fusion="on", use_kernel=uk),
    }
    plan = faults.FaultPlan().add(faults.FaultSpec(site=site, mode="raise"))
    with faults.active(plan):
        calls[site](False)  # the plain versions: no site
        assert plan.total_fires() == 0
        with pytest.raises(ExecutionError) as ei:
            calls[site](True)
    assert ei.value.context["site"] == site
    assert plan.stats()[f"{site}:raise"]["fires"] == 1


def test_fused_site_fires_only_where_the_region_fuses():
    w, s, d = _hop_inputs()
    hop = K.FusedHopOperands(s, d, n_dst=6, hot_share=0.0)
    plan = faults.FaultPlan().add(faults.FaultSpec(site="ops.fragment_spmv_fused",
                                                   mode="raise"))
    with faults.active(plan):
        K.fragment_spmv_fused(w, hop, fusion="off")  # composed from the hops
    assert plan.total_fires() == 0


def test_engine_prepare_site(db):
    eng = GQFastEngine(db)
    plan = faults.FaultPlan().add(faults.FaultSpec(site="engine.prepare", mode="raise",
                                                   max_fires=1))
    with faults.active(plan):
        with pytest.raises(ExecutionError):
            eng.prepare(SG.QUERY_SD)
        eng.prepare(SG.QUERY_SD)
    assert plan.total_fires() == 1


def test_storage_corrupt_then_restore(pubmed):
    db = GQFastDatabase(pubmed, device_encodings="packed", device="cpu")
    col = next(
        c for di in db.device.indexes.values()
        for c in ([di.dst_col] + list(di.measure_cols.values()))
        if getattr(c, "kind", None) in ("packed", "dict")
    )
    truth = col.materialize().numpy().copy()
    plan = faults.FaultPlan().add(
        faults.FaultSpec(site="storage.materialize", mode="corrupt")
    )
    with faults.active(plan):
        bad = col.materialize().numpy()
    assert plan.total_fires() >= 1
    assert not np.array_equal(bad, truth)
    assert np.array_equal(col.materialize().numpy(), truth)


def test_kernel_fault_degrades_to_working_rung(pubmed, engine, jax_results):
    """The reference poisons its Pallas dispatch at trace time; the port's
    sites fire on every call. Either way the ladder lands on a rung that
    asks for no kernel (xla or fragment_loop) with the right answer."""
    eng = GQFastEngine(GQFastDatabase(pubmed, device="cpu"))
    plan = faults.FaultPlan(seed=3).add(
        faults.FaultSpec(site="ops.", mode="raise")
    )
    with faults.active(plan):
        pq = eng.prepare(SG.QUERY_AD)
        oc = run_with_policy(pq, {"t1": 2, "t2": 3}, policy=_no_retry())
    assert oc.ok and oc.rung in ("xla", "fragment_loop"), oc.to_dict()
    assert oc.demotions == ("active", "unfused", "scan")
    assert plan.total_fires() >= 3
    assert np.array_equal(oc.value, engine.prepare(SG.QUERY_AD)(t1=2, t2=3))
    _check(oc.value, jax_results["AD"], True, "AD on the working rung vs the JAX engine")


def test_fused_kernel_fault_degrades_to_unfused(pubmed, engine, jax_results):
    eng = GQFastEngine(GQFastDatabase(pubmed, device="cpu"))
    plan = faults.FaultPlan(seed=4).add(
        faults.FaultSpec(site="ops.fragment_spmv_fused", mode="raise")
    )
    with faults.active(plan):
        pq = eng.prepare(SG.QUERY_AS, fusion="on")
        assert has_fused(pq.phys)
        oc = run_with_policy(pq, {"a0": 2}, policy=_no_retry())
    assert oc.ok and oc.status == "degraded", oc.to_dict()
    assert oc.rung == "unfused" and oc.demotions == ("active",)
    assert plan.total_fires() >= 1
    _check(oc.value, engine.prepare(SG.QUERY_AS)(a0=2), False, "AS unfused vs defaults")
    _check(oc.value, jax_results["AS"], False, "AS unfused vs the JAX engine")


# ---------------------------------------------------------------------------
# A kernel that fails is terminal: no rung below answers from the plain versions
# ---------------------------------------------------------------------------

_WRAPPERS = ("_dense", "_packed", "_fused", "_dense_rows", "_packed_rows",
             "_bitunpack", "_block_list", "_crc32c", "_bitmaps")


@pytest.fixture
def kernels_fail(monkeypatch):
    """Every ``use_kernel=True`` call goes to its kernel wrapper, as a CUDA
    tensor does, and every wrapper fails there as a failed nvcc does."""
    def failed_build(t, kernel):
        raise cuda_build.KernelError(f"nvcc failed building {kernel}.cu")

    monkeypatch.setattr(K, "_plain", lambda t, use_kernel: not use_kernel)
    for name in _WRAPPERS:
        monkeypatch.setattr(getattr(K, name), "cuda_device", failed_build)


def _plain_rungs_built(pq) -> list:
    return [k for k in pq.__dict__.get("_rung_fns", {}) if k[0] in ("xla", "fragment_loop")]


@pytest.mark.parametrize("name,q,params,fusion", [
    ("SD", SG.QUERY_SD, {"d0": 3}, "auto"),
    ("AD", SG.QUERY_AD, {"t1": 2, "t2": 3}, "auto"),
    ("AS fused", SG.QUERY_AS, {"a0": 2}, "on"),
], ids=["SD", "AD", "AS-fused"])
def test_kernel_that_fails_to_build_ends_the_query(kernels_fail, db, name, q,
                                                   params, fusion):
    reg = MetricsRegistry()
    pq = GQFastEngine(db).prepare(q, fusion=fusion)
    oc = run_with_policy(pq, params, policy=RobustPolicy(registry=reg))
    assert oc.status == "error" and oc.value is None, oc.to_dict()
    assert isinstance(oc.error, KernelFault) and oc.error.code == "KERNEL"
    assert isinstance(oc.error.__cause__, cuda_build.KernelError)
    assert oc.rung == "active" and oc.demotions == () and oc.attempts == 1
    assert _plain_rungs_built(pq) == []
    assert reg.counter("robust.errors.KERNEL").snapshot() == 1
    assert reg.counters_with_prefix("robust.demotions") == {}


def test_kernel_that_fails_ends_the_batch(kernels_fail, db):
    pq = GQFastEngine(db).prepare(SG.QUERY_SD)
    outs = run_batch_with_policy(pq, {"d0": np.arange(5)},
                                 policy=RobustPolicy(registry=MetricsRegistry()))
    assert len(outs) == 5
    assert all(o.status == "error" and o.error.code == "KERNEL" and o.rung == "active"
               and o.demotions == () for o in outs)
    assert _plain_rungs_built(pq) == []


def test_kernel_launch_error_and_device_fault_are_kernel_faults(monkeypatch, prepared_sd):
    """A nonzero CUDA code from a launch, and a device fault at the attempt's
    fence, end the query on the rung they hit."""
    def launch_fails(*args):
        cuda_build.raise_on(719, "fragment_spmv_packed")

    class OnCard:
        device = torch.device("cuda", 0)

    def fence_faults(device=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    for fn, patch in ((launch_fails, None),
                      (lambda *a: OnCard(), ("synchronize", fence_faults))):
        if patch is not None:
            monkeypatch.setattr(torch.cuda, *patch)
        monkeypatch.setattr(R, "rung_fn", lambda pq, rung, batched=False, fn=fn: fn)
        oc = run_with_policy(prepared_sd, {"d0": 3},
                             policy=RobustPolicy(registry=MetricsRegistry()))
        assert oc.status == "error" and oc.error.code == "KERNEL", oc.to_dict()
        assert oc.rung == "active" and oc.demotions == ()
        assert isinstance(oc.error.__cause__, cuda_build.KernelError)


def test_kernel_error_at_build_load_and_launch(monkeypatch, tmp_path):
    """What cuda_build raises where a kernel cannot be had: KernelError (a
    RuntimeError) for no nvcc, a library that does not load, a launch code."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(cuda_build.KernelError, match="nvcc not found"):
        cuda_build._nvcc()
    bad = tmp_path / "bad.cu"
    bad.write_text("not CUDA")
    lib = cuda_build.CudaLibrary("bad", {}, source=bad)
    cuda_build.LIBRARIES.remove(lib)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib._so().write_bytes(b"not a shared library")
    with pytest.raises(cuda_build.KernelError, match="loading bad.cu"):
        lib.load()
    with pytest.raises(cuda_build.KernelError, match="CUDA error 700"):
        cuda_build.raise_on(700, "bitmap_and")
    assert issubclass(cuda_build.KernelError, RuntimeError)


def test_injected_kernel_faults_still_demote(kernels_fail, db, jax_results):
    """The demotion the fault sites drive is unchanged: the site fires before
    the wrapper, and an injected fault is no KernelFault."""
    pq = GQFastEngine(db).prepare(SG.QUERY_SD)
    plan = faults.FaultPlan(seed=3).add(faults.FaultSpec(site="ops.", mode="raise"))
    with faults.active(plan):
        oc = run_with_policy(pq, {"d0": 3}, policy=_no_retry())
    assert oc.ok and oc.rung in ("xla", "fragment_loop"), oc.to_dict()
    assert oc.demotions == ("active", "unfused", "scan")
    _check(oc.value, jax_results["SD"], True, "SD on the working rung vs the JAX engine")


# ---------------------------------------------------------------------------
# Chaos serve smoke
# ---------------------------------------------------------------------------


def test_chaos_serve_smoke(engine, prepared_sd):
    reg = MetricsRegistry()
    pol = RobustPolicy(retry=RetryPolicy(max_attempts=2, base_ms=0.1),
                       registry=reg)
    plan = (
        faults.FaultPlan(seed=9)
        .add(faults.FaultSpec(site="runner.execute", mode="raise",
                              prob=0.3, max_fires=6))
        .add(faults.FaultSpec(site="runner.execute", mode="delay",
                              delay_ms=5.0, prob=0.2))
    )
    rng = np.random.default_rng(0)
    outcomes = []
    with faults.active(plan):
        for _ in range(8):
            arr = rng.integers(0, 50, size=4)
            outcomes.extend(
                run_batch_with_policy(prepared_sd, {"d0": arr}, policy=pol)
            )
    assert len(outcomes) == 32
    assert all(o.status in ("ok", "degraded", "error") for o in outcomes)
    assert [o for o in outcomes if o.ok], "chaos must not take the service fully down"
    assert any(o.degraded for o in outcomes), "injected faults must degrade"
    errs = reg.counters_with_prefix("robust.errors.")
    assert sum(errs.values()) > 0
    for o in outcomes:
        d = o.to_dict()
        assert d["status"] == o.status and "rung" in d
