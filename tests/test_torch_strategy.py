"""The ``fragment_loop`` and ``auto`` strategies of the PyTorch port on the
CPU, against the JAX engine's ``fragment_loop`` (its scalar walk is a jitted
fori_loop; its frontier fallback runs Pallas in interpret mode) and the numpy
oracle ``run_sql``, on the same seeded graphs: the nine queries on dense and
auto storage, every aggregate, packed against dense, the path cap, the
strategy pick and its calibration store, and ``execute_batch``.

Counts, MIN, MAX and EXISTS are exact; sums within rtol=atol=1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro_torch.core import executor as X  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    CalibrationStore,
    GQFastDatabase,
    GQFastEngine,
)
from repro_torch.core.fuse import has_fused  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import params as KP  # noqa: E402
from repro_torch.robust.errors import ValidationError  # noqa: E402
from repro_torch.storage import device_space_report  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

CASES = [
    ("SD", SG.QUERY_SD, {"d0": 5}),
    ("FSD", SG.QUERY_FSD, {"d0": 5}),
    ("AS", SG.QUERY_AS, {"a0": 7}),
    ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
    ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
    ("CS", SG.QUERY_CS, {"c0": 11}),
    ("SD_RECENT", SG.QUERY_SD_RECENT, {"d0": 5}),
    ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 7}),
]
IDS = [c[0] for c in CASES]
EXACT = ("SD", "AD", "RECENT", "CS", "SD_RECENT")  # counts and memberships
SCALAR = ("SD", "FSD", "AS", "SD_RECENT", "AS_RECENT")  # id seed, no semijoin

Q_SCORE = """
SELECT dt2.Doc, {agg}(dt1.Fre * dt2.Fre)
FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
WHERE dt1.Doc = :d0
GROUP BY dt2.Doc
"""
Q_EXISTS = Q_SCORE.replace("{agg}(dt1.Fre * dt2.Fre)", "EXISTS(*)")
Q_COUNT = Q_SCORE.replace("{agg}(dt1.Fre * dt2.Fre)", "COUNT(*)")
AGGS = {"SUM": Q_SCORE.format(agg="SUM"), "MIN": Q_SCORE.format(agg="MIN"),
        "MAX": Q_SCORE.format(agg="MAX"), "AVG": Q_SCORE.format(agg="AVG"),
        "COUNT": Q_COUNT, "EXISTS": Q_EXISTS}

PUBMED = dict(n_docs=800, n_terms=60, n_authors=250, seed=2)
SEMMED = dict(n_concepts=400, n_csemtypes=500, n_predications=800, n_sentences=3000)


@pytest.fixture(scope="module")
def graphs():
    """Per graph: the port's schema, its databases by storage, and the JAX
    fragment_loop engine on dense storage (its scalar walk densifies the
    plan, so its results are those of every storage)."""
    out = {}
    for name, make, kw in (("pubmed", "make_pubmed", PUBMED),
                           ("semmed", "make_semmeddb", SEMMED)):
        schema = getattr(SG, make)(**kw)
        dbs = {enc: GQFastDatabase(schema, account_space=False, device="cpu",
                                   device_encodings=enc) for enc in ("dense", "auto")}
        jdb = JDatabase(getattr(JSG, make)(**kw), account_space=False,
                        device_encodings="dense")
        out[name] = (schema, dbs, JEngine(jdb, strategy="fragment_loop"))
    return out


def _graph(graphs, name):
    return graphs["semmed" if name == "CS" else "pubmed"]


@pytest.fixture(scope="module")
def jax_results(graphs):
    """The JAX engine's fragment_loop result for each of the nine queries."""
    return {name: np.asarray(_graph(graphs, name)[2].prepare(q)(**p))
            for name, q, p in CASES}


def _check(got, want, exact, what):
    assert got.shape == want.shape and got.dtype == np.float32, what
    if exact:
        np.testing.assert_array_equal(got, want.astype(np.float32), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("enc", ["dense", "auto"])
@pytest.mark.parametrize("strategy", ["fragment_loop", "auto"])
@pytest.mark.parametrize("name,q,params", CASES, ids=IDS)
def test_strategies_match_jax_and_oracle(graphs, jax_results, strategy, enc, name, q, params):
    schema, dbs, _ = _graph(graphs, name)
    pq = GQFastEngine(dbs[enc], strategy=strategy).prepare(q)
    got = pq(**params)
    _check(got, jax_results[name], name in EXACT, f"{name} vs the JAX fragment_loop")
    _check(got, run_sql(schema, q, params), name in EXACT, f"{name} vs run_sql")
    assert (got != 0).any(), "degenerate test: empty result"
    if strategy == "fragment_loop":
        # the reference's strategy name, whether the plan walks or falls back
        assert pq.strategy == "fragment_loop"
        assert X.walks_scalar(pq.phys) == (name in SCALAR)


@pytest.mark.parametrize("agg", list(AGGS))
def test_every_aggregate_matches_jax_and_oracle(graphs, agg):
    schema, dbs, jeng = graphs["pubmed"]
    q = AGGS[agg]
    want = np.asarray(jeng.prepare(q)(d0=5))
    for enc in ("dense", "auto"):
        got = GQFastEngine(dbs[enc], strategy="fragment_loop").query(q, d0=5)
        exact = agg in ("MIN", "MAX", "EXISTS", "COUNT")
        _check(got, want, exact, f"{agg} {enc} vs the JAX fragment_loop")
        _check(got, run_sql(schema, q, {"d0": 5}), exact, f"{agg} {enc} vs run_sql")
        assert (got != 0).any()
    if agg == "EXISTS":
        assert set(np.unique(got)) <= {0.0, 1.0}


@pytest.mark.parametrize("name", SCALAR)
def test_packed_walk_equals_dense_and_keeps_no_dense_copy(graphs, name):
    """The scalar walk reads packed columns through ``gather``: equal to the
    dense walk bit for bit, and no column is decoded whole."""
    schema, _, _ = graphs["pubmed"]
    q, params = next((q, p) for n, q, p in CASES if n == name)
    packed = GQFastDatabase(schema, account_space=False, device="cpu")
    dense = GQFastDatabase(schema, account_space=False, device="cpu",
                           device_encodings="dense")
    a = GQFastEngine(packed, strategy="fragment_loop").query(q, **params)
    b = GQFastEngine(dense, strategy="fragment_loop").query(q, **params)
    np.testing.assert_array_equal(a, b)
    assert device_space_report(packed.device)["materialized_bytes"] == 0


def test_fragment_loop_plans_stay_unfused(graphs):
    _, dbs, _ = graphs["pubmed"]
    for name in ("SD_RECENT", "AS_RECENT"):
        q, params = next((q, p) for n, q, p in CASES if n == name)
        assert has_fused(GQFastEngine(dbs["auto"]).prepare(q, fusion="on").phys)
        pq = GQFastEngine(dbs["auto"], strategy="fragment_loop").prepare(q, fusion="on")
        assert not has_fused(pq.phys) and pq.fusion == "on"
        np.testing.assert_allclose(
            pq(**params), GQFastEngine(dbs["auto"]).query(q, **params), rtol=1e-4, atol=1e-4)


def test_unknown_strategy_raises(graphs):
    err = pytest.raises(ValidationError, GQFastEngine, graphs["pubmed"][1]["dense"],
                        strategy="scalar").value
    assert "strategy" in str(err)


@pytest.mark.parametrize("name,q,params", CASES, ids=IDS)
def test_pick_matches_the_reference_at_its_threshold(graphs, monkeypatch, name, q, params):
    """At the reference's crossover (0.15) the port picks what the JAX
    engine picks, query by query, and prepares the plan it picked."""
    monkeypatch.setattr(KP, "FRAGMENT_LOOP_CROSSOVER", 0.15)
    _, dbs, jeng = _graph(graphs, name)
    eng = GQFastEngine(dbs["auto"], strategy="auto")
    jauto = JEngine(jeng.db, strategy="auto")
    pick = eng._pick_strategy(eng.prepare(q).plan)
    assert pick == jauto._pick_strategy(jauto.prepare(q).plan)
    assert eng.prepare(q).strategy == pick
    if name == "AS":
        assert pick == "frontier"  # tests/test_system.py's pick


@pytest.mark.parametrize("name,q,params", CASES, ids=IDS)
def test_pick_follows_the_shipped_crossover(graphs, name, q, params):
    _, dbs, _ = _graph(graphs, name)
    eng = GQFastEngine(dbs["auto"], strategy="auto")
    pq = eng.prepare(q)
    worst = max((h["est_active_fraction"] for h in pq.hop_estimates), default=1.0)
    id_seed = pq.phys.ops[0].ids is not None
    scalar = id_seed and worst < KP.FRAGMENT_LOOP_CROSSOVER
    assert pq.strategy == ("fragment_loop" if scalar else "frontier")


def test_calibration_overrides_the_model_both_ways(graphs, monkeypatch):
    monkeypatch.setattr(KP, "FRAGMENT_LOOP_CROSSOVER", 0.15)
    eng = GQFastEngine(graphs["pubmed"][1]["auto"], strategy="auto")
    pq = eng.prepare(SG.QUERY_AS)
    assert eng._pick_strategy(pq.plan, pq.plan_sig) == "frontier"
    eng.calibration.record(pq.plan_sig, [0.01, 0.02])
    assert eng._pick_strategy(pq.plan, pq.plan_sig) == "fragment_loop"
    eng.calibration.record(pq.plan_sig, [0.01, 0.5])
    assert eng._pick_strategy(pq.plan, pq.plan_sig) == "frontier"
    # the key is the unfused signature: a fused prepare shares it
    fused = GQFastEngine(graphs["pubmed"][1]["auto"]).prepare(SG.QUERY_AS_RECENT, fusion="on")
    assert has_fused(fused.phys) and "Fused" not in fused.plan_sig


def test_calibration_store_stays_bounded():
    st = CalibrationStore(max_entries=3)
    for i in range(5):
        st.record(f"sig{i}", [i / 10])
    assert len(st) == 3 and st.get("sig0") is None and st.get("sig4") == [0.4]
    st.record("sig2", [0.9])  # a re-record makes it the newest
    st.record("sig5", [0.5])
    assert st.get("sig2") == [0.9] and st.get("sig3") is None
    st.record("sig6", [None])  # nothing observed: nothing kept
    assert st.get("sig6") is None and len(st) == 3


@pytest.fixture(scope="module")
def tiny():
    """A graph small enough for a walk in chunks of 4 paths."""
    schema = SG.make_pubmed(n_docs=120, n_terms=30, n_authors=60, seed=4)
    return GQFastDatabase(schema, account_space=False, device="cpu")


@pytest.mark.parametrize("name", SCALAR)
def test_path_cap_does_not_change_the_result(tiny, monkeypatch, name):
    q, params = next((q, p) for n, q, p in CASES if n == name)
    pq = GQFastEngine(tiny, strategy="fragment_loop").prepare(q)
    key = next(iter(params))
    rows = {key: [params[key], params[key] + 1, params[key] + 2]}
    want, want_b = pq(**params), pq.execute_batch(**rows)
    monkeypatch.setattr(KP, "FRAGMENT_LOOP_MAX_PATHS", 4)
    np.testing.assert_array_equal(pq(**params), want)
    np.testing.assert_array_equal(pq.execute_batch(**rows), want_b)


def test_path_cap_chunks_the_walk(graphs, monkeypatch):
    """Under a cap of 4 paths the hop after the first runs once a chunk."""
    monkeypatch.setattr(KP, "FRAGMENT_LOOP_MAX_PATHS", 4)
    pq = GQFastEngine(graphs["pubmed"][1]["auto"], strategy="fragment_loop").prepare(
        SG.QUERY_SD)
    prof = pq.profile(reps=1, d0=5)
    assert prof.ops[0].calls == 1 and 1 < prof.ops[1].calls < prof.ops[2].calls


@pytest.mark.parametrize("strategy", ["fragment_loop", "auto"])
@pytest.mark.parametrize("name", ["SD", "FSD", "AS", "AD"])
def test_execute_batch_matches_single_calls_and_jax(graphs, strategy, name):
    q, params = next((q, p) for n, q, p in CASES if n == name)
    _, dbs, jeng = _graph(graphs, name)
    pq = GQFastEngine(dbs["auto"], strategy=strategy).prepare(q)
    jpq = jeng.prepare(q)
    rng = np.random.default_rng(3)
    for B in (1, 5, 8):
        rows = {k: rng.integers(0, 40, size=B) for k in params}
        got = pq.execute_batch(**rows)
        assert got.shape == (B, pq.phys.out_dom)
        _check(got, np.asarray(jpq.execute_batch(**rows)), name in EXACT,
               f"{name} B={B} vs the JAX execute_batch")
        for b in range(B):
            single = pq(**{k: int(v[b]) for k, v in rows.items()})
            _check(got[b], single, name in EXACT, f"{name} B={B} row {b} vs its call")


def test_batched_walk_seed_scalars_and_dropped_ids(graphs):
    """FSD's seed scalar per row, a negative seed id counting from the end
    and an id outside the domain seeding nothing, in one batch."""
    schema, dbs, _ = graphs["pubmed"]
    n = schema.entities["Document"].size
    pq = GQFastEngine(dbs["auto"], strategy="fragment_loop").prepare(SG.QUERY_SD)
    got = pq.execute_batch(d0=[5, -3, n + 7, 5])
    np.testing.assert_array_equal(got[1], pq(d0=n - 3))
    assert not got[2].any()
    np.testing.assert_array_equal(got[0], got[3])
    fsd = GQFastEngine(dbs["auto"], strategy="fragment_loop").prepare(SG.QUERY_FSD)
    rows = fsd.execute_batch(d0=[5, 9])
    for b, d in enumerate((5, 9)):
        _check(rows[b], run_sql(schema, SG.QUERY_FSD, {"d0": d}), False, f"FSD row {b}")
