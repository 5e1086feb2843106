"""The dense path end to end: SQL → plan → lowered IR → frontier interpreter
→ one fragment_spmv per hop → dense γ, in the PyTorch port on the CPU, against
the JAX engine (dense device encodings, block skipping and fusion off, Pallas
in interpret mode) and the numpy oracle ``run_sql``, on the same seeded graphs.
Both sides ask for the dense path explicitly; the default settings (packed
storage, block skipping) are covered by tests/test_torch_storage.py and
tests/test_torch_sparsity.py.

sum, count and avg use the repo's tolerance (rtol=atol=1e-4,
tests/test_system.py); min, max and exists are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.robust.errors import ValidationError  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

CASES = [
    ("SD", SG.QUERY_SD, {"d0": 5}),
    ("FSD", SG.QUERY_FSD, {"d0": 5}),
    ("AS", SG.QUERY_AS, {"a0": 7}),
    ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
    ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
]

Q_SCORE = """
SELECT dt2.Doc, {agg}(dt1.Fre * dt2.Fre)
FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
WHERE dt1.Doc = :d0
GROUP BY dt2.Doc
"""

Q_EXISTS = """
SELECT dt2.Doc, EXISTS(*)
FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
WHERE dt1.Doc = :d0
GROUP BY dt2.Doc
"""

EXACT = ("MIN", "MAX", "EXISTS")


def _pair(make, **kw):
    """The same seeded graph through each package's own generator, loaded
    into each package's engine with dense device storage."""
    pschema = getattr(SG, make)(**kw)
    jschema = getattr(JSG, make)(**kw)
    port = GQFastEngine(GQFastDatabase(pschema, account_space=False, device="cpu",
                                       device_encodings="dense"))
    jax_ = JEngine(JDatabase(jschema, account_space=False, device_encodings="dense"))
    return pschema, port, jax_


@pytest.fixture(scope="module")
def pubmed():
    return _pair("make_pubmed", n_docs=2000, n_terms=100, n_authors=500, seed=3)


@pytest.fixture(scope="module")
def small():
    return _pair("make_pubmed", n_docs=800, n_terms=60, n_authors=250, seed=2)


@pytest.fixture(scope="module")
def semmed():
    return _pair("make_semmeddb", n_concepts=400, n_csemtypes=500,
                 n_predications=800, n_sentences=3000)


def _jax_query(eng, sql, params):
    return np.asarray(eng.prepare(sql, block_skipping="off", fusion="off")(**params))


def _port_query(eng, sql, params):
    return eng.prepare(sql, block_skipping="off")(**params)


def _check(got, jgot, ref, exact):
    assert got.shape == ref.shape == jgot.shape and got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_array_equal(got, ref.astype(np.float32))
    else:
        np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert (got != 0).sum() > 0, "degenerate test: empty result"


@pytest.mark.parametrize("name,q,params", CASES + [("CS", SG.QUERY_CS, {"c0": 11})],
                         ids=[c[0] for c in CASES] + ["CS"])
def test_query_matches_jax_and_oracle(pubmed, semmed, name, q, params):
    schema, port, jax_ = semmed if name == "CS" else pubmed
    got = _port_query(port, q, params)
    # COUNT, EXISTS and the mask-seeded queries are integers: exact
    exact = name in ("SD", "AD", "RECENT", "CS")
    _check(got, _jax_query(jax_, q, params), run_sql(schema, q, params), exact)


@pytest.mark.parametrize("agg", ["SUM", "MIN", "MAX", "AVG", "EXISTS"])
def test_aggregates_match_jax_and_oracle(small, agg):
    schema, port, jax_ = small
    q = Q_EXISTS if agg == "EXISTS" else Q_SCORE.format(agg=agg)
    got = _port_query(port, q, {"d0": 5})
    _check(got, _jax_query(jax_, q, {"d0": 5}), run_sql(schema, q, {"d0": 5}),
           agg in EXACT)
    if agg == "EXISTS":
        assert set(np.unique(got)) <= {0.0, 1.0}


def test_duplicate_seed_ids_accumulate(small):
    schema, port, jax_ = small
    q = """SELECT dt2.Doc, COUNT(*)
           FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
           WHERE dt1.Doc = :x AND dt1.Doc = :y
           GROUP BY dt2.Doc"""
    got = _port_query(port, q, {"x": 5, "y": 5})
    _check(got, _jax_query(jax_, q, {"x": 5, "y": 5}),
           run_sql(schema, q, {"x": 5, "y": 5}), exact=True)
    single = _port_query(port, Q_SCORE.format(agg="SUM").replace(
        "SUM(dt1.Fre * dt2.Fre)", "COUNT(*)"), {"d0": 5})
    np.testing.assert_array_equal(got, 2 * single)


def test_prepare_once_execute_many(pubmed):
    schema, port, _ = pubmed
    pq = port.prepare(SG.QUERY_SD)
    assert port.prepare(SG.QUERY_SD) is pq  # cached
    r1, r2 = pq(d0=5), pq(d0=np.int64(6))
    assert not np.allclose(r1, r2), "parameter change must change the result"
    np.testing.assert_array_equal(r2, run_sql(schema, SG.QUERY_SD, {"d0": 6}))
    np.testing.assert_array_equal(pq(d0=5), r1)


def test_validate_params_errors(pubmed):
    pq = pubmed[1].prepare(SG.QUERY_AD)
    err = pytest.raises(ValidationError, pq, t1=3).value
    assert err.code == "VALIDATION" and err.context["missing"] == ["t2"]
    err = pytest.raises(ValidationError, pq, t1=3, t2=9, zz=1).value
    assert err.context["unknown"] == ["zz"]
    assert isinstance(err, ValueError) and isinstance(err, TypeError)


def test_query_topk_matches_reference(pubmed):
    schema, port, jax_ = pubmed
    top = port.query_topk(SG.QUERY_AD, k=5, t1=3, t2=9)
    ref = run_sql(schema, SG.QUERY_AD, {"t1": 3, "t2": 9})
    assert top == GQFastEngine._topk(ref, 5)
    assert top == jax_._topk(_jax_query(jax_, SG.QUERY_AD, {"t1": 3, "t2": 9}), 5)
    assert len(top) == 5 and all(s > 0 for _, s in top)


@pytest.mark.parametrize("name,q", [(c[0], c[1]) for c in CASES])
def test_explain_matches_jax(pubmed, name, q):
    _, port, jax_ = pubmed
    pq = port.prepare(q, block_skipping="off")  # both packages' default fusion
    jpq = jax_.prepare(q, block_skipping="off")
    assert pq.explain() == jpq.explain()
    assert pq.phys.op_signature() == jpq.phys.op_signature()


#: Options whose slice has landed: they run now (storage, skipping, fusion,
#: batching).
PORTED = ("device_encodings=auto", "device_encodings=packed", "block_skipping=on",
          "block_skipping=auto", "fusion=on", "fusion=auto", "space_report",
          "execute_batch", "strategy=fragment_loop", "strategy=auto", "explain_analyze",
          "profile")


@pytest.mark.parametrize("call", [
    "device_encodings=auto", "device_encodings=packed", "block_skipping=on",
    "block_skipping=auto", "fusion=on", "fusion=auto", "strategy=fragment_loop",
    "strategy=auto", "mesh", "execute_batch", "explain_analyze", "profile",
    "space_report",
])
def test_unported_options_raise(pubmed, call):
    """Every option of the reference either runs (its slice has landed) or
    raises ValidationError naming the ROADMAP item that brings it; a mesh
    runs (``tests/test_torch_distributed.py``), and one that is not a
    DeviceMesh raises ValidationError."""
    schema, port, _ = pubmed
    pq = port.prepare(SG.QUERY_SD)
    calls = {
        "device_encodings=auto": lambda: GQFastDatabase(schema, device="cpu",
                                                        device_encodings="auto"),
        "device_encodings=packed": lambda: GQFastDatabase(schema, device="cpu",
                                                          device_encodings="packed"),
        "block_skipping=on": lambda: port.prepare(SG.QUERY_SD, block_skipping="on"),
        "block_skipping=auto": lambda: port.prepare(SG.QUERY_SD, block_skipping="auto"),
        "fusion=on": lambda: port.prepare(SG.QUERY_SD, fusion="on"),
        "fusion=auto": lambda: port.prepare(SG.QUERY_SD, fusion="auto"),
        "strategy=fragment_loop": lambda: GQFastEngine(port.db, strategy="fragment_loop"),
        "strategy=auto": lambda: GQFastEngine(port.db, strategy="auto"),
        "mesh": lambda: GQFastEngine(port.db, mesh=object()),
        "execute_batch": lambda: pq.execute_batch(d0=[1, 2]),
        "explain_analyze": lambda: pq.explain(analyze=True, d0=5),
        "profile": lambda: pq.profile(d0=5),
        "space_report": lambda: port.db.space_report(),
    }
    if call in PORTED:
        assert calls[call]() is not None
        return
    err = pytest.raises(ValidationError, calls[call]).value
    if call == "mesh":  # ported: a mesh that is not a DeviceMesh is refused
        assert "DeviceMesh" in str(err)
        return
    assert "ROADMAP Queue 1 item" in str(err)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """device=None means CUDA; without a card that is an error, not a quiet
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema = SG.make_pubmed(n_docs=50, n_terms=10, n_authors=20, seed=1)
    for device in (None, "cuda"):
        err = pytest.raises(ValidationError, GQFastDatabase, schema,
                            account_space=False, device=device).value
        assert "cuda" in str(err) and "device='cpu'" in str(err)


def test_results_stay_on_the_database_device(pubmed):
    _, port, _ = pubmed
    out = port.prepare(SG.QUERY_FSD).fn(5)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == torch.float32
