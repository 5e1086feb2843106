"""Front-end parity: the PyTorch port's copies of the SQL parser, planner,
fragment index builder and typed errors behave as the JAX package's do."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fragments as jfrag  # noqa: E402
from repro.core.planner import plan_query as jplan  # noqa: E402
from repro.core.sql import parse as jparse  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.robust import errors as jerr  # noqa: E402
from repro_torch.core import fragments as pfrag  # noqa: E402
from repro_torch.core.planner import NotRelationshipQuery, plan_query  # noqa: E402
from repro_torch.core.sql import parse  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.robust.errors import ParseError, PlanError, QueryError  # noqa: E402

QUERIES = {
    "SD": SG.QUERY_SD, "FSD": SG.QUERY_FSD, "AS": SG.QUERY_AS, "AD": SG.QUERY_AD,
    "FAD": SG.QUERY_FAD, "RECENT": SG.QUERY_RECENT_AUTHORS, "CS": SG.QUERY_CS,
}


def _struct(x):
    """Structural form of a plan: class names and field values, recursively,
    so plans built from the two packages' (distinct) classes compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _struct(getattr(x, f.name))) for f in dataclasses.fields(x)
        )
    if isinstance(x, (list, tuple)):
        return tuple(_struct(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((repr(k), _struct(v)) for k, v in x.items()))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.tolist())
    return x


@pytest.fixture(scope="module")
def schemas():
    """The same seeded graphs from both packages' generators."""
    return {
        "pubmed": (SG.make_pubmed(n_docs=300, n_terms=40, n_authors=100, seed=3),
                   JSG.make_pubmed(n_docs=300, n_terms=40, n_authors=100, seed=3)),
        "semmed": (SG.make_semmeddb(50, 60, 80, 200), JSG.make_semmeddb(50, 60, 80, 200)),
    }


@pytest.mark.parametrize("graph", ["pubmed", "semmed"])
def test_generators_give_equal_graphs(schemas, graph):
    p, j = schemas[graph]
    assert p.entities.keys() == j.entities.keys()
    for name, e in p.entities.items():
        assert e.size == j.entities[name].size
        for a, col in e.attributes.items():
            np.testing.assert_array_equal(col, j.entities[name].attributes[a])
    for name, rel in p.relationships.items():
        for c, col in rel.columns.items():
            np.testing.assert_array_equal(col, j.relationships[name].columns[c])


@pytest.mark.parametrize("name", list(QUERIES))
def test_parse_and_plan_equal(schemas, name):
    sql = QUERIES[name]
    p, j = schemas["semmed" if name == "CS" else "pubmed"]
    assert _struct(parse(sql)) == _struct(jparse(sql))
    assert _struct(plan_query(p, parse(sql))) == _struct(jplan(j, jparse(sql)))


@pytest.mark.parametrize("table,key", [("DT", "Doc"), ("DT", "Term"), ("DA", "Doc"), ("DA", "Author")])
def test_fragment_index_arrays_equal(schemas, table, key):
    p, j = schemas["pubmed"]
    pi = pfrag.build_index(p, p.relationships[table], key)
    ji = jfrag.build_index(j, j.relationships[table], key)
    np.testing.assert_array_equal(pi.indptr, ji.indptr)
    assert pi.indptr.dtype == ji.indptr.dtype
    np.testing.assert_array_equal(pi.src_ids(), ji.src_ids())
    assert pi.columns.keys() == ji.columns.keys()
    for c, cf in pi.columns.items():
        jc = ji.columns[c]
        np.testing.assert_array_equal(cf.values, jc.values)
        assert (cf.domain, cf.encoding, cf.encoded_bytes, cf.packed_width) == (
            jc.domain, jc.encoding, jc.encoded_bytes, jc.packed_width)
        np.testing.assert_array_equal(cf.packed, jc.packed)
    assert pi.total_bytes() == ji.total_bytes()


# ---------------------------------------------------------------------------
# Typed errors: the classes, codes and context of tests/test_sql_planner.py
# ---------------------------------------------------------------------------


def test_parse_error_taxonomy_and_position():
    err = pytest.raises(ParseError, parse, "SELECT FROM x").value
    assert isinstance(err, QueryError) and isinstance(err, SyntaxError)
    assert err.code == "PARSE" and err.retryable is False
    assert isinstance(err.context["position"], int)
    assert err.context["near"] in err.context["query"]
    d = err.to_dict()
    assert d["error"] == "ParseError" and d["code"] == "PARSE"
    jd = pytest.raises(jerr.ParseError, jparse, "SELECT FROM x").value.to_dict()
    assert d == jd


@pytest.mark.parametrize("sql", [
    "SELECT",
    "SELECT a.b FROM",
    "SELECT a.b FROM T t WHERE",
    "SELECT a.b FROM T t WHERE a.b = ",
    "SELECT a.b FROM T t GROUP BY",
    "SELECT a.b, FROM T t WHERE a.b = 1",
    "SELECT a.b FROM T t WHERE a.b IN (1",
    "SELECT a.b FROM T t WHERE a.b ~ 3",
])
def test_malformed_sql_raises_the_same_parse_error(sql):
    err = pytest.raises(ParseError, parse, sql).value
    jerr_ = pytest.raises(jerr.ParseError, jparse, sql).value
    assert err.to_dict() == jerr_.to_dict()


@pytest.mark.parametrize("sql", [
    "SELECT x.A FROM Nope x WHERE x.A = 1",
    "SELECT dt.Doc, COUNT(*) FROM DT dt WHERE zz.Doc = 1 GROUP BY dt.Doc",
    "SELECT dt.Doc, COUNT(*) FROM DT dt WHERE dt.Doc = 1 GROUP BY zz.Doc",
    "SELECT dt.Nope, COUNT(*) FROM DT dt WHERE dt.Doc = 1 GROUP BY dt.Nope",
    "SELECT dt.Doc, COUNT(*) FROM DT dt GROUP BY dt.Doc",
    "SELECT dt.Doc, COUNT(*) FROM DT dt JOIN Document d ON dt.Fre = d.Year"
    " WHERE dt.Doc = 1 GROUP BY dt.Doc",
    """SELECT dt2.Doc, SUM(dt1.Fre + dt2.Fre)
       FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
       WHERE dt1.Doc = 1 GROUP BY dt2.Doc""",
])
def test_plan_errors_are_typed_like_the_reference(schemas, sql):
    p, j = schemas["pubmed"]
    err = pytest.raises(QueryError, plan_query, p, parse(sql)).value
    jerr_ = pytest.raises(jerr.QueryError, jplan, j, jparse(sql)).value
    assert isinstance(err, PlanError) and err.code == "PLAN"
    assert err.retryable is False
    assert type(err).__name__ == type(jerr_).__name__
    assert err.to_dict() == jerr_.to_dict()


def test_not_relationship_query_is_plan_error(schemas):
    bad = "SELECT dt.Doc, COUNT(*) FROM DT dt GROUP BY dt.Doc"
    err = pytest.raises(NotRelationshipQuery, plan_query,
                        schemas["pubmed"][0], parse(bad)).value
    assert isinstance(err, PlanError) and isinstance(err, ValueError)
    assert err.code == "PLAN"
