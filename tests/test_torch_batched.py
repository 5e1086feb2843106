"""Batched serving in the PyTorch port against the JAX package, on the CPU.

``PreparedQuery.execute_batch`` answers B parameter bindings in one pass
whose hops are batched (SpMM) hops; here the port's results equal the JAX
engine's ``execute_batch`` and B single calls of the port, for the nine
queries under ``fusion`` 'auto' and 'on', every aggregate, mask seeds and
seed scalars, ``query_topk_batch``, the bucket policy and the validation
contract; and at the kernel level the dense SpMM (``ops.fragment_spmm``,
the port's plain version) against the JAX package's with ``use_pallas=True``
for every op × skipping mode × B ∈ {1, 3, 8} × E ∈ {0, 1, 4097} (the JAX
kernel at every B and E > 0 with skipping off, at B = 3 and E = 4097 under
every mode), per-row ``[B, E]`` measures and the empty relation. The sweep
of the decode-fused SpMM and the batched fused regions is
``test_torch_batched_kernels.py``.

The JAX engine runs its Pallas kernels in interpret mode; the port runs its
plain versions (the path the CPU takes). Tolerances: min, max and bool
equal; sums within rtol=atol=1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.core.engine import batch_bucket as jbatch_bucket  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import executor as X  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    BATCH_BUCKET_CAP,
    GQFastDatabase,
    GQFastEngine,
    batch_bucket,
)
from repro_torch.core.semiring import SEMIRINGS  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active, ops  # noqa: E402
from repro_torch.robust.errors import ValidationError  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

N_DOCS, N_TERMS, N_AUTHORS = 300, 40, 120
SEM = dict(n_concepts=200, n_csemtypes=250, n_predications=400, n_sentences=1500)

AGG_SQL = """
SELECT dt2.Doc, {agg}
FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
WHERE dt1.Doc = :d0
GROUP BY dt2.Doc
"""
AGGS = ["SUM(dt1.Fre * dt2.Fre)", "COUNT(*)", "MIN(dt2.Fre)", "MAX(dt2.Fre)",
        "AVG(dt2.Fre)", "EXISTS(*)"]
EXACT = {"COUNT(*)", "MIN(dt2.Fre)", "MAX(dt2.Fre)", "EXISTS(*)"}

#: name → (sql attribute, parameter → domain; None: a year)
QUERIES = {
    "SD": ("QUERY_SD", {"d0": N_DOCS}),
    "FSD": ("QUERY_FSD", {"d0": N_DOCS}),
    "AS": ("QUERY_AS", {"a0": N_AUTHORS}),
    "AD": ("QUERY_AD", {"t1": N_TERMS, "t2": N_TERMS}),
    "FAD": ("QUERY_FAD", {"t1": N_TERMS, "t2": N_TERMS}),
    "RECENT": ("QUERY_RECENT_AUTHORS", {"t1": N_TERMS, "t2": N_TERMS, "y": None}),
    "CS": ("QUERY_CS", {"c0": SEM["n_concepts"]}),
    "SD_RECENT": ("QUERY_SD_RECENT", {"d0": N_DOCS}),
    "AS_RECENT": ("QUERY_AS_RECENT", {"a0": N_AUTHORS}),
}
EXACT_QUERIES = {"SD", "AD", "RECENT", "CS", "SD_RECENT"}


def _draw(rng, doms: dict, B: int) -> dict:
    return {n: (rng.integers(1990, 2020, B) if d is None else rng.integers(0, d, B))
            for n, d in doms.items()}


def _close(got, want, exact: bool):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _rows_equal_single_calls(pq, params: dict, got, exact: bool):
    B = next(iter(params.values())).shape[0]
    assert got.shape == (B, pq.phys.out_dom)
    for i in range(B):
        _close(got[i], pq(**{n: v[i] for n, v in params.items()}), exact)


@pytest.fixture(scope="module")
def engines():
    """Port and JAX engines over the same generated graphs (default storage)."""
    pub = SG.make_pubmed(n_docs=N_DOCS, n_terms=N_TERMS, n_authors=N_AUTHORS, seed=9)
    jpub = JSG.make_pubmed(n_docs=N_DOCS, n_terms=N_TERMS, n_authors=N_AUTHORS, seed=9)
    sem, jsem = SG.make_semmeddb(**SEM), JSG.make_semmeddb(**SEM)
    port = {"pub": GQFastEngine(GQFastDatabase(pub, account_space=False, device="cpu")),
            "sem": GQFastEngine(GQFastDatabase(sem, account_space=False, device="cpu"))}
    jax = {"pub": JEngine(JDatabase(jpub, account_space=False)),
           "sem": JEngine(JDatabase(jsem, account_space=False))}
    return port, jax


def _pick(engs, name):
    return engs["sem" if name == "CS" else "pub"]


# ---------------------------------------------------------------------------
# the nine queries: port == JAX engine == B single calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fusion", ["auto", "on"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_execute_batch_matches_jax_and_single_calls(engines, name, fusion):
    port, jax = engines
    attr, doms = QUERIES[name]
    q = getattr(SG, attr)
    pq = _pick(port, name).prepare(q, fusion=fusion)
    assert pq.batched_fn is not None
    rng = np.random.default_rng(len(name) + len(fusion))
    params = _draw(rng, doms, 5)  # pads to 8
    got = pq.execute_batch(**params)
    want = _pick(jax, name).prepare(q, fusion=fusion).execute_batch(**params)  # same SQL
    _close(got, want, name in EXACT_QUERIES)
    _rows_equal_single_calls(pq, params, got, name in EXACT_QUERIES)
    for B in (1, 3):
        params = _draw(rng, doms, B)
        _rows_equal_single_calls(pq, params, pq.execute_batch(**params),
                                 name in EXACT_QUERIES)


@pytest.mark.parametrize("agg", AGGS)
def test_every_aggregate_batched(engines, agg):
    port, jax = engines
    sql = AGG_SQL.format(agg=agg)
    pq = port["pub"].prepare(sql)
    rng = np.random.default_rng(1)
    params = {"d0": rng.integers(0, N_DOCS, 3)}
    got = pq.execute_batch(**params)
    _close(got, jax["pub"].prepare(sql).execute_batch(**params), agg in EXACT)
    _rows_equal_single_calls(pq, params, got, agg in EXACT)


@pytest.mark.parametrize("block_skipping", ["off", "on"])
@pytest.mark.parametrize("encodings", ["dense", "packed"])
def test_other_settings_batched(encodings, block_skipping):
    """Dense and packed storage, skipping off and on: the batched rows equal
    the single calls (the dense SpMM and the packed SpMM, scan and active)."""
    schema = SG.make_pubmed(n_docs=N_DOCS, n_terms=N_TERMS, n_authors=N_AUTHORS, seed=9)
    eng = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu",
                                      device_encodings=encodings))
    rng = np.random.default_rng(4)
    for name in ("SD", "FSD", "AD", "AS"):
        attr, doms = QUERIES[name]
        pq = eng.prepare(getattr(SG, attr), block_skipping=block_skipping)
        params = _draw(rng, doms, 6)
        _rows_equal_single_calls(pq, params, pq.execute_batch(**params),
                                 name in EXACT_QUERIES)


def test_mask_seeds_and_seed_scalars(engines):
    """AD and RECENT seed from IN-INTERSECT masks (batched sub-programs;
    RECENT's ``:y`` is a parameter condition, [B, dom]); FSD carries the seed
    scalar d1.Year into a [B, dom] factor."""
    port, _ = engines
    rng = np.random.default_rng(6)
    for name in ("AD", "RECENT", "FSD"):
        attr, doms = QUERIES[name]
        pq = port["pub"].prepare(getattr(SG, attr))
        params = _draw(rng, doms, 7)
        got = pq.execute_batch(**params)
        _rows_equal_single_calls(pq, params, got, name in EXACT_QUERIES)
        assert len({r.tobytes() for r in got}) > 1  # the rows differ


def test_per_row_measure_takes_the_dense_spmm(engines):
    """A hop measure that reads a seed scalar differs from row to row: it
    goes to the dense SpMM as a [B, E] stream, and a fused region holding
    such a hop replays its members."""
    port, _ = engines
    sql = """
    SELECT dt2.Doc, SUM(dt2.Fre * d1.Year)
    FROM ((Document d1 JOIN DT dt1 ON d1.ID = dt1.Doc)
      JOIN DT dt2 ON dt1.Term = dt2.Term)
    WHERE d1.ID = :d0
    GROUP BY dt2.Doc
    """
    rng = np.random.default_rng(8)
    for fusion in ("off", "on"):
        pq = port["pub"].prepare(sql, fusion=fusion)
        params = {"d0": rng.integers(0, N_DOCS, 4)}
        _rows_equal_single_calls(pq, params, pq.execute_batch(**params), False)


def test_seed_ids_follow_the_single_query_rules(engines):
    """A negative id counts from the end of the domain and an id past it
    seeds nothing, row by row, as in the single query."""
    port, _ = engines
    pq = port["pub"].prepare(SG.QUERY_SD)
    params = {"d0": np.array([-1, 5, N_DOCS + 3, -N_DOCS])}
    _rows_equal_single_calls(pq, params, pq.execute_batch(**params), True)
    assert not pq.execute_batch(d0=[N_DOCS + 3]).any()


def test_query_topk_batch(engines):
    port, jax = engines
    ids = [3, 7, 11]
    tops = port["pub"].query_topk_batch(SG.QUERY_SD, k=4, d0=ids)
    assert tops == jax["pub"].query_topk_batch(JSG.QUERY_SD, k=4, d0=ids)
    assert len(tops) == 3
    for i, top in zip(ids, tops):
        assert top == port["pub"].query_topk(SG.QUERY_SD, k=4, d0=i)


# ---------------------------------------------------------------------------
# buckets and the validation contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2, 3, 5, 8, 9, 63, 64, 65, 128, 129, 200])
def test_batch_bucket_equals_jax(b):
    assert batch_bucket(b) == jbatch_bucket(b)
    assert batch_bucket(b) >= b


def test_batch_bucket_policy():
    assert BATCH_BUCKET_CAP == 64
    assert [batch_bucket(b) for b in (1, 2, 3, 5, 8, 9, 64)] == [1, 2, 4, 8, 8, 16, 64]
    assert batch_bucket(65) == 128 and batch_bucket(129) == 192


def test_ragged_batch_pads_and_slices(engines, monkeypatch):
    """B = 5 runs the 8 bucket, the last row repeated; the result has 5 rows."""
    port, _ = engines
    pq = port["pub"].prepare(SG.QUERY_SD)
    seen = []
    fn = pq.batched_fn
    monkeypatch.setattr(pq, "batched_fn", lambda *a: seen.append(a) or fn(*a))
    got = pq.execute_batch(d0=[1, 2, 3, 4, 9])
    assert got.shape == (5, N_DOCS)
    (arr,), = seen
    assert arr.tolist() == [1, 2, 3, 4, 9, 9, 9, 9]
    _rows_equal_single_calls(pq, {"d0": np.array([1, 2, 3, 4, 9])}, got, True)


def test_execute_batch_accepts_lists(engines):
    port, _ = engines
    pq = port["pub"].prepare(SG.QUERY_SD)
    a = pq.execute_batch(d0=[0, 1, 2])
    b = pq.execute_batch(d0=np.asarray([0, 1, 2]))
    assert np.array_equal(a, b)


@pytest.mark.parametrize("bad,match", [
    (dict(t1=[1, 2, 3], t2=[1, 2]), "ragged"),
    (dict(t1=5, t2=[1, 2]), "scalar"),
    (dict(t1=[1, 2]), "missing"),
    (dict(t1=[], t2=[]), "empty"),
    (dict(t1=np.zeros((2, 2)), t2=[1, 2]), "1-D"),
], ids=["ragged", "scalar", "missing", "empty", "2-D"])
def test_execute_batch_rejects_bad_inputs(engines, bad, match):
    port, jax = engines
    pq = port["pub"].prepare(SG.QUERY_AD)
    with pytest.raises(ValidationError, match=match):
        pq.execute_batch(**bad)
    with pytest.raises(ValueError, match=match):  # the reference raises alike
        jax["pub"].prepare(JSG.QUERY_AD).execute_batch(**bad)


def test_parameter_free_query_is_rejected(engines):
    port, _ = engines
    sql = """
    SELECT dt2.Doc, COUNT(*)
    FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
    WHERE dt1.Doc = 3
    GROUP BY dt2.Doc
    """
    pq = port["pub"].prepare(sql)
    assert pq.batched_fn is None
    with pytest.raises(ValidationError, match="parameterized"):
        pq.execute_batch(d0=[1])
    with pytest.raises(ValidationError, match="at least one query parameter"):
        X.compile_frontier_batched(port["pub"].db.device, pq.phys)


def test_batched_scatter_flattens_rows():
    """Semiring.scatter with a [B, k] index updates row b at its own ids,
    duplicates accumulating under ⊕."""
    for name in ("sum", "min", "max", "exists"):
        sr = SEMIRINGS[name]
        acc = torch.full((3, 5), sr.zero)
        idx = torch.tensor([[0, 0], [4, 1], [2, 2]])
        val = torch.tensor([[2.0, 3.0], [1.0, 5.0], [7.0, 7.0]])
        got = sr.scatter(acc, idx, val)
        want = torch.stack([sr.scatter(acc[b], idx[b], val[b]) for b in range(3)])
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# kernel level: the dense SpMM
# ---------------------------------------------------------------------------

OPS = ["sum", "min", "max", "bool"]
SKIPS = ["off", "on", "auto"]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}
N_SRC, N_DST = 5000, 300


def _assert_match(got, want, op):
    _close(got, want, op != "sum")


def _frontier(B, op, seed, n=N_SRC, live=1.0):
    """B rows with identity entries (a quarter), each row live on a prefix
    of ``live`` × n sources, so the union list is sparse below 1."""
    rng = np.random.default_rng(seed)
    W = (rng.random((B, n)) * 2).astype(np.float32)
    if op == "bool":
        W = (W > 1).astype(np.float32)
    W[rng.random(W.shape) < 0.25] = ZERO[op]
    W[:, int(live * n):] = ZERO[op]
    return W


def _edges(E, seed):
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, N_SRC, E)).astype(np.int32)
    dst = rng.integers(0, N_DST, E).astype(np.int32)
    m = rng.integers(0, 40, E).astype(np.float32)
    return src, dst, m


# ---------------------------------------------------------------------------
# fragment_spmm (dense columns): shared, absent and per-row measures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_spmm_matches_jax(op):
    for E in (0, 1, 4097):
        src, dst, m = _edges(E, E + 7)
        blocks = active.block_ranges(src)
        for B in (1, 3, 8):
            W = _frontier(B, op, 3 * B + E, live=0.3 if E > 1 else 1.0)
            scan = ops.fragment_spmm(W, src, dst, m, N_DST, op=op)
            none = ops.fragment_spmm(W, src, dst, None, N_DST, op=op)
            _assert_match(none, ops.fragment_spmm(W, src, dst, np.ones(E, np.float32), N_DST,
                                                  op=op), op)
            for b in range(B):
                _assert_match(scan[b], ops.fragment_spmv(W[b], src, dst, m, N_DST, op=op), op)
            for mode in SKIPS:
                got = ops.fragment_spmm(W, src, dst, m, N_DST, op=op, blocks=blocks,
                                        block_skipping=mode)
                _assert_match(got, scan, op)
                if E and (mode == "off" or (B == 3 and E == 4097)):
                    _assert_match(got, jops.fragment_spmm(W, src, dst, m, N_DST, op=op,
                                                          blocks=blocks,
                                                          block_skipping=mode), op)


@pytest.mark.parametrize("mode", SKIPS)
@pytest.mark.parametrize("op", OPS)
def test_spmm_per_row_measures(op, mode):
    """A ``[B, E]`` measure (one stream per row, the kernel's row stride E):
    each row equals its own SpMV, and the whole equals the reference (its
    XLA fallback takes per-row streams)."""
    src, dst, _ = _edges(4097, 11)
    rng = np.random.default_rng(12)
    for B in (1, 3, 8):
        W = _frontier(B, op, B, live=0.5)
        m = rng.random((B, src.shape[0])).astype(np.float32)
        m[rng.random(m.shape) < 0.1] = 0.0
        got = ops.fragment_spmm(W, src, dst, m, N_DST, op=op,
                                blocks=active.block_ranges(src), block_skipping=mode)
        for b in range(B):
            _assert_match(got[b], ops.fragment_spmv(W[b], src, dst, m[b], N_DST, op=op), op)
        _assert_match(got, jops.fragment_spmm(W, src, dst, m, N_DST, op=op), op)


@pytest.mark.parametrize("op", OPS)
def test_spmm_empty_relation(op):
    W = _frontier(2, op, 1, n=5)
    e = np.zeros(0, np.int32)
    for m in (None, np.zeros(0, np.float32), np.zeros((2, 0), np.float32)):
        out = ops.fragment_spmm(W, e, e, m, 7, op=op, blocks=active.block_ranges(e),
                                block_skipping="on")
        assert tuple(out.shape) == (2, 7) and bool((out == ZERO[op]).all())
    out = ops.fragment_spmm_packed(W, e, np.zeros(0, np.uint32), n_dst=7, dst_width=3, op=op)
    assert tuple(out.shape) == (2, 7) and bool((out == ZERO[op]).all())
    _assert_match(ops.fragment_spmm(W, e, e, np.zeros(0, np.float32), 7, op=op),
                  jops.fragment_spmm(W, e, e, np.zeros(0, np.float32), 7, op=op), op)


