"""Compressed device storage in the PyTorch port against the JAX package, on
the CPU: BCA decode at every width, the storage policy, device columns and
their bytes, the decode-fused hop for every op × measure mode, and the seven
queries under packed storage (block skipping off here; on and auto are in
tests/test_torch_sparsity.py).

The same numpy inputs go through both packages. The JAX kernels run in
interpret mode, as the JAX package's own tests run them on the CPU; the port
runs its plain PyTorch versions (the CUDA kernels are compared with those on
the card by tests/test_torch_cuda.py). Integers — decoded values, packed
words, dictionaries, device bytes — are equal; sum is within rtol=atol=1e-4
(the order of float adds differs), min, max and bool are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.core.fragments import _pack_words as j_pack_words  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.storage import policy as jpolicy  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.fragments import _pack_words  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.robust.errors import ValidationError  # noqa: E402
from repro_torch.storage import (  # noqa: E402
    DenseColumn,
    DictPackedColumn,
    PackedColumn,
    build_device_column,
    choose_device_encoding,
    device_space_report,
    resolve_device_encoding,
)
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

OPS = ["sum", "min", "max", "bool"]
M_MODES = ["none", "dense", "packed", "dict"]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}
ENCODINGS = {
    "auto": "auto",
    "packed": "packed",
    "dict": {("DT", "Term", "Fre"): "dict", ("DT", "Doc", "Fre"): "dict"},
}


def words_u32(t: torch.Tensor) -> np.ndarray:
    """A port word stream (int32 bit patterns) as the reference's uint32."""
    return t.numpy().view(np.uint32)


def _assert_match(got, want, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


class _CF:
    """Minimal ColumnFragments stand-in for build_device_column."""

    def __init__(self, values, domain, packed=None, packed_width=0):
        self.values = values
        self.domain = domain
        self.packed = packed
        self.packed_width = packed_width


# ---------------------------------------------------------------------------
# BCA decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", list(range(1, 33)))
def test_bitunpack_and_bitgather_match_jax_at_every_width(width):
    rng = np.random.default_rng(width)
    count = 1024 + 513  # straddles block and group boundaries
    vals = rng.integers(0, 2**width, size=count, dtype=np.uint64)
    words = _pack_words(vals, width)
    np.testing.assert_array_equal(words, j_pack_words(vals, width))
    got = ops.bitunpack(words, width, count)
    assert got.dtype == torch.int32 and got.shape == (count,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.bitunpack(words, width, count)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), vals.astype(np.uint32))
    ids = rng.integers(0, count, size=300)
    wt = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(
        ref.bitgather_ref(wt, width, torch.from_numpy(ids)).numpy(),
        np.asarray(jref.bitgather_ref(jnp.asarray(words), width, jnp.asarray(ids))),
    )


@pytest.mark.parametrize("count", [0, 1, 31, 32, 33, 1023, 1025, 4097])
def test_bitunpack_odd_counts_match_jax(count):
    rng = np.random.default_rng(count)
    for width in (1, 7, 13, 22, 29, 32):
        vals = rng.integers(0, 2**width, size=count, dtype=np.uint64)
        words = _pack_words(vals, width)
        got = ops.bitunpack(words, width, count).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), vals.astype(np.uint32))
        if count:
            np.testing.assert_array_equal(
                got, np.asarray(jref.bitunpack_ref(jnp.asarray(words), width, count)))


# ---------------------------------------------------------------------------
# Storage policy and device columns
# ---------------------------------------------------------------------------


def _policy_columns():
    rng = np.random.default_rng(1)
    return {
        "narrow_key": (rng.integers(0, 50, size=10_000), 50, True),
        "sparse_measure": (rng.choice([0, 9_999_999, 123456], size=10_000), 10_000_000, False),
        "sparse_key": (rng.choice([0, 9_999_999, 123456], size=10_000), 10_000_000, True),
        "wide_key": (rng.integers(0, 50, size=10_000), 2**40, True),
        "signed_measure": (rng.choice([-7, -1, 3, 12], size=4000), 13, False),
        "fre_like": (rng.integers(1, 20, size=7000), 20, False),
        "empty": (np.zeros(0, np.int64), 10, False),
    }


@pytest.mark.parametrize("name", list(_policy_columns()))
def test_policy_chooser_matches_jax(name):
    vals, dom, is_key = _policy_columns()[name]
    got = choose_device_encoding(vals, dom, is_key)
    assert got == jpolicy.choose_device_encoding(vals, dom, is_key)
    addr = ("T", "K", "c")
    for spec in ("auto", "dense", "packed", {addr: "dense"}, {("T", "K", "d"): "packed"}):
        assert (resolve_device_encoding(spec, addr, vals, dom, is_key)
                == jpolicy.resolve_device_encoding(spec, addr, vals, dom, is_key)), spec


def test_policy_rejects_unknown_and_dict_keys_with_typed_errors():
    vals = np.arange(100) % 17
    with pytest.raises(ValidationError, match="unknown device encoding"):
        resolve_device_encoding("bogus", ("T", "K", "c"), vals, 17, is_key=True)
    with pytest.raises(ValidationError, match="measure-only"):
        resolve_device_encoding({("T", "K", "c"): "dict"}, ("T", "K", "c"), vals, 17, True)
    with pytest.raises(ValueError):  # the reference's error for the same calls
        jpolicy.resolve_device_encoding("bogus", ("T", "K", "c"), vals, 17, is_key=True)


@pytest.mark.parametrize("enc", ["dense", "packed", "dict"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_build_device_column_matches_jax(enc, dtype):
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1000, size=3000)
    vals[::7] = 3  # skew so the dictionary ordering is non-trivial
    tdt, jdt = {"int32": (torch.int32, jnp.int32), "float32": (torch.float32, jnp.float32)}[dtype]
    col = build_device_column(_CF(vals, 1000), enc, tdt, "cpu")
    jcol = jpolicy.build_device_column(_CF(vals, 1000), enc, jdt)
    assert col.kind == jcol.kind == enc
    assert col.count == jcol.count == vals.shape[0]
    assert col.device_nbytes == jcol.device_nbytes
    np.testing.assert_array_equal(col.materialize().numpy(), np.asarray(jcol.materialize()))
    ids = rng.integers(0, vals.shape[0], size=257)
    np.testing.assert_array_equal(col.gather(ids).numpy(), np.asarray(jcol.gather(ids)))
    if enc in ("packed", "dict"):
        assert col.width == jcol.width
        np.testing.assert_array_equal(words_u32(col.words), np.asarray(jcol.words))
    if enc == "dict":
        np.testing.assert_array_equal(col.dictionary.numpy(), np.asarray(jcol.dictionary))


def test_packed_column_reuses_loader_words_and_memoizes():
    vals = np.arange(100) % 17
    packed_words = _pack_words(vals, 5)
    col = build_device_column(_CF(vals, 17, packed=packed_words, packed_width=5),
                              "packed", torch.int32, "cpu")
    assert isinstance(col, PackedColumn) and col.width == 5
    assert col.materialized_nbytes == 0
    first = col.materialize()
    np.testing.assert_array_equal(first.numpy(), vals)
    assert col.materialize() is first  # memo: one decoded copy
    assert col.materialized_nbytes == 4 * 100
    plain = col.materialize(use_kernel=False)  # bypasses the memo
    assert plain is not first and torch.equal(plain, first)


def test_signed_and_sparse_huge_values_take_dict():
    rng = np.random.default_rng(2)
    signed = rng.choice([-7, -1, 3, 12], size=4000)
    col = build_device_column(_CF(signed, 13), "dict", torch.float32, "cpu")
    assert isinstance(col, DictPackedColumn)
    np.testing.assert_array_equal(col.materialize().numpy(), signed)
    sparse = rng.choice(np.array([5, 2**31 - 3, 123456789]), size=4000)
    col = build_device_column(_CF(sparse, 2**31), "dict", torch.int32, "cpu")
    assert col.kind == "dict" and col.device_nbytes < 4 * 4000
    np.testing.assert_array_equal(col.materialize().numpy(), sparse)
    wide = build_device_column(_CF(np.arange(70_000), 70_000), "dict", torch.int32, "cpu")
    assert isinstance(wide, DenseColumn)  # over DICT_MAX_ENTRIES: stays dense


# ---------------------------------------------------------------------------
# The decode-fused hop
# ---------------------------------------------------------------------------


def packed_hop_inputs(op, seed, n_src=700, n_dst=300, E=9000):
    """Random hop inputs with a packed dst, packed/dict measure streams and a
    frontier holding the identity in a quarter of its entries."""
    rng = np.random.default_rng(seed)
    w = rng.random(n_src).astype(np.float32) * 2
    if op == "bool":
        w = (w > 1).astype(np.float32)
    w[rng.random(n_src) < 0.25] = ZERO[op]
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = rng.integers(0, n_dst, E).astype(np.int32)
    mint = rng.integers(0, 40, E)  # includes 0: the ∞·0 guard is on the path
    dst_width, m_width = 9, 6
    mdict = np.array([0.5, 3.0, 0.0, 7.25, 1.0], np.float32)
    midx = rng.integers(0, mdict.shape[0], E)
    return dict(
        w=w, src=src, dst=dst, dst_words=_pack_words(dst, dst_width), dst_width=dst_width,
        m_dense=mint.astype(np.float32), m_words=_pack_words(mint, m_width), m_width=m_width,
        mdict=mdict, midx_words=_pack_words(midx, 3), n_dst=n_dst,
    )


def hop_operands(x, m_mode, dst_packed):
    """(dst, measure, mdict, dst_width, m_width) for one layout."""
    dst = x["dst_words"] if dst_packed else x["dst"]
    dw = x["dst_width"] if dst_packed else 0
    if m_mode == "none":
        return dst, None, None, dw, 0
    if m_mode == "dense":
        return dst, x["m_dense"], None, dw, 0
    if m_mode == "packed":
        return dst, x["m_words"], None, dw, x["m_width"]
    return dst, x["midx_words"], x["mdict"], dw, 3


@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("op", OPS)
def test_packed_hop_matches_jax(op, m_mode, dst_packed):
    x = packed_hop_inputs(op, seed=len(op) * 7 + M_MODES.index(m_mode))
    dst, m, md, dw, mw = hop_operands(x, m_mode, dst_packed)
    kw = dict(n_dst=x["n_dst"], dst_width=dw, m_mode=m_mode, m_width=mw, op=op)
    got = ops.fragment_spmv_packed(x["w"], x["src"], dst, m, md, **kw)
    _assert_match(got, jops.fragment_spmv_packed(x["w"], x["src"], dst, m, md, **kw), op)
    # and the dense hop on the decoded columns: packed == decoded
    mdec = {"none": None, "dense": x["m_dense"], "packed": x["m_dense"],
            "dict": x["mdict"][ref.bitunpack_ref(
                torch.from_numpy(x["midx_words"].view(np.int32)), 3, x["src"].shape[0]
            ).numpy()]}[m_mode]
    _assert_match(got, ops.fragment_spmv(x["w"], x["src"], x["dst"], mdec, x["n_dst"], op=op), op)


@pytest.mark.parametrize("op", OPS)
def test_packed_hop_empty_edge_list(op):
    w = np.ones(5, np.float32)
    empty = np.zeros(0, np.int32)
    got = ops.fragment_spmv_packed(w, empty, np.zeros(0, np.uint32), None, None,
                                   n_dst=4, dst_width=3, op=op)
    np.testing.assert_array_equal(got.numpy(), np.full(4, ZERO[op], np.float32))


# ---------------------------------------------------------------------------
# The engine under packed storage
# ---------------------------------------------------------------------------


PUBMED_KW = dict(n_docs=1500, n_terms=80, n_authors=400, seed=3)
SEMMED_KW = dict(n_concepts=400, n_csemtypes=500, n_predications=800, n_sentences=3000)
CASES = [
    ("SD", SG.QUERY_SD, {"d0": 5}),
    ("FSD", SG.QUERY_FSD, {"d0": 5}),
    ("AS", SG.QUERY_AS, {"a0": 7}),
    ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
    ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
    ("CS", SG.QUERY_CS, {"c0": 11}),
]
EXACT = ("SD", "AD", "RECENT", "CS")  # counts and memberships


def engine_pair(kind: str, encodings):
    """The same seeded graph through each package, under the same device
    encodings (the per-column dict names PubMed columns only)."""
    make, kw = ("make_semmeddb", SEMMED_KW) if kind == "semmed" else ("make_pubmed", PUBMED_KW)
    pschema, jschema = getattr(SG, make)(**kw), getattr(JSG, make)(**kw)
    if kind == "semmed" and isinstance(encodings, dict):
        encodings = "auto"
    port = GQFastEngine(GQFastDatabase(pschema, account_space=False, device="cpu",
                                       device_encodings=encodings))
    jax_ = JEngine(JDatabase(jschema, account_space=False, device_encodings=encodings))
    return pschema, port, jax_


@pytest.fixture(scope="module")
def engines():
    return {(kind, enc): engine_pair(kind, spec)
            for kind in ("pubmed", "semmed") for enc, spec in ENCODINGS.items()}


def check_query(engines, name, q, params, enc, block_skipping):
    schema, port, jax_ = engines[("semmed" if name == "CS" else "pubmed", enc)]
    got = port.prepare(q, block_skipping=block_skipping)(**params)
    jgot = np.asarray(jax_.prepare(q, block_skipping=block_skipping, fusion="off")(**params))
    want = run_sql(schema, q, params)
    assert got.shape == jgot.shape == want.shape and got.dtype == np.float32
    if name in EXACT:
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_array_equal(got, want.astype(np.float32))
    else:
        np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got != 0).any(), "degenerate test: empty result"


@pytest.mark.parametrize("enc", list(ENCODINGS))
@pytest.mark.parametrize("name,q,params", CASES, ids=[c[0] for c in CASES])
def test_queries_under_packed_storage_match_jax_and_oracle(engines, name, q, params, enc):
    check_query(engines, name, q, params, enc, "off")


@pytest.mark.parametrize("enc", list(ENCODINGS))
def test_device_layout_and_space_report_equal_jax(engines, enc):
    for kind in ("pubmed", "semmed"):
        _, port, jax_ = engines[(kind, enc)]
        pdb, jdb = port.db.device, jax_.db.device
        assert pdb.indexes.keys() == jdb.indexes.keys()
        for k, di in pdb.indexes.items():
            ji = jdb.indexes[k]
            cols = [("__dst__", di.dst_col, ji.dst_col)] + [
                (m, c, ji.measure_cols[m]) for m, c in di.measure_cols.items()]
            for name, c, jc in cols:
                assert c.kind == jc.kind, (k, name)
                if c.kind in ("packed", "dict"):
                    assert c.width == jc.width
                    np.testing.assert_array_equal(words_u32(c.words), np.asarray(jc.words))
                if c.kind == "dict":
                    np.testing.assert_array_equal(c.dictionary.numpy(), np.asarray(jc.dictionary))
            np.testing.assert_array_equal(di.block_src_min.numpy(), ji.block_src_min)
            np.testing.assert_array_equal(di.block_src_max.numpy(), ji.block_src_max)
        rep, jrep = device_space_report(pdb), jpolicy.device_space_report(jdb)
        assert rep == jrep
        assert port.db.space_report()["device"] == jax_.db.space_report()["device"]
    if enc == "dict":
        assert engines[("pubmed", enc)][1].db.device.index("DT", "Term").measure_cols["Fre"].kind == "dict"


def test_auto_is_the_default_and_packs_every_key():
    schema = SG.make_pubmed(n_docs=300, n_terms=30, n_authors=80, seed=1)
    db = GQFastDatabase(schema, account_space=False, device="cpu")
    for di in db.device.indexes.values():
        assert di.dst_col.kind == "packed"
    assert db.space_report()["device"]["ratio"] > 1.5


def test_composite_measure_over_a_packed_column_decodes_through_bitunpack():
    """A measure expression that is not one column (dt2.Fre * dt2.Fre) is
    evaluated dense, its packed column decoded whole through bitunpack; the
    hop itself still decodes dst inside the kernel. The reference's planner
    takes the same query."""
    q = """SELECT dt2.Doc, SUM(dt2.Fre * dt2.Fre)
           FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
           WHERE dt1.Doc = :d0 GROUP BY dt2.Doc"""
    schema, port, jax_ = engine_pair("pubmed", "auto")
    col = port.db.device.index("DT", "Term").measure_cols["Fre"]
    assert col.kind == "packed" and col.materialized_nbytes == 0
    got = port.query(q, d0=5)
    assert col.materialized_nbytes == 4 * col.count  # decoded once, memoized
    np.testing.assert_allclose(got, np.asarray(jax_.query(q, d0=5)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, run_sql(schema, q, {"d0": 5}), rtol=1e-4, atol=1e-4)


def test_typed_errors_for_unknown_modes_addresses_and_fusion():
    schema = SG.make_pubmed(n_docs=200, n_terms=20, n_authors=50, seed=1)
    with pytest.raises(ValidationError, match="device_encodings must be one of"):
        GQFastDatabase(schema, device="cpu", device_encodings="bogus")
    with pytest.raises(ValidationError, match="match no index column"):
        GQFastDatabase(schema, device="cpu", device_encodings={("DT", "Term", "fre"): "dense"})
    with pytest.raises(ValidationError, match="unknown device encoding"):
        GQFastDatabase(schema, device="cpu", device_encodings={("DT", "Term", "Fre"): "zip"})
    eng = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu"))
    with pytest.raises(ValidationError, match="block_skipping must be one of"):
        eng.prepare(SG.QUERY_SD, block_skipping="sometimes")
    for fusion in ("on", "auto"):
        assert eng.prepare(SG.QUERY_SD, fusion=fusion).fusion == fusion
    with pytest.raises(ValidationError, match="fusion must be one of"):
        eng.prepare(SG.QUERY_SD, fusion="bogus")


def test_densify_plan_decodes_every_packed_column_once():
    """densify_plan: the all-dense twin of a lowered plan answers the same,
    and its hops bind dense columns only."""
    from repro_torch.core import executor as X
    from repro_torch.core.lower import HopOp

    schema, port, _ = engine_pair("pubmed", "auto")
    q = SG.QUERY_FSD
    phys = port.prepare(q).phys
    dense = X.densify_plan(phys)
    hops = [op for op in dense.ops if isinstance(op, HopOp)]
    assert hops and all(op.dst_col.kind == "dense" for op in hops)
    assert any(op.dst_col.kind == "packed" for op in phys.ops if isinstance(op, HopOp))
    a = X.compile_frontier(port.db.device, phys)(5)
    b = X.compile_frontier(port.db.device, dense)(5)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
