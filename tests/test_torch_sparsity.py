"""Frontier-sparsity block skipping in the PyTorch port against the JAX
package, on the CPU: block metadata, the active-block lists (equal to the
reference's for the same frontier), the active hops over dense and packed
columns at several supports, and the seven queries with ``block_skipping``
'on' and 'auto' under every device encoding.

The same numpy inputs go through both packages; the JAX kernels run in
interpret mode, the port its plain versions (the list is built by the same
device-side code the card runs). Block lists are equal; skip equals scan
exactly for min/max/bool and within rtol=atol=1e-4 for sum, as does the port
against the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.core.fragments import _pack_words  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.kernels import active as jactive  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active, ops, ref  # noqa: E402
from repro_torch.kernels.params import EDGE_BLOCK  # noqa: E402
from repro_torch.robust.errors import ValidationError  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

N_DST = 256
OPS = ["sum", "min", "max", "bool"]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}


def _assert_match(got, want, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def edges():
    """The reference's sparsity edge set: a 4-block CSR index with a degree-0
    gap (sources 3000..3999 have no edges, so a support landing only there
    activates a block whose edges all carry the identity) and heavy heads."""
    rng = np.random.default_rng(42)
    n_src = 8192
    deg = np.full(n_src, 2, np.int64)
    deg[3000:4000] = 0
    deg[:100] = 40
    E = int(deg.sum())
    deg[n_src - 1] += (-E) % EDGE_BLOCK  # E a block multiple
    src = np.repeat(np.arange(n_src, dtype=np.int32), deg)
    E = src.shape[0]
    dst = rng.integers(0, N_DST, E).astype(np.int32)
    m = (rng.random(E) * 9 + 1).astype(np.float32)
    return n_src, src, dst, m


@pytest.fixture(scope="module")
def blocks(edges):
    return active.block_ranges(edges[1])


def frontier(n_src, sl, op="sum"):
    w = np.full(n_src, ZERO[op], np.float32)
    w[sl] = 1.5
    return w


PATTERNS = {
    "empty": lambda n: slice(0, 0),
    "one_seed": lambda n: slice(7, 8),
    "first_block": lambda n: slice(0, 3),
    "last_block": lambda n: slice(n - 2, n),
    "gap_only": lambda n: slice(3200, 3400),
    "middle": lambda n: slice(5000, 5200),
    "all_active": lambda n: slice(0, n),
}


# ---------------------------------------------------------------------------
# metadata and lists
# ---------------------------------------------------------------------------


def test_block_ranges_equal_jax(edges, blocks):
    src = edges[1]
    for got, want in zip(blocks, jactive.block_ranges(src)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for got, want in zip(active.block_ranges(np.zeros(0, np.int64)),
                         jactive.block_ranges(np.zeros(0, np.int64))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [
    [False, True, False, True, True, False], [False] * 4, [True] * 5, [True],
    [False, False, True],
], ids=["mixed", "none", "all", "single", "last"])
def test_compact_blocks_equal_jax(flags):
    idx, n = active.compact_blocks(torch.tensor(flags))
    jidx, jn = jactive.compact_blocks(jnp.asarray(flags))
    assert idx.dtype == n.dtype == torch.int32 and n.shape == (1,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


@pytest.mark.parametrize("n,nb", [(0, 256), (1, 256), (3, 256), (5, 256), (300, 256),
                                  (64, 64), (65, 1000), (1, 1)])
def test_bucket_capacity_equal_jax(n, nb):
    assert active.bucket_capacity(n, nb) == jactive.bucket_capacity(n, nb)


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_block_lists_equal_jax(edges, blocks, pattern):
    n_src = edges[0]
    w = frontier(n_src, PATTERNS[pattern](n_src))
    src_min, src_max = blocks
    # the device form (full capacity), as the hop builds it
    bi, na = active.active_block_list(torch.from_numpy(w), 0.0, torch.from_numpy(src_min),
                                      torch.from_numpy(src_max))
    jbi, jna = jactive.active_block_list(jnp.asarray(w), 0.0, jnp.asarray(src_min),
                                         jnp.asarray(src_max))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(jbi))
    np.testing.assert_array_equal(na.numpy(), np.asarray(jna))
    # the host form (bucketed capacity)
    got = active.active_block_list_np(w != 0, src_min, src_max)
    want = jactive.active_block_list_np(w != 0, src_min, src_max)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


# ---------------------------------------------------------------------------
# active hops: skip == scan == JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("op", OPS)
def test_dense_active_hop_matches_scan_and_jax(edges, blocks, op, mode):
    n_src, src, dst, m = edges
    for name, pat in PATTERNS.items():
        w = frontier(n_src, pat(n_src), op)
        scan = ops.fragment_spmv(w, src, dst, m, N_DST, op=op)
        got = ops.fragment_spmv(w, src, dst, m, N_DST, op=op, blocks=blocks,
                                block_skipping=mode)
        _assert_match(got, scan, op)
        _assert_match(got, jops.fragment_spmv(w, src, dst, m, N_DST, op=op, blocks=blocks,
                                              block_skipping=mode), op)
        if name in ("empty", "gap_only"):
            assert (got.numpy() == ZERO[op]).all(), name


@pytest.mark.parametrize("m_mode", ["none", "dense", "packed", "dict"])
@pytest.mark.parametrize("op", OPS)
def test_packed_active_hop_matches_scan_and_jax(edges, blocks, m_mode, op):
    n_src, src, dst, m = edges
    rng = np.random.default_rng(7)
    dw = int(N_DST - 1).bit_length()
    words_dst = _pack_words(dst, dw)
    midx = rng.integers(0, 32, src.shape[0]).astype(np.int32)
    mdict = (rng.random(32) * 5 + 1).astype(np.float32)
    words_m = _pack_words(midx, 5)
    meas = {"none": None, "dense": m, "packed": words_m, "dict": words_m}[m_mode]
    kw = dict(n_dst=N_DST, dst_width=dw, m_mode=m_mode,
              m_width=5 if m_mode in ("packed", "dict") else 0, op=op)
    md = mdict if m_mode == "dict" else None
    for sl in (slice(0, 5), slice(3200, 3300), slice(n_src - 3, n_src), slice(0, n_src)):
        w = frontier(n_src, sl, op)
        scan = ops.fragment_spmv_packed(w, src, words_dst, meas, md, **kw)
        for mode in ("on", "auto"):
            got = ops.fragment_spmv_packed(w, src, words_dst, meas, md, blocks=blocks,
                                           block_skipping=mode, **kw)
            _assert_match(got, scan, op)
        _assert_match(got, jops.fragment_spmv_packed(
            w, src, words_dst, meas, md, blocks=blocks, block_skipping="on", **kw), op)


@pytest.mark.parametrize("op", OPS)
def test_auto_threshold_scan_order_gives_the_same_result(edges, blocks, op):
    """Above 'auto''s threshold the active kernels take every block in scan
    order: the plain active version with scan_above=0 equals the list."""
    n_src, src, dst, m = edges
    w = torch.from_numpy(frontier(n_src, slice(0, 3), op))
    s, d, mt = (torch.from_numpy(a) for a in (src, dst, m))
    bi, na = active.active_block_list(w, ZERO[op], *(torch.from_numpy(b) for b in blocks))
    assert int(na[0]) == 1
    listed = ref.fragment_spmv_active_ref(w, s, d, mt, bi, na, N_DST, op=op)
    scanned = ref.fragment_spmv_active_ref(w, s, d, mt, bi, na, N_DST, op=op, scan_above=0)
    _assert_match(listed, scanned, op)
    assert ref.listed_edges(bi, na, src.shape[0]).shape[0] == EDGE_BLOCK
    assert ref.listed_edges(bi, na, src.shape[0], scan_above=0).shape[0] == src.shape[0]


def test_off_missing_blocks_and_unknown_mode(edges, blocks):
    n_src, src, dst, m = edges
    w = frontier(n_src, slice(0, 10))
    scan = ops.fragment_spmv(w, src, dst, m, N_DST)
    np.testing.assert_array_equal(
        scan, ops.fragment_spmv(w, src, dst, m, N_DST, blocks=blocks, block_skipping="off"))
    np.testing.assert_array_equal(
        scan, ops.fragment_spmv(w, src, dst, m, N_DST, blocks=None, block_skipping="auto"))
    with pytest.raises(ValidationError, match="block_skipping"):
        ops.fragment_spmv(w, src, dst, m, N_DST, blocks=blocks, block_skipping="maybe")


# ---------------------------------------------------------------------------
# the engine with block skipping
# ---------------------------------------------------------------------------


PUBMED_KW = dict(n_docs=1500, n_terms=80, n_authors=400, seed=3)
SEMMED_KW = dict(n_concepts=400, n_csemtypes=500, n_predications=800, n_sentences=3000)
ENCODINGS = {
    "auto": "auto",
    "packed": "packed",
    "dict": {("DT", "Term", "Fre"): "dict", ("DT", "Doc", "Fre"): "dict"},
}
CASES = [
    ("SD", SG.QUERY_SD, {"d0": 5}),
    ("FSD", SG.QUERY_FSD, {"d0": 5}),
    ("AS", SG.QUERY_AS, {"a0": 7}),
    ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
    ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
    ("CS", SG.QUERY_CS, {"c0": 11}),
]
EXACT = ("SD", "AD", "RECENT", "CS")


@pytest.fixture(scope="module")
def engines():
    out = {}
    for kind, make, kw in (("pubmed", "make_pubmed", PUBMED_KW),
                           ("semmed", "make_semmeddb", SEMMED_KW)):
        for enc, spec in ENCODINGS.items():
            if kind == "semmed" and isinstance(spec, dict):
                spec = "auto"  # the override names PubMed columns
            pschema, jschema = getattr(SG, make)(**kw), getattr(JSG, make)(**kw)
            out[(kind, enc)] = (
                pschema,
                GQFastEngine(GQFastDatabase(pschema, account_space=False, device="cpu",
                                            device_encodings=spec)),
                JEngine(JDatabase(jschema, account_space=False, device_encodings=spec)),
            )
    return out


@pytest.mark.parametrize("block_skipping", ["on", "auto"])
@pytest.mark.parametrize("enc", list(ENCODINGS))
@pytest.mark.parametrize("name,q,params", CASES, ids=[c[0] for c in CASES])
def test_queries_with_skipping_match_jax_and_oracle(engines, name, q, params, enc,
                                                    block_skipping):
    schema, port, jax_ = engines[("semmed" if name == "CS" else "pubmed", enc)]
    got = port.prepare(q, block_skipping=block_skipping)(**params)
    jgot = np.asarray(jax_.prepare(q, block_skipping=block_skipping, fusion="off")(**params))
    want = run_sql(schema, q, params)
    off = port.prepare(q, block_skipping="off")(**params)
    assert got.shape == jgot.shape == want.shape == off.shape and got.dtype == np.float32
    if name in EXACT:
        for other in (jgot, want.astype(np.float32), off):
            np.testing.assert_array_equal(got, other)
    else:
        for other in (jgot, want, off):
            np.testing.assert_allclose(got, other, rtol=1e-4, atol=1e-4)
    assert (got != 0).any(), "degenerate test: empty result"


Q_SCORE = """
SELECT dt2.Doc, {call}
FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
WHERE dt1.Doc = :d0
GROUP BY dt2.Doc
"""


@pytest.mark.parametrize("agg", ["SUM", "COUNT", "MIN", "MAX", "AVG", "EXISTS"])
def test_engine_modes_agree_for_every_aggregate(engines, agg):
    call = {"COUNT": "COUNT(*)", "EXISTS": "EXISTS(*)"}.get(agg, f"{agg}(dt1.Fre * dt2.Fre)")
    q = Q_SCORE.format(call=call)
    schema, port, _ = engines[("pubmed", "auto")]
    res = {mode: port.prepare(q, block_skipping=mode)(d0=7) for mode in ("off", "on", "auto")}
    for mode in ("on", "auto"):
        if agg in ("SUM", "AVG"):
            np.testing.assert_allclose(res[mode], res["off"], rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(res[mode], res["off"])
    np.testing.assert_allclose(res["auto"], run_sql(schema, q, {"d0": 7}), rtol=1e-4, atol=1e-4)
    assert (res["off"] != 0).any(), "degenerate test: empty result"


def test_explain_and_cache_key_by_mode(engines):
    _, port, _ = engines[("pubmed", "auto")]
    q = Q_SCORE.format(call="COUNT(*)")
    pq = port.prepare(q)
    assert "block_skipping: auto" in pq.explain() and "fusion: auto" in pq.explain()
    # distinct modes are distinct cache entries, not silently shared
    assert port.prepare(q, block_skipping="off") is not pq
    assert port.prepare(q, block_skipping="off").block_skipping == "off"
    assert port.prepare(q) is pq


def test_device_db_carries_block_metadata_on_the_device(engines):
    _, port, jax_ = engines[("pubmed", "auto")]
    for k, di in port.db.device.indexes.items():
        E = int(di.src_ids.shape[0])
        assert isinstance(di.block_src_min, torch.Tensor)
        assert di.block_src_min.device == di.src_ids.device
        assert di.block_src_min.dtype == torch.int32
        assert di.block_src_min.shape[0] == active.n_edge_blocks(E)
        ji = jax_.db.device.indexes[k]
        np.testing.assert_array_equal(di.block_src_max.numpy(), ji.block_src_max)
