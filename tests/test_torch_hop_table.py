"""The packed hop's per-CTA aggregation table, as far as the CPU sees it: the
hot-share statistic built with each device index (also when a database is
carried across from the JAX package), the per-index choice the dispatch
hands the kernel wrapper, and the packed entry at every hot share against
the JAX package's packed hop on the same numpy inputs. The kernel itself is
held to the plain versions on the card in ``tests/test_torch_cuda.py``.
Sums within rtol = atol = 1e-4, min/max/bool exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.fragments import _pack_words as j_pack_words  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import device_db_from_numpy  # noqa: E402
from repro_torch.core import executor as X  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.lower import HopOp  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active, ops, params  # noqa: E402
from repro_torch.kernels import fragment_spmv_packed as pkernel  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

OPS = ["sum", "min", "max", "bool"]


@pytest.fixture(scope="module")
def pubmed():
    schema = SG.make_pubmed(n_docs=3000, n_terms=80, n_authors=600, seed=2)
    return schema, GQFastDatabase(schema, account_space=False, device="cpu")


def test_hot_share_is_the_largest_destination_degree_over_the_edges(pubmed):
    schema, db = pubmed
    for (table, key), di in db.device.indexes.items():
        host = db.host_indexes[(table, key)]
        dst = next(c.values for n, c in host.columns.items()
                   if n != key and n in (schema.relationships[table].fk1,
                                         schema.relationships[table].fk2))
        want = np.bincount(dst).max() / dst.shape[0]
        assert di.hot_share == pytest.approx(want, rel=1e-12), (table, key)
    # Zipf authors make I_DA.Doc hot; documents spread over I_DT.Term
    assert db.device.index("DA", "Doc").hot_share >= params.HOP_TABLE_HOT_SHARE
    assert db.device.index("DT", "Term").hot_share < params.HOP_TABLE_HOT_SHARE


def test_hot_share_reaches_the_lowered_hops(pubmed):
    _, db = pubmed
    pq = GQFastEngine(db).prepare(SG.QUERY_AS, fusion="off")
    hops = [op for op in pq.phys.ops if type(op).__name__ == "HopOp"]
    assert hops
    for op in hops:
        assert op.hot_share == db.device.index(op.table, op.src_key).hot_share


def test_hot_share_of_an_empty_column_and_convert():
    assert X.dst_hot_share(np.zeros(0, np.int64)) == 0.0
    assert X.dst_hot_share(np.array([3, 3, 1, 0])) == 0.5


@pytest.mark.parametrize("host", [True, False], ids=["host_indexes", "arrays_only"])
def test_convert_carries_the_hot_share(host):
    """A database carried across from the JAX package gets each index's hot
    share from the host index's dst column, or without host indexes from
    the decoded dst column of the arrays (packed under "auto")."""
    from test_torch_convert import jax_device_arrays

    kw = dict(n_docs=1500, n_terms=60, n_authors=300, seed=4)
    jdb = JDatabase(JSG.make_pubmed(**kw), account_space=False)
    own = GQFastDatabase(SG.make_pubmed(**kw), account_space=False, device="cpu")
    got = device_db_from_numpy(own.schema, jax_device_arrays(jdb.device), "cpu",
                               host_indexes=own.host_indexes if host else None)
    for k, di in own.device.indexes.items():
        assert got.indexes[k].hot_share == di.hot_share, k
    assert got.index("DA", "Doc").hot_share >= params.HOP_TABLE_HOT_SHARE


def test_hot_share_is_required_where_hops_are_built():
    """No layer has a default for it: an index, a lowered hop and a fused
    region's operands without one are refused."""
    t = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        X.make_device_index(np.array([0, 1]), np.zeros(1, np.int32), None, {}, "cpu")
    with pytest.raises(TypeError):
        HopOp("T", "K", "E", 1, t, t, None)
    with pytest.raises(TypeError):
        ops.FusedHopOperands(t, t)
    assert ops.FusedHopOperands(t, t, hot_share=0.25).hot_share == 0.25


def test_uses_table_threshold():
    t = params.HOP_TABLE_HOT_SHARE
    assert ops.uses_table(t) and ops.uses_table(1.0)
    assert not ops.uses_table(t / 2) and not ops.uses_table(0.0)


@pytest.mark.parametrize("hot_share,table", [(0.5, True), (0.0, False),
                                             (params.HOP_TABLE_HOT_SHARE, True)])
@pytest.mark.parametrize("skipping", ["off", "on"])
def test_dispatch_passes_the_choice_to_the_kernel_wrapper(monkeypatch, hot_share, table,
                                                          skipping):
    """With the kernel path taken (``_plain`` forced off), the wrapper the
    dispatch calls gets ``table`` from the hot share; the stand-ins (the hop
    wrappers and the list kernel's) return the plain versions' results."""
    from repro_torch.kernels import block_list, ref

    monkeypatch.setattr(block_list, "block_list", lambda w, zero, smin, smax, flags:
                        active.active_block_list(w, zero, smin, smax))
    seen = []
    for name, plain in (("fragment_spmv_packed", ref.fragment_spmv_packed_ref),
                        ("fragment_spmv_packed_active", ref.fragment_spmv_packed_active_ref)):
        def spy(*a, _plain=plain, table, **k):
            seen.append(table)
            return _plain(*a, **k)

        monkeypatch.setattr(pkernel, name, spy)
    monkeypatch.setattr(ops, "_plain", lambda t, uk: False)
    x = _inputs("sum", 9000, 3)
    blocks = tuple(torch.from_numpy(b) for b in active.block_ranges(x["src"]))
    got = ops.fragment_spmv_packed(x["w"], x["src"], x["dst"], n_dst=x["n_dst"], op="sum",
                                   hot_share=hot_share, blocks=blocks, block_skipping=skipping)
    assert seen == [table]
    assert got.shape == (x["n_dst"],)


def _inputs(op, E, seed, n_src=500, n_dst=40):
    rng = np.random.default_rng(seed)
    w = (rng.random(n_src) * 2).astype(np.float32)
    if op == "bool":
        w = (w > 1).astype(np.float32)
    elif op != "sum":
        w[rng.random(n_src) < 0.2] = np.inf if op == "min" else -np.inf
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = np.minimum(rng.zipf(1.5, E) - 1, n_dst - 1).astype(np.int32)  # hot low ids
    mint = rng.integers(0, 9, E)
    return dict(w=w, src=src, dst=dst, mint=mint, n_dst=n_dst)


@pytest.mark.parametrize("E", [1, 4095, 4097, 20_000])
@pytest.mark.parametrize("op", OPS)
def test_packed_entry_matches_reference_at_any_hot_share(op, E):
    """The packed entry on packed dst and measure words, with the index hot
    and not, against the JAX package's packed hop (plain and Pallas in
    interpret mode); on the CPU the hot share changes nothing."""
    x = _inputs(op, E, E + len(op))
    dwords, mwords = j_pack_words(x["dst"], 6), j_pack_words(x["mint"], 4)
    kw = dict(n_dst=x["n_dst"], dst_width=6, m_mode="packed", m_width=4, op=op)
    want = np.asarray(jops.fragment_spmv_packed(x["w"], x["src"], dwords, mwords, **kw,
                                                use_pallas=False))
    got = ops.fragment_spmv_packed(x["w"], x["src"], dwords, mwords, hot_share=1.0, **kw)
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        assert np.array_equal(got.numpy(), want)
    cold = ops.fragment_spmv_packed(x["w"], x["src"], dwords, mwords, hot_share=0.0, **kw)
    assert torch.equal(got, cold)
    if E == 4097:
        pal = np.asarray(jops.fragment_spmv_packed(x["w"], x["src"], dwords, mwords, **kw))
        np.testing.assert_allclose(got.numpy(), pal, rtol=1e-4, atol=1e-4)


def test_engine_answers_do_not_move_with_the_table(pubmed, monkeypatch):
    """Queries' answers with the threshold past every index (no table) and
    at 0 (every packed hop aggregates) are the same on the CPU, where the
    packed hop is the plain version whatever the choice."""
    schema, db = pubmed
    eng = GQFastEngine(db)
    qs = [("SD", SG.QUERY_SD, {"d0": 5}), ("AS", SG.QUERY_AS, {"a0": 7}),
          ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
          ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 7})]
    out = {}
    for thr in (float("inf"), 0.0):
        monkeypatch.setattr(params, "HOP_TABLE_HOT_SHARE", thr)
        out[thr] = {n: eng.query(q, **p) for n, q, p in qs}
    for n, _, _ in qs:
        assert np.array_equal(out[float("inf")][n], out[0.0][n]), n
