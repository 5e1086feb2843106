"""The batched hops' per-CTA table, as far as the CPU sees it: the choice the
batched dispatch (``ops.fragment_spmm``, ``ops.fragment_spmm_packed``) hands
the kernel wrappers from an index's hot share, the batched executor handing
each HopOp's hot share to both batched entries (also through a fused
region composed unfused), the batched entries on a graph with one hot
destination against the JAX package's batched hops (its Pallas kernels in
interpret mode), for every op, and ``execute_batch`` rows against their
single calls on Zipf-hot authors with the table chosen everywhere and
nowhere. The kernels themselves (the row-chunk scratch, the table with a
row chunk a slot) are held to the plain versions on the card in
``tests/test_torch_cuda.py``. Sums within rtol = atol = 1e-4, min/max/bool
exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fragments import _pack_words as j_pack_words  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active, ops, params, ref  # noqa: E402
from repro_torch.kernels import fragment_spmm as skernel  # noqa: E402
from repro_torch.kernels import fragment_spmm_packed as spkernel  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

OPS = ["sum", "min", "max", "bool"]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}
N_SRC, N_DST, HOT = 600, 50, 3


def _assert_match(got, want, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


def _hot_graph(op, B, E, seed):
    """B frontier rows (a quarter identity) over a src-sorted edge list whose
    destination HOT takes 40% of the edges."""
    rng = np.random.default_rng(seed)
    W = (rng.random((B, N_SRC)) * 2).astype(np.float32)
    if op == "bool":
        W = (W > 1).astype(np.float32)
    W[rng.random(W.shape) < 0.25] = ZERO[op]
    src = np.sort(rng.integers(0, N_SRC, E)).astype(np.int32)
    dst = rng.integers(0, N_DST, E).astype(np.int32)
    dst[rng.random(E) < 0.4] = HOT
    mint = rng.integers(0, 9, E)
    return W, src, dst, mint


@pytest.fixture
def kernel_spies(monkeypatch):
    """The four SpMM wrappers replaced by stand-ins that record ``table`` and
    return the plain versions' results; the list kernel's wrapper by the
    plain list; the kernel path taken for CPU tensors."""
    from repro_torch.kernels import block_list

    monkeypatch.setattr(block_list, "block_list", lambda w, zero, smin, smax, flags=False:
                        active.active_block_list(w, zero, smin, smax))
    seen = []
    for mod, name, plain in (
        (skernel, "fragment_spmm", ref.fragment_spmm_ref),
        (skernel, "fragment_spmm_active", ref.fragment_spmm_active_ref),
        (spkernel, "fragment_spmm_packed", ref.fragment_spmm_packed_ref),
        (spkernel, "fragment_spmm_packed_active", ref.fragment_spmm_packed_active_ref),
    ):
        def spy(*a, _plain=plain, _name=name, table, **k):
            seen.append((_name, table))
            return _plain(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(ops, "_plain", lambda t, uk: False)
    return seen


@pytest.mark.parametrize("hot_share,table", [(0.5, True), (0.0, False),
                                             (params.HOP_TABLE_HOT_SHARE, True),
                                             (params.HOP_TABLE_HOT_SHARE / 2, False)])
@pytest.mark.parametrize("skipping", ["off", "on"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_batched_dispatch_passes_the_choice_to_the_kernel_wrapper(kernel_spies, hot_share,
                                                                   table, skipping, packed):
    """With the kernel path taken, the batched wrapper the dispatch calls (the
    scan, or the active kernel when skipping) gets ``table`` from the hot
    share, on both sides of HOP_TABLE_HOT_SHARE."""
    W, src, dst, mint = _hot_graph("sum", 5, 9000, 1)
    blocks = tuple(torch.from_numpy(b) for b in active.block_ranges(src))
    kw = dict(op="sum", blocks=blocks, block_skipping=skipping, hot_share=hot_share)
    if packed:
        got = ops.fragment_spmm_packed(W, src, j_pack_words(dst, 6), n_dst=N_DST, dst_width=6,
                                       **kw)
        name = "fragment_spmm_packed"
    else:
        got = ops.fragment_spmm(W, src, dst, mint.astype(np.float32), N_DST, **kw)
        name = "fragment_spmm"
    assert kernel_spies == [(name + ("_active" if skipping == "on" else ""), table)]
    assert got.shape == (5, N_DST)


def test_uses_table_is_the_batched_choice_too():
    """One threshold for single and batched hops."""
    t = params.HOP_TABLE_HOT_SHARE
    assert ops.uses_table(t) and not ops.uses_table(np.nextafter(t, 0))


@pytest.fixture(scope="module")
def pubmed():
    return SG.make_pubmed(n_docs=2500, n_terms=70, n_authors=500, seed=3)


@pytest.mark.parametrize("fusion", ["off", "auto"])
@pytest.mark.parametrize("encodings", ["dense", "auto"])
def test_batched_executor_passes_each_hops_hot_share(pubmed, monkeypatch, encodings, fusion):
    """Every batched hop of execute_batch reaches ops.fragment_spmm (dense
    storage) or ops.fragment_spmm_packed (packed storage) with the hot share
    of the index it streams, on AS, AS-recent (a two-hop region over the
    scratch budget of a batch, run unfused under 'auto') and SD."""
    db = GQFastDatabase(pubmed, account_space=False, device="cpu",
                        device_encodings=encodings)
    by_src = {id(di.src_ids): di.hot_share for di in db.device.indexes.values()}
    seen = []
    for name in ("fragment_spmm", "fragment_spmm_packed"):
        real = getattr(ops, name)

        def spy(w, src_ids, *a, _real=real, _name=name, hot_share, **k):
            seen.append((_name, by_src.get(id(src_ids)), hot_share))
            return _real(w, src_ids, *a, hot_share=hot_share, **k)

        monkeypatch.setattr(ops, name, spy)
    eng = GQFastEngine(db)
    for q, param in ((SG.QUERY_AS, "a0"), (SG.QUERY_AS_RECENT, "a0"), (SG.QUERY_SD, "d0")):
        eng.prepare(q, fusion=fusion).execute_batch(**{param: np.arange(1, 9)})
    entries = {n for n, _, _ in seen}
    assert entries == {"fragment_spmm" if encodings == "dense" else "fragment_spmm_packed"}
    assert seen and all(want is not None and got == want for _, want, got in seen)
    assert any(ops.uses_table(h) for _, h, _ in seen)  # I_DA.Doc's Zipf-hot authors
    assert any(not ops.uses_table(h) for _, h, _ in seen)  # I_DT.Term's spread documents


@pytest.mark.parametrize("skipping", ["off", "on"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("op", OPS)
def test_batched_entries_match_reference_on_a_hot_destination(op, packed, skipping):
    """The batched entries, with the index hot and not, against the JAX
    package's batched hops (Pallas in interpret mode) on a graph whose one
    destination takes 40% of the edges; on the CPU the hot share changes
    nothing."""
    B, E = 3, 4097
    W, src, dst, mint = _hot_graph(op, B, E, E + len(op))
    blocks = active.block_ranges(src)
    kw = dict(op=op, blocks=blocks, block_skipping=skipping)
    jblocks = tuple(np.asarray(b) for b in blocks)
    if packed:
        dwords, mwords = j_pack_words(dst, 6), j_pack_words(mint, 4)
        pk = dict(n_dst=N_DST, dst_width=6, m_mode="packed", m_width=4)
        want = np.asarray(jops.fragment_spmm_packed(W, src, dwords, mwords, **pk, op=op,
                                                    blocks=jblocks, block_skipping=skipping))
        got = [ops.fragment_spmm_packed(W, src, dwords, mwords, **pk, **kw, hot_share=h)
               for h in (1.0, 0.0)]
    else:
        m = mint.astype(np.float32)
        want = np.asarray(jops.fragment_spmm(W, src, dst, m, N_DST, op=op, blocks=jblocks,
                                             block_skipping=skipping))
        got = [ops.fragment_spmm(W, src, dst, m, N_DST, **kw, hot_share=h) for h in (1.0, 0.0)]
    _assert_match(got[0].numpy(), want, op)
    assert torch.equal(got[0], got[1])
    assert (got[0][:, HOT] != ZERO[op]).any()


@pytest.mark.parametrize("threshold", [0.0, float("inf")], ids=["table_everywhere",
                                                                  "table_nowhere"])
@pytest.mark.parametrize("name", ["AS", "AS_RECENT", "FSD"])
def test_execute_batch_rows_equal_single_calls_on_hot_authors(pubmed, monkeypatch, name,
                                                              threshold):
    """execute_batch's rows (B = 5, padded to 8, and 8) against their single
    calls within 1e-4 on the float queries that reach the Zipf-hot authors,
    with the table chosen for every index and for none."""
    monkeypatch.setattr(params, "HOP_TABLE_HOT_SHARE", threshold)
    eng = GQFastEngine(GQFastDatabase(pubmed, account_space=False, device="cpu"))
    q, param = {"AS": (SG.QUERY_AS, "a0"), "AS_RECENT": (SG.QUERY_AS_RECENT, "a0"),
                "FSD": (SG.QUERY_FSD, "d0")}[name]
    pq = eng.prepare(q)
    rng = np.random.default_rng(len(name))
    for B in (5, 8):
        ids = rng.integers(0, 400, B)
        got = pq.execute_batch(**{param: ids})
        assert got.shape == (B, pq.phys.out_dom)
        for i in range(B):
            np.testing.assert_allclose(got[i], pq(**{param: int(ids[i])}), rtol=1e-4,
                                       atol=1e-4)
