"""The block list built in one launch, and the dense hop pair with its per-index
table, as far as the CPU sees them.

  * ``ops.active_block_list`` (on the CPU: the plain version, the kernel's
    yardstick on the card) against the JAX package's
    ``repro.kernels.active.active_block_list`` and ``active_flags`` for single
    and ``[B, n_src]`` frontiers, every op's identity, empty, full, one-seed
    and random supports, and indexes of 1, 2 and a number of blocks that is
    not a power of two: the integer lists are equal, not close;
  * the dispatch reaches the list kernel's wrapper for every unfused single
    and batched hop and for a fused region's hop 1 (with the flags hop 2
    needs), and the dense hop's wrapper gets ``table`` from the hot share;
  * ``ops.fragment_spmv`` at hot shares on both sides of
    ``HOP_TABLE_HOT_SHARE`` against the JAX package's ``fragment_spmv`` /
    ``fragment_spmv_active`` (Pallas in interpret mode);
  * the executor hands each dense hop its index's hot share.

The kernels themselves are held to the plain versions on the card in
``tests/test_torch_cuda.py``. Sums within rtol = atol = 1e-4 (the two packages
add in another order), min/max/bool and every list exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import active as jactive  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active, ops, params, ref  # noqa: E402
from repro_torch.kernels import block_list as lkernel  # noqa: E402
from repro_torch.kernels import fragment_spmm as mkernel  # noqa: E402
from repro_torch.kernels import fragment_spmv as kernel  # noqa: E402
from repro_torch.kernels import fragment_spmv_fused as fkernel  # noqa: E402
from repro_torch.kernels import fragment_spmv_packed as pkernel  # noqa: E402
from repro_torch.kernels.params import EDGE_BLOCK  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

OPS = ["sum", "min", "max", "bool"]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}
SUPPORTS = ["empty", "full", "one_seed", "random"]
N_SRC = 3000


def _index(nb: int, seed: int):
    """Sorted sources of an ``nb``-block index over N_SRC sources (the last
    block partial), and its block ranges."""
    rng = np.random.default_rng(seed)
    E = (nb - 1) * EDGE_BLOCK + 100
    src = np.sort(rng.integers(0, N_SRC, E)).astype(np.int32)
    return src, active.block_ranges(src)


def _support(kind: str, rng) -> np.ndarray:
    if kind == "empty":
        return np.zeros(N_SRC, bool)
    if kind == "full":
        return np.ones(N_SRC, bool)
    if kind == "one_seed":
        s = np.zeros(N_SRC, bool)
        s[rng.integers(0, N_SRC)] = True
        return s
    return rng.random(N_SRC) < 0.003


def _frontier(kind: str, op: str, rows, seed: int) -> np.ndarray:
    """A frontier whose support is ``kind``: ``rows`` None for ``[n_src]``,
    else that many rows, each with a support of its own."""
    rng = np.random.default_rng(seed)
    shape = (N_SRC,) if rows is None else (rows, N_SRC)
    w = np.full(shape, ZERO[op], np.float32)
    vals = (rng.random(shape) * 2 + 0.1).astype(np.float32)
    if op == "bool":
        vals[:] = 1.0
    sup = _support(kind, rng) if rows is None else np.stack(
        [_support(kind, rng) for _ in range(rows)])
    w[sup] = vals[sup]
    return w


@pytest.mark.parametrize("nb", [1, 2, 7, 37])
@pytest.mark.parametrize("support", SUPPORTS)
@pytest.mark.parametrize("rows", [None, 3], ids=["single", "B3"])
@pytest.mark.parametrize("op", OPS)
def test_list_equals_jax(op, rows, support, nb):
    src, (smin, smax) = _index(nb, nb)
    w = _frontier(support, op, rows, nb + len(op) + len(support))
    bi, na, fl = ops.active_block_list(torch.from_numpy(w), ZERO[op], torch.from_numpy(smin),
                                       torch.from_numpy(smax), flags=True)
    jbi, jna = jactive.active_block_list(jnp.asarray(w), ZERO[op], jnp.asarray(smin),
                                         jnp.asarray(smax))
    jfl = jactive.active_flags(jactive.support_mask(jnp.asarray(w), ZERO[op]),
                               jnp.asarray(smin), jnp.asarray(smax))
    assert bi.dtype == na.dtype == torch.int32 and bi.shape == (nb,) and na.shape == (1,)
    assert fl.dtype == torch.bool
    np.testing.assert_array_equal(bi.numpy(), np.asarray(jbi))
    np.testing.assert_array_equal(na.numpy(), np.asarray(jna))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jfl))
    want_n = {"empty": 0, "full": nb}.get(support)
    if want_n is not None:
        assert int(na[0]) == want_n
    # without flags: the same list
    bi2, na2 = ops.active_block_list(torch.from_numpy(w), ZERO[op], torch.from_numpy(smin),
                                     torch.from_numpy(smax))
    assert torch.equal(bi, bi2) and torch.equal(na, na2)


def test_list_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the dispatch takes the plain version; the kernel's wrapper
    itself takes only CUDA tensors."""
    _, (smin, smax) = _index(3, 0)
    with pytest.raises(ValueError, match="CUDA"):
        lkernel.block_list(torch.ones(N_SRC), 0.0, torch.from_numpy(smin),
                           torch.from_numpy(smax))


# ---------------------------------------------------------------------------
# the dispatch: which wrappers a kernel path reaches
# ---------------------------------------------------------------------------


def _spy_list(monkeypatch, seen):
    """The list kernel's wrapper replaced by the plain list, recording calls."""
    def spy(w, zero, smin, smax, flags=False):
        seen.append(("list", tuple(w.shape), flags))
        f = active.active_flags(active.support_mask(w, zero), smin, smax)
        bi, na = active.compact_blocks(f)
        return (bi, na, f) if flags else (bi, na)

    monkeypatch.setattr(lkernel, "block_list", spy)


def _spy_hops(monkeypatch, seen):
    """Every hop wrapper the unfused and fused paths reach replaced by its
    plain version, recording (name, table)."""
    def spy(name, plain):
        def fn(*a, table=None, **k):
            seen.append((name, table))
            return plain(*a, **k)
        return fn

    monkeypatch.setattr(kernel, "fragment_spmv", spy("spmv", ref.fragment_spmv_ref))
    monkeypatch.setattr(kernel, "fragment_spmv_active",
                        spy("spmv_active", ref.fragment_spmv_active_ref))
    monkeypatch.setattr(pkernel, "fragment_spmv_packed",
                        spy("packed", ref.fragment_spmv_packed_ref))
    monkeypatch.setattr(pkernel, "fragment_spmv_packed_active",
                        spy("packed_active", ref.fragment_spmv_packed_active_ref))
    monkeypatch.setattr(mkernel, "fragment_spmm_active",
                        spy("spmm_active", ref.fragment_spmm_active_ref))

    def fused1(w, s1, mm, bi1, na1, n_dst, op="sum", *, table):
        seen.append(("fused1", table))
        return ref.fragment_spmv_fused_ref(w, s1, None, mm, n_dst, n_dst, op=op,
                                           lists=(bi1, na1, None, None))

    def fused2(w, s1, s2, mm, bi1, na1, bi2, na2, n_mid, n_dst, op="sum",
               mid_binarize=False, *, table1, table2):
        seen.append(("fused2", (table1, table2)))
        return ref.fragment_spmv_fused_ref(w, s1, s2, mm, n_mid, n_dst, op=op,
                                           mid_binarize=mid_binarize,
                                           lists=(bi1, na1, bi2, na2))

    monkeypatch.setattr(fkernel, "fragment_spmv_fused1", fused1)
    monkeypatch.setattr(fkernel, "fragment_spmv_fused2", fused2)
    monkeypatch.setattr(ops, "_plain", lambda t, uk: not uk)


def _hop_inputs(nb: int, seed: int, n_dst: int = 50):
    rng = np.random.default_rng(seed)
    src, blocks = _index(nb, seed)
    dst = np.minimum(rng.zipf(1.5, src.shape[0]) - 1, n_dst - 1).astype(np.int32)
    m = (rng.random(src.shape[0]) + 0.5).astype(np.float32)
    t = torch.from_numpy
    return t(src), t(dst), t(m), tuple(t(b) for b in blocks), n_dst


@pytest.mark.parametrize("skipping", ["on", "auto"])
def test_every_unfused_hop_takes_the_list_kernel(monkeypatch, skipping):
    """With the kernel path taken, the dense and packed single hops and the
    batched hop build their list through the list kernel's wrapper, once a
    hop, and get the plain version's answer; skipping off builds none."""
    seen = []
    _spy_list(monkeypatch, seen)
    _spy_hops(monkeypatch, seen)
    src, dst, m, blocks, n_dst = _hop_inputs(5, 11)
    w = torch.from_numpy(_frontier("random", "sum", None, 3))
    want = ref.fragment_spmv_ref(w, src, dst, m, n_dst)
    got = ops.fragment_spmv(w, src, dst, m, n_dst, blocks=blocks, block_skipping=skipping)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    got = ops.fragment_spmv_packed(w, src, dst, m, n_dst=n_dst, m_mode="dense",
                                   blocks=blocks, block_skipping=skipping)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    W = torch.from_numpy(_frontier("random", "sum", 3, 4))
    got = ops.fragment_spmm(W, src, dst, m, n_dst, blocks=blocks, block_skipping=skipping)
    torch.testing.assert_close(got, ref.fragment_spmm_ref(W, src, dst, m, n_dst), rtol=1e-4,
                               atol=1e-4)
    assert [s for s in seen if s[0] == "list"] == [
        ("list", (N_SRC,), False), ("list", (N_SRC,), False), ("list", (3, N_SRC), False)]
    assert [s[0] for s in seen if s[0] != "list"] == ["spmv_active", "packed_active",
                                                      "spmm_active"]
    seen.clear()
    ops.fragment_spmv(w, src, dst, m, n_dst, blocks=blocks, block_skipping="off")
    assert seen == [("spmv", False)]


def test_fused_hop1_takes_the_list_kernel_with_flags(monkeypatch):
    """A two-hop region's hop 1 list comes from the list kernel, which also
    gives the flags hop 2's list is derived from through the reach matrix;
    the degenerate region asks for no flags. Both get the plain answer."""
    seen = []
    _spy_list(monkeypatch, seen)
    _spy_hops(monkeypatch, seen)
    src, dst, m, blocks, _ = _hop_inputs(4, 12, n_dst=N_SRC)
    src2, dst2, m2, blocks2, n_dst = _hop_inputs(3, 13)
    nb1, nb2 = blocks[0].shape[0], blocks2[0].shape[0]
    reach = torch.ones(nb1, nb2, dtype=torch.bool)
    h1 = ops.FusedHopOperands(src, dst, m, n_dst=N_SRC, m_mode="dense", blocks=blocks,
                              hot_share=0.0)
    h2 = ops.FusedHopOperands(src2, dst2, m2, n_dst=n_dst, m_mode="dense", blocks=blocks2,
                              reach=reach, hot_share=0.0)
    w = torch.from_numpy(_frontier("random", "sum", None, 5))
    got = ops.fragment_spmv_fused(w, h1, h2, fusion="on", block_skipping="auto")
    want = ref.fragment_spmv_ref(ref.fragment_spmv_ref(w, src, dst, m, N_SRC), src2, dst2,
                                 m2, n_dst)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert seen == [("list", (N_SRC,), True), ("fused2", (False, False))]
    seen.clear()
    got = ops.fragment_spmv_fused(w, h1, None, fusion="on", block_skipping="auto")
    torch.testing.assert_close(got, ref.fragment_spmv_ref(w, src, dst, m, N_SRC), rtol=1e-4,
                               atol=1e-4)
    assert seen == [("list", (N_SRC,), False), ("fused1", False)]


@pytest.mark.parametrize("hot_share,table", [(0.5, True), (0.0, False),
                                             (params.HOP_TABLE_HOT_SHARE, True),
                                             (params.HOP_TABLE_HOT_SHARE / 2, False)])
@pytest.mark.parametrize("skipping", ["off", "on"])
def test_dense_dispatch_passes_the_table_choice(monkeypatch, hot_share, table, skipping):
    seen = []
    _spy_list(monkeypatch, seen)
    _spy_hops(monkeypatch, seen)
    src, dst, m, blocks, n_dst = _hop_inputs(3, 14)
    w = torch.from_numpy(_frontier("full", "max", None, 6))
    got = ops.fragment_spmv(w, src, dst, m, n_dst, op="max", blocks=blocks,
                            block_skipping=skipping, hot_share=hot_share)
    assert torch.equal(got, ref.fragment_spmv_ref(w, src, dst, m, n_dst, op="max"))
    assert [s for s in seen if s[0] != "list"] == [
        ("spmv" if skipping == "off" else "spmv_active", table)]


# ---------------------------------------------------------------------------
# the dense entry against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skipping", ["off", "on"])
@pytest.mark.parametrize("E", [4097, 20_000])
@pytest.mark.parametrize("op", OPS)
def test_dense_entry_matches_jax_at_any_hot_share(op, E, skipping):
    """Zipf-hot destinations, a frontier over part of the sources; the port's
    dense entry with the hot share on either side of the threshold against
    the JAX package's dense hop (Pallas in interpret mode); on the CPU the
    hot share changes nothing."""
    rng = np.random.default_rng(E + len(op))
    n_src, n_dst = 700, 60
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = np.minimum(rng.zipf(1.4, E) - 1, n_dst - 1).astype(np.int32)
    m = (rng.random(E) * 3).astype(np.float32)
    m[rng.random(E) < 0.1] = 0.0
    w = (rng.random(n_src) * 2).astype(np.float32)
    if op == "bool":
        w = (w > 1).astype(np.float32)
    w[rng.random(n_src) < 0.6] = ZERO[op]
    blocks = active.block_ranges(src)
    kw = dict(op=op, blocks=blocks, block_skipping=skipping)
    want = np.asarray(jops.fragment_spmv(w, src, dst, m, n_dst, **kw))
    outs = [ops.fragment_spmv(w, src, dst, m, n_dst, hot_share=h, **kw)
            for h in (0.0, params.HOP_TABLE_HOT_SHARE / 2, params.HOP_TABLE_HOT_SHARE, 1.0)]
    for got in outs[1:]:
        assert torch.equal(got, outs[0])
    got = outs[0].numpy()
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_db():
    schema = SG.make_pubmed(n_docs=3000, n_terms=80, n_authors=600, seed=2)
    return GQFastDatabase(schema, account_space=False, device="cpu",
                          device_encodings="dense")


@pytest.mark.parametrize("skipping", ["off", "auto"])
def test_executor_passes_hot_share_to_the_dense_hop(monkeypatch, dense_db, skipping):
    """Under dense storage every HopOp reaches the dense wrapper with the
    table its index's hot share chooses (AS: I_DA.Doc hot, I_DA.Author
    not), and under 'auto' each skipping hop builds its list through the
    list kernel's wrapper; the answer is the plain one."""
    eng = GQFastEngine(dense_db)
    pq = eng.prepare(SG.QUERY_AS, block_skipping=skipping, fusion="off")
    want = pq(a0=7)
    hops = [op for op in pq.phys.ops if type(op).__name__ == "HopOp"]
    seen = []
    _spy_list(monkeypatch, seen)
    _spy_hops(monkeypatch, seen)
    got = pq(a0=7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    tables = [s[1] for s in seen if s[0] != "list"]
    assert tables == [ops.uses_table(op.hot_share) for op in hops]
    assert True in tables and False in tables
    n_lists = sum(1 for s in seen if s[0] == "list")
    assert n_lists == (0 if skipping == "off" else
                       sum(1 for op in hops if active.n_edge_blocks(op.src_ids.shape[0]) > 1))
