"""The fused regions' per-CTA table, as far as the CPU sees it: the table
flags the fused dispatch (``ops.fragment_spmv_fused``,
``ops.fragment_spmm_fused``) hands the fused kernel wrappers from each hop's
hot share, the executor handing each HopOp's hot share to both fused entries
(single and batched), both fused entries on a graph with one hot destination
against the JAX package's fused entries (its Pallas kernels in interpret
mode), for every op × mask × binarize × packed/dense dst, and
``execute_batch`` rows under ``fusion="on"`` against their single calls on
Zipf-hot authors. The kernels themselves (the table in each hop phase, the
row-chunk scratch of the SpMM form) are held to the plain versions on the
card in ``tests/test_torch_cuda.py``. Sums within rtol = atol = 1e-4,
min/max/bool exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fragments import _pack_words as j_pack_words  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active, ops, params, ref  # noqa: E402
from repro_torch.kernels import fragment_spmv_fused as fkernel  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

OPS = ["sum", "min", "max", "bool"]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}
N_SRC, N_MID, N_DST, HOT = 600, 700, 500, 3
T = params.HOP_TABLE_HOT_SHARE
#: (two hops, mask, binarize): every region the fusion pass forms (a
#: degenerate region always carries its filter's mask)
VARIANTS = {"two_hop": (True, False, False), "two_hop_mask": (True, True, False),
            "two_hop_binarize": (True, False, True),
            "two_hop_mask_binarize": (True, True, True), "degenerate_mask": (False, True, False)}


def _assert_match(got, want, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


def _hot_hop(rng, n_src, n_dst, E, dst_packed):
    """One hop's operands (a dict of the FusedHopOperands fields) whose
    destination HOT takes 40% of the edges; 4-bit packed measures."""
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = rng.integers(0, n_dst, E)
    dst[rng.random(E) < 0.4] = HOT
    mint = rng.integers(0, 9, E)
    return dict(src_ids=src, dst=j_pack_words(dst, 10) if dst_packed else dst.astype(np.int32),
                measure=j_pack_words(mint, 4), n_dst=n_dst, dst_width=10 if dst_packed else 0,
                m_mode="packed", m_width=4, blocks=active.block_ranges(src))


def _hot_region(seed, dst_packed):
    """hop1 N_SRC → N_MID (2500 edges), hop2 N_MID → N_DST (2503 edges),
    both hot on HOT; a mid mask over N_MID that keeps HOT."""
    rng = np.random.default_rng(seed)
    a = _hot_hop(rng, N_SRC, N_MID, 2500, dst_packed)
    b = _hot_hop(rng, N_MID, N_DST, 2503, dst_packed)
    keep = (rng.random(N_MID) < 0.6).astype(np.float32)
    keep[HOT] = 1.0
    return a, b, keep


def _port_hop(h: dict, hot_share: float):
    """A hop's operands for the port: word streams as int32 tensors of the
    same bits."""
    words = {k: torch.from_numpy(h[k].view(np.int32)) for k in ("dst", "measure")
             if h[k].dtype == np.uint32}
    return ops.FusedHopOperands(**{**h, **words}, hot_share=hot_share)


def _frontier(op, seed, B=None):
    """A frontier over N_SRC (B rows of it) with a quarter at the identity."""
    rng = np.random.default_rng(seed)
    W = (rng.random((B or 1, N_SRC)) * 2).astype(np.float32)
    if op == "bool":
        W = (W > 1).astype(np.float32)
    W[rng.random(W.shape) < 0.25] = ZERO[op]
    return W if B else W[0]


@pytest.fixture
def kernel_spies(monkeypatch):
    """The four fused wrappers replaced by stand-ins that record their table
    flags and return the plain region; the list kernel's wrapper by the plain
    list; the kernel path taken for CPU tensors."""
    from repro_torch.kernels import block_list

    monkeypatch.setattr(block_list, "block_list", lambda w, zero, smin, smax, flags=False: (
        (*active.active_block_list(w, zero, smin, smax),
         active.active_flags(active.support_mask(w, zero), smin, smax)) if flags
        else active.active_block_list(w, zero, smin, smax)))
    seen = []
    for name in ("fragment_spmv_fused1", "fragment_spmm_fused1"):
        def spy1(w, s1, mm, bi1, na1, n_dst, op="sum", *, table, _name=name):
            seen.append((_name, table))
            return ref.fragment_spmv_fused_ref(w, s1, None, mm, n_dst, n_dst, op=op,
                                               lists=(bi1, na1, None, None))

        monkeypatch.setattr(fkernel, name, spy1)
    for name in ("fragment_spmv_fused2", "fragment_spmm_fused2"):
        def spy2(w, s1, s2, mm, bi1, na1, bi2, na2, n_mid, n_dst, op="sum",
                 mid_binarize=False, *, table1, table2, _name=name):
            seen.append((_name, (table1, table2)))
            return ref.fragment_spmv_fused_ref(w, s1, s2, mm, n_mid, n_dst, op=op,
                                               mid_binarize=mid_binarize,
                                               lists=(bi1, na1, bi2, na2))

        monkeypatch.setattr(fkernel, name, spy2)
    monkeypatch.setattr(ops, "_plain", lambda t, uk: not uk)
    return seen


@pytest.mark.parametrize("shares", [(0.5, 0.0), (0.0, 0.5), (T, T / 2), (T / 2, T),
                                    (0.0, 0.0), (1.0, 1.0)])
@pytest.mark.parametrize("skipping", ["off", "on"])
@pytest.mark.parametrize("batched", [False, True], ids=["spmv", "spmm"])
def test_fused_dispatch_passes_each_hops_choice_to_the_kernel_wrapper(kernel_spies, shares,
                                                                      skipping, batched):
    """With the kernel path taken, the fused wrapper the dispatch calls gets
    each hop's table flag from that hop's hot share, on both sides of
    HOP_TABLE_HOT_SHARE: fused2 ``table1`` / ``table2``, fused1 ``table``
    (its one hop's), in both forms; the result is the plain region's."""
    a, b, keep = _hot_region(1, True)
    h1, h2 = _port_hop(a, shares[0]), _port_hop(b, shares[1])
    W = torch.from_numpy(_frontier("sum", 2, 5 if batched else None))
    entry = ops.fragment_spmm_fused if batched else ops.fragment_spmv_fused
    form = "fragment_spmm_fused" if batched else "fragment_spmv_fused"
    flags = tuple(s >= T for s in shares)
    kw = dict(op="sum", fusion="on", block_skipping=skipping)
    got = entry(W, h1, h2, torch.from_numpy(keep), mid_binarize=True, **kw)
    want = entry(W, h1, h2, torch.from_numpy(keep), mid_binarize=True, use_kernel=False,
                 **kw)
    got1 = entry(W, h1, None, torch.from_numpy(keep), **kw)
    assert kernel_spies == [(form + "2", flags), (form + "1", flags[0])]
    assert got.shape == want.shape
    _assert_match(got.numpy(), want.numpy(), "sum")
    _assert_match(got1.numpy(), ops.fragment_spmv_fused(
        W, h1, None, torch.from_numpy(keep), use_kernel=False, **kw).numpy(), "sum")


@pytest.fixture(scope="module")
def pubmed():
    return SG.make_pubmed(n_docs=2500, n_terms=70, n_authors=500, seed=3)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "execute_batch"])
@pytest.mark.parametrize("encodings", ["dense", "auto"])
def test_executor_passes_each_hops_hot_share_to_the_fused_entry(pubmed, monkeypatch,
                                                                encodings, batched):
    """Every fused region (SD's and AS-recent's two-hop regions under 'on',
    SD-recent's degenerate one under 'auto') reaches the fused entry with the
    hot share of the index each of its hops streams, in a single call and
    through execute_batch."""
    db = GQFastDatabase(pubmed, account_space=False, device="cpu",
                        device_encodings=encodings)
    by_src = {id(di.src_ids): di.hot_share for di in db.device.indexes.values()}
    seen = []
    name = "fragment_spmm_fused" if batched else "fragment_spmv_fused"
    real = getattr(ops, name)

    def spy(w, hop1, hop2=None, *a, **k):
        for h in (hop1, hop2):
            if h is not None:
                seen.append((by_src.get(id(h.src_ids)), h.hot_share))
        return real(w, hop1, hop2, *a, **k)

    monkeypatch.setattr(ops, name, spy)
    eng = GQFastEngine(db)
    for q, param, fusion in ((SG.QUERY_SD, "d0", "on"), (SG.QUERY_AS_RECENT, "a0", "on"),
                             (SG.QUERY_SD_RECENT, "d0", "auto")):
        pq = eng.prepare(q, fusion=fusion)
        if batched:
            pq.execute_batch(**{param: np.arange(1, 4)})
        else:
            pq(**{param: 5})
    assert len(seen) == 7  # 2 + 2 · 2 + 1 hops in fused regions
    assert all(want is not None and got == want for want, got in seen)
    assert any(ops.uses_table(h) for _, h in seen)  # I_DT.Doc's, I_DA.Doc's hot ids
    assert any(not ops.uses_table(h) for _, h in seen)  # I_DT.Term's spread documents


@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("op", OPS)
def test_fused_entries_match_reference_on_a_hot_destination(op, variant, dst_packed):
    """Both fused entries, with each hop's index hot and not, against the
    JAX package's fused entries (Pallas in interpret mode) on a region whose
    hops send 40% of their edges to one destination: the single region for
    every op × mask × binarize × dst layout; the batched one (B = 3) row by
    row against the single entry for all of them, and against the JAX
    package's batched entry for every op at packed dst with the mask and the
    binarize, two-hop and degenerate (each configuration compiles once in
    interpret mode, about a second). On the CPU the hot share changes
    nothing."""
    two, with_mask, binz = VARIANTS[variant]
    a, b, keep = _hot_region(len(op) + len(variant), dst_packed)
    j1, j2 = jops.FusedHopOperands(**a), jops.FusedHopOperands(**b) if two else None
    mask = keep if with_mask else None
    kw = dict(op=op, mid_binarize=binz, fusion="on", block_skipping="on")
    w = _frontier(op, 7)
    want = np.asarray(jops.fragment_spmv_fused(w, j1, j2, mask, **kw))
    W = _frontier(op, 8, 3)
    single = {}
    for share in (1.0, 0.0):
        h1, h2 = _port_hop(a, share), _port_hop(b, share) if two else None
        single[share] = ops.fragment_spmv_fused(torch.from_numpy(w), h1, h2, mask, **kw)
        _assert_match(single[share].numpy(), want, op)
        rows = ops.fragment_spmm_fused(torch.from_numpy(W), h1, h2, mask, **kw)
        for r in range(3):
            _assert_match(rows[r].numpy(), ops.fragment_spmv_fused(
                torch.from_numpy(W[r]), h1, h2, mask, **kw).numpy(), op)
    assert torch.equal(single[1.0], single[0.0])
    assert single[1.0][HOT] != ZERO[op]  # the mask keeps the hot id
    if dst_packed and variant in ("two_hop_mask_binarize", "degenerate_mask"):
        _assert_match(rows.numpy(), np.asarray(jops.fragment_spmm_fused(W, j1, j2, mask, **kw)),
                      op)


@pytest.mark.parametrize("threshold", [0.0, float("inf")], ids=["table_everywhere",
                                                                  "table_nowhere"])
@pytest.mark.parametrize("name", ["AS", "AS_RECENT", "SD_RECENT"])
def test_execute_batch_rows_under_fusion_on_equal_single_calls(pubmed, monkeypatch, name,
                                                               threshold):
    """execute_batch's rows (B = 5, padded to 8, and 8) under fusion="on"
    against their single calls within 1e-4 on queries whose fused regions
    reach the Zipf-hot authors and documents, with the table chosen for
    every index and for none."""
    monkeypatch.setattr(params, "HOP_TABLE_HOT_SHARE", threshold)
    eng = GQFastEngine(GQFastDatabase(pubmed, account_space=False, device="cpu"))
    q, param = {"AS": (SG.QUERY_AS, "a0"), "AS_RECENT": (SG.QUERY_AS_RECENT, "a0"),
                "SD_RECENT": (SG.QUERY_SD_RECENT, "d0")}[name]
    pq = eng.prepare(q, fusion="on")
    rng = np.random.default_rng(len(name))
    for B in (5, 8):
        ids = rng.integers(0, 400, B)
        got = pq.execute_batch(**{param: ids})
        assert got.shape == (B, pq.phys.out_dom)
        for i in range(B):
            np.testing.assert_allclose(got[i], pq(**{param: int(ids[i])}), rtol=1e-4,
                                       atol=1e-4)


def test_masks_reach_the_kernels_as_bytes_converted_once_a_tensor():
    """The fused wrappers' mask: a float32 mask becomes one byte an entry
    (mask > 0) once a tensor, and again after an in-place change; another
    dtype or length raises."""
    dev = torch.device("cpu")
    m = torch.tensor([0.0, 1.0, -2.0, 0.5])
    k = fkernel._keep(m, 4, dev)
    assert k.dtype == torch.uint8 and k.tolist() == [0, 1, 0, 1]
    assert fkernel._keep(m, 4, dev) is k
    m[0] = 3.0
    k2 = fkernel._keep(m, 4, dev)
    assert k2 is not k and k2.tolist() == [1, 1, 0, 1]
    assert fkernel._keep(None, 4, dev) is None
    for other in (m.double(), k, k.bool()):
        with pytest.raises(TypeError):
            fkernel._keep(other, 4, dev)
    with pytest.raises(ValueError):
        fkernel._keep(m, 5, dev)
