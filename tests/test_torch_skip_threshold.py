"""block_skipping="auto" on an index too small for the block list to pay
(``params.SKIP_MIN_BLOCKS``), and the kernel wrappers' launch path, in the
PyTorch port on the CPU.

  * ``ops._plan_skip`` under 'auto' scans (``None``) below the threshold and
    builds the list at or above it; 'on' lists at every size, 'off' never;
    a fused region's hop-1 list follows the same rule;
  * the nine queries under the defaults (skipping 'auto', the threshold as
    shipped: every index of these small graphs lies below it) match the JAX
    engine (its defaults; Pallas in interpret mode) and the numpy oracle
    ``run_sql``: counts, min, max and exists exactly, sums within
    rtol=atol=1e-4 (tests/test_system.py);
  * the wrappers' checks raise the messages they raised before the launch
    path was made lean (what a CPU can reach of them: a CUDA tensor is what
    the kernels take).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active, ops, params  # noqa: E402
from repro_torch.kernels import bitmap_ops as bm  # noqa: E402
from repro_torch.kernels import bitunpack as bu  # noqa: E402
from repro_torch.kernels import block_list as lk  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels import fragment_spmm as dm  # noqa: E402
from repro_torch.kernels import fragment_spmm_packed as pm  # noqa: E402
from repro_torch.kernels import fragment_spmv as dk  # noqa: E402
from repro_torch.kernels import fragment_spmv_fused as fk  # noqa: E402
from repro_torch.kernels import fragment_spmv_packed as pk  # noqa: E402
from repro_torch.kernels.params import EDGE_BLOCK  # noqa: E402
from repro_torch.kernels.ref import HopStreams  # noqa: E402

K = params.SKIP_MIN_BLOCKS
N_SRC = 512


@functools.lru_cache(maxsize=None)
def _index(nb: int):
    """An index of exactly ``nb`` EDGE_BLOCK-edge blocks over N_SRC sorted
    sources, its block metadata, and a frontier with one live source."""
    rng = np.random.default_rng(nb)
    E = (nb - 1) * EDGE_BLOCK + 1
    src = torch.from_numpy(np.sort(rng.integers(0, N_SRC, E)).astype(np.int32))
    w = torch.zeros(N_SRC)
    w[int(src[E // 2])] = 1.0
    blocks = tuple(torch.from_numpy(b) for b in active.block_ranges(src.numpy()))
    return E, src, w, blocks


def test_threshold_is_more_than_one_block():
    assert isinstance(K, int) and K > 1


@pytest.mark.parametrize("nb", sorted({1, 2, K - 1, K, K + 1} - {0}))
def test_plan_skip_lists_from_the_threshold_up_under_auto(nb):
    E, src, w, blocks = _index(nb)
    assert active.n_edge_blocks(E) == nb
    auto = ops._plan_skip(w, "sum", E, blocks, "auto")
    if nb < K or nb == 1:
        assert auto is None
    else:
        bi, na, scan_above = auto
        assert bi.shape == (nb,) and int(na[0]) >= 1 and scan_above >= 1
    on = ops._plan_skip(w, "sum", E, blocks, "on")
    assert on is not None and on[0].shape == (nb,) and on[2] == nb
    assert ops._plan_skip(w, "sum", E, blocks, "off") is None
    assert ops._plan_skip(w, "sum", E, None, "on") is None


@pytest.mark.parametrize("mode", ["auto", "on"])
@pytest.mark.parametrize("nb", sorted({2, K - 1, K} - {0, 1}))
def test_hop_below_and_above_the_threshold_equals_the_scan(nb, mode):
    E, src, w, blocks = _index(nb)
    rng = np.random.default_rng(7)
    dst = torch.from_numpy(rng.integers(0, 300, E).astype(np.int32))
    m = torch.from_numpy(rng.random(E).astype(np.float32))
    want = ops.fragment_spmv(w, src, dst, m, 300, blocks=blocks, block_skipping="off")
    got = ops.fragment_spmv(w, src, dst, m, 300, blocks=blocks, block_skipping=mode)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    assert (want != 0).any(), "degenerate test: empty result"


@pytest.mark.parametrize("nb", sorted({2, K - 1, K} - {0, 1}))
def test_fused_hop1_list_follows_the_threshold(nb):
    E, src, w, blocks = _index(nb)
    dst = torch.zeros(E, dtype=torch.int32)
    h1 = ops.FusedHopOperands(src, dst, n_dst=1, blocks=blocks, hot_share=1.0)
    bi, na, _, _ = ops._fused_block_lists(w, "sum", h1, None, E, 0, "auto")
    if nb < K:  # the full list: every block in order
        assert torch.equal(bi, torch.arange(nb, dtype=torch.int32)) and int(na[0]) == nb
    else:
        assert int(na[0]) < nb
    bi, na, _, _ = ops._fused_block_lists(w, "sum", h1, None, E, 0, "on")
    assert int(na[0]) < nb


PUBMED_KW = dict(n_docs=1500, n_terms=80, n_authors=400, seed=3)
SEMMED_KW = dict(n_concepts=400, n_csemtypes=500, n_predications=800, n_sentences=3000)
NINE = [
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
EXACT = ("SD", "AD", "RECENT", "CS", "SD_RECENT")


@pytest.fixture(scope="module")
def engines():
    out = {}
    for kind, make, kw in (("pubmed", "make_pubmed", PUBMED_KW),
                           ("semmed", "make_semmeddb", SEMMED_KW)):
        pschema, jschema = getattr(SG, make)(**kw), getattr(JSG, make)(**kw)
        out[kind] = (pschema,
                     GQFastEngine(GQFastDatabase(pschema, account_space=False, device="cpu")),
                     JEngine(JDatabase(jschema, account_space=False)))
    return out


@pytest.mark.parametrize("name,q,prm", NINE, ids=[c[0] for c in NINE])
def test_nine_queries_under_auto_match_jax_and_oracle(engines, name, q, prm):
    schema, port, jax_ = engines["semmed" if name == "CS" else "pubmed"]
    for di in port.db.device.indexes.values():  # every hop scans under 'auto'
        assert active.n_edge_blocks(int(di.src_ids.shape[0])) < K
    pq = port.prepare(q)
    assert pq.block_skipping == "auto"
    got = pq(**prm)
    jgot = np.asarray(jax_.prepare(q)(**prm))
    want = run_sql(schema, q, prm)
    assert got.shape == jgot.shape == want.shape and got.dtype == np.float32
    if name in EXACT:
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_array_equal(got, want.astype(np.float32))
    else:
        np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got != 0).any(), "degenerate test: empty result"


# ---------------------------------------------------------------------------
# the wrappers' messages
# ---------------------------------------------------------------------------

_I = torch.zeros(4, dtype=torch.int32)
_F = torch.zeros(4)
_S = HopStreams(_I, _I, None, None, 0, "none", 0)
WRAPPERS = {
    "bitmap_and": lambda: bm.bitmap_and(_I, _I),
    "bitmap_and_popcount": lambda: bm.bitmap_and_popcount(_I, _I),
    "bitunpack": lambda: bu.bitunpack(_I, 4, 4),
    "block_list": lambda: lk.block_list(_F, 0.0, _I, _I),
    "fragment_spmv": lambda: dk.fragment_spmv(_F, _I, _I, None, 4),
    "fragment_spmv_active": lambda: dk.fragment_spmv_active(_F, _I, _I, None, _I, _I[:1], 4),
    "fragment_spmv_packed": lambda: pk.fragment_spmv_packed(_F, _I, _I, None, None, 4),
    "fragment_spmv_packed_active": lambda: pk.fragment_spmv_packed_active(
        _F, _I, _I, None, None, _I, _I[:1], 4),
    "fragment_spmm": lambda: dm.fragment_spmm(_F[None], _I, _I, None, 4),
    "fragment_spmm_active": lambda: dm.fragment_spmm_active(_F[None], _I, _I, None, _I,
                                                            _I[:1], 4),
    "fragment_spmm_packed": lambda: pm.fragment_spmm_packed(_F[None], _I, _I, None, None, 4),
    "fragment_spmm_packed_active": lambda: pm.fragment_spmm_packed_active(
        _F[None], _I, _I, None, None, _I, _I[:1], 4),
    "fragment_spmv_fused1": lambda: fk.fragment_spmv_fused1(_F, _S, None, _I, _I[:1], 4),
    "fragment_spmv_fused2": lambda: fk.fragment_spmv_fused2(_F, _S, _S, None, _I, _I[:1], _I,
                                                            _I[:1], 4, 4),
    "fragment_spmm_fused1": lambda: fk.fragment_spmm_fused1(_F[None], _S, None, _I, _I[:1], 4),
    "fragment_spmm_fused2": lambda: fk.fragment_spmm_fused2(_F[None], _S, _S, None, _I, _I[:1],
                                                            _I, _I[:1], 4, 4),
}


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_every_wrapper_refuses_cpu_tensors_with_its_message(kernel):
    with pytest.raises(ValueError) as e:
        WRAPPERS[kernel]()
    assert str(e.value) == f"{kernel}'s CUDA kernel needs CUDA tensors, got cpu"


META = torch.device("meta")


@pytest.mark.parametrize("t,dtype,device,ndim,exc,msg", [
    ([1, 2], torch.int32, META, 1, TypeError, "x must be a torch.Tensor, got list"),
    (_I, torch.int32, META, 1, ValueError, "x is on cpu, expected meta"),
    (_I, torch.float32, torch.device("cpu"), 1, TypeError,
     "x must be torch.float32, got torch.int32"),
    (_I, torch.int32, torch.device("cpu"), 2, ValueError, "x must be 2-D, got shape (4,)"),
    (torch.zeros(4, 2, dtype=torch.int32).t(), torch.int32, torch.device("cpu"), 2, ValueError,
     "x must be contiguous (materialise broadcasts first)"),
])
def test_check_tensor_messages(t, dtype, device, ndim, exc, msg):
    with pytest.raises(exc) as e:
        cuda_build.check_tensor(t, "x", dtype, device, ndim=ndim)
    assert str(e.value) == msg
    cuda_build.check_tensor(_I, "x", torch.int32, torch.device("cpu"))  # a good one passes


def test_launch_error_and_bitmap_messages():
    with pytest.raises(RuntimeError) as e:
        cuda_build.raise_on(700, "bitmap_and")
    assert str(e.value) == "bitmap_and kernel launch failed: CUDA error 700"
    cuda_build.raise_on(0, "bitmap_and")
    with pytest.raises(ValueError) as e:
        bm.check_pair(_I, _I[:3])
    assert str(e.value) == "bitmaps differ in length: 4 and 3 words"
    with pytest.raises(ValueError) as e:
        bm.check_popcount_words(bm.MAX_POPCOUNT_WORDS + 1)
    assert str(e.value) == (f"{2**26} words can hold more than 2^31 - 1 set bits, past an int32"
                            f" count; at most {2**26 - 1} words")
