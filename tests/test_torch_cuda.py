"""Tests that need an NVIDIA GPU: the hand-written CUDA kernels (the dense
and packed hops, their block-skipping variants, the packed pair's per-CTA
aggregation on hot destinations, bitunpack, both fused-region kernels with
the per-CTA table in their hops and without, the batched forms of all of
them: the SpMM kernels and the fused regions' SpMM form, the bitmap AND
and popcount, and CRC-32C) against their plain PyTorch versions, and the
engine on the card (single queries and execute_batch, the degradation
ladder's rungs, manifests, snapshots and the scrubber's heal, the analytics
server's obs lane and a reload while the scrubber ticks, the distributed
strategy under a 1-rank NCCL mesh, the transformer family, the GNN family and
DIN) against the engine or model on the CPU, the plain versions, the numpy
oracle and the same requests served alone. They import no JAX (the
GPU machine need not have it) and skip where ``torch.cuda.is_available()`` is
false: a CUDA kernel has no CPU mode. On a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

sum within rtol=atol=1e-4 (atomics reorder the float adds); min, max and bool
exact.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.fragments import _pack_words  # noqa: E402
from repro_torch.core.lower import FusedHopOp, HopOp  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active  # noqa: E402
from repro_torch.kernels import bitmap_ops as bmkernel  # noqa: E402
from repro_torch.kernels import bitunpack as bkernel  # noqa: E402
from repro_torch.kernels import crc32c as ckernel  # noqa: E402
from repro_torch.kernels import fragment_spmv as kernel  # noqa: E402
from repro_torch.kernels import fragment_spmv_fused as fkernel  # noqa: E402
from repro_torch.kernels import fragment_spmv_packed as pkernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

pytestmark = pytest.mark.cuda

OPS = ["sum", "min", "max", "bool"]
SHAPES = [(100, 80, 500), (1000, 1000, 10000), (17, 5, 3), (4096, 4096, 4096),
          (10, 7, 0), (1, 1, 1), (5000, 300, 4097)]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n_src, n_dst, E, op, seed, device):
    """Random hop inputs with identity entries in the frontier and zero
    measures, so the ∞·0 guard and the skipped-identity paths run."""
    rng = np.random.default_rng(seed)
    w = rng.random(n_src).astype(np.float32)
    if op == "bool":
        w = (w > 0.5).astype(np.float32)
    w[rng.random(n_src) < 0.25] = ZERO[op]
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = rng.integers(0, n_dst, E).astype(np.int32)
    m = rng.random(E).astype(np.float32)
    m[rng.random(E) < 0.1] = 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (w, src, dst, m))


def _assert_match(got, want, op):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == torch.float32
    if op == "sum":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n_src,n_dst,E", SHAPES, ids=[f"{a}x{b}x{c}" for a, b, c in SHAPES])
@pytest.mark.parametrize("with_measure", [True, False], ids=["m", "no_m"])
def test_kernel_matches_plain(cuda, n_src, n_dst, E, op, with_measure):
    w, src, dst, m = _inputs(n_src, n_dst, E, op, E + n_src, cuda)
    if not with_measure:
        m = None
    before = kernel.LAUNCHES
    got = kernel.fragment_spmv(w, src, dst, m, n_dst, op=op)
    want = ref.fragment_spmv_ref(w, src, dst, m, n_dst, op=op)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + (1 if E else 0)  # E == 0 never launches
    _assert_match(got, want, op)


@pytest.mark.parametrize("op", OPS)
def test_identity_frontier_stays_identity(cuda, op):
    _, src, dst, _ = _inputs(64, 48, 700, op, 7, cuda)
    w = torch.full((64,), ZERO[op], device=cuda)
    m = torch.zeros(700, device=cuda)
    got = kernel.fragment_spmv(w, src, dst, m, 48, op=op)
    assert torch.equal(got.cpu(), torch.full((48,), ZERO[op]))


def test_negative_zero_against_the_max_identity(cuda):
    """-0.0 has its sign bit set: the max atomic must take it over −∞."""
    w = torch.tensor([-1.0], device=cuda)
    src = torch.zeros(2, dtype=torch.int32, device=cuda)
    dst = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    m = torch.tensor([0.0, 2.0], device=cuda)  # products -0.0 and -2.0
    got = kernel.fragment_spmv(w, src, dst, m, 2, op="max").cpu()
    assert got[0] == 0.0 and got[1] == -2.0
    got = kernel.fragment_spmv(w, src, dst, m, 2, op="min").cpu()
    assert got[0] == 0.0 and got[1] == -2.0


def test_wrapper_rejects_bad_inputs(cuda):
    w, src, dst, m = _inputs(50, 40, 300, "sum", 3, cuda)
    with pytest.raises(TypeError):
        kernel.fragment_spmv(w, src.long(), dst, m, 40)
    with pytest.raises(ValueError):
        kernel.fragment_spmv(w, src, dst[:-1], m, 40)
    with pytest.raises(ValueError):
        kernel.fragment_spmv(w, src, dst, torch.stack([m, m], 1)[:, 0], 40)
    with pytest.raises(ValueError):
        kernel.fragment_spmv(w, src.cpu(), dst, m, 40)


def test_dispatch_launches_the_kernel_on_cuda(cuda):
    w, src, dst, m = _inputs(80, 60, 900, "max", 9, cuda)
    before = kernel.LAUNCHES
    got = ops.fragment_spmv(w, src, dst, m, 60, op="max")
    plain = ops.fragment_spmv(w, src, dst, m, 60, op="max", use_kernel=False)
    assert kernel.LAUNCHES == before + 1
    assert torch.equal(got, plain)


CASES = [
    ("SD", SG.QUERY_SD, {"d0": 5}),
    ("FSD", SG.QUERY_FSD, {"d0": 5}),
    ("AS", SG.QUERY_AS, {"a0": 7}),
    ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
    ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
    ("CS", SG.QUERY_CS, {"c0": 11}),
]


def _launches(phys) -> tuple[int, int, int]:
    """(HopOps outside fused regions, degenerate regions, two-hop regions)
    one execution runs, mask sub-programs included: the hop-kernel and the
    two fused kernels' launches."""
    n = [0, 0, 0]
    for op in phys.ops:
        if isinstance(op, HopOp):
            n[0] += 1
        elif isinstance(op, FusedHopOp):
            n[len(op.hops)] += 1
        for p in getattr(op, "programs", ()):
            n = [a + b for a, b in zip(n, _launches(p))]
    return tuple(n)


def _fused_counts():
    return fkernel.FUSED1_LAUNCHES, fkernel.FUSED2_LAUNCHES


@pytest.mark.parametrize("name,q,params", CASES, ids=[c[0] for c in CASES])
def test_engine_on_the_card_matches_cpu_and_oracle(cuda, name, q, params):
    if name == "CS":
        schema = SG.make_semmeddb(400, 500, 800, 3000)
    else:
        schema = SG.make_pubmed(n_docs=2000, n_terms=100, n_authors=500, seed=3)
    gpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device=cuda,
                                      device_encodings="dense"))
    cpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu",
                                      device_encodings="dense"))
    before, fbefore = kernel.LAUNCHES, _fused_counts()
    pq = gpu.prepare(q, block_skipping="off")
    got = pq(**params)
    hops, f1, f2 = _launches(pq.phys)
    assert kernel.LAUNCHES - before == hops
    assert [b - a for a, b in zip(fbefore, _fused_counts())] == [f1, f2]
    want = cpu.prepare(q, block_skipping="off")(**params)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, run_sql(schema, q, params), rtol=1e-4, atol=1e-4)
    assert (got != 0).any()


def _schema(name):
    if name == "CS":
        return SG.make_semmeddb(400, 500, 800, 3000)
    return SG.make_pubmed(n_docs=2000, n_terms=100, n_authors=500, seed=3)


@pytest.mark.parametrize("name,q,params", CASES, ids=[c[0] for c in CASES])
def test_engine_defaults_on_the_card_go_through_the_packed_kernels(cuda, name, q, params):
    """Default storage and skipping: every hop launches the packed scan or
    active kernel, and the result matches the CPU engine and the oracle."""
    schema = _schema(name)
    gpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device=cuda))
    cpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu"))
    before, fbefore = pkernel.LAUNCHES + pkernel.ACTIVE_LAUNCHES, _fused_counts()
    got = gpu.query(q, **params)
    hops, f1, f2 = _launches(gpu.prepare(q).phys)
    assert pkernel.LAUNCHES + pkernel.ACTIVE_LAUNCHES - before == hops
    assert [b - a for a, b in zip(fbefore, _fused_counts())] == [f1, f2]
    np.testing.assert_allclose(got, cpu.query(q, **params), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, run_sql(schema, q, params), rtol=1e-4, atol=1e-4)
    assert (got != 0).any()


@pytest.mark.parametrize("width", list(range(1, 33)))
@pytest.mark.parametrize("count", [1, 33, 4097, 100_003])
def test_bitunpack_matches_plain(cuda, width, count):
    rng = np.random.default_rng(width * 7 + count)
    vals = rng.integers(0, 2**width, size=count, dtype=np.uint64)
    words = torch.from_numpy(_pack_words(vals, width).view(np.int32)).to(cuda)
    before = bkernel.LAUNCHES
    got = bkernel.bitunpack(words, width, count)
    want = ref.bitunpack_ref(words, width, count)
    torch.cuda.synchronize()
    assert bkernel.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want.cpu())
    assert np.array_equal(got.cpu().numpy().view(np.uint32), vals.astype(np.uint32))


def test_bitunpack_rejects_bad_inputs_and_empty_is_free(cuda):
    words = torch.from_numpy(_pack_words(np.arange(100) % 7, 3).view(np.int32)).to(cuda)
    with pytest.raises(TypeError):
        bkernel.bitunpack(words.long(), 3, 100)
    with pytest.raises(ValueError):
        bkernel.bitunpack(words, 0, 100)
    with pytest.raises(ValueError):
        bkernel.bitunpack(words, 33, 100)
    with pytest.raises(ValueError):
        bkernel.bitunpack(words[:-1], 3, 100)  # too few words
    with pytest.raises(ValueError):
        bkernel.bitunpack(words.cpu(), 3, 100)
    before = bkernel.LAUNCHES
    assert bkernel.bitunpack(words, 3, 0).shape == (0,)
    assert bkernel.LAUNCHES == before


def _packed_inputs(op, E, seed, device, n_src=3000, n_dst=700):
    rng = np.random.default_rng(seed)
    w = rng.random(n_src).astype(np.float32) * 2
    if op == "bool":
        w = (w > 1).astype(np.float32)
    w[rng.random(n_src) < 0.25] = ZERO[op]
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = rng.integers(0, n_dst, E).astype(np.int32)
    mint = rng.integers(0, 40, E)
    mdict = np.array([0.5, 3.0, 0.0, 7.25, 1.0], np.float32)
    midx = rng.integers(0, 5, E)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    words = lambda v, b: t(_pack_words(v, b).view(np.int32))  # noqa: E731
    return dict(w=t(w), src=t(src), dst=t(dst), dst_words=words(dst, 10), n_dst=n_dst,
                m_dense=t(mint.astype(np.float32)), m_words=words(mint, 6),
                midx_words=words(midx, 3), mdict=t(mdict))


def _packed_operands(x, m_mode, dst_packed):
    dst, dw = (x["dst_words"], 10) if dst_packed else (x["dst"], 0)
    m, md, mw = {"none": (None, None, 0), "dense": (x["m_dense"], None, 0),
                 "packed": (x["m_words"], None, 6),
                 "dict": (x["midx_words"], x["mdict"], 3)}[m_mode]
    return dst, m, md, dict(n_dst=x["n_dst"], dst_width=dw, m_mode=m_mode, m_width=mw)


M_MODES = ["none", "dense", "packed", "dict"]


@pytest.mark.parametrize("E", [0, 1, 4097, 50_000])
@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("op", OPS)
def test_packed_kernel_matches_plain(cuda, op, m_mode, dst_packed, E):
    x = _packed_inputs(op, E, E + len(op), cuda)
    dst, m, md, kw = _packed_operands(x, m_mode, dst_packed)
    before = pkernel.LAUNCHES
    got = pkernel.fragment_spmv_packed(x["w"], x["src"], dst, m, md, op=op, **kw)
    want = ref.fragment_spmv_packed_ref(x["w"], x["src"], dst, m, md, op=op, **kw)
    torch.cuda.synchronize()
    assert pkernel.LAUNCHES == before + (1 if E else 0)  # E == 0 never launches
    _assert_match(got, want, op)


@pytest.mark.parametrize("support", [0.0, 0.001, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("op", OPS)
def test_active_kernels_match_scan_and_plain(cuda, op, support):
    """Both active kernels over device-built lists, at several supports, with
    the list followed ('on') and with 'auto''s scan order forced."""
    E = 40_000
    x = _packed_inputs(op, E, 11, cuda)
    w = x["w"].clone()
    keep = torch.rand(w.shape[0], generator=torch.Generator().manual_seed(3)) < support
    w[~keep.to(cuda)] = ZERO[op]
    bmin, bmax = (torch.from_numpy(b).to(cuda) for b in active.block_ranges(x["src"].cpu()))
    bi, na = active.active_block_list(w, ZERO[op], bmin, bmax)
    nb = active.n_edge_blocks(E)
    for scan_above in (nb, 0):
        dense_before = kernel.ACTIVE_LAUNCHES
        got = kernel.fragment_spmv_active(w, x["src"], x["dst"], x["m_dense"], bi, na,
                                          x["n_dst"], op=op, scan_above=scan_above)
        assert kernel.ACTIVE_LAUNCHES == dense_before + 1
        scan = kernel.fragment_spmv(w, x["src"], x["dst"], x["m_dense"], x["n_dst"], op=op)
        plain = ref.fragment_spmv_active_ref(w, x["src"], x["dst"], x["m_dense"], bi, na,
                                             x["n_dst"], op=op, scan_above=scan_above)
        _assert_match(got, scan, op)
        _assert_match(got, plain, op)
        for m_mode in M_MODES:
            dst, m, md, kw = _packed_operands(x, m_mode, True)
            before = pkernel.ACTIVE_LAUNCHES
            got = pkernel.fragment_spmv_packed_active(w, x["src"], dst, m, md, bi, na,
                                                      op=op, scan_above=scan_above, **kw)
            assert pkernel.ACTIVE_LAUNCHES == before + 1
            _assert_match(got, ref.fragment_spmv_packed_ref(w, x["src"], dst, m, md,
                                                            op=op, **kw), op)
    torch.cuda.synchronize()


def test_packed_wrappers_reject_bad_inputs(cuda):
    x = _packed_inputs("sum", 5000, 5, cuda)
    args = (x["w"], x["src"], x["dst_words"], x["m_words"], None)
    kw = dict(n_dst=x["n_dst"], dst_width=10, m_mode="packed", m_width=6)
    with pytest.raises(TypeError):
        pkernel.fragment_spmv_packed(x["w"], x["src"].long(), *args[2:], **kw)
    with pytest.raises(ValueError):
        pkernel.fragment_spmv_packed(*args, **{**kw, "dst_width": 33})
    with pytest.raises(ValueError):
        pkernel.fragment_spmv_packed(x["w"], x["src"], x["dst_words"][:10], *args[3:], **kw)
    with pytest.raises(ValueError):
        pkernel.fragment_spmv_packed(*args, **{**kw, "m_mode": "zip"})
    with pytest.raises(ValueError):
        pkernel.fragment_spmv_packed(x["w"].cpu(), *args[1:], **kw)
    bi = torch.zeros(100, dtype=torch.int32, device=cuda)  # more entries than blocks
    na = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pkernel.fragment_spmv_packed_active(*args, bi, na, **kw)
    with pytest.raises(ValueError):
        kernel.fragment_spmv_active(x["w"], x["src"], x["dst"], None, bi[:2],
                                    torch.ones(2, dtype=torch.int32, device=cuda), 700)


def test_dispatch_counts_each_new_kernel_on_cuda(cuda):
    x = _packed_inputs("max", 20_000, 9, cuda)
    bmin, bmax = (torch.from_numpy(b).to(cuda) for b in active.block_ranges(x["src"].cpu()))
    counts = lambda: (kernel.ACTIVE_LAUNCHES, pkernel.LAUNCHES,  # noqa: E731
                      pkernel.ACTIVE_LAUNCHES, bkernel.LAUNCHES)
    c0 = counts()
    ops.fragment_spmv(x["w"], x["src"], x["dst"], None, x["n_dst"], op="max",
                      blocks=(bmin, bmax), block_skipping="auto")
    ops.fragment_spmv_packed(x["w"], x["src"], x["dst_words"], n_dst=x["n_dst"],
                             dst_width=10, op="max")
    ops.fragment_spmv_packed(x["w"], x["src"], x["dst_words"], n_dst=x["n_dst"],
                             dst_width=10, op="max", blocks=(bmin, bmax), block_skipping="on")
    ops.bitunpack(x["dst_words"], 10, 20_000)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, counts())] == [1, 1, 1, 1]


# ---------------------------------------------------------------------------
# The packed pair's per-CTA aggregation: hot destinations and a full table
# ---------------------------------------------------------------------------

HOT_CASES = ["one_dst", "overflow", "zipf"]


def _hot_inputs(case, op, E, seed, device):
    """Packed-hop inputs whose destinations stress the table: every edge on
    one destination; more distinct destinations in a 4096-edge block than
    the table has slots (a permutation of 20,000 ids); Zipf-hot ones."""
    x = _packed_inputs(op, E, seed, device)
    x["n_dst"] = 20_000
    rng = np.random.default_rng(seed + 1)
    if case == "one_dst":
        dst = np.full(E, 7, np.int32)
    elif case == "overflow":
        dst = np.concatenate([rng.permutation(20_000) for _ in range(E // 20_000 + 1)])[:E]
    else:
        dst = np.minimum(rng.zipf(1.3, E) - 1, 19_999)
    dst = dst.astype(np.int32)
    x["dst"] = torch.from_numpy(dst).to(device)
    x["dst_words"] = torch.from_numpy(_pack_words(dst, 15).view(np.int32)).to(device)
    return x


def _hot_operands(x, m_mode, dst_packed):
    dst, m, md, kw = _packed_operands(x, m_mode, dst_packed)
    if dst_packed:
        dst, kw["dst_width"] = x["dst_words"], 15
    return dst, m, md, kw


@pytest.mark.parametrize("E", [1, 4095, 4096, 4097, 30_000])
@pytest.mark.parametrize("case", HOT_CASES)
@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("op", OPS)
def test_packed_pair_hot_destinations_match_plain(cuda, op, m_mode, dst_packed, case, E):
    """Scan and active (following the list, and in scan order with n_active
    above scan_above) against the plain versions, for every op and measure."""
    x = _hot_inputs(case, op, E, E + len(op) + len(case), cuda)
    dst, m, md, kw = _hot_operands(x, m_mode, dst_packed)
    want = ref.fragment_spmv_packed_ref(x["w"], x["src"], dst, m, md, op=op, **kw)
    before = pkernel.LAUNCHES
    got = pkernel.fragment_spmv_packed(x["w"], x["src"], dst, m, md, op=op, **kw)
    torch.cuda.synchronize()
    assert pkernel.LAUNCHES == before + 1
    _assert_match(got, want, op)
    bmin, bmax = (torch.from_numpy(b).to(cuda) for b in active.block_ranges(x["src"].cpu()))
    bi, na = active.active_block_list(x["w"], ZERO[op], bmin, bmax)
    for scan_above in (active.n_edge_blocks(E), 0):
        got = pkernel.fragment_spmv_packed_active(x["w"], x["src"], dst, m, md, bi, na, op=op,
                                                  scan_above=scan_above, **kw)
        want = ref.fragment_spmv_packed_active_ref(x["w"], x["src"], dst, m, md, bi, na, op=op,
                                                   scan_above=scan_above, **kw)
        torch.cuda.synchronize()
        _assert_match(got, want, op)


_TABLE_BUILDS: dict = {}


def _table_build(bits: int, probes: int):
    """The packed kernels built with another table shape (``-D`` overrides
    of ``csrc/hop.cuh``), in a library file of their own."""
    from repro_torch.kernels.cuda_build import CudaLibrary

    key = (bits, probes)
    if key not in _TABLE_BUILDS:
        _TABLE_BUILDS[key] = CudaLibrary(
            pkernel.LIB.name, pkernel.LIB.functions,
            defines=(f"HOP_TABLE_BITS={bits}", f"HOP_TABLE_PROBES={probes}"))
    return _TABLE_BUILDS[key]


@pytest.mark.parametrize("shape", ["off", "built", "2x1", "1024x4", "2048x8"])
@pytest.mark.parametrize("case", HOT_CASES)
@pytest.mark.parametrize("op", OPS)
def test_packed_pair_result_does_not_depend_on_the_table(cuda, monkeypatch, op, case, shape):
    """No table (an atomic an edge), the built table and builds at other
    sizes and probe limits give the plain version's result: an edge without
    a slot writes to y directly."""
    if "x" in shape:
        slots, probes = (int(v) for v in shape.split("x"))
        monkeypatch.setattr(pkernel, "LIB", _table_build(slots.bit_length() - 1, probes))
    E = 20_000
    x = _hot_inputs(case, op, E, 5, cuda)
    dst, m, md, kw = _hot_operands(x, "packed", True)
    want = ref.fragment_spmv_packed_ref(x["w"], x["src"], dst, m, md, op=op, **kw)
    table = shape != "off"
    _assert_match(pkernel.fragment_spmv_packed(x["w"], x["src"], dst, m, md, op=op,
                                               table=table, **kw), want, op)
    bi = torch.arange(active.n_edge_blocks(E), dtype=torch.int32, device=cuda)
    na = torch.full((1,), bi.shape[0], dtype=torch.int32, device=cuda)
    _assert_match(pkernel.fragment_spmv_packed_active(x["w"], x["src"], dst, m, md, bi, na,
                                                      op=op, table=table, **kw), want, op)
    torch.cuda.synchronize()


@pytest.mark.parametrize("scan_order", [False, True], ids=["listed", "scan_order"])
@pytest.mark.parametrize("op", OPS)
def test_packed_active_table_loops_over_more_blocks_than_one_wave(cuda, op, scan_order):
    """The aggregating active kernel runs one wave of CTAs, each over a run of
    consecutive listed blocks into one table: an index with more blocks than
    a wave holds, every other block listed (or all, in scan order), against
    the plain version."""
    E = 5_000_000  # 1,221 blocks: more than the CTAs co-resident with the table
    x = _hot_inputs("overflow", op, E, 3, cuda)  # 250 edges a destination
    dst, m, md, kw = _hot_operands(x, "packed", True)
    nb = active.n_edge_blocks(E)
    bi = torch.arange(0, nb, 2, dtype=torch.int32, device=cuda)
    na = torch.full((1,), bi.shape[0], dtype=torch.int32, device=cuda)
    sa = 0 if scan_order else nb
    got = pkernel.fragment_spmv_packed_active(x["w"], x["src"], dst, m, md, bi, na, op=op,
                                              scan_above=sa, **kw)
    want = ref.fragment_spmv_packed_active_ref(x["w"], x["src"], dst, m, md, bi, na, op=op,
                                               scan_above=sa, **kw)
    torch.cuda.synchronize()
    _assert_match(got, want, op)


@pytest.mark.parametrize("scan_order", [False, True], ids=["listed", "scan_order"])
@pytest.mark.parametrize("op", OPS)
def test_packed_active_per_edge_wave_covers_more_blocks_than_one_wave(cuda, op, scan_order):
    """The per-edge packed active kernel runs one wave of CTAs, each over
    every gridDim.x-th listed block: an index with more blocks than a wave
    holds, every other block listed (or all, in scan order), against the
    plain version."""
    E = 5_000_000  # 1,221 blocks: more than one wave of CTAs without shared memory
    x = _hot_inputs("zipf", op, E, 6, cuda)
    dst, m, md, kw = _hot_operands(x, "packed", True)
    nb = active.n_edge_blocks(E)
    bi = torch.arange(0, nb, 2, dtype=torch.int32, device=cuda)
    na = torch.full((1,), bi.shape[0], dtype=torch.int32, device=cuda)
    sa = 0 if scan_order else nb
    got = pkernel.fragment_spmv_packed_active(x["w"], x["src"], dst, m, md, bi, na, op=op,
                                              scan_above=sa, table=False, **kw)
    want = ref.fragment_spmv_packed_active_ref(x["w"], x["src"], dst, m, md, bi, na, op=op,
                                               scan_above=sa, **kw)
    torch.cuda.synchronize()
    _assert_match(got, want, op)


@pytest.mark.parametrize("active_kernel", [False, True], ids=["scan", "active"])
def test_packed_pair_negative_zero_through_the_table(cuda, active_kernel):
    """-0.0 products combined in the table (a −∞ identity for max) reach y
    with their sign bit."""
    E = 5000
    w = torch.tensor([-1.0], device=cuda)
    src = torch.zeros(E, dtype=torch.int32, device=cuda)
    dst = torch.zeros(E, dtype=torch.int32, device=cuda)
    dst[E // 2:] = 1
    m = torch.zeros(E, device=cuda)  # products -0.0 on dst 0
    m[E // 2:] = 2.0  # and -2.0 on dst 1
    kw = dict(n_dst=3, m_mode="dense")
    for op in ("max", "min"):
        if active_kernel:
            bi = torch.arange(2, dtype=torch.int32, device=cuda)
            got = pkernel.fragment_spmv_packed_active(
                w, src, dst, m, None, bi, torch.full((1,), 2, dtype=torch.int32, device=cuda),
                op=op, **kw).cpu()
        else:
            got = pkernel.fragment_spmv_packed(w, src, dst, m, None, op=op, **kw).cpu()
        assert got[0] == 0.0 and got[1] == -2.0
        assert got[2] == ZERO[op]
    got = pkernel.fragment_spmv_packed(w, src, dst, m, None, op="max", **kw).cpu()
    assert torch.signbit(got[0])


@pytest.mark.parametrize("hot_share", [0.0, 1.0])
@pytest.mark.parametrize("op", OPS)
def test_packed_dispatch_chooses_the_table_by_hot_share(cuda, op, hot_share):
    """ops.fragment_spmv_packed with an index's hot share below and above
    the threshold, on the card, against its plain version on the card."""
    x = _hot_inputs("zipf", op, 30_000, 7, cuda)
    dst, m, md, kw = _hot_operands(x, "packed", True)
    before = pkernel.LAUNCHES
    got = ops.fragment_spmv_packed(x["w"], x["src"], dst, m, md, op=op, hot_share=hot_share,
                                   **kw)
    want = ops.fragment_spmv_packed(x["w"], x["src"], dst, m, md, op=op, hot_share=hot_share,
                                    use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert pkernel.LAUNCHES == before + 1
    _assert_match(got, want, op)


# ---------------------------------------------------------------------------
# Bitmap intersection: the AND and its popcount
# ---------------------------------------------------------------------------

BITMAP_SIZES = [0, 1, 3, 4, 5, 1023, 1024, 1025, 2**20 + 3, 3_000_001]


def _bitmaps(n, seed, device):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, n, dtype=np.uint32)
    b = rng.integers(0, 2**32, n, dtype=np.uint32)
    t = lambda v: torch.from_numpy(v.view(np.int32)).to(device)  # noqa: E731
    return a, b, t(a), t(b)


def _popcount_np(x):
    return int(np.unpackbits(x.view(np.uint8)).sum())


@pytest.mark.parametrize("n", BITMAP_SIZES)
def test_bitmap_kernels_match_plain(cuda, n):
    a, b, ta, tb = _bitmaps(n, n, cuda)
    before = (bmkernel.AND_LAUNCHES, bmkernel.POPCOUNT_LAUNCHES)
    got = bmkernel.bitmap_and(ta, tb)
    pc = bmkernel.bitmap_and_popcount(ta, tb)
    torch.cuda.synchronize()
    launched = 1 if n else 0
    assert (bmkernel.AND_LAUNCHES, bmkernel.POPCOUNT_LAUNCHES) == (
        before[0] + launched, before[1] + launched)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, ref.bitmap_and_ref(ta, tb))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), a & b)
    assert pc.dtype == torch.int32 and pc.shape == () and pc.device == ta.device
    assert int(pc) == int(ref.bitmap_and_popcount_ref(ta, tb)) == _popcount_np(a & b)


@pytest.mark.parametrize("off_a,off_b", [(1, 0), (0, 1), (1, 1), (2, 2), (3, 3), (1, 3), (4, 4)])
@pytest.mark.parametrize("n", [1, 6, 1029, 100_003])
def test_bitmap_kernels_on_unaligned_views(cuda, n, off_a, off_b):
    """Contiguous views that start off a 16-byte boundary: scalar head and
    tail around uint4 words where the offsets agree, scalar words where not."""
    a, b, ta, tb = _bitmaps(n + 4, n + off_a, cuda)
    va, vb = ta[off_a:off_a + n], tb[off_b:off_b + n]
    want = a[off_a:off_a + n] & b[off_b:off_b + n]
    got = bmkernel.bitmap_and(va, vb)
    assert np.array_equal(got.cpu().numpy().view(np.uint32), want)
    assert int(bmkernel.bitmap_and_popcount(va, vb)) == _popcount_np(want)
    assert torch.equal(got, ref.bitmap_and_ref(va, vb))


def test_bitmap_popcount_of_full_words_is_exact(cuda):
    """Every bit set (sign bits included) across more words than one CTA."""
    t = torch.full((700_001,), -1, dtype=torch.int32, device=cuda)
    assert int(bmkernel.bitmap_and_popcount(t, t)) == 32 * 700_001


def test_bitmap_wrappers_reject_bad_inputs(cuda):
    _, _, ta, tb = _bitmaps(100, 1, cuda)
    for fn in (bmkernel.bitmap_and, bmkernel.bitmap_and_popcount, ops.bitmap_and,
               ops.bitmap_and_popcount):
        with pytest.raises(ValueError):
            fn(ta, tb[:-1])
        with pytest.raises(TypeError):
            fn(ta.long(), tb.long())
        with pytest.raises(ValueError):
            fn(ta, tb.cpu())
    with pytest.raises(ValueError):
        bmkernel.bitmap_and(ta.cpu(), tb.cpu())
    big = torch.zeros(bmkernel.MAX_POPCOUNT_WORDS + 1, dtype=torch.int32, device=cuda)
    before = bmkernel.POPCOUNT_LAUNCHES
    with pytest.raises(ValueError):
        bmkernel.bitmap_and_popcount(big, big)
    with pytest.raises(ValueError):
        ops.bitmap_and_popcount(big, big)
    assert bmkernel.POPCOUNT_LAUNCHES == before
    assert bmkernel.bitmap_and(big, big).shape == big.shape


def test_bitmap_dispatch_launches_the_kernels_on_cuda(cuda):
    a, b, ta, tb = _bitmaps(5000, 3, cuda)
    before = (bmkernel.AND_LAUNCHES, bmkernel.POPCOUNT_LAUNCHES)
    got = ops.bitmap_and(ta, tb)
    pc = ops.bitmap_and_popcount(ta, tb)
    plain = ops.bitmap_and(ta, tb, use_kernel=False)
    plain_pc = ops.bitmap_and_popcount(ta, tb, use_kernel=False)
    assert (bmkernel.AND_LAUNCHES, bmkernel.POPCOUNT_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert got.device == ta.device and pc.device == ta.device
    assert torch.equal(got, plain) and int(pc) == int(plain_pc) == _popcount_np(a & b)


@pytest.mark.parametrize("n", [1, 1029, 125_000, 2**20 + 3])
def test_bitmap_popcount_is_one_kernel_a_call(cuda, n):
    """One launch writes the int32 count: no fill before it, no cast after
    it (the launch counter; and every device operation the profiler sees is
    the kernel, which it may miss once at the start of its window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, b, ta, tb = _bitmaps(n, 5, cuda)
    bmkernel.bitmap_and_popcount(ta, tb)  # the stream's scratch exists from here on
    torch.cuda.synchronize()
    before = bmkernel.POPCOUNT_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pcs = [bmkernel.bitmap_and_popcount(ta, tb) for _ in range(4)]
        torch.cuda.synchronize()
    assert bmkernel.POPCOUNT_LAUNCHES == before + 4
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if events:  # a profiler that saw the card: the kernel and nothing else
        assert all("bitmap_and_popcount_kernel" in e.key for e in events), [
            (e.key, e.count) for e in events]
        assert 3 <= sum(e.count for e in events) <= 4, [(e.key, e.count) for e in events]
    for pc in pcs:
        assert pc.dtype == torch.int32 and pc.shape == () and pc.device == ta.device
        assert int(pc) == _popcount_np(a & b)


def test_bitmap_popcount_scratch_resets_between_launches(cuda):
    """100 back-to-back counts on one stream with no synchronise between
    them, then counts interleaved on two streams: each equals the plain
    version, so every launch leaves its stream's scratch at zero."""
    cases = [_bitmaps(n, n, cuda) for n in (7, 1025, 100_003, 2**20 + 3)]
    pcs = [bmkernel.bitmap_and_popcount(c[2], c[3]) for _ in range(25) for c in cases]
    torch.cuda.synchronize()
    want = [_popcount_np(c[0] & c[1]) for c in cases]
    assert [int(p) for p in pcs] == want * 25
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    got = {id(s1): [], id(s2): []}
    for i in range(40):
        s = s1 if i % 2 == 0 else s2
        c = cases[i % len(cases)]
        with torch.cuda.stream(s):
            got[id(s)].append((bmkernel.bitmap_and_popcount(c[2], c[3]), i % len(cases)))
    torch.cuda.synchronize()
    for pairs in got.values():
        for pc, k in pairs:
            assert int(pc) == want[k] == int(ref.bitmap_and_popcount_ref(cases[k][2],
                                                                          cases[k][3]))


@pytest.mark.parametrize("off_a,off_b", [(0, 0), (1, 1), (2, 2), (3, 3), (1, 0), (0, 3),
                                         (2, 1)])
@pytest.mark.parametrize("n", BITMAP_SIZES)
def test_bitmap_pair_at_every_length_and_alignment(cuda, n, off_a, off_b):
    """Every length of the bitmap sweep, the operands as views off a
    16-byte boundary (both alike: scalar head and tail around the vectors;
    not alike: scalar words), against the plain versions."""
    a, b, ta, tb = _bitmaps(n + 3, n + 11 * off_a + off_b, cuda)
    va, vb = ta[off_a:off_a + n], tb[off_b:off_b + n]
    want = a[off_a:off_a + n] & b[off_b:off_b + n]
    got = bmkernel.bitmap_and(va, vb)
    pc = bmkernel.bitmap_and_popcount(va, vb)
    assert torch.equal(got, ref.bitmap_and_ref(va, vb))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), want)
    assert int(pc) == int(ref.bitmap_and_popcount_ref(va, vb)) == _popcount_np(want)


# ---------------------------------------------------------------------------
# The fused-region kernels
# ---------------------------------------------------------------------------


def _streams(x, m_mode, dst_packed, src, dst, dst_words, dst_width):
    """A HopStreams bundle over the arrays of _packed_inputs."""
    m, md, mw = {"none": (None, None, 0), "dense": (x["m_dense"], None, 0),
                 "packed": (x["m_words"], None, 6),
                 "dict": (x["midx_words"], x["mdict"], 3)}[m_mode]
    d, dw = (dst_words, dst_width) if dst_packed else (dst, 0)
    return ref.HopStreams(src, d, m, md, dw, m_mode, mw)


def _region(op, E, m_mode, dst_packed, seed, device):
    """hop1 E0 (3000) → E1 (700) from _packed_inputs; hop2 E1 → E2 (500) with
    E + 3 edges, the same measure mode; a mid mask over E1."""
    x = _packed_inputs(op, E, seed, device)
    h1 = _streams(x, m_mode, dst_packed, x["src"], x["dst"], x["dst_words"], 10)
    rng = np.random.default_rng(seed + 1)
    E2 = E + 3
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    src2 = np.sort(rng.integers(0, 700, E2)).astype(np.int32)
    dst2 = rng.integers(0, 500, E2).astype(np.int32)
    y = _packed_inputs(op, E2, seed + 2, device)
    h2 = _streams(y, m_mode, dst_packed, t(src2), t(dst2), t(_pack_words(dst2, 9).view(np.int32)),
                  9)
    keep = t((rng.random(700) < 0.6).astype(np.float32))
    return x["w"], h1, h2, keep


def _full(E, device):
    nb = active.n_edge_blocks(E)
    return (torch.arange(nb, dtype=torch.int32, device=device),
            torch.full((1,), nb, dtype=torch.int32, device=device))


@pytest.mark.parametrize("variant", ["two_hop", "two_hop_mask_binarize", "degenerate",
                                     "degenerate_mask"])
@pytest.mark.parametrize("E", [1, 4097, 50_000])
@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("op", OPS)
def test_fused_kernels_match_plain_and_unfused(cuda, op, m_mode, dst_packed, E, variant):
    """Both fused kernels over full block lists against the plain region and
    against the unfused composition through the port's packed hop kernel."""
    w, h1, h2, keep = _region(op, E, m_mode, dst_packed, E + len(op), cuda)
    two = variant.startswith("two_hop")
    mask = keep if variant.endswith(("mask", "binarize")) else None
    if not two and mask is not None:
        mask = (torch.arange(700, device=cuda) % 3 != 0).to(torch.float32)
    binz = variant.endswith("binarize")
    bi1, na1 = _full(E, cuda)
    bi2, na2 = _full(E + 3, cuda)
    before = _fused_counts()
    if two:
        got = fkernel.fragment_spmv_fused2(w, h1, h2, mask, bi1, na1, bi2, na2, 700, 500,
                                           op=op, mid_binarize=binz)
    else:
        got = fkernel.fragment_spmv_fused1(w, h1, mask, bi1, na1, 700, op=op)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, _fused_counts())] == ([0, 1] if two else [1, 0])
    want = ref.fragment_spmv_fused_ref(w, h1, h2 if two else None, mask, 700, 500, op=op,
                                       mid_binarize=binz)
    _assert_match(got, want, op)

    def hop(x, h, n):
        return pkernel.fragment_spmv_packed(x, h.src, h.dst, h.measure, h.mdict, n,
                                            dst_width=h.dst_width, m_mode=h.m_mode,
                                            m_width=h.m_width, op=op)

    u = hop(w, h1, 700)
    if mask is not None:
        u = ref.apply_mask(u, mask, op)
    if two:
        u = hop(ref.binarize(u, op) if binz else u, h2, 500)
    _assert_match(got, u, op)


@pytest.mark.parametrize("support", [0.0, 0.001, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("op", OPS)
def test_fused_kernels_follow_device_lists(cuda, op, support):
    """The dispatch's device-built lists (hop2's through the reach matrix) at
    several supports: fused equals the scan composition and the plain region,
    and each kernel launches once."""
    from repro_torch.core.fuse import _block_reach

    E = 60_000
    w, h1, h2, keep = _region(op, E, "packed", True, 21, cuda)
    drop = torch.rand(w.shape[0], generator=torch.Generator().manual_seed(4)) >= support
    w = w.clone()
    w[drop.to(cuda)] = ZERO[op]
    smin2, smax2 = active.block_ranges(h2.src.cpu())
    hop1 = HopOp("T", "A", "E1", 700, None, h1.src, None,
                 host_dst=ref.bitunpack_ref(h1.dst.cpu(), h1.dst_width, E).numpy(),
                 hot_share=0.0)
    hop2 = HopOp("T", "B", "E2", 500, None, h2.src, None, block_src_min=smin2,
                 block_src_max=smax2, hot_share=0.0)
    reach = torch.from_numpy(_block_reach(hop1, hop2)).to(cuda)
    blocks = lambda h: tuple(torch.from_numpy(b).to(cuda)  # noqa: E731
                             for b in active.block_ranges(h.src.cpu()))
    mk = lambda h, n, r=None: ops.FusedHopOperands(  # noqa: E731
        h.src, h.dst, h.measure, h.mdict, n, h.dst_width, h.m_mode, h.m_width,
        blocks=blocks(h), reach=r, hot_share=0.0)
    o1, o2 = mk(h1, 700), mk(h2, 500, reach)
    for two in (True, False):
        before = _fused_counts()
        got = ops.fragment_spmv_fused(w, o1, o2 if two else None, keep, op=op,
                                      mid_binarize=two, fusion="on", block_skipping="on")
        off = ops.fragment_spmv_fused(w, o1, o2 if two else None, keep, op=op,
                                      mid_binarize=two, fusion="off", block_skipping="off")
        plain = ops.fragment_spmv_fused(w, o1, o2 if two else None, keep, op=op,
                                        mid_binarize=two, fusion="on", block_skipping="on",
                                        use_kernel=False)
        torch.cuda.synchronize()
        assert [b - a for a, b in zip(before, _fused_counts())] == ([0, 1] if two else [1, 0])
        _assert_match(got, off, op)
        _assert_match(got, plain, op)


def test_fused_wrappers_reject_bad_inputs(cuda):
    w, h1, h2, keep = _region("sum", 5000, "packed", True, 5, cuda)
    bi1, na1 = _full(5000, cuda)
    bi2, na2 = _full(5003, cuda)
    args = (bi1, na1, bi2, na2, 700, 500)
    with pytest.raises(TypeError):
        fkernel.fragment_spmv_fused2(w, h1._replace(src=h1.src.long()), h2, keep, *args)
    with pytest.raises(ValueError):
        fkernel.fragment_spmv_fused2(w, h1._replace(dst_width=33), h2, keep, *args)
    with pytest.raises(ValueError):
        fkernel.fragment_spmv_fused2(w, h1, h2, keep[:10], *args)
    with pytest.raises(ValueError):
        fkernel.fragment_spmv_fused2(w.cpu(), h1, h2, keep, *args)
    with pytest.raises(ValueError):
        fkernel.fragment_spmv_fused1(w, h1._replace(m_mode="zip"), None, bi1, na1, 700)
    big = torch.zeros(100, dtype=torch.int32, device=cuda)  # more entries than blocks
    with pytest.raises(ValueError):
        fkernel.fragment_spmv_fused2(w, h1, h2, keep, big, na1, bi2, na2, 700, 500)
    assert fkernel.max_grid("sum") >= 132  # at least one CTA per SM of an H100


@pytest.mark.parametrize("fusion", ["auto", "on"])
@pytest.mark.parametrize("name,q,params", CASES + [
    ("SD_RECENT", SG.QUERY_SD_RECENT, {"d0": 5}), ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 7})],
    ids=[c[0] for c in CASES] + ["SD_RECENT", "AS_RECENT"])
def test_engine_fusion_on_the_card(cuda, name, q, params, fusion):
    """Fused plans on the card: one fused launch per region, the other hops
    through the packed kernels; the result equals fusion off and the oracle."""
    schema = _schema(name)
    gpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device=cuda))
    pq = gpu.prepare(q, fusion=fusion)
    hops, f1, f2 = _launches(pq.phys)
    before, fbefore = pkernel.LAUNCHES + pkernel.ACTIVE_LAUNCHES, _fused_counts()
    got = pq(**params)
    assert pkernel.LAUNCHES + pkernel.ACTIVE_LAUNCHES - before == hops
    assert [b - a for a, b in zip(fbefore, _fused_counts())] == [f1, f2]
    off = gpu.prepare(q, fusion="off")(**params)
    np.testing.assert_allclose(got, off, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, run_sql(schema, q, params), rtol=1e-4, atol=1e-4)
    assert (got != 0).any()


# ---------------------------------------------------------------------------
# Batched serving: the SpMM kernels and the fused regions' SpMM form
# ---------------------------------------------------------------------------

from repro_torch.kernels import fragment_spmm as skernel  # noqa: E402
from repro_torch.kernels import fragment_spmm_packed as spkernel  # noqa: E402

BATCHES = [1, 3, 64]


def _rows(w, B, op, seed):
    """B frontier rows: row 0 is ``w``, the others random with identity
    entries (a quarter), so rows differ and the per-row identity guard runs."""
    rng = np.random.default_rng(seed)
    W = rng.random((B, w.shape[0])).astype(np.float32) * 2
    if op == "bool":
        W = (W > 1).astype(np.float32)
    W[rng.random(W.shape) < 0.25] = ZERO[op]
    W = torch.from_numpy(W).to(w.device)
    W[0] = w
    return W.contiguous()


def _union_list(W, src, op, device):
    """The device-built union list of W's rows (a full one-block list for an
    empty index, which has no blocks to list)."""
    if src.shape[0] == 0:
        return _full(0, device)
    bmin, bmax = (torch.from_numpy(b).to(device) for b in active.block_ranges(src.cpu()))
    return active.active_block_list(W, ZERO[op], bmin, bmax)


def _spmm_counts():
    return (skernel.LAUNCHES, skernel.ACTIVE_LAUNCHES, spkernel.LAUNCHES,
            spkernel.ACTIVE_LAUNCHES, fkernel.SPMM_FUSED1_LAUNCHES,
            fkernel.SPMM_FUSED2_LAUNCHES)


def _delta(before):
    return [b - a for a, b in zip(before, _spmm_counts())]


@pytest.mark.parametrize("measure", ["none", "shared", "per_row"])
@pytest.mark.parametrize("E", [0, 1, 4097])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("op", OPS)
def test_spmm_kernels_match_plain(cuda, op, B, E, measure):
    """The dense SpMM (scan and active over a device-built union list) against
    the plain version, with a shared, a per-row ([B, E], row stride E) and no
    measure; each row also against the port's SpMV kernel."""
    x = _packed_inputs(op, E, E + B + len(op), cuda)
    W = _rows(x["w"], B, op, E + B)
    m = {"none": None, "shared": x["m_dense"],
         "per_row": torch.rand((B, E), generator=torch.Generator().manual_seed(B)).to(cuda)
         }[measure]
    bi, na = _union_list(W, x["src"], op, cuda)
    before = _spmm_counts()
    got = skernel.fragment_spmm(W, x["src"], x["dst"], m, x["n_dst"], op=op)
    got_a = skernel.fragment_spmm_active(W, x["src"], x["dst"], m, bi, na, x["n_dst"], op=op)
    torch.cuda.synchronize()
    assert _delta(before) == ([1, 1, 0, 0, 0, 0] if E else [0] * 6)
    want = ref.fragment_spmm_ref(W, x["src"], x["dst"], m, x["n_dst"], op=op)
    _assert_match(got, want, op)
    _assert_match(got_a, want, op)
    for b in range(B):
        mb = m[b].contiguous() if measure == "per_row" else m
        _assert_match(got[b], kernel.fragment_spmv(W[b], x["src"], x["dst"], mb, x["n_dst"],
                                                   op=op), op)


@pytest.mark.parametrize("E", [0, 1, 4097])
@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("op", OPS)
def test_spmm_packed_kernels_match_plain(cuda, op, B, m_mode, dst_packed, E):
    """The decode-fused SpMM, scan and active (the list followed, and in scan
    order), against the plain version and each row against the SpMV kernel."""
    x = _packed_inputs(op, E, E + B + len(op), cuda)
    W = _rows(x["w"], B, op, E + 2 * B)
    dst, m, md, kw = _packed_operands(x, m_mode, dst_packed)
    bi, na = _union_list(W, x["src"], op, cuda)
    nb = active.n_edge_blocks(E)
    before = _spmm_counts()
    got = spkernel.fragment_spmm_packed(W, x["src"], dst, m, md, op=op, **kw)
    acts = [spkernel.fragment_spmm_packed_active(W, x["src"], dst, m, md, bi, na, op=op,
                                                 scan_above=sa, **kw) for sa in (nb, 0)]
    torch.cuda.synchronize()
    assert _delta(before) == ([0, 0, 1, 2, 0, 0] if E else [0] * 6)
    want = ref.fragment_spmm_packed_ref(W, x["src"], dst, m, md, op=op, **kw)
    for g in [got, *acts]:
        _assert_match(g, want, op)
    for b in range(B):
        _assert_match(got[b], pkernel.fragment_spmv_packed(W[b], x["src"], dst, m, md, op=op,
                                                           **kw), op)


@pytest.mark.parametrize("variant", ["two_hop", "two_hop_mask_binarize", "degenerate",
                                     "degenerate_mask"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("op", OPS)
def test_spmm_fused_kernels_match_plain_and_unfused(cuda, op, B, m_mode, variant):
    """The fused regions' SpMM form over full lists against the plain batched
    region and the unfused composition through the port's SpMM kernels."""
    E = 4097
    w, h1, h2, keep = _region(op, E, m_mode, True, E + B + len(op), cuda)
    W = _rows(w, B, op, B + 17)
    two = variant.startswith("two_hop")
    mask = keep if variant.endswith(("mask", "binarize")) else None
    if not two and mask is not None:
        mask = (torch.arange(700, device=cuda) % 3 != 0).to(torch.float32)
    binz = variant.endswith("binarize")
    bi1, na1 = _full(E, cuda)
    bi2, na2 = _full(E + 3, cuda)
    before = _spmm_counts()
    if two:
        got = fkernel.fragment_spmm_fused2(W, h1, h2, mask, bi1, na1, bi2, na2, 700, 500,
                                           op=op, mid_binarize=binz)
    else:
        got = fkernel.fragment_spmm_fused1(W, h1, mask, bi1, na1, 700, op=op)
    torch.cuda.synchronize()
    assert _delta(before) == ([0, 0, 0, 0, 0, 1] if two else [0, 0, 0, 0, 1, 0])
    want = ref.fragment_spmm_fused_ref(W, h1, h2 if two else None, mask, 700, 500, op=op,
                                       mid_binarize=binz)
    _assert_match(got, want, op)

    def hop(x, h, n):
        return spkernel.fragment_spmm_packed(x, h.src, h.dst, h.measure, h.mdict, n,
                                             dst_width=h.dst_width, m_mode=h.m_mode,
                                             m_width=h.m_width, op=op)

    u = hop(W, h1, 700)
    if mask is not None:
        u = ref.apply_mask(u, mask, op)
    if two:
        u = hop(ref.binarize(u, op) if binz else u, h2, 500)
    _assert_match(got, u, op)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("op", OPS)
def test_spmm_fused_dispatch_follows_union_lists(cuda, op, B):
    """The batched dispatch with device-built lists (the union of the rows'
    supports; hop2's through the reach matrix): one launch of the SpMM form,
    equal to the unfused scan composition and the plain region."""
    from repro_torch.core.fuse import _block_reach

    E = 60_000
    w, h1, h2, keep = _region(op, E, "packed", True, 21, cuda)
    W = _rows(w, B, op, 5)
    W[:, 200:] = ZERO[op]  # a sparse union: hop1's list skips blocks
    smin2, smax2 = active.block_ranges(h2.src.cpu())
    hop1 = HopOp("T", "A", "E1", 700, None, h1.src, None,
                 host_dst=ref.bitunpack_ref(h1.dst.cpu(), h1.dst_width, E).numpy(),
                 hot_share=0.0)
    hop2 = HopOp("T", "B", "E2", 500, None, h2.src, None, block_src_min=smin2,
                 block_src_max=smax2, hot_share=0.0)
    reach = torch.from_numpy(_block_reach(hop1, hop2)).to(cuda)
    blocks = lambda h: tuple(torch.from_numpy(b).to(cuda)  # noqa: E731
                             for b in active.block_ranges(h.src.cpu()))
    mk = lambda h, n, r=None: ops.FusedHopOperands(  # noqa: E731
        h.src, h.dst, h.measure, h.mdict, n, h.dst_width, h.m_mode, h.m_width,
        blocks=blocks(h), reach=r, hot_share=0.0)
    o1, o2 = mk(h1, 700), mk(h2, 500, reach)
    for two in (True, False):
        before = _spmm_counts()
        got = ops.fragment_spmm_fused(W, o1, o2 if two else None, keep, op=op,
                                      mid_binarize=two, fusion="on", block_skipping="on")
        torch.cuda.synchronize()
        assert _delta(before) == ([0, 0, 0, 0, 0, 1] if two else [0, 0, 0, 0, 1, 0])
        off = ops.fragment_spmm_fused(W, o1, o2 if two else None, keep, op=op,
                                      mid_binarize=two, fusion="off", block_skipping="off")
        plain = ops.fragment_spmm_fused(W, o1, o2 if two else None, keep, op=op,
                                        mid_binarize=two, fusion="on", block_skipping="on",
                                        use_kernel=False)
        _assert_match(got, off, op)
        _assert_match(got, plain, op)


def test_spmm_wrappers_reject_bad_inputs(cuda):
    x = _packed_inputs("sum", 5000, 5, cuda)
    W = _rows(x["w"], 3, "sum", 1)
    with pytest.raises(ValueError):  # a 1-D frontier is the SpMV's
        skernel.fragment_spmm(x["w"], x["src"], x["dst"], None, 700)
    with pytest.raises(ValueError):  # rows must be contiguous
        skernel.fragment_spmm(W.t().contiguous().t(), x["src"], x["dst"], None, 700)
    with pytest.raises(ValueError):  # a per-row measure of the wrong shape
        skernel.fragment_spmm(W, x["src"], x["dst"], torch.rand(2, 5000, device=cuda), 700)
    with pytest.raises(TypeError):
        spkernel.fragment_spmm_packed(W, x["src"].long(), x["dst_words"], None, None, 700,
                                      dst_width=10)
    with pytest.raises(ValueError):
        spkernel.fragment_spmm_packed(W.cpu(), x["src"], x["dst_words"], None, None, 700,
                                      dst_width=10)
    assert fkernel.max_grid("sum", batched=True) >= 132


def test_spmm_row_offsets_are_int64(cuda):
    """B · n_dst and B · n_src past 2^31: row 1's offsets wrap a 32-bit int.
    Three 8 GiB tensors (W, the scratch and Y), so it runs only where the card
    has room."""
    n = 2**30 + 7
    free, _ = torch.cuda.mem_get_info(cuda)
    if free < 28 * 2**30:
        pytest.skip("needs 28 GiB of free device memory for B · n > 2^31")
    assert skernel.LIB.functions["fragment_spmm_launch"][6] is ctypes.c_int64  # m_stride
    W = torch.zeros((2, n), device=cuda)
    W[1, n - 3] = 2.0
    src = torch.tensor([5, n - 3, n - 3], dtype=torch.int32, device=cuda)
    dst = torch.tensor([0, n - 1, 4], dtype=torch.int32, device=cuda)
    m = torch.tensor([1.0, 3.0, 0.5], device=cuda)
    for packed in (False, True):
        if packed:
            words = torch.from_numpy(
                _pack_words(dst.cpu().numpy().astype(np.int64), 31).view(np.int32)).to(cuda)
            y = spkernel.fragment_spmm_packed(W, src, words, m, None, n, dst_width=31,
                                              m_mode="dense")
        else:
            y = skernel.fragment_spmm(W, src, dst, m, n)
        torch.cuda.synchronize()
        assert float(y[1, n - 1]) == 6.0 and float(y[1, 4]) == 1.0
        assert float(y[0].abs().sum()) == 0.0 and float(y[1].sum()) == 7.0
        del y


def _batched_launches(phys, B):
    """(HopOps, degenerate regions, two-hop regions) one batched execution
    runs at B rows: a two-hop region over the scratch budget of B rows runs
    its hops unfused under 'auto'. Once a batch, whatever B is."""
    n = [0, 0, 0]
    for op in phys.ops:
        if isinstance(op, HopOp):
            n[0] += 1
        elif isinstance(op, FusedHopOp):
            if ops._fusion_unfusable("auto", op.n_mid, len(op.hops) == 2, B):
                n[0] += len(op.hops)
            else:
                n[len(op.hops)] += 1
        for p in getattr(op, "programs", ()):
            n = [a + b for a, b in zip(n, _batched_launches(p, B))]
    return n


@pytest.mark.parametrize("name,q,params", CASES + [
    ("SD_RECENT", SG.QUERY_SD_RECENT, {"d0": 5}), ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 7})],
    ids=[c[0] for c in CASES] + ["SD_RECENT", "AS_RECENT"])
def test_execute_batch_on_the_card_matches_single_calls(cuda, name, q, params):
    """The defaults through execute_batch at B ∈ {1, 5 (pads to 8), 64}: each
    row equals its single call, and the SpMM and batched fused launches equal
    the HopOps and regions of one execution, once a batch."""
    schema = _schema(name)
    gpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device=cuda))
    pq = gpu.prepare(q)
    rng = np.random.default_rng(len(name))
    for B in (1, 5, 64):
        arrays = {k: (rng.integers(1995, 2015, B) if k == "y" else
                      np.full(B, v) if name == "CS" else rng.integers(0, 60, B))
                  for k, v in params.items()}
        before = _spmm_counts()
        got = pq.execute_batch(**arrays)
        torch.cuda.synchronize()
        d = _delta(before)
        hops, f1, f2 = _batched_launches(pq.phys, 8 if B == 5 else B)
        assert [d[0] + d[1] + d[2] + d[3], d[4], d[5]] == [hops, f1, f2]
        assert got.shape == (B, pq.phys.out_dom)
        for i in range(B):
            row = pq(**{k: int(v[i]) for k, v in arrays.items()})
            np.testing.assert_allclose(got[i], row, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The dense pair's two forms (per-CTA table; atomic an edge), the one-wave
# per-edge active kernels, and the block list built in one launch
# ---------------------------------------------------------------------------

from repro_torch.kernels import block_list as lkernel  # noqa: E402

@pytest.mark.parametrize("E", [1, 4095, 4097, 30_000])
@pytest.mark.parametrize("case", HOT_CASES)
@pytest.mark.parametrize("with_measure", [True, False], ids=["m", "no_m"])
@pytest.mark.parametrize("table", [True, False], ids=["table", "per_edge"])
@pytest.mark.parametrize("op", OPS)
def test_dense_pair_both_forms_match_plain(cuda, op, table, with_measure, case, E):
    """The dense scan and active kernels (the list followed, and scan order
    with n_active above scan_above) with the table and without, on hot,
    overflowing and Zipf destinations, against the plain versions."""
    x = _hot_inputs(case, op, E, E + len(op) + len(case), cuda)
    m = x["m_dense"] if with_measure else None
    want = ref.fragment_spmv_ref(x["w"], x["src"], x["dst"], m, x["n_dst"], op=op)
    before = kernel.LAUNCHES, kernel.ACTIVE_LAUNCHES
    got = kernel.fragment_spmv(x["w"], x["src"], x["dst"], m, x["n_dst"], op=op, table=table)
    torch.cuda.synchronize()
    _assert_match(got, want, op)
    bmin, bmax = (torch.from_numpy(b).to(cuda) for b in active.block_ranges(x["src"].cpu()))
    bi, na = active.active_block_list(x["w"], ZERO[op], bmin, bmax)
    for scan_above in (active.n_edge_blocks(E), 0):
        got = kernel.fragment_spmv_active(x["w"], x["src"], x["dst"], m, bi, na, x["n_dst"],
                                          op=op, scan_above=scan_above, table=table)
        want = ref.fragment_spmv_active_ref(x["w"], x["src"], x["dst"], m, bi, na, x["n_dst"],
                                            op=op, scan_above=scan_above)
        torch.cuda.synchronize()
        _assert_match(got, want, op)
    assert (kernel.LAUNCHES, kernel.ACTIVE_LAUNCHES) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("table", [True, False], ids=["table", "per_edge"])
@pytest.mark.parametrize("scan_order", [False, True], ids=["listed", "scan_order"])
@pytest.mark.parametrize("op", OPS)
def test_dense_active_wave_covers_more_blocks_than_one_wave(cuda, op, scan_order, table):
    """The dense active kernel runs one wave of CTAs (the per-edge form each
    over every gridDim.x-th listed block, the table form each over a run of
    consecutive listed blocks): an index with more blocks than a wave holds,
    every other block listed (or all, in scan order)."""
    E = 5_000_000  # 1,221 blocks
    x = _hot_inputs("zipf", op, E, 4, cuda)
    nb = active.n_edge_blocks(E)
    bi = torch.arange(0, nb, 2, dtype=torch.int32, device=cuda)
    na = torch.full((1,), bi.shape[0], dtype=torch.int32, device=cuda)
    sa = 0 if scan_order else nb
    got = kernel.fragment_spmv_active(x["w"], x["src"], x["dst"], x["m_dense"], bi, na,
                                      x["n_dst"], op=op, scan_above=sa, table=table)
    want = ref.fragment_spmv_active_ref(x["w"], x["src"], x["dst"], x["m_dense"], bi, na,
                                        x["n_dst"], op=op, scan_above=sa)
    torch.cuda.synchronize()
    _assert_match(got, want, op)


@pytest.mark.parametrize("table", [True, False], ids=["table", "per_edge"])
def test_dense_pair_negative_zero_in_both_forms(cuda, table):
    """-0.0 products (a −∞ identity for max) reach y with their sign bit,
    through the table and through the per-edge atomics."""
    E = 5000
    w = torch.tensor([-1.0], device=cuda)
    src = torch.zeros(E, dtype=torch.int32, device=cuda)
    dst = torch.zeros(E, dtype=torch.int32, device=cuda)
    dst[E // 2:] = 1
    m = torch.zeros(E, device=cuda)
    m[E // 2:] = 2.0
    bi = torch.arange(2, dtype=torch.int32, device=cuda)
    na = torch.full((1,), 2, dtype=torch.int32, device=cuda)
    for op in ("max", "min"):
        for got in (kernel.fragment_spmv(w, src, dst, m, 3, op=op, table=table),
                    kernel.fragment_spmv_active(w, src, dst, m, bi, na, 3, op=op,
                                                table=table)):
            got = got.cpu()
            assert got[0] == 0.0 and got[1] == -2.0 and got[2] == ZERO[op]
    assert torch.signbit(kernel.fragment_spmv(w, src, dst, m, 3, op="max",
                                              table=table).cpu()[0])


@pytest.mark.parametrize("hot_share", [0.0, 1.0])
@pytest.mark.parametrize("skipping", ["off", "on"])
@pytest.mark.parametrize("op", OPS)
def test_dense_dispatch_by_hot_share_and_list_kernel(cuda, op, skipping, hot_share):
    """ops.fragment_spmv with the hot share below and above the threshold,
    skipping off and on: one hop launch, one list launch when skipping, the
    plain version's result."""
    x = _hot_inputs("zipf", op, 30_000, 8, cuda)
    blocks = tuple(torch.from_numpy(b).to(cuda) for b in active.block_ranges(x["src"].cpu()))
    before = kernel.LAUNCHES, kernel.ACTIVE_LAUNCHES, lkernel.LAUNCHES
    got = ops.fragment_spmv(x["w"], x["src"], x["dst"], x["m_dense"], x["n_dst"], op=op,
                            blocks=blocks, block_skipping=skipping, hot_share=hot_share)
    torch.cuda.synchronize()
    on = skipping == "on"
    assert (kernel.LAUNCHES, kernel.ACTIVE_LAUNCHES, lkernel.LAUNCHES) == (
        before[0] + (not on), before[1] + on, before[2] + on)
    want = ops.fragment_spmv(x["w"], x["src"], x["dst"], x["m_dense"], x["n_dst"], op=op,
                             blocks=blocks, block_skipping=skipping, hot_share=hot_share,
                             use_kernel=False)
    _assert_match(got, want, op)


LIST_SUPPORTS = ["empty", "full", "one_seed", 0.001, 0.1, 0.5]


def _list_frontier(n_src, rows, support, op, seed, device):
    rng = np.random.default_rng(seed)
    shape = (n_src,) if rows is None else (rows, n_src)
    w = np.full(shape, ZERO[op], np.float32)
    if support == "full":
        keep = np.ones(shape, bool)
    elif support == "empty":
        keep = np.zeros(shape, bool)
    elif support == "one_seed":
        keep = np.zeros(shape, bool)
        keep[..., rng.integers(0, n_src)] = True
    else:
        keep = rng.random(shape) < support
    w[keep] = 1.0 if op == "bool" else rng.random(int(keep.sum())) + 0.5
    return torch.from_numpy(w).to(device)


@pytest.mark.parametrize("nb", [1, 2, 7, 2049, 10_000])
@pytest.mark.parametrize("support", LIST_SUPPORTS)
@pytest.mark.parametrize("rows", [None, 8], ids=["single", "B8"])
@pytest.mark.parametrize("op", OPS)
def test_list_kernel_equals_plain(cuda, op, rows, support, nb):
    """The list kernel's (block_idx, n_active) and flags equal the plain
    list's, integer for integer: 1 and 2 blocks, a number that is not a power
    of two, 65 tiles of 32 blocks and one block more, 313 tiles (10,000
    blocks), over sources with gaps (every 7th degree 0)."""
    rng = np.random.default_rng(nb)
    n_src = nb * 50 + 64
    deg = rng.integers(0, 200, n_src)
    deg[::7] = 0
    src = np.repeat(np.arange(n_src, dtype=np.int32), deg)[: (nb - 1) * 4096 + 100]
    smin, smax = (torch.from_numpy(b).to(cuda) for b in active.block_ranges(src))
    assert smin.shape[0] == nb
    w = _list_frontier(n_src, rows, support, op, nb + len(op), cuda)
    want = active.active_block_list(w, ZERO[op], smin, smax)
    want_flags = active.active_flags(active.support_mask(w, ZERO[op]), smin, smax)
    for _ in range(2):  # the status words reset themselves between launches
        before = lkernel.LAUNCHES
        bi, na, fl = lkernel.block_list(w, ZERO[op], smin, smax, flags=True)
        torch.cuda.synchronize()
        assert lkernel.LAUNCHES == before + 1
        assert torch.equal(bi, want[0]) and torch.equal(na, want[1])
        assert torch.equal(fl, want_flags)
    bi, na = lkernel.block_list(w, ZERO[op], smin, smax)
    assert torch.equal(bi, want[0]) and torch.equal(na, want[1])


@pytest.mark.parametrize("nb", [3, 300])
@pytest.mark.parametrize("support", ["empty", "full", "one_seed", 0.0005])
@pytest.mark.parametrize("rows", [None, 8], ids=["single", "B8"])
@pytest.mark.parametrize("op", ["sum", "min"])
def test_list_kernel_long_ranges_equal_plain(cuda, op, rows, support, nb):
    """Blocks whose source ranges run over thousands of sources (one source
    in 500 has edges), so a warp's test takes many steps of 512 sources: the
    list and flags equal the plain list's."""
    rng = np.random.default_rng(nb + 1)
    n_src = nb * 4096 * 500 // 100
    deg = np.where(rng.random(n_src) < 1 / 500, 100, 0)
    src = np.repeat(np.arange(n_src, dtype=np.int32), deg)[: (nb - 1) * 4096 + 100]
    smin, smax = (torch.from_numpy(b).to(cuda) for b in active.block_ranges(src))
    assert smin.shape[0] == nb and int((smax - smin)[:-1].min()) > 1000  # but the last
    w = _list_frontier(n_src, rows, support, op, nb, cuda)
    want = active.active_block_list(w, ZERO[op], smin, smax)
    bi, na, fl = lkernel.block_list(w, ZERO[op], smin, smax, flags=True)
    torch.cuda.synchronize()
    assert torch.equal(bi, want[0]) and torch.equal(na, want[1])
    assert torch.equal(fl, active.active_flags(active.support_mask(w, ZERO[op]), smin, smax))


def test_list_kernel_on_two_streams_at_once(cuda):
    """List builds queued on two streams at once each get their own list:
    the status words belong to the stream, so concurrent launches do not
    share them."""
    rng = np.random.default_rng(11)
    n_src = 3_000_000
    src = np.repeat(np.arange(n_src, dtype=np.int32), rng.integers(0, 12, n_src))
    smin, smax = (torch.from_numpy(b).to(cuda) for b in active.block_ranges(src))
    frontiers = [_list_frontier(n_src, rows, support, "sum", k, cuda)
                 for k, (rows, support) in enumerate([(None, 0.001), (8, "one_seed"),
                                                      (None, "full"), (8, 0.0001)])]
    wants = [active.active_block_list(w, 0.0, smin, smax) for w in frontiers]
    flags = [active.active_flags(active.support_mask(w, 0.0), smin, smax) for w in frontiers]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    for _ in range(3):
        got = [[] for _ in frontiers]
        for rep in range(20):  # queue many builds on both streams before any ends
            for k, w in enumerate(frontiers):
                with torch.cuda.stream(streams[k % 2]):
                    got[k].append(lkernel.block_list(w, 0.0, smin, smax, flags=rep % 2 == 1))
        torch.cuda.synchronize()
        for k, want in enumerate(wants):
            for rep, out in enumerate(got[k]):
                assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
                if rep % 2:
                    assert torch.equal(out[2], flags[k])


def _tile_index(nb: int, seed: int, cuda):
    """An nb-block index over n_src = 50·nb + 8 sources (every 5th with no
    edges) and its block ranges on the card."""
    rng = np.random.default_rng(seed)
    n_src = 50 * nb + 8
    deg = rng.integers(80, 200, n_src - 1)
    deg[::5] = 0
    # the last block holds only the last source, which no other block has
    src = np.concatenate([np.repeat(np.arange(n_src - 1, dtype=np.int32), deg)[
        : (nb - 1) * 4096], np.full(5, n_src - 1, np.int32)])
    smin, smax = (torch.from_numpy(b).to(cuda) for b in active.block_ranges(src))
    assert smin.shape[0] == nb
    return n_src, smin, smax


def _flagged_frontier(n_src, rows, which, op, smin, smax, seed, cuda):
    """A frontier whose support flags no block, one block, every block or
    only the last one (the identity elsewhere); ``nan``: a NaN in one
    source (NaN is live) of the middle block, nothing else."""
    rng = np.random.default_rng(seed)
    B = 1 if rows is None else rows
    w = np.full((B, n_src), ZERO[op], np.float32)
    lo, hi = smin.cpu().numpy(), smax.cpu().numpy()
    nb = lo.shape[0]
    live = 1.0 if op == "bool" else 0.75
    if which == "one":
        b = int(rng.integers(0, nb))
        w[int(rng.integers(0, B)), int(rng.integers(lo[b], hi[b] + 1))] = live
    elif which == "all":
        w[rng.integers(0, B, n_src), np.arange(n_src)] = live
    elif which == "last":
        w[B - 1, hi[nb - 1]] = live  # the last source: the last block's alone
    elif which == "nan":
        b = nb // 2
        w[0, int(rng.integers(lo[b], hi[b] + 1))] = np.nan
    t = torch.from_numpy(w).to(cuda)
    return t[0] if rows is None else t


@pytest.mark.parametrize("nb", [1, 31, 32, 33, 64, 65, 7_079])
@pytest.mark.parametrize("which", ["none", "one", "all", "last", "nan"])
@pytest.mark.parametrize("rows", [None, 8, 64], ids=["single", "B8", "B64"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_list_kernel_at_tile_boundaries(cuda, op, rows, which, nb):
    """The single-pass list kernel (a CTA a tile of block_list.TILE blocks,
    placed by decoupled look-back) at one block, a tile's size ±1, two tiles
    ±1 and I_DT.Term's 7,079 blocks, with no, one, every and only the last
    block flagged, and a NaN source, for 1, 8 and 64 rows: block_idx,
    n_active and the flags equal the plain list's, id for id."""
    assert lkernel.TILE == 32
    n_src, smin, smax = _tile_index(nb, nb + (rows or 0), cuda)
    w = _flagged_frontier(n_src, rows, which, op, smin, smax, nb + len(which), cuda)
    want = active.active_block_list(w, ZERO[op], smin, smax)
    want_flags = active.active_flags(active.support_mask(w, ZERO[op]), smin, smax)
    # one source may lie in two blocks (a range shares its first with the
    # range before)
    assert int(want[1][0]) in {"none": (0,), "one": (1, 2), "all": (nb,), "last": (1,),
                               "nan": (1, 2)}[which]
    before = lkernel.LAUNCHES
    bi, na, fl = lkernel.block_list(w, ZERO[op], smin, smax, flags=True)
    torch.cuda.synchronize()
    assert lkernel.LAUNCHES == before + 1
    assert torch.equal(bi, want[0]) and torch.equal(na, want[1])
    assert torch.equal(fl, want_flags)


def test_list_kernel_reuses_its_status_words_back_to_back(cuda):
    """Launches of every size in turn on one stream, none waited for, reuse
    the stream's status buffer (each launch leaves it zero): every list
    equals the plain list, and the buffers are zero after."""
    from repro_torch.kernels import cuda_build

    cases = []
    for k, nb in enumerate([7_079, 33, 1, 7_079, 32, 2_049, 65]):
        n_src, smin, smax = _tile_index(nb, 100 + k, cuda)
        w = _list_frontier(n_src, None if k % 2 else 8, [0.001, "one_seed", "full"][k % 3],
                           "sum", k, cuda)
        cases.append((w, smin, smax, active.active_block_list(w, 0.0, smin, smax)))
    torch.cuda.synchronize()
    got = [lkernel.block_list(w, 0.0, smin, smax) for _ in range(3)
           for w, smin, smax, _ in cases]
    torch.cuda.synchronize()
    for i, (bi, na) in enumerate(got):
        want = cases[i % len(cases)][3]
        assert torch.equal(bi, want[0]) and torch.equal(na, want[1]), i
    bufs = [b for (name, _, _), b in cuda_build._STREAM_SCRATCH.items()
            if name.startswith("block_list")]
    assert bufs and all(int(b.abs().sum()) == 0 for b in bufs)


def test_list_kernel_rejects_bad_inputs(cuda):
    w = torch.ones(100, device=cuda)
    smin = torch.zeros(3, dtype=torch.int32, device=cuda)
    smax = torch.full((3,), 99, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        lkernel.block_list(w.cpu(), 0.0, smin, smax)
    with pytest.raises(TypeError):
        lkernel.block_list(w.double(), 0.0, smin, smax)
    with pytest.raises(TypeError):
        lkernel.block_list(w, 0.0, smin.long(), smax)
    with pytest.raises(ValueError):
        lkernel.block_list(w, 0.0, smin, smax[:2])
    with pytest.raises(ValueError):
        lkernel.block_list(w, 0.0, smin[:0], smax[:0])
    with pytest.raises(ValueError):
        lkernel.block_list(w.reshape(2, 5, 10), 0.0, smin, smax)


# ---------------------------------------------------------------------------
# The batched hops' row-chunk body: the scratch a row chunk a sector, the
# per-CTA table with a row chunk a slot, one wave over the list
# ---------------------------------------------------------------------------

#: 1 and 2 rows; 3 (a 4-row chunk, one row past B); 8 (one chunk); 13 and 65
#: (a last chunk of 5 rows, of 1 row); 64 (eight chunks)
ROW_BATCHES = [1, 2, 3, 8, 13, 64, 65]


def _hot_rows(case, op, B, E, seed, device):
    """_hot_inputs with B frontier rows (_rows) and the block list of their
    union."""
    x = _hot_inputs(case, op, E, seed, device)
    W = _rows(x["w"], B, op, seed + B)
    return x, W, _union_list(W, x["src"], op, device)


def _spmm_forms(x, W, bi, na, op, table, m, nb):
    """The dense scan and active kernels (following the list, and in scan
    order) in one form."""
    kw = dict(op=op, table=table)
    return [skernel.fragment_spmm(W, x["src"], x["dst"], m, x["n_dst"], **kw)] + [
        skernel.fragment_spmm_active(W, x["src"], x["dst"], m, bi, na, x["n_dst"],
                                     scan_above=sa, **kw) for sa in (nb, 0)]


@pytest.mark.parametrize("case", ["one_dst", "zipf"])
@pytest.mark.parametrize("measure", ["none", "shared", "per_row"])
@pytest.mark.parametrize("B", ROW_BATCHES)
@pytest.mark.parametrize("table", [True, False], ids=["table", "per_edge"])
@pytest.mark.parametrize("op", OPS)
def test_spmm_both_forms_match_plain(cuda, op, table, B, measure, case):
    """The dense SpMM, scan and active (the list followed, and in scan order),
    with the table and without, on one hot destination and on Zipf-hot ones,
    at row counts that are not multiples of the vector width and of more than
    one chunk, with no, a shared and a per-row measure, against the plain
    version."""
    E = 30_000
    x, W, (bi, na) = _hot_rows(case, op, B, E, B + len(op) + len(case), cuda)
    m = {"none": None, "shared": x["m_dense"],
         "per_row": torch.rand((B, E), generator=torch.Generator().manual_seed(B)).to(cuda)
         }[measure]
    nb = active.n_edge_blocks(E)
    before = _spmm_counts()
    got = _spmm_forms(x, W, bi, na, op, table, m, nb)
    torch.cuda.synchronize()
    assert _delta(before) == [1, 2, 0, 0, 0, 0]
    want = ref.fragment_spmm_ref(W, x["src"], x["dst"], m, x["n_dst"], op=op)
    for g in got:
        _assert_match(g, want, op)


@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("B", ROW_BATCHES)
@pytest.mark.parametrize("table", [True, False], ids=["table", "per_edge"])
@pytest.mark.parametrize("op", OPS)
def test_spmm_packed_both_forms_match_plain(cuda, op, table, B, m_mode, dst_packed):
    """The decode-fused SpMM, scan and active (the list followed, and in scan
    order), with the table and without, on Zipf-hot destinations, for every
    measure mode and dst stream, against the plain version."""
    E = 30_000
    x, W, (bi, na) = _hot_rows("zipf", op, B, E, 2 * B + len(op), cuda)
    dst, m, md, kw = _hot_operands(x, m_mode, dst_packed)
    nb = active.n_edge_blocks(E)
    before = _spmm_counts()
    got = [spkernel.fragment_spmm_packed(W, x["src"], dst, m, md, op=op, table=table, **kw)]
    got += [spkernel.fragment_spmm_packed_active(W, x["src"], dst, m, md, bi, na, op=op,
                                                 scan_above=sa, table=table, **kw)
            for sa in (nb, 0)]
    torch.cuda.synchronize()
    assert _delta(before) == [0, 0, 1, 2, 0, 0]
    want = ref.fragment_spmm_packed_ref(W, x["src"], dst, m, md, op=op, **kw)
    for g in got:
        _assert_match(g, want, op)


@pytest.mark.parametrize("B", [1, 2, 4, 8, 13])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("table", [True, False], ids=["table", "per_edge"])
def test_spmm_negative_zero_in_both_forms(cuda, table, packed, B):
    """-0.0 products (a −∞ identity for max) reach Y with their sign bit
    through the scratch and the table, every row, at every chunk width; for
    sum a row of zero products stays +0.0 beside live rows."""
    E = 5000
    W = torch.full((B, 1), -1.0, device=cuda)
    src = torch.zeros(E, dtype=torch.int32, device=cuda)
    dst = torch.zeros(E, dtype=torch.int32, device=cuda)
    dst[E // 2:] = 1
    m = torch.zeros(E, device=cuda)
    m[E // 2:] = 2.0
    bi = torch.arange(2, dtype=torch.int32, device=cuda)
    na = torch.full((1,), 2, dtype=torch.int32, device=cuda)

    def both(op, W):
        if packed:
            kw = dict(op=op, table=table, m_mode="dense")
            return (spkernel.fragment_spmm_packed(W, src, dst, m, None, 3, **kw),
                    spkernel.fragment_spmm_packed_active(W, src, dst, m, None, bi, na, 3, **kw))
        return (skernel.fragment_spmm(W, src, dst, m, 3, op=op, table=table),
                skernel.fragment_spmm_active(W, src, dst, m, bi, na, 3, op=op, table=table))

    for op in ("max", "min"):
        for got in both(op, W):
            got = got.cpu()
            assert (got[:, 0] == 0.0).all() and (got[:, 1] == -2.0).all()
            assert (got[:, 2] == ZERO[op]).all()
            if op == "max":
                assert torch.signbit(got[:, 0]).all()
    Ws = W.clone()
    Ws[::2] = 0.0  # every other row adds nothing
    for got in both("sum", Ws):
        got = got.cpu()
        assert not torch.signbit(got[::2]).any() and not torch.signbit(got[:, [0, 2]]).any()
        assert (got[::2] == 0.0).all() and (got[1::2, 1] == -2.0 * (E - E // 2)).all()


@pytest.mark.parametrize("B", [8, 13])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("table", [True, False], ids=["table", "per_edge"])
@pytest.mark.parametrize("scan_order", [False, True], ids=["listed", "scan_order"])
@pytest.mark.parametrize("op", OPS)
def test_spmm_active_wave_covers_more_blocks_than_one_wave(cuda, op, scan_order, table,
                                                           packed, B):
    """Both active SpMM kernels run one wave of CTAs divided among the row
    chunks (the per-edge form each over every gridDim.y-th listed block, the
    table form each over a run of consecutive listed blocks): an index with
    more blocks than a wave holds, every other block listed (or all, in scan
    order)."""
    E = 5_000_000  # 1,221 blocks
    x = _hot_inputs("zipf", op, E, 9, cuda)
    W = _rows(x["w"], B, op, 11)
    nb = active.n_edge_blocks(E)
    bi = torch.arange(0, nb, 2, dtype=torch.int32, device=cuda)
    na = torch.full((1,), bi.shape[0], dtype=torch.int32, device=cuda)
    sa = 0 if scan_order else nb
    if packed:
        dst, m, md, kw = _hot_operands(x, "packed", True)
        got = spkernel.fragment_spmm_packed_active(W, x["src"], dst, m, md, bi, na, op=op,
                                                   scan_above=sa, table=table, **kw)
        want = ref.fragment_spmm_packed_active_ref(W, x["src"], dst, m, md, bi, na, op=op,
                                                   scan_above=sa, **kw)
    else:
        got = skernel.fragment_spmm_active(W, x["src"], x["dst"], x["m_dense"], bi, na,
                                           x["n_dst"], op=op, scan_above=sa, table=table)
        want = ref.fragment_spmm_active_ref(W, x["src"], x["dst"], x["m_dense"], bi, na,
                                            x["n_dst"], op=op, scan_above=sa)
    torch.cuda.synchronize()
    _assert_match(got, want, op)


_SPMM_BUILDS: dict = {}


def _spmm_table_build(lib, bits: int, probes: int):
    """A batched kernel library built with another table shape (``-D``
    overrides of ``csrc/hop.cuh``), in a library file of its own."""
    from repro_torch.kernels.cuda_build import CudaLibrary

    key = (lib.name, bits, probes)
    if key not in _SPMM_BUILDS:
        _SPMM_BUILDS[key] = CudaLibrary(
            lib.name, lib.functions,
            defines=(f"SPMM_TABLE_BITS={bits}", f"HOP_TABLE_PROBES={probes}"))
    return _SPMM_BUILDS[key]


@pytest.mark.parametrize("B", [2, 4, 13])
@pytest.mark.parametrize("shape", ["off", "built", "2x1", "1024x4", "4096x2"])
@pytest.mark.parametrize("case", HOT_CASES)
@pytest.mark.parametrize("op", OPS)
def test_spmm_result_does_not_depend_on_the_table(cuda, monkeypatch, op, case, shape, B):
    """No table, the built table and builds at other sizes (at every row
    chunk) and probe limits give the plain version's result for all four
    SpMM kernels at B = 2, 4 and 13 (rb = 2, 4 and two chunks of 8): an edge
    without a slot writes its chunk to the scratch."""
    if "x" in shape:
        slots, probes = (int(v) for v in shape.split("x"))
        for mod in (skernel, spkernel):
            monkeypatch.setattr(mod, "LIB", _spmm_table_build(mod.LIB, slots.bit_length() - 1,
                                                              probes))
    E = 20_000
    x = _hot_inputs(case, op, E, 5, cuda)
    W = _rows(x["w"], B, op, 6)
    table = shape != "off"
    bi, na = _full(E, cuda)
    m = x["m_dense"]
    want = ref.fragment_spmm_ref(W, x["src"], x["dst"], m, x["n_dst"], op=op)
    _assert_match(skernel.fragment_spmm(W, x["src"], x["dst"], m, x["n_dst"], op=op,
                                        table=table), want, op)
    _assert_match(skernel.fragment_spmm_active(W, x["src"], x["dst"], m, bi, na, x["n_dst"],
                                               op=op, table=table), want, op)
    dst, pm, md, kw = _hot_operands(x, "packed", True)
    want = ref.fragment_spmm_packed_ref(W, x["src"], dst, pm, md, op=op, **kw)
    _assert_match(spkernel.fragment_spmm_packed(W, x["src"], dst, pm, md, op=op, table=table,
                                                **kw), want, op)
    _assert_match(spkernel.fragment_spmm_packed_active(W, x["src"], dst, pm, md, bi, na, op=op,
                                                       table=table, **kw), want, op)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hot_share", [0.0, 1.0])
@pytest.mark.parametrize("skipping", ["off", "on"])
@pytest.mark.parametrize("op", OPS)
def test_spmm_dispatch_by_hot_share(cuda, op, skipping, hot_share):
    """ops.fragment_spmm and ops.fragment_spmm_packed with the hot share below
    and above the threshold, skipping off and on: one SpMM launch each, the
    plain version's result."""
    x = _hot_inputs("zipf", op, 30_000, 12, cuda)
    W = _rows(x["w"], 8, op, 13)
    blocks = tuple(torch.from_numpy(b).to(cuda) for b in active.block_ranges(x["src"].cpu()))
    dst, m, md, kw = _hot_operands(x, "packed", True)
    common = dict(op=op, blocks=blocks, block_skipping=skipping, hot_share=hot_share)
    on = skipping == "on"
    before = _spmm_counts()
    got = [ops.fragment_spmm(W, x["src"], x["dst"], x["m_dense"], x["n_dst"], **common),
           ops.fragment_spmm_packed(W, x["src"], dst, m, md, **kw, **common)]
    torch.cuda.synchronize()
    assert _delta(before) == [int(not on), int(on), int(not on), int(on), 0, 0]
    want = [ops.fragment_spmm(W, x["src"], x["dst"], x["m_dense"], x["n_dst"],
                              use_kernel=False, **common),
            ops.fragment_spmm_packed(W, x["src"], dst, m, md, use_kernel=False, **kw, **common)]
    for g, w in zip(got, want):
        _assert_match(g, w, op)


# ---------------------------------------------------------------------------
# The fused regions' table form: each hop phase aggregates per CTA in a
# shared-memory table (fused2: table1 / table2; fused1: table), in both
# forms; the SpMM form on the row-chunk scratch
# ---------------------------------------------------------------------------

N_HOT = 20_000  # the hot regions' mid and output domains: more ids than slots
REGION_VARIANTS = ["two_hop", "two_hop_mask", "two_hop_binarize", "two_hop_mask_binarize",
                   "degenerate", "degenerate_mask"]
FUSED_BATCHES = [1, 2, 5, 8]


def _hot_dst(case, n, E, rng):
    """Destinations that stress the table: 40% of the edges on id 7 ("hot"),
    or every id in turn, so a block has more distinct ids than slots
    ("overflow")."""
    if case == "hot":
        d = rng.integers(0, n, E)
        d[rng.random(E) < 0.4] = 7
    else:
        d = np.concatenate([rng.permutation(n) for _ in range(E // n + 1)])[:E]
    return d.astype(np.int32)


def _hot_region(case, op, E, m_mode, dst_packed, seed, device):
    """hop1 3000 → N_HOT (E edges), hop2 N_HOT → N_HOT (E + 3 edges), both
    with _hot_dst destinations (15-bit words when packed) and the measure
    mode of _packed_inputs; a mask over the N_HOT mid ids."""
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    x1 = _packed_inputs(op, E, seed, device)
    hops = []
    for x in (x1, _packed_inputs(op, E + 3, seed + 2, device, n_src=N_HOT)):
        d = _hot_dst(case, N_HOT, x["src"].shape[0], rng)
        hops.append(_streams(x, m_mode, dst_packed, x["src"], t(d),
                             t(_pack_words(d, 15).view(np.int32)), 15))
    keep = t((rng.random(N_HOT) < 0.6).astype(np.float32))
    return x1["w"], hops[0], hops[1], keep


def _variant(variant, keep):
    """(two hops, mid or output mask, binarize) of a REGION_VARIANTS entry."""
    two = variant.startswith("two_hop")
    return two, keep if "mask" in variant else None, variant.endswith("binarize")


def _unfused_table(x, h1, h2, mask, binz, op):
    """The region through the unfused packed kernels in the table form (the
    SpMM kernels for [B, n] rows)."""
    hop = spkernel.fragment_spmm_packed if x.dim() == 2 else pkernel.fragment_spmv_packed

    def run(v, h):
        return hop(v, h.src, h.dst, h.measure, h.mdict, N_HOT, dst_width=h.dst_width,
                   m_mode=h.m_mode, m_width=h.m_width, op=op, table=True)

    u = run(x, h1)
    if mask is not None:
        u = ref.apply_mask(u, mask, op)
    if h2 is None:
        return u
    return run(ref.binarize(u, op) if binz else u, h2)


def _table_counts():
    return dict(fkernel.TABLE_LAUNCHES)


@pytest.mark.parametrize("variant", REGION_VARIANTS)
@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("op", OPS)
def test_fused_table_forms_match_plain_and_unfused(cuda, op, m_mode, dst_packed, variant):
    """Both fused kernels (SpMV form) with the table in hop 1, hop 2 or both
    against the plain region and the unfused packed kernels in the table
    form, at E = 1 and 4097, on a hot destination and on more distinct
    destinations than slots (the bounded probe writes the rest to global
    memory)."""
    for case in ("hot", "overflow"):
        for E in (1, 4097):
            w, h1, h2, keep = _hot_region(case, op, E, m_mode, dst_packed, E + len(op), cuda)
            two, mask, binz = _variant(variant, keep)
            bi1, na1 = _full(E, cuda)
            bi2, na2 = _full(E + 3, cuda)
            want = ref.fragment_spmv_fused_ref(w, h1, h2 if two else None, mask, N_HOT, N_HOT,
                                               op=op, mid_binarize=binz)
            unf = _unfused_table(w, h1, h2 if two else None, mask, binz, op)
            for flags in ((True, False), (False, True), (True, True)) if two else ((True,),):
                before, tb = _fused_counts(), _table_counts()
                if two:
                    got = fkernel.fragment_spmv_fused2(w, h1, h2, mask, bi1, na1, bi2, na2,
                                                       N_HOT, N_HOT, op=op, mid_binarize=binz,
                                                       table1=flags[0], table2=flags[1])
                else:
                    got = fkernel.fragment_spmv_fused1(w, h1, mask, bi1, na1, N_HOT, op=op,
                                                       table=True)
                torch.cuda.synchronize()
                k = "fragment_spmv_fused2" if two else "fragment_spmv_fused1"
                assert [b - a for a, b in zip(before, _fused_counts())] == (
                    [0, 1] if two else [1, 0])
                assert fkernel.TABLE_LAUNCHES[k] == tb[k] + 1
                _assert_match(got, want, op)
                _assert_match(got, unf, op)
                if case == "hot" and E > 1:
                    assert (got != ZERO[op]).any()


@pytest.mark.parametrize("variant", REGION_VARIANTS)
@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("B", FUSED_BATCHES)
@pytest.mark.parametrize("op", OPS)
def test_spmm_fused_table_forms_match_plain_and_unfused(cuda, op, B, m_mode, dst_packed,
                                                        variant):
    """The fused regions' SpMM form on the row-chunk scratch, per edge and
    with the table in either hop or both, against the plain batched region
    and the unfused SpMM kernels in the table form, at B = 1 (the SpMV
    form), 2, 5 (a 4-row chunk and a 1-row one) and 8, one row that never
    writes (all identity), on a hot destination and on more distinct
    destinations than slots, at E = 1 and 4097."""
    for case in ("hot", "overflow"):
        for E in (1, 4097):
            w, h1, h2, keep = _hot_region(case, op, E, m_mode, dst_packed, E + B + len(op),
                                          cuda)
            W = _rows(w, B, op, B + 31)
            if B > 1:
                W[1] = ZERO[op]  # a row that never writes
            two, mask, binz = _variant(variant, keep)
            bi1, na1 = _full(E, cuda)
            bi2, na2 = _full(E + 3, cuda)
            want = ref.fragment_spmm_fused_ref(W, h1, h2 if two else None, mask, N_HOT, N_HOT,
                                               op=op, mid_binarize=binz)
            unf = _unfused_table(W, h1, h2 if two else None, mask, binz, op)
            flag_sets = (((False, False), (True, False), (False, True), (True, True)) if two
                         else ((False,), (True,)))
            for flags in flag_sets:
                before = _spmm_counts()
                if two:
                    got = fkernel.fragment_spmm_fused2(W, h1, h2, mask, bi1, na1, bi2, na2,
                                                       N_HOT, N_HOT, op=op, mid_binarize=binz,
                                                       table1=flags[0], table2=flags[1])
                else:
                    got = fkernel.fragment_spmm_fused1(W, h1, mask, bi1, na1, N_HOT, op=op,
                                                       table=flags[0])
                torch.cuda.synchronize()
                assert _delta(before) == ([0, 0, 0, 0, 0, 1] if two else [0, 0, 0, 0, 1, 0])
                _assert_match(got, want, op)
                _assert_match(got, unf, op)
                if B > 1:
                    assert (got[1] == ZERO[op]).all()
                    if op == "sum":  # +0.0 added to a row that does not write
                        assert not torch.signbit(got[1]).any()


@pytest.mark.parametrize("listed", ["one_block", "every_other"])
@pytest.mark.parametrize("B", [None, 8], ids=["spmv", "B8"])
@pytest.mark.parametrize("table", [True, False], ids=["table", "per_edge"])
@pytest.mark.parametrize("op", OPS)
def test_fused1_one_wave_over_a_long_list(cuda, op, table, B, listed):
    """fused1 runs one wave of CTAs over the list: on a large index (1,221
    blocks) with one listed block, and with every other block listed (more
    than a wave), in both forms, against the plain region."""
    E = 5_000_000
    x = _hot_inputs("zipf", op, E, 9, cuda)
    dst, m, md, kw = _hot_operands(x, "packed", True)
    h = ref.HopStreams(x["src"], dst, m, md, kw["dst_width"], "packed", kw["m_width"])
    nb = active.n_edge_blocks(E)
    bi = (torch.tensor([nb // 2], dtype=torch.int32, device=cuda) if listed == "one_block"
          else torch.arange(0, nb, 2, dtype=torch.int32, device=cuda))
    na = torch.full((1,), bi.shape[0], dtype=torch.int32, device=cuda)
    keep = (torch.arange(x["n_dst"], device=cuda) % 3 != 0).to(torch.float32)
    lists = (bi, na, None, None)
    if B is None:
        got = fkernel.fragment_spmv_fused1(x["w"], h, keep, bi, na, x["n_dst"], op=op,
                                           table=table)
        want = ref.fragment_spmv_fused_ref(x["w"], h, None, keep, x["n_dst"], x["n_dst"],
                                           op=op, lists=lists)
    else:
        W = _rows(x["w"], B, op, 3)
        got = fkernel.fragment_spmm_fused1(W, h, keep, bi, na, x["n_dst"], op=op, table=table)
        want = ref.fragment_spmm_fused_ref(W, h, None, keep, x["n_dst"], x["n_dst"], op=op,
                                           lists=lists)
    torch.cuda.synchronize()
    _assert_match(got, want, op)


@pytest.mark.parametrize("form", ["spmv", "rows_2", "rows_4", "rows_8"])
def test_fused2_grid_with_the_table_is_never_refused(cuda, form):
    """max_grid with the table's shared memory counted is positive and at
    most the grid without it; a region whose lists want more CTAs than that
    (a 5M-edge hop 1) launches at that grid with both tables and matches the
    plain region."""
    rows = 1 if form == "spmv" else int(form.split("_")[1])
    batched = form != "spmv"
    for op in OPS:
        g_table = fkernel.max_grid(op, batched=batched, table=True, rows=rows)
        g_edge = fkernel.max_grid(op, batched=batched, table=False, rows=rows)
        assert 0 < g_table <= g_edge
    E = 5_000_000
    x = _hot_inputs("zipf", "sum", E, 4, cuda)
    dst, m, md, kw = _hot_operands(x, "dense", False)
    h1 = ref.HopStreams(x["src"], dst, m, md, 0, "dense", 0)
    assert active.n_edge_blocks(E) > fkernel.max_grid("sum", batched=batched, table=True,
                                                      rows=rows)
    y = _packed_inputs("sum", 60_000, 5, cuda, n_src=x["n_dst"])
    d2 = _hot_dst("hot", 500, 60_000, np.random.default_rng(6))
    h2 = ref.HopStreams(y["src"], torch.from_numpy(d2).to(cuda), None, None, 0, "none", 0)
    bi1, na1 = _full(E, cuda)
    bi2, na2 = _full(60_000, cuda)
    w = _rows(x["w"], rows, "sum", 8) if batched else x["w"]
    fn = fkernel.fragment_spmm_fused2 if batched else fkernel.fragment_spmv_fused2
    got = fn(w, h1, h2, None, bi1, na1, bi2, na2, x["n_dst"], 500, table1=True, table2=True)
    plain = ref.fragment_spmm_fused_ref if batched else ref.fragment_spmv_fused_ref
    want = plain(w, h1, h2, None, x["n_dst"], 500)
    torch.cuda.synchronize()
    _assert_match(got, want, "sum")


@pytest.mark.parametrize("batched", [False, True], ids=["spmv", "B8"])
@pytest.mark.parametrize("hot_share", [0.0, 1.0])
@pytest.mark.parametrize("op", OPS)
def test_fused_dispatch_chooses_the_table_by_hot_share(cuda, op, hot_share, batched):
    """ops.fragment_spmv_fused / fragment_spmm_fused with both hops' hot
    shares below and above the threshold: one fused launch each, with the
    table exactly when above, equal to the plain region."""
    w, h1, h2, keep = _hot_region("hot", op, 30_000, "packed", True, 14, cuda)
    if batched:
        w = _rows(w, 8, op, 15)
    mk = lambda h, n: ops.FusedHopOperands(  # noqa: E731
        h.src, h.dst, h.measure, h.mdict, n, h.dst_width, h.m_mode, h.m_width,
        hot_share=hot_share)
    o1, o2 = mk(h1, N_HOT), mk(h2, N_HOT)
    entry = ops.fragment_spmm_fused if batched else ops.fragment_spmv_fused
    for two in (True, False):
        k = ("fragment_spmm_fused" if batched else "fragment_spmv_fused") + ("2" if two else "1")
        tb = _table_counts()
        got = entry(w, o1, o2 if two else None, keep, op=op, mid_binarize=two, fusion="on")
        torch.cuda.synchronize()
        assert fkernel.TABLE_LAUNCHES[k] - tb[k] == int(hot_share > 0)
        want = entry(w, o1, o2 if two else None, keep, op=op, mid_binarize=two, fusion="on",
                     use_kernel=False)
        _assert_match(got, want, op)


@pytest.mark.parametrize("batched", [False, True], ids=["spmv", "B8"])
@pytest.mark.parametrize("op", OPS)
def test_fused_kernels_read_the_float_mask_as_bytes(cuda, op, batched):
    """Both fused kernels read the mask as one byte an entry, converted by
    the wrapper from the float32 mask (keep > 0, once a tensor): zero and
    negative entries are masked, and the result equals the plain region."""
    w, h1, h2, keep = _hot_region("hot", op, 4097, "packed", True, 7, cuda)
    keep = keep - 0.5 * (keep == 0).to(torch.float32)  # negative entries are masked too
    if batched:
        w = _rows(w, 8, op, 9)
    bi1, na1 = _full(4097, cuda)
    bi2, na2 = _full(4100, cuda)
    f1 = fkernel.fragment_spmm_fused1 if batched else fkernel.fragment_spmv_fused1
    f2 = fkernel.fragment_spmm_fused2 if batched else fkernel.fragment_spmv_fused2
    plain = ref.fragment_spmm_fused_ref if batched else ref.fragment_spmv_fused_ref
    for two in (True, False):
        want = plain(w, h1, h2 if two else None, keep, N_HOT, N_HOT, op=op, mid_binarize=two)
        if two:
            got = f2(w, h1, h2, keep, bi1, na1, bi2, na2, N_HOT, N_HOT, op=op,
                     mid_binarize=True, table1=True, table2=True)
        else:
            got = f1(w, h1, keep, bi1, na1, N_HOT, op=op, table=True)
        torch.cuda.synchronize()
        _assert_match(got, want, op)


SCALAR_CASES = [c for c in CASES if c[0] in ("SD", "FSD", "AS")] + [
    ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 7}),
]


def _hop_launches():
    """Every single-query and batched hop kernel's launches, fused included."""
    from repro_torch.kernels import fragment_spmm as mkernel
    from repro_torch.kernels import fragment_spmm_packed as mpkernel

    return (kernel.LAUNCHES + kernel.ACTIVE_LAUNCHES + pkernel.LAUNCHES
            + pkernel.ACTIVE_LAUNCHES + sum(_fused_counts()) + mkernel.LAUNCHES
            + mkernel.ACTIVE_LAUNCHES + mpkernel.LAUNCHES + mpkernel.ACTIVE_LAUNCHES
            + fkernel.SPMM_FUSED1_LAUNCHES + fkernel.SPMM_FUSED2_LAUNCHES)


@pytest.mark.parametrize("name,q,params", SCALAR_CASES, ids=[c[0] for c in SCALAR_CASES])
def test_scalar_walk_on_the_card_matches_cpu(cuda, name, q, params):
    """fragment_loop's walk on the card: the same paths as on the CPU (counts
    exact, sums within the gate), single and batched, no hop kernel
    launched, and no packed column decoded whole."""
    from repro_torch.storage import device_space_report

    schema = _schema(name)
    gpu_db = GQFastDatabase(schema, account_space=False, device=cuda)
    gpu = GQFastEngine(gpu_db, strategy="fragment_loop")
    cpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu"),
                       strategy="fragment_loop")
    key = next(iter(params))
    rows = {key: [params[key], params[key] + 1, params[key] + 2]}
    before = _hop_launches()
    got, got_b = gpu.query(q, **params), gpu.prepare(q).execute_batch(**rows)
    assert _hop_launches() == before
    assert device_space_report(gpu_db.device)["materialized_bytes"] == 0
    want, want_b = cpu.query(q, **params), cpu.prepare(q).execute_batch(**rows)
    if name == "SD":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_b, want_b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, run_sql(schema, q, params), rtol=1e-4, atol=1e-4)
    assert (got != 0).any()


@pytest.mark.parametrize("strategy", ["frontier", "fragment_loop"])
@pytest.mark.parametrize("name,q,params", [c for c in CASES if c[0] in ("SD", "AS", "AD")],
                         ids=["SD", "AS", "AD"])
def test_profile_on_the_card(cuda, strategy, name, q, params):
    """profile() on the card: its result against __call__ (counts exact), the
    self walls summing to the total, and the observed fractions equal to
    the same walk on the CPU."""
    from repro_torch.obs.profile import observed_hop_fractions

    schema = _schema(name)
    pq = GQFastEngine(GQFastDatabase(schema, account_space=False, device=cuda),
                      strategy=strategy).prepare(q)
    prof = pq.profile(reps=2, **params)
    if name in ("SD", "AD"):
        np.testing.assert_array_equal(prof.result, pq(**params))
    np.testing.assert_allclose(prof.result, pq(**params), rtol=1e-4, atol=1e-4)
    walls = [o.wall_ms for o in prof.ops if o.wall_ms is not None]
    assert abs(sum(walls) - prof.total_wall_ms) <= 1e-6 * prof.total_wall_ms
    cpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu"),
                       strategy=strategy).prepare(q)
    assert ([h.meta["touched_edges"] for h in prof.hops]
            == [h["touched_edges"] for h in observed_hop_fractions(cpu.phys, params)])


# ---------------------------------------------------------------------------
# CRC-32C and the durability layer on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 9, 15, 16, 17, 511, 512, 513, 4095, 4096,
                               4097, 2**20 + 3, 5_000_011])
def test_crc32c_kernel_matches_plain(cuda, n):
    """The kernel against its plain version (which equals the reference's
    values, tests/test_torch_snapshot.py) at every offset mod 16 of the
    stream and from a previous value."""
    rng = np.random.default_rng(n)
    raw = torch.tensor(rng.integers(0, 256, n + 16, dtype=np.uint8), device=cuda)
    for off in (0, 1, 5, 15):
        data = raw[off:off + n]
        for value in (0, int(rng.integers(0, 2**32))):
            before = ckernel.LAUNCHES
            got = ckernel.crc32c(data, value)
            torch.cuda.synchronize()
            assert ckernel.LAUNCHES == before + (n > 0)
            assert int(got) == int(ref.crc32c_ref(data, value)) == \
                int(ref.crc32c_ref(data.cpu(), value)), (n, off, value)


def test_crc32c_kernel_check_value_and_chain(cuda):
    data = torch.tensor(list(b"123456789"), dtype=torch.uint8, device=cuda)
    assert int(ops.crc32c(data)) == 0xE3069283
    words = torch.tensor(np.random.default_rng(0).integers(-2**31, 2**31, 300_001),
                         dtype=torch.int32, device=cuda)
    whole = int(ops.crc32c(words))
    head = int(ops.crc32c(words[:1000]))
    assert int(ops.crc32c(words[1000:], head)) == whole
    with pytest.raises(ValueError):
        ckernel.crc32c(words[::2])  # not contiguous


#: Lengths at the kernel's boundaries: a warp's tile (512 bytes), a CTA's
#: step (32 tiles, 16 KiB), a wave's step (132 CTAs on an H100) and a lane's
#: kUnroll = 4 steps, each ±1 and ±16 (one uint4).
CRC_BOUNDARIES = [496, 511, 512, 513, 528, 16_368, 16_383, 16_384, 16_385, 16_400,
                  132 * 16_384 - 16, 132 * 16_384 - 1, 132 * 16_384, 132 * 16_384 + 1,
                  132 * 16_384 + 16, 4 * 132 * 16_384 - 1, 4 * 132 * 16_384 + 17,
                  5 * 132 * 16_384 + 3]


@pytest.mark.parametrize("n", CRC_BOUNDARIES)
def test_crc32c_kernel_at_tile_and_wave_boundaries(cuda, n):
    """The kernel at every offset 0-15 of the stream (the head, the body of
    16-byte units, the tail) and at lengths around its tile, CTA, wave and
    unroll boundaries, from 0 and from a previous value, equal to the plain
    version; and chained: the CRC of the whole equals the CRC of its second
    part continuing from its first's, cut anywhere."""
    rng = np.random.default_rng(n)
    raw = torch.tensor(rng.integers(0, 256, n + 16, dtype=np.uint8), device=cuda)
    for off in range(16):
        data = raw[off:off + n]
        value = int(rng.integers(0, 2**32))
        got = [int(ckernel.crc32c(data, v)) for v in (0, value)]
        assert got == [int(ref.crc32c_ref(data, v)) for v in (0, value)], (n, off)
        cut = int(rng.integers(0, n + 1))
        head = int(ckernel.crc32c(data[:cut], value)) if cut else value
        assert int(ops.crc32c(data[cut:], head)) == got[1], (n, off, cut)


def test_crc32c_kernel_on_the_store_parts(cuda):
    """Every encoded part and decoded view of a PubMed store on the card
    (what manifests, verified reads and the scrubber hash), and their
    concatenation chained part by part, equal to the plain version."""
    from repro_torch.storage import decode_fresh, encoded_parts, iter_columns

    schema = SG.make_pubmed(n_docs=20_000, n_terms=600, n_authors=4_000, seed=9)
    db = GQFastDatabase(schema, device=cuda)
    chained, want = 0, 0
    n = 0
    for _, _, _, col in iter_columns(db.device):
        for part in list(encoded_parts(col)) + [decode_fresh(col)]:
            b = ckernel.as_bytes(part.contiguous())
            assert int(ckernel.crc32c(b)) == int(ref.crc32c_ref(b))
            chained = int(ckernel.crc32c(b, chained))
            want = int(ref.crc32c_ref(b, want))
            n += 1
    assert n > 10 and chained == want


@pytest.mark.parametrize("enc", ["packed", "auto"])
def test_durability_on_the_card(cuda, enc, tmp_path):
    """Manifests on the card equal the CPU's; a snapshot of the card's DB
    restores on the CPU and back; a flipped word on the card is detected and
    healed by the scrubber, and a plan prepared after the heal gives the
    original answer."""
    from repro_torch.robust import Scrubber
    from repro_torch.storage import attach_manifest, build_manifest, restore_db, snapshot_db

    schema = _schema("SD")
    gpu_db = GQFastDatabase(schema, account_space=False, device=cuda, device_encodings=enc)
    cpu_db = GQFastDatabase(schema, account_space=False, device="cpu", device_encodings=enc)
    assert build_manifest(gpu_db.device) == build_manifest(cpu_db.device)
    snapshot_db(gpu_db, str(tmp_path))
    cpu2 = restore_db(str(tmp_path), device="cpu")
    gpu2 = restore_db(str(tmp_path), device=cuda)
    q, params = SG.QUERY_SD, {"d0": 5}
    want = GQFastEngine(cpu_db).query(q, **params)
    np.testing.assert_array_equal(GQFastEngine(cpu2).query(q, **params), want)
    eng = GQFastEngine(gpu2)
    np.testing.assert_array_equal(eng.query(q, **params), want)
    attach_manifest(gpu2.device)
    col = gpu2.device.indexes[("DT", "Term")].dst_col
    bad = col.words.clone()
    bad[bad.shape[0] // 2] ^= 1 << 20
    col.words = bad
    stats = Scrubber(gpu2, snapshot_dir=str(tmp_path)).scrub_full()
    assert stats["healed"] == 1 and stats["failed"] == 0
    eng.invalidate_prepared()
    np.testing.assert_array_equal(eng.query(q, **params), want)


@pytest.mark.parametrize("name,q,params", [c for c in CASES if c[0] in ("SD", "AS", "AD")],
                         ids=["SD", "AS", "AD"])
def test_ladder_rungs_on_the_card(cuda, name, q, params):
    from repro_torch.robust import LADDER, run_with_policy
    from repro_torch.robust.runner import rung_fn

    schema = _schema(name)
    pq = GQFastEngine(GQFastDatabase(schema, account_space=False, device=cuda)).prepare(q)
    want = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu")
                        ).query(q, **params)
    oc = run_with_policy(pq, params)
    assert oc.status == "ok" and oc.rung == "active"
    args = [params[n] for n in pq.param_names]
    for rung in LADDER:
        got = rung_fn(pq, rung)(*args).cpu().numpy()
        if name in ("SD", "AD"):
            np.testing.assert_array_equal(got, want, err_msg=rung)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=rung)


def _served_alone(run, eng):
    """Each batch of a serve run again through ``execute_batch`` of ``eng``
    on the main thread with no other thread launching, padded as served:
    {request id: row}."""
    from repro_torch.launch import serve

    out = {}
    for kind, ids, _ in run.batches:
        rows = ids + [ids[-1]] * (run.bucket - len(ids))
        arrays = {k: np.asarray([run.stream[i][2][k] for i in rows])
                  for k in run.stream[ids[0]][2]}
        got = eng.prepare(serve.QUERIES[kind]).execute_batch(**arrays)
        out.update({i: (kind, got[r]) for r, i in enumerate(ids)})
    return out


def _assert_served_as_alone(run, eng):
    alone = _served_alone(run, eng)
    assert sorted(alone) == list(range(len(run.stream)))
    for i, (kind, want) in alone.items():
        got = run.results[i].value
        if kind in ("SD", "AD"):
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} request {i}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"{kind} request {i}")


def test_serve_obs_lane_on_the_card(cuda, tmp_path):
    """The CI's obs lane through the server on the card, with the workflow's
    assertions; every answer equals its batch served alone."""
    import json

    from repro_torch.launch import serve

    art = tmp_path / "artifacts"
    run = serve.main(["--device", "cuda", "--workload", "analytics",
                      "--requests", "48", "--docs", "4000", "--batch", "8",
                      "--metrics-json", str(art / "obs/serve_metrics.json"),
                      "--profile-json", str(art / "obs/query_profile.json")])
    m = json.load(open(art / "obs/serve_metrics.json"))
    lat = m["histograms"]["serve.request_latency_ms"]
    assert lat["count"] == 48, lat["count"]
    assert "p50" in lat and "p99" in lat, sorted(lat)
    assert lat["p50"] <= lat["p99"], (lat["p50"], lat["p99"])
    assert m["gauges"]["serve.batch_occupancy"] > 0
    p = json.load(open(art / "obs/query_profile.json"))
    assert p["ops"] and p["hops"] and p["total_wall_ms"] > 0
    schema = SG.make_pubmed(n_docs=4000, n_terms=1_200, n_authors=800, seed=5)
    _assert_served_as_alone(run, GQFastEngine(GQFastDatabase(schema, account_space=False,
                                                             device=cuda)))


def test_serve_reload_while_the_scrubber_ticks_on_the_card(cuda, tmp_path):
    """A reload after every batch (the reloader thread restoring with the
    CRC kernel and warming) while the scrubber ticks every millisecond on its
    own thread and the serving thread launches, all on the default stream:
    every answer equals the same requests served alone."""
    import threading

    from repro_torch.launch import serve
    from repro_torch.storage import restore_db

    d = str(tmp_path / "snapshots")
    run = serve.main(["--device", "cuda", "--requests", "64", "--docs", "4000",
                      "--batch", "8", "--snapshot-dir", d, "--reload-at", "1",
                      "--scrub", "--scrub-interval-ms", "1"])
    c = run.registry.snapshot()["counters"]
    assert c["serve.generation_reloads"] >= 1 and "serve.reload_failures" not in c
    assert c["serve.requests_ok"] == 64
    assert c.get("robust.integrity.scrub_failures", 0) == 0
    assert c["robust.integrity.cols_verified"] > 0
    assert all(t.name not in ("reloader", "scrubber") for t in threading.enumerate())
    _assert_served_as_alone(run, GQFastEngine(restore_db(d, device=cuda)))


# ---------------------------------------------------------------------------
# The distributed strategy on the card: a world of 1 over NCCL, in process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh():
    """A 1-rank NCCL mesh in this process (``launch.mesh`` makes the world of
    one), torn down after the module's tests."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    made = not dist.is_initialized()
    mesh = make_mesh((1,), ("data",))
    yield mesh
    if made:
        dist.destroy_process_group()


def _hops(phys) -> int:
    """HopOps one execution of ``phys`` runs, mask sub-programs included."""
    from repro_torch.core.lower import SeedOp, iter_flat_ops

    return sum(1 if isinstance(op, HopOp) else
               sum(_hops(p) for p in op.programs) if isinstance(op, SeedOp) else 0
               for op in iter_flat_ops(phys))


@pytest.mark.parametrize("name,q,params", CASES, ids=[c[0] for c in CASES])
def test_distributed_world_of_one_on_the_card(cuda, nccl_mesh, name, q, params):
    """Under a 1-rank NCCL mesh every hop is one ``fragment_spmv`` launch
    over the shard (``fragment_spmm`` a hop for a batch), and each result
    equals the same sharded plan through the plain versions
    (``use_kernel=False``; counts exact, sums within the gate), the CPU
    engine and the oracle; the batch's rows equal
    their single calls; packed columns decode through bitunpack at shard
    time."""
    from repro_torch.core import executor as X
    from repro_torch.kernels import fragment_spmm as mkernel

    schema = _schema(name)
    eng = GQFastEngine(GQFastDatabase(schema, account_space=False, device=cuda),
                       mesh=nccl_mesh)
    unpacks = bkernel.LAUNCHES
    pq = eng.prepare(q)
    assert pq.strategy == "distributed" and bkernel.LAUNCHES > unpacks
    before, single0 = _hop_launches(), kernel.LAUNCHES
    got = pq(**params)
    hops = _hops(pq.phys)
    assert kernel.LAUNCHES - single0 == hops and _hop_launches() - before == hops
    plain = X.compile_frontier_distributed(eng.db.device, pq.phys, nccl_mesh,
                                           sharded_db=eng.sharded_db(), use_kernel=False)
    before = _hop_launches()
    want = plain(*[params[n] for n in pq.param_names]).cpu().numpy()
    assert _hop_launches() == before  # the plain versions launch nothing
    cpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu")
                       ).query(q, **params)
    for other in (want, cpu):
        if name in ("SD", "AD", "RECENT", "CS"):
            np.testing.assert_array_equal(got, other)
        np.testing.assert_allclose(got, other, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, run_sql(schema, q, params), rtol=1e-4, atol=1e-4)
    key = next(iter(params))
    rows = {k: [v, v, v] for k, v in params.items()}
    rows[key] = [params[key], params[key] + 1, params[key] + 2]
    before = mkernel.LAUNCHES
    got_b = pq.execute_batch(**rows)
    assert mkernel.LAUNCHES - before == hops
    for b in range(3):
        one = pq(**{k: v[b] for k, v in rows.items()})
        np.testing.assert_allclose(got_b[b], one, rtol=1e-4, atol=1e-4)


def test_distributed_profile_and_ladder_on_the_card(cuda, nccl_mesh):
    """profile() of SD under the NCCL mesh times every op by prefix-delta
    and returns ``__call__``'s answer; through the ladder it answers ``ok``
    on the sharded rung, and with every hop kernel failing it ends with
    KERNEL there, no plain rung built."""
    from repro_torch.kernels.cuda_build import KernelError
    from repro_torch.robust import run_with_policy

    name, q, params = CASES[0]
    eng = GQFastEngine(GQFastDatabase(_schema(name), account_space=False, device=cuda),
                       mesh=nccl_mesh)
    pq = eng.prepare(q)
    prof = pq.profile(reps=2, **params)
    assert prof.timing_method == "prefix-delta"
    assert all(o.wall_ms is not None for o in prof.ops)
    np.testing.assert_array_equal(prof.result, pq(**params))
    oc = run_with_policy(pq, params)
    assert oc.status == "ok" and oc.rung == "active"
    np.testing.assert_array_equal(oc.value, prof.result)

    def fails(*a, **k):
        raise KernelError("fragment_spmv: launch failed")

    real = kernel.fragment_spmv
    kernel.fragment_spmv = fails
    try:
        oc = run_with_policy(pq, params)
    finally:
        kernel.fragment_spmv = real
    assert oc.status == "error" and oc.error.code == "KERNEL" and oc.rung == "active"
    assert [k for k in pq.__dict__.get("_rung_fns", {}) if k[0] != "active"] == []


# ---------------------------------------------------------------------------
# The transformer family on the card against the same model on the CPU
# ---------------------------------------------------------------------------

LM_F32_TOL = 1e-4  # max|card − CPU| / max|CPU|, float32 compute


def _lm_cfg(moe: bool):
    import dataclasses

    from repro_torch.configs.registry import get_arch

    cfg = get_arch("olmoe-1b-7b" if moe else "qwen2.5-3b").smoke_cfg
    return dataclasses.replace(cfg, compute_dtype=torch.float32, remat=True)


def _rel_err(got, want) -> float:
    got, want = got.detach().cpu().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("moe", [False, True], ids=["qwen2.5-3b", "olmoe-1b-7b"])
def test_lm_on_the_card_matches_cpu(cuda, moe):
    """Smoke-width Qwen2.5-3B and OLMoE under float32 compute: logits, loss
    and the gradient of every leaf on the card within LM_F32_TOL of the CPU's
    on the same weights; the MoE routing (topi, keep) equal, integer for
    integer, each layer's router fed the same input on both."""
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = _lm_cfg(moe)
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), cpu)
    batch = lm_batch(0, 2, 64, cfg.vocab, seed=3, device="cpu")
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    routing = []
    (lc, _), gc = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg), cpu, batch)
    (lg, _), gg = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg), card, cbatch)
    assert _rel_err(lg, lc) <= LM_F32_TOL
    for (k, a), (_, b) in zip(tree_leaves_with_path(gc), tree_leaves_with_path(gg)):
        assert b.device.type == "cuda" and _rel_err(b, a) <= LM_F32_TOL, k
    with torch.no_grad():
        logits_c, _ = T.forward(cpu, batch["tokens"], cfg)
        logits_g, _ = T.forward(card, cbatch["tokens"], cfg, routing=routing)
    assert _rel_err(logits_g, logits_c) <= LM_F32_TOL
    if not moe:
        return
    assert len(routing) == cfg.n_layers
    for i, r in enumerate(routing):
        lp = {k: v[i] for k, v in cpu["layers"].items()}
        want = T.moe_route(lp, r["x"].cpu(), cfg)
        assert torch.equal(r["topi"].cpu(), want["topi"]), i
        assert torch.equal(r["keep"].cpu(), want["keep"]), i


def test_lm_decode_matches_forward_on_the_card(cuda):
    """Smoke-width Qwen2.5-3B at its bf16 compute: prefill and three decode
    steps on the card equal the card's forward over the same tokens within
    bf16's tolerance (3e-2 of the largest logit)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T

    cfg = get_arch("qwen2.5-3b").smoke_cfg
    params = T.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 32), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    logits, cache, pos = T.prefill(params, toks, cfg, 128)
    seq, steps = [torch.argmax(logits, -1)], []
    for i in range(3):
        logits, cache = T.decode_step(params, cache, seq[-1], pos + i, cfg)
        steps.append(logits)
        seq.append(torch.argmax(logits, -1))
    full = torch.cat([toks, torch.stack(seq[:3], 1).int()], 1)
    with torch.no_grad():
        fl, _ = T.forward(params, full, cfg)
    for i, got in enumerate(steps):
        assert torch.isfinite(got).all() and _rel_err(got, fl[:, 32 + i].cpu()) <= 3e-2, i


# ---------------------------------------------------------------------------
# The GNN family and DIN on the card against the same models on the CPU
# ---------------------------------------------------------------------------

GNN_TOL = 1e-4  # outputs and loss, max|card − CPU| / max|CPU|
GNN_GRAD_TOL = 1e-3  # each gradient leaf, relative to its largest value


@pytest.mark.parametrize("aid", ["mace", "egnn", "equiformer-v2", "schnet"])
def test_gnn_on_the_card_matches_cpu(cuda, aid):
    """Each arch's smoke config on a molecule batch: energies and loss on the
    card within GNN_TOL of the CPU's on the same weights, every gradient leaf
    within GNN_GRAD_TOL (EquiformerV2's attention output bias, whose gradient
    is 0 in exact arithmetic, under GNN_TOL of the tree's largest)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.graphs import make_molecule_batch
    from repro_torch.models.gnn.models import gnn_apply, gnn_init, gnn_loss
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = get_arch(aid).smoke_cfg
    cpu = gnn_init(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), cpu)
    mol = make_molecule_batch(8, 10, 24, seed=1, device="cpu")
    b, cb = mol.as_inputs(), mol.to(cuda).as_inputs()
    with torch.no_grad():
        assert _rel_err(gnn_apply(card, cb, cfg, 8), gnn_apply(cpu, b, cfg, 8)) <= GNN_TOL
    (lc, _), gc = value_and_grad(lambda p, x: gnn_loss(p, x, cfg, 8), cpu, b)
    (lg, _), gg = value_and_grad(lambda p, x: gnn_loss(p, x, cfg, 8), card, cb)
    assert _rel_err(lg, lc) <= GNN_TOL
    scale = max(float(a.abs().max()) for _, a in tree_leaves_with_path(gc))
    for (k, a), (_, g) in zip(tree_leaves_with_path(gc), tree_leaves_with_path(gg)):
        assert g.device.type == "cuda", k
        if k.endswith("/attn/[1]/b"):
            assert float(g.abs().max()) <= GNN_TOL * scale, k
        else:
            assert _rel_err(g, a) <= GNN_GRAD_TOL, k


def test_din_on_the_card_matches_cpu(cuda, monkeypatch):
    """DIN's smoke config: logits, retrieval scores and loss on the card
    within GNN_TOL of the CPU's on the same weights, every gradient leaf
    within GNN_GRAD_TOL; the empty bags of ``embedding_bag`` on the card
    hold the reference's values (0, 0, -inf)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.recsys import make_din_batch
    from repro_torch.models import din as D
    from repro_torch.models.din import din_forward, din_init, din_loss, din_retrieval_scores
    from repro_torch.models.embedding import embedding_bag
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = get_arch("din").smoke_cfg
    cpu = din_init(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), cpu)
    kw = dict(seq_len=cfg.seq_len, n_items=cfg.n_items, n_users=cfg.n_users)
    b = make_din_batch(64, **kw, seed=2, device="cpu")
    cb = {k: v.to(cuda) for k, v in b.items()}
    rb = make_din_batch(1, **kw, n_candidates=700, seed=3, device="cpu")
    crb = {k: v.to(cuda) for k, v in rb.items()}
    with torch.no_grad():
        assert _rel_err(din_forward(card, cb, cfg), din_forward(cpu, b, cfg)) <= GNN_TOL
        want = din_retrieval_scores(cpu, rb, cfg)
        monkeypatch.setattr(D, "RETRIEVAL_CHUNK", 256)  # three chunks on the card
        assert _rel_err(din_retrieval_scores(card, crb, cfg), want) <= GNN_TOL
    (lc, _), gc = value_and_grad(lambda p, x: din_loss(p, x, cfg), cpu, b)
    (lg, _), gg = value_and_grad(lambda p, x: din_loss(p, x, cfg), card, cb)
    assert _rel_err(lg, lc) <= GNN_TOL
    for (k, a), (_, g) in zip(tree_leaves_with_path(gc), tree_leaves_with_path(gg)):
        if float(a.abs().max()) == 0:  # a table no id of the batch reads
            assert float(g.abs().max()) == 0, k
        else:
            assert _rel_err(g, a) <= GNN_GRAD_TOL, k
    table = torch.randn(20, 3, generator=torch.Generator().manual_seed(5))
    ids = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    bags = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    for mode, empty in (("sum", 0.0), ("mean", 0.0), ("max", -float("inf"))):
        want = embedding_bag(table, ids, bags, 3, mode=mode)
        got = embedding_bag(table.to(cuda), ids.to(cuda), bags.to(cuda), 3, mode=mode).cpu()
        assert (got[1] == empty).all() and torch.allclose(got, want, rtol=1e-5, atol=1e-6), mode
