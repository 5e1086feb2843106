"""Tests that need an NVIDIA GPU: the hand-written CUDA kernel against its
plain PyTorch version, and the engine on the card against the engine on the
CPU and the numpy oracle. They import no JAX (the GPU machine need not have
it) and skip where ``torch.cuda.is_available()`` is false: a CUDA kernel has no
CPU mode. On a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

sum within rtol=atol=1e-4 (atomics reorder the float adds); min, max and bool
exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.lower import HopOp  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import fragment_spmv as kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

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


def _hops(phys) -> int:
    """HopOps one execution runs, mask sub-programs included."""
    return sum(
        1 if isinstance(op, HopOp) else sum(_hops(p) for p in getattr(op, "programs", ()))
        for op in phys.ops
    )


@pytest.mark.parametrize("name,q,params", CASES, ids=[c[0] for c in CASES])
def test_engine_on_the_card_matches_cpu_and_oracle(cuda, name, q, params):
    if name == "CS":
        schema = SG.make_semmeddb(400, 500, 800, 3000)
    else:
        schema = SG.make_pubmed(n_docs=2000, n_terms=100, n_authors=500, seed=3)
    gpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device=cuda))
    cpu = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu"))
    before = kernel.LAUNCHES
    got = gpu.query(q, **params)
    assert kernel.LAUNCHES - before == _hops(gpu.prepare(q).phys)
    want = cpu.query(q, **params)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, run_sql(schema, q, params), rtol=1e-4, atol=1e-4)
    assert (got != 0).any()
