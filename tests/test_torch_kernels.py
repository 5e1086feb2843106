"""Hop kernel and semiring parity: the PyTorch port against the JAX package.

On the CPU the port's ``ops.fragment_spmv`` takes its plain PyTorch version;
it is compared with the JAX dispatch (the Pallas kernel in interpret mode)
and with the JAX oracle ``ref.fragment_spmv_ref``, on the same numpy inputs.
The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py, which imports no JAX.
sum uses the repo's tolerance (rtol=atol=1e-4): the order of float adds
differs between the implementations. min, max and bool are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import semiring as JS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import semiring as PS  # noqa: E402
from repro_torch.kernels import fragment_spmv as pkernel  # noqa: E402
from repro_torch.kernels import ops as pops  # noqa: E402

OPS = ["sum", "min", "max", "bool"]
SHAPES = [(100, 80, 500), (1000, 1000, 10000), (17, 5, 3), (4096, 4096, 4096), (10, 7, 0)]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}


def _inputs(n_src, n_dst, E, op, seed):
    """Random hop inputs; a quarter of the frontier holds the ⊕-identity and
    a tenth of the measures are 0, so the ∞·0 guard is on the path."""
    rng = np.random.default_rng(seed)
    w = rng.random(n_src).astype(np.float32)
    if op == "bool":
        w = (w > 0.5).astype(np.float32)
    w[rng.random(n_src) < 0.25] = ZERO[op]
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = rng.integers(0, n_dst, E).astype(np.int32)
    m = rng.random(E).astype(np.float32)
    m[rng.random(E) < 0.1] = 0.0
    return w, src, dst, m


def _assert_match(got, want, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n_src,n_dst,E", SHAPES, ids=[f"{a}x{b}x{c}" for a, b, c in SHAPES])
def test_plain_spmv_matches_jax(n_src, n_dst, E, op):
    w, src, dst, m = _inputs(n_src, n_dst, E, op, seed=n_src + E)
    got = pops.fragment_spmv(w, src, dst, m, n_dst, op=op)
    _assert_match(got, jops.fragment_spmv(w, src, dst, m, n_dst, op=op), op)
    _assert_match(got, jref.fragment_spmv_ref(
        jnp.asarray(w), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(m), n_dst, op=op
    ), op)


@pytest.mark.parametrize("op", OPS)
def test_identity_frontier_with_zero_measures(op):
    """An all-identity frontier against m = 0: ∞·0 must not become NaN; every
    destination stays the ⊕-identity, as in the JAX kernel."""
    n_src, n_dst, E = 64, 48, 700
    rng = np.random.default_rng(7)
    w = np.full(n_src, ZERO[op], np.float32)
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = rng.integers(0, n_dst, E).astype(np.int32)
    m = np.zeros(E, np.float32)
    got = np.asarray(pops.fragment_spmv(w, src, dst, m, n_dst, op=op))
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, np.full(n_dst, ZERO[op], np.float32))
    _assert_match(got, jops.fragment_spmv(w, src, dst, m, n_dst, op=op), op)


@pytest.mark.parametrize("op", OPS)
def test_measure_free_hop_is_measure_one(op):
    w, src, dst, _ = _inputs(300, 200, 2000, op, seed=11)
    ones = np.ones(src.shape[0], np.float32)
    _assert_match(
        pops.fragment_spmv(w, src, dst, None, 200, op=op),
        pops.fragment_spmv(w, src, dst, ones, 200, op=op), op,
    )


def test_out_of_range_src_reads_identity():
    w = np.asarray([2.0, 3.0], np.float32)
    src = np.asarray([0, 1, 2, -1], np.int32)
    dst = np.asarray([0, 1, 2, 2], np.int32)
    m = np.ones(4, np.float32)
    for op in OPS:
        got = np.asarray(pops.fragment_spmv(w, src, dst, m, 3, op=op))
        assert got[2] == ZERO[op]


def test_cpu_tensors_take_the_plain_version():
    before = pkernel.LAUNCHES
    w, src, dst, m = _inputs(50, 40, 300, "sum", seed=3)
    pops.fragment_spmv(torch.from_numpy(w), torch.from_numpy(src),
                       torch.from_numpy(dst), torch.from_numpy(m), 40)
    assert pkernel.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back: a CPU tensor raises before any build."""
    w, src, dst, m = (torch.from_numpy(a) for a in _inputs(50, 40, 300, "sum", seed=3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pkernel.fragment_spmv(w, src, dst, m, 40)


def test_ops_rejects_unknown_op():
    with pytest.raises(ValueError, match="unknown combine op"):
        pops.fragment_spmv(np.ones(2, np.float32), [0], [0], [1.0], 1, op="prod")


# ---------------------------------------------------------------------------
# Semirings: every method against the JAX one
# ---------------------------------------------------------------------------

SEMIRINGS = ["sum", "min", "max", "bool"]
AGG = {"sum": "sum", "min": "min", "max": "max", "bool": "exists"}


def _frontier(name, n=257, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.random(n) * 4).astype(np.float32)
    if name == "bool":
        w = (w > 2).astype(np.float32)
    w[rng.random(n) < 0.3] = ZERO[name]
    return w


def _pair(name):
    p, j = PS.semiring_for(AGG[name]), JS.semiring_for(AGG[name])
    assert p.name == j.name == name
    return p, j


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("method", ["binarize", "to_mask", "finalize", "from_mask"])
def test_semiring_unary_matches_jax(name, method):
    p, j = _pair(name)
    w = _frontier(name)
    got = getattr(p, method)(torch.from_numpy(w))
    want = getattr(j, method)(jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("method", ["combine", "extend", "mask"])
def test_semiring_binary_matches_jax(name, method):
    p, j = _pair(name)
    a, b = _frontier(name, seed=1), _frontier(name, seed=2)
    if method == "extend":  # factors include 0 against 0̄: the ∞·0 guard
        b = np.where(np.arange(b.shape[0]) % 5 == 0, 0.0, np.abs(b)).astype(np.float32)
        b[np.isinf(b)] = 1.0
    if method == "mask":
        b = (b > 1).astype(np.float32)
    got = getattr(p, method)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(j, method)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_semiring_scatter_matches_jax(name):
    """Seeding: duplicate ids accumulate under ⊕."""
    p, j = _pair(name)
    idx = np.asarray([3, 5, 3, 0, 9, 3], np.int32)
    acc = np.full(12, j.zero, np.float32)
    vals = np.asarray([1.0, 2.0, 0.5, 4.0, 1.0, 3.0], np.float32)
    got = p.scatter(torch.from_numpy(acc), torch.from_numpy(idx), torch.from_numpy(vals))
    want = j.scatter(jnp.asarray(acc), jnp.asarray(idx), jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got1 = p.scatter(torch.from_numpy(acc), torch.from_numpy(idx), p.one)
    want1 = j.scatter(jnp.asarray(acc), jnp.asarray(idx), j.one)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_semiring_segment_matches_jax(name):
    """Reached segments agree exactly (sum within tolerance). An empty
    segment reads 0̄ in the port under every semiring; the JAX bool semiring
    leaves −∞ there (segment_max's fill), a reference caveat kept in the
    ROADMAP's list of reference faults."""
    p, j = _pair(name)
    rng = np.random.default_rng(4)
    vals = _frontier(name, n=300, seed=5)
    seg = rng.integers(0, 40, 300).astype(np.int32)
    seg[seg == 17] = 18  # segment 17 stays empty
    got = p.segment(torch.from_numpy(vals), torch.from_numpy(seg), 40).numpy()
    want = np.asarray(j.segment(jnp.asarray(vals), jnp.asarray(seg), 40))
    reached = np.bincount(seg, minlength=40) > 0
    if name == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got[reached], want[reached])
    assert got[17] == p.zero
    if name != "bool":
        assert want[17] == j.zero
