"""The port's decode-fused batched hop and batched fused regions against
the JAX package's, on the CPU: ``ops.fragment_spmm_packed`` and
``ops.fragment_spmm_fused`` (the port's plain versions, the path CPU tensors
take) against ``repro.kernels.ops`` with ``use_pallas=True`` (its Pallas
kernels in interpret mode) on the same numpy inputs; the dense SpMM, per-row
measures and the empty relation are in ``test_torch_batched.py``.

Every op × dense/packed dst × measure mode × block skipping off/on/auto ×
B ∈ {1, 3, 8} × E ∈ {0, 1, 4097} runs through the port and equals the
port's scan and each row's SpMV. The JAX Pallas kernels compile once per
shape in interpret mode (about half a second each), so the sweep calls them
at B = 3 and E = 4097 under every skipping mode. Also the union block lists
(equal as integers to the reference's for the same frontier), the batched
fused regions and the fusion budget of a batch. Tolerances: min, max and
bool equal; sums within rtol=atol=1e-4. The reference's SpMM-vs-SpMV
bit-identity is not taken as ground truth (its own
``test_fragment_spmm_matches_spmv_rows[sum]`` fails).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.fragments import _pack_words  # noqa: E402
from repro.kernels import active as jactive  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import active, ops  # noqa: E402
from repro_torch.kernels import fragment_spmm as skernel  # noqa: E402
from repro_torch.kernels import fragment_spmm_packed as spkernel  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

OPS = ["sum", "min", "max", "bool"]
M_MODES = ["none", "dense", "packed", "dict"]
SKIPS = ["off", "on", "auto"]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}
N_SRC, N_DST, DST_W, M_W = 5000, 300, 9, 6
MDICT = np.array([0.5, 3.0, 0.0, 7.25, 1.0, 2.5, 6.0, 4.0], np.float32)
#: (B, E) → the skipping modes at which the packed sweep calls the JAX
#: kernels (each (B, E, mode) shape compiles once in interpret mode)
JAX_AT = {(3, 4097): SKIPS}


def _assert_match(got, want, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


def _frontier(B, op, seed, n=N_SRC, live=1.0):
    """B rows with identity entries (a quarter), each row live on a prefix
    of ``live`` × n sources, so the union list is sparse below 1."""
    rng = np.random.default_rng(seed)
    W = (rng.random((B, n)) * 2).astype(np.float32)
    if op == "bool":
        W = (W > 1).astype(np.float32)
    W[rng.random(W.shape) < 0.25] = ZERO[op]
    W[:, int(live * n):] = ZERO[op]
    return W


def _edges(E, seed):
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, N_SRC, E)).astype(np.int32)
    dst = rng.integers(0, N_DST, E).astype(np.int32)
    m = rng.integers(0, 40, E).astype(np.float32)
    midx = rng.integers(0, MDICT.shape[0], E)
    return src, dst, m, midx


def _operands(E, seed, dst_packed, m_mode):
    src, dst, m, midx = _edges(E, seed)
    d = _pack_words(dst, DST_W) if dst_packed else dst
    meas = {"none": None, "dense": m, "packed": _pack_words(m.astype(np.int64), M_W),
            "dict": _pack_words(midx, 3)}[m_mode]
    kw = dict(n_dst=N_DST, dst_width=DST_W if dst_packed else 0, m_mode=m_mode,
              m_width={"packed": M_W, "dict": 3}.get(m_mode, 0))
    return src, d, meas, (MDICT if m_mode == "dict" else None), kw


def _port_hop(h: dict):
    """A hop's operands for the port: word streams as int32 tensors of the
    same bits."""
    words = {k: torch.from_numpy(h[k].view(np.int32)) for k in ("dst", "measure")
             if h[k].dtype == np.uint32}
    return ops.FusedHopOperands(**{**h, **words}, hot_share=0.0)


# ---------------------------------------------------------------------------
# fragment_spmm_packed: every op × dst × measure mode × skipping × B × E
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m_mode", M_MODES)
@pytest.mark.parametrize("dst_packed", [True, False], ids=["dst_packed", "dst_dense"])
@pytest.mark.parametrize("op", OPS)
def test_spmm_packed_matches_jax(op, dst_packed, m_mode):
    for E in (0, 1, 4097):
        src, d, meas, md, kw = _operands(E, E + 1, dst_packed, m_mode)
        blocks = active.block_ranges(src)
        for B in (1, 3, 8):
            W = _frontier(B, op, B + E, live=0.3 if E > 1 else 1.0)
            scan = ops.fragment_spmm_packed(W, src, d, meas, md, op=op, **kw)
            assert tuple(scan.shape) == (B, N_DST)
            for b in range(B):  # each row is the port's SpMV
                _assert_match(scan[b], ops.fragment_spmv_packed(W[b], src, d, meas, md,
                                                                op=op, **kw), op)
            for mode in SKIPS:
                got = ops.fragment_spmm_packed(W, src, d, meas, md, op=op, blocks=blocks,
                                               block_skipping=mode, **kw)
                _assert_match(got, scan, op)
                if mode in JAX_AT.get((B, E), ()):
                    want = jops.fragment_spmm_packed(W, src, d, meas, md, op=op,
                                                     blocks=blocks, block_skipping=mode,
                                                     **kw)
                    _assert_match(got, want, op)


# ---------------------------------------------------------------------------
# the union block list
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["empty", "one_row", "disjoint", "overlap", "all"])
def test_union_block_lists_equal_jax(pattern):
    """One list for the batch: a block is listed when any row's support meets
    it; equal as integers to the reference's (device and host forms)."""
    src, _, _, _ = _edges(40_000, 3)
    smin, smax = active.block_ranges(src)
    W = np.zeros((4, N_SRC), np.float32)
    if pattern == "one_row":
        W[2, 10:12] = 1.0
    elif pattern == "disjoint":
        W[0, :50] = 1.0
        W[3, 4000:4100] = 2.0
    elif pattern == "overlap":
        W[:, 1000:1300] = 1.0
        W[1, 2500] = 3.0
    elif pattern == "all":
        W[:] = 1.0
    bi, na = active.active_block_list(torch.from_numpy(W), 0.0, torch.from_numpy(smin),
                                      torch.from_numpy(smax))
    jbi, jna = jactive.active_block_list(jnp.asarray(W), 0.0, jnp.asarray(smin),
                                         jnp.asarray(smax))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(jbi))
    np.testing.assert_array_equal(na.numpy(), np.asarray(jna))
    union = (W != 0).any(axis=0)
    got = active.active_block_list_np(union, smin, smax)
    want = jactive.active_block_list_np(union, smin, smax)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    rows = [set(active.active_block_list(torch.from_numpy(W[b]), 0.0, torch.from_numpy(smin),
                                         torch.from_numpy(smax))[0][:int(
                                             active.active_block_list(
                                                 torch.from_numpy(W[b]), 0.0,
                                                 torch.from_numpy(smin),
                                                 torch.from_numpy(smax))[1][0])].tolist())
            for b in range(4)]
    assert set(bi[:int(na[0])].tolist()) == set().union(*rows)


# ---------------------------------------------------------------------------
# the batched fused regions
# ---------------------------------------------------------------------------


def _region(seed, dst_packed):
    """hop1 N_SRC → 700 (4097 edges), hop2 700 → 500 (4100 edges), packed
    measures, a mid mask over the 700."""
    rng = np.random.default_rng(seed)
    out = []
    for n_src, n_dst, E, w in ((N_SRC, 700, 4097, 10), (700, 500, 4100, 9)):
        src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
        dst = rng.integers(0, n_dst, E)
        mint = rng.integers(0, 40, E)
        out.append(dict(src_ids=src, dst=_pack_words(dst, w) if dst_packed else dst.astype(np.int32),
                        measure=_pack_words(mint, 6), n_dst=n_dst,
                        dst_width=w if dst_packed else 0, m_mode="packed", m_width=6,
                        blocks=active.block_ranges(src)))
    keep = (rng.random(700) < 0.6).astype(np.float32)
    return out[0], out[1], keep


@pytest.mark.parametrize("variant", ["two_hop", "two_hop_mask_binarize", "degenerate",
                                     "degenerate_mask"])
@pytest.mark.parametrize("op", OPS)
def test_spmm_fused_matches_jax_and_unfused(op, variant):
    two = variant.startswith("two_hop")
    binz = variant.endswith("binarize")
    for dst_packed in (True, False):
        a, b, keep = _region(5, dst_packed)
        mask = keep if variant.endswith(("mask", "binarize")) else None
        h1, j1 = _port_hop(a), jops.FusedHopOperands(**a)
        h2, j2 = (_port_hop(b), jops.FusedHopOperands(**b)) if two else (None, None)
        for B in (1, 3, 8):
            W = _frontier(B, op, B + 40, live=0.4)
            off = ops.fragment_spmm_fused(W, h1, h2, mask, op=op, mid_binarize=binz,
                                          fusion="off", block_skipping="off")
            for skip in SKIPS:
                got = ops.fragment_spmm_fused(W, h1, h2, mask, op=op, mid_binarize=binz,
                                              fusion="on", block_skipping=skip)
                _assert_match(got, off, op)
            for r in range(B):
                row = ops.fragment_spmv_fused(W[r], h1, h2, mask, op=op, mid_binarize=binz,
                                              fusion="on", block_skipping="on")
                _assert_match(got[r], row, op)
            if B == 3 and dst_packed:
                want = jops.fragment_spmm_fused(W, j1, j2, mask, op=op, mid_binarize=binz,
                                                fusion="on", block_skipping="on")
                _assert_match(got, want, op)


@pytest.mark.parametrize("B,n_mid,two,unfused", [
    (1, 100, True, False), (8, 27_000, True, True), (64, 600, True, True),
    (64, 4_000_000, False, False), (1, 40_000, True, True), (8, 4_000, True, False),
])
def test_fusion_budget_counts_the_batch(B, n_mid, two, unfused, monkeypatch):
    """'auto' budgets a two-hop region's scratch as 4 · n_mid · B bytes, as
    the reference does, here against a budget of 128 KiB; the degenerate
    region keeps no scratch."""
    monkeypatch.setattr(ops, "FUSED_SCRATCH_BUDGET_BYTES", 128 * 2**10)
    assert ops._fusion_unfusable("auto", n_mid, two, B) is unfused
    assert ops._fusion_unfusable("on", n_mid, two, B) is False
    assert ops._fusion_unfusable("off", n_mid, two, B) is True


def test_spmm_wrappers_need_cuda_and_pass_int64_strides():
    """On CPU tensors the kernels' wrappers raise (the dispatch takes the
    plain versions there); the C entry points take the measure stride and
    the edge count as int64 (row offsets past 2^31 are formed on the card)."""
    import ctypes

    W = torch.ones((2, 4))
    e = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        skernel.fragment_spmm(W, e, e, None, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        spkernel.fragment_spmm_packed(W, e, e, None, None, 4)
    args = skernel.LIB.functions["fragment_spmm_launch"]
    assert args[6] is ctypes.c_int64 and args[7] is ctypes.c_int64  # m_stride, E
    assert spkernel.LIB.functions["fragment_spmm_packed_launch"][4] is ctypes.c_int64  # E
