"""The GNN family of the PyTorch port against the JAX package, on the CPU:
``tests/test_models_gnn.py`` case for case on the port, then the pieces
against the reference's (``tests/test_torch_gnn_parity.py`` holds the four
models whole, on the reference's weights).

Tolerances: real SH, Wigner matrices and edge frames on tensors within 1e-5
of the reference's, relative to the largest value. The numpy tables (the
Wigner samples and their pseudo-inverses, the Clebsch-Gordan couplings) and
the data generators are equal exactly, and ``segment_max``'s empty segments
hold the reference's ``-inf``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need the [test] extra")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import graphs as JG  # noqa: E402
from repro.models.gnn import equivariant as JE  # noqa: E402
from repro.models.gnn import models as JM  # noqa: E402
from repro_torch.data.graphs import (  # noqa: E402
    CSRGraph,
    NeighborSampler,
    make_feature_graph,
    make_molecule_batch,
)
from repro_torch.models.gnn import equivariant as PE  # noqa: E402
from repro_torch.models.gnn import models as PM  # noqa: E402
from repro_torch.models.gnn.common import segment_max  # noqa: E402
from repro_torch.models.gnn.models import GNNConfig, gnn_apply, gnn_init, gnn_loss  # noqa: E402

from torch_fixtures import two_threads  # noqa: E402,F401 (autouse)
from torch_gnn_reference import CONFIGS, IDS, check_against_reference, feature_graph  # noqa: E402,E501

settings.register_profile("tg", deadline=None, max_examples=10)
settings.load_profile("tg")

GEOM_TOL = 1e-5

CPU = torch.device("cpu")

def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rand_rot(seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q.astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_models_gnn.py, case for case, on the port
# ---------------------------------------------------------------------------


@given(st.integers(0, 2**31))
def test_sph_harm_equivariance(seed):
    R = torch.from_numpy(_rand_rot(seed))
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(20, 3))
    v = torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32))
    l_max = 4
    Y = PE.real_sph_harm(l_max, v)
    Yr = PE.real_sph_harm(l_max, torch.einsum("ij,nj->ni", R, v))
    D = PE.wigner_d_real(l_max, R)
    for l, sl in enumerate(PE.l_slices(l_max)):
        np.testing.assert_allclose(torch.einsum("mk,nk->nm", D[l], Y[:, sl]).numpy(),
                                   Yr[:, sl].numpy(), atol=5e-5)


@given(st.integers(0, 2**31))
def test_wigner_orthogonality(seed):
    D = PE.wigner_d_real(4, torch.from_numpy(_rand_rot(seed)))
    for l, d in enumerate(D):
        np.testing.assert_allclose((d @ d.T).numpy(), np.eye(2 * l + 1), atol=5e-5)


@pytest.mark.parametrize("l1,l2,l3", [(1, 1, 2), (2, 2, 2), (1, 2, 3), (2, 2, 0)])
def test_real_cg_equivariance(l1, l2, l3):
    C = torch.from_numpy(PE.real_cg(l1, l2, l3)).float()
    R = torch.from_numpy(_rand_rot(l1 * 100 + l2 * 10 + l3))
    D = PE.wigner_d_real(max(l1, l2, l3), R)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2 * l1 + 1,)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2 * l2 + 1,)).astype(np.float32))
    z = torch.einsum("ijk,i,j->k", C, x, y)
    zr = torch.einsum("ijk,i,j->k", C, D[l1] @ x, D[l2] @ y)
    np.testing.assert_allclose((D[l3] @ z).numpy(), zr.numpy(), atol=1e-5)


def test_edge_frame_maps_to_z():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    R = PE.rotation_to_edge_frame(v)
    n = v / torch.linalg.norm(v, dim=1, keepdim=True)
    out = torch.einsum("eij,ej->ei", R, n)
    np.testing.assert_allclose(out[:, 2].numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)  # proper rotations


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_rotation_invariance(cfg):
    binp = make_molecule_batch(batch=4, n_nodes=8, n_edges=16, device="cpu").as_inputs()
    rot = dict(binp)
    rot["pos"] = binp["pos"] @ torch.from_numpy(_rand_rot(7)).T
    p = gnn_init(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        e1, e2 = gnn_apply(p, binp, cfg, 4), gnn_apply(p, rot, cfg, 4)
    scale = float(e1.abs().max()) + 1e-9
    assert float((e1 - e2).abs().max()) / scale < 2e-2, cfg.arch


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_translation_invariance(cfg):
    binp = make_molecule_batch(batch=2, n_nodes=6, n_edges=12, device="cpu").as_inputs()
    tr = dict(binp)
    tr["pos"] = binp["pos"] + torch.tensor([1.5, -2.0, 0.7])
    p = gnn_init(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        e1, e2 = gnn_apply(p, binp, cfg, 2), gnn_apply(p, tr, cfg, 2)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_edge_mask_zeroes_padding(cfg):
    """Adding masked-out padding edges must not change the output."""
    b = make_molecule_batch(batch=2, n_nodes=6, n_edges=12, device="cpu").as_inputs()
    p = gnn_init(cfg, torch.Generator().manual_seed(0))
    pad = 8
    b2 = dict(b)
    b2["edge_src"] = torch.cat([b["edge_src"], torch.zeros(pad, dtype=torch.int32)])
    b2["edge_dst"] = torch.cat([b["edge_dst"], torch.ones(pad, dtype=torch.int32)])
    b2["edge_mask"] = torch.cat([b["edge_mask"], torch.zeros(pad)])
    with torch.no_grad():
        e1, e2 = gnn_apply(p, b, cfg, 2), gnn_apply(p, b2, cfg, 2)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-5)


def test_node_classification_head():
    g = make_feature_graph(100, 400, d_feat=16, n_classes=5, device="cpu")
    cfg = GNNConfig("s", "schnet", 2, 16, n_rbf=8, d_feat=16, n_classes=5)
    p = gnn_init(cfg, torch.Generator().manual_seed(0))
    logits = gnn_apply(p, g.as_inputs(), cfg)
    assert logits.shape == (100, 5)
    loss, _ = gnn_loss(p, g.as_inputs(), cfg)
    assert bool(torch.isfinite(loss))


def test_neighbor_sampler_budgets():
    g = CSRGraph.random(5000, 50000, d_feat=8)
    batch = NeighborSampler(g, fanouts=[5, 3], batch_nodes=64, device="cpu").sample()
    assert batch.edge_src.shape == batch.edge_dst.shape == batch.edge_mask.shape
    assert batch.edge_src.shape[0] == 64 * 5 * (1 + 3)
    assert int(batch.edge_src.max()) < batch.pos.shape[0]
    uniq = np.unique(np.concatenate([batch.edge_src.numpy(), batch.edge_dst.numpy()]))
    assert uniq.shape[0] <= batch.pos.shape[0]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_numpy_tables_equal_the_reference():
    for l_max in range(7):
        (pv, pp), (jv, jp) = PE._wigner_samples(l_max), JE._wigner_samples(l_max)
        assert np.array_equal(pv, jv) and len(pp) == len(jp) == l_max + 1
        assert all(np.array_equal(a, b) for a, b in zip(pp, jp)), l_max
        assert np.array_equal(PE._real_to_complex(l_max), JE._real_to_complex(l_max))
    for l1 in range(7):
        for l2 in range(7):
            for l3 in range(7):
                assert np.array_equal(PE._cg_complex(l1, l2, l3), JE._cg_complex(l1, l2, l3))
                a, b = PE.real_cg(l1, l2, l3), JE.real_cg(l1, l2, l3)
                assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    assert [PE.irreps_dim(l) for l in range(7)] == [JE.irreps_dim(l) for l in range(7)]
    assert PE.l_slices(6) == JE.l_slices(6)
    assert PM._mace_paths(3) == JM._mace_paths(3)


@pytest.mark.parametrize("l_max", [0, 3, 6])
def test_sph_harm_wigner_and_frames_match_the_reference(l_max):
    rng = np.random.default_rng(l_max)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    assert _rel(PE.real_sph_harm(l_max, torch.from_numpy(v)),
                JE.real_sph_harm(l_max, jnp.asarray(v))) <= GEOM_TOL
    rot = np.stack([_rand_rot(s) for s in range(8)])
    for got, want in zip(PE.wigner_d_real(l_max, torch.from_numpy(rot)),
                         JE.wigner_d_real(l_max, jnp.asarray(rot))):
        assert _rel(got, want) <= GEOM_TOL
    assert _rel(PE.rotation_to_edge_frame(torch.from_numpy(v)),
                JE.rotation_to_edge_frame(jnp.asarray(v))) <= GEOM_TOL


def test_segment_max_is_the_reference_s():
    """An empty segment holds -inf, as ``jax.ops.segment_max`` gives."""
    data = np.random.default_rng(3).normal(size=(9, 2)).astype(np.float32)
    ids = np.array([0, 0, 2, 2, 2, 4, 4, 0, 2], np.int32)
    want = np.asarray(jax.ops.segment_max(jnp.asarray(data), jnp.asarray(ids), num_segments=6))
    got = segment_max(torch.from_numpy(data), torch.from_numpy(ids), 6).numpy()
    assert np.array_equal(got, want) and np.isneginf(got[[1, 3, 5]]).all()


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_node_logits_loss_and_every_gradient_match_the_reference(cfg):
    """The classification head and the feature projection against the
    reference's, on one layer (``test_torch_gnn_parity.py`` holds the layer
    stack on molecules)."""
    cfg = dataclasses.replace(cfg, name=cfg.name + "-cls", n_layers=1, d_feat=12, n_classes=5)
    check_against_reference(cfg, feature_graph(), 1)


def _assert_batches_equal(got, want) -> None:
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if w is None or isinstance(w, int):
            assert g == w, f.name
            continue
        w = np.asarray(w)
        assert g.device == CPU and g.numpy().dtype == w.dtype, (f.name, g.dtype, w.dtype)
        assert np.array_equal(g.numpy(), w), f.name


@pytest.mark.parametrize("seed", [0, 5])
def test_generators_equal_the_reference(seed):
    _assert_batches_equal(make_molecule_batch(6, 9, 20, seed=seed, device="cpu"),
                          JG.make_molecule_batch(6, 9, 20, seed=seed))
    _assert_batches_equal(make_feature_graph(300, 1200, 7, n_classes=6, seed=seed, device="cpu"),
                          JG.make_feature_graph(300, 1200, 7, n_classes=6, seed=seed))
    g, jg = CSRGraph.random(2000, 20000, 5, seed=seed), JG.CSRGraph.random(2000, 20000, 5,
                                                                           seed=seed)
    for f in ("indptr", "indices", "feat", "labels"):
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    ps = NeighborSampler(g, [4, 3], 32, seed=seed, device="cpu")
    js = JG.NeighborSampler(jg, [4, 3], 32, seed=seed)
    for _ in range(2):  # the sampler's generator carries over between batches
        _assert_batches_equal(ps.sample(), js.sample())
