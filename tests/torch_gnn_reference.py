"""The GNN family's reference side for the port's tests: the reference
test's configs, the JAX package's functions compiled once each with
``jax.jit``, its weights carried to the port, and the whole-model check
(outputs, loss and every gradient leaf) that ``test_torch_gnn_parity.py``
and ``test_torch_models_gnn.py`` run.

Tolerances, each a bound on max|port − reference| over max|reference|:
energies, node logits, the loss and every gradient leaf within 1e-4 (float32;
the order of float adds differs: the port sums EquiformerV2's input degrees
inside one product, MACE contracts its einsums in another order).
EquiformerV2's attention output bias (``attn/[1]/b``) has a gradient of 0 in
exact arithmetic: it shifts all of a head's logits at a destination, which
the per-destination softmax cancels. Both packages give rounding noise there
(~1e-11), so that leaf is held, in both, under 1e-4 of the tree's largest
gradient instead of to the reference's noise.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.data import graphs as JG
from repro.models.gnn import models as JM
from repro_torch.convert import graph_batch_from_numpy, params_from_numpy
from repro_torch.models.gnn.models import GNNConfig, gnn_apply, gnn_loss
from repro_torch.train.loop import value_and_grad
from repro_torch.tree import tree_leaves_with_path

TOL = 1e-4

# tests/test_models_gnn.py's configs
CONFIGS = [
    GNNConfig("schnet-s", "schnet", 2, 32, n_rbf=8, cutoff=6.0),
    GNNConfig("egnn-s", "egnn", 2, 32),
    GNNConfig("mace-s", "mace", 2, 16, n_rbf=8, cutoff=6.0, l_max=2, correlation=3),
    GNNConfig("eqv2-s", "equiformer_v2", 2, 16, l_max=3, m_max=2, n_heads=4,
              n_rbf=8, cutoff=6.0),
]
IDS = [c.arch for c in CONFIGS]


@functools.partial(jax.jit, static_argnums=(2, 3))
def J_BOTH(p, b, cfg, n_graphs):
    """The outputs, and the loss with every gradient, in one compile."""
    return JM.gnn_apply(p, b, cfg, n_graphs), jax.value_and_grad(
        JM.gnn_loss, has_aux=True)(p, b, cfg, n_graphs)


def rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jcfg(cfg: GNNConfig):
    return JM.GNNConfig(**dataclasses.asdict(cfg))


J_INIT = jax.jit(JM.gnn_init, static_argnums=0)


@functools.lru_cache(maxsize=None)
def weights(cfg: GNNConfig):
    """(reference params, the port's copy of them)."""
    jp = J_INIT(jcfg(cfg), jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def fields(jbatch) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, int) else v)
            for f in dataclasses.fields(jbatch) for v in [getattr(jbatch, f.name)]}


def pair(jbatch) -> tuple[dict, dict]:
    """(reference inputs, the port's inputs) of one reference batch."""
    return jbatch.as_inputs(), graph_batch_from_numpy(fields(jbatch), "cpu").as_inputs()


def molecule(seed: int = 0):
    return JG.make_molecule_batch(batch=4, n_nodes=8, n_edges=16, seed=seed)


def feature_graph():
    return JG.make_feature_graph(60, 240, d_feat=12, n_classes=5, seed=1)


def check_against_reference(cfg: GNNConfig, jbatch, n_graphs: int) -> None:
    jp, pp = weights(cfg)
    jb, pb = pair(jbatch)
    want, ((jloss, _), jgrads) = J_BOTH(jp, jb, jcfg(cfg), n_graphs)
    with torch.no_grad():
        got = gnn_apply(pp, pb, cfg, n_graphs)
    assert rel(got, want) <= TOL, cfg.name
    (ploss, _), pgrads = value_and_grad(lambda p, b: gnn_loss(p, b, cfg, n_graphs), pp, pb)
    assert abs(float(ploss) - float(jloss)) <= TOL * abs(float(jloss)), cfg.name
    want_g = {"/".join(str(k.key) if hasattr(k, "key") else f"[{k.idx}]" for k in path):
              np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    got_g = dict(tree_leaves_with_path(pgrads))
    assert sorted(got_g) == sorted(want_g)
    scale = max(float(np.abs(w).max()) for w in want_g.values())
    zero = {k for k in got_g if cfg.arch == "equiformer_v2" and k.endswith("/attn/[1]/b")}
    for k in zero:
        assert max(float(got_g[k].abs().max()), float(np.abs(want_g[k]).max())) <= TOL * scale
    worst = max((rel(got_g[k], want_g[k]), k) for k in got_g if k not in zero)
    assert worst[0] <= TOL, (cfg.name, worst)
