"""The four GNN architectures of the PyTorch port against the JAX package's,
whole, on the CPU: both packages on the same weights (the reference's
``gnn_init``, carried by ``convert.params_from_numpy``) and the same numpy
molecules (carried by ``convert.graph_batch_from_numpy``): energies, the loss
and every gradient leaf (tolerances in ``torch_gnn_reference``); the port's
parameter trees; remat off against on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.models.gnn import models as PM  # noqa: E402
from repro_torch.models.gnn.models import gnn_init, gnn_loss  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

from torch_fixtures import two_threads  # noqa: E402,F401 (autouse)
from torch_gnn_reference import (  # noqa: E402
    CONFIGS,
    IDS,
    check_against_reference,
    molecule,
    pair,
    weights,
)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_energies_loss_and_every_gradient_match_the_reference(cfg):
    check_against_reference(cfg, molecule(), 4)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_parameter_trees_equal_the_reference_s(cfg):
    """The port's own init draws the reference's tree: the same key paths,
    shapes and dtypes, leaf for leaf."""
    jp, _ = weights(cfg)
    want = [(np.asarray(v).shape, np.asarray(v).dtype.name) for v in jax.tree.leaves(jp)]
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for _, t in tree_leaves_with_path(gnn_init(cfg, torch.Generator().manual_seed(0)))]
    assert got == want


def test_remat_changes_no_gradient(monkeypatch):
    """REMAT off (no checkpoint) gives the same loss and gradients bit for
    bit: the checkpointed backward recomputes exactly what the plain one
    saves."""
    cfg = CONFIGS[3]
    _, pp = weights(cfg)
    _, pb = pair(molecule())
    runs = []
    for remat in (True, False):
        monkeypatch.setattr(PM, "REMAT", remat)
        runs.append(value_and_grad(lambda p, b: gnn_loss(p, b, cfg, 4), pp, pb))
    (l1, _), g1 = runs[0]
    (l2, _), g2 = runs[1]
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves_with_path(g1), tree_leaves_with_path(g2)))
