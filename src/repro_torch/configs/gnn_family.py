"""GNN arch configs: the four assigned equivariant/molecular GNNs × the four
assigned graph shapes (the JAX package's ``repro.configs.gnn_family``, config
for config). Edge counts are padded to multiples of 512 so the edge axis
shards over (data×model); non-molecular shapes use synthesized positions and
a node-classification head (DESIGN.md §5). ``make_cell`` lays a shape out on
a production mesh for the dry run (the state replicated, the batch by
``dist.sharding.gnn_input_shardings``; the 'naive' variant turns the edge
hints and remat off); ``smoke`` runs the reduced config through a train step
on ``device``."""
from __future__ import annotations

import dataclasses

import torch

from ..dist.sharding import distribute_tree, gnn_input_shardings, replicated
from ..models.common import MetaGenerator
from ..models.gnn.models import GNNConfig, gnn_init, gnn_loss
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..train.loop import value_and_grad
from ..tree import tree_leaves
from .base import ArchConfig, Cell


def _pad512(n: int) -> int:
    return -(-n // 512) * 512


GNN_SHAPES = {
    # shape_id: nodes, edges, d_feat, n_classes, graphs (0 → node-level)
    "full_graph_sm": dict(n=2708, e=_pad512(10556), d_feat=1433, n_classes=7, graphs=0),
    "minibatch_lg": dict(n=1024 * (1 + 15 + 150), e=1024 * 15 * (1 + 10),
                         d_feat=602, n_classes=41, graphs=0),
    "ogb_products": dict(n=2_449_029, e=_pad512(61_859_140), d_feat=100,
                         n_classes=47, graphs=0),
    "molecule": dict(n=128 * 30, e=128 * 64, d_feat=0, n_classes=0, graphs=128),
}


class GNNArch(ArchConfig):
    kind = "gnn"
    shape_ids = list(GNN_SHAPES)

    def __init__(self, arch_id: str, base: GNNConfig, smoke_cfg: GNNConfig):
        self.arch_id = arch_id
        self.base = base
        self.smoke_cfg = smoke_cfg
        self.opt = AdamWConfig(lr=1e-3, weight_decay=0.0)

    def cfg_for(self, shape_id: str) -> GNNConfig:
        """The full config with ``shape_id``'s feature width and head."""
        sh = GNN_SHAPES[shape_id]
        return dataclasses.replace(
            self.base, d_feat=sh["d_feat"], n_classes=sh["n_classes"]
        )

    def make_cell(self, shape_id: str, mesh, variant: str = "") -> Cell:
        sh = GNN_SHAPES[shape_id]
        cfg = self.cfg_for(shape_id)
        N, E, G = sh["n"], sh["e"], sh["graphs"]

        def meta(shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")

        i32 = torch.int32
        batch_abs = {
            "pos": meta((N, 3)),
            "z": meta((N,), i32),
            "edge_src": meta((E,), i32),
            "edge_dst": meta((E,), i32),
            "node_mask": meta((N,)),
            "edge_mask": meta((E,)),
        }
        if sh["d_feat"]:
            batch_abs["node_feat"] = meta((N, sh["d_feat"]))
        if G:
            batch_abs["graph_ids"] = meta((N,), i32)
            batch_abs["labels"] = meta((G,))
        else:
            batch_abs["labels"] = meta((N,), i32)

        params_abs = gnn_init(cfg, MetaGenerator())
        state_abs = (params_abs, adamw_init(params_abs, self.opt))
        n_graphs = G or 1

        def fn(state, batch):
            from ..models.gnn import common as gcommon, models as gmodels

            gcommon.EDGE_HINTS = variant != "naive"
            gmodels.REMAT = variant != "naive"
            try:
                params, opt_state = state
                (_, metrics), grads = value_and_grad(
                    lambda p, b: gnn_loss(p, b, cfg, n_graphs), params, batch)
            finally:
                gcommon.EDGE_HINTS = True
                gmodels.REMAT = True
            params, opt_state, om = adamw_update(grads, opt_state, params, self.opt)
            return (params, opt_state), {**metrics, **om}

        state_sh = replicated(state_abs, mesh)
        batch_sh = gnn_input_shardings(batch_abs, mesh)
        n_params = sum(x.numel() for x in tree_leaves(params_abs))
        return Cell(self.arch_id, shape_id, fn,
                    (distribute_tree(state_abs, state_sh, mesh),
                     distribute_tree(batch_abs, batch_sh, mesh)),
                    (state_sh, batch_sh), "train", 6.0 * n_params * N)

    def smoke(self, device="cuda") -> dict:
        from ..data.graphs import make_molecule_batch

        cfg = self.smoke_cfg
        batch = make_molecule_batch(batch=4, n_nodes=8, n_edges=16, device=device).as_inputs()
        params = gnn_init(cfg, torch.Generator(device).manual_seed(0))
        opt = adamw_init(params, self.opt)
        (loss, _), grads = value_and_grad(lambda p, b: gnn_loss(p, b, cfg, 4), params, batch)
        params2, _, om = adamw_update(grads, opt, params, self.opt)
        return {
            "loss": float(loss),
            "grad_norm": float(om["grad_norm"]),
            "finite": bool(torch.isfinite(loss))
            and all(bool(torch.isfinite(x).all()) for x in tree_leaves(params2)),
        }


# the four assigned architectures (exact hyperparameters from the assignment)
MACE = GNNArch(
    "mace",
    GNNConfig("mace", "mace", n_layers=2, d_hidden=128, l_max=2, correlation=3,
              n_rbf=8, cutoff=5.0),
    GNNConfig("mace-smoke", "mace", n_layers=2, d_hidden=16, l_max=2,
              correlation=3, n_rbf=8, cutoff=6.0),
)
EGNN = GNNArch(
    "egnn",
    GNNConfig("egnn", "egnn", n_layers=4, d_hidden=64),
    GNNConfig("egnn-smoke", "egnn", n_layers=2, d_hidden=16),
)
EQUIFORMER_V2 = GNNArch(
    "equiformer-v2",
    GNNConfig("equiformer-v2", "equiformer_v2", n_layers=12, d_hidden=128,
              l_max=6, m_max=2, n_heads=8, n_rbf=16, cutoff=8.0),
    GNNConfig("eqv2-smoke", "equiformer_v2", n_layers=2, d_hidden=16, l_max=3,
              m_max=2, n_heads=4, n_rbf=8, cutoff=6.0),
)
SCHNET = GNNArch(
    "schnet",
    GNNConfig("schnet", "schnet", n_layers=3, d_hidden=64, n_rbf=300, cutoff=10.0),
    GNNConfig("schnet-smoke", "schnet", n_layers=2, d_hidden=16, n_rbf=16, cutoff=10.0),
)
