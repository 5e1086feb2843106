"""Graph data pipeline: synthetic graph generators + a CSR neighbor sampler.

The JAX package's ``repro.data.graphs``: the same numpy draws in the same
order, so every batch equals the reference's integer for integer (int32 ids,
float32 positions and features); the tensors go on ``device``.

Shapes follow the assigned grid: full_graph_sm (Cora-like), minibatch_lg
(Reddit-like, sampled via the fanout sampler), ogb_products (large full-batch),
molecule (batched small graphs). Non-molecular graphs get synthesized 3D
positions (DESIGN.md §5).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.gnn.common import GraphBatch


def _t(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype=dtype, device=device)


def make_molecule_batch(
    batch: int = 128, n_nodes: int = 30, n_edges: int = 64, seed: int = 0, device="cuda"
) -> GraphBatch:
    rng = np.random.default_rng(seed)
    N = batch * n_nodes
    pos = rng.normal(size=(batch, n_nodes, 3)) * 2.0
    z = rng.integers(1, 10, size=(batch, n_nodes))
    # per-graph edges: nearest pairs (undirected → both directions), capped
    srcs, dsts = [], []
    for b in range(batch):
        d = np.linalg.norm(pos[b, :, None] - pos[b, None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        order = np.argsort(d, axis=None)[: n_edges // 2]
        i, j = np.unravel_index(order, d.shape)
        srcs.append(np.concatenate([i, j]) + b * n_nodes)
        dsts.append(np.concatenate([j, i]) + b * n_nodes)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    graph_ids = np.repeat(np.arange(batch), n_nodes).astype(np.int32)
    energies = (z.sum(axis=1) * 0.1 + rng.normal(size=batch) * 0.01).astype(np.float32)
    f32, i32 = torch.float32, torch.int32
    return GraphBatch(
        pos=_t(pos.reshape(N, 3), f32, device),
        z=_t(z.reshape(N), i32, device),
        node_feat=None,
        edge_src=_t(src, i32, device),
        edge_dst=_t(dst, i32, device),
        node_mask=torch.ones(N, dtype=f32, device=device),
        edge_mask=torch.ones(src.shape[0], dtype=f32, device=device),
        graph_ids=_t(graph_ids, i32, device),
        n_graphs=batch,
        labels=_t(energies, f32, device),
    )


def make_feature_graph(
    n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 40, seed: int = 0,
    device="cuda",
) -> GraphBatch:
    """Citation/products-like graph: power-law degrees, features, class labels,
    synthesized 3D layout."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-ish edge list
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.zipf(1.6, size=n_edges).astype(np.int64) % n_nodes
    f32, i32 = torch.float32, torch.int32
    return GraphBatch(
        pos=_t(rng.normal(size=(n_nodes, 3)), f32, device),
        z=_t(rng.integers(0, 10, n_nodes), i32, device),
        node_feat=_t(rng.normal(size=(n_nodes, d_feat)) * 0.1, f32, device),
        edge_src=_t(src.astype(np.int32), i32, device),
        edge_dst=_t(dst.astype(np.int32), i32, device),
        node_mask=torch.ones(n_nodes, dtype=f32, device=device),
        edge_mask=torch.ones(n_edges, dtype=f32, device=device),
        labels=_t(rng.integers(0, n_classes, n_nodes), i32, device),
    )


# ---------------------------------------------------------------------------
# Neighbor sampler (minibatch_lg: batch_nodes=1024, fanout 15-10)
# ---------------------------------------------------------------------------


@dataclass
class CSRGraph:
    indptr: np.ndarray
    indices: np.ndarray
    feat: np.ndarray | None
    labels: np.ndarray | None

    @staticmethod
    def random(n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 41, seed: int = 0):
        rng = np.random.default_rng(seed)
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n_nodes), out=indptr[1:])
        feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32) * 0.1 if d_feat else None
        labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
        return CSRGraph(indptr, dst[order].astype(np.int64), feat, labels)


class NeighborSampler:
    """GraphSAGE-style layered uniform fanout sampling over a CSR graph.

    Produces fixed-shape padded subgraph batches: for fanouts [f1, f2] the
    node budget is b·(1 + f1 + f1·f2) and the edge budget b·f1·(1 + f2);
    missing neighbors are masked out. Batches go on ``device``."""

    def __init__(self, graph: CSRGraph, fanouts: list[int], batch_nodes: int, seed: int = 0,
                 device="cuda"):
        self.g = graph
        self.fanouts = fanouts
        self.batch_nodes = batch_nodes
        self.rng = np.random.default_rng(seed)
        self.n_nodes = graph.indptr.shape[0] - 1
        self.device = device

    def sample(self) -> GraphBatch:
        g, rng = self.g, self.rng
        seeds = rng.integers(0, self.n_nodes, self.batch_nodes)
        layer = seeds
        all_src, all_dst, all_mask = [], [], []
        nodes = [seeds]
        for f in self.fanouts:
            deg = g.indptr[layer + 1] - g.indptr[layer]
            # sample f neighbors per node (with replacement; mask deg==0)
            offs = rng.integers(0, 2**31, size=(layer.shape[0], f)) % np.maximum(deg, 1)[:, None]
            nbrs = g.indices[g.indptr[layer][:, None] + offs]
            mask = (deg > 0)[:, None] & np.ones((1, f), bool)
            all_src.append(nbrs.reshape(-1))
            all_dst.append(np.repeat(layer, f))
            all_mask.append(mask.reshape(-1))
            layer = nbrs.reshape(-1)
            nodes.append(layer)
        # relabel nodes to a compact padded id space
        uniq = np.unique(np.concatenate(nodes))
        n_sub = uniq.shape[0]
        src = np.searchsorted(uniq, np.concatenate(all_src))
        dst = np.searchsorted(uniq, np.concatenate(all_dst))
        mask = np.concatenate(all_mask)
        dev, f32, i32 = self.device, torch.float32, torch.int32
        return GraphBatch(
            pos=_t(rng.normal(size=(n_sub, 3)), f32, dev),
            z=_t(uniq % 10, i32, dev),
            node_feat=torch.from_numpy(g.feat[uniq]).to(dev) if g.feat is not None else None,
            edge_src=_t(src.astype(np.int32), i32, dev),
            edge_dst=_t(dst.astype(np.int32), i32, dev),
            node_mask=torch.ones(n_sub, dtype=f32, device=dev),
            edge_mask=_t(mask.astype(np.float32), f32, dev),
            labels=torch.from_numpy(g.labels[uniq]).to(dev) if g.labels is not None else None,
        )
