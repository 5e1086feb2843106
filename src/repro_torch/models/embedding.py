"""EmbeddingBag and model-parallel embedding tables, on PyTorch.

The JAX package's ``repro.models.embedding``: a gather + a segment reduce
(a GQ-Fast fragment lookup + γ hop, DESIGN.md §5), here ``index_select`` and
``index_add`` / ``scatter_reduce`` (deterministic forms on CUDA). The
reference's semantics are kept where ``torch.nn.functional.embedding_bag``'s
differ: a bag that no id reaches is 0 under sum and mean and ``-inf`` under
max (the reference's ``segment_max``; ``embedding_bag`` gives 0).

The sharded lookup row-mod-shards the table over a mesh axis and exchanges
only batch×dim activations (one ``all_reduce``), never gathering the table.
"""
from __future__ import annotations

import numpy as np
import torch

from .gnn.common import aggregate, segment_max


def embedding_bag(
    table: torch.Tensor,  # [V, D]
    ids: torch.Tensor,  # [n_ids] flat ids of all bags
    bag_ids: torch.Tensor,  # [n_ids] which bag each id belongs to
    n_bags: int,
    weights: torch.Tensor | None = None,  # per-id weights
    mode: str = "sum",
) -> torch.Tensor:
    """Ragged multi-hot lookup-and-reduce (torch ``nn.EmbeddingBag`` layout,
    CSR-style (ids, bag offsets→bag_ids)), with the reference's values."""
    vecs = torch.index_select(table, 0, ids)  # [n_ids, D]
    if weights is not None:
        vecs = vecs * weights[:, None]
    if mode == "max":
        return segment_max(vecs, bag_ids, n_bags)
    out = aggregate(vecs, bag_ids, n_bags)
    if mode == "mean":
        cnt = aggregate(torch.ones(ids.shape, dtype=torch.float32, device=ids.device),
                        bag_ids, n_bags)
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out


def sharded_embedding_lookup(
    table: torch.Tensor,  # [ceil(V/n), D]: this rank's rows of the row-mod layout
    ids: torch.Tensor,  # [...] int
    n_shards: int,
    mesh,
    axis_name: str = "model",
) -> torch.Tensor:
    """Lookup for a table partitioned row-mod over ``mesh``'s ``axis_name``
    (a ``DeviceMesh``, ``launch.mesh.make_mesh``): rank r of the axis owns
    rows {v : v % n_shards == r}; every rank looks up its local rows for the
    full id batch (masked) and one ``all_reduce`` over the axis' group sums
    them — the collective moves batch×D, not the table. Differentiable (the
    reference's ``psum``)."""
    from torch.distributed.nn.functional import all_reduce

    r = mesh.get_local_rank(axis_name)
    ids = ids.long()
    local = torch.index_select(table, 0, (ids // n_shards).reshape(-1))
    local = local.reshape(ids.shape + table.shape[1:])
    mask = (ids % n_shards == r).to(table.dtype)
    return all_reduce(local * mask[..., None], group=mesh.get_group(axis_name))


def mod_shard_table(table, n_shards: int):
    """Host-side: reorder a [V, D] table into the row-mod layout expected by
    :func:`sharded_embedding_lookup` ([n_shards · ceil(V/n) rows])."""
    V, D = table.shape
    rows_per = -(-V // n_shards)
    out = np.zeros((n_shards * rows_per, D), table.dtype)
    for rshard in range(n_shards):
        rows = np.arange(rshard, V, n_shards)
        out[rshard * rows_per : rshard * rows_per + rows.shape[0]] = table[rows]
    return out.reshape(n_shards, rows_per, D)
