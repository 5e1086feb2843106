"""GNN substrate: graph batches, segment-op message passing, radial bases, on
PyTorch.

The JAX package's ``repro.models.gnn.common``, function for function.
Message passing *is* the paper's fragment join-aggregate (DESIGN.md §5): the
edge list + gather → transform → a sum into the destinations is one RelHop
of the GQ-Fast executor. Here the sum is ``index_add`` (the reference's
``jax.ops.segment_sum``, which reaches no Pallas kernel): a deterministic
form on CUDA under ``torch.use_deterministic_algorithms(True)``, as are the
gathers' backward passes (``index_select``).

``edge_hint`` and ``node_hint`` are the reference's sharding hints
(``models.common.shard_hint``): over a production mesh they lay per-edge
tensors out edge dim over 'data' and channels over 'model', and per-node
tensors channels over 'model'; on one device they are identities.
``EDGE_HINTS`` turns them off (the 'naive' dry-run variant).

``segment_max`` is a ``scatter_reduce``, which DTensor has no sharding
strategy for: over a mesh it runs in ``local_map`` on replicated operands
(the reference's segment_max is unsharded too: its ids index every node).
``segment_sum`` (``aggregate``'s ``index_add``, and the backward of
``gather``) runs in ``local_map`` over a mesh as well, a partial sum over
the axes that shard the rows (its docstring says why).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F

from ..common import current_mesh, randn, shard_hint


@dataclass
class GraphBatch:
    """Padded, fixed-shape graph batch."""

    pos: torch.Tensor  # [N, 3]
    z: torch.Tensor  # [N] atom types / node categories
    node_feat: torch.Tensor | None  # [N, d_feat] or None
    edge_src: torch.Tensor  # [E]
    edge_dst: torch.Tensor  # [E]
    node_mask: torch.Tensor  # [N] float {0,1}
    edge_mask: torch.Tensor  # [E] float {0,1}
    graph_ids: torch.Tensor | None = None  # [N] for batched small graphs
    n_graphs: int = 1
    labels: torch.Tensor | None = None  # node labels or graph energies

    def as_inputs(self) -> dict:
        out = {
            "pos": self.pos, "z": self.z,
            "edge_src": self.edge_src, "edge_dst": self.edge_dst,
            "node_mask": self.node_mask, "edge_mask": self.edge_mask,
        }
        if self.node_feat is not None:
            out["node_feat"] = self.node_feat
        if self.graph_ids is not None:
            out["graph_ids"] = self.graph_ids
        if self.labels is not None:
            out["labels"] = self.labels
        return out

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``."""
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return GraphBatch(**kw)


EDGE_HINTS = True  # toggled by the 'naive' dry-run variant


def edge_hint(x: torch.Tensor) -> torch.Tensor:
    """Per-edge tensors: edge dim over 'data', channel dim over 'model' (GNN
    tensor parallelism — channels are independent through gathers and
    segment sums, so the TP axis never communicates in message passing)."""
    if not EDGE_HINTS:
        return x
    if x.dim() >= 2:
        return shard_hint(x, "data", "model", *([None] * (x.dim() - 2)))
    return shard_hint(x, "data")


def node_hint(x: torch.Tensor) -> torch.Tensor:
    """Per-node tensors: replicated over nodes (gathers by edge src stay
    local), channel dim over 'model'."""
    if not EDGE_HINTS:
        return x
    if x.dim() >= 2:
        return shard_hint(x, None, "model", *([None] * (x.dim() - 2)))
    return x


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 (the reference's ``jnp.take(x, idx, axis=0)``).
    Its backward is :func:`segment_sum` of the gradient into ``x``'s rows,
    the ``index_add`` that ``index_select``'s own backward runs; over a mesh
    that sum is a partial one, as ``aggregate``'s."""
    return _Gather.apply(x, idx)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = x.shape[0]
        ctx.rows = getattr(x, "placements", None)  # a DTensor's layout
        return torch.index_select(x, 0, idx)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return segment_sum(grad, idx, ctx.n_rows, ctx.rows), None


def aggregate(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Sum the messages into their destination nodes (one RelHop): the
    reference's ``segment_sum``, out of place so autograd sees it."""
    return node_hint(segment_sum(edge_hint(messages), dst, n_nodes))


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int, rows=None) -> torch.Tensor:
    """Rows of ``data`` summed into ``n`` rows by ``ids`` (``index_add``).
    Over a mesh (a DTensor ``data``) the sum runs in ``local_map``; ``rows``
    is the result's layout where it is a gradient's (``gather``'s
    backward). DTensor's own ``index_add`` strategy gathers every rank's
    rows (torch 2.13) or hands the local op the whole index against a shard
    of the rows (torch 2.11)."""
    if hasattr(data, "placements"):  # a DTensor (a backward pass sees no current mesh)
        return _sharded_index_add(data, ids, n, rows)
    return _index_add(data, ids, n)


def _index_add(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    out = messages.new_zeros((n_nodes,) + tuple(messages.shape[1:]))
    return out.index_add(0, dst, messages)


def _index_add_rows(messages: torch.Tensor, dst: torch.Tensor, n_rows: int,
                    r0: int) -> torch.Tensor:
    """:func:`_index_add` into rows ``r0`` .. ``r0 + n_rows`` only (one
    rank's shard of the result); messages to other rows are dropped."""
    local = dst - r0
    keep = (local >= 0) & (local < n_rows)
    w = keep.to(messages.dtype).reshape((-1,) + (1,) * (messages.dim() - 1))
    return _index_add(messages * w, torch.where(keep, local, 0), n_rows)


def _sharded_index_add(messages, dst: torch.Tensor, n_nodes: int, rows=None):
    """:func:`_index_add` of DTensor ``messages`` in ``local_map``. On a
    mesh dim where ``rows`` (the result's layout) shards the result's rows,
    every rank sees every message and keeps its own rows; where the
    messages' rows are sharded, ``dst`` is laid out as they are and the
    result is a partial sum; elsewhere the result is laid out as the
    messages (a dim that a mesh dim does not divide evenly is gathered
    first: ``local_map`` infers the result's shape from even shards)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = messages.device_mesh
    split = [i for i, pl in enumerate(rows or ()) if isinstance(pl, Shard) and pl.dim == 0]
    parts = math.prod(mesh.size(i) for i in split)
    if n_nodes % parts:
        split, parts = [], 1
    ins, idx, out = [], [], []
    for i, pl in enumerate(messages.placements):
        if i in split:
            ins.append(Replicate()), idx.append(Replicate()), out.append(Shard(0))
        elif isinstance(pl, Shard) and pl.dim == 0:
            ins.append(pl), idx.append(Shard(0)), out.append(Partial())
        elif isinstance(pl, Shard) and messages.shape[pl.dim] % mesh.size(i):
            ins.append(Replicate()), idx.append(Replicate()), out.append(Replicate())
        else:
            ins.append(pl), idx.append(Replicate()), out.append(pl)
    fn = functools.partial(_index_add, n_nodes=n_nodes)
    if split:
        coord, rank = mesh.get_coordinate(), 0
        for i in split:
            rank = rank * mesh.size(i) + coord[i]
        fn = functools.partial(_index_add_rows, n_rows=n_nodes // parts,
                               r0=rank * (n_nodes // parts))
    if not isinstance(dst, DTensor):  # a plain index is every rank's
        dst = DTensor.from_local(dst, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return local_map(fn, out_placements=(tuple(out),), in_placements=(tuple(ins), tuple(idx)),
                     device_mesh=mesh, redistribute_inputs=True)(messages, dst)


def segment_max(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``jax.ops.segment_max`` along dim 0: a segment that no
    id reaches holds ``-inf``. Over a mesh (DTensor operands), DTensor has
    no sharding strategy for ``scatter_reduce``: the op runs in
    ``local_map`` on replicated operands, every rank computing the whole
    result."""
    if current_mesh() is not None:
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor.experimental import local_map

        if isinstance(data, DTensor):
            rep = tuple(Replicate() for _ in data.placements)
            return local_map(_segment_max, out_placements=(rep,),
                             in_placements=(rep, rep, None), device_mesh=data.device_mesh,
                             redistribute_inputs=True)(data, ids, n)
    return _segment_max(data, ids, n)


def _segment_max(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = data.new_full((n,) + tuple(data.shape[1:]), -math.inf)
    index = ids.long().view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax", include_self=False)


def edge_vectors(pos: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    vec = gather(pos, src) - gather(pos, dst)
    vec = edge_hint(vec)
    r = torch.sqrt(torch.sum(vec**2, dim=-1) + 1e-12)
    return vec, r


def gaussian_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=r.dtype, device=r.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (r[..., None] - centers) ** 2)


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rr = torch.clamp_min(r[..., None], 1e-6)
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rr / cutoff) / rr


def cosine_cutoff(r: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(r < cutoff, 0.5 * (torch.cos(math.pi * r / cutoff) + 1.0),
                       torch.zeros_like(r))


# ---------------------------------------------------------------------------
# Tiny MLP helper
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, sizes: list[int], dtype=torch.float32) -> list[dict]:
    """The reference's MLP tree: ``w`` normal / sqrt(fan_in), ``b`` zeros, on
    ``gen``'s device."""
    return [
        {
            "w": (randn(gen, (sizes[i], sizes[i + 1])) / math.sqrt(sizes[i])).to(dtype),
            "b": torch.zeros((sizes[i + 1],), dtype=dtype, device=gen.device),
        }
        for i in range(len(sizes) - 1)
    ]


def mlp_apply(params: list[dict], x: torch.Tensor, act=F.silu,
              final_act: bool = False) -> torch.Tensor:
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def readout(node_out: torch.Tensor, batch: dict, n_graphs: int) -> torch.Tensor:
    """Per-graph sum readout (energies) honoring padding."""
    vals = node_out * batch["node_mask"][:, None]
    if "graph_ids" in batch:
        return aggregate(vals, batch["graph_ids"], n_graphs)
    return vals.sum(dim=0, keepdim=True)
