"""GNN substrate: graph batches, segment-op message passing, radial bases, on
PyTorch.

The JAX package's ``repro.models.gnn.common``, function for function.
Message passing *is* the paper's fragment join-aggregate (DESIGN.md §5): the
edge list + gather → transform → a sum into the destinations is one RelHop
of the GQ-Fast executor. Here the sum is ``index_add`` (the reference's
``jax.ops.segment_sum``, which reaches no Pallas kernel): a deterministic
form on CUDA under ``torch.use_deterministic_algorithms(True)``, as are the
gathers' backward passes (``index_select``).

``edge_hint`` and ``node_hint`` (the reference's sharding constraints on the
production mesh) are identities: the model runs on one device, and the hints
come with ROADMAP Queue 1 item 15c, as ``models/common.py`` says of
``shard_hint``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F


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


def edge_hint(x: torch.Tensor) -> torch.Tensor:
    """The reference's per-edge sharding hint: an identity on one device."""
    return x


def node_hint(x: torch.Tensor) -> torch.Tensor:
    """The reference's per-node sharding hint: an identity on one device."""
    return x


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 (the reference's ``jnp.take(x, idx, axis=0)``)."""
    return torch.index_select(x, 0, idx)


def aggregate(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Sum the messages into their destination nodes (one RelHop): the
    reference's ``segment_sum``, out of place so autograd sees it."""
    out = messages.new_zeros((n_nodes,) + tuple(messages.shape[1:]))
    return node_hint(out.index_add(0, dst, edge_hint(messages)))


def segment_max(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``jax.ops.segment_max`` along dim 0: a segment that no
    id reaches holds ``-inf``."""
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
            "w": (torch.randn((sizes[i], sizes[i + 1]), generator=gen, dtype=torch.float32,
                              device=gen.device) / math.sqrt(sizes[i])).to(dtype),
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
