"""Plain PyTorch versions of the hop kernels: the CPU path, and the yardstick
every CUDA kernel is compared with on the card."""
from __future__ import annotations

import torch

# ⊕-identity per combine op ("no path reaches this entity")
IDENTITY = {
    "sum": 0.0,
    "min": float("inf"),
    "max": float("-inf"),
    "bool": 0.0,
}

_REDUCE = {"sum": "sum", "min": "amin", "max": "amax", "bool": "amax"}


def _edge_product(weights, src_ids, measures, op: str):
    """w[src] ⊗ m per edge with the identity guard non-sum lattices need
    (∞·0 = NaN); an out-of-range src reads the ⊕-identity. ``measures=None``
    means measure 1 on every edge."""
    zero = IDENTITY[op]
    src = src_ids.to(torch.int64)
    n_src = weights.shape[0]
    valid = (src >= 0) & (src < n_src)
    if n_src:
        ws = torch.where(valid, weights[src.clamp(0, n_src - 1)], zero)
    else:
        ws = torch.full(src.shape, zero, dtype=torch.float32, device=weights.device)
    m = 1.0 if measures is None else measures
    if op == "sum":
        return ws * m
    if op == "bool":
        return ((ws > 0) & (torch.as_tensor(m, device=ws.device) != 0)).to(torch.float32)
    return torch.where(ws == zero, zero, ws * m)


def fragment_spmv_ref(
    weights: torch.Tensor,  # f32[n_src]
    src_ids: torch.Tensor,  # i32[E]
    dst_ids: torch.Tensor,  # i32[E]
    measures: torch.Tensor | None,  # f32[E] | None (measure 1)
    n_dst: int,
    op: str = "sum",
) -> torch.Tensor:
    """One relationship hop: y[dst] = ⊕_edges w[src] ⊗ m (the frontier SpMV),
    with the combine op ⊕ selected by the aggregation semiring. The output
    starts at the ⊕-identity, so an unreached dst reads 0 / +∞ / −∞ / 0 —
    for bool that is ``max(segment_max, 0)``."""
    out = torch.full((n_dst,), IDENTITY[op], dtype=torch.float32,
                     device=weights.device)
    prod = _edge_product(weights, src_ids, measures, op)
    return out.scatter_reduce_(0, dst_ids.to(torch.int64), prod,
                               reduce=_REDUCE[op])
