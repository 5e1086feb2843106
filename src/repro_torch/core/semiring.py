"""Aggregation semirings for the dense γ accumulator, on torch tensors.

Every relationship query reduces, per group key, an aggregate over the set of
join paths reaching that key; the per-path weight is the ⊗-product of the hop
factors. A :class:`Semiring` packages the (⊕, ⊗, 0̄, 1̄) the executor needs so
that SUM/COUNT, MIN/MAX and EXISTS all run through the *same* lowered-IR walker
and the same kernels:

  * ``sum``  — (+, ×, 0, 1): SUM/COUNT, the paper's γ accumulator.
  * ``min``  — (min, ×, +∞, 1): MIN over path scores. Distributes over the hop
    product only for non-negative factors (monotone extension) — the measure
    columns of a GQ-Fast index are counts/frequencies, which satisfy this.
  * ``max``  — (max, ×, −∞, 1): MAX, same monotonicity caveat.
  * ``bool`` — (∨, ∧, 0, 1) on {0,1}: EXISTS / pure reachability; also the
    algebra every IN-subquery mask chain runs under.

AVG is not a semiring element of its own: the executor runs the ``sum``
semiring twice — once weighted, once in count mode (measures suppressed) — and
divides at finalize (the fused SUM+COUNT pair).

The zero element 0̄ marks "no path reaches this entity". ⊗-extension guards it
explicitly (``extend``) because +∞·0 would poison min/max lattices with NaNs,
and predicate masks replace excluded entries by 0̄ (``mask``) instead of
multiplying by 0, which is only correct for the sum semiring.

All frontier vectors are float32. ``segment`` and ``scatter`` reduce into an
output filled with 0̄, so an unreached segment reads 0̄ under every semiring.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# torch.scatter_reduce names of each ⊕
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax", "bool": "amax"}


@dataclass(frozen=True)
class Semiring:
    """The executor-facing contract; all tensors are float32 frontier vectors."""

    name: str  # 'sum' | 'min' | 'max' | 'bool'
    zero: float  # identity of ⊕ ("unreachable")
    one: float = 1.0  # identity of ⊗ (seed weight)

    # -- ⊕ ------------------------------------------------------------------
    def combine(self, a, b):
        if self.name == "sum":
            return a + b
        if self.name == "min":
            return torch.minimum(a, b)
        return torch.maximum(a, b)  # max | bool

    def segment(self, vals, seg_ids, num_segments: int):
        """Scatter-⊕ of per-edge values into the destination domain."""
        out = torch.full(
            (num_segments,), self.zero, dtype=torch.float32, device=vals.device
        )
        return self.scatter(out, seg_ids, vals)

    def preduce(self, x, group):
        """Cross-shard ⊕ in place over ``group`` (the distributed strategy's
        one collective a hop): an ``all_reduce`` with SUM, MIN, or MAX for
        max and bool. Returns ``x``."""
        import torch.distributed as dist

        op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}.get(
            self.name, dist.ReduceOp.MAX)
        dist.all_reduce(x, op=op, group=group)
        return x

    # -- ⊗ ------------------------------------------------------------------
    def extend(self, w, factor):
        """w ⊗ factor with the 0̄ guard (0̄ absorbs: no path stays no path)."""
        if self.name == "sum":
            return w * factor
        if self.name == "bool":
            return ((w > 0) & (factor != 0)).to(torch.float32)
        return torch.where(w == self.zero, self.zero, w * factor)

    # -- structural ops ------------------------------------------------------
    def mask(self, w, keep):
        """Predicate filter: keep where ``keep`` (bool/0-1), else 0̄."""
        return torch.where(keep > 0, w, self.zero)

    def from_mask(self, m):
        """0/1 mask → frontier of 1̄/0̄ (seeding from an intersection mask)."""
        return torch.where(m > 0, self.one, self.zero)

    def binarize(self, w):
        """Semijoin ⋉: collapse path multiplicity to one path (paper §6.1)."""
        if self.name == "sum":
            return (w > 0).to(torch.float32)
        return torch.where(w != self.zero, self.one, self.zero)

    def to_mask(self, w):
        """Accumulator → 0/1 membership mask (mask-producing chains)."""
        if self.name in ("sum", "bool"):
            return (w > 0).to(torch.float32)
        return (w != self.zero).to(torch.float32)

    def finalize(self, w):
        """Output convention: unreached groups report 0, not 0̄."""
        if self.zero == 0.0:
            return w
        return torch.where(w == self.zero, 0.0, w)

    def scatter(self, acc, idx, val):
        """⊕-update of ``acc`` at ``idx`` by ``val`` (a tensor aligned with
        ``idx`` or a scalar). Duplicate indices accumulate under ⊕; returns a
        new tensor. A ``[B, dom]`` accumulator takes a ``[B, k]`` index, row b
        updating row b (flattened to ``b·dom + id``: one scatter for all
        rows)."""
        idx = torch.as_tensor(idx, device=acc.device).to(torch.int64)
        val = torch.as_tensor(val, dtype=torch.float32, device=acc.device)
        val = val.expand(idx.shape)
        if acc.dim() == 2:
            B, dom = acc.shape
            rows = torch.arange(B, dtype=torch.int64, device=acc.device)[:, None] * dom
            flat = (idx + rows).reshape(-1)
            return acc.reshape(-1).scatter_reduce(
                0, flat, val.reshape(-1), reduce=_REDUCE[self.name]).reshape(B, dom)
        return acc.scatter_reduce(0, idx, val, reduce=_REDUCE[self.name])


SUM_PRODUCT = Semiring("sum", zero=0.0)
MIN_PRODUCT = Semiring("min", zero=float("inf"))
MAX_PRODUCT = Semiring("max", zero=float("-inf"))
BOOL_OR_AND = Semiring("bool", zero=0.0)

SEMIRINGS = {
    "sum": SUM_PRODUCT,
    "count": SUM_PRODUCT,
    "avg": SUM_PRODUCT,  # fused SUM+COUNT pair, divided at finalize
    "min": MIN_PRODUCT,
    "max": MAX_PRODUCT,
    "exists": BOOL_OR_AND,
    None: BOOL_OR_AND,  # mask-producing plans are reachability queries
}


def semiring_for(agg: str | None) -> Semiring:
    try:
        return SEMIRINGS[agg]
    except KeyError:
        raise ValueError(f"no semiring registered for aggregate {agg!r}") from None
