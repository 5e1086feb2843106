"""The number that decides ``correct``: the widest symmetric relative gap
between a served row and the reference's row, over every entry of every
compared row, |p − r| / max(|p|, |r|) (0 where both are 0). Every query here
sums positive terms, so each entry's own float32 rounding is bounded
relative to the entry; an entry that should be 0 and is not reads 1, as
does a row of the wrong length."""
from __future__ import annotations

import numpy as np
import torch


def max_rel_err(served: list, reference: torch.Tensor) -> float:
    worst = 0.0
    for row, ref in zip(served, reference):
        ref = ref.to(torch.float64)
        if row is None or np.shape(row) != tuple(ref.shape):
            return 1.0
        p = torch.as_tensor(np.asarray(row), device=ref.device).to(torch.float64)
        den = torch.maximum(p.abs(), ref.abs())
        gap = (p - ref).abs()
        if not bool(torch.isfinite(p).all()):
            return 1.0
        rel = torch.where(den > 0, gap / torch.where(den > 0, den, 1.0), 0.0)
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
    return worst
