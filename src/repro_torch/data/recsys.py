"""Synthetic click-stream generator for DIN (Zipf item popularity).

The JAX package's ``repro.data.recsys``: the same numpy draws in the same
order, so a batch equals the reference's integer for integer; the tensors go
on ``device``."""
from __future__ import annotations

import numpy as np
import torch


def make_din_batch(
    batch: int,
    seq_len: int = 100,
    n_items: int = 10_000_000,
    n_users: int = 1_000_000,
    n_candidates: int = 0,
    seed: int = 0,
    device="cuda",
) -> dict:
    rng = np.random.default_rng(seed)

    # Zipf-ish popularity without building a 10M-entry prob table
    def zipf_ids(size):
        u = rng.random(size)
        return np.minimum((n_items ** u).astype(np.int64), n_items - 1)

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    hist = zipf_ids((batch, seq_len))
    lengths = rng.integers(5, seq_len + 1, size=batch)
    mask = (np.arange(seq_len)[None, :] < lengths[:, None]).astype(np.float32)
    out = {
        "user": t(rng.integers(0, n_users, batch).astype(np.int32)),
        "hist_items": t(hist.astype(np.int32)),
        "hist_mask": t(mask),
    }
    if n_candidates:
        out["cand_items"] = t(zipf_ids(n_candidates).astype(np.int32))
    else:
        out["cand_item"] = t(zipf_ids(batch).astype(np.int32))
        out["label"] = t(rng.integers(0, 2, batch).astype(np.int32))
    return out
