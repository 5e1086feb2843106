"""Synthetic LM token stream: Zipf-distributed tokens with local n-gram
structure (so the loss has signal to descend), deterministic by
(seed, step, shard), the property the fault-tolerant loop relies on. The
JAX package's stream (``repro.data.lm_data``): the same numpy draws, so the
tokens are identical."""
from __future__ import annotations

import numpy as np
import torch


def lm_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0, shard: int = 0,
             device="cuda") -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard]))
    # Zipf marginals
    u = rng.random((batch, seq))
    toks = np.minimum((vocab ** u).astype(np.int64), vocab - 1)
    # inject learnable bigram structure: token 2i+1 often follows 2i
    follow = rng.random((batch, seq)) < 0.5
    toks[:, 1:] = np.where(follow[:, 1:], (toks[:, :-1] + 1) % vocab, toks[:, 1:])
    t = torch.from_numpy(toks.astype(np.int32)).to(device)
    return {"tokens": t, "labels": t}
