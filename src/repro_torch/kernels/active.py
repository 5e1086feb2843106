"""Frontier-sparsity metadata: per-block src ranges over the CSR-ordered edge
arrays, computed on the host when an index is shipped to the device. Edges are
sorted by src, so the block ranges are a monotone partition of the CSR
offsets; a frontier whose support misses a block's range can skip that block
(the skipping itself comes with ROADMAP Queue 1 item 5)."""
from __future__ import annotations

import numpy as np

from .params import EDGE_BLOCK


def n_edge_blocks(E: int) -> int:
    """Blocks of EDGE_BLOCK edges covering an E-edge index (≥ 1)."""
    return max(1, -(-E // EDGE_BLOCK))


def block_ranges(src_ids) -> tuple[np.ndarray, np.ndarray]:
    """Per-block ``[src_min, src_max]`` over EDGE_BLOCK-sized blocks of the
    CSR-ordered (src-sorted) edge array. Host/numpy — runs once at
    ``build_device_db`` time. An empty relation gets the 1-entry sentinel
    ``([0], [-1])`` whose range intersects no support."""
    src = np.asarray(src_ids)
    E = src.shape[0]
    if E == 0:
        return np.zeros(1, np.int32), np.full(1, -1, np.int32)
    nb = n_edge_blocks(E)
    starts = np.arange(nb, dtype=np.int64) * EDGE_BLOCK
    ends = np.minimum(starts + EDGE_BLOCK, E) - 1
    return src[starts].astype(np.int32), src[ends].astype(np.int32)
