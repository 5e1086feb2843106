"""Shared block geometry for the edge-streaming kernels (single source of truth).

``EDGE_BLOCK`` is the granularity of the per-block hop metadata
(``block_src_min`` / ``block_src_max``) that block skipping and the packed
layouts read: 4096 = 4·1024 values, and 1024·width ≡ 0 (mod 32) for every
width 1–32, so each block starts and ends word-aligned in a bit-packed uint32
word stream. The CUDA hop kernel does not tile by it.
"""
from __future__ import annotations

EDGE_BLOCK = 4096  # edges per metadata block; must stay a multiple of 1024
