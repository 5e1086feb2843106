"""Shared block geometry for the edge-streaming kernels (single source of truth).

``EDGE_BLOCK`` is the granularity of the per-block hop metadata
(``block_src_min`` / ``block_src_max``) that block skipping and the packed
layouts read: 4096 = 4·1024 values, and 1024·width ≡ 0 (mod 32) for every
width 1–32, so each block starts and ends word-aligned in a bit-packed uint32
word stream. The CUDA hop kernel does not tile by it.
"""
from __future__ import annotations

EDGE_BLOCK = 4096  # edges per metadata block; must stay a multiple of 1024

#: ``fusion="auto"`` runs a two-hop fused region in one launch only while its
#: intermediate frontier ``u[n_mid]`` (4 · n_mid bytes of global-memory
#: scratch, L2-resident while it fits the H100's 50 MB L2) is at most this;
#: above it the region runs as the unfused composition. The degenerate
#: region keeps no intermediate, so no budget applies to it. Set from the H100
#: measurement of fused against unfused through the dispatch at the main
#: path's region shapes with every source live (``chip_smoke.py`` phase 5;
#: PERF.md): no slower at 108,000 bytes (SD's 27,000-term intermediate), 8%
#: slower at 16,000,000 bytes (AS-recent's 4M-document one). 128 KiB is the
#: next power of two above the first; sizes between the two are not measured.
#: (The reference's TPU value is 8 MiB of VMEM.)
FUSED_SCRATCH_BUDGET_BYTES = 128 * 2**10
