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
#: PERF.md): the largest intermediate at which fused is no slower. Fused is
#: slower at both measured shapes, 108,000 bytes (SD's 27,000-term
#: intermediate) and 16,000,000 bytes (AS-recent's 4M-document one): the
#: fused kernel and the hop-2 list the dispatch derives from the reach matrix
#: cost more than the launches fusion saves. So 0: under ``"auto"`` every
#: two-hop region runs unfused; ``fusion="on"`` still fuses it. (The
#: reference's TPU value is 8 MiB of VMEM.)
FUSED_SCRATCH_BUDGET_BYTES = 0

#: The packed and dense hops use the table only on an index whose hottest
#: destination takes at least this share of its edges (``DeviceIndex.hot_share``, from the
#: host dst column where the index is built). Measured on an NVIDIA H100 80GB
#: HBM3 at 700 W by ``scripts/hop_table_probe.py`` (PERF.md) on synthetic
#: indexes of I_DA.Doc's size (11.8M edges, one destination taking a share h
#: of them, the rest spread over 2M): without the table the hop serialises on
#: the hot destination (scan 0.158 ms at h = 0, 0.264 ms at 0.01, 1.67 ms at
#: 0.08), with it it stays at 0.16-0.18 ms; both kernels with the table are
#: no slower from h = 0.003 up in two runs (the scan from 0.002, the active
#: kernel from 0.003). On I_DT.Term (h = 7.6e-7) the table would cost the
#: active kernel about 25%. The main path's indexes lie far from the
#: threshold on both sides: I_DT.Doc 0.094, I_DA.Doc 0.082, SemMedDB's
#: I_PA.PID and I_SP.SID 0.101 take the table; the others are at most 0.00014.
#: The dense pair (the same schedules over a 4-byte dst) takes the same
#: threshold, and so do the batched hops: on the same synthetic indexes at
#: B = 8 their table (a row chunk a slot) is no slower from h = 0.002 up
#: (0.82 ms against 0.98-1.0 per edge at 0.003, 6.5 at 0.08) and equal below
#: (the H100, scripts/spmm_probe.py part 5; PERF.md).
HOP_TABLE_HOT_SHARE = 0.003

#: ``block_skipping="auto"`` builds a hop's block list only on an index of at
#: least this many EDGE_BLOCK-edge blocks; below it the hop scans (``"on"``
#: lists at every size). Set from ``chip_smoke.time_list_threshold`` on an
#: NVIDIA H100 80GB HBM3 at 700 W: the whole hop through ``ops`` with
#: skipping 'off' against 'on' (the list's launch and host time included,
#: CUDA events over back-to-back calls, two rounds in turns) on the first k
#: blocks of I_DA.Doc and I_DT.Term, k from CS's 13 up to I_DT.Term's 7,079,
#: at supports from one seed to every source. With the one-pass list kernel
#: (scripts/launch_probe.py threshold, four processes in one call, the
#: parent's list kernel in two of them) the list was faster in every round
#: at no count below 7,079 in any process, and at 7,079 in three of the four
#: (PERF.md §6): the listed hop is host-bound, and the list kernel's own
#: time (5.7-14.1 µs a launch) is not what decides. An earlier list kernel
#: measured 5,600 on another host. SemMedDB's indexes (13-116 blocks) and
#: I_DA's (2,876) scan under ``"auto"``, and I_DT's (7,079) list.
SKIP_MIN_BLOCKS = 7079

#: The ``fragment_loop`` strategy's scalar walk holds at most this many paths
#: at once: a hop whose paths would exceed it expands its current paths in
#: chunks of this many edges and carries each chunk depth-first through the
#: rest of the plan (the result does not depend on it). 2^24 paths keep the
#: walk's per-hop temporaries (about 60 bytes a path) near 1 GB.
FRAGMENT_LOOP_MAX_PATHS = 1 << 24

#: ``strategy="auto"`` picks ``fragment_loop`` for an id-seeded plan whose
#: worst hop touches less than this fraction of its index's edges (the
#: estimate of ``GQFastEngine._hop_fractions``, or the fractions a
#: ``profile()`` observed), else the frontier. Set from
#: ``chip_smoke.time_crossover`` on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
#: §6): SD and FSD at eight documents and AS at six authors, from 47 paths
#: (a worst fraction of 1.6e-6) to 3e7 (0.92), both strategies in turns for
#: three rounds. The walk lost every round at every point: 1.3-3.3× the
#: frontier's wall at the smallest seeds (47 and 156 paths: 2.65-5.87 ms
#: against 1.75-1.99; its ~90 PyTorch calls and a host read a hop cost more
#: than the frontier's hops) and up to 16× at the largest (3e7 paths:
#: 21.9-22.1 ms against 1.38-1.43). So 0: ``"auto"`` runs the frontier
#: everywhere. (The reference's TPU value is 0.15.)
FRAGMENT_LOOP_CROSSOVER = 0.0
