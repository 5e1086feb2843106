#!/usr/bin/env python3
"""Drive the PyTorch port of GQ-Fast on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases (any failure exits non-zero; nothing is caught while the run goes on):

 1. Card, power limit, torch/CUDA versions; build every CUDA kernel from
    ``src/repro_torch/kernels/csrc`` (nine libraries, one nvcc per source,
    all started together) and report the build times and ptxas
    register/spill lines.
 2. Load a PubMed-shaped graph (4M documents, 27,000 terms, 2M authors) and a
    SemMedDB-shaped graph at 10× the generator's defaults, each twice on the
    card: dense device encodings, and the reference's default
    ``device_encodings="auto"`` (bit-packed keys) built from the same host
    indexes. Device bytes per index and the ratio to dense. The scalar
    walk's path counts per document (SD) and author (AS) on the host, and
    the column store's bytes before and after ``fragment_loop`` prepares and
    runs SD, FSD and AS: unchanged (it reads packed columns by ``gather``,
    no dense copy), the allocator's live bytes beside them.
 3. Kernels against their plain PyTorch versions on the card (sum within
    rtol=atol=1e-4, min/max/bool equal): the dense pair in both forms (the
    per-CTA table and the atomic an edge), scan and active, at
    E ∈ {0, 1, 4097}, at the main path's hop shapes and on synthetic hot
    indexes (one destination, more a block than the table holds, Zipf); the
    list kernel's lists equal to the plain lists, integer for integer, on
    every index of the main path at LIST_SUPPORTS (one seed, 10%, 100%;
    five supports before path p came), single and B = 8; the storage round trip (every packed or
    dict column decoded by ``bitunpack`` equal to the host values);
    ``bitunpack`` at widths 1–32; the packed hop for every op × measure mode ×
    packed/dense dst at E ∈ {0, 1, 4097} and at I_DT.Term / I_DA.Doc (the
    dict mode through a per-column override); both active kernels at support
    fractions from one seed to 100%, equal to the scan and the plain version;
    both fused-region kernels (fused1: hop + output mask; fused2: hop1 → mask
    → binarize → hop2, one cooperative launch), per edge and with the per-CTA
    table in their hops, against the plain region and the unfused
    composition through the port's own kernels, for every op × packed/dense
    dst × measure mode × mask × binarize at E ∈ {1, 4097}, and at the main
    path's region shapes (SD's I_DT.Doc → I_DT.Term at supports from one
    seed to 100%, AS-recent's I_DT.Term + mask + I_DA.Doc over a dense
    frontier, SD-recent's degenerate I_DT.Term + mask) over the device-built
    block lists, in the form the hops' hot shares choose, per edge and with
    the table in every hop. The packed pair's per-CTA aggregation on hot
    destinations: every edge on one destination, more distinct destinations
    in a block than the table has slots, Zipf-hot ones, for every op, scan
    and active, with the table and without. The bitmap AND and popcount at n ∈ {0, 1, 3, 4, 5, 1023,
    1024, 1025, 2^20 + 3} words and on views off a 16-byte boundary, exact.
    3c. CRC-32C (``crc32c.cu``, not a TPU kernel: the integrity layer's hash)
    against its plain version at CRC_SIZES bytes × CRC_OFFSETS offsets off a
    16-byte boundary, from 0 and from a previous value, and the check value
    0xE3069283 of "123456789"; then on every encoded part and decoded view
    of every column of the PubMed cell, value for value.
    3h. The batched kernels: the four SpMM kernels, with the per-CTA table
    and without, at E ∈ {0, 1, 4097} × B ∈ {1, 3, 8, 13, 64} for every op
    and measure (none, shared, per-row [B, E]; packed/dense dst × every
    mode), scan and active over the union list, at I_DT.Term / I_DA.Doc at
    B = 8 (sum and max: PATH_SPMM_OPS; every op before path q came) and on
    the hot destinations above at B = 8 and 13; every row (B ≤
    8; at the path shapes in the form the hot share chooses) against the
    SpMV kernels; the fused regions' SpMM form on the small regions (every
    op) and the main path's regions at B = 8 (sum and max: PATH_REGION_OPS;
    min and bool too before path p came), per edge and with the table,
    against the plain region and the unfused SpMM kernels (each hop in the
    form its hot share chooses).
 4. The main paths, each driven through ``GQFastEngine.query`` /
    ``query_topk`` with every launch counter set to 0 just before and read
    just after:
      a. dense storage, skipping off, fusion off (slice 1): fragment_spmv
         launches equal the HopOps executed;
      b. auto storage, auto skipping, fusion off (slice 2's defaults), the
         nine queries: packed-hop launches (scan + active) equal the HopOps;
         per hop the n_active / n_blocks the list gave;
      c. auto storage, skipping off: packed scan launches equal the HopOps;
      d. dense storage, auto skipping: dense hop launches (scan + active)
         equal the HopOps;
         (in every path that skips, each list is one launch of the list
         kernel: its launches equal the lists built, and it must launch);
      e. a composite measure over a packed column (SUM(dt2.Fre * dt2.Fre) in
         SD's shape): it decodes through bitunpack (its planner path is the
         reference's: tests/test_torch_storage.py runs it in both packages);
      f. the defaults (auto storage, auto skipping, ``fusion="auto"``) over
         the seven queries plus SD-recent and AS-recent, and ``query_topk``:
         fused1/fused2 launches equal the regions executed by kind, packed-hop
         launches the HopOps outside them; the regions that formed and each
         fused plan's prepare time and reach bytes on the card;
      g. ``fusion="on"`` over the same nine queries, accounted the same way;
         fused2 must launch with the table (its hops on I_DT.Doc, I_DA.Doc,
         I_SP.SID and I_PA.PID take it);
      h. batched serving: the defaults through ``execute_batch`` over the
         nine queries at B ∈ {1, 5 (pads to 8), 8, 64}, parameters drawn from
         a seeded generator over ids with edges, and ``query_topk_batch``:
         per batch the SpMM launches (scan + active) and the batched fused
         launches equal the HopOps and regions executed, once a batch
         whatever B is, and no single-query kernel launches; at B = 8 the
         dense SpMM (skipping off and auto) and the packed scan SpMM
         (skipping off) paths, equal to the defaults. Every row of the
         defaults and of the dense paths equals its single call (gated, the
         gate ratios kept; at B = 64 the rows WIDE_BATCH_ROWS, all 64 before
         path p came), B = 8 equals the plain versions run batched with
         float64 sums, the float queries at B = 8 hold to them within
         FLOAT64_LIMIT, and all nine at the quickstart scale match
         ``run_sql`` row by row;
      i. h's B = 8 batches under ``fusion="on"`` (the fused regions' SpMM
         form, fused2 launching with the table), equal to h, to their single
         calls and to the plain versions with float64 sums, all gated (cut
         from h's four sizes to B = 8 when path p came: the other sizes'
         fused SpMM is held to its plain version in 3h and the card tests);
      j. the intersection a user asks for (AD's merge intersection, paper
         §6.1): the document sets of terms 3 and 9 as bitmaps built on the
         card from I_DT.Term (32 documents a word), their AND and its
         popcount through ``ops.bitmap_and`` / ``bitmap_and_popcount`` (one
         launch each), equal to the plain versions, the count equal to
         ``np.intersect1d`` of the two terms' document lists on the host;
      k. ``GQFastEngine(strategy="fragment_loop")`` and ``"auto"`` over the
         nine queries (AS and AS-recent from an author whose walk holds
         about LOOP_AUTHOR_PATHS paths: from a0=7 it would hold ~1.3e12) and
         ``query_topk``: per query no kernel launches at all where the plan
         walks path by path, the frontier's launches where it falls back
         (mask seeds, semijoins) or ``auto`` picks it; ``auto``'s pick per
         query with the estimated and the observed worst fraction; each
         result against the defaults' (exact for the counts, gated) and the
         float sums against the float64 sums within FLOAT64_LIMIT;
         ``execute_batch`` at B = 8 under both, every row against its
         single call;
      l. ``profile()`` and ``explain(analyze=True)`` of SD, AS and AD under
         the defaults and under ``fragment_loop``: the self walls summing to
         ``total_wall_ms``, the observed fractions on the card equal to a
         numpy walk of the same plan on the host (integers), the result
         against ``__call__``'s (exact for the counts, gated: a float sum's
         last bits can differ between two calls on the card) and the
         float64 sums;
      m. the degradation ladder: with no fault plan the nine (k's
         parameters) through ``run_with_policy`` and at B = 8 through
         ``run_batch_with_policy`` all ``ok`` on ``active``; every rung
         (active, unfused, scan, xla — the plain versions —, fragment_loop)
         gated against the defaults; ``ops.`` poisoned lands AD on xla, the
         fused site poisoned lands AS under fusion on on unfused; with
         every kernel's build failing SD and AD end with a KERNEL error on
         active, not on a plain rung; AS from a0 = 7 (1.3e12 paths) on the fragment_loop rung under
         LADDER_DEADLINE_MS returns DEADLINE within it plus the longest
         stretch between two of the walk's deadline reads and the tail from
         the raise to the return, both read in the same run (one chunk's
         walk of ~2^24 paths timed alone beside them); an AdmissionController budget
         between SD's B = 1 and B = 64 estimates demotes B = 64 to serial
         calls equal to ``execute_batch``'s rows; each query's estimated
         working bytes at B = 1 and 8 at least the allocator's measured
         peak;
      n. durability at the PubMed cell (and SemMedDB for CS): each DB
         snapshotted to a temporary directory and restored on the card,
         every CRC verified and the restored manifest equal to a fresh one;
         the nine on the restored DBs against the defaults; one bit of a
         destination in I_DT.Term flipped in place on the card changes
         SD's answer until the scrubber heals the column, and SD after
         ``invalidate_prepared`` equals the original (crc32c must launch
         here); the snapshots kept for o and p;
      o. serving, in process on the main thread: the CI's three lanes (obs, chaos,
         corrupt-and-heal) through ``repro_torch.launch.serve.main`` at
         their own arguments with ``--device cuda`` and the workflow's
         assertions; then SERVE_REQUESTS requests in micro-batches of
         SERVE_BATCH from a fast start of n's PubMed snapshot with a reload
         every SERVE_RELOAD_AT batches (the first publishing generation 2,
         so the swap loads a new one), the scrub gate and ticks, a profile
         and the metrics: every request answered ``ok``, none unserved, a
         reload at least and no failure, the packed SpMM pair, the list and
         CRC-32C launched, every answer held to its batch through the plain
         versions with float64 sums; queries/s micro-batched and
         sequential, p50/p99 a shape, the result copy a batch and the idle
         share of the batches replayed under the profiler, each beside the
         card;
      p. the distributed strategy (``GQFastEngine(db, mesh=...)``, one
         process a rank over ``torch.distributed``, each a child of this
         script: ``chip_smoke.py --path-p-child CONFIG``): (i) a world of 1
         on NCCL, (ii) a world of 4 on the one card over gloo
         (``cpu:gloo,cuda:gloo``: NCCL puts no two ranks on one device),
         then in (ii) a 2×2 ``("data", "model")`` mesh with both axes
         sharded for one batched query. Each rank restores n's snapshots
         with every CRC verified, cuts its shards (bitunpack launches),
         prepares the nine and runs them single, through ``execute_batch``
         at B = 8 and ``profile()`` of SD and AS (prefix-delta), counting
         its launches: ``fragment_spmv`` once a HopOp whose shard has edges,
         ``fragment_spmm`` once such a hop a batch, no packed, fused or
         list kernel. Every rank's answers equal rank 0's bit for bit; rank
         0 holds each answer to the single-card defaults (exact for the
         counts, gated) and the float sums to the plain float64 sums within
         FLOAT64_LIMIT; every batch row equals its single call; each
         query's admission estimate at B = 1 and 8 is at least the
         allocator's peak on the rank; in (ii) a fault on rank 1 only ends
         the query on every rank with the same typed error within the
         group's timeout. Logged beside the card: the median wall a query
         under (i), (ii) and the single-card defaults, each hop's all_reduce
         alone over the wall (the all_reduce's share), each rank's device
         bytes and path p's seconds; the directory removed after p.
      q. the transformer family (``repro_torch.models``, ``optim``,
         ``train``, ``ckpt.manager``, ``configs``; no GQ-Fast kernel runs on
         it, every count of KERNELS read 0 after it), after phase 5 on the
         quiet card, its 12 GB freed before the record is written: (q1)
         Qwen2.5-3B at full width (36 layers, d_model 2048, 16/2 heads, d_ff
         11,008, vocab 151,936, tied, QKV bias; f32 params from a seeded
         generator on the card, bf16 compute) serves the reference server's
         shape, a prefill of 4×32 tokens into a 128-slot cache and 60 greedy
         decode steps: the decode logits at positions 32-35 (and the
         prefill's at 31) within LM_BF16_TOL of ``forward`` over the same 36
         tokens, every logit finite; ms a step, tokens/s, the prefill's ms
         and the peak allocated bytes beside the bound. (q2) Qwen2.5-3B and
         OLMoE-1B-7B at full width cut to 2 layers under f32 compute against
         the same weights on the CPU: Qwen's logits and loss (LM_F32_TOL)
         and every gradient leaf (LM_GRAD_TOL) at 2×64 tokens; OLMoE's
         routing (topi, keep) at 2×512 tokens equal integer for integer, each
         layer's router on the CPU fed the card's input to it. (q3) the train
         step (autograd, then AdamW lr 1e-3) of Qwen2.5-3B at full width cut
         to 2 layers, 8 steps of ``lm_batch(step, 2, 512)``: step ms,
         tokens/s and peak bytes beside 6·N·tokens at 989 TFLOP/s, the loss
         falling. Started before phase 3 and run beside its checks, which
         time nothing (``LMBackground``): q3's gates in a child process under
         ``torch.use_deterministic_algorithms(True)`` and
         ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (``chip_smoke.py
         --path-q3-child``), ``train()`` with checkpoints for the same 8
         steps: the loss falls; a run preempted at step 4 and resumed equals
         the uninterrupted one bit for bit (params and losses); int8 moments
         end within 5% of float32; and (q4) as subprocesses on the card, three
         chains at once, ``python -m repro_torch.launch.serve --workload lm
         --requests 20``, ``python -m repro_torch.launch.train --arch
         llama3-8b --steps 12`` then ``--steps 16 --resume``, the same for
         olmoe-1b-7b, their lines checked; and every LM arch's
         ``smoke(device="cuda")`` finite with (2, vocab) logits.
         ``chip_smoke.py --path-q`` runs path q alone (no kernel built; the
         background part after the rest).
      r. the GNN family and DIN (``repro_torch.models.gnn``, ``models.din``,
         ``models.embedding``, ``data.graphs``, ``data.recsys``; no GQ-Fast
         kernel runs on it, every count of KERNELS read 0 after it), after q
         on the quiet card: (r1) DIN at the reference's full config (embed
         18, seq 100, attention 80-40, MLP 200-80; 10M / 1M / 100k table rows
         from a seeded generator on the card) under DIN_SHAPES' traffic:
         serve_p99 (B = 512) and serve_bulk (B = 262,144) ms a batch,
         examples/s and peak bytes, retrieval_cand (1,000,448 candidates in
         chunks of ``din.RETRIEVAL_CHUNK``) ms and candidates/s with 4,096
         scores against ``din_forward``, train_batch (B = 65,536) 8 AdamW
         steps over 3 batches, each beside max(bytes / 3.35 TB/s, 2 or 6 ·
         active params · B / 67 TFLOP/s); masked history moves no logit; the
         card against the CPU at B = 512 (logits and loss DIN_OUT_TOL, every
         gradient leaf DIN_GRAD_TOL). (r2) MACE, EGNN, EquiformerV2 and SchNet
         at their full configs on ``make_molecule_batch(128, 30, 64)``:
         energies finite, rotation and translation invariance, the card
         against the CPU (EquiformerV2 at EQV2_CPU_LAYERS layers there), 3
         train steps with ms and peak bytes beside a bound from the step's
         GEMM operations. (r3) MACE at full width on minibatch_lg:
         ``NeighborSampler`` (fanouts 15-10, 1,024 seeds) over a random CSR
         graph of Reddit's nodes and features (edges cut 10×), 4 train steps.
         (r4) beside phase 3 (``RBackground``): ``launch.train --arch A
         --steps 12`` then ``--steps 16 --resume`` for the five archs, both
         examples at their default scale, and a child under deterministic
         CUDA (``chip_smoke.py --path-r4-child``): DIN and MACE (smoke
         configs) preempted at step 4 and resumed equal to the uninterrupted
         run bit for bit, every new arch's ``smoke(device="cuda")`` finite.
         ``chip_smoke.py --path-r`` runs path r alone (no kernel built).
      s. the dry run (``repro_torch.launch.dryrun``: meta DTensors over a fake
         process group, no card and nothing allocated), one child process
         started beside phase 3 (``DryRunBackground``, CUDA hidden from it):
         DIN's serve_bulk, train_batch and retrieval_cand and MACE's
         minibatch_lg on a 1×1 mesh, GQ-Fast's as_b8 and Llama-3-8B's
         train_4k on the 16×16 pod mesh, every record ``ok``. After path r,
         each 1×1 record's roofline bound (``roofline.analysis``: the H100's
         989.4 TFLOP/s, 3.35 TB/s and 50 GB/s a link) is held at or under the
         wall path r measured for the same cell (a bound above a measured
         time means the count is wrong), measured over bound logged with the
         record's flops beside path r's count; the two pod records' roofline
         rows printed. ``chip_smoke.py --path-s`` runs paths r and s alone
         (no kernel built).
    Each result is compared with the same lowered plan run through the plain
    versions on the card with float64 sums (each comparison's gate ratio
    logged and kept), the defaults with skipping off and with the dense
    paths (exact for SD/AD/RECENT/CS), the fused paths with fusion off, SD
    with the numpy oracle ``run_sql`` at full scale, and all nine with
    ``run_sql`` at the quickstart scale under the defaults (fusion on too
    before path q came, dense/off before path p came). Every path's float sums (FSD, AS, FAD, AS-recent) are also
    held to the same plan through the plain versions with float64 sums,
    within FLOAT64_LIMIT.
 5. Times: per query the median wall time of QUERY_REPS runs (the defaults, fusion
    on, fusion off and the dense path with skipping off, in turns; the
    defaults' wall over the dense path's) and the profiler's device
    breakdown (the list kernel's launches a run beside the hop kernels');
    per kernel at the main path's shapes its CUDA-event time (the dense pair
    in the form the index's hot share chooses, the other form beside it)
    beside its bound, the plain version's time and one library call
    computing the same function where there is one (``torch.mv`` on a CSR
    matrix, two of them and the mask for a fused region; none for
    bitunpack and the popcount; ``torch.bitwise_and`` for the AND, timed at
    path j's 125,000 words and at 2^26 words); the float32 error of each hop
    kernel's sum on I_DA.Doc's hottest author against float64; scan against
    skip and the cost of the block list at support
    fractions from one seed to 100% (the list kernel a call against the
    plain build's calls, and the whole 'on' and 'auto' hops against the scan
    at 100%, beside the reference's 1.1×), which set ``SKIP_BLOCK_FRACTION``;
    both fused kernels in every form against the unfused composition at each
    region shape, which sets ``FUSED_SCRATCH_BUDGET_BYTES``; the defaults'
    wall over the defaults with skipping off beside their wall over the
    dense path (Queue 3 fault 2 closes at ``AUTO_OVER_SCAN``: logged); the
    whole hop with skipping 'off' against 'on' on the first k blocks of
    I_DA.Doc and I_DT.Term, which sets ``SKIP_MIN_BLOCKS``; every wrapper's
    host µs a call at CS's smallest index; the popcount's device operations
    (its one kernel alone); CRC-32C's kernel time beside its bound and plain
    version on I_DT's packed words and summed over every encoded part and
    decoded view; SD and AS with an integrity manifest attached against
    without (every materialize() verified), auto and dense storage, in
    turns. Batched (5h): per query and B ∈ {1, 8,
    64} the median wall of ``execute_batch`` and queries/s beside B single
    calls, the result copy and the profiler's device time and idle share;
    per SpMM kernel at I_DT.Term / I_DA.Doc and B ∈ {1, 8, 64} its time in
    the form the hot share chooses and in the other, beside its bound, the
    scalar reduction floor, B × the SpMV kernel's, the plain version's (B =
    8) and ``torch.sparse.mm`` on the CSR matrix; the fused regions' SpMM
    form at B = 8 in every form beside the unfused SpMM kernels (held to
    them, and to the float64 sums within ``FLOAT64_LIMIT``). The strategies
    (5k): SD and FSD at documents and AS at authors picked at quantiles of
    the walk's paths, from one fragment to most of an index, the defaults
    and ``fragment_loop`` in turns for CROSSOVER_ROUNDS rounds of QUERY_REPS calls each, which
    sets ``FRAGMENT_LOOP_CROSSOVER``.

Output: progress lines, then the card line, the ``{"kernels": [...]}`` line and
last ``{"ok": true, "device": {...}}``. Everything measured is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Full-scale configuration (see PERF.md "Cells")
PUBMED = dict(n_docs=4_000_000, n_terms=27_000, n_authors=2_000_000, seed=0)
SEMMED = dict(n_concepts=40_000, n_csemtypes=50_000, n_predications=80_000,
              n_sentences=300_000)
QUICKSTART_PUBMED = dict(n_docs=10_000, n_terms=800, n_authors=2_500, seed=7)
QUERY_REPS = 10
KERNEL_REPS = 20
PROFILE_REPS = 5
SUPPORTS = ("one_seed", 0.01, 0.1, 0.5, 1.0)
#: The list kernel's supports in phase 3 (three of SUPPORTS since path p
#: came: the list's cost on the host is its frontiers').
LIST_SUPPORTS = ("one_seed", 0.1, 1.0)

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

OPS = ("sum", "min", "max", "bool")
M_MODES = ("none", "dense", "packed", "dict")
EXACT_QUERIES = ("SD", "AD", "RECENT", "CS", "SD_RECENT")  # counts and memberships
#: The H100's L2: a fused region's intermediate up to this size stays in it.
L2_BYTES = 50 * 2**20

Q_COMPOSITE = """
SELECT dt2.Doc, SUM(dt2.Fre * dt2.Fre)
FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
WHERE dt1.Doc = :d0
GROUP BY dt2.Doc
"""

# kernel name → (module under repro_torch.kernels, counter, source, TPU kernel)
KERNELS = {
    "fragment_spmv": ("fragment_spmv", "LAUNCHES", "fragment_spmv.cu",
                      "src/repro/kernels/fragment_spmv.py:103"),
    "fragment_spmv_active": ("fragment_spmv", "ACTIVE_LAUNCHES", "fragment_spmv.cu",
                             "src/repro/kernels/fragment_spmv.py:180"),
    "bitunpack": ("bitunpack", "LAUNCHES", "bitunpack.cu",
                  "src/repro/kernels/bitunpack.py:83"),
    "fragment_spmv_packed": ("fragment_spmv_packed", "LAUNCHES", "fragment_spmv_packed.cu",
                             "src/repro/kernels/fragment_spmv_packed.py:220"),
    "fragment_spmv_packed_active": ("fragment_spmv_packed", "ACTIVE_LAUNCHES",
                                    "fragment_spmv_packed.cu",
                                    "src/repro/kernels/fragment_spmv_packed.py:287"),
    "fragment_spmv_fused1": ("fragment_spmv_fused", "FUSED1_LAUNCHES",
                             "fragment_spmv_fused.cu",
                             "src/repro/kernels/fragment_spmv_fused.py:297"),
    "fragment_spmv_fused2": ("fragment_spmv_fused", "FUSED2_LAUNCHES",
                             "fragment_spmv_fused.cu",
                             "src/repro/kernels/fragment_spmv_fused.py:331"),
    "fragment_spmm": ("fragment_spmm", "LAUNCHES", "fragment_spmm.cu",
                      "src/repro/kernels/fragment_spmm.py:118"),
    "fragment_spmm_active": ("fragment_spmm", "ACTIVE_LAUNCHES", "fragment_spmm.cu",
                             "src/repro/kernels/fragment_spmm.py:186"),
    "fragment_spmm_packed": ("fragment_spmm_packed", "LAUNCHES", "fragment_spmm_packed.cu",
                             "src/repro/kernels/fragment_spmm.py:240"),
    "fragment_spmm_packed_active": ("fragment_spmm_packed", "ACTIVE_LAUNCHES",
                                    "fragment_spmm_packed.cu",
                                    "src/repro/kernels/fragment_spmm.py:308"),
    "fragment_spmm_fused1": ("fragment_spmv_fused", "SPMM_FUSED1_LAUNCHES",
                             "fragment_spmv_fused.cu",
                             "src/repro/kernels/fragment_spmv_fused.py:297"),
    "fragment_spmm_fused2": ("fragment_spmv_fused", "SPMM_FUSED2_LAUNCHES",
                             "fragment_spmv_fused.cu",
                             "src/repro/kernels/fragment_spmv_fused.py:331"),
    "bitmap_and": ("bitmap_ops", "AND_LAUNCHES", "bitmap_ops.cu",
                   "src/repro/kernels/bitmap_ops.py:45"),
    "bitmap_and_popcount": ("bitmap_ops", "POPCOUNT_LAUNCHES", "bitmap_ops.cu",
                            "src/repro/kernels/bitmap_ops.py:63"),
    # not a TPU kernel: the list build the reference runs inside its jitted
    # program (jnp), which the port ran as 14 eager calls a hop
    "block_list": ("block_list", "LAUNCHES", "block_list.cu",
                   "src/repro/kernels/active.py:102"),
    # not a TPU kernel: CRC-32C of the column store, which the reference
    # computes on the host
    "crc32c": ("crc32c", "LAUNCHES", "crc32c.cu", "src/repro/storage/integrity.py:64"),
}
PACKED_HOPS = ["fragment_spmv_packed", "fragment_spmv_packed_active"]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(title: str, t_start: float) -> None:
    log(f"{title} (at {time.perf_counter() - t_start:.1f} s)")


def mark(what: str, t_start: float) -> None:
    """A step of a phase done: where the phase's seconds go."""
    log(f"    · {what} done (at {time.perf_counter() - t_start:.1f} s)")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_state() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def kmod(name: str):
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{KERNELS[name][0]}")


def reset_counts() -> None:
    from repro_torch.kernels import fragment_spmv_fused as fk

    for name, (_, attr, _, _) in KERNELS.items():
        setattr(kmod(name), attr, 0)
    for k in fk.TABLE_LAUNCHES:
        fk.TABLE_LAUNCHES[k] = 0


def read_table_counts() -> dict:
    """The fused kernels' launches with a table in at least one hop."""
    from repro_torch.kernels import fragment_spmv_fused as fk

    return dict(fk.TABLE_LAUNCHES)


def read_counts() -> dict:
    return {name: getattr(kmod(name), attr) for name, (_, attr, _, _) in KERNELS.items()}


def time_device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def is_hop_kernel(name: str) -> bool:
    """Whether a profiled device kernel is hop time: the hop kernels
    (``fragment_spm*``, the fused regions' included) and the batched hops'
    epilogue, ``rows_from_chunks``. The fill of a row-chunk scratch is a
    PyTorch fill and counts as other time."""
    return "fragment_spm" in name or "rows_from_chunks" in name


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate against
    operations over the fp32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hop_bound(E: int, n_src: int, n_dst: int, dst_bytes: int, m_bytes: int,
              extra: int = 0) -> tuple[float, str]:
    """One hop: src (4 B an edge), the dst and measure streams as stored,
    the frontier and the output once each; a multiply and a combine an edge
    (``roofline.analysis.hop_work``, the count the dry run's GQ-Fast cells
    use)."""
    from repro_torch.roofline.analysis import hop_work

    return bound_ms(*hop_work(E, n_src, n_dst, dst_bytes, m_bytes, extra))


def uses_table(di) -> bool:
    """Whether the main path's packed hop on index ``di`` aggregates per CTA
    (``ops.uses_table`` of its hot share)."""
    from repro_torch.kernels import ops as K

    return K.uses_table(di.hot_share)


#: The largest relative difference allowed between a float query's result
#: and the same plan through the plain versions with float64 sums
#: (:class:`float64_sums`): single calls; execute_batch's rows at B = 8,
#: the defaults' and under fusion on; the fused regions' SpMM form at B = 8
#: (phase 5h). About twice the largest reading on the H100 (PERF.md): every
#: hop that reaches a hot destination, fused or not, single or batched, sums
#: per CTA in its table, and the paths read 0.6e-6-2.4e-6.
FLOAT64_LIMIT = {"single": 5e-6, "batched": 5e-6}


class float64_sums:
    """Within the block the plain hop (``ref.fragment_spmv_ref``, under every
    plain hop, active, packed, fused and batched version) adds a sum's
    products in float64 and rounds each destination's sum to float32 once;
    min, max and bool are left as they are. A plan run with
    ``use_kernel=False`` then gives the float32 chain with exact per-hop
    sums: the yardstick of the kernels' float32 atomics."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import ref

        self.saved = plain = ref.fragment_spmv_ref

        def hop(weights, src_ids, dst_ids, measures, n_dst, op="sum"):
            if op != "sum":
                return plain(weights, src_ids, dst_ids, measures, n_dst, op=op)
            m = measures.double() if isinstance(measures, torch.Tensor) else measures
            prod = ref._edge_product(weights.double(), src_ids, m, op)
            out = torch.zeros(n_dst, dtype=torch.float64, device=weights.device)
            return out.index_add_(0, dst_ids.to(torch.int64), prod).float()

        ref.fragment_spmv_ref = hop

    def __exit__(self, *exc):
        from repro_torch.kernels import ref

        ref.fragment_spmv_ref = self.saved


def gate_ratio(got, want) -> float:
    """max |got - want| / (1e-4 + 1e-4 |want|): at most 1 passes compare's
    rtol = atol = 1e-4."""
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(a - b) / (1e-4 + 1e-4 * np.abs(b))).max()) if a.size else 0.0


def compare_gated(got, want, name: str, what: str, gates: dict) -> float:
    """:func:`compare` (exact for EXACT_QUERIES), a float query's gate ratio
    kept in ``gates[name]`` (the largest)."""
    err = compare(got, want, name in EXACT_QUERIES, what)
    if name not in EXACT_QUERIES:
        gates[name] = max(gates.get(name, 0.0), gate_ratio(got, want))
    return err


def log_gates(what: str, ratios: dict, gates: dict) -> None:
    """Keep and log the gate ratios ({query: ratio}) of a gated comparison."""
    gates[what] = ratios
    log(f"  {what}: gate ratios " + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items()))


def rel_to_f64(got, want) -> float:
    """Largest |got - want| / |want|; where ``want`` is 0, ``got`` must be 0
    too (inf otherwise)."""
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        return float("inf")
    nz = b != 0
    if (a[~nz] != 0).any():
        return float("inf")
    return float((np.abs(a - b)[nz] / np.abs(b[nz])).max()) if nz.any() else 0.0


def compare(got, want, exact: bool, what: str) -> float:
    """Fail unless ``got`` matches ``want``; returns the max abs error over
    the finite entries."""
    import torch

    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if exact:
        if not torch.equal(got, want):
            n = int((got != want).sum())
            raise AssertionError(f"{what}: {n} entries differ (exact comparison)")
    elif not torch.allclose(got, want, rtol=1e-4, atol=1e-4, equal_nan=False):
        diff = (got.double() - want.double()).abs()
        raise AssertionError(f"{what}: max abs err {float(diff.max())} beyond rtol=atol=1e-4")
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError(f"{what}: non-finite entries differ")
    if got.dtype.is_floating_point:
        fin = torch.isfinite(got) & torch.isfinite(want)
        return float((got[fin].double() - want[fin].double()).abs().max()) if fin.any() else 0.0
    return 0.0


def frontier(n: int, op: str, gen, device):
    """A dense random frontier for ``op``: values in (0, 2], 0/1 for bool, and
    for min/max a fifth of the entries at the ⊕-identity."""
    import torch

    w = torch.rand(n, generator=gen, device=device) * 2 + 1e-3
    if op == "bool":
        w = (w > 1).to(torch.float32)
    elif op in ("min", "max"):
        w[torch.rand(n, generator=gen, device=device) < 0.2] = (
            float("inf") if op == "min" else float("-inf")
        )
    return w


def sparse_frontier(w, degrees, support, op: str, seed: int):
    """``w`` with every source outside a random support set to the
    ⊕-identity; the support takes sources in a random order until their edges
    reach ``support`` × E (``"one_seed"``: the single source of median
    degree among those with edges)."""
    import torch

    from repro_torch.kernels.ref import IDENTITY

    deg = degrees.cpu().numpy().astype(np.int64)
    rng = np.random.default_rng(seed)
    if support == "one_seed":
        nz = np.flatnonzero(deg)
        keep = nz[np.argsort(deg[nz], kind="stable")][nz.shape[0] // 2:][:1]
    else:
        order = rng.permutation(deg.shape[0])
        reach = np.cumsum(deg[order])
        keep = order[: int(np.searchsorted(reach, support * reach[-1])) + 1]
    mask = torch.zeros(deg.shape[0], dtype=torch.bool)
    mask[torch.from_numpy(keep)] = True
    out = torch.full_like(w, IDENTITY[op])
    m = mask.to(w.device)
    out[m] = w[m]
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_dense_kernel(db, device) -> tuple[dict, list[dict]]:
    """Phase 3a: the dense pair, scan and active (the list followed, and scan
    order), each with the table and without, against the plain versions at
    E ∈ {0, 1, 4097}, on I_DT.Term and I_DA.Doc, and on the synthetic hot
    indexes of :func:`hot_cases` (dense dst). Returns the worst error by
    kernel and the rows."""
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmv as kernel
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for E in (0, 1, 4097):
        n_src, n_dst = 5000, 300
        src = torch.sort(torch.randint(0, n_src, (E,), generator=gen, device=device)).values
        dst = torch.randint(0, n_dst, (E,), generator=gen, device=device)
        m = torch.rand(E, generator=gen, device=device)
        cases.append((f"E={E}", n_src, src.to(torch.int32), dst.to(torch.int32), m, n_dst))
    dt = db.device.index("DT", "Term")
    da = db.device.index("DA", "Doc")
    cases.append(("I_DT.Term", dt.indptr.shape[0] - 1, dt.src_ids, dt.dst_ids,
                  dt.measures["Fre"], db.schema.domain_size("Document")))
    cases.append(("I_DA.Doc", da.indptr.shape[0] - 1, da.src_ids, da.dst_ids,
                  None, db.schema.domain_size("Author")))
    for name, n_src, src, dst, dw, mwords, n_dst in hot_cases(device):
        if not dw:  # the dense-dst hot indexes
            m = torch.rand(src.shape[0], generator=gen, device=device) * 3
            cases.append((name.split(",")[0], n_src, src, dst, m, n_dst))
    worst = {"fragment_spmv": 0.0, "fragment_spmv_active": 0.0}
    rows = []
    for name, n_src, src, dst, m, n_dst in cases:
        E = int(src.shape[0])
        nb = active.n_edge_blocks(E)
        listed = torch.arange(0, nb, 2, dtype=torch.int32, device=device)  # every other
        na = torch.full((1,), listed.shape[0], dtype=torch.int32, device=device)
        bi = torch.cat([listed, listed[-1:].expand(nb - listed.shape[0])]).contiguous()
        for op in OPS:
            w = frontier(n_src, op, gen, device)
            want = ref.fragment_spmv_ref(w, src, dst, m, n_dst, op=op)
            want_listed = ref.fragment_spmv_active_ref(w, src, dst, m, bi, na, n_dst, op=op)
            for table in (True, False):
                got = kernel.fragment_spmv(w, src, dst, m, n_dst, op=op, table=table)
                what = f"fragment_spmv {name} {op} table={table}"
                err = compare(got, want, op != "sum", what)
                worst["fragment_spmv"] = max(worst["fragment_spmv"], err)
                rows.append({"shape": name, "op": op, "E": E, "table": table,
                             "max_abs_err": err})
                for sa, w_ in ((nb, want_listed), (0, want)):
                    got = kernel.fragment_spmv_active(w, src, dst, m, bi, na, n_dst, op=op,
                                                      scan_above=sa, table=table)
                    err = compare(got, w_, op != "sum",
                                  f"fragment_spmv_active {name} {op} table={table}"
                                  f" scan_above={sa}")
                    worst["fragment_spmv_active"] = max(worst["fragment_spmv_active"], err)
            sync()
        log(f"  dense pair {name:22s} E={E:>9d} scan and active, table on and off, all ops ok")
    return worst, rows


def storage_round_trip(host_dbs) -> dict:
    """Phase 3b: decode every packed or dict column of the auto databases on
    the card with bitunpack; equal to the host values and to the plain
    decode."""
    import torch

    from repro_torch.kernels import bitunpack as bk
    from repro_torch.kernels import ref

    cols = 0
    widths = set()
    for label, db in host_dbs:
        for (t, k), di in db.device.indexes.items():
            idx = db.host_indexes[(t, k)]
            other = next(c for c in idx.columns if c != k and c in
                         (db.schema.relationships[t].fk1, db.schema.relationships[t].fk2))
            for name, col in [(other, di.dst_col), *di.measure_cols.items()]:
                if col.kind == "dense":
                    continue
                got = bk.bitunpack(col.words, col.width, col.count)
                compare(got, ref.bitunpack_ref(col.words, col.width, col.count), True,
                        f"bitunpack {label} I_{t}.{k}/{name} vs plain")
                host = torch.from_numpy(np.asarray(idx.columns[name].values))
                if col.kind == "dict":
                    got = col.dictionary[got.to(torch.int64)]
                    host = host.to(torch.float32)
                else:
                    host = host.to(torch.int32)
                compare(got, host, True, f"bitunpack {label} I_{t}.{k}/{name} vs host")
                cols += 1
                widths.add(col.width)
    sync()
    log(f"  storage round trip: {cols} packed/dict columns decoded on the card equal the"
        f" host values (widths {sorted(widths)})")
    return {"columns": cols, "widths": sorted(widths)}


def check_bitunpack(device) -> float:
    """Phase 3c: bitunpack at every width 1–32 against the plain decode."""
    import torch

    from repro_torch.core.fragments import _pack_words
    from repro_torch.kernels import bitunpack as bk
    from repro_torch.kernels import ref

    rng = np.random.default_rng(5)
    for width in range(1, 33):
        count = 1_000_003
        vals = rng.integers(0, 2**width, size=count, dtype=np.uint64)
        words = torch.from_numpy(_pack_words(vals, width).view(np.int32)).to(device)
        got = bk.bitunpack(words, width, count)
        compare(got, ref.bitunpack_ref(words, width, count), True, f"bitunpack width {width}")
        if not np.array_equal(got.cpu().numpy().view(np.uint32), vals.astype(np.uint32)):
            raise AssertionError(f"bitunpack width {width}: differs from the packed values")
    sync()
    log("  bitunpack widths 1..32 (1,000,003 values each) equal the plain decode")
    return 0.0


def packed_cases(db, dict_db, device):
    """(name, n_src, src, dst operand, dst_width, {m_mode: (measure, mdict,
    m_width)}, n_dst) for the packed-hop checks."""
    import torch

    from repro_torch.core.fragments import _pack_words

    gen = torch.Generator(device=device).manual_seed(2)
    rng = np.random.default_rng(3)
    out = []
    for E in (0, 1, 4097):
        n_src, n_dst = 5000, 300
        src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
        dst = rng.integers(0, n_dst, E)
        mint = rng.integers(0, 40, E)
        midx = rng.integers(0, 5, E)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        words = lambda v, b: t(_pack_words(v, b).view(np.int32))  # noqa: E731
        modes = {"none": (None, None, 0),
                 "dense": (torch.rand(E, generator=gen, device=device), None, 0),
                 "packed": (words(mint, 6), None, 6),
                 "dict": (words(midx, 3), t(np.array([0.5, 3.0, 0.0, 7.25, 1.0], np.float32)), 3)}
        for dst_packed in (True, False):
            d, dw = (words(dst, 9), 9) if dst_packed else (t(dst.astype(np.int32)), 0)
            out.append((f"E={E} dst {'packed' if dst_packed else 'dense'}", n_src, t(src),
                        d, dw, modes, n_dst))
    dt = db.device.index("DT", "Term")
    fre = dt.measure_cols["Fre"]
    dfre = dict_db.device.index("DT", "Term").measure_cols["Fre"]
    if fre.kind != "packed" or dfre.kind != "dict" or dt.dst_col.kind != "packed":
        raise AssertionError(f"I_DT.Term layout: dst {dt.dst_col.kind}, Fre {fre.kind},"
                             f" dict override Fre {dfre.kind}")
    # decoded with the plain version: no materialize memo is left behind
    modes = {"none": (None, None, 0), "dense": (fre.materialize(use_kernel=False), None, 0),
             "packed": (fre.words, None, fre.width),
             "dict": (dfre.words, dfre.dictionary, dfre.width)}
    n_doc = db.schema.domain_size("Document")
    out.append(("I_DT.Term dst packed", dt.indptr.shape[0] - 1, dt.src_ids, dt.dst_col.words,
                dt.dst_col.width, modes, n_doc))
    out.append(("I_DT.Term dst dense", dt.indptr.shape[0] - 1, dt.src_ids,
                dt.dst_col.materialize(use_kernel=False), 0, modes, n_doc))
    da = db.device.index("DA", "Doc")
    out.append(("I_DA.Doc dst packed", da.indptr.shape[0] - 1, da.src_ids, da.dst_col.words,
                da.dst_col.width, {"none": (None, None, 0)}, db.schema.domain_size("Author")))
    return out


def check_packed_kernel(cases, device) -> tuple[float, list[dict]]:
    """Phase 3d: fragment_spmv_packed vs plain, every op × m_mode × dst."""
    import torch

    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(4)
    worst, rows = 0.0, []
    for name, n_src, src, dst, dw, modes, n_dst in cases:
        for m_mode, (m, md, mw) in modes.items():
            for op in OPS:
                w = frontier(n_src, op, gen, device)
                kw = dict(dst_width=dw, m_mode=m_mode, m_width=mw, op=op)
                got = pk.fragment_spmv_packed(w, src, dst, m, md, n_dst, **kw)
                want = ref.fragment_spmv_packed_ref(w, src, dst, m, md, n_dst, **kw)
                sync()
                err = compare(got, want, op != "sum", f"fragment_spmv_packed {name} {m_mode} {op}")
                worst = max(worst, err)
                rows.append({"shape": name, "m_mode": m_mode, "op": op,
                             "E": int(src.shape[0]), "max_abs_err": err})
        log(f"  fragment_spmv_packed {name:22s} E={int(src.shape[0]):>9d}"
            f" m_modes {list(modes)} × all ops ok")
    return worst, rows


def check_active_kernels(db, db_dense, device) -> tuple[dict, list[dict]]:
    """Phase 3e: both active kernels at support fractions from one seed to
    100% on I_DT.Term: skip ('on') and 'auto''s scan order both equal the
    scan kernel and the plain version."""
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(6)
    pt, dt = db.device.index("DT", "Term"), db_dense.device.index("DT", "Term")
    fre, n_dst = pt.measure_cols["Fre"], db.schema.domain_size("Document")
    n_src = pt.indptr.shape[0] - 1
    E = int(pt.src_ids.shape[0])
    nb = active.n_edge_blocks(E)
    worst = {"fragment_spmv_active": 0.0, "fragment_spmv_packed_active": 0.0}
    rows = []
    for support in SUPPORTS:
        for op in OPS:
            w = sparse_frontier(frontier(n_src, op, gen, device), pt.degrees, support, op, 7)
            bi, na = active.active_block_list(w, ref.IDENTITY[op], pt.block_src_min,
                                              pt.block_src_max)
            n_act = int(na[0])
            exact = op != "sum"
            kw = dict(dst_width=pt.dst_col.width, m_mode="packed", m_width=fre.width, op=op)
            scan_p = pk.fragment_spmv_packed(w, pt.src_ids, pt.dst_col.words, fre.words,
                                             None, n_dst, **kw)
            scan_d = dk.fragment_spmv(w, dt.src_ids, dt.dst_ids, dt.measures["Fre"], n_dst, op=op)
            plain_d = ref.fragment_spmv_active_ref(w, dt.src_ids, dt.dst_ids,
                                                   dt.measures["Fre"], bi, na, n_dst, op=op)
            for scan_above in (nb, 0):  # follow the list; scan order
                got = pk.fragment_spmv_packed_active(w, pt.src_ids, pt.dst_col.words,
                                                     fre.words, None, bi, na, n_dst,
                                                     scan_above=scan_above, **kw)
                what = f"packed_active {support} {op} scan_above={scan_above}"
                e1 = compare(got, scan_p, exact, f"{what} vs scan")
                e2 = compare(got, ref.fragment_spmv_packed_active_ref(
                    w, pt.src_ids, pt.dst_col.words, fre.words, None, bi, na, n_dst,
                    scan_above=scan_above, **kw), exact, f"{what} vs plain")
                worst["fragment_spmv_packed_active"] = max(
                    worst["fragment_spmv_packed_active"], e1, e2)
                got = dk.fragment_spmv_active(w, dt.src_ids, dt.dst_ids, dt.measures["Fre"],
                                              bi, na, n_dst, op=op, scan_above=scan_above)
                what = f"dense active {support} {op} scan_above={scan_above}"
                e1 = compare(got, scan_d, exact, f"{what} vs scan")
                e2 = compare(got, plain_d, exact, f"{what} vs plain")
                worst["fragment_spmv_active"] = max(worst["fragment_spmv_active"], e1, e2)
            sync()
            rows.append({"support": support, "op": op, "n_active": n_act, "n_blocks": nb})
        log(f"  active kernels, support {support}: {n_act}/{nb} blocks active;"
            f" skip == scan order == scan == plain for every op")
    return worst, rows


def check_block_lists(dbs, device) -> tuple[float, list[dict]]:
    """Phase 3k: the list kernel against the plain list (``active.active_block_list``)
    on every index of the main path's databases, at supports from one seed
    to 100%, for one frontier and for B = 8 rows (each row its own support
    of that size): block_idx, n_active and the flags equal, integer for
    integer. The op's identity cycles through the four ops."""
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import block_list as lk
    from repro_torch.kernels.ref import IDENTITY

    gen = torch.Generator(device=device).manual_seed(26)
    rows, n = [], 0
    for label, d in dbs:
        for (table, key), di in d.device.indexes.items():
            n_src, nb = di.indptr.shape[0] - 1, int(di.block_src_min.shape[0])
            for i, support in enumerate(LIST_SUPPORTS):
                op = OPS[i % len(OPS)]
                for B in (1, 8):
                    ws = [sparse_frontier(frontier(n_src, op, gen, device), di.degrees, support,
                                          op, 300 + b) for b in range(B)]
                    w = ws[0] if B == 1 else torch.stack(ws).contiguous()
                    want = active.active_block_list(w, IDENTITY[op], di.block_src_min,
                                                    di.block_src_max)
                    flags = active.active_flags(active.support_mask(w, IDENTITY[op]),
                                                di.block_src_min, di.block_src_max)
                    bi, na, fl = lk.block_list(w, IDENTITY[op], di.block_src_min,
                                               di.block_src_max, flags=True)
                    sync()
                    what = f"block_list {label} I_{table}.{key} {support} B={B} {op}"
                    compare(bi, want[0], True, f"{what} block_idx")
                    compare(na, want[1], True, f"{what} n_active")
                    compare(fl, flags, True, f"{what} flags")
                    rows.append({"index": f"{label} I_{table}.{key}", "support": support,
                                 "B": B, "op": op, "n_active": int(na[0]), "n_blocks": nb})
                    n += 1
            log(f"  block_list {label} I_{table}.{key} ({nb} blocks): lists equal the plain"
                f" lists at supports {list(LIST_SUPPORTS)}, B 1 and 8 (n_active "
                + ", ".join(str(r["n_active"]) for r in rows[-2 * len(LIST_SUPPORTS):]) + ")")
    log(f"  block_list: {n} lists equal the plain lists, integer for integer")
    return 0.0, rows


#: Phase 3's bitmap lengths, in words: a CTA's vector words are 1024.
BITMAP_SIZES = (0, 1, 3, 4, 5, 1023, 1024, 1025, 2**20 + 3)
#: Phase 5's bandwidth shape for the bitmap kernels: 256 MB an operand.
BITMAP_BIG_WORDS = 2**26


def check_bitmap(device) -> dict:
    """Phase 3i: the bitmap AND and popcount against their plain versions,
    exact, at every length of BITMAP_SIZES (0: no launch) and on views off a
    16-byte boundary (one operand: scalar words; both alike: scalar head and
    tail around uint4 words)."""
    import torch

    from repro_torch.kernels import bitmap_ops as bm
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(21)

    def words(n):
        return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, generator=gen,
                             device=device)

    def both(a, b, what):
        got = bm.bitmap_and(a, b)
        compare(got, ref.bitmap_and_ref(a, b), True, f"bitmap_and {what}")
        pc = bm.bitmap_and_popcount(a, b)
        if pc.shape != () or pc.dtype != torch.int32:
            raise AssertionError(f"bitmap_and_popcount {what}: {pc.dtype} {tuple(pc.shape)}")
        compare(pc, ref.bitmap_and_popcount_ref(a, b), True, f"bitmap_and_popcount {what}")

    n_cases = 0
    for n in BITMAP_SIZES:
        a, b = words(n), words(n)
        both(a, b, f"n={n}")
        n_cases += 1
        if n == 2**20 + 3:
            both(a[1:], b[:-1], f"n={n - 1} a[1:] beside b[:-1]")
            both(a[3:], b[3:], f"n={n - 3} a[3:] beside b[3:]")
            n_cases += 2
    if int(bm.bitmap_and_popcount(*(torch.full((70_001,), -1, dtype=torch.int32,
                                                 device=device),) * 2)) != 32 * 70_001:
        raise AssertionError("bitmap_and_popcount: full words do not count 32 bits each")
    sync()
    log(f"  bitmap_and, bitmap_and_popcount: {n_cases + 1} cases (n {list(BITMAP_SIZES)},"
        f" views off 16 bytes, full words) equal the plain versions exactly")
    return {"bitmap_and": 0.0, "bitmap_and_popcount": 0.0}


def hot_cases(device):
    """Packed-hop streams whose destinations stress the aggregation table:
    every edge on one destination; more distinct destinations in each
    4096-edge block than the table has slots; Zipf-hot destinations."""
    import torch

    from repro_torch.core.fragments import _pack_words

    rng = np.random.default_rng(22)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    n_src, n_dst, E = 50_000, 20_000, 3 * 4096 + 5
    out = []
    for name, dst in (
        ("one destination", np.full(E, 11)),
        ("4096 distinct a block", np.concatenate([rng.permutation(n_dst)
                                                  for _ in range(E // n_dst + 1)])[:E]),
        ("Zipf", np.minimum(rng.zipf(1.3, E) - 1, n_dst - 1)),
    ):
        src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
        mint = rng.integers(0, 40, E)
        for dst_packed in (True, False):
            d, dw = ((t(_pack_words(dst, 15).view(np.int32)), 15) if dst_packed
                     else (t(dst.astype(np.int32)), 0))
            out.append((f"{name}, dst {'packed' if dst_packed else 'dense'}", n_src, t(src),
                        d, dw, t(_pack_words(mint, 6).view(np.int32)), n_dst))
    return out


def check_hot_packed(device) -> float:
    """Phase 3j: the packed pair's per-CTA aggregation on hot_cases, every op,
    measure none and packed, scan and active (the list followed, and scan
    order with n_active above scan_above), against the plain versions, with
    the table and without it."""
    import torch

    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(23)
    worst, n = 0.0, 0
    for name, n_src, src, dst, dw, mwords, n_dst in hot_cases(device):
        E = int(src.shape[0])
        nb = -(-E // 4096)
        bi = torch.arange(nb, dtype=torch.int32, device=device)
        na = torch.full((1,), nb, dtype=torch.int32, device=device)
        for m_mode, m, mw in (("none", None, 0), ("packed", mwords, 6)):
            for op in OPS:
                w = frontier(n_src, op, gen, device)
                kw = dict(dst_width=dw, m_mode=m_mode, m_width=mw, op=op)
                want = ref.fragment_spmv_packed_ref(w, src, dst, m, None, n_dst, **kw)
                for table in (True, False):
                    got = [pk.fragment_spmv_packed(w, src, dst, m, None, n_dst, table=table,
                                                   **kw)]
                    got += [pk.fragment_spmv_packed_active(w, src, dst, m, None, bi, na, n_dst,
                                                           scan_above=sa, table=table, **kw)
                            for sa in (nb, 0)]
                    sync()
                    for g, sched in zip(got, ("scan", "active", "active in scan order")):
                        worst = max(worst, compare(
                            g, want, op != "sum",
                            f"packed {sched} {name} {m_mode} {op} table={table}"))
                        n += 1
    log(f"  packed pair on hot destinations: {n} cases (one destination, more destinations"
        f" a block than table slots, Zipf; every op; scan and active; the table on and off)"
        f" equal the plain versions")
    return worst


def small_regions(device):
    """Fused-region inputs at E ∈ {1, 4097}: hop1 5000 → 700, hop2 700 → 500
    (E + 3 edges), for packed and dense dst and every measure mode; a mid
    mask over the 700 and an output mask over them for the degenerate
    region."""
    import torch

    from repro_torch.core.fragments import _pack_words
    from repro_torch.kernels.ref import HopStreams

    rng = np.random.default_rng(12)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    words = lambda v, b: t(_pack_words(v, b).view(np.int32))  # noqa: E731
    mdict = t(np.array([0.5, 3.0, 0.0, 7.25, 1.0], np.float32))
    out = []
    for E in (1, 4097):
        hops = []
        for n_src, n_dst, n in ((5000, 700, E), (700, 500, E + 3)):
            src = t(np.sort(rng.integers(0, n_src, n)).astype(np.int32))
            dst = rng.integers(0, n_dst, n)
            mint, midx = rng.integers(0, 40, n), rng.integers(0, 5, n)
            hops.append({(dp, mm): HopStreams(
                src, words(dst, 10) if dp else t(dst.astype(np.int32)),
                {"none": None, "dense": t(mint.astype(np.float32)), "packed": words(mint, 6),
                 "dict": words(midx, 3)}[mm], mdict if mm == "dict" else None,
                10 if dp else 0, mm, {"none": 0, "dense": 0, "packed": 6, "dict": 3}[mm])
                for dp in (True, False) for mm in M_MODES})
        keep = t((rng.random(700) < 0.6).astype(np.float32))
        out.append((E, hops[0], hops[1], keep))
    return out


def full_lists(E: int, device):
    import torch

    from repro_torch.kernels.active import n_edge_blocks

    nb = n_edge_blocks(E)
    return (torch.arange(nb, dtype=torch.int32, device=device),
            torch.full((1,), nb, dtype=torch.int32, device=device))


def unfused_region(w, s1, s2, mask, lists, n_mid, n_dst, op, binz, tables=(True, True)):
    """A region through the port's own unfused kernels: the packed hop over
    each list (lists=None: the scan kernel), the mask and binarize between;
    a [B, n] frontier goes through the packed SpMM kernels; ``tables`` is
    each hop's form (True: the per-CTA table, False: per edge)."""
    from repro_torch.kernels import fragment_spmm_packed as spk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    scan, act = ((spk.fragment_spmm_packed, spk.fragment_spmm_packed_active) if w.dim() == 2
                 else (pk.fragment_spmv_packed, pk.fragment_spmv_packed_active))

    def hop(x, h, n, bl, table):
        kw = dict(dst_width=h.dst_width, m_mode=h.m_mode, m_width=h.m_width, op=op,
                  table=table)
        if bl is None:
            return scan(x, h.src, h.dst, h.measure, h.mdict, n, **kw)
        return act(x, h.src, h.dst, h.measure, h.mdict, *bl, n, **kw)

    u = hop(w, s1, n_mid, None if lists is None else lists[:2], tables[0])
    if mask is not None:
        u = ref.apply_mask(u, mask, op)
    if s2 is None:
        return u
    if binz:
        u = ref.binarize(u, op)
    return hop(u, s2, n_dst, None if lists is None else lists[2:], tables[-1])


#: The table flags the small regions' fused kernels run with: per edge, and
#: the table in every hop.
SMALL_FORMS = (False, True)


def check_fused_small(device) -> tuple[dict, int]:
    """Phase 3f: both fused kernels at E ∈ {1, 4097} for every op × dst ×
    measure mode × mask × binarize, per edge and with the table in every
    hop, against the plain region and the unfused composition through the
    port's kernels (the table form)."""
    from repro_torch.kernels import fragment_spmv_fused as fk
    from repro_torch.kernels import ref

    import torch

    gen = torch.Generator(device=device).manual_seed(13)
    worst = {"fragment_spmv_fused1": 0.0, "fragment_spmv_fused2": 0.0}
    n = 0
    for E, h1s, h2s, keep in small_regions(device):
        l1, l2 = full_lists(E, device), full_lists(E + 3, device)
        for (dp, mm), s1 in h1s.items():
            s2 = h2s[(dp, mm)]
            for op in OPS:
                w = frontier(5000, op, gen, device)
                for two, mask, binz in ((True, False, False), (True, True, False),
                                        (True, False, True), (True, True, True),
                                        (False, False, False), (False, True, False)):
                    mk = keep if mask else None
                    want = ref.fragment_spmv_fused_ref(w, s1, s2 if two else None, mk, 700, 500,
                                                       op=op, mid_binarize=binz)
                    unf = unfused_region(w, s1, s2 if two else None, mk, None, 700, 500, op,
                                         binz)
                    for table in SMALL_FORMS:
                        if two:
                            got = fk.fragment_spmv_fused2(w, s1, s2, mk, *l1, *l2, 700, 500,
                                                          op=op, mid_binarize=binz,
                                                          table1=table, table2=table)
                        else:
                            got = fk.fragment_spmv_fused1(w, s1, mk, *l1, 700, op=op,
                                                          table=table)
                        what = (f"fused{2 if two else 1} E={E} dst"
                                f" {'packed' if dp else 'dense'} {mm} {op} mask={mask}"
                                f" binarize={binz} table={table}")
                        e1 = compare(got, want, op != "sum", f"{what} vs plain")
                        e2 = compare(got, unf, op != "sum", f"{what} vs unfused kernels")
                        k = f"fragment_spmv_fused{2 if two else 1}"
                        worst[k] = max(worst[k], e1, e2)
                        n += 1
    sync()
    log(f"  fused kernels: {n} small regions (E 1 and 4097 × dst × measure mode × op ×"
        f" mask × binarize × per edge / table) equal the plain region and the unfused"
        f" kernels")
    return worst, n


def region_specs(db, SG, device) -> list[dict]:
    """The main path's fused regions at full scale, each taken from a plan
    prepared on the auto database (so its operands, mask and reach are the
    engine's): SD's two-hop region under 'on', AS-recent's masked two-hop
    region under 'on', SD-recent's degenerate region under 'auto'."""
    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastEngine
    from repro_torch.core.semiring import semiring_for

    eng = GQFastEngine(db)
    out = []
    for name, q, fusion, pick in (
        ("SD I_DT.Doc->I_DT.Term", SG.QUERY_SD, "on", 0),
        ("AS-recent I_DT.Term+mask+I_DA.Doc", SG.QUERY_AS_RECENT, "on", -1),
        ("SD-recent I_DT.Term+mask", SG.QUERY_SD_RECENT, "auto", -1),
    ):
        t0 = time.perf_counter()
        pq = eng.prepare(q, fusion=fusion)
        t_prep = time.perf_counter() - t0
        region = [op for op in pq.phys.ops if type(op).__name__ == "FusedHopOp"][pick]
        interp = X._FrontierInterp({}, semiring_for("sum"), device=device,
                                   block_skipping="on", fusion=fusion, reach=pq.fn.reach)
        h1_op, hop1, hop2, mask, binz = interp._fused_region_args(region)
        out.append(dict(name=name, region=region, hop1=hop1, hop2=hop2, mask=mask,
                        binarize=binz,
                        n_src=int(db.device.index(h1_op.table, h1_op.src_key).degrees.shape[0]),
                        degrees=db.device.index(h1_op.table, h1_op.src_key).degrees,
                        prepare_s=t_prep,
                        reach_bytes=sum(r.numel() for r in pq.fn.reach.values()),
                        # the mean of each two-hop region's reach matrix:
                        # 'auto' forms a region only up to REACH_DENSITY_MAX
                        reach_density=[float(r.float().mean()) for r in pq.fn.reach.values()]))
    return out


def region_flags(spec, form: str = "ops") -> tuple:
    """The table flags, a hop, of ``spec``'s region kernel in ``form``:
    "ops" what the dispatch chooses from each hop's hot share (the main
    path's form), "per_edge" none, "table" every hop's."""
    from repro_torch.kernels import ops as K

    hops = [h for h in (spec["hop1"], spec["hop2"]) if h is not None]
    if form == "ops":
        return tuple(K.uses_table(h.hot_share) for h in hops)
    return tuple(form == "table" for _ in hops)


def region_forms(spec) -> dict:
    """{form: flags} of the region's kernel forms, each distinct set of
    flags once, "ops" (the main path's) first."""
    out = {}
    for form in ("ops", "per_edge", "table"):
        flags = region_flags(spec, form)
        if flags not in out.values():
            out[form] = flags
    return out


def form_checks(spec, w, op, lists, device, every_form: bool = True):
    """{form: (flags, plain region, unfused region)} for every form of
    ``spec``'s region kernel (:func:`region_forms`; ``every_form`` False: the
    main path's alone) over ``w``: the unfused
    kernels (the scan, each hop in the form's own flag) and the plain region
    over ``lists``, for sum with float64 sums where the form takes the table
    on every hop whose hot share asks for it (the per-CTA sums land that
    close to exact), else with the float32 scatter, whose per-edge drift on
    hot destinations (~1e-4 relative on I_DA.Doc's top authors) the per-edge
    form shares."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    h1, h2 = spec["hop1"], spec["hop2"]
    s1 = K._streams(h1, device)
    s2 = K._streams(h2, device) if h2 is not None else None
    n_dst = h2.n_dst if h2 is not None else h1.n_dst
    plain = ref.fragment_spmm_fused_ref if w.dim() == 2 else ref.fragment_spmv_fused_ref

    def run():
        return plain(w, s1, s2, spec["mask"], h1.n_dst, n_dst, op=op,
                     mid_binarize=spec["binarize"], lists=lists)

    want32 = run()
    want64 = want32
    if op == "sum":
        with float64_sums():
            want64 = run()
    hot = region_flags(spec, "ops")
    out = {}
    for form, flags in region_forms(spec).items():
        if not every_form and form != "ops":
            continue
        covered = all(f or not t for f, t in zip(flags, hot))
        out[form] = (flags, want64 if covered else want32,
                     unfused_region(w, s1, s2, spec["mask"], None, h1.n_dst, n_dst, op,
                                    spec["binarize"], flags))
    return out


def region_call(spec, w, op, lists, device, form: str = "ops"):
    """The fused kernel of ``spec``'s region over ``lists`` in ``form``
    (:func:`region_flags`): the SpMV form for a ``[n]`` frontier, the SpMM
    form for ``[B, n]`` rows."""
    from repro_torch.kernels import fragment_spmv_fused as fk
    from repro_torch.kernels import ops as K

    rows = w.dim() == 2
    s1 = K._streams(spec["hop1"], device)
    n_mid = spec["hop1"].n_dst
    flags = region_flags(spec, form)
    if spec["hop2"] is None:
        f1 = fk.fragment_spmm_fused1 if rows else fk.fragment_spmv_fused1
        return lambda: f1(w, s1, spec["mask"], *lists[:2], n_mid, op=op, table=flags[0])
    f2 = fk.fragment_spmm_fused2 if rows else fk.fragment_spmv_fused2
    s2 = K._streams(spec["hop2"], device)
    return lambda: f2(w, s1, s2, spec["mask"], *lists, n_mid, spec["hop2"].n_dst, op=op,
                      mid_binarize=spec["binarize"], table1=flags[0], table2=flags[1])


def check_fused_regions(specs, device) -> dict:
    """Phase 3g: both fused kernels at the main path's region shapes over the
    device-built lists, in every form (:func:`region_forms`: the table where
    the hop's hot share asks for it, per edge, the table in every hop),
    against the plain region and the unfused scan composition in the same
    form (:func:`form_checks`): SD's region at LIST_SUPPORTS (the five of
    SUPPORTS before path q came; 0.1 in the main path's form alone),
    AS-recent's over a dense frontier, SD-recent's at one seed and 100%."""
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(14)
    worst = {"fragment_spmv_fused1": 0.0, "fragment_spmv_fused2": 0.0}
    rows = []
    for spec, supports in zip(specs, (LIST_SUPPORTS, (1.0,), ("one_seed", 1.0))):
        h1, h2 = spec["hop1"], spec["hop2"]
        E1 = int(h1.src_ids.shape[0])
        E2 = int(h2.src_ids.shape[0]) if h2 is not None else 0
        k = "fragment_spmv_fused2" if h2 is not None else "fragment_spmv_fused1"
        for support in supports:
            for op in OPS:
                w = sparse_frontier(frontier(spec["n_src"], op, gen, device), spec["degrees"],
                                    support, op, 15)
                lists = K._fused_block_lists(w, op, h1, h2, E1, E2, "on")
                exact = op != "sum"
                checks = form_checks(spec, w, op, lists, device, support in ("one_seed", 1.0))
                for form, (_, want, unf) in checks.items():
                    got = region_call(spec, w, op, lists, device, form)()
                    what = f"{k} {spec['name']} {support} {op} {form}"
                    e1 = compare(got, want, exact, f"{what} vs plain")
                    e2 = compare(got, unf, exact, f"{what} vs unfused scan")
                    worst[k] = max(worst[k], e1, e2)
            na = [int(lists[1][0])] + ([int(lists[3][0])] if h2 is not None else [])
            rows.append({"region": spec["name"], "support": support, "n_active": na,
                         "n_blocks": [-(-E1 // 4096)] + ([-(-E2 // 4096)] if E2 else [])})
            log(f"  {k} {spec['name']}: support {support}: lists {na} of"
                f" {rows[-1]['n_blocks']} blocks; fused == plain == unfused for every op and"
                f" form {list(checks)}")
    sync()
    return worst, rows


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------


def hop_count(phys) -> int:
    """HopOps one execution of ``phys`` runs, inside fused regions and mask
    sub-programs included; AVG walks the plan twice."""
    from repro_torch.core.lower import iter_flat_ops

    n = 0
    for op in iter_flat_ops(phys):
        if type(op).__name__ == "HopOp":
            n += 1
        n += sum(hop_count(p) for p in getattr(op, "programs", ()))
    return 2 * n if phys.agg == "avg" else n


def expected_launches(phys, fusion: str, batch: int = 1) -> list[int]:
    """[hop-kernel launches, fused1 launches, fused2 launches] one execution
    of ``phys`` makes (``batch``: one batched execution of that many rows):
    a region runs in one fused launch unless fusion is off or 'auto' finds a
    two-hop region's intermediate (of ``batch`` rows) over the scratch
    budget, when its hops run unfused."""
    from repro_torch.kernels import ops as K

    n = [0, 0, 0]
    for op in phys.ops:
        kind = type(op).__name__
        if kind == "HopOp":
            n[0] += 1
        elif kind == "FusedHopOp":
            if fusion == "off" or K._fusion_unfusable(fusion, op.n_mid, len(op.hops) == 2,
                                                      batch):
                n[0] += len(op.hops)
            else:
                n[len(op.hops)] += 1
        for p in getattr(op, "programs", ()):
            n = [a + b for a, b in zip(n, expected_launches(p, fusion, batch))]
    return [2 * x for x in n] if phys.agg == "avg" else n


def region_sigs(phys) -> list[str]:
    """The fused regions of a plan, mask sub-programs included."""
    from repro_torch.core.fuse import fusion_groups

    out = list(fusion_groups(phys))
    for op in phys.ops:
        for p in getattr(op, "programs", ()):
            out.extend(region_sigs(p))
    return out


def cases(SG, c0: int, nine: bool = False):
    """The seven queries and their parameters (``nine``: and SD-recent,
    AS-recent); ``c0`` is a concept of the SemMedDB graph at hand (see
    :func:`busy_concept`)."""
    out = [
        ("SD", SG.QUERY_SD, {"d0": 5}),
        ("FSD", SG.QUERY_FSD, {"d0": 5}),
        ("AS", SG.QUERY_AS, {"a0": 7}),
        ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
        ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
        ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
        ("CS", SG.QUERY_CS, {"c0": c0}),
    ]
    if nine:
        out += [("SD_RECENT", SG.QUERY_SD_RECENT, {"d0": 5}),
                ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 7})]
    return out


def busy_concept(sem) -> int:
    """The concept owning ConceptSemtype 0, the most-linked semtype under the
    generator's Zipf draw, so CS has a non-empty answer at any scale."""
    return int(sem.relationships["CS"].columns["CID"][0])


#: Per path label, the fused kernels' launches with a table in at least one
#: hop (``fragment_spmv_fused.TABLE_LAUNCHES``) over the path's run.
TABLE_BY_PATH: dict = {}


def check_table_launches(label, must_table: tuple) -> None:
    """Keep the path's table launches (read just after the run) and fail
    unless every kernel in ``must_table`` launched with a table."""
    tables = read_table_counts()
    TABLE_BY_PATH[label] = tables
    for k in must_table:
        if tables[k] < 1:
            raise AssertionError(f"path {label}: {k} never launched with a table ({tables})")
    log(f"  path {label}: launches with a table {tables}")


def drive_path(label, engines, SG, c0, block_skipping, fusion, kernels, topk: bool,
               nine: bool = False, must: tuple = (), must_table: tuple = ()):
    """One main path: the seven queries (``nine``: and the two variants) and
    ``query_topk`` for AS when ``topk``, with every counter set to 0 just
    before and read just after. ``kernels`` are the hop kernels of the path:
    their launches must equal the HopOps executed outside fused regions, the
    last of them must have launched, and the fused kernels' launches must
    equal the regions executed by kind; the list kernel's launches must
    equal the block lists the hops built (``ops.active_block_list`` calls),
    and it must have launched on a path that skips; every kernel in ``must``
    must have launched, every one in ``must_table`` with a table
    (:func:`check_table_launches`). Returns (results, counts, expected
    launches, per-hop skip records, per-query plan records)."""
    from repro_torch.kernels import ops as K

    qs = cases(SG, c0, nine)
    prepared, plans = {}, {}
    for n, q, _ in qs:
        t0 = time.perf_counter()
        pq = engines[n].prepare(q, block_skipping=block_skipping, fusion=fusion)
        prepared[n] = pq
        plans[n] = {"prepare_s": time.perf_counter() - t0, "regions": region_sigs(pq.phys),
                    "reach_bytes": sum(t.numel() for t in getattr(pq.fn, "reach", {}).values()),
                    "hops": hop_count(pq.phys)}
    expected = [0, 0, 0]
    for n, _, _ in qs + ([("AS", None, None)] if topk else []):
        expected = [a + b for a, b in zip(expected, expected_launches(prepared[n].phys, fusion))]
    skips, n_lists = [], [0]
    plan_skip, fused_lists, block_list = K._plan_skip, K._fused_block_lists, K.active_block_list

    def recorded(w, op, E, blocks, mode, *a):  # the smoke reads n_active after the run
        plan = plan_skip(w, op, E, blocks, mode, *a)
        if plan is not None:
            skips.append((current[0], plan[1], plan[2], E))
        return plan

    def counted_list(*a, **k):
        n_lists[0] += 1
        return block_list(*a, **k)

    def recorded_lists(w, op, h1, h2, E1, E2, mode, *a):
        lists = fused_lists(w, op, h1, h2, E1, E2, mode, *a)
        skips.append((current[0] + " fused hop1", lists[1], 2**31 - 1, E1))
        if h2 is not None:
            skips.append((current[0] + " fused hop2", lists[3], 2**31 - 1, E2))
        return lists

    current = [None]
    results = {}
    defaults = block_skipping == "auto" and fusion == "auto"
    K._plan_skip, K._fused_block_lists = recorded, recorded_lists
    K.active_block_list = counted_list
    try:
        reset_counts()
        for name, q, params in qs:
            current[0] = name
            results[name] = (engines[name].query(q, **params) if defaults
                             else prepared[name](**params))
        if topk:
            current[0] = "AS topk"
            top = engines["AS"].query_topk(SG.QUERY_AS, k=10, a0=7)
        counts = read_counts()
        check_table_launches(label, must_table)
    finally:
        K._plan_skip, K._fused_block_lists = plan_skip, fused_lists
        K.active_block_list = block_list
    launched = sum(counts[k] for k in kernels)
    got = [launched, counts["fragment_spmv_fused1"], counts["fragment_spmv_fused2"]]
    if got != expected:
        raise AssertionError(f"path {label}: [{kernels}, fused1, fused2] launched {got} times,"
                             f" expected {expected} ({counts})")
    if counts["block_list"] != n_lists[0]:
        raise AssertionError(f"path {label}: {n_lists[0]} block lists built, the list kernel"
                             f" launched {counts['block_list']} times")
    for k in [kernels[-1], *must] + (["block_list"] if block_skipping != "off" else []):
        if counts[k] < 1:
            raise AssertionError(f"path {label}: {k} never launched ({counts})")
    if topk:
        want = engines["AS"]._topk(results["AS"], 10)
        if not top or [i for i, _ in top] != [i for i, _ in want]:
            raise AssertionError(f"query_topk ids {top} != query's {want}")
        compare(np.asarray([v for _, v in top]), np.asarray([v for _, v in want]), False,
                "query_topk scores")
    hops = [{"query": q, "n_active": int(na[0]), "n_blocks": -(-E // 4096),
             "scan_above": int(sa)} for q, na, sa, E in skips]
    if block_skipping == "auto":
        from repro_torch.kernels.params import SKIP_MIN_BLOCKS

        small = [h for h in hops if "fused" not in h["query"]
                 and h["n_blocks"] < SKIP_MIN_BLOCKS]
        if small:
            raise AssertionError(f"path {label}: 'auto' listed on an index of fewer than"
                                 f" SKIP_MIN_BLOCKS = {SKIP_MIN_BLOCKS} blocks: {small}")
    log(f"  path {label}: launches {counts} (expected [hops, fused1, fused2] {expected})")
    return results, counts, expected, hops, plans


def check_results(label, results, engines, SG, c0, block_skipping, fusion="auto",
                  nine=False, gates=None) -> dict:
    """Each result against the same lowered plan run through the plain
    versions on the card with float64 sums (:class:`float64_sums`: the
    float32 per-edge scatter of the plain hop drifts about 1e-4 from them on
    I_DA.Doc's hot authors, as much as the gate allows, PERF.md); finite, of
    the domain's shape, not empty. Each float query's gate ratio goes to
    ``gates[f"{label} vs plain"]``."""
    from repro_torch.core import executor as X

    errs, ratios = {}, {}
    for name, q, params in cases(SG, c0, nine):
        got = results[name]
        pq = engines[name].prepare(q, block_skipping=block_skipping, fusion=fusion)
        if got.shape != (pq.phys.out_dom,) or not np.isfinite(got).all():
            raise AssertionError(f"{label} {name}: shape {got.shape} or non-finite values")
        if not (got != 0).any():
            raise AssertionError(f"{label} {name}: empty result")
        plain = X.compile_frontier(engines[name].db.device, pq.phys,
                                   block_skipping=block_skipping, use_kernel=False,
                                   fusion=fusion)
        with float64_sums():
            want = plain(*[params[n] for n in pq.param_names]).cpu().numpy()
        errs[name] = compare(got, want, name in EXACT_QUERIES, f"{label} {name} vs plain")
        if name not in EXACT_QUERIES:
            ratios[name] = gate_ratio(got, want)
    log(f"  path {label}: every result matches the plain versions on the card"
        f" (max abs err {max(errs.values()):.3g})")
    if gates is not None:
        log_gates(f"{label} vs plain", ratios, gates)
    return errs


def float_queries(SG, c0) -> list:
    """The nine queries whose results are float sums (not EXACT_QUERIES)."""
    return [c for c in cases(SG, c0, True) if c[0] not in EXACT_QUERIES]


def truth_single(engines, SG, c0) -> dict:
    """Each float query through the plain versions with float64 sums
    (:class:`float64_sums`; skipping and fusion off)."""
    from repro_torch.core import executor as X

    out = {}
    with float64_sums():
        for name, q, params in float_queries(SG, c0):
            pq = engines[name].prepare(q, block_skipping="off", fusion="off")
            run = X.compile_frontier(engines[name].db.device, pq.phys, block_skipping="off",
                                     use_kernel=False, fusion="off")
            out[name] = run(*[params[n] for n in pq.param_names]).cpu().numpy()
    return out


def truth_batched(engines, SG, c0, results, B: int = 8) -> dict:
    """Each float query's B-row batch of ``results`` through the plain
    versions run batched with float64 sums."""
    from repro_torch.core import executor as X

    out = {}
    with float64_sums():
        for name, q, _ in float_queries(SG, c0):
            params = results[(name, B)][0]
            pq = engines[name].prepare(q, block_skipping="off", fusion="off")
            run = X.compile_frontier_batched(engines[name].db.device, pq.phys,
                                             block_skipping="off", use_kernel=False,
                                             fusion="off")
            out[name] = run(*[params[n] for n in pq.param_names]).cpu().numpy()
    return out


def hold_f64(label, results, truth, kind: str, key=lambda name: name) -> dict:
    """Each float query's result (``results[key(name)]``) against the float64
    sums ``truth[name]``: fails past FLOAT64_LIMIT[kind] (where it is set);
    returns the relative differences."""
    limit = FLOAT64_LIMIT[kind]
    rel = {}
    for name, want in truth.items():
        got = results[key(name)]
        if isinstance(got, tuple):
            got = got[1]
        rel[name] = rel_to_f64(got, want)
        if limit is not None and not rel[name] <= limit:
            raise AssertionError(f"{label} {name}: relative difference {rel[name]:.3g} to the"
                                 f" float64 sums beyond {limit:g}")
    log(f"  path {label}: float sums against the plain versions' float64 sums (relative,"
        f" limit {limit}): " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
    return rel


def check_quickstart(SG, run_sql, GQFastDatabase, GQFastEngine, device, encodings,
                     fusion) -> None:
    """All nine queries against run_sql at the quickstart scale."""
    pub = SG.make_pubmed(**QUICKSTART_PUBMED)
    sem = SG.make_semmeddb()  # the generator's defaults
    c0 = busy_concept(sem)
    kw = dict(account_space=False, device=device, device_encodings=encodings)
    eng_p = GQFastEngine(GQFastDatabase(pub, **kw))
    eng_s = GQFastEngine(GQFastDatabase(sem, **kw))
    worst, regions = 0.0, 0
    for name, q, params in cases(SG, c0, nine=True):
        schema, eng = (sem, eng_s) if name == "CS" else (pub, eng_p)
        pq = eng.prepare(q, fusion=fusion)
        regions += len(region_sigs(pq.phys))
        got = pq(**params)
        ref = run_sql(schema, q, params)
        worst = max(worst, compare(got, ref.astype(np.float32), name in EXACT_QUERIES,
                                   f"{name} vs run_sql (quickstart, {encodings}, {fusion})"))
        if not (got != 0).any():
            raise AssertionError(f"{name}: empty result at quickstart scale")
    log(f"  all nine match run_sql at quickstart scale, device_encodings={encodings!r},"
        f" fusion={fusion!r} ({regions} regions; max abs err {worst:.3g})")


#: Path j's two terms (AD's parameters).
INTERSECT_TERMS = (3, 9)


def drive_intersection(db_dense, device) -> tuple[dict, tuple]:
    """Path j: the document sets of INTERSECT_TERMS as bitmaps built on the
    card from I_DT.Term (32 documents a word), intersected through
    ``ops.bitmap_and`` and counted through ``ops.bitmap_and_popcount`` with
    every counter set to 0 just before and read just after: one launch of
    each, results equal to the plain versions, the count equal to
    ``np.intersect1d`` of the two document lists on the host index.
    Returns the record and the two masks."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    di = db_dense.device.index("DT", "Term")
    host = db_dense.host_indexes[("DT", "Term")]
    n_doc = db_dense.schema.domain_size("Document")
    t1, t2 = INTERSECT_TERMS
    masks = tuple(K.membership_bitmap(di.dst_ids[int(host.indptr[t]):int(host.indptr[t + 1])],
                                      n_doc) for t in (t1, t2))
    sync()
    reset_counts()
    both = K.bitmap_and(*masks)
    count = K.bitmap_and_popcount(*masks)
    counts = read_counts()
    sync()
    want = {k: 1 if k in ("bitmap_and", "bitmap_and_popcount") else 0 for k in KERNELS}
    if counts != want:
        raise AssertionError(f"path j: launches {counts}, expected {want}")
    compare(both, ref.bitmap_and_ref(*masks), True, "path j bitmap_and vs plain")
    compare(count, ref.bitmap_and_popcount_ref(*masks), True, "path j popcount vs plain")
    docs = np.intersect1d(host.fragment(t1, "Doc"), host.fragment(t2, "Doc"))
    if int(count) != docs.shape[0]:
        raise AssertionError(f"path j: popcount {int(count)} != np.intersect1d's {docs.shape[0]}")
    compare(both, K.membership_bitmap(docs, n_doc).to(both.device), True,
            "path j: the AND vs the bitmap of np.intersect1d")
    rec = {"counts": counts, "terms": [t1, t2], "words": int(masks[0].shape[0]),
           "docs": [int(host.indptr[t + 1] - host.indptr[t]) for t in (t1, t2)],
           "intersection": int(count)}
    log(f"  path j: terms {t1} and {t2} ({rec['docs'][0]} and {rec['docs'][1]} documents,"
        f" {rec['words']} words a bitmap): intersection {int(count)} documents, equal to"
        f" np.intersect1d; launches bitmap_and {counts['bitmap_and']}, bitmap_and_popcount"
        f" {counts['bitmap_and_popcount']}")
    return rec, masks


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def time_modes(engines, SG, c0, modes: dict, qs=None) -> dict:
    """Median wall ms of QUERY_REPS executions per query (of ``qs``, else
    the nine) under each of ``modes`` ({label: (storage, block_skipping,
    fusion)}, storage naming the engines of ``engines``), taken in turns —
    the modes' order rotates from one repetition to the next — so that the
    shared host's drift falls on every mode alike."""
    out = {label: {} for label in modes}
    labels = list(modes)
    for name, q, params in qs or cases(SG, c0, nine=True):
        pqs = {lb: engines[st][name].prepare(q, block_skipping=bs, fusion=fu)
               for lb, (st, bs, fu) in modes.items()}
        ts = {lb: [] for lb in labels}
        for pq in pqs.values():
            pq(**params)
        for i in range(QUERY_REPS):
            for lb in labels[i % len(labels):] + labels[:i % len(labels)]:
                t0 = time.perf_counter()
                pqs[lb](**params)  # returns host numpy: waits for the device
                ts[lb].append((time.perf_counter() - t0) * 1e3)
        for lb in labels:
            out[lb][name] = {"median_ms": statistics.median(ts[lb]), "min_ms": min(ts[lb]),
                             "max_ms": max(ts[lb]), "hops": hop_count(pqs[lb].phys)}
        log(f"  {name:10s} median ms over {QUERY_REPS} runs in turns: " + ", ".join(
            f"{lb} {out[lb][name]['median_ms']:.4f}" for lb in labels))
    return out


def breakdown(label, engines, SG, c0, block_skipping, fusion="auto", nine=False,
              qs=None) -> dict:
    """Where a query's time goes. torch.profiler over PROFILE_REPS runs gives
    the device's busy time per run, split into the hop kernels, bitunpack,
    the list kernel, copies (the result to the host) and everything else
    (fills, seeds, masks); the list kernel's launches a run against the hop
    kernels' (one list a skipping hop); the idle share is 1 − busy / the wall
    time of the same profiled runs (profiling slows them, so both sides carry
    its cost). ``None`` where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, q, params in qs or cases(SG, c0, nine):
        pq = engines[name].prepare(q, block_skipping=block_skipping, fusion=fusion)
        pq(**params)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_REPS):
                pq(**params)  # returns host numpy: waits for the device
            wall = (time.perf_counter() - t0) * 1e3 / PROFILE_REPS
        split = {"hop": 0.0, "bitunpack": 0.0, "list": 0.0, "copy": 0.0, "other": 0.0}
        launches = {k: 0 for k in split}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            kind = ("hop" if is_hop_kernel(ev.key)
                    else "bitunpack" if "bitunpack" in ev.key
                    else "list" if "block_list" in ev.key
                    else "copy" if "Memcpy" in ev.key else "other")
            split[kind] += ev.self_device_time_total / 1e3 / PROFILE_REPS
            launches[kind] += ev.count
        per_run = {k: v / PROFILE_REPS for k, v in launches.items()}
        launches = sum(launches.values())
        busy = sum(split.values())
        if busy == 0.0:
            out[name] = None
            log(f"  {label:8s} {name:6s} device time not measured (profiler saw no device events)")
            continue
        out[name] = {"busy_ms": busy, **{f"{k}_ms": v for k, v in split.items()},
                     "profiled_wall_ms": wall, "idle_share": max(0.0, 1.0 - busy / wall),
                     "device_ops_per_run": launches / PROFILE_REPS,
                     "hop_launches_per_run": per_run["hop"],
                     "list_launches_per_run": per_run["list"],
                     "other_ops_per_run": per_run["other"]}
        log(f"  {label:8s} {name:6s} device busy {busy:.4f} ms of {wall:.4f} ms profiled wall"
            f" (hop {split['hop']:.4f}, list {split['list']:.4f}, copy {split['copy']:.4f},"
            f" other {split['other']:.4f}; {launches / PROFILE_REPS:.0f} device ops a run:"
            f" {per_run['hop']:.0f} hop, {per_run['list']:.0f} list, {per_run['other']:.0f}"
            f" other; idle share {out[name]['idle_share']:.3f})")
    return out


def csr_matrix(src, dst, vals, n_src, n_dst):
    import torch

    return torch.sparse_coo_tensor(
        torch.stack([dst.to(torch.int64), src.to(torch.int64)]), vals, (n_dst, n_src),
        check_invariants=False,
    ).coalesce().to_sparse_csr()


def time_kernels(db, db_dense, device) -> dict:
    """Per kernel at the main path's shapes, sum over a dense random
    frontier (every edge live): CUDA-event ms, bound, plain ms, library ms."""
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import bitunpack as bk
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(1)
    rows = {k: [] for k in KERNELS}
    for name, (table, key), meas, dst_ent in (
        ("I_DT.Term", ("DT", "Term"), "Fre", "Document"),
        ("I_DA.Doc", ("DA", "Doc"), None, "Author"),
    ):
        di, pi = db_dense.device.index(table, key), db.device.index(table, key)
        n_src, n_dst = di.indptr.shape[0] - 1, db.schema.domain_size(dst_ent)
        src, dst = di.src_ids, di.dst_ids
        m = di.measures[meas] if meas else None
        E = int(src.shape[0])
        w = frontier(n_src, "sum", gen, device)
        A = csr_matrix(src, dst, m if m is not None else torch.ones(E, device=device),
                       n_src, n_dst)
        lib = torch.mv(A, w)
        compare(dk.fragment_spmv(w, src, dst, m, n_dst), lib, False, f"torch.mv {name}")
        library_ms = time_device_ms(lambda: torch.mv(A, w), KERNEL_REPS)
        del A, lib
        # dense scan and active (list built beforehand: the kernel alone), in the
        # form the index's hot share chooses, and the other form beside it
        bi, na = active.active_block_list(w, 0.0, di.block_src_min, di.block_src_max)
        nb = active.n_edge_blocks(E)
        mb = 4 * E if m is not None else 0
        dtable = uses_table(di)
        b, by = hop_bound(E, n_src, n_dst, 4 * E, mb)
        ms, other = (time_device_ms(lambda t=t: dk.fragment_spmv(w, src, dst, m, n_dst, table=t),
                                    KERNEL_REPS) for t in (dtable, not dtable))
        plain = time_device_ms(lambda: ref.fragment_spmv_ref(w, src, dst, m, n_dst), KERNEL_REPS)
        rows["fragment_spmv"].append(dict(shape=name, E=E, ms=ms, plain_ms=plain, bound_ms=b,
                                          bound_by=by, library_ms=library_ms, table=dtable,
                                          hot_share=di.hot_share, other_form_ms=other))
        ms, other = (time_device_ms(lambda t=t: dk.fragment_spmv_active(
            w, src, dst, m, bi, na, n_dst, scan_above=nb, table=t), KERNEL_REPS)
            for t in (dtable, not dtable))
        plain = time_device_ms(lambda: ref.fragment_spmv_active_ref(w, src, dst, m, bi, na,
                                                                    n_dst), KERNEL_REPS)
        b, by = hop_bound(E, n_src, n_dst, 4 * E, mb, extra=4 * nb + 4)
        rows["fragment_spmv_active"].append(dict(shape=name, E=E, ms=ms, plain_ms=plain,
                                                 bound_ms=b, bound_by=by,
                                                 library_ms=library_ms, support=1.0,
                                                 table=dtable, hot_share=di.hot_share,
                                                 other_form_ms=other))
        # packed scan and active
        pm = pi.measure_cols[meas] if meas else None
        mw, m_mode = (pm.words, "packed") if pm is not None else (None, "none")
        kw = dict(dst_width=pi.dst_col.width, m_mode=m_mode,
                  m_width=pm.width if pm is not None else 0)
        table = uses_table(pi)
        dwords = pi.dst_col.words
        pb = 4 * dwords.shape[0] + (4 * mw.shape[0] if mw is not None else 0)
        b, by = hop_bound(E, n_src, n_dst, 4 * dwords.shape[0],
                          4 * mw.shape[0] if mw is not None else 0)
        ms = time_device_ms(lambda: pk.fragment_spmv_packed(w, src, dwords, mw, None, n_dst,
                                                            table=table, **kw), KERNEL_REPS)
        plain = time_device_ms(lambda: ref.fragment_spmv_packed_ref(
            w, src, dwords, mw, None, n_dst, **kw), KERNEL_REPS)
        rows["fragment_spmv_packed"].append(dict(shape=name, E=E, ms=ms, plain_ms=plain,
                                                 bound_ms=b, bound_by=by,
                                                 library_ms=library_ms, packed_bytes=pb,
                                                 dst_width=kw["dst_width"],
                                                 m_width=kw["m_width"],
                                                 table=table, hot_share=pi.hot_share))
        ms = time_device_ms(lambda: pk.fragment_spmv_packed_active(
            w, src, dwords, mw, None, bi, na, n_dst, scan_above=nb, table=table, **kw),
            KERNEL_REPS)
        plain = time_device_ms(lambda: ref.fragment_spmv_packed_active_ref(
            w, src, dwords, mw, None, bi, na, n_dst, **kw), KERNEL_REPS)
        b, by = hop_bound(E, n_src, n_dst, 4 * dwords.shape[0],
                          4 * mw.shape[0] if mw is not None else 0, extra=4 * nb + 4)
        rows["fragment_spmv_packed_active"].append(dict(shape=name, E=E, ms=ms, plain_ms=plain,
                                                        bound_ms=b, bound_by=by,
                                                        library_ms=library_ms, support=1.0,
                                                        table=table))
        for k in KERNELS:
            if rows[k] and rows[k][-1]["shape"] == name:
                r = rows[k][-1]
                form = ""
                if "table" in r:
                    form = f"  table {'on' if r['table'] else 'off'} (hot share {di.hot_share:.3g})"
                if "other_form_ms" in r:
                    form += f", other form {r['other_form_ms']:.4f} ms"
                log(f"  {k:28s} {name:10s} E={E} {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms"
                    f" ({r['bound_by']})  plain {r['plain_ms']:.4f} ms"
                    f"  torch.mv(CSR) {r['library_ms']:.4f} ms{form}")
        if name == "I_DT.Term":  # bitunpack of the 22-bit Doc column
            count, width = pi.dst_col.count, pi.dst_col.width
            ms = time_device_ms(lambda: bk.bitunpack(dwords, width, count), KERNEL_REPS)
            plain = time_device_ms(lambda: ref.bitunpack_ref(dwords, width, count), KERNEL_REPS)
            b, by = bound_ms(4 * dwords.shape[0] + 4 * count, 0)
            rows["bitunpack"].append(dict(shape=f"{name} dst ({width} bits)", E=count, ms=ms,
                                          plain_ms=plain, bound_ms=b, bound_by=by,
                                          library_ms=None))
            log(f"  {'bitunpack':28s} {name} dst {width} bits, {count} values {ms:.4f} ms"
                f"  bound {b:.4f} ms ({by})  plain {plain:.4f} ms  library none")
    return rows


def hot_author_error(db, db_dense, device) -> dict:
    """The float32 sum of each SpMV hop kernel on I_DA.Doc over a dense random
    frontier against float64, on the hottest author (the most edges) and over
    every author: the dense pair with its table (the form I_DA.Doc takes) and
    without it (an atomic an edge), the packed pair's per-CTA partial sums,
    and the plain scatter."""
    import torch

    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(24)
    di, pi = db_dense.device.index("DA", "Doc"), db.device.index("DA", "Doc")
    n_src, n_dst = di.indptr.shape[0] - 1, db.schema.domain_size("Author")
    src, dst = di.src_ids, di.dst_ids
    E = int(src.shape[0])
    nb = -(-E // 4096)
    bi = torch.arange(nb, dtype=torch.int32, device=device)
    na = torch.full((1,), nb, dtype=torch.int32, device=device)
    w = frontier(n_src, "sum", gen, device)
    truth = torch.zeros(n_dst, dtype=torch.float64, device=device).index_add_(
        0, dst.long(), w.double()[src.long()])
    deg = torch.bincount(dst.long(), minlength=n_dst)
    hot = int(torch.argmax(deg))
    kw = dict(dst_width=pi.dst_col.width)
    out = {"author": hot, "edges": int(deg[hot]), "E": E}
    for name, fn in (
        ("fragment_spmv", lambda: dk.fragment_spmv(w, src, dst, None, n_dst, table=True)),
        ("fragment_spmv_active", lambda: dk.fragment_spmv_active(
            w, src, dst, None, bi, na, n_dst, scan_above=nb, table=True)),
        ("fragment_spmv per edge", lambda: dk.fragment_spmv(w, src, dst, None, n_dst,
                                                            table=False)),
        ("fragment_spmv_packed", lambda: pk.fragment_spmv_packed(
            w, src, pi.dst_col.words, None, None, n_dst, **kw)),
        ("fragment_spmv_packed_active", lambda: pk.fragment_spmv_packed_active(
            w, src, pi.dst_col.words, None, None, bi, na, n_dst, scan_above=nb, **kw)),
        ("plain", lambda: ref.fragment_spmv_ref(w, src, dst, None, n_dst)),
    ):
        y = fn().double()
        rel = (y - truth).abs() / truth.abs().clamp_min(1e-30)
        rel[truth == 0] = 0.0
        out[name] = {"rel_err_hottest": float(rel[hot]), "rel_err_max": float(rel.max())}
    log(f"  float32 sums on I_DA.Doc against float64: hottest author {hot} ({out['edges']}"
        f" edges) " + ", ".join(f"{k} {v['rel_err_hottest']:.3g}" for k, v in out.items()
                                if isinstance(v, dict))
        + "; largest over all authors " + ", ".join(
            f"{k} {v['rel_err_max']:.3g}" for k, v in out.items() if isinstance(v, dict)))
    return out


def time_bitmap(masks, device) -> dict:
    """The bitmap kernels at path j's shape and at 2^26 words an operand (the
    popcount at one word fewer, its most): CUDA-event ms, the bound (12 bytes
    a word for the AND, 8 for the popcount), the plain version's ms and
    ``torch.bitwise_and``'s (none counts bits in one PyTorch call)."""
    import torch

    from repro_torch.kernels import bitmap_ops as bm
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(25)
    big = tuple(torch.randint(-2**31, 2**31, (BITMAP_BIG_WORDS,), dtype=torch.int32,
                              generator=gen, device=device) for _ in range(2))
    rows = {"bitmap_and": [], "bitmap_and_popcount": []}
    for shape, (a, b) in (("path j masks", masks), ("bandwidth shape", big)):
        n = int(a.shape[0])
        bnd, by = bound_ms(12 * n, 0)
        rows["bitmap_and"].append(dict(
            shape=shape, E=n, ms=time_device_ms(lambda: bm.bitmap_and(a, b), KERNEL_REPS),
            plain_ms=time_device_ms(lambda: ref.bitmap_and_ref(a, b), KERNEL_REPS),
            library_ms=time_device_ms(lambda: torch.bitwise_and(a, b), KERNEL_REPS),
            bound_ms=bnd, bound_by=by))
        a, b = a[:bm.MAX_POPCOUNT_WORDS], b[:bm.MAX_POPCOUNT_WORDS]
        n = int(a.shape[0])
        bnd, by = bound_ms(8 * n + 4, 0)
        ops = device_ops(lambda: bm.bitmap_and_popcount(a, b))
        if ops and set(ops) != {"bitmap_and_popcount_kernel"}:  # {}: no device events seen
            raise AssertionError(f"bitmap_and_popcount {shape}: device operations {ops},"
                                 " expected its one kernel alone")
        rows["bitmap_and_popcount"].append(dict(
            shape=shape, E=n,
            ms=time_device_ms(lambda: bm.bitmap_and_popcount(a, b), KERNEL_REPS),
            plain_ms=time_device_ms(lambda: ref.bitmap_and_popcount_ref(a, b), KERNEL_REPS),
            library_ms=None, bound_ms=bnd, bound_by=by, device_ops=sum(ops.values())))
        for k in rows:
            r = rows[k][-1]
            lib = (f"torch.bitwise_and {r['library_ms']:.4f} ms"
                   if r["library_ms"] is not None
                   else f"library none; {r['device_ops']:.3g} device operations a call")
            log(f"  {k:20s} {shape} ({r['E']} words): {r['ms']:.4f} ms  bound"
                f" {r['bound_ms']:.4f} ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms"
                f"  {lib}")
    del big
    return rows


def stream_bytes(h, E: int) -> float:
    """Bytes an edge of ``h`` streams: src, dst and measure as stored."""
    b = 4 * E + (4 * h.dst.shape[0] if h.dst_width else 4 * E)
    if h.m_mode == "dense":
        b += 4 * E
    elif h.m_mode in ("packed", "dict"):
        b += 4 * h.measure.shape[0]
    return b / max(E, 1)


def decoded(h, device):
    """(src, dst, measure) of a hop as decoded tensors, for a CSR matrix."""
    import torch

    from repro_torch.kernels import ref

    E = int(h.src_ids.shape[0])
    s = torch.as_tensor(h.src_ids, device=device)
    d = ref.bitunpack_ref(h.dst, h.dst_width, E) if h.dst_width else h.dst
    m = ref._measure_values(h.measure, h.mdict, h.m_mode, h.m_width, None, E)
    return s, d, m if m is not None else torch.ones(E, device=device)


def time_fused(specs, device) -> tuple[dict, list[dict], int]:
    """Rows 5 and 6 at the region shapes, sum: the fused kernel over its
    prebuilt lists by CUDA events, in the main path's form (the table where
    a hop's hot share asks for it) and in the others (:func:`region_forms`);
    the unfused composition of the port's kernels (each hop in the form its
    hot share chooses) over lists built beforehand from the same frontier
    and from the intermediate; the whole dispatch (lists included) with
    fusion on and off;
    the plain region; two ``torch.mv`` on CSR matrices and the mask (the
    library yardstick); the bytes bound of the listed blocks' streams + w +
    keep (one byte an entry, as the kernels read it) + out (u, 4·n_mid
    bytes, not counted while it fits the L2). Returns
    the rows by kernel, the fused-vs-unfused rows and the scratch budget they
    support: the largest 4·n_mid up to which fused was no slower (within
    SKIP_TIE) than unfused, end to end through the dispatch, at every shape
    with every source live."""
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(16)
    rows = {"fragment_spmv_fused1": [], "fragment_spmv_fused2": []}
    budget_rows = []
    for spec, supports in zip(specs, (("one_seed", 1.0), (1.0,), ("one_seed", 1.0))):
        h1, h2 = spec["hop1"], spec["hop2"]
        E1 = int(h1.src_ids.shape[0])
        E2 = int(h2.src_ids.shape[0]) if h2 is not None else 0
        n_mid = h1.n_dst
        n_dst = h2.n_dst if h2 is not None else n_mid
        k = "fragment_spmv_fused2" if h2 is not None else "fragment_spmv_fused1"
        s1 = K._streams(h1, device)
        s2 = K._streams(h2, device) if h2 is not None else None
        mask, binz = spec["mask"], spec["binarize"]
        for support in supports:
            w = sparse_frontier(frontier(spec["n_src"], "sum", gen, device), spec["degrees"],
                                support, "sum", 17)
            lists = K._fused_block_lists(w, "sum", h1, h2, E1, E2, "on")
            fused = region_call(spec, w, "sum", lists, device)
            got = fused()
            # the unfused kernels over lists of their own: hop2's from the
            # intermediate's support, as the unfused active hop builds it
            u = unfused_region(w, s1, None, mask, None, n_mid, n_dst, "sum", False)
            ul = list(lists[:2])
            if h2 is not None:
                ul += list(active.active_block_list(ref.binarize(u, "sum") if binz else u, 0.0,
                                                    *(torch.as_tensor(b, device=device)
                                                      for b in h2.blocks)))
            forms = region_forms(spec)
            unf = lambda: unfused_region(w, s1, s2, mask, ul, n_mid, n_dst, "sum",  # noqa: E731
                                         binz, forms["ops"])
            compare(got, unf(), False, f"{k} {spec['name']} vs unfused kernels (timing inputs)")
            na1 = int(lists[1][0])
            na2 = int(lists[3][0]) if h2 is not None else 0
            e1, e2 = min(E1, na1 * 4096), min(E2, na2 * 4096)
            nbytes = (stream_bytes(s1, E1) * e1 + (stream_bytes(s2, E2) * e2 if s2 else 0)
                      + 4 * spec["n_src"] + (n_mid if mask is not None else 0) + 4 * n_dst
                      + 4 * (lists[0].shape[0] + (lists[2].shape[0] if s2 else 0)))
            if 4 * n_mid > L2_BYTES:
                nbytes += 8 * n_mid  # u written and read once through HBM
            b, by = bound_ms(int(nbytes), 2 * (e1 + e2))
            hp1, hp2 = h1, h2
            disp = lambda f: K.fragment_spmv_fused(  # noqa: E731
                w, hp1, hp2, mask, op="sum", mid_binarize=binz, fusion=f, block_skipping="auto")
            r = dict(shape=f"{spec['name']} support {support}", E=e1 + e2, n_mid=n_mid,
                     support=support,
                     n_active=[na1] + ([na2] if s2 else []),
                     ms=time_device_ms(fused, KERNEL_REPS), tables=forms["ops"],
                     ms_forms={f: time_device_ms(region_call(spec, w, "sum", lists, device, f),
                                                 KERNEL_REPS) for f in forms if f != "ops"},
                     unfused_ms=time_device_ms(unf, KERNEL_REPS),
                     dispatch_on_ms=time_device_ms(lambda: disp("on"), KERNEL_REPS),
                     dispatch_off_ms=time_device_ms(lambda: disp("off"), KERNEL_REPS),
                     plain_ms=time_device_ms(lambda: ref.fragment_spmv_fused_ref(
                         w, s1, s2, mask, n_mid, n_dst, op="sum", mid_binarize=binz,
                         lists=lists), KERNEL_REPS),
                     bound_ms=b, bound_by=by)
            A1 = csr_matrix(*decoded(h1, device), spec["n_src"], n_mid)
            A2 = csr_matrix(*decoded(h2, device), n_mid, n_dst) if h2 is not None else None

            def lib():
                x = torch.mv(A1, w)
                if mask is not None:
                    x = torch.where(mask > 0, x, 0.0)
                if A2 is None:
                    return x
                return torch.mv(A2, (x > 0).to(torch.float32) if binz else x)

            compare(got, lib(), False, f"{k} {spec['name']} vs torch.mv(CSR) composition")
            r["library_ms"] = time_device_ms(lib, KERNEL_REPS)
            del A1, A2
            rows[k].append(r)
            budget_rows.append(r)
            log(f"  {k:22s} {r['shape']}: {r['ms']:.4f} ms (tables {r['tables']}; other"
                f" forms {r['ms_forms']}; lists"
                f" {r['n_active']}) unfused kernels {r['unfused_ms']:.4f} ms; dispatch on"
                f" {r['dispatch_on_ms']:.4f} / off {r['dispatch_off_ms']:.4f} ms; bound"
                f" {b:.4f} ms ({by}); plain {r['plain_ms']:.4f} ms; torch.mv(CSR) x2"
                f" {r['library_ms']:.4f} ms")
    # the budget is read where both sides stream the same blocks (every
    # source live): what differs there is the scratch and the launches, not
    # the lists (a coarse reach list is REACH_DENSITY_MAX's business)
    full = [r for r in budget_rows if r["support"] == 1.0]
    ok = sorted({r["n_mid"] for r in full})
    budget = 0
    for n in ok:
        if all(r["dispatch_on_ms"] <= SKIP_TIE * r["dispatch_off_ms"]
               for r in full if r["n_mid"] == n):
            budget = 4 * n
        else:
            break
    log(f"  fused no slower than unfused (within {SKIP_TIE}x, through the dispatch, every"
        f" source live) up to 4·n_mid = {budget} bytes (n_mid measured: {ok})")
    return rows, budget_rows, budget


def device_busy(fn) -> tuple[float, float]:
    """Device busy ms and device operations of one call of ``fn``, from
    torch.profiler over PROFILE_REPS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            fn()
        sync()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in evs) / 1e3 / PROFILE_REPS,
            sum(e.count for e in evs) / PROFILE_REPS)


def device_ops(fn) -> dict:
    """The device operations of one call of ``fn`` by torch.profiler over
    PROFILE_REPS calls: {name: launches a call}, a kernel named by its
    function (``{}`` where the profiler saw no device events). The profiler
    may miss the first operation of its window, so a count can read low."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            fn()
        sync()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + e.count / PROFILE_REPS
    return out


#: A kernel following the block list counts as no slower than scan order
#: while within this factor of it (the spread of repeated event timings).
SKIP_TIE = 1.05


#: The reference's contract for block_skipping="auto" where it does not
#: skip: at most this factor of the scan (benchmarks/selectivity.py).
AUTO_OVER_SCAN = 1.1


def list_bound(w, zero: float, src_min, src_max) -> tuple[float, str]:
    """The list kernel's bound for this frontier: the frontier values a
    block's test must read (its range up to the first live source, or all of
    it; B rows each; at most the whole frontier), the two range ends, and
    the list and count written."""
    import torch

    live = w != zero
    B = 1 if live.dim() == 1 else live.shape[0]
    sup = live if live.dim() == 1 else live.any(dim=0)
    lo, hi = src_min.long(), src_max.long()
    pos = torch.nonzero(sup).flatten()
    first = torch.full_like(lo, 2**62)  # the first live source at or after lo: none
    if pos.numel():
        at = pos[torch.searchsorted(pos, lo).clamp(max=pos.shape[0] - 1)]
        first = torch.where(at >= lo, at, first)
    need = (torch.minimum(first, hi) - lo + 1).clamp(min=0)
    values = min(int(need.sum()), sup.shape[0]) * B
    nb = src_min.shape[0]
    return bound_ms(4 * values + 8 * nb + 4 * nb + 4, 0)


def time_skipping(db, db_dense, device) -> tuple[list[dict], float, list[dict]]:
    """Scan against skip at support fractions from one seed to 100% on
    I_DT.Term (sum), packed and dense:

      * the block list alone: the list kernel and the plain build
        (``active.active_block_list``'s 14 calls) per call by CUDA events over
        back-to-back calls (what a hop pays, launch overhead included), their
        device busy time and operations by the profiler, and the list
        kernel's bound;
      * the kernels alone, the list built beforehand: the scan kernel, the
        active kernel following the list, and the active kernel in scan
        order ('auto' above its threshold), with the bytes bound of the
        blocks the list names;
      * the whole hop through ``kernels.ops`` with block_skipping 'off', 'on'
        (list + active kernel) and 'auto'; at 100% support 'auto' and 'on'
        against 'off', beside the reference's AUTO_OVER_SCAN.

    Returns the rows, the derived threshold (the largest active fraction up
    to which following the list was no slower, within SKIP_TIE, than scan
    order at every measured support, for both layouts) and the list kernel's
    timing rows."""
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ops as K

    gen = torch.Generator(device=device).manual_seed(8)
    pt, dt = db.device.index("DT", "Term"), db_dense.device.index("DT", "Term")
    fre, n_dst = pt.measure_cols["Fre"], db.schema.domain_size("Document")
    n_src, E = pt.indptr.shape[0] - 1, int(pt.src_ids.shape[0])
    nb = active.n_edge_blocks(E)
    blocks = (pt.block_src_min, pt.block_src_max)
    kw = dict(dst_width=pt.dst_col.width, m_mode="packed", m_width=fre.width)
    table, dtable = uses_table(pt), uses_table(dt)
    per_edge = {"packed": (4 * pt.dst_col.words.shape[0] + 4 * fre.words.shape[0]) / E + 4,
                "dense": 12}
    base = frontier(n_src, "sum", gen, device)
    # on the H100 (torch 2.11) the first profiled run here recorded no device
    # events, after the breakdown's runs had; a throwaway one goes first
    device_busy(lambda: active.active_block_list(base, 0.0, *blocks))
    rows, list_rows, ok_up_to, broken = [], [], 0.0, False
    for support in SUPPORTS:
        w = sparse_frontier(base, pt.degrees, support, "sum", 9)
        lst = lambda: K.active_block_list(w, 0.0, *blocks)  # noqa: E731  (the kernel)
        plain_lst = lambda: active.active_block_list(w, 0.0, *blocks)  # noqa: E731
        bi, na = lst()
        n_act = int(na[0])
        busy, ops = device_busy(lst)
        pbusy, pops = device_busy(plain_lst)
        lb, lby = list_bound(w, 0.0, *blocks)
        r = {"support": support, "n_active": n_act, "n_blocks": nb,
             "active_fraction": n_act / nb, "list_ms": time_device_ms(lst, KERNEL_REPS),
             "list_device_ms": busy, "list_device_ops": ops,
             "list_plain_ms": time_device_ms(plain_lst, KERNEL_REPS),
             "list_plain_device_ms": pbusy, "list_plain_device_ops": pops,
             "list_bound_ms": lb}
        list_rows.append(dict(shape=f"I_DT.Term support {support}", E=nb, support=support,
                              ms=r["list_ms"], plain_ms=r["list_plain_ms"], bound_ms=lb,
                              bound_by=lby, library_ms=None, device_ops=ops,
                              plain_device_ops=pops))
        for layout in ("packed", "dense"):
            if layout == "packed":
                scan = lambda: pk.fragment_spmv_packed(w, pt.src_ids, pt.dst_col.words,  # noqa: E731
                                                       fre.words, None, n_dst, table=table,
                                                       **kw)
                act = lambda sa: pk.fragment_spmv_packed_active(  # noqa: E731
                    w, pt.src_ids, pt.dst_col.words, fre.words, None, bi, na, n_dst,
                    scan_above=sa, table=table, **kw)
                hop = lambda mode: K.fragment_spmv_packed(  # noqa: E731
                    w, pt.src_ids, pt.dst_col.words, fre.words, n_dst=n_dst, blocks=blocks,
                    block_skipping=mode, hot_share=pt.hot_share, **kw)
            else:
                scan = lambda: dk.fragment_spmv(w, dt.src_ids, dt.dst_ids,  # noqa: E731
                                                dt.measures["Fre"], n_dst, table=dtable)
                act = lambda sa: dk.fragment_spmv_active(  # noqa: E731
                    w, dt.src_ids, dt.dst_ids, dt.measures["Fre"], bi, na, n_dst,
                    scan_above=sa, table=dtable)
                hop = lambda mode: K.fragment_spmv(  # noqa: E731
                    w, dt.src_ids, dt.dst_ids, dt.measures["Fre"], n_dst, blocks=blocks,
                    block_skipping=mode, hot_share=dt.hot_share)
            r[f"{layout}_scan_ms"] = time_device_ms(scan, KERNEL_REPS)
            r[f"{layout}_skip_ms"] = time_device_ms(lambda: act(nb), KERNEL_REPS)
            r[f"{layout}_skip_device_ms"] = device_busy(lambda: act(nb))[0]
            r[f"{layout}_scan_order_ms"] = time_device_ms(lambda: act(0), KERNEL_REPS)
            r[f"{layout}_skip_bound_ms"] = bound_ms(
                int(per_edge[layout] * min(E, n_act * 4096)) + 4 * n_src + 4 * n_dst
                + 4 * nb + 4, 2 * min(E, n_act * 4096))[0]
            for mode in ("off", "on", "auto"):
                r[f"{layout}_hop_{mode}_ms"] = time_device_ms(lambda: hop(mode), KERNEL_REPS)
        rows.append(r)
        tie = all(r[f"{lay}_skip_ms"] <= SKIP_TIE * r[f"{lay}_scan_order_ms"]
                  for lay in ("packed", "dense"))
        broken = broken or not tie
        if not broken:
            ok_up_to = n_act / nb
        log(f"  support {support}: {n_act}/{nb} blocks ({n_act / nb:.4f}); list kernel"
            f" {r['list_ms']:.4f} ms a call ({r['list_device_ms']:.4f} ms device,"
            f" {r['list_device_ops']:.0f} ops; bound {lb:.6f} ms), plain build"
            f" {r['list_plain_ms']:.4f} ms ({r['list_plain_device_ms']:.4f} ms device,"
            f" {r['list_plain_device_ops']:.0f} ops)")
        for lay in ("packed", "dense"):
            log(f"    {lay:6s} kernels: scan {r[f'{lay}_scan_ms']:.4f} / skip"
                f" {r[f'{lay}_skip_ms']:.4f} ({r[f'{lay}_skip_device_ms']:.4f} device with the"
                f" output fill, bound {r[f'{lay}_skip_bound_ms']:.4f}) / scan order"
                f" {r[f'{lay}_scan_order_ms']:.4f} ms; hop off {r[f'{lay}_hop_off_ms']:.4f} /"
                f" on {r[f'{lay}_hop_on_ms']:.4f} / auto {r[f'{lay}_hop_auto_ms']:.4f} ms")
    full = rows[-1]
    for lay in ("packed", "dense"):
        for mode in ("on", "auto"):
            full[f"{lay}_{mode}_over_off"] = full[f"{lay}_hop_{mode}_ms"] / full[f"{lay}_hop_off_ms"]
        log(f"  {lay} hop at 100% support: 'on' {full[f'{lay}_on_over_off']:.3f}x and 'auto'"
            f" {full[f'{lay}_auto_over_off']:.3f}x the scan ('off'); the reference's contract"
            f" for 'auto': at most {AUTO_OVER_SCAN}x")
    log(f"  following the list is no slower than scan order (within {SKIP_TIE}x) up to an"
        f" active fraction of {ok_up_to:.4f}")
    return rows, ok_up_to, list_rows


#: The block counts of the list's threshold sweep: the first k blocks of an
#: index, from CS's smallest SemMedDB index (13 blocks) and its largest (116)
#: up to I_DA.Doc's 2,876 and I_DT.Term's 7,079 (a count past an index's own
#: is not taken on it).
THRESHOLD_BLOCKS = (13, 42, 116, 256, 512, 1024, 2048, 2400, 2876, 4096, 5600, 7079)
#: The supports of the sweep: where the list could pay, a sparse frontier,
#: and every source (where it skips nothing).
THRESHOLD_SUPPORTS = ("one_seed", 0.01, 0.1, 1.0)
#: Rounds of the sweep, scan and list timed in turns in each: the list wins
#: at a count only where it was faster in every round.
THRESHOLD_ROUNDS = 2


def index_prefix(di, k: int) -> dict:
    """The first ``k`` EDGE_BLOCK-edge blocks of a packed index ``di`` as a
    hop's operands: src, the dst words and the packed measure words (each
    block starts and ends word-aligned), the blocks' metadata, and the
    degrees of the sources the prefix reaches (0 past its last source)."""
    from repro_torch.kernels.fragment_spmv_packed import words_needed

    E = min(int(di.src_ids.shape[0]), k * 4096)
    src = di.src_ids[:E]
    deg = di.degrees.clone()
    deg[int(src[-1]) + 1:] = 0
    meas = next(iter(di.measure_cols.values()), None)
    out = dict(E=E, blocks=(di.block_src_min[:k], di.block_src_max[:k]), src=src,
               words=di.dst_col.words[:words_needed(E, di.dst_col.width)],
               kw=dict(dst_width=di.dst_col.width, m_mode="none", m_width=0),
               measure=None, degrees=deg)
    if meas is not None and hasattr(meas, "words"):
        out["measure"] = meas.words[:words_needed(E, meas.width)]
        out["kw"].update(m_mode="packed", m_width=meas.width)
    elif meas is not None:
        out["measure"] = meas.materialize()[:E]
        out["kw"].update(m_mode="dense")
    return out


def time_list_threshold(db, device) -> tuple[list[dict], int | None]:
    """Scan against list + active kernel, each the whole hop through
    ``ops.fragment_spmv_packed`` (block_skipping 'off' against 'on': the
    list's launch and host time included), by CUDA events over back-to-back
    calls, THRESHOLD_ROUNDS rounds with the two in turns, on the first k
    blocks (THRESHOLD_BLOCKS) of I_DA.Doc and I_DT.Term as the defaults
    store them, sum, at THRESHOLD_SUPPORTS of the prefix's sources. Returns
    the rows and the measured ``SKIP_MIN_BLOCKS``: the block count after the
    largest one at which the list did not win (faster in every round) at
    any support on either index (None where the list did not win at the
    largest count, 2 where it won at every count)."""
    import torch

    from repro_torch.kernels import ops as K

    gen = torch.Generator(device=device).manual_seed(31)
    rows = []
    for name, (table, key), dst_ent in (("I_DA.Doc", ("DA", "Doc"), "Author"),
                                        ("I_DT.Term", ("DT", "Term"), "Document")):
        di = db.device.index(table, key)
        n_dst = db.schema.domain_size(dst_ent)
        base = frontier(di.indptr.shape[0] - 1, "sum", gen, device)
        for k in (k for k in THRESHOLD_BLOCKS if k <= di.block_src_min.shape[0]):
            h = index_prefix(di, k)
            for support in THRESHOLD_SUPPORTS:
                w = sparse_frontier(base, h["degrees"], support, "sum", 33)

                def hop(mode, w=w, h=h):
                    return K.fragment_spmv_packed(
                        w, h["src"], h["words"], h["measure"], n_dst=n_dst,
                        blocks=h["blocks"], block_skipping=mode, hot_share=di.hot_share,
                        **h["kw"])

                got, want = hop("on"), hop("off")
                compare(got, want, False, f"threshold {name} k={k} {support} on vs off")
                n_act = int(K.active_block_list(w, 0.0, *h["blocks"])[1][0])
                off, on = [], []
                for _ in range(THRESHOLD_ROUNDS):
                    off.append(time_device_ms(lambda: hop("off"), KERNEL_REPS))
                    on.append(time_device_ms(lambda: hop("on"), KERNEL_REPS))
                r = {"index": name, "blocks": k, "E": h["E"], "support": support,
                     "n_active": n_act, "off_ms": float(np.median(off)),
                     "on_ms": float(np.median(on)), "off_ms_rounds": off, "on_ms_rounds": on,
                     "rounds_won": sum(b < a for a, b in zip(off, on))}
                r["list_wins"] = r["rounds_won"] == THRESHOLD_ROUNDS
                rows.append(r)
            log(f"  threshold {name} first {k} blocks ({h['E']} edges), median of"
                f" {THRESHOLD_ROUNDS}: " + ", ".join(
                    f"{r['support']} {r['n_active']}/{k} active off {r['off_ms']:.4f} on"
                    f" {r['on_ms']:.4f} ms (list won {r['rounds_won']}/{THRESHOLD_ROUNDS})"
                    for r in rows[-len(THRESHOLD_SUPPORTS):]))
    counts = sorted({r["blocks"] for r in rows})
    lost = [k for k in counts if not any(r["list_wins"] for r in rows if r["blocks"] == k)]
    if not lost:
        measured = 2
    elif lost[-1] == counts[-1]:
        measured = None
    else:
        measured = counts[counts.index(lost[-1]) + 1]
    log(f"  the list did not win in every round up to {lost[-1] if lost else 'no'} blocks:"
        f" 'auto' lists from {measured} blocks (SKIP_MIN_BLOCKS measured)")
    return rows, measured


#: Host time of a wrapper: WRAPPER_ROUNDS rounds of back-to-back calls timed
#: by the host clock (the median round kept: the host is shared), and calls
#: under torch.profiler, each in a record_function range.
WRAPPER_CALLS = 1000
WRAPPER_ROUNDS = 5
WRAPPER_PROFILED_CALLS = 200


def host_us(fn, calls: int = WRAPPER_CALLS) -> dict:
    """µs a call of ``fn`` over ``calls`` back-to-back calls, the median of
    WRAPPER_ROUNDS rounds: the enqueue (host clock up to the last call's
    return) and with the drain (up to the synchronise after it); and the
    profiler's CPU time of a ``record_function`` range around each of
    WRAPPER_PROFILED_CALLS calls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(20):
        fn()
    sync()
    rounds = []
    for _ in range(WRAPPER_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        sync()
        rounds.append((t1 - t0, time.perf_counter() - t0))
    enqueue, drained = sorted(rounds)[len(rounds) // 2]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(WRAPPER_PROFILED_CALLS):
            with record_function("wrapper_call"):
                fn()
    sync()
    ev = next(e for e in prof.key_averages() if e.key == "wrapper_call")
    return {"us": enqueue / calls * 1e6, "us_with_drain": drained / calls * 1e6,
            "us_rounds": [r[0] / calls * 1e6 for r in rounds],
            "profiler_cpu_us": ev.cpu_time_total / ev.count}


def wrapper_cases(di, ddi, bitmaps, device) -> dict:
    """{name: call} of every wrapper on the single-query path at a shape of
    a few µs of device work: the packed index ``di`` and its dense twin
    ``ddi`` (the same edges) from one seed, sum; the bitmap pair on the two
    ``bitmaps``. The list kernel, the four hop wrappers (lists built
    beforehand), their ``ops`` entries with skipping 'off' and 'on',
    ``ops._plan_skip`` ('on': the list) and ``ops._hop_streams``."""
    import torch

    from repro_torch.kernels import bitmap_ops as bm
    from repro_torch.kernels import block_list as lk
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ops as K

    gen = torch.Generator(device=device).manual_seed(35)
    n_src, E = di.indptr.shape[0] - 1, int(di.src_ids.shape[0])
    n_dst = 1 << di.dst_col.width
    w = sparse_frontier(frontier(n_src, "sum", gen, device), di.degrees, "one_seed", "sum", 36)
    blocks = (di.block_src_min, di.block_src_max)
    s, words, d = di.src_ids, di.dst_col.words, ddi.dst_ids
    bi, na = lk.block_list(w, 0.0, *blocks)
    nb = int(blocks[0].shape[0])
    pkw = dict(dst_width=di.dst_col.width, m_mode="none")
    a, b = bitmaps
    return {
        "block_list.block_list": lambda: lk.block_list(w, 0.0, *blocks),
        "fragment_spmv.fragment_spmv": lambda: dk.fragment_spmv(w, s, d, None, n_dst,
                                                                table=False),
        "fragment_spmv.fragment_spmv_active": lambda: dk.fragment_spmv_active(
            w, s, d, None, bi, na, n_dst, scan_above=nb, table=False),
        "fragment_spmv_packed.fragment_spmv_packed": lambda: pk.fragment_spmv_packed(
            w, s, words, None, None, n_dst, table=False, **pkw),
        "fragment_spmv_packed.fragment_spmv_packed_active": lambda: (
            pk.fragment_spmv_packed_active(w, s, words, None, None, bi, na, n_dst,
                                           scan_above=nb, table=False, **pkw)),
        "ops.fragment_spmv off": lambda: K.fragment_spmv(w, s, d, None, n_dst, blocks=blocks,
                                                         block_skipping="off"),
        "ops.fragment_spmv on": lambda: K.fragment_spmv(w, s, d, None, n_dst, blocks=blocks,
                                                        block_skipping="on"),
        "ops.fragment_spmv_packed off": lambda: K.fragment_spmv_packed(
            w, s, words, n_dst=n_dst, blocks=blocks, block_skipping="off", **pkw),
        "ops.fragment_spmv_packed on": lambda: K.fragment_spmv_packed(
            w, s, words, n_dst=n_dst, blocks=blocks, block_skipping="on", **pkw),
        "ops._plan_skip on": lambda: K._plan_skip(w, "sum", E, blocks, "on"),
        "ops._hop_streams": lambda: K._hop_streams(s, words, None, None, di.dst_col.width,
                                                   "none", 0, device),
        "bitmap_ops.bitmap_and": lambda: bm.bitmap_and(a, b),
        "bitmap_ops.bitmap_and_popcount": lambda: bm.bitmap_and_popcount(a, b),
        "ops.bitmap_and": lambda: K.bitmap_and(a, b),
        "ops.bitmap_and_popcount": lambda: K.bitmap_and_popcount(a, b),
    }


def smallest_index(dbs, dbs_dense):
    """The packed SemMedDB index with the fewest blocks (more than one) and
    its dense twin: CS's smallest hop."""
    from repro_torch.kernels import active

    key = min((k for k, di in dbs.device.indexes.items()
               if active.n_edge_blocks(int(di.src_ids.shape[0])) > 1
               and hasattr(di.dst_col, "words")),
              key=lambda k: int(dbs.device.indexes[k].src_ids.shape[0]))
    return key, dbs.device.indexes[key], dbs_dense.device.indexes[key]


def time_wrappers(dbs, dbs_dense, masks, device) -> dict:
    """Host µs a call of each wrapper on the single-query path
    (:func:`wrapper_cases`) at CS's smallest index and path j's bitmaps."""
    from repro_torch.kernels import active

    key, di, ddi = smallest_index(dbs, dbs_dense)
    nb = active.n_edge_blocks(int(di.src_ids.shape[0]))
    rows = {}
    for name, fn in wrapper_cases(di, ddi, masks, device).items():
        rows[name] = host_us(fn)
        r = rows[name]
        log(f"  host {name:50s} {r['us']:8.2f} us a call (with the drain {r['us_with_drain']:8.2f},"
            f" profiler CPU {r['profiler_cpu_us']:8.2f})")
    log(f"  (the hops on I_{key[0]}.{key[1]}, {nb} blocks, one seed; the bitmaps"
        f" {int(masks[0].shape[0])} words)")
    return {"index": f"I_{key[0]}.{key[1]}", "blocks": nb, "rows": rows}


# ---------------------------------------------------------------------------
# batched serving (phases 3h, 4h, 4i and the batched half of 5)
# ---------------------------------------------------------------------------

#: 4h/4i batch sizes (5 pads to the 8 bucket); phase 5's.
BATCHES = (1, 5, 64)
TIME_BATCHES = (1, 8, 64)
SPMM_DENSE_HOPS = ["fragment_spmm", "fragment_spmm_active"]
SPMM_HOPS = ["fragment_spmm_packed", "fragment_spmm_packed_active"]
SPMM_FUSED = ["fragment_spmm_fused1", "fragment_spmm_fused2"]
#: a batched run launches none of these
SINGLE_KERNELS = [k for k in KERNELS if not k.startswith("fragment_spmm") and k != "block_list"]
#: row counts of the small SpMM cases: 1 and 3 rows (a 4-row chunk), one
#: chunk of 8, two chunks (the last of 5 rows), eight chunks
SMALL_BATCHES = (1, 3, 8, 13, 64)
#: per-row supports of the 8-row frontiers at the main path's shapes
ROW_SUPPORTS = ("one_seed", 0.01, 0.1, 0.5, 1.0, "one_seed", 0.01, 0.1)


def max_rel(got, want64) -> float:
    """Largest relative difference of ``got`` to float64 sums ``want64``
    over the entries where ``want64`` is not 0."""
    nz = want64 != 0
    if not bool(nz.any()):
        return 0.0
    return float(((got.double() - want64).abs()[nz] / want64.abs()[nz]).max())


def frontier_rows(n: int, B: int, op: str, gen, device, degrees=None):
    """B frontier rows for ``op``: dense random rows, or (``degrees`` given)
    rows of sparse supports cycling through ROW_SUPPORTS, so the union list
    is that of a real batch."""
    import torch

    rows = []
    for b in range(B):
        w = frontier(n, op, gen, device)
        if degrees is not None:
            w = sparse_frontier(w, degrees, ROW_SUPPORTS[b % len(ROW_SUPPORTS)], op, 100 + b)
        rows.append(w)
    return torch.stack(rows).contiguous()


def union_list(W, op, src_min, src_max, E, device):
    from repro_torch.kernels import active
    from repro_torch.kernels.ref import IDENTITY

    if E == 0:
        return full_lists(0, device)
    return active.active_block_list(W, IDENTITY[op], src_min, src_max)


def check_spmm_small(device) -> tuple[dict, int]:
    """Phase 3h (small): the four SpMM kernels at E ∈ {0, 1, 4097} × B ∈
    SMALL_BATCHES for every op, with the per-CTA table and without — the
    dense one with no, a shared and a per-row [B, E] measure, the packed one
    for packed/dense dst × every measure mode — scan and active over the
    union list, against the plain version; each row (B ≤ 8) against the
    port's SpMV kernel."""
    import torch

    from repro_torch.core.fragments import _pack_words
    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmm as sk
    from repro_torch.kernels import fragment_spmm_packed as spk
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(20)
    rng = np.random.default_rng(21)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    words = lambda v, b: t(_pack_words(v, b).view(np.int32))  # noqa: E731
    mdict = t(np.array([0.5, 3.0, 0.0, 7.25, 1.0], np.float32))
    worst = {k: 0.0 for k in SPMM_DENSE_HOPS + SPMM_HOPS}
    n = 0
    n_src, n_dst = 5000, 300
    for E in (0, 1, 4097):
        src_np = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
        dst_np = rng.integers(0, n_dst, E)
        mint, midx = rng.integers(0, 40, E), rng.integers(0, 5, E)
        src, dst = t(src_np), t(dst_np.astype(np.int32))
        bmin, bmax = (t(b) for b in active.block_ranges(src_np))
        for B, table in ((B, table) for B in SMALL_BATCHES for table in (True, False)):
            m_rows = torch.rand((B, E), generator=gen, device=device)
            for op in OPS:
                W = frontier_rows(n_src, B, op, gen, device)
                bi, na = union_list(W, op, bmin, bmax, E, device)
                exact = op != "sum"
                for mname, m in (("none", None), ("shared", t(mint.astype(np.float32))),
                                 ("per_row", m_rows)):
                    want = ref.fragment_spmm_ref(W, src, dst, m, n_dst, op=op)
                    got = sk.fragment_spmm(W, src, dst, m, n_dst, op=op, table=table)
                    got_a = sk.fragment_spmm_active(W, src, dst, m, bi, na, n_dst, op=op,
                                                    table=table)
                    what = f"fragment_spmm E={E} B={B} {op} measure {mname} table={table}"
                    worst["fragment_spmm"] = max(worst["fragment_spmm"],
                                                 compare(got, want, exact, what))
                    worst["fragment_spmm_active"] = max(
                        worst["fragment_spmm_active"],
                        compare(got_a, want, exact, f"{what} active"))
                    for b in range(B if B <= 8 else 0):
                        mb = m[b].contiguous() if mname == "per_row" else m
                        compare(got[b], dk.fragment_spmv(W[b], src, dst, mb, n_dst, op=op),
                                exact, f"{what} row {b} vs fragment_spmv")
                    n += 1
                modes = {"none": (None, None, 0), "dense": (t(mint.astype(np.float32)), None, 0),
                         "packed": (words(mint, 6), None, 6), "dict": (words(midx, 3), mdict, 3)}
                for dp in (True, False):
                    d, dw = (words(dst_np, 9), 9) if dp else (dst, 0)
                    for m_mode, (m, md, mw) in modes.items():
                        kw = dict(dst_width=dw, m_mode=m_mode, m_width=mw, op=op)
                        want = ref.fragment_spmm_packed_ref(W, src, d, m, md, n_dst, **kw)
                        got = spk.fragment_spmm_packed(W, src, d, m, md, n_dst, table=table,
                                                       **kw)
                        what = (f"fragment_spmm_packed E={E} B={B} {op} dst"
                                f" {'packed' if dp else 'dense'} {m_mode} table={table}")
                        worst["fragment_spmm_packed"] = max(worst["fragment_spmm_packed"],
                                                            compare(got, want, exact, what))
                        for sa in (None, 0):  # follow the list; scan order
                            got_a = spk.fragment_spmm_packed_active(
                                W, src, d, m, md, bi, na, n_dst, scan_above=sa, table=table,
                                **kw)
                            worst["fragment_spmm_packed_active"] = max(
                                worst["fragment_spmm_packed_active"],
                                compare(got_a, want, exact, f"{what} active {sa}"))
                        for b in range(B if B <= 8 else 0):
                            compare(got[b], pk.fragment_spmv_packed(W[b], src, d, m, md, n_dst,
                                                                    **kw),
                                    exact, f"{what} row {b} vs fragment_spmv_packed")
                        n += 1
    sync()
    log(f"  SpMM kernels: {n} small cases (E 0, 1, 4097 × B {list(SMALL_BATCHES)} × table"
        f" on/off × op × measure / dst × mode) equal the plain versions, scan and active;"
        f" every row (B ≤ 8) equals the SpMV kernel")
    return worst, n


def check_spmm_path(db, db_dense, device) -> tuple[dict, list[dict]]:
    """Phase 3h (path shapes): the four SpMM kernels at I_DT.Term (Fre) and
    I_DA.Doc at B = 8 over sparse rows and their union list, for the ops of
    PATH_SPMM_OPS, with the per-CTA table and without, against the plain
    version; each row of the form the index's hot share chooses against the
    SpMV kernel."""
    import torch

    from repro_torch.kernels import fragment_spmm as sk
    from repro_torch.kernels import fragment_spmm_packed as spk
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(22)
    worst = {k: 0.0 for k in SPMM_DENSE_HOPS + SPMM_HOPS}
    rows = []
    B = 8
    for name, (table, key), meas, dst_ent in (
        ("I_DT.Term", ("DT", "Term"), "Fre", "Document"),
        ("I_DA.Doc", ("DA", "Doc"), None, "Author"),
    ):
        di, pi = db_dense.device.index(table, key), db.device.index(table, key)
        n_src, n_dst = di.indptr.shape[0] - 1, db.schema.domain_size(dst_ent)
        m = di.measures[meas] if meas else None
        E = int(di.src_ids.shape[0])
        pm = pi.measure_cols[meas] if meas else None
        kw = dict(dst_width=pi.dst_col.width, m_mode="packed" if pm is not None else "none",
                  m_width=pm.width if pm is not None else 0)
        mw = pm.words if pm is not None else None
        chosen = uses_table(pi)
        for op, table in ((op, table) for op in PATH_SPMM_OPS
                          for table in (chosen, not chosen)):
            W = frontier_rows(n_src, B, op, gen, device, degrees=di.degrees)
            bi, na = union_list(W, op, di.block_src_min, di.block_src_max, E, device)
            exact = op != "sum"
            want = ref.fragment_spmm_ref(W, di.src_ids, di.dst_ids, m, n_dst, op=op)
            for k, got in (
                ("fragment_spmm", sk.fragment_spmm(W, di.src_ids, di.dst_ids, m, n_dst, op=op,
                                                   table=table)),
                ("fragment_spmm_active", sk.fragment_spmm_active(
                    W, di.src_ids, di.dst_ids, m, bi, na, n_dst, op=op, table=table)),
                ("fragment_spmm_packed", spk.fragment_spmm_packed(
                    W, pi.src_ids, pi.dst_col.words, mw, None, n_dst, op=op, table=table,
                    **kw)),
                ("fragment_spmm_packed_active", spk.fragment_spmm_packed_active(
                    W, pi.src_ids, pi.dst_col.words, mw, None, bi, na, n_dst, op=op,
                    table=table, **kw)),
            ):
                what = f"{k} {name} B=8 {op} table={table}"
                worst[k] = max(worst[k], compare(got, want, exact, what))
                for b in range(B if table == chosen else 0):
                    row = (pk.fragment_spmv_packed(W[b], pi.src_ids, pi.dst_col.words, mw, None,
                                                   n_dst, op=op, table=table, **kw)
                           if "packed" in k else
                           dk.fragment_spmv(W[b], di.src_ids, di.dst_ids, m, n_dst, op=op,
                                            table=table))
                    compare(got[b], row, exact, f"{what} row {b} vs SpMV kernel")
                del got
            rows.append({"shape": name, "op": op, "B": B, "table": table,
                         "n_active": int(na[0]), "n_blocks": -(-E // 4096)})
            del W, want
        log(f"  SpMM kernels at {name} (B = 8, union list {rows[-1]['n_active']}/"
            f"{rows[-1]['n_blocks']} blocks for the last op): all four in both forms equal"
            f" the plain version, ops {list(PATH_SPMM_OPS)}, and every row of the form the hot share chooses"
            f" ({'table' if chosen else 'per edge'}) the SpMV kernels")
    sync()
    return worst, rows


def check_spmm_hot(device) -> tuple[dict, int]:
    """Phase 3h (hot destinations): the four SpMM kernels on hot_cases (one
    destination; more destinations a block than table slots; Zipf) at B = 8
    and 13 (two chunks), every op, measure none and packed, scan and active
    (the list followed, and scan order), with the table and without, against
    the plain versions."""
    import torch

    from repro_torch.kernels import fragment_spmm as sk
    from repro_torch.kernels import fragment_spmm_packed as spk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(25)
    worst = {k: 0.0 for k in SPMM_DENSE_HOPS + SPMM_HOPS}
    n = 0
    for name, n_src, src, dst, dw, mwords, n_dst in hot_cases(device):
        E = int(src.shape[0])
        nb = -(-E // 4096)
        bi = torch.arange(nb, dtype=torch.int32, device=device)
        na = torch.full((1,), nb, dtype=torch.int32, device=device)
        for B, op in ((B, op) for B in (8, 13) for op in OPS):
            W = frontier_rows(n_src, B, op, gen, device)
            exact = op != "sum"
            for table in (True, False):
                what = f"{name} B={B} {op} table={table}"
                for m_mode, m, mw in (("none", None, 0), ("packed", mwords, 6)):
                    kw = dict(dst_width=dw, m_mode=m_mode, m_width=mw, op=op)
                    want = ref.fragment_spmm_packed_ref(W, src, dst, m, None, n_dst, **kw)
                    got = [("fragment_spmm_packed", spk.fragment_spmm_packed(
                        W, src, dst, m, None, n_dst, table=table, **kw))]
                    got += [("fragment_spmm_packed_active", spk.fragment_spmm_packed_active(
                        W, src, dst, m, None, bi, na, n_dst, scan_above=sa, table=table, **kw))
                            for sa in (nb, 0)]
                    if dw == 0:  # the dense kernels on the dense dst stream
                        md = None if m is None else ref.bitunpack_ref(m, 6, E).to(
                            torch.float32)
                        got += [("fragment_spmm",
                                 sk.fragment_spmm(W, src, dst, md, n_dst, op=op, table=table))]
                        got += [("fragment_spmm_active",
                                 sk.fragment_spmm_active(W, src, dst, md, bi, na, n_dst, op=op,
                                                         scan_above=sa, table=table))
                                for sa in (nb, 0)]
                    for k, g in got:
                        worst[k] = max(worst[k], compare(g, want, exact,
                                                         f"{k} {what} {m_mode}"))
                        n += 1
    sync()
    log(f"  SpMM kernels on hot destinations: {n} cases (one destination, more destinations"
        f" a block than table slots, Zipf; B 8, 13; every op; scan and active; the table on"
        f" and off) equal the plain versions")
    return worst, n


#: The ops phase 3h holds the main path's fused regions to in their SpMM
#: form at B = 8 (all four before path p came; the small regions run every
#: op, and min's and bool's combines are max's code with another identity).
PATH_REGION_OPS = ("sum", "max")
#: The ops of the SpMM kernels at the main path's shapes in phase 3h (every op
#: before path q came: min and bool stay checked at the small and hot shapes).
PATH_SPMM_OPS = ("sum", "max")


def check_spmm_fused(specs, device) -> tuple[dict, int]:
    """Phase 3h (fused): the fused regions' SpMM form, per edge and with the
    table, against the plain batched region and the unfused composition
    through the port's SpMM kernels: the small regions at B = 3 (every dst ×
    measure mode × op × mask × binarize), per edge and with the table in
    every hop, and at B = 8 (packed dst, packed and dict measures) with the
    table; the main
    path's regions (SD, AS-recent, SD-recent) at B = 8 over sparse rows and
    the device-built lists in every form (:func:`region_forms`), against the
    plain region and the unfused SpMM kernels in the same form
    (:func:`form_checks`), for the ops of PATH_REGION_OPS."""
    import torch

    from repro_torch.kernels import fragment_spmv_fused as fk
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(23)
    worst = {k: 0.0 for k in SPMM_FUSED}
    n = 0
    for E, h1s, h2s, keep in small_regions(device):
        l1, l2 = full_lists(E, device), full_lists(E + 3, device)
        for (dp, mm), s1 in h1s.items():
            s2 = h2s[(dp, mm)]
            for B in ((3, 8) if dp and mm in ("packed", "dict") else (3,)):
                for op in OPS:
                    W = frontier_rows(5000, B, op, gen, device)
                    for two, mask, binz in ((True, False, False), (True, True, True),
                                            (False, False, False), (False, True, False)):
                        mk = keep if mask else None
                        want = ref.fragment_spmm_fused_ref(W, s1, s2 if two else None, mk, 700,
                                                           500, op=op, mid_binarize=binz)
                        unf = unfused_region(W, s1, s2 if two else None, mk, None, 700, 500,
                                             op, binz)
                        k = f"fragment_spmm_fused{2 if two else 1}"
                        for table in SMALL_FORMS[-1:] if B == 8 else SMALL_FORMS:
                            if two:
                                got = fk.fragment_spmm_fused2(W, s1, s2, mk, *l1, *l2, 700,
                                                              500, op=op, mid_binarize=binz,
                                                              table1=table, table2=table)
                            else:
                                got = fk.fragment_spmm_fused1(W, s1, mk, *l1, 700, op=op,
                                                              table=table)
                            what = (f"spmm fused{2 if two else 1} E={E} B={B} dst"
                                    f" {'packed' if dp else 'dense'} {mm} {op} mask={mask}"
                                    f" binarize={binz} table={table}")
                            worst[k] = max(worst[k], compare(got, want, op != "sum",
                                                             f"{what} vs plain"))
                            worst[k] = max(worst[k], compare(
                                got, unf, op != "sum", f"{what} vs unfused SpMM kernels"))
                            n += 1
    for spec in specs:
        h1, h2 = spec["hop1"], spec["hop2"]
        E1 = int(h1.src_ids.shape[0])
        E2 = int(h2.src_ids.shape[0]) if h2 is not None else 0
        k = "fragment_spmm_fused2" if h2 is not None else "fragment_spmm_fused1"
        for op in PATH_REGION_OPS:
            W = frontier_rows(spec["n_src"], 8, op, gen, device, degrees=spec["degrees"])
            lists = K._fused_block_lists(W, op, h1, h2, E1, E2, "on")
            exact = op != "sum"
            for form, (_, want, unf) in form_checks(spec, W, op, lists, device).items():
                got = region_call(spec, W, op, lists, device, form)()
                what = f"{k} {spec['name']} B=8 {op} {form}"
                worst[k] = max(worst[k], compare(got, want, exact, f"{what} vs plain"))
                worst[k] = max(worst[k], compare(got, unf, exact,
                                                 f"{what} vs unfused SpMM scan"))
                n += 1
                del got, want, unf
            del W
        na = [int(lists[1][0])] + ([int(lists[3][0])] if h2 is not None else [])
        log(f"  {k} {spec['name']} at B = 8: lists {na}; equal to the plain region and the"
            f" unfused SpMM kernels for {list(PATH_REGION_OPS)} in every form {region_forms(spec)}")
    sync()
    log(f"  batched fused kernels: {n} regions equal the plain region and the unfused SpMM"
        f" kernels")
    return worst, n


def param_pools(db, dbs) -> dict:
    """Per parameter, the ids a user would query: those with edges in the
    index the query seeds from (documents, authors, terms, concepts); years
    over the generator's range."""
    def nz(host, table, key):
        return np.flatnonzero(np.diff(np.asarray(host[(table, key)].indptr)))

    return {"d0": nz(db.host_indexes, "DT", "Doc"), "a0": nz(db.host_indexes, "DA", "Author"),
            "t1": nz(db.host_indexes, "DT", "Term"), "t2": nz(db.host_indexes, "DT", "Term"),
            "c0": nz(dbs.host_indexes, "CS", "CID"), "y": np.arange(1990, 2016)}


def draw_params(SG, c0, pools, sizes, seed) -> dict:
    """{query: {B: {param: int64[B]}}}, drawn from a seeded generator over
    the pools."""
    rng = np.random.default_rng(seed)
    return {name: {B: {k: rng.choice(pools[k], size=B) for k in params} for B in sizes}
            for name, _, params in cases(SG, c0, True)}


def drive_batched(label, engines, SG, c0, draws, block_skipping, fusion, hop_kernels,
                  sizes, must: tuple = (), topk=None,
                  must_table: tuple = ()) -> tuple[dict, dict, list]:
    """One batched path: execute_batch over the nine queries at each B of
    ``sizes`` (and ``query_topk_batch`` for AS at ``topk`` rows), every
    counter set to 0 just before and read just after. Per batch, the launches
    of ``hop_kernels`` must equal the HopOps run outside fused regions and
    the batched fused kernels' the regions by kind — once a batch, whatever B
    is (the padded bucket decides the scratch budget); no single-query kernel
    launches; every kernel in ``must_table`` launches with a table. Returns
    ({(query, B): (params, result)}, counts, per-batch records)."""
    from repro_torch.core.engine import batch_bucket

    def delta(a, b):
        return {k: b[k] - a[k] for k in a}

    prepared = {n: engines[n].prepare(q, block_skipping=block_skipping, fusion=fusion)
                for n, q, _ in cases(SG, c0, True)}
    results, records = {}, []
    reset_counts()
    for B in sizes:
        for name, _, _ in cases(SG, c0, True):
            pq, params = prepared[name], draws[name][B]
            before = read_counts()
            out = pq.execute_batch(**params)
            d = delta(before, read_counts())
            want = expected_launches(pq.phys, fusion, batch_bucket(B))
            got = [sum(d[k] for k in hop_kernels), d["fragment_spmm_fused1"],
                   d["fragment_spmm_fused2"]]
            if got != want or any(d[k] for k in SINGLE_KERNELS):
                raise AssertionError(f"path {label} {name} B={B}: [{hop_kernels}, fused1,"
                                     f" fused2] launched {got}, expected {want} ({d})")
            if out.shape != (B, pq.phys.out_dom) or not np.isfinite(out).all():
                raise AssertionError(f"path {label} {name} B={B}: shape {out.shape} or"
                                     " non-finite values")
            results[(name, B)] = (params, out)
            records.append({"query": name, "B": B, "launches": got})
    if topk is not None:
        ids = draws["AS"][topk]["a0"]
        before = read_counts()
        tops = engines["AS"].query_topk_batch(SG.QUERY_AS, k=10, a0=ids)
        d = delta(before, read_counts())
        if sum(d[k] for k in hop_kernels) + d["fragment_spmm_fused1"] + d[
                "fragment_spmm_fused2"] < 1:
            raise AssertionError(f"path {label}: query_topk_batch launched nothing ({d})")
        rows = prepared["AS"].execute_batch(a0=ids)
        for top, row in zip(tops, rows):
            want = engines["AS"]._topk(row, 10)
            if [i for i, _ in top] != [i for i, _ in want]:
                raise AssertionError(f"query_topk_batch ids {top} != execute_batch's {want}")
    counts = read_counts()
    check_table_launches(label, must_table)
    for k in [hop_kernels[-1], *must] + (["block_list"] if block_skipping != "off" else []):
        if counts[k] < 1:
            raise AssertionError(f"path {label}: {k} never launched ({counts})")
    log(f"  path {label}: launches {({k: v for k, v in counts.items() if v})}; once a batch"
        f" for B in {list(sizes)}")
    return results, counts, records


#: The rows of a batch wider than 8 held to their single calls (every row
#: before path p came: a B = 64 batch cost 576 single calls).
WIDE_BATCH_ROWS = (0, 21, 42, 63)


def check_batched_rows(label, results, engines, SG, c0, block_skipping, fusion, gates,
                       sizes=None) -> float:
    """Each row of each batch of up to 8 rows, and WIDE_BATCH_ROWS of a
    wider one, against the single call ``pq(**row)`` of the same prepared
    query (exact for counts and memberships), the float queries' largest
    gate ratios kept in ``gates``."""
    worst, ratios = 0.0, {}
    for (name, B), (params, out) in results.items():
        if sizes is not None and B not in sizes:
            continue
        pq = engines[name].prepare(dict((n, q) for n, q, _ in cases(SG, c0, True))[name],
                                   block_skipping=block_skipping, fusion=fusion)
        for i in (range(B) if B <= 8 else WIDE_BATCH_ROWS):
            single = pq(**{k: int(v[i]) for k, v in params.items()})
            worst = max(worst, compare_gated(out[i], single, name,
                                             f"{label} {name} B={B} row {i} vs single call",
                                             ratios))
    log(f"  path {label}: every row (at B = 64 rows {list(WIDE_BATCH_ROWS)}) equals its single"
        f" call (max abs err {worst:.3g})")
    log_gates(f"path {label} rows vs single calls", ratios, gates)
    return worst


def check_batched_plain(label, results, engines, SG, c0, block_skipping, fusion,
                        gates) -> float:
    """The B = 8 batches against the same lowered plans run batched through
    the plain versions on the card with float64 sums (:class:`float64_sums`:
    the plain float32 scatter itself drifts ~1e-4 on hot authors, as for the
    single calls), the gate ratios kept in ``gates``."""
    from repro_torch.core import executor as X

    worst, ratios = 0.0, {}
    for name, q, _ in cases(SG, c0, True):
        params, out = results[(name, 8)]
        pq = engines[name].prepare(q, block_skipping=block_skipping, fusion=fusion)
        plain = X.compile_frontier_batched(engines[name].db.device, pq.phys,
                                           block_skipping=block_skipping, use_kernel=False,
                                           fusion=fusion)
        with float64_sums():
            want = plain(*[params[n] for n in pq.param_names]).cpu().numpy()
        worst = max(worst, compare_gated(out, want, name,
                                         f"{label} {name} B=8 vs plain batched", ratios))
    log(f"  path {label}: B = 8 equals the plain versions run batched with float64 sums"
        f" (max abs err {worst:.3g})")
    log_gates(f"path {label} B=8 vs plain batched", ratios, gates)
    return worst


def check_batched_quickstart(SG, run_sql, GQFastDatabase, GQFastEngine, device,
                             fusion) -> float:
    """All nine at the quickstart scale through execute_batch (B = 5), each
    row against run_sql."""
    pub = SG.make_pubmed(**QUICKSTART_PUBMED)
    sem = SG.make_semmeddb()
    c0 = busy_concept(sem)
    kw = dict(account_space=False, device=device)
    dbp, dbs = GQFastDatabase(pub, **kw), GQFastDatabase(sem, **kw)
    eng_p, eng_s = GQFastEngine(dbp), GQFastEngine(dbs)
    draws = draw_params(SG, c0, param_pools(dbp, dbs), (5,), 31)
    worst = 0.0
    for name, q, _ in cases(SG, c0, nine=True):
        schema, eng = (sem, eng_s) if name == "CS" else (pub, eng_p)
        params = draws[name][5]
        out = eng.prepare(q, fusion=fusion).execute_batch(**params)
        for i in range(5):
            row = {k: int(v[i]) for k, v in params.items()}
            worst = max(worst, compare(out[i], run_sql(schema, q, row).astype(np.float32),
                                       name in EXACT_QUERIES,
                                       f"{name} row {i} vs run_sql (quickstart, {fusion})"))
    log(f"  all nine through execute_batch (B = 5) match run_sql row by row at quickstart"
        f" scale, fusion={fusion!r} (max abs err {worst:.3g})")
    return worst


def time_batched(engines, SG, c0, draws) -> dict:
    """Per query and B: the median wall of execute_batch and queries/s,
    beside B sequential single calls; the result copy (device to host) of
    the sliced block; the profiler's device busy ms, idle share and device
    operations a batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import batch_bucket

    out = {}
    for name, q, _ in cases(SG, c0, True):
        pq = engines[name].prepare(q)
        for B in TIME_BATCHES:
            params = draws[name][B]
            rows = [{k: int(v[i]) for k, v in params.items()} for i in range(B)]
            pq.execute_batch(**params)
            reps = QUERY_REPS // 2 if B < 64 else 3
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                pq.execute_batch(**params)  # host numpy: waits for the device
                ts.append((time.perf_counter() - t0) * 1e3)
            seq = []
            for _ in range(3):
                t0 = time.perf_counter()
                for r in rows:
                    pq(**r)
                seq.append((time.perf_counter() - t0) * 1e3)
            args = [np.concatenate([params[n], np.repeat(params[n][-1:], batch_bucket(B) - B)])
                    for n in pq.param_names]
            copies = []
            for _ in range(3 if B < 64 else 2):
                dev = pq.batched_fn(*args)[:B]
                sync()
                t0 = time.perf_counter()
                dev.cpu().numpy()
                copies.append((time.perf_counter() - t0) * 1e3)
                del dev
            n_prof = 2 if B == 64 else PROFILE_REPS
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_prof):
                    pq.execute_batch(**params)
                wall = (time.perf_counter() - t0) * 1e3 / n_prof
            split = {"hop": 0.0, "copy": 0.0, "other": 0.0}
            ops_n = 0
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA:
                    continue
                kind = ("hop" if is_hop_kernel(ev.key)
                        else "copy" if "Memcpy" in ev.key else "other")
                split[kind] += ev.self_device_time_total / 1e3 / n_prof
                ops_n += ev.count
            busy = sum(split.values())
            med, seq_med = statistics.median(ts), statistics.median(seq)
            r = {"median_ms": med, "min_ms": min(ts), "qps": B / med * 1e3,
                 "sequential_ms": seq_med, "sequential_qps": B / seq_med * 1e3,
                 "copy_ms": statistics.median(copies),
                 "copy_bytes": 4 * B * pq.phys.out_dom,
                 "busy_ms": busy if busy else None, "profiled_wall_ms": wall,
                 "idle_share": max(0.0, 1.0 - busy / wall) if busy else None,
                 "hop_ms": split["hop"] if busy else None,
                 "device_copy_ms": split["copy"] if busy else None,
                 "device_ops_per_batch": ops_n / n_prof}
            out.setdefault(name, {})[B] = r
            idle = "not measured" if r["idle_share"] is None else f"{r['idle_share']:.3f}"
            log(f"  batched {name:10s} B={B:2d}: median {med:.4f} ms ({r['qps']:.1f} q/s) vs"
                f" {B} single calls {seq_med:.4f} ms ({r['sequential_qps']:.1f} q/s); copy"
                f" {r['copy_ms']:.4f} ms for {r['copy_bytes']} B; device busy"
                f" {busy:.4f} ms (hop {split['hop']:.4f}), idle share {idle},"
                f" {r['device_ops_per_batch']:.0f} device ops")
            del prof
    return out


#: The card's rate of float reductions to distinct addresses (a second):
#: scripts/hop_table_probe.py part 5 on the NVIDIA H100 80GB HBM3 at 700 W
#: (PERF.md). E·B of them is the floor of a batched hop that adds a scalar
#: an edge a row, beside its bytes bound.
RED_PER_S = 8.99e10


def time_spmm_kernels(db, db_dense, device) -> dict:
    """Per SpMM kernel at I_DT.Term and I_DA.Doc, B ∈ {1, 8, 64}, sum over
    dense random rows (every edge live for every row): CUDA-event ms in the
    form the index's hot share chooses (the per-CTA table or per edge) and
    in the other form, beside the bound (bytes: the edge streams as stored,
    once, + 4·B·n_src + 4·B·n_dst + the list; operations 2·E·B), the scalar
    reduction floor E·B / RED_PER_S, B × the SpMV kernel's ms (its form
    chosen the same way), the plain version's ms (B = 8) and torch.sparse.mm
    on the decoded CSR matrix times Wᵀ (the library yardstick; the port
    never calls it)."""
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmm as sk
    from repro_torch.kernels import fragment_spmm_packed as spk
    from repro_torch.kernels import fragment_spmv as dk
    from repro_torch.kernels import fragment_spmv_packed as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(24)
    rows = {k: [] for k in SPMM_DENSE_HOPS + SPMM_HOPS}
    for name, (table, key), meas, dst_ent in (
        ("I_DT.Term", ("DT", "Term"), "Fre", "Document"),
        ("I_DA.Doc", ("DA", "Doc"), None, "Author"),
    ):
        di, pi = db_dense.device.index(table, key), db.device.index(table, key)
        n_src, n_dst = di.indptr.shape[0] - 1, db.schema.domain_size(dst_ent)
        src, dst = di.src_ids, di.dst_ids
        m = di.measures[meas] if meas else None
        E = int(src.shape[0])
        nb = active.n_edge_blocks(E)
        pm = pi.measure_cols[meas] if meas else None
        mw = pm.words if pm is not None else None
        kw = dict(dst_width=pi.dst_col.width, m_mode="packed" if pm is not None else "none",
                  m_width=pm.width if pm is not None else 0)
        dwords = pi.dst_col.words
        chosen = uses_table(pi)
        A = csr_matrix(src, dst, m if m is not None else torch.ones(E, device=device),
                       n_src, n_dst)
        stream = {"dense": 4 * E + 4 * E + (4 * E if m is not None else 0),
                  "packed": 4 * E + 4 * dwords.shape[0] + (4 * mw.shape[0] if mw is not None
                                                          else 0)}
        for B in TIME_BATCHES:
            W = frontier_rows(n_src, B, "sum", gen, device)
            bi, na = active.active_block_list(W, 0.0, di.block_src_min, di.block_src_max)
            reps = KERNEL_REPS if B < 64 else 3
            rel64 = None
            if B <= 8:  # the yardstick computes the same function (as in time_spmm_fused)
                lib_out = torch.sparse.mm(A, W.t().contiguous()).t()
                want64 = torch.sparse.mm(A.to(torch.float64),
                                         W.t().to(torch.float64).contiguous()).t()
                compare(lib_out.double(), want64, False,
                        f"torch.sparse.mm {name} B={B} float32 vs float64")
                rel64 = max_rel(sk.fragment_spmm(W, src, dst, m, n_dst, table=chosen), want64)
                del lib_out, want64
            library_ms = time_device_ms(lambda: torch.sparse.mm(A, W.t().contiguous()), reps)
            spmv = {
                "fragment_spmm": lambda: dk.fragment_spmv(W[0], src, dst, m, n_dst,
                                                          table=chosen),
                "fragment_spmm_active": lambda: dk.fragment_spmv_active(
                    W[0], src, dst, m, bi, na, n_dst, scan_above=nb, table=chosen),
                "fragment_spmm_packed": lambda: pk.fragment_spmv_packed(
                    W[0], src, dwords, mw, None, n_dst, table=chosen, **kw),
                "fragment_spmm_packed_active": lambda: pk.fragment_spmv_packed_active(
                    W[0], src, dwords, mw, None, bi, na, n_dst, scan_above=nb,
                    table=chosen, **kw),
            }
            calls = {
                "fragment_spmm": (
                    lambda t: sk.fragment_spmm(W, src, dst, m, n_dst, table=t),
                    lambda: ref.fragment_spmm_ref(W, src, dst, m, n_dst)),
                "fragment_spmm_active": (
                    lambda t: sk.fragment_spmm_active(W, src, dst, m, bi, na, n_dst,
                                                      scan_above=nb, table=t),
                    lambda: ref.fragment_spmm_active_ref(W, src, dst, m, bi, na, n_dst)),
                "fragment_spmm_packed": (
                    lambda t: spk.fragment_spmm_packed(W, src, dwords, mw, None, n_dst,
                                                       table=t, **kw),
                    lambda: ref.fragment_spmm_packed_ref(W, src, dwords, mw, None, n_dst, **kw)),
                "fragment_spmm_packed_active": (
                    lambda t: spk.fragment_spmm_packed_active(W, src, dwords, mw, None, bi, na,
                                                              n_dst, scan_above=nb, table=t,
                                                              **kw),
                    lambda: ref.fragment_spmm_packed_active_ref(W, src, dwords, mw, None, bi, na,
                                                                n_dst, **kw)),
            }
            for k, (kern, plain) in calls.items():
                lst = 4 * nb + 4 if k.endswith("active") else 0
                b, by = bound_ms(stream["packed" if "packed" in k else "dense"]
                                 + 4 * B * n_src + 4 * B * n_dst + lst, 2 * E * B)
                r = dict(shape=name, E=E, B=B, form="table" if chosen else "per edge",
                         hot_share=pi.hot_share,
                         ms=time_device_ms(lambda: kern(chosen), reps),
                         other_form_ms=time_device_ms(lambda: kern(not chosen), reps),
                         spmv_ms=time_device_ms(spmv[k], KERNEL_REPS),
                         plain_ms=time_device_ms(plain, 5) if B == 8 else None,
                         bound_ms=b, bound_by=by, reduction_floor_ms=E * B / RED_PER_S * 1e3,
                         library_ms=library_ms, max_rel_vs_float64=rel64)
                r["spmv_x_B_ms"] = r["spmv_ms"] * B
                rows[k].append(r)
                plain_s = "not measured" if r["plain_ms"] is None else f"{r['plain_ms']:.4f} ms"
                log(f"  {k:28s} {name:10s} B={B:2d} {r['form']:8s} {r['ms']:.4f} ms"
                    f" (other form {r['other_form_ms']:.4f})  bound {b:.4f} ms ({by}),"
                    f" reduction floor {r['reduction_floor_ms']:.4f} ms  {B} x SpMV"
                    f" {r['spmv_x_B_ms']:.4f} ms  plain {plain_s}  torch.sparse.mm"
                    f" {library_ms:.4f} ms"
                    + (f"  (fragment_spmm vs float64 sums: max rel {rel64:.3g})"
                       if rel64 is not None else ""))
            del W
        del A
    return rows


def time_spmm_fused(specs, device) -> dict:
    """The fused regions' SpMM form at the region shapes, B = 8 over sparse
    rows, sum: the kernel over its prebuilt lists in the main path's form
    and in the others (:func:`region_forms`); the unfused composition
    through the SpMM kernels, each hop in the form its hot share chooses
    (hop2's list from the intermediate); the plain
    region; torch.sparse.mm on the decoded CSR matrices and the mask; the
    bytes bound of the listed blocks' streams + W + keep (a byte an entry)
    + out (+ u through HBM when 4·B·n_mid passes the L2)."""
    import torch

    from repro_torch.kernels import active
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(25)
    rows = {k: [] for k in SPMM_FUSED}
    B = 8
    for spec in specs:
        h1, h2 = spec["hop1"], spec["hop2"]
        E1 = int(h1.src_ids.shape[0])
        E2 = int(h2.src_ids.shape[0]) if h2 is not None else 0
        n_mid = h1.n_dst
        n_dst = h2.n_dst if h2 is not None else n_mid
        k = "fragment_spmm_fused2" if h2 is not None else "fragment_spmm_fused1"
        s1 = K._streams(h1, device)
        s2 = K._streams(h2, device) if h2 is not None else None
        mask, binz = spec["mask"], spec["binarize"]
        W = frontier_rows(spec["n_src"], B, "sum", gen, device, degrees=spec["degrees"])
        lists = K._fused_block_lists(W, "sum", h1, h2, E1, E2, "on")
        fused = region_call(spec, W, "sum", lists, device)
        got = fused()
        u = unfused_region(W, s1, None, mask, None, n_mid, n_dst, "sum", False)
        ul = list(lists[:2])
        if h2 is not None:
            ul += list(active.active_block_list(ref.binarize(u, "sum") if binz else u, 0.0,
                                                *(torch.as_tensor(b, device=device)
                                                  for b in h2.blocks)))
        del u
        forms = region_forms(spec)
        unf = lambda: unfused_region(W, s1, s2, mask, ul, n_mid, n_dst, "sum", binz,  # noqa: E731
                                     forms["ops"])
        # both sides take the table on a hot index
        edge = unf()
        vs_unfused = gate_ratio(got.cpu().numpy(), edge.cpu().numpy())
        compare(got, edge, False, f"{k} {spec['name']} B=8 vs unfused SpMM kernels")
        del edge
        na1 = int(lists[1][0])
        na2 = int(lists[3][0]) if h2 is not None else 0
        e1, e2 = min(E1, na1 * 4096), min(E2, na2 * 4096)
        nbytes = (stream_bytes(s1, E1) * e1 + (stream_bytes(s2, E2) * e2 if s2 else 0)
                  + 4 * B * spec["n_src"] + (n_mid if mask is not None else 0)
                  + 4 * B * n_dst + 4 * (lists[0].shape[0] + (lists[2].shape[0] if s2 else 0)))
        if h2 is not None and 4 * B * n_mid > L2_BYTES:
            nbytes += 8 * B * n_mid  # u written and read once through HBM
        b, by = bound_ms(int(nbytes), 2 * B * (e1 + e2))
        A1 = csr_matrix(*decoded(h1, device), spec["n_src"], n_mid)
        A2 = csr_matrix(*decoded(h2, device), n_mid, n_dst) if h2 is not None else None

        def lib(a1=A1, a2=A2, w=W):
            x = torch.sparse.mm(a1, w.t().contiguous())
            if mask is not None:
                x = torch.where(mask[:, None] > 0, x, 0.0)
            if a2 is not None:
                x = torch.sparse.mm(a2, (x > 0).to(x.dtype) if binz else x)
            return x.t()

        # the yardstick computes the same function: its float32 result
        # against the float64 one; the kernel is held to
        # FLOAT64_LIMIT["batched"] (the plain version's float32 scatter, a
        # sum an edge, drifts ~1e-4 on the hottest authors' million-term sums)
        want64 = lib(A1.to(torch.float64), A2.to(torch.float64) if A2 is not None else None,
                     W.to(torch.float64))
        lib32 = lib()
        compare(lib32.double(), want64, False,
                f"{k} {spec['name']} B=8: torch.sparse.mm float32 vs float64")
        r_kernel = max_rel(got, want64)
        if not r_kernel <= FLOAT64_LIMIT["batched"]:
            raise AssertionError(f"{k} {spec['name']} B=8: relative difference {r_kernel:.3g}"
                                 f" to the float64 sums beyond {FLOAT64_LIMIT['batched']:g}")
        # the same rows one at a time through the SpMV hops, whose packed
        # pair sums per CTA in its table on a hot index (I_DA.Doc)
        single = torch.stack([K.fragment_spmv_fused(
            W[i], h1, h2, mask, op="sum", mid_binarize=binz, fusion="off",
            block_skipping="off") for i in range(B)])
        r_single = max_rel(single, want64)
        del single
        log(f"    {spec['name']} B=8: max relative difference to the float64 sums:"
            f" kernel {r_kernel:.3g}, the rows through the SpMV hops {r_single:.3g}, float32"
            f" torch.sparse.mm {max_rel(lib32, want64):.3g}"
            + f" (limit {FLOAT64_LIMIT['batched']:g}); against the unfused SpMM"
              f" kernels gate ratio {vs_unfused:.3g}")
        del want64, lib32
        r = dict(shape=spec["name"], E=e1 + e2, B=B, n_mid=n_mid, max_rel_vs_float64=r_kernel,
                 spmv_hops_max_rel_vs_float64=r_single, unfused_gate_ratio=vs_unfused,
                 n_active=[na1] + ([na2] if s2 else []),
                 ms=time_device_ms(fused, KERNEL_REPS), tables=forms["ops"],
                 ms_forms={f: time_device_ms(region_call(spec, W, "sum", lists, device, f),
                                             KERNEL_REPS) for f in forms if f != "ops"},
                 unfused_ms=time_device_ms(unf, KERNEL_REPS),
                 plain_ms=time_device_ms(lambda: ref.fragment_spmm_fused_ref(
                     W, s1, s2, mask, n_mid, n_dst, op="sum", mid_binarize=binz,
                     lists=lists), 5),
                 library_ms=time_device_ms(lib, KERNEL_REPS), bound_ms=b, bound_by=by)
        rows[k].append(r)
        log(f"  {k:22s} {r['shape']}: {r['ms']:.4f} ms (tables {r['tables']}; other forms"
            f" {r['ms_forms']}; lists {r['n_active']}) unfused SpMM"
            f" kernels {r['unfused_ms']:.4f} ms; bound {b:.4f} ms ({by}); plain"
            f" {r['plain_ms']:.4f} ms; torch.sparse.mm {r['library_ms']:.4f} ms")
        del A1, A2, W, got
    return rows


# ---------------------------------------------------------------------------
# the strategies and query profiling (phases 2, 4k, 4l and the crossover of 5)
# ---------------------------------------------------------------------------

#: The scalar walk's paths grow with the seed's reach, not with the edges it
#: touches (paths never merge): AS from a0=7 would walk ~1.3e12 of them. The
#: fragment_loop paths seed AS and AS-recent from authors whose walk holds
#: about this many paths at its last hop (``walk_sizes``).
LOOP_AUTHOR_PATHS = 10_000_000
#: phase 5's crossover sweep: SD and FSD at documents, AS at authors, picked
#: at these quantiles of the walk's paths (authors among those whose walk
#: holds at most CROSSOVER_MAX_PATHS), both strategies in turns for
#: CROSSOVER_ROUNDS rounds of QUERY_REPS calls each
CROSSOVER_DOC_QUANTILES = (0.0, 0.01, 0.05, 0.2, 0.5, 0.8, 0.95, 1.0)
CROSSOVER_AUTHOR_QUANTILES = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
CROSSOVER_MAX_PATHS = 30_000_000
CROSSOVER_ROUNDS = 2
#: path l: the queries profiled under the defaults and under fragment_loop
PROFILED = ("SD", "AS", "AD")


def walk_sizes(pub) -> dict:
    """The scalar walk's path counts, on the host: per document the paths SD
    holds after its second hop (the sum of its terms' degrees), per author
    the paths AS holds after its fourth (over its documents' terms, each
    term's documents' author counts)."""
    dt, da = pub.relationships["DT"].columns, pub.relationships["DA"].columns
    n_docs = pub.entities["Document"].size
    n_terms = pub.entities["Term"].size
    term_deg = np.bincount(dt["Term"], minlength=n_terms).astype(np.float64)
    doc_paths = np.bincount(dt["Doc"], weights=term_deg[dt["Term"]], minlength=n_docs)
    doc_authors = np.bincount(da["Doc"], minlength=n_docs).astype(np.float64)
    term_authors = np.bincount(dt["Term"], weights=doc_authors[dt["Doc"]], minlength=n_terms)
    doc_paths4 = np.bincount(dt["Doc"], weights=term_authors[dt["Term"]], minlength=n_docs)
    author_paths = np.bincount(da["Author"], weights=doc_paths4[da["Doc"]],
                               minlength=pub.entities["Author"].size)
    return {"doc": doc_paths, "author": author_paths}


def near(paths: np.ndarray, target: float, n: int) -> np.ndarray:
    """The ``n`` ids whose path counts lie nearest ``target`` (by ratio)."""
    ok = np.flatnonzero(paths > 0)
    return ok[np.argsort(np.abs(np.log(paths[ok] / target)), kind="stable")[:n]]


def at_quantiles(paths: np.ndarray, quantiles, cap: float = np.inf) -> list[int]:
    """Distinct ids at the given quantiles of the nonzero path counts up to
    ``cap``."""
    ok = np.flatnonzero((paths > 0) & (paths <= cap))
    order = ok[np.argsort(paths[ok], kind="stable")]
    picks = [int(order[min(int(q * (order.shape[0] - 1)), order.shape[0] - 1)])
             for q in quantiles]
    return list(dict.fromkeys(picks))


def loop_cases(SG, c0, sizes: dict) -> list:
    """The nine queries for the fragment_loop paths: AS and AS-recent from
    the author nearest LOOP_AUTHOR_PATHS paths, the others as ``cases``."""
    a0 = int(near(sizes["author"], LOOP_AUTHOR_PATHS, 1)[0])
    return [(n, q, {"a0": a0} if n in ("AS", "AS_RECENT") else p)
            for n, q, p in cases(SG, c0, True)]


def strategy_launches(pq) -> list[int]:
    """[hop-kernel launches, fused1, fused2] one call of ``pq`` makes: none
    for a plan fragment_loop walks path by path, the unfused frontier's for
    one it falls back on."""
    from repro_torch.core import executor as X

    if pq.strategy == "fragment_loop":
        return [0, 0, 0] if X.walks_scalar(pq.phys) else expected_launches(pq.phys, "off")
    return expected_launches(pq.phys, pq.fusion)


def truth_for(engines, qs) -> dict:
    """Each float query of ``qs`` through the plain versions with float64
    sums (skipping and fusion off), at its own parameters."""
    from repro_torch.core import executor as X

    out = {}
    with float64_sums():
        for name, q, params in qs:
            if name in EXACT_QUERIES:
                continue
            pq = engines[name].prepare(q, block_skipping="off", fusion="off")
            run = X.compile_frontier(engines[name].db.device, pq.phys, block_skipping="off",
                                     use_kernel=False, fusion="off")
            out[name] = run(*[params[n] for n in pq.param_names]).cpu().numpy()
    return out


def walk_bytes(db, eng, SG, a0: int) -> dict:
    """Device bytes before and after fragment_loop prepares and runs SD, FSD
    and AS on ``db``: the column store's (device_space_report, with the
    bytes a materialize() memo pins) must not move, as the walk reads packed
    columns by gather; the allocator's live bytes are logged beside."""
    import gc

    import torch

    from repro_torch.storage import device_space_report

    def state():
        gc.collect()
        sync()
        rep = device_space_report(db.device)
        return {"total_bytes": rep["total_bytes"], "materialized_bytes":
                rep["materialized_bytes"], "allocated": torch.cuda.memory_allocated()}

    before = state()
    for q, params in ((SG.QUERY_SD, {"d0": 5}), (SG.QUERY_FSD, {"d0": 5}),
                      (SG.QUERY_AS, {"a0": a0})):
        eng.prepare(q)(**params)
    after = state()
    log(f"  fragment_loop prepare and run of SD, FSD, AS (a0={a0}): device bytes {before} ->"
        f" {after}")
    if (after["total_bytes"], after["materialized_bytes"]) != (before["total_bytes"], 0):
        raise AssertionError(f"the scalar walk changed the column store's bytes: {before} ->"
                             f" {after}")
    return {"before": before, "after": after}


def drive_strategy(label, engines, defaults, SG, qs, truth, gates) -> tuple[dict, dict, dict]:
    """One strategy path over ``qs`` through ``GQFastEngine.query`` and
    ``query_topk`` (AS), every counter set to 0 just before and read just
    after. Per query the hop kernels' launches must equal the plan's: none
    for a scalar walk (no kernel at all), the frontier's otherwise. Each
    result against the defaults' frontier result (``defaults``: exact for
    the counts, gated) and the float sums against ``truth`` within
    FLOAT64_LIMIT. Returns (results, counts, per-query records)."""
    from repro_torch.core import executor as X
    from repro_torch.obs.profile import observed_hop_fractions

    prepared = {n: engines[n].prepare(q) for n, q, _ in qs}
    hops = PACKED_HOPS + ["fragment_spmv", "fragment_spmv_active"]
    results, records = {}, {}
    reset_counts()
    for name, q, params in qs:
        before = read_counts()
        results[name] = engines[name].query(q, **params)
        d = {k: v - before[k] for k, v in read_counts().items()}
        pq = prepared[name]
        want = strategy_launches(pq)
        got = [sum(d[k] for k in hops), d["fragment_spmv_fused1"], d["fragment_spmv_fused2"]]
        scalar = pq.strategy == "fragment_loop" and X.walks_scalar(pq.phys)
        if got != want or (scalar and any(d.values())):
            raise AssertionError(f"path {label} {name} ({pq.strategy}): [hops, fused1, fused2]"
                                 f" launched {got}, expected {want} ({d})")
        records[name] = {"strategy": pq.strategy, "scalar": scalar, "launches": got,
                         "est_worst": max((h["est_active_fraction"]
                                           for h in pq.hop_estimates), default=1.0)}
    top = engines["AS"].query_topk(SG.QUERY_AS, k=10, **next(p for n, _, p in qs if n == "AS"))
    counts = read_counts()
    if not any(r["scalar"] for r in records.values()) and label.startswith("k: fragment"):
        raise AssertionError(f"path {label}: no plan walked path by path")
    want = engines["AS"]._topk(results["AS"], 10)
    if [i for i, _ in top] != [i for i, _ in want]:
        raise AssertionError(f"path {label}: query_topk ids {top} != query's {want}")
    ratios = {}
    for name, q, params in qs:
        got = results[name]
        if got.shape != defaults[name].shape or not np.isfinite(got).all() or not got.any():
            raise AssertionError(f"path {label} {name}: shape {got.shape}, non-finite or empty")
        compare_gated(got, defaults[name], name, f"{label} {name} vs the defaults", ratios)
        obs = observed_hop_fractions(prepared[name].phys, params)
        records[name]["observed_worst"] = max(h["observed_active_fraction"] for h in obs)
        records[name]["touched_edges"] = [h["touched_edges"] for h in obs]
    log_gates(f"path {label} vs the defaults", ratios, gates)
    rel = hold_f64(label, results, truth, "single")
    for name, r in records.items():
        log(f"    {name:10s} {r['strategy']:13s} {'scalar walk' if r['scalar'] else 'frontier'}"
            f" launches {r['launches']}, worst fraction estimated {r['est_worst']:.4g},"
            f" observed {r['observed_worst']:.4g}")
    log(f"  path {label}: launches {({k: v for k, v in counts.items() if v})}")
    return results, counts, {"queries": records, "float64_rel": rel}


def drive_strategy_batched(label, engines, SG, qs, rows: dict, gates) -> dict:
    """``execute_batch`` at B = 8 over ``qs`` (parameters ``rows[name]``),
    every row against its single call (exact for the counts, gated)."""
    ratios, worst = {}, 0.0
    for name, q, _ in qs:
        pq = engines[name].prepare(q)
        out = pq.execute_batch(**rows[name])
        if out.shape != (8, pq.phys.out_dom) or not np.isfinite(out).all():
            raise AssertionError(f"path {label} {name}: shape {out.shape} or non-finite values")
        for i in range(8):
            single = pq(**{k: int(v[i]) for k, v in rows[name].items()})
            worst = max(worst, compare_gated(out[i], single, name,
                                             f"{label} {name} B=8 row {i} vs single call",
                                             ratios))
    log(f"  path {label}: execute_batch B = 8, every row equals its single call (max abs err"
        f" {worst:.3g})")
    log_gates(f"path {label} B=8 rows vs single calls", ratios, gates)
    return ratios


def host_walk(phys, params, hops_out) -> np.ndarray:
    """The observed hop fractions by a numpy walk of the plan on the host, as
    the JAX package computes them: the support as a host array, each hop's
    sources from the card and its destinations from the host index
    (``HopOp.host_dst``)."""
    from repro_torch.core.lower import (
        DegreeFilterOp, EntityFilterOp, HopOp, LParam, SeedOp, iter_flat_ops,
    )
    from repro_torch.kernels.active import active_block_list_np

    host = lambda t: t.cpu().numpy()
    sup = None
    for op in iter_flat_ops(phys):
        if isinstance(op, SeedOp):
            if op.ids is not None:
                sup = np.zeros(op.dom, bool)
                sup[[int(params[i.name]) if isinstance(i, LParam) else int(i)
                     for i in op.ids]] = True
            else:
                sup = np.ones(op.dom, bool)
                for prog in op.programs:
                    sup &= host_walk(prog, params, None)
                if op.const_mask is not None:
                    sup &= host(op.const_mask) > 0
                for c in op.param_conds:
                    sup &= host(c.mask(params, lambda c: c.array))
        elif isinstance(op, HopOp):
            active = sup[host(op.src_ids)]
            reached = np.zeros(op.dom_dst, bool)
            reached[np.asarray(op.host_dst)[active]] = True
            if hops_out is not None:
                _, na, _ = active_block_list_np(sup, host(op.block_src_min),
                                                host(op.block_src_max))
                hops_out.append({"touched_edges": int(active.sum()),
                                 "frontier_nnz": int(sup.sum()),
                                 "reached": int(reached.sum()), "active_blocks": int(na[0])})
            sup = reached
        elif isinstance(op, DegreeFilterOp):
            sup = sup & (host(op.degrees) > 0)
        elif isinstance(op, EntityFilterOp):
            if op.const_mask is not None:
                sup = sup & (host(op.const_mask) > 0)
            for c in op.param_conds:
                sup = sup & host(c.mask(params, lambda c: c.array))
    return sup


def drive_profiles(engines_by_strategy, SG, qs, truth, gates) -> dict:
    """Path l: ``profile()`` and ``explain(analyze=True)`` of PROFILED under
    each strategy of ``engines_by_strategy``. The self walls must sum to
    ``total_wall_ms``; the observed fractions on the card must equal the
    host's numpy walk of the same plan, integer for integer; the result must
    equal ``__call__``'s (exact for the counts, gated; on the card a float
    sum's last bits may differ from call to call) and hold to the float64
    sums within FLOAT64_LIMIT."""
    out, ratios = {}, {}
    for strategy, engines in engines_by_strategy.items():
        for name, q, params in qs:
            if name not in PROFILED:
                continue
            pq = engines[name].prepare(q)
            prof = pq.profile(reps=PROFILE_REPS, **params)
            walls = [o.wall_ms for o in prof.ops if o.wall_ms is not None]
            if abs(sum(walls) - prof.total_wall_ms) > 1e-6 * prof.total_wall_ms:
                raise AssertionError(f"path l {strategy} {name}: self walls sum to {sum(walls)},"
                                     f" total {prof.total_wall_ms}")
            want = []
            host_walk(pq.phys, params, want)
            keys = ("touched_edges", "frontier_nnz", "reached", "active_blocks")
            got = [{k: h.meta[k] for k in keys} for h in prof.hops]
            if got != want:
                raise AssertionError(f"path l {strategy} {name}: observed fractions on the card"
                                     f" {got} != the host walk's {want}")
            compare_gated(prof.result, pq(**params), name,
                          f"l {strategy} {name} profile vs __call__", ratios)
            if name in truth:
                hold_f64(f"l {strategy} {name}", {name: prof.result}, {name: truth[name]},
                         "single")
            text = pq.explain(analyze=True, **params)
            if not text.startswith(pq.explain()) or "analyze: total" not in text:
                raise AssertionError(f"path l {strategy} {name}: explain(analyze=True) is not"
                                     " explain() extended")
            out[f"{strategy} {name}"] = {
                "strategy": pq.strategy, "total_wall_ms": prof.total_wall_ms,
                "timing_method": prof.timing_method, "phases": prof.phase_summary(),
                "calls": [o.calls for o in prof.ops],
                "hops": [h.to_dict() for h in prof.hops]}
            log(f"  path l {strategy:13s} {name}: {pq.strategy}, total {prof.total_wall_ms:.4f}"
                f" ms; self walls {prof.phase_summary()}; calls {[o.calls for o in prof.ops]};"
                f" hops est/obs " + ", ".join(
                    f"I_{h.table}.{h.src_key} {h.est_active_fraction:.4g}/"
                    f"{h.observed_active_fraction:.4g}" for h in prof.hops))
    log_gates("path l profile vs __call__", ratios, gates)
    return out


def time_crossover(eng_f, eng_l, SG, sizes) -> tuple[list[dict], float]:
    """The strategies' crossover: SD and FSD at documents, AS at authors,
    chosen at quantiles of the walk's paths (CROSSOVER_*_QUANTILES), each
    through the defaults (frontier) and fragment_loop, CROSSOVER_ROUNDS
    rounds with the two in turns, the median wall of QUERY_REPS calls each
    round. Returns the rows and the measured FRAGMENT_LOOP_CROSSOVER: the
    observed worst fraction of the first point (by that fraction) at which
    fragment_loop did not win every round, 0 where that is the first point,
    the largest fraction measured where it won everywhere."""
    from repro_torch.obs.profile import observed_hop_fractions

    docs = at_quantiles(sizes["doc"], CROSSOVER_DOC_QUANTILES)
    authors = at_quantiles(sizes["author"], CROSSOVER_AUTHOR_QUANTILES, CROSSOVER_MAX_PATHS)
    rows = []
    for name, q, key, seeds, paths in (("SD", SG.QUERY_SD, "d0", docs, sizes["doc"]),
                                       ("FSD", SG.QUERY_FSD, "d0", docs, sizes["doc"]),
                                       ("AS", SG.QUERY_AS, "a0", authors, sizes["author"])):
        pf, pl = eng_f.prepare(q), eng_l.prepare(q)
        for s in seeds:
            params = {key: s}
            obs = observed_hop_fractions(pl.phys, params)
            compare(pl(**params), pf(**params), name == "SD", f"crossover {name} {params}")
            ms = {"frontier": [], "fragment_loop": []}
            for r in range(CROSSOVER_ROUNDS):
                for label, pq in (("frontier", pf), ("fragment_loop", pl))[::1 - 2 * (r % 2)]:
                    ts = []
                    for _ in range(QUERY_REPS):
                        t0 = time.perf_counter()
                        pq(**params)  # returns host numpy: waits for the device
                        ts.append((time.perf_counter() - t0) * 1e3)
                    ms[label].append(statistics.median(ts))
            row = {"query": name, key: s, "paths": float(paths[s]),
                   "worst": max(h["observed_active_fraction"] for h in obs),
                   "fractions": [h["observed_active_fraction"] for h in obs],
                   "frontier_ms": ms["frontier"], "fragment_loop_ms": ms["fragment_loop"]}
            row["loop_wins"] = all(b < a for a, b in zip(ms["frontier"], ms["fragment_loop"]))
            rows.append(row)
            log(f"  crossover {name} {key}={s}: {row['paths']:.0f} paths, worst fraction"
                f" {row['worst']:.4g}; median ms by round frontier "
                + "/".join(f"{v:.4f}" for v in ms["frontier"]) + ", fragment_loop "
                + "/".join(f"{v:.4f}" for v in ms["fragment_loop"])
                + (" (fragment_loop won every round)" if row["loop_wins"] else ""))
    pts = sorted(rows, key=lambda r: r["worst"])
    lost = [i for i, r in enumerate(pts) if not r["loop_wins"]]
    measured = pts[-1]["worst"] if not lost else (0.0 if lost[0] == 0 else pts[lost[0]]["worst"])
    log(f"  fragment_loop won every round below a worst fraction of {measured:.6g}"
        " (FRAGMENT_LOOP_CROSSOVER measured)")
    return rows, measured


# ---------------------------------------------------------------------------
# CRC-32C and the durability layer (phases 3c, 4m, 4n and their times in 5)
# ---------------------------------------------------------------------------

#: 3c: stream lengths (bytes) the CRC kernel is held to its plain version at,
#: each at these byte offsets off a 16-byte boundary
CRC_SIZES = (0, 1, 3, 4, 7, 8, 9, 4095, 4096, 4097, 2**20 + 3)
CRC_OFFSETS = (0, 1, 2, 3, 5, 15)
#: 4m: the AS deadline on the fragment_loop rung, and the walks (of
#: params.FRAGMENT_LOOP_MAX_PATHS paths) timed alone beside its gate
LADDER_DEADLINE_MS = 2000.0
CHUNK_WALKS = 3
#: 5: walls with a manifest attached against without, in turns
MANIFEST_REPS = 30
MANIFEST_QUERIES = ("SD", "AS")


def crc_parts(db) -> list[tuple[str, object]]:
    """Every encoded part and decoded view of every column of ``db`` as
    (label, tensor): what manifests, verified reads and the scrubber hash."""
    from repro_torch.storage import decode_fresh, encoded_parts, iter_columns

    out = []
    for addr, _, _, col in iter_columns(db.device):
        for i, part in enumerate(encoded_parts(col)):
            out.append((f"{addr} encoded[{i}]", part))
        out.append((f"{addr} decoded", decode_fresh(col)))
    return out


def check_crc(db, device) -> dict:
    """3c: the CRC kernel against its plain version (and, at 9 bytes, the
    check value 0xE3069283) at CRC_SIZES × CRC_OFFSETS from 0 and from a
    random previous value, then on every encoded part and decoded view of
    every column of the PubMed cell's ``db``, equal value for value."""
    import torch

    from repro_torch.kernels import crc32c as ck
    from repro_torch.kernels import ref

    gen = np.random.default_rng(21)
    n_small = 0
    for n in CRC_SIZES:
        raw = torch.tensor(gen.integers(0, 256, n + 16, dtype=np.uint8), device=device)
        for off in CRC_OFFSETS:
            data = raw[off:off + n]
            for value in (0, int(gen.integers(0, 2**32))):
                got, want = int(ck.crc32c(data, value)), int(ref.crc32c_ref(data, value))
                if got != want:
                    raise AssertionError(f"crc32c n={n} offset={off} value={value}: kernel"
                                         f" {got:#010x} != plain {want:#010x}")
                n_small += 1
    check = torch.tensor(list(b"123456789"), dtype=torch.uint8, device=device)
    if int(ck.crc32c(check)) != 0xE3069283:
        raise AssertionError(f"crc32c check value {int(ck.crc32c(check)):#010x} != 0xe3069283")
    cols, nbytes = 0, 0
    for label, part in crc_parts(db):
        b = ck.as_bytes(part)
        got, want = int(ck.crc32c(b)), int(ref.crc32c_ref(b))
        if got != want:
            raise AssertionError(f"crc32c {label}: kernel {got:#010x} != plain {want:#010x}")
        cols += 1
        nbytes += b.shape[0]
    sync()
    log(f"  crc32c: {n_small} streams (n = {CRC_SIZES}, offsets {CRC_OFFSETS}) and the check"
        f" value equal to the plain version; every column of the PubMed cell: {cols} encoded"
        f" parts and decoded views, {nbytes} bytes, equal")
    return {"small_cases": n_small, "parts": cols, "bytes": nbytes}


def time_crc(db, device) -> list[dict]:
    """CUDA-event ms of the CRC kernel beside its bound (bytes / HBM), its
    plain version's ms (no library call computes CRC-32C): first on the
    largest encoded part of the PubMed cell (I_DT's packed words), then
    summed over every encoded part, every decoded view, and both (the whole
    column store as manifests hash it)."""
    from repro_torch.kernels import crc32c as ck
    from repro_torch.kernels import ref

    parts = [(label, ck.as_bytes(t)) for label, t in crc_parts(db)]
    timed = []
    for label, b in parts:
        ms = time_device_ms(lambda: ck.crc32c(b), KERNEL_REPS)
        plain = time_device_ms(lambda: ref.crc32c_ref(b), 1)
        timed.append((label, int(b.shape[0]), ms, plain))
    rows = []
    big = max((t for t in timed if "encoded" in t[0]), key=lambda t: t[1])
    groups = [(big[0], [big]),
              ("every encoded part", [t for t in timed if "encoded" in t[0]]),
              ("every decoded view", [t for t in timed if "decoded" in t[0]]),
              ("the whole store, encoded and decoded", timed)]
    for shape, ts in groups:
        nbytes = sum(t[1] for t in ts)
        b, by = bound_ms(nbytes + 8 * len(ts), nbytes)
        rows.append(dict(shape=shape, E=nbytes, calls=len(ts), ms=sum(t[2] for t in ts),
                         plain_ms=sum(t[3] for t in ts), bound_ms=b, bound_by=by,
                         library_ms=None))
        r = rows[-1]
        log(f"  {'crc32c':28s} {shape}: {nbytes} bytes in {len(ts)} calls {r['ms']:.4f} ms"
            f"  bound {b:.4f} ms ({by})  plain {r['plain_ms']:.4f} ms  library none")
    return rows


def chunk_ms(pq, sizes) -> float:
    """The longest of CHUNK_WALKS fragment_loop walks of AS (the ladder's
    terminus) from the author whose walk holds nearest
    ``params.FRAGMENT_LOOP_MAX_PATHS`` paths: one chunk's time, with the
    hops before it."""
    from repro_torch.kernels import params as KP
    from repro_torch.robust.runner import rung_fn

    a = int(near(sizes["author"], KP.FRAGMENT_LOOP_MAX_PATHS, 1)[0])
    fn = rung_fn(pq, "fragment_loop")
    fn(a)
    sync()
    ts = []
    for _ in range(CHUNK_WALKS):
        t0 = time.perf_counter()
        fn(a)
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    log(f"  one chunk: AS from a0={a} ({sizes['author'][a]:.0f} paths) on the fragment_loop"
        f" rung {', '.join(f'{t:.1f}' for t in ts)} ms")
    return max(ts)


def deadline_reads(call) -> tuple:
    """``call()``'s outcome with every deadline read the executor made inside
    it (``executor.check_deadline``, the walk's reads at each op and before
    each ``fragment_loop`` chunk): ``(host clock, where, raised)`` a read,
    and the host clock when ``call`` returned."""
    from repro_torch.core import executor as EX
    from repro_torch.robust.errors import DeadlineExceeded

    reads, real = [], EX.check_deadline

    def recording(where: str = "op") -> None:
        try:
            real(where)
        except DeadlineExceeded:
            reads.append((time.perf_counter(), where, True))
            raise
        reads.append((time.perf_counter(), where, False))

    EX.check_deadline = recording
    try:
        oc = call()
        return oc, reads, time.perf_counter()
    finally:
        EX.check_deadline = real


def deadline_overshoot(oc, reads: list, t_return: float, deadline_ms: float) -> dict:
    """Path m's deadline gate. The code guarantees that a walk past its
    deadline stops at its next deadline read: the overshoot is at most the
    longest stretch between two reads (one chunk, with the hops' work the
    reads bracket) plus the tail from the raising read to
    ``run_with_policy``'s return (the raise unwinding the walk and the
    ladder's bookkeeping: the error skips the fence). Both are read in this
    run, on the host's clock, around the same call."""
    if not reads or not reads[-1][2] or any(r[2] for r in reads[:-1]):
        raise AssertionError(f"path m: the walk's deadline reads {[r[1:] for r in reads[-3:]]}:"
                             " expected the last, and only it, to raise")
    gaps = np.diff([r[0] for r in reads]) * 1e3
    chunk = float(gaps.max()) if gaps.size else 0.0
    last = float(gaps[-1]) if gaps.size else 0.0
    tail = (t_return - reads[-1][0]) * 1e3
    over = oc.elapsed_ms - deadline_ms
    if gaps.size == 0 or over > chunk + tail:
        raise AssertionError(f"path m: DEADLINE after {oc.elapsed_ms:.1f} ms: {over:.2f} ms past"
                             f" {deadline_ms}, beyond the longest stretch between two reads"
                             f" ({chunk:.2f} ms over {len(reads)} reads) + the tail {tail:.3f} ms")
    log(f"  path m: AS a0=7 on the fragment_loop rung under {deadline_ms:.0f} ms: DEADLINE at"
        f" {oc.error.context.get('where')} after {oc.elapsed_ms:.1f} ms, {over:.2f} ms past it:"
        f" the last stretch between reads {last:.2f} ms (the longest of {len(reads)} reads"
        f" {chunk:.2f}), the raise to the return {tail:.3f} ms; bound {chunk + tail:.2f} ms")
    return {"reads": len(reads), "overshoot_ms": over, "longest_stretch_ms": chunk,
            "last_stretch_ms": last, "tail_ms": tail}


def drive_ladder(engines, SG, qs, defaults, rows8, draws, sizes, gates) -> tuple[dict, dict]:
    """Path m: the degradation ladder on the card. With no fault plan every
    one of ``qs`` comes back ``ok`` on ``active`` through
    ``run_with_policy`` and the B = 8 batches through
    ``run_batch_with_policy``; each rung's result (``rung_fn``) is gated
    against the defaults'; ``ops.`` poisoned lands AD on ``xla`` and the
    fused site poisoned lands AS under fusion on on ``unfused``; with every
    kernel's ``build`` failing, SD and AD end with a KERNEL error on
    ``active``; AS from a0 = 7 (1.3e12 paths) on the ``fragment_loop`` rung under
    LADDER_DEADLINE_MS returns DEADLINE within it plus the longest stretch
    between two of the walk's deadline reads and the tail from the raise to
    the return, both read in the same run (``deadline_overshoot``); an
    AdmissionController budget between SD's B = 1 and B = 64 estimates
    demotes B = 64 to serial calls equal to ``execute_batch``'s rows; each
    query's estimate at B = 1 and 8 at least the allocator's measured peak.
    Returns (the record, the launch counts of the policy runs)."""
    import torch

    from repro_torch.core.fuse import has_fused
    from repro_torch.robust import (
        LADDER,
        AdmissionController,
        MemoryBudget,
        RetryPolicy,
        RobustPolicy,
        estimate_query_bytes,
        faults,
        run_batch_with_policy,
        run_with_policy,
    )
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.robust.runner import rung_fn

    rec, ratios = {"queries": {}}, {}
    prepared = {n: engines[n].prepare(q) for n, q, _ in qs}
    reset_counts()
    for name, q, params in qs:
        oc = run_with_policy(prepared[name], params)
        if oc.status != "ok" or oc.rung != "active":
            raise AssertionError(f"path m {name}: with no plan {oc.to_dict()}, expected ok on"
                                 " active")
        compare_gated(oc.value, defaults[name], name, f"m {name} run_with_policy vs defaults",
                      ratios)
        rec["queries"][name] = {"elapsed_ms": oc.elapsed_ms}
    for name, q, _ in qs:
        outs = run_batch_with_policy(prepared[name], rows8[name])
        want = prepared[name].execute_batch(**rows8[name])
        if any(o.status != "ok" or o.rung != "active" for o in outs) or len(outs) != 8:
            raise AssertionError(f"path m {name} B=8: {[o.to_dict() for o in outs]}")
        for i, o in enumerate(outs):
            compare_gated(o.value, want[i], name, f"m {name} B=8 row {i} vs execute_batch",
                          ratios)
    counts = read_counts()
    log(f"  path m: the nine through run_with_policy and B = 8 through run_batch_with_policy:"
        f" every outcome ok on active; launches {({k: v for k, v in counts.items() if v})}")
    rung_ms = {}
    for rung in LADDER:
        for name, q, params in qs:
            args = [params[n] for n in prepared[name].param_names]
            fn = rung_fn(prepared[name], rung)
            fn(*args)
            sync()
            t0 = time.perf_counter()
            got = fn(*args).cpu().numpy()
            rung_ms[f"{rung} {name}"] = (time.perf_counter() - t0) * 1e3
            compare_gated(got, defaults[name], name, f"m {name} rung {rung} vs defaults", ratios)
    log("  path m: every rung's result against the defaults' (exact for the counts): "
        + ", ".join(f"{rung} {sum(v for k, v in rung_ms.items() if k.startswith(rung + ' ')):.1f}"
                    " ms" for rung in LADDER) + " for the nine")
    rec["rung_ms"] = rung_ms
    one_try = RobustPolicy(retry=RetryPolicy(max_attempts=1), registry=MetricsRegistry())
    # a kernel fault: every kernel rung fails, the plain versions answer
    ad = cases(SG, 0)[3]
    plan = faults.FaultPlan(seed=3).add(faults.FaultSpec(site="ops.", mode="raise"))
    with faults.active(plan):
        oc = run_with_policy(prepared["AD"], ad[2], policy=one_try)
    if oc.rung != "xla" or oc.demotions != ("active", "unfused", "scan"):
        raise AssertionError(f"path m: ops. poisoned landed on {oc.to_dict()}, expected xla")
    compare(oc.value, defaults["AD"], True, "m AD on xla vs defaults")
    rec["ops_fault"] = {**oc.to_dict(), "fires": plan.total_fires()}
    # a fused-region fault: the ladder sheds the fused kernels
    as_q, as_p = SG.QUERY_AS, {"a0": 7}
    fused = engines["AS"].prepare(as_q, fusion="on")
    if not has_fused(fused.phys):
        raise AssertionError("path m: AS under fusion on formed no region")
    plan = faults.FaultPlan(seed=4).add(faults.FaultSpec(site="ops.fragment_spmv_fused",
                                                         mode="raise"))
    with faults.active(plan):
        oc = run_with_policy(fused, as_p, policy=one_try)
    if oc.rung != "unfused" or oc.demotions != ("active",):
        raise AssertionError(f"path m: the fused site poisoned landed on {oc.to_dict()}")
    compare_gated(oc.value, engines["AS"].prepare(as_q)(**as_p), "AS",
                  "m AS unfused vs defaults (a0=7)", ratios)
    rec["fused_fault"] = {**oc.to_dict(), "fires": plan.total_fires()}
    log(f"  path m: ops. poisoned → {rec['ops_fault']['rung']} after"
        f" {rec['ops_fault']['demotions']} ({rec['ops_fault']['fires']} fires); the fused site"
        f" poisoned → {rec['fused_fault']['rung']} ({rec['fused_fault']['fires']} fires)")
    # a kernel that fails to build ends the query on its rung: no rung below
    # answers from the plain versions
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.cuda_build import KernelError

    def failed_build():
        raise KernelError("nvcc failed building the kernel (a stand-in)")

    mods = [K._dense, K._packed, K._fused, K._dense_rows, K._packed_rows, K._bitunpack,
            K._block_list, K._crc32c, K._bitmaps]
    builds = [m.build for m in mods]
    try:
        for m in mods:
            m.build = failed_build
        kernel_faults = {}
        for name in ("SD", "AD"):
            params = next(p for n, _, p in qs if n == name)
            oc = run_with_policy(prepared[name], params,
                                 policy=RobustPolicy(registry=MetricsRegistry()))
            if oc.status != "error" or oc.error.code != "KERNEL" or oc.demotions:
                raise AssertionError(f"path m: {name} with no kernel built: {oc.to_dict()},"
                                     " expected a KERNEL error on active")
            kernel_faults[name] = oc.to_dict()
    finally:
        for m, b in zip(mods, builds):
            m.build = b
    rec["kernel_fault"] = kernel_faults
    log("  path m: with every kernel's build failing, SD and AD end with a KERNEL error on"
        " active, no demotion")
    # the deadline inside the terminus' walk
    pq_as = engines["AS"].prepare(as_q)
    one_chunk = chunk_ms(pq_as, sizes)
    term = RobustPolicy(ladder=("fragment_loop",), retry=RetryPolicy(max_attempts=1),
                        registry=MetricsRegistry())
    oc, reads, t_return = deadline_reads(
        lambda: run_with_policy(pq_as, as_p, deadline_ms=LADDER_DEADLINE_MS, policy=term))
    if oc.status != "error" or oc.error.code != "DEADLINE":
        raise AssertionError(f"path m: AS a0=7 on fragment_loop: {oc.to_dict()}")
    rec["deadline"] = {**oc.to_dict(), "deadline_ms": LADDER_DEADLINE_MS,
                       "chunk_ms_alone": one_chunk,
                       **deadline_overshoot(oc, reads, t_return, LADDER_DEADLINE_MS)}
    # admission: B = 64 over budget, B = 1 within it
    sd = prepared["SD"]
    est1 = estimate_query_bytes(sd, 1)["total_bytes"]
    est64 = estimate_query_bytes(sd, 64)["total_bytes"]
    ctl = AdmissionController(MemoryBudget(limit_bytes=int((est1 + est64) / 2 / 0.9)),
                              MetricsRegistry())
    d64 = draws["SD"][64]
    outs = run_batch_with_policy(sd, d64, policy=RobustPolicy(admission=ctl,
                                                              registry=MetricsRegistry()))
    want = sd.execute_batch(**d64)
    if any(o.status != "degraded" for o in outs):
        raise AssertionError("path m: the over-budget B = 64 was not demoted to serial")
    for i, o in enumerate(outs):
        compare(o.value, want[i], True, f"m SD B=64 serial row {i} vs execute_batch")
    rec["admission"] = {"est_b1": est1, "est_b64": est64, "limit": ctl.budget.limit_bytes}
    log(f"  path m: budget {ctl.budget.limit_bytes} B between SD's estimates at B = 1"
        f" ({est1}) and 64 ({est64}): B = 64 demoted to 64 serial calls, each equal to"
        " execute_batch's row")
    # the estimate beside the allocator's peak a query, at B = 1 and B = 8:
    # the working term must bound what the run allocates
    peaks = {}
    for name, q, params in qs:
        for batch, run in ((1, lambda: prepared[name](**params)),
                           (8, lambda: prepared[name].execute_batch(**rows8[name]))):
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run()
            sync()
            est = estimate_query_bytes(prepared[name], batch)
            peaks[f"{name} B={batch}"] = {
                "estimated_working": est["working_bytes"],
                "reference_working": est["reference_working_bytes"],
                "estimated_resident": est["resident_bytes"],
                "measured_peak_over_live": torch.cuda.max_memory_allocated() - base}
    rec["estimate_vs_peak"] = peaks
    log("  path m: working bytes estimated (the reference's term) / the allocator's peak over"
        " the live bytes a query: "
        + ", ".join(f"{n} {v['estimated_working']} ({v['reference_working']})"
                    f"/{v['measured_peak_over_live']}" for n, v in peaks.items()))
    under = {n: v for n, v in peaks.items()
             if v["estimated_working"] < v["measured_peak_over_live"]}
    if under:
        raise AssertionError(f"path m: the admission estimate is under the allocator's peak: {under}")
    log_gates("path m vs the defaults", ratios, gates)
    return rec, counts


def drive_durability(dbs_by_graph, SG, c0, defaults, gates, tmp: str) -> tuple[dict, dict]:
    """Path n, at the PubMed cell (and the SemMedDB graph for CS): each DB
    snapshotted to ``tmp``/<graph> and restored on the card with every CRC
    verified, the restored manifest equal to a fresh one of the original;
    the nine queries on the restored DBs against the defaults'; a packed word
    of I_DT.Term flipped in place on the card, which changes SD's answer
    until the scrubber detects and heals the column and
    ``invalidate_prepared`` lets a new prepare read the healed tensor; a
    clean ``scrub_full`` timed. The snapshots stay for path o (the caller
    removes ``tmp``). Returns (the record, the launch counts)."""
    from repro_torch.core.engine import GQFastEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.robust import Scrubber
    from repro_torch.storage import build_manifest, restore_db, snapshot_db

    rec, ratios = {}, {}
    reset_counts()
    restored = {}
    for graph, db in dbs_by_graph.items():
        d = f"{tmp}/{graph}"
        sync()
        t0 = time.perf_counter()
        gen_path = snapshot_db(db, d)
        sync()
        t_write = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(gen_path).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        db2 = restore_db(d, device=db.device.device)
        sync()
        t_restore = time.perf_counter() - t0
        if db2.device.integrity != build_manifest(db.device):
            raise AssertionError(f"path n {graph}: restored manifest != the original's")
        restored[graph] = (db2, d)
        rec[graph] = {"write_s": t_write, "restore_s": t_restore, "bytes": size}
        log(f"  path n {graph}: snapshot {size} bytes written in {t_write:.2f} s,"
            f" restored on the card with every CRC verified in {t_restore:.2f} s")
    engines = {n: GQFastEngine(restored["semmed" if n == "CS" else "pubmed"][0])
               for n, _, _ in cases(SG, c0, True)}
    for name, q, params in cases(SG, c0, True):
        compare_gated(engines[name].query(q, **params), defaults[name], name,
                      f"n {name} restored vs the defaults", ratios)
    log("  path n: the nine on the restored DBs equal the defaults' (exact for the counts)")
    db2, d = restored["pubmed"]
    eng = engines["SD"]
    sd = cases(SG, c0)[0]
    pq = eng.prepare(sd[1])
    want = pq(**sd[2])
    reg = MetricsRegistry()
    healed = []
    scrubber = Scrubber(db2, snapshot_dir=d, registry=reg, on_heal=healed.append)
    # the lowest bit of one destination in the middle of the fragment of
    # d0's busiest term, which SD's second hop reads: a document id moves
    # by one, in place, where the prepared plan reads it
    col = db2.device.index("DT", "Term").dst_col
    host = db2.host_indexes[("DT", "Term")]
    terms = db2.host_indexes[("DT", "Doc")].fragment(sd[2]["d0"], "Term")
    t = int(max(terms, key=lambda x: int(host.indptr[x + 1] - host.indptr[x])))
    e = int(host.indptr[t] + (host.indptr[t + 1] - host.indptr[t]) // 2)
    word, bit = divmod(e * col.width, 32)
    col.words[word] ^= (1 << bit) - (1 << 32 if bit == 31 else 0)
    flipped = pq(**sd[2])
    if np.array_equal(flipped, want):
        raise AssertionError("path n: the flipped word did not change SD's answer")
    sync()
    t0 = time.perf_counter()
    stats = scrubber.scrub_full()
    t_heal = (time.perf_counter() - t0) * 1e3
    if stats["healed"] != 1 or stats["failed"] or healed != ["I_DT.Term/__dst__"]:
        raise AssertionError(f"path n: scrub after the flip {stats}, healed {healed}")
    eng.invalidate_prepared()
    compare(eng.prepare(sd[1])(**sd[2]), want, True, "n SD after the heal")
    t0 = time.perf_counter()
    clean = scrubber.scrub_full()
    t_clean = (time.perf_counter() - t0) * 1e3
    if clean["healed"] or clean["failed"]:
        raise AssertionError(f"path n: a clean scrub found {clean}")
    rec["scrub"] = {"heal_pass_ms": t_heal, "clean_pass_ms": t_clean,
                    "columns": len(scrubber._columns()), "stats": stats,
                    "counters": reg.counters_with_prefix("robust.integrity.")}
    log(f"  path n: bit {bit} of word {word} of I_DT.Term (term {t}'s edge {e}) flipped on"
        f" the card changed SD's answer; the"
        f" scrubber detected and healed it ({stats}, a pass of"
        f" {len(scrubber._columns())} columns {t_heal:.1f} ms), SD after"
        f" invalidate_prepared equals the original; a clean scrub_full {t_clean:.1f} ms")
    counts = read_counts()
    if counts["crc32c"] < 1:
        raise AssertionError(f"path n: crc32c never launched ({counts})")
    log(f"  path n: launches {({k: v for k, v in counts.items() if v})}")
    log_gates("path n restored vs the defaults", ratios, gates)
    return rec, counts


#: Path o's full-scale serve (the server's own flags, ``--device cuda`` beside
#: them): 192 requests in micro-batches of 32 from a fast start, a hot swap
#: every 4 batches, the scrub gate and ticks, one profile and the metrics.
SERVE_REQUESTS = 192
SERVE_BATCH = 32
SERVE_RELOAD_AT = 4


def ci_lanes(art: str, device) -> list[tuple[str, list[list[str]]]]:
    """The three CI lanes (``.github/workflows/ci.yml``: obs, chaos,
    corrupt-and-heal), each its server invocations with the workflow's
    arguments under ``art`` (its ``artifacts/``) and ``--device``."""
    base = ["--device", device.type, "--workload", "analytics"]
    return [
        ("obs", [base + ["--requests", "48", "--docs", "4000", "--batch", "8",
                         "--metrics-json", f"{art}/obs/serve_metrics.json",
                         "--profile-json", f"{art}/obs/query_profile.json"]]),
        ("chaos", [base + ["--requests", "64", "--docs", "4000", "--batch", "8",
                           "--chaos", "--chaos-seed", "3", "--deadline-ms", "2000",
                           "--queue-bound", "56",
                           "--metrics-json", f"{art}/obs/chaos_metrics.json"]]),
        ("heal", [base + ["--requests", "8", "--docs", "2000", "--batch", "8",
                          "--snapshot-dir", f"{art}/snapshots",
                          "--metrics-json", f"{art}/obs/heal_publish_metrics.json"],
                  base + ["--requests", "48", "--docs", "2000", "--batch", "8",
                          "--snapshot-dir", f"{art}/snapshots", "--reload-at", "2",
                          "--scrub", "--verify-responses",
                          "--chaos", "--chaos-seed", "3", "--chaos-corrupt",
                          "--deadline-ms", "4000",
                          "--metrics-json", f"{art}/obs/heal_metrics.json"]]),
    ]


def ci_assert(lane: str, art: str) -> dict:
    """The workflow's assertions on a lane's artifacts, word for word (its
    relative ``artifacts/`` paths under ``art``). Returns the counters."""
    if lane == "obs":
        m = json.load(open(f"{art}/obs/serve_metrics.json"))
        lat = m["histograms"]["serve.request_latency_ms"]
        assert lat["count"] == 48, lat["count"]
        assert "p50" in lat and "p99" in lat, sorted(lat)
        assert lat["p50"] <= lat["p99"], (lat["p50"], lat["p99"])
        assert m["gauges"]["serve.batch_occupancy"] > 0
        p = json.load(open(f"{art}/obs/query_profile.json"))
        assert p["ops"] and p["hops"] and p["total_wall_ms"] > 0
        log("  obs smoke ok: p50=%.1fms p99=%.1fms occupancy=%.1f"
            % (lat["p50"], lat["p99"], m["gauges"]["serve.batch_occupancy"]))
        return m["counters"]
    if lane == "chaos":
        m = json.load(open(f"{art}/obs/chaos_metrics.json"))
        c = m["counters"]
        # every request completed (served, typed-error, or shed) — no crash
        answered = (c.get("serve.requests_ok", 0)
                    + c.get("serve.requests_degraded", 0)
                    + c.get("serve.requests_error", 0)
                    + c.get("serve.requests_shed", 0))
        assert answered == 64, (answered, c)
        assert c.get("serve.requests_degraded", 0) > 0, c
        errs = {k: v for k, v in c.items() if k.startswith("robust.errors.")}
        assert errs and sum(errs.values()) > 0, c
        log(f"  chaos smoke ok: {({k: c[k] for k in sorted(c) if k.startswith(('serve.requests_', 'robust.'))})}")
        return c
    m = json.load(open(f"{art}/obs/heal_metrics.json"))
    c = m["counters"]
    # zero corrupted responses: every oracle-replayed answer matched
    assert c.get("serve.responses_corrupt", 0) == 0, c
    assert c.get("serve.responses_verified", 0) > 0, c
    # the scrubber detected injected corruption and healed from snapshot
    assert c.get("robust.integrity.scrub_repairs", 0) >= 1, c
    # hot swap exercised: at least one succeeded, and the corrupted
    # generation load was rejected and rolled back (old gen kept serving)
    assert c.get("serve.generation_reloads", 0) >= 1, c
    assert c.get("serve.reload_failures", 0) >= 1, c
    assert c.get("serve.fast_starts", 0) == 1, c
    # no request was dropped by a swap or heal
    answered = (c.get("serve.requests_ok", 0)
                + c.get("serve.requests_degraded", 0)
                + c.get("serve.requests_error", 0)
                + c.get("serve.requests_shed", 0))
    assert answered == 48, (answered, c)
    log(f"  corrupt-and-heal ok: {({k: c[k] for k in sorted(c) if k.startswith(('serve.', 'robust.integrity.'))})}")
    return c


def replay_batches(eng, run) -> dict:
    """The full-scale serve's batches again, each padded as served, through
    ``run_batch_with_policy`` on ``eng``: the result copy's wall a batch
    (the bucket's [B, n] float32 to the host after a synchronise), the
    batches' wall through the runner, and under torch.profiler the device
    busy ms, the device-to-host copy's ms and the idle share over them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.robust import RobustPolicy, run_batch_with_policy

    prepared = {k: eng.prepare(q) for k, q in serve.QUERIES.items()}

    policy = RobustPolicy(registry=MetricsRegistry())
    batches = [(kind, padded_params(run, ids)) for kind, ids, _ in run.batches]
    copies = {}
    for kind, arrays in batches:
        pq = prepared[kind]
        dev = pq.batched_fn(*[arrays[n] for n in pq.param_names])
        sync()
        t0 = time.perf_counter()
        dev.cpu().numpy()
        copies.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        del dev
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for kind, arrays in batches:
            run_batch_with_policy(prepared[kind], arrays, policy=policy)
        wall = (time.perf_counter() - t0) * 1e3
    busy = copy = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy += ev.self_device_time_total / 1e3
            if "Memcpy" in ev.key and "DtoH" in ev.key:
                copy += ev.self_device_time_total / 1e3
    n = len(batches)
    return {
        "copy_ms_a_batch": {k: statistics.median(v) for k, v in copies.items()},
        "copy_bytes_a_batch": {k: 4 * run.bucket * prepared[k].phys.out_dom for k in copies},
        "batches": n, "replay_wall_ms": wall, "device_busy_ms": busy or None,
        "device_copy_ms": copy or None,
        "idle_share": max(0.0, 1.0 - busy / wall) if busy else None,
    }


def padded_params(run, ids: list) -> dict:
    """A served batch's parameter arrays, padded to the bucket as the server
    pads it (the last binding repeated)."""
    ids = ids + [ids[-1]] * (run.bucket - len(ids))
    return {k: np.asarray([run.stream[i][2][k] for i in ids]) for k in run.stream[ids[0]][2]}


def drive_serving(db, pub_dir: str, tmp: str, gates: dict, card: str,
                  device) -> tuple[dict, dict]:
    """Path o, the analytics server in process on the card, on the main
    thread: the three CI lanes at their own
    arguments with the workflow's assertions; then the full-scale serve from
    a fast start on path n's PubMed snapshot (``pub_dir``), the first reload
    publishing generation 2 there so that the swap loads a new generation
    while the scrubber ticks and the serving thread launches. Every answered
    request is held against its batch run through the plain versions with
    float64 sums; the served queries/s, p50/p99 a shape, the result copy a
    batch and the idle share (a replay of the batches under the profiler)
    are logged beside the card. Returns (the record, the launch counts)."""
    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastEngine
    from repro_torch.launch import serve
    from repro_torch.storage import snapshot_db

    rec = {}
    # (a) the CI lanes
    reset_counts()
    art = f"{tmp}/artifacts"
    rec["lanes"] = {}
    for lane, invocations in ci_lanes(art, device):
        t0 = time.perf_counter()
        for argv in invocations:
            serve.main(argv)
        c = ci_assert(lane, art)
        rec["lanes"][lane] = {"seconds": time.perf_counter() - t0, "counters": c}
    lane_counts = read_counts()
    for k in ("fragment_spmm_packed", "crc32c"):
        if lane_counts[k] < 1:
            raise AssertionError(f"path o lanes: {k} never launched ({lane_counts})")
    log(f"  path o lanes: launches {({k: v for k, v in lane_counts.items() if v})}")

    # (b) the full-scale serve from path n's snapshot
    real_load = serve.load_generation
    reloads = []  # per reload on the reloader thread: publish and load seconds

    def publish_then_load(*a, **kw):
        t0 = time.perf_counter()
        if not reloads:  # the first reload: an operator publishes generation 2
            snapshot_db(db, pub_dir)
        t1 = time.perf_counter()
        out = real_load(*a, **kw)
        reloads.append({"publish_s": t1 - t0, "load_s": time.perf_counter() - t1})
        return out

    argv = ["--device", device.type, "--workload", "analytics",
            "--requests", str(SERVE_REQUESTS), "--batch", str(SERVE_BATCH),
            "--snapshot-dir", pub_dir, "--reload-at", str(SERVE_RELOAD_AT), "--scrub",
            "--profile-json", f"{tmp}/serve_profile.json",
            "--metrics-json", f"{tmp}/serve_metrics.json"]
    reset_counts()
    serve.load_generation = publish_then_load
    t0 = time.perf_counter()
    try:
        run = serve.main(argv)
    finally:
        serve.load_generation = real_load
    t_serve = time.perf_counter() - t0
    counts = read_counts()
    snap = run.registry.snapshot()
    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
    if c.get("serve.fast_starts") != 1 or c.get("serve.restore_failures"):
        raise AssertionError(f"path o: not a fast start ({c})")
    if c.get("serve.generation_reloads", 0) < 1 or c.get("serve.reload_failures", 0):
        raise AssertionError(f"path o: reloads {c}")
    if g.get("serve.serving_generation") != 2:
        raise AssertionError(f"path o: serving generation {g.get('serve.serving_generation')},"
                             " expected the published 2")
    written = json.load(open(f"{tmp}/serve_metrics.json"))
    if written["counters"] != c or not json.load(open(f"{tmp}/serve_profile.json"))["hops"]:
        raise AssertionError("path o: the metrics or the profile written differ from the run's")
    if c.get("serve.requests_unserved", 0) or c.get("serve.requests_ok") != SERVE_REQUESTS:
        raise AssertionError(f"path o: not every request answered ok ({c})")
    bad = [i for i, r in enumerate(run.results) if isinstance(r, dict) or r.status != "ok"]
    if bad:
        raise AssertionError(f"path o: requests {bad[:8]} not ok")
    if run.scrub_gate is None or run.scrub_gate["failed"] or c.get(
            "robust.integrity.scrub_failures", 0):
        raise AssertionError(f"path o: scrub gate {run.scrub_gate}, counters {c}")
    for k in ("fragment_spmm_packed", "fragment_spmm_packed_active", "block_list", "crc32c"):
        if counts[k] < 1:
            raise AssertionError(f"path o: {k} never launched ({counts})")

    # every answered request against its batch through the plain versions
    pub_eng = GQFastEngine(db)
    t0 = time.perf_counter()
    prepared = {k: pub_eng.prepare(q) for k, q in serve.QUERIES.items()}
    t_prepare = time.perf_counter() - t0
    plain = {}
    ratios, worst = {}, 0.0
    t0 = time.perf_counter()
    for kind, ids, _ in run.batches:
        if kind not in plain:
            pq = prepared[kind]
            plain[kind] = (pq.param_names, X.compile_frontier_batched(
                db.device, pq.phys, block_skipping=pq.block_skipping, use_kernel=False,
                fusion=pq.fusion))
        names, fn = plain[kind]
        arrays = padded_params(run, ids)
        with float64_sums():
            want = fn(*[arrays[n] for n in names])[:len(ids)].cpu().numpy()
        for row, i in enumerate(ids):
            worst = max(worst, compare_gated(run.results[i].value, want[row], kind,
                                             f"o {kind} request {i} vs plain batched", ratios))
    t_plain = time.perf_counter() - t0
    log_gates("path o served vs plain batched", ratios, gates)

    t0 = time.perf_counter()
    replay = replay_batches(pub_eng, run)
    t_replay = time.perf_counter() - t0
    per_shape = {k[len("serve.request_latency_ms."):]: {"p50": v["p50"], "p99": v["p99"],
                                                        "count": v["count"]}
                 for k, v in h.items() if k.startswith("serve.request_latency_ms.")}
    lat = h["serve.request_latency_ms"]
    rec["full_scale"] = {
        "argv": argv, "seconds": t_serve, "counters": c, "gauges": g,
        "latency_ms": {"p50": lat["p50"], "p99": lat["p99"], "count": lat["count"]},
        "latency_ms_by_shape": per_shape, "batches": [(k, len(i), gen) for k, i, gen in run.batches],
        "scrub_gate": run.scrub_gate, "max_abs_err_vs_plain": worst, "replay": replay,
        "reloads": reloads, "prepare_five_s": t_prepare, "plain_check_s": t_plain,
        "replay_s": t_replay,
        "launches": {k: v for k, v in counts.items() if v},
    }
    log(f"  [{card}] path o: {SERVE_REQUESTS} requests from a fast start of generation 1,"
        f" {len(run.batches)} batches of <= {SERVE_BATCH} (bucket {run.bucket}), generations"
        f" served {sorted({gen for _, _, gen in run.batches})}, reloads"
        f" {c.get('serve.generation_reloads', 0):g}, failures {c.get('serve.reload_failures', 0):g},"
        f" scrub gate {run.scrub_gate}, {t_serve:.1f} s in all; on the reloader thread "
        + ", ".join(f"publish {r['publish_s']:.2f} s + load {r['load_s']:.2f} s" for r in reloads)
        + f"; the five shapes prepared in {t_prepare:.2f} s, the plain check {t_plain:.1f} s,"
        f" the replay {t_replay:.1f} s")
    log(f"  [{card}] path o: micro-batched {g['serve.queries_per_sec']:.2f} queries/s,"
        f" sequential {g.get('serve.sequential_queries_per_sec', 0):.2f} queries/s;"
        f" latency p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms")
    for kind, v in per_shape.items():
        log(f"  [{card}] path o: {kind:4s} p50 {v['p50']:.2f} ms, p99 {v['p99']:.2f} ms"
            f" ({v['count']} batches)")
    for kind, ms in replay["copy_ms_a_batch"].items():
        log(f"  [{card}] path o: result copy {kind:4s} {ms:.2f} ms a batch for"
            f" {replay['copy_bytes_a_batch'][kind]} B")
    idle = "not measured" if replay["idle_share"] is None else f"{replay['idle_share']:.3f}"
    log(f"  [{card}] path o: the {replay['batches']} batches replayed under the profiler:"
        f" wall {replay['replay_wall_ms']:.1f} ms, device busy {replay['device_busy_ms']} ms"
        f" (device-to-host copies {replay['device_copy_ms']} ms), idle share {idle}")
    log(f"  [{card}] path o: launches {rec['full_scale']['launches']}; every answer equals its"
        f" batch through the plain versions with float64 sums (max abs err {worst:.3g})")
    total = {k: lane_counts[k] + counts[k] for k in counts}
    return rec, total


#: Path p, the distributed strategy on one card: (world, backend, label).
#: NCCL puts no two ranks on one device, so a world of 4 on the card runs
#: gloo, all-reducing CUDA tensors through the host.
P_WORLDS = ((1, "nccl", "i"), (4, "cpu:gloo,cuda:gloo", "ii"))
#: The process group's timeout in path p's ranks, and each world's limit.
P_GROUP_TIMEOUT_S = 60
P_WORLD_TIMEOUT_S = 300
#: Timed runs a query (after one to warm it), and the batch path p drives.
P_REPS = 3
P_BATCH = 8
P_PROFILED = ("SD", "AS")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def digest(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def hop_keys(phys) -> list[tuple]:
    """``(table, src_key, dom_dst)`` of every hop one execution of ``phys``
    runs (mask sub-programs included; AVG twice): each is one all_reduce of
    ``dom_dst`` values, and one hop launch where the rank's shard of the
    index has edges."""
    from repro_torch.core.lower import iter_flat_ops

    out = []
    for op in iter_flat_ops(phys):
        if type(op).__name__ == "HopOp":
            out.append((op.table, op.src_key, int(op.dom_dst)))
        for p in getattr(op, "programs", ()):
            out += hop_keys(p)
    return out * 2 if phys.agg == "avg" else out


def allreduce_ms(sizes, group, device, reps: int = P_REPS) -> dict:
    """Median wall ms of one all_reduce (SUM, float32, on ``device``) of each
    size plus the walk's flags, after one to warm it."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.executor import AGREED_KINDS

    out = {}
    for n in sorted(set(sizes)):
        buf = torch.zeros(n + len(AGREED_KINDS), device=device)
        ts = []
        for i in range(reps + 1):
            sync()
            t0 = time.perf_counter()
            dist.all_reduce(buf, group=group)
            sync()
            ts.append(time.perf_counter() - t0)
        out[n] = statistics.median(ts[1:]) * 1e3
    return out


def p_launches(label: str, what: str, counts: dict, kernel: str, want: int) -> None:
    """Path p's launch gate: ``kernel`` launched ``want`` times and no other
    hop, fused or list kernel at all (CRC-32C and bitunpack may decode)."""
    others = {k: v for k, v in counts.items()
              if v and k not in (kernel, "crc32c", "bitunpack")}
    if counts[kernel] != want or others:
        raise AssertionError(f"path p {label} {what}: {kernel} launched {counts[kernel]},"
                             f" expected {want} (the hops run); others {others}")


def distributed_rank(cfg: dict) -> dict:
    """One rank of path p: restore n's snapshots on the card with every CRC
    verified, cut this rank's shards (bitunpack launches), prepare the nine
    under a mesh and run them single, at B = P_BATCH (every row against its
    single call) and through ``profile()`` (SD, AS), each run's launches
    counted; rank 0 holds every answer to the single-card defaults (exact
    for the counts, gated) and the float sums to the plain float64 sums
    within FLOAT64_LIMIT; then the walls, each hop's all_reduce alone, the
    admission estimate against the allocator's peak, and in a world of more
    than one a 2×2 mesh's batch and a fault on rank 1 only. Returns the
    rank's record (results as digests)."""
    import torch

    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastEngine
    from repro_torch.data import synth_graph as SG
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.robust import estimate_query_bytes, faults
    from repro_torch.robust.errors import ExecutionError
    from repro_torch.storage import device_space_report, restore_db

    rank, world, label = cfg["rank"], cfg["world"], cfg["label"]
    device = torch.device(cfg["device"])
    cuda = device.type == "cuda"
    inputs = np.load(cfg["inputs"])
    qs = cases(SG, cfg["c0"], True)
    draws = {name: {k: inputs[f"draw/{name}/{k}"] for k in params} for name, _, params in qs}
    rec = {"rank": rank, "world": world, "gates": {}, "counts": {}, "digests": {}}
    totals = {k: 0 for k in KERNELS}

    def counted(what):
        c = read_counts()
        rec["counts"][what] = c
        for k, v in c.items():
            totals[k] += v
        reset_counts()
        return c

    reset_counts()
    t0 = time.perf_counter()
    dbs = {g: restore_db(cfg["dirs"][g], device=device) for g in ("pubmed", "semmed")}
    sync()
    rec["restore_s"] = time.perf_counter() - t0
    counted("restore")
    mesh = make_mesh((world,), ("data",), device_type=device.type)
    engines = {g: GQFastEngine(db, mesh=mesh) for g, db in dbs.items()}
    t0 = time.perf_counter()
    sdbs = {g: e.sharded_db() for g, e in engines.items()}
    sync()
    rec["shard_s"] = time.perf_counter() - t0
    if counted("shard")["bitunpack"] < 1:
        raise AssertionError(f"path p {label}: bitunpack never launched at shard time")
    rec["device_bytes"] = {
        "shards": sum(X.shard_bytes(s) for s in sdbs.values()),
        "full_dbs": sum(device_space_report(db.device)["total_bytes"] for db in dbs.values()),
        "allocated": torch.cuda.memory_allocated() if cuda else None,
        "peak": torch.cuda.max_memory_allocated() if cuda else None}
    on = {name: engines["semmed" if name == "CS" else "pubmed"] for name, _, _ in qs}
    prepared = {name: on[name].prepare(q) for name, q, _ in qs}
    if {pq.strategy for pq in prepared.values()} != {"distributed"}:
        raise AssertionError(f"path p {label}: a query did not run distributed")
    keys = {name: hop_keys(pq.phys) for name, pq in prepared.items()}
    # a hop launches where this rank's shard of its index has edges
    hops = {name: sum(sdbs["semmed" if name == "CS" else "pubmed"].index(t, k).src_ids.numel() > 0
                      for t, k, _ in ks) for name, ks in keys.items()}

    # the nine, single
    single = {name: prepared[name](**params) for name, _, params in qs}
    p_launches(label, "the nine", counted("single"), "fragment_spmv", sum(hops.values()))
    # the nine at B = P_BATCH: one fragment_spmm a hop a batch
    batched = {}
    for name, _, _ in qs:
        batched[name] = prepared[name].execute_batch(**draws[name])
        p_launches(label, f"{name} B={P_BATCH}", counted(f"batch {name}"), "fragment_spmm",
                   hops[name])
    rows = {name: [prepared[name](**{k: int(v[b]) for k, v in draws[name].items()})
                   for b in range(P_BATCH)] for name, _, _ in qs}
    counted("rows")
    for name, _, _ in qs:
        rec["digests"][f"single/{name}"] = digest(single[name])
        rec["digests"][f"batch/{name}"] = digest(batched[name])
        for b, row in enumerate(rows[name]):
            compare_gated(batched[name][b], row, name, f"p {label} {name} row {b} vs its single"
                          f" call", rec["gates"].setdefault("rows_vs_single", {}))
    if rank == 0:
        for name, _, _ in qs:
            compare_gated(single[name], inputs[f"defaults/{name}"], name,
                          f"p {label} {name} vs the single-card defaults",
                          rec["gates"].setdefault("vs_defaults", {}))
        truth = {name: inputs[f"truth/{name}"] for name, _, _ in float_queries(SG, cfg["c0"])}
        rec["float64_rel"] = hold_f64(f"p {label}", single, truth, "single")
    # profile() of SD and AS: every rank profiles together (prefix-delta)
    rec["profiles"] = {}
    for name in P_PROFILED:
        params = dict(qs[[n for n, _, _ in qs].index(name)][2])
        prof = prepared[name].profile(reps=3, **params)
        if prof.timing_method != "prefix-delta" or any(o.wall_ms is None for o in prof.ops):
            raise AssertionError(f"path p {label} profile {name}: {prof.timing_method}")
        compare_gated(prof.result, single[name], name, f"p {label} {name} profile vs __call__",
                      rec["gates"].setdefault("profile", {}))
        rec["profiles"][name] = {"total_wall_ms": prof.total_wall_ms,
                                 "ops": {o.name: o.wall_ms for o in prof.ops}}
    counted("profile")
    # walls, and each hop's all_reduce alone
    walls, reduce_ms = {}, {}
    group = sdbs["pubmed"].spec.group
    for name, _, params in qs:
        ts = []
        for i in range(P_REPS + 1):
            t0 = time.perf_counter()
            prepared[name](**params)
            ts.append(time.perf_counter() - t0)
        walls[name] = statistics.median(ts[1:]) * 1e3
    one = allreduce_ms([n for ks in keys.values() for _, _, n in ks], group, device)
    for name in walls:
        reduce_ms[name] = sum(one[n] for _, _, n in keys[name])
    rec["walls_ms"], rec["allreduce_ms"] = walls, reduce_ms
    rec["allreduce_share"] = {n: reduce_ms[n] / walls[n] for n in walls}
    counted("timing")
    # the admission estimate at B = 1 and P_BATCH against the allocator's peak
    rec["admission"] = {}
    for name, _, params in (qs if cuda else ()):
        pq = prepared[name]
        for B, run_ in ((1, lambda: pq(**params)),
                        (P_BATCH, lambda: pq.execute_batch(**draws[name]))):
            sync()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run_()
            sync()
            peak = torch.cuda.max_memory_allocated() - base
            est = estimate_query_bytes(pq, B)["working_bytes"]
            rec["admission"][f"{name} B={B}"] = est / max(peak, 1)
            if est < peak:
                raise AssertionError(f"path p {label} {name} B={B}: estimate {est} below the"
                                     f" allocator's peak {peak}")
    counted("admission")
    if world > 1:
        # a 2×2 mesh, both axes sharded: one batched query
        mesh22 = make_mesh((2, 2), ("data", "model"), device_type=device.type)
        e22 = GQFastEngine(dbs["pubmed"], mesh=mesh22, shard_axes=("data", "model"))
        pq = e22.prepare(SG.QUERY_AS)
        out22 = pq.execute_batch(**draws["AS"])
        p_launches(label, "2x2 AS", counted("2x2"), "fragment_spmm", hops["AS"])
        compare_gated(out22, batched["AS"], "AS", f"p {label} 2x2 AS vs the 1-D mesh",
                      rec["gates"].setdefault("2x2", {}))
        rec["digests"]["2x2/AS"] = digest(out22)
        # a fault on rank 1 only: every rank raises, within the group timeout
        name, _, params = qs[0]
        spec = faults.FaultSpec("ops.fragment_spmv", max_fires=1)
        t0 = time.perf_counter()
        with faults.active(faults.FaultPlan(0, [spec] if rank == 1 else [])):
            try:
                prepared[name](**params)
                rec["fault"] = "answered"
            except ExecutionError as e:
                rec["fault"] = f"{type(e).__name__}:{e.code}"
        rec["fault_s"] = time.perf_counter() - t0
        compare(prepared[name](**params), single[name], True, f"p {label} {name} after the fault")
        counted("fault")
    rec["launches"] = totals
    return rec


def distributed_child(cfg: dict) -> int:
    """``chip_smoke.py --path-p-child CONFIG``: one rank of path p, its
    record written to ``cfg["out"]``."""
    import datetime

    import torch
    import torch.distributed as dist

    if cfg["device"] == "cuda":
        torch.cuda.set_device(0)
    # the world's ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // cfg["world"]))
    dist.init_process_group(cfg["backend"], init_method=f"tcp://localhost:{cfg['port']}",
                            rank=cfg["rank"], world_size=cfg["world"],
                            timeout=datetime.timedelta(seconds=P_GROUP_TIMEOUT_S))
    try:
        rec = distributed_rank(cfg)
    finally:
        dist.destroy_process_group()
    Path(cfg["out"]).write_text(json.dumps(rec))
    return 0


def run_world(world: int, backend: str, label: str, cfg: dict, tmp: str) -> list[dict]:
    """Start ``world`` ranks of path p on the card, wait for all (killing
    every rank when one fails or the world outlives P_WORLD_TIMEOUT_S),
    relay their logs and return their records."""
    port = free_port()
    procs, outs = [], []
    for r in range(world):
        out = f"{tmp}/p_{label}_rank{r}.json"
        c = {**cfg, "rank": r, "world": world, "backend": backend, "label": label,
             "port": port, "out": out}
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--path-p-child", json.dumps(c)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    deadline = time.perf_counter() + P_WORLD_TIMEOUT_S
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=max(deadline - time.perf_counter(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if r == 0 or p.returncode != 0:
            for line in text.splitlines()[-60 if p.returncode else -40:]:
                log(f"    [{label} rank {r}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"path p {label}: rank {r} exited with {p.returncode}")
    return [json.loads(Path(o).read_text()) for o in outs]


def drive_distributed(engines, SG, c0, defaults, truth, draws, dirs: dict, tmp: str,
                      gates: dict, card: str, device) -> tuple[dict, dict]:
    """Path p: the distributed strategy, (i) a world of 1 on NCCL and (ii) a
    world of 4 on the one card over gloo, each rank a process of its own
    (:func:`distributed_rank`) restoring path n's snapshots; every rank's
    answers equal rank 0's bit for bit, the launches counted in each rank;
    the walls beside the single-card defaults' (timed here), the
    all_reduce's share of a query's wall and each rank's device bytes,
    logged beside the card. Returns (the record, the launch counts summed
    over every rank)."""
    t_path = time.perf_counter()
    qs = cases(SG, c0, True)
    arrays = {f"defaults/{n}": defaults[n] for n, _, _ in qs}
    arrays.update({f"truth/{n}": v for n, v in truth.items()})
    arrays.update({f"draw/{n}/{k}": v for n, _, _ in qs for k, v in draws[n][P_BATCH].items()})
    np.savez(f"{tmp}/p_inputs.npz", **arrays)
    single_card = {}
    for name, q, params in qs:
        ts = []
        for i in range(P_REPS + 1):
            t0 = time.perf_counter()
            engines[name].query(q, **params)
            ts.append(time.perf_counter() - t0)
        single_card[name] = statistics.median(ts[1:]) * 1e3
    cfg = {"inputs": f"{tmp}/p_inputs.npz", "c0": c0, "dirs": dirs, "device": device.type}
    rec = {"single_card_walls_ms": single_card, "worlds": {}}
    counts = {k: 0 for k in KERNELS}
    for world, backend, label in P_WORLDS:
        t0 = time.perf_counter()
        ranks = run_world(world, backend, label, cfg, tmp)
        seconds = time.perf_counter() - t0
        for r in ranks[1:]:
            if r["digests"] != ranks[0]["digests"]:
                bad = [k for k in r["digests"] if r["digests"][k] != ranks[0]["digests"][k]]
                raise AssertionError(f"path p {label}: rank {r['rank']} differs from rank 0"
                                     f" in {bad}")
        if world > 1 and {r["fault"] for r in ranks} != {"ExecutionError:EXECUTION"}:
            raise AssertionError(f"path p {label}: a fault on rank 1 ended the ranks with"
                                 f" {[r['fault'] for r in ranks]}")
        for r in ranks:
            for k, v in r["launches"].items():
                counts[k] += v
        r0 = ranks[0]
        for what, ratios in r0["gates"].items():
            log_gates(f"path p {label} {what}", ratios, gates)
        rec["worlds"][label] = {"backend": backend, "world": world, "seconds": seconds,
                                "ranks": ranks}
        log(f"  [{card}] path p {label} ({backend}, a world of {world}): {seconds:.1f} s;"
            f" every rank's answers equal rank 0's bit for bit; restore"
            f" {r0['restore_s']:.2f} s, shard {r0['shard_s']:.2f} s")
        log(f"  [{card}] path p {label}: median wall ms a query (distributed / single-card"
            " defaults): " + ", ".join(f"{n} {r0['walls_ms'][n]:.3f} / {single_card[n]:.3f}"
                                       for n in single_card))
        log(f"  [{card}] path p {label}: the all_reduce's share of a query's wall: "
            + ", ".join(f"{n} {v:.3f}" for n, v in r0["allreduce_share"].items()))
        log(f"  [{card}] path p {label}: device bytes a rank (shards / full DBs / allocated /"
            " peak): " + "; ".join(
                f"rank {r['rank']} {r['device_bytes']['shards']} / {r['device_bytes']['full_dbs']}"
                f" / {r['device_bytes']['allocated']} / {r['device_bytes']['peak']}"
                for r in ranks))
        adm = r0["admission"].values()
        log(f"  path p {label}: launches over every rank"
            f" {({k: v for k, v in counts.items() if v})} (so far); the admission estimate"
            f" over the allocator's peak at B = 1 and {P_BATCH} "
            + (f"{min(adm):.3f}–{max(adm):.3f}" if adm else "not measured")
            + (f"; the fault on rank 1 ended every rank in"
               f" {max(r['fault_s'] for r in ranks):.2f} s" if world > 1 else ""))
    rec["seconds"] = time.perf_counter() - t_path
    log(f"  [{card}] path p: {rec['seconds']:.1f} s")
    for k in ("fragment_spmv", "fragment_spmm", "bitunpack"):
        if counts[k] < 1:
            raise AssertionError(f"path p: {k} never launched ({counts})")
    return rec, counts


def time_manifest(engines, SG, c0) -> dict:
    """Median wall ms of SD and AS with an integrity manifest attached (every
    materialize() verified) against without, MANIFEST_REPS runs in turns, on
    auto and dense storage, with the CRC launches a call under each; the
    manifest is built once a DB and detached at the end."""
    from repro_torch.kernels import crc32c as ck
    from repro_torch.storage import attach_manifest, build_manifest, detach_manifest

    out = {}
    for storage in ("auto", "dense"):
        qs = [c for c in cases(SG, c0) if c[0] in MANIFEST_QUERIES]
        dev_db = engines[storage]["SD"].db.device
        t0 = time.perf_counter()
        man = build_manifest(dev_db)
        sync()
        t_build = time.perf_counter() - t0
        for name, q, params in qs:
            pq = engines[storage][name].prepare(q)
            ts = {"with": [], "without": []}
            crcs = {"with": 0, "without": 0}
            for i in range(MANIFEST_REPS):
                for mode in (("with", "without") if i % 2 == 0 else ("without", "with")):
                    if mode == "with":
                        attach_manifest(dev_db, man)
                    else:
                        detach_manifest(dev_db)
                    before = ck.LAUNCHES
                    t0 = time.perf_counter()
                    pq(**params)
                    ts[mode].append((time.perf_counter() - t0) * 1e3)
                    crcs[mode] += ck.LAUNCHES - before
            detach_manifest(dev_db)
            row = {m: statistics.median(v) for m, v in ts.items()}
            out[f"{storage} {name}"] = {**row, "ratio": row["with"] / row["without"],
                                        "crc_launches_a_call": crcs["with"] / MANIFEST_REPS}
            log(f"  manifest {storage:5s} {name}: median ms with {row['with']:.4f}, without"
                f" {row['without']:.4f} ({row['with'] / row['without']:.3f}x); crc32c launches"
                f" a call with {crcs['with'] / MANIFEST_REPS:g}, without"
                f" {crcs['without'] / MANIFEST_REPS:g}")
        out[f"{storage} build_manifest_s"] = t_build
        log(f"  build_manifest of the {storage} PubMed store: {t_build:.2f} s")
    return out


# ---------------------------------------------------------------------------
# Path q: the transformer family (no kernel of KERNELS runs on it)
# ---------------------------------------------------------------------------

#: q1: the reference LM server's shape (``launch/serve.py --workload lm``)
LM_PROMPT = (4, 32)
LM_CACHE = 128
LM_DECODE_STEPS = 60
#: q1's check of the decode logits at positions 32-35 against ``forward``
#: over the same 36 tokens, as a share of the largest logit: bf16 compute
#: keeps 8 bits, and 36 layers round it at other points in the two paths'
#: other GEMM shapes
LM_BF16_TOL = 5e-2
#: q2, float32 compute, card against CPU: the logits and the loss within
#: LM_F32_TOL of the largest value; each gradient leaf within LM_GRAD_TOL of
#: its largest value (sums of up to 11,008 products in another order, and the
#: backward's second level of them)
LM_F32_TOL = 1e-4
LM_GRAD_TOL = 1e-3
LM_Q2_TOKENS = (2, 64)
OLMOE_Q2_TOKENS = (2, 512)
#: q3: full-width Qwen2.5-3B cut to LM_TRAIN_LAYERS layers (depth only)
LM_TRAIN_LAYERS = 2
LM_TRAIN_STEPS = 8
LM_TRAIN_BATCH = (2, 512)
LM_PREEMPT_AT = 4
#: q3's int8-moment run converges like the float32 one
#: (tests/test_checkpoint_train.py's 5%)
LM_INT8_REL = 0.05
Q3_TIMEOUT_S = 600
Q4_TIMEOUT_S = 300
BF16_FLOP_PER_S = 989e12


def rel_err(got, want) -> float:
    """max|got − want| / max|want| (float32 on the CPU)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def drive_lm_serve(card: str, device) -> dict:
    """q1: Qwen2.5-3B at full width (f32 params, bf16 compute) from a seeded
    generator on the card; the reference server's prefill of 4×32 tokens
    into a 128-slot cache and 60 greedy decode steps; the decode logits at
    positions 32-35 against ``forward`` over the same 36 tokens."""
    import torch

    from repro_torch.configs.lm_archs import QWEN25_3B
    from repro_torch.models import transformer as T
    from repro_torch.models.common import count_params

    cfg = QWEN25_3B.full
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0))
    sync()
    t_init = time.perf_counter() - t0
    n = count_params(params)
    toks = torch.randint(0, cfg.vocab, LM_PROMPT, device=device,
                         generator=torch.Generator(device).manual_seed(1))
    prefill_ms = []
    for _ in range(2):  # the first call beside a warm one
        sync()
        t0 = time.perf_counter()
        logits, cache, pos = T.prefill(params, toks, cfg, LM_CACHE)
        sync()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    first = logits.clone()
    cur = torch.argmax(logits, -1)
    out, kept = [cur], []
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for i in range(LM_DECODE_STEPS):
        logits, cache = T.decode_step(params, cache, cur, pos + i, cfg)
        finite &= torch.isfinite(logits).all()
        if i < 4:
            kept.append(logits.clone())
        cur = torch.argmax(logits, -1)
        out.append(cur)
    sync()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not bool(finite):
        raise AssertionError("path q1: a logit is not finite")
    full = torch.cat([toks, torch.stack(out[:4], 1).to(toks.dtype)], 1)
    with torch.no_grad():
        fl, _ = T.forward(params, full, cfg)
    errs = [rel_err(first, fl[:, pos - 1])] + [rel_err(k, fl[:, pos + i])
                                               for i, k in enumerate(kept)]
    agree = float(sum((torch.argmax(k, -1) == torch.argmax(fl[:, pos + i], -1)).float().mean()
                      for i, k in enumerate(kept)) / len(kept))
    if max(errs) > LM_BF16_TOL:
        raise AssertionError(f"path q1: prefill/decode logits against forward {errs} over"
                             f" {LM_BF16_TOL}")
    kv = cache["k"]
    mean_len = pos + (LM_DECODE_STEPS + 1) / 2
    kv_bytes = 2 * cfg.n_layers * kv.shape[1] * mean_len * kv.shape[3] * kv.shape[4] \
        * kv.element_size()
    bound = (4 * n + kv_bytes) / HBM_BYTES_PER_S * 1e3
    cast_bound = (8 * n + kv_bytes) / HBM_BYTES_PER_S * 1e3
    ms = dt / LM_DECODE_STEPS * 1e3
    rec = {"params": n, "param_count_formula": cfg.param_count(), "init_s": t_init,
           "prefill_ms": prefill_ms, "decode_ms_a_step": ms,
           "tokens_per_s": LM_PROMPT[0] * LM_DECODE_STEPS / dt,
           "bound_ms": bound, "bound_with_cast_ms": cast_bound,
           "peak_allocated_bytes": peak, "rel_err_vs_forward": errs,
           "greedy_agreement": agree, "tolerance": LM_BF16_TOL,
           "tokens": torch.stack(out).cpu().numpy()[:, 0].tolist()}
    log(f"  [{card}] q1 Qwen2.5-3B full width ({n} params, {gib(4 * n)} f32, init"
        f" {t_init:.2f} s): prefill 4×32 {prefill_ms[0]:.1f} ms first, {prefill_ms[1]:.1f} ms"
        f" warm; decode {ms:.3f} ms a step ({rec['tokens_per_s']:.1f} tokens/s, batch 4) against"
        f" a bound of {bound:.3f} ms (f32 weights read once; {cast_bound:.3f} ms with the bf16"
        f" cast written and read); peak allocated {peak} B ({gib(peak)})")
    log(f"  q1: prefill and decode logits at positions 31-35 against forward: "
        + ", ".join(f"{e:.4g}" for e in errs) + f" of the largest logit (tolerance"
        f" {LM_BF16_TOL}); greedy picks equal {agree:.3f}; all logits finite")
    return rec


def drive_lm_card_vs_cpu(card: str, device) -> dict:
    """q2: full-width Qwen2.5-3B and OLMoE-1B-7B, each cut to 2 layers,
    under float32 compute, on the card against the same weights on the CPU:
    Qwen's logits, loss and every gradient leaf; OLMoE's routing (topi,
    keep), each layer's router on the CPU fed the card's input to it."""
    import torch

    from repro_torch.configs.lm_archs import OLMOE_1B_7B, QWEN25_3B
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_leaves_with_path, tree_map

    rec = {}
    cfg = dataclasses.replace(QWEN25_3B.full, n_layers=2, compute_dtype=torch.float32)
    card_p = T.init_params(cfg, torch.Generator(device).manual_seed(2))
    cpu_p = tree_map(lambda t: t.cpu(), card_p)
    batch = lm_batch(0, *LM_Q2_TOKENS, cfg.vocab, seed=0, device="cpu")
    cbatch = {k: v.to(device) for k, v in batch.items()}
    t0 = time.perf_counter()
    (lg, _), gg = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg), card_p, cbatch)
    sync()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    (lc, _), gc = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg), cpu_p, batch)
    t_cpu = time.perf_counter() - t0
    with torch.no_grad():
        logit_err = rel_err(T.forward(card_p, cbatch["tokens"], cfg)[0],
                            T.forward(cpu_p, batch["tokens"], cfg)[0])
    loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
    grad_errs = {k: rel_err(g, c) for (k, g), (_, c) in
                 zip(tree_leaves_with_path(gg), tree_leaves_with_path(gc))}
    worst = max(grad_errs.items(), key=lambda kv: kv[1])
    if logit_err > LM_F32_TOL or loss_err > LM_F32_TOL or worst[1] > LM_GRAD_TOL:
        raise AssertionError(f"path q2: Qwen2.5-3B card against CPU: logits {logit_err},"
                             f" loss {loss_err}, worst gradient {worst}")
    rec["qwen"] = {"logits_rel": logit_err, "loss_rel": loss_err, "grad_rel": grad_errs,
                   "card_s": t_card, "cpu_s": t_cpu, "loss": float(lg)}
    log(f"  [{card}] q2 Qwen2.5-3B full width, 2 layers, f32 compute, {LM_Q2_TOKENS}"
        f" tokens: logits {logit_err:.3g}, loss {loss_err:.3g} (tolerance {LM_F32_TOL}),"
        f" {len(grad_errs)} gradient leaves worst {worst[0]} {worst[1]:.3g} (tolerance"
        f" {LM_GRAD_TOL}); value and gradients {t_card:.2f} s on the card, {t_cpu:.2f} s"
        " on the CPU")
    del card_p, cpu_p, gg, gc

    cfg = dataclasses.replace(OLMOE_1B_7B.full, n_layers=2, compute_dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator(device).manual_seed(3))
    toks = lm_batch(0, *OLMOE_Q2_TOKENS, cfg.vocab, seed=1, device=device)["tokens"]
    routing = []
    with torch.no_grad():
        logits, aux = T.forward(params, toks, cfg, routing=routing)
    if len(routing) != cfg.n_layers or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"path q2: OLMoE forward: {len(routing)} routed layers, finite"
                             f" {bool(torch.isfinite(logits).all())}")
    layers = []
    for i, r in enumerate(routing):
        want = T.moe_route({"router": params["layers"]["router"][i].cpu()}, r["x"].cpu(), cfg)
        topi_eq = torch.equal(r["topi"].cpu(), want["topi"])
        keep_eq = torch.equal(r["keep"].cpu(), want["keep"])
        layers.append({"topi_equal": topi_eq, "keep_equal": keep_eq, "C": want["C"],
                       "dropped": int((~want["keep"]).sum()),
                       "entries": int(want["keep"].numel())})
        if not (topi_eq and keep_eq):
            diff = int((r["topi"].cpu() != want["topi"]).sum())
            raise AssertionError(f"path q2: OLMoE layer {i} routing differs from the CPU's"
                                 f" ({diff} topi entries, keep equal {keep_eq})")
    rec["olmoe"] = {"layers": layers, "aux": float(aux)}
    log(f"  [{card}] q2 OLMoE-1B-7B full width, 2 layers, f32 compute, {OLMOE_Q2_TOKENS}"
        f" tokens: every layer's routing (topi, keep) equal to the CPU's, integer for"
        f" integer; capacity {layers[0]['C']}, dropped entries a layer"
        f" {[lay['dropped'] for lay in layers]} of {layers[0]['entries']}; aux {float(aux):.4f}")
    del params, routing
    return rec


def lm_train_child(cfg: dict) -> int:
    """``chip_smoke.py --path-q3-child CONFIG``: q3 in a process whose CUDA
    starts under ``torch.use_deterministic_algorithms(True)`` (the parent
    sets ``CUBLAS_WORKSPACE_CONFIG``); its record written to ``cfg["out"]``."""
    import torch

    torch.use_deterministic_algorithms(True)
    from repro_torch.configs.lm_archs import QWEN25_3B
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.common import count_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train
    from repro_torch.tree import tree_leaves

    t_child = time.perf_counter()
    device = torch.device(cfg["device"])
    model = dataclasses.replace(QWEN25_3B.full, n_layers=LM_TRAIN_LAYERS)
    params = T.init_params(model, torch.Generator(device).manual_seed(4))
    n = count_params(params)

    def data(step):
        return lm_batch(step, *LM_TRAIN_BATCH, model.vocab, seed=0, device=device)

    def lf(p, b):
        return T.loss_fn(p, b, model)

    def run(label, opt, **kw):
        loop = TrainLoopConfig(total_steps=LM_TRAIN_STEPS, ckpt_every=100,
                               ckpt_dir=os.path.join(cfg["tmp"], label))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, res = train(params, lf, data, loop, opt, **kw)
        sync()
        wall = time.perf_counter() - t0
        return p, res, {"wall_s": wall, "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                        "steps_s": sum(h["step_time"] for h in res.history),
                        "losses": [h["loss"] for h in res.history]}

    rec = {"params": n, "layers": model.n_layers}
    pA, rA, rec["uninterrupted"] = run("a", AdamWConfig(lr=1e-3), resume=False)
    _, r1, rec["preempted"] = run("b", AdamWConfig(lr=1e-3), resume=False,
                                  preempt_at=LM_PREEMPT_AT)
    pB, r2, rec["resumed"] = run("b", AdamWConfig(lr=1e-3), resume=True)
    rec["preempted"]["step"], rec["resumed"]["resumed_from"] = r1.step, r2.resumed_from
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(tree_leaves(pA), tree_leaves(pB))]
    rec["resume_equal"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(pA), tree_leaves(pB)))
    rec["resume_max_abs_diff"] = max(diffs)
    del pA, pB
    _, rC, rec["int8"] = run("c", AdamWConfig(lr=1e-3, quantize_moments=True), resume=False)
    rec["child_s"] = time.perf_counter() - t_child
    Path(cfg["out"]).write_text(json.dumps(rec))
    return 0


def time_lm_train(card: str, device) -> dict:
    """q3's times, on the quiet card in this process: the train step
    (``train.loop.make_train_step``: autograd, then AdamW lr 1e-3) of
    Qwen2.5-3B at full width cut to LM_TRAIN_LAYERS layers, LM_TRAIN_STEPS
    steps of ``lm_batch`` at LM_TRAIN_BATCH; the median step after the first
    beside 6·N·tokens at 989 TFLOP/s bf16, the peak allocated bytes. The
    loss falls (q3's gates proper run in the child, ``LMBackground``)."""
    import torch

    from repro_torch.configs.lm_archs import QWEN25_3B
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.common import count_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.loop import make_train_step

    model = dataclasses.replace(QWEN25_3B.full, n_layers=LM_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(model, torch.Generator(device).manual_seed(4))
    n = count_params(params)
    opt = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt)
    step = make_train_step(lambda p, b: T.loss_fn(p, b, model), opt)
    times, losses = [], []
    for s in range(LM_TRAIN_STEPS):
        batch = lm_batch(s, *LM_TRAIN_BATCH, model.vocab, seed=0, device=device)
        sync()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))  # waits for the device
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"path q3: the loss did not fall: {losses}")
    tokens = LM_TRAIN_BATCH[0] * LM_TRAIN_BATCH[1]
    rec = {"params": n, "layers": model.n_layers, "losses": losses,
           "step_ms": statistics.median(times[1:]) * 1e3, "step_ms_first": times[0] * 1e3,
           "bound_ms": 6 * n * tokens / BF16_FLOP_PER_S * 1e3, "peak_allocated_bytes": peak}
    rec["tokens_per_s"] = tokens / (rec["step_ms"] / 1e3)
    log(f"  [{card}] q3 Qwen2.5-3B full width cut to {model.n_layers} layers ({n} params),"
        f" {LM_TRAIN_BATCH} tokens a step, AdamW lr 1e-3: loss {losses[0]:.4f} →"
        f" {losses[-1]:.4f} in {LM_TRAIN_STEPS} steps; step {rec['step_ms']:.2f} ms median"
        f" (first {rec['step_ms_first']:.1f}), {rec['tokens_per_s']:.0f} tokens/s, against a"
        f" bound of {rec['bound_ms']:.3f} ms (6·N·tokens at 989 TFLOP/s bf16); peak allocated"
        f" {peak} B ({gib(peak)})")
    return rec


class Background:
    """Work started before phase 3 and run beside its checks (which time
    nothing): one child of this script and chains of entry points, each a
    ``python`` subprocess on the card, the chains in a thread pool.
    :meth:`stop` ends whatever still runs and removes the temporary
    directory (registered with atexit, so a failed run leaves no process
    behind)."""

    def __init__(self, prefix: str, flag: str, cfg: dict, chains: list, workers: int,
                 env: dict | None = None):
        import atexit
        from concurrent.futures import ThreadPoolExecutor

        self.tmp = tempfile.mkdtemp(prefix=prefix)
        self.procs, self.stopped = [], False
        self.child_out = os.path.join(self.tmp, "child.json")
        self.child_log = open(os.path.join(self.tmp, "child.log"), "w")
        atexit.register(self.stop)
        self.child = self._popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag,
             json.dumps({**cfg, "tmp": self.tmp, "out": self.child_out})],
            env={**os.environ, **(env or {})}, stdout=self.child_log, stderr=subprocess.STDOUT)
        self.pool = ThreadPoolExecutor(workers)
        self.chains = [self.pool.submit(self._chain, [[a.format(tmp=self.tmp) for a in argv]
                                                      for argv in c]) for c in chains]

    def _popen(self, argv, **kw):
        p = subprocess.Popen(argv, cwd=ROOT, **kw)
        self.procs.append(p)
        return p

    def _chain(self, argvs) -> list:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        outs = []
        for argv in argvs:
            if self.stopped:
                break
            t0 = time.perf_counter()
            p = self._popen([sys.executable, *argv], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
            out, err = p.communicate(timeout=Q4_TIMEOUT_S)
            outs.append((" ".join(argv), p.returncode, out, err, time.perf_counter() - t0))
        return outs

    def stop(self) -> None:
        self.stopped = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.pool.shutdown(wait=True)
        self.child_log.close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def finish(self, label: str, timeout: float) -> tuple[dict, dict]:
        """(the child's record, the chains' record); raises, naming
        ``label``, when the child or an entry point exits with an error."""
        self.child.wait(timeout=timeout)
        if self.child.returncode != 0:
            self.child_log.flush()
            for line in Path(self.child_log.name).read_text().splitlines()[-60:]:
                log(f"    [{label} child] {line}")
            raise AssertionError(f"path {label}: the child exited with {self.child.returncode}")
        child = json.loads(Path(self.child_out).read_text())
        runs = {"runs": []}
        for what, rc, out, err, secs in (r for c in self.chains for r in c.result()):
            runs["runs"].append({"argv": what, "rc": rc, "stdout": out, "seconds": secs})
            if rc != 0:
                raise AssertionError(f"path {label}: {what} exited with {rc}: {err[-2000:]}")
            log(f"  {label} {what} ({secs:.1f} s): " + " | ".join(out.strip().splitlines()[-3:]))
        runs["chains_s"] = [sum(r[4] for r in c.result()) for c in self.chains]
        self.stop()
        return child, runs


def device_flag(device) -> list[str]:
    """The entry points' ``--device`` argument for ``device`` (none for the
    default, cuda)."""
    return [] if device.type == "cuda" else ["--device", device.type]


def train_chains(archs, ckpt: str, device, first: int, then: int) -> list:
    """A chain an arch: ``launch.train --steps first``, then ``--steps then
    --resume`` from its checkpoint."""
    chains = []
    for aid in archs:
        base = ["-m", "repro_torch.launch.train", "--arch", aid, "--ckpt-dir", ckpt,
                *device_flag(device)]
        chains.append([base + ["--steps", str(first)],
                       base + ["--steps", str(then), "--resume"]])
    return chains


def check_train_lines(label: str, lines: list[str], first: int, then: int) -> None:
    """Each chain's two lines: ``first`` steps, then ``then - first`` steps
    resumed from ``first``."""
    for a, b in zip(lines[::2], lines[1::2]):
        if f": {first} steps, loss" not in a or f"{then - first} steps" not in b \
                or f"(resumed from {first})" not in b:
            raise AssertionError(f"path {label}: train printed {a!r}, then {b!r}")


class LMBackground(Background):
    """Path q's work that needs no quiet card: q3's gates in a child process
    whose CUDA starts under deterministic algorithms (:func:`lm_train_child`)
    and q4's entry points as subprocesses on the card, three chains at once.
    :meth:`finish` waits for them and holds them to their gates."""

    def __init__(self, device):
        chains = [[["-m", "repro_torch.launch.serve", "--workload", "lm", "--requests", "20",
                    *device_flag(device)]]]
        chains += train_chains(("llama3-8b", "olmoe-1b-7b"), "{tmp}/q4", device, 12, 16)
        super().__init__("lm_path_q_", "--path-q3-child", {"device": device.type}, chains,
                         len(chains), env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})

    def finish(self, card: str) -> tuple[dict, dict]:
        """(q3's record, q4's record), each held to its gates."""
        q3, q4 = super().finish("q", Q3_TIMEOUT_S)
        check_lm_train(card, q3)
        lines = [r["stdout"] for r in q4["runs"]]
        if not lines[0].startswith("[serve/lm] 20 decode steps × batch 4: "):
            raise AssertionError(f"path q4: serve printed {lines[0]!r}")
        check_train_lines("q4", lines[1:], 12, 16)
        return q3, q4


def check_lm_train(card: str, rec: dict) -> None:
    """q3's gates on the child's record: the loss falls; the run preempted at
    LM_PREEMPT_AT and resumed equals the uninterrupted one bit for bit; int8
    moments end within LM_INT8_REL of float32."""
    A, B, P, C = (rec[k] for k in ("uninterrupted", "resumed", "preempted", "int8"))
    if not A["losses"][-1] < A["losses"][0]:
        raise AssertionError(f"path q3: the loss did not fall: {A['losses']}")
    if P["step"] != LM_PREEMPT_AT or B["resumed_from"] != LM_PREEMPT_AT:
        raise AssertionError(f"path q3: preempted at {P['step']}, resumed from"
                             f" {B['resumed_from']}")
    if not rec["resume_equal"] or P["losses"] + B["losses"] != A["losses"]:
        raise AssertionError(f"path q3: the resumed run differs from the uninterrupted one"
                             f" (max |Δ| {rec['resume_max_abs_diff']}; losses {A['losses']}"
                             f" against {P['losses'] + B['losses']})")
    rec["int8_rel"] = abs(C["losses"][-1] - A["losses"][-1]) / A["losses"][-1]
    if rec["int8_rel"] >= LM_INT8_REL:
        raise AssertionError(f"path q3: int8 moments end at {C['losses'][-1]} against"
                             f" {A['losses'][-1]} ({rec['int8_rel']:.4f})")
    log(f"  [{card}] q3 train() with checkpoints (the child, deterministic CUDA): loss"
        f" {A['losses'][0]:.4f} → {A['losses'][-1]:.4f}; preempted at step {P['step']} and"
        f" resumed: equal to the uninterrupted run bit for bit (params and losses); int8"
        f" moments end at {C['losses'][-1]:.4f} ({rec['int8_rel']:.4f} from float32); walls"
        f" (s, steps / whole run with its checkpoints, beside phase 3): uninterrupted"
        f" {A['steps_s']:.2f} / {A['wall_s']:.2f}, preempted {P['steps_s']:.2f} /"
        f" {P['wall_s']:.2f}, resumed {B['steps_s']:.2f} / {B['wall_s']:.2f}, int8"
        f" {C['steps_s']:.2f} / {C['wall_s']:.2f}")


def drive_lm(card: str, device, background: LMBackground | None = None) -> tuple[dict, dict]:
    """Path q: the transformer family. q1, q2 and q3's times here, on the
    quiet card; q3's gates and q4's entry points from ``background`` (started
    before phase 3; started here, after the rest, when None); every LM arch's
    ``smoke``. Returns (the record, the launch counts of KERNELS over the
    in-process part)."""
    import torch

    from repro_torch.configs.registry import ARCHS

    t_path = time.perf_counter()
    reset_counts()
    rec = {"q1_serve": drive_lm_serve(card, device)}
    torch.cuda.empty_cache()
    rec["q2_card_vs_cpu"] = drive_lm_card_vs_cpu(card, device)
    torch.cuda.empty_cache()
    rec["q3_train_times"] = time_lm_train(card, device)
    torch.cuda.empty_cache()
    smoke = {}
    for aid, arch in ARCHS.items():
        if arch.kind != "lm":
            continue
        smoke[aid] = arch.smoke(device=device.type)
        if not smoke[aid]["finite"] or smoke[aid]["logits_shape"] != (2, arch.smoke_cfg.vocab):
            raise AssertionError(f"path q4: {aid} smoke {smoke[aid]}")
    log(f"  q4: every LM arch's smoke(device={device.type!r}) finite with (2, vocab) logits: "
        + ", ".join(f"{a} loss {o['loss']:.3f}" for a, o in smoke.items()))
    counts = read_counts()
    rec["q3_train"], rec["q4_entry_points"] = (background or LMBackground(device)).finish(card)
    rec["q4_entry_points"]["smoke"] = smoke
    rec["seconds"] = time.perf_counter() - t_path
    log(f"  [{card}] path q: {rec['seconds']:.1f} s here; beside phase 3 q3's child"
        f" {rec['q3_train']['child_s']:.1f} s and q4's chains"
        f" {', '.join(f'{t:.1f}' for t in rec['q4_entry_points']['chains_s'])} s; launches of"
        f" the GQ-Fast kernels {({k: v for k, v in counts.items() if v}) or 'none'} (the"
        " transformer family reaches none)")
    return rec, counts


# ---------------------------------------------------------------------------
# Path r: the GNN family and DIN (no kernel of KERNELS runs on it)
# ---------------------------------------------------------------------------

#: r1: DIN at the reference's full config, the traffic of DIN_SHAPES
DIN_SERVE_REPS = 20
DIN_BULK_REPS = 3
DIN_RETRIEVAL_REPS = 2
DIN_RETRIEVAL_CHECKED = 4096
DIN_TRAIN_STEPS = 8
DIN_TRAIN_BATCHES = 3
#: tests/test_recsys.py:32's property: a retrieval score equals din_forward's
#: on that candidate, relative to the largest score
DIN_RETRIEVAL_TOL = 1e-4
#: r1's card against the CPU on the same weights: logits and loss within
#: DIN_OUT_TOL of the largest value, every gradient leaf within DIN_GRAD_TOL
DIN_CPU_BATCH = 512
DIN_OUT_TOL = 1e-5
DIN_GRAD_TOL = 1e-4
#: r2: the molecule shape (GNN_SHAPES["molecule"]: 3,840 nodes, 8,192 edges)
GNN_MOLECULE = (128, 30, 64)
#: tests/test_models_gnn.py:100 (rotation, relative to the largest energy) and
#: :111 (translation, numpy's allclose)
GNN_ROT_TOL = 2e-2
GNN_TRANS_RTOL, GNN_TRANS_ATOL = 1e-3, 1e-4
#: r2's card against the CPU: energies within GNN_OUT_TOL of the largest,
#: each gradient leaf within GNN_GRAD_TOL of its largest value
GNN_OUT_TOL = 1e-4
GNN_GRAD_TOL = 1e-3
GNN_STEPS = 3
#: EquiformerV2's depth on the CPU side of r2's comparison (the card runs
#: the same 2 layers for it; its other checks run all 12)
EQV2_CPU_LAYERS = 2
#: r3: Reddit's nodes, feature width and classes (minibatch_lg); its
#: 114,615,892 edges cut 10× for the host build in the smoke's limit (the
#: sampled batch's shape does not depend on the cut)
REDDIT = dict(n_nodes=232_965, n_edges=11_461_589, d_feat=602, n_classes=41)
MINIBATCH_FANOUTS = [15, 10]
MINIBATCH_NODES = 1024
MACE_LG_STEPS = 4
#: Path s: the dry run's cells (mesh, arch, shape) and the child's limit.
S_CELLS = (("local_1x1", "din", "serve_bulk"), ("local_1x1", "din", "train_batch"),
           ("local_1x1", "din", "retrieval_cand"), ("local_1x1", "mace", "minibatch_lg"),
           ("pod_16x16", "gqfast-pubmed", "as_b8"), ("pod_16x16", "llama3-8b", "train_4k"))
S_TIMEOUT_S = 900
#: r4: the entry points beside phase 3, and the child's preempted runs
R_ARCHS = ("mace", "egnn", "equiformer-v2", "schnet", "din")
R_WORKERS = 3
R_CHILD_STEPS = 8
R_PREEMPT_AT = 4
R_CHILD_TIMEOUT_S = 600


def din_row_bytes(cfg) -> int:
    """The bytes one example reads: T + 2 embedding rows (history, candidate,
    user), their int32 ids and the float32 history mask."""
    return (cfg.seq_len + 2) * (cfg.embed_dim * 4 + 4) + cfg.seq_len * 4


def leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's max|got − want| over its largest |want|; a leaf that is 0
    in ``want`` (a table no id of the batch reads) must be 0 in ``got``."""
    out = {}
    for k, w in want.items():
        scale = float(w.abs().max())
        g = got[k].detach().float().cpu()
        out[k] = rel_err(g, w) if scale else float(g.abs().max())
    return out


def drive_din(card: str, device) -> dict:
    """r1: DIN at the reference's full config (embed 18, seq 100, attention
    80-40, MLP 200-80; 11.1M table rows from a seeded generator on the card)
    under DIN_SHAPES' traffic: serve_p99 and serve_bulk (ms a batch,
    examples/s, peak bytes beside the bound), retrieval_cand (ms,
    candidates/s; DIN_RETRIEVAL_CHECKED scores against ``din_forward``),
    train_batch (DIN_TRAIN_STEPS AdamW steps over DIN_TRAIN_BATCHES batches;
    the loss on the first batch falls); masked history invariance; the card
    against the CPU on the same weights."""
    import torch

    from repro_torch.configs.din_arch import DIN, DIN_SHAPES
    from repro_torch.data.recsys import make_din_batch
    from repro_torch.models import din as D
    from repro_torch.models.common import count_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import make_train_step, value_and_grad
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = DIN.full
    T = cfg.seq_len
    kw = dict(seq_len=T, n_items=cfg.n_items, n_users=cfg.n_users)
    act = cfg.active_param_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = D.din_init(cfg, torch.Generator(device).manual_seed(0))
    sync()
    rec = {"params": count_params(params), "param_count_formula": cfg.param_count(),
           "active_params": act, "init_s": time.perf_counter() - t0}
    w_bytes = 4 * (count_params(params["attn"]) + count_params(params["mlp"]))

    def peak_of(fn, reps: int) -> tuple[float, object, int, int]:
        """(ms a call by CUDA events, a call's result, the peak allocated
        bytes over those calls, the live bytes before them)."""
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = time_device_ms(fn, reps)
        out = fn()
        return ms, out, torch.cuda.max_memory_allocated(), base

    for shape, reps in (("serve_p99", DIN_SERVE_REPS), ("serve_bulk", DIN_BULK_REPS)):
        B = DIN_SHAPES[shape]["batch"]
        b = make_din_batch(B, **kw, seed=1, device=device)
        with torch.no_grad():
            ms, out, peak, base = peak_of(lambda: D.din_forward(params, b, cfg), reps)
        if out.shape != (B,) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"path r1 {shape}: logits {tuple(out.shape)}, finite"
                                 f" {bool(torch.isfinite(out).all())}")
        bound, by = bound_ms(B * (din_row_bytes(cfg) + 4) + w_bytes, 2 * act * B)
        rec[shape] = {"batch": B, "ms": ms, "examples_per_s": B / ms * 1e3, "bound_ms": bound,
                      "bound_by": by, "peak_allocated_bytes": peak,
                      "peak_over_live_bytes": peak - base}
        log(f"  [{card}] r1 DIN {shape} B = {B}: {ms:.3f} ms a batch"
            f" ({rec[shape]['examples_per_s']:.0f} examples/s) against a bound of {bound:.4f} ms"
            f" ({by}); peak allocated {peak} B ({gib(peak)}), {gib(peak - base)} over the"
            " live bytes")
        del b, out
    b512 = make_din_batch(DIN_CPU_BATCH, **kw, seed=1, device=device)

    N = DIN_SHAPES["retrieval_cand"]["candidates"]
    rb = make_din_batch(1, **kw, n_candidates=N, seed=2, device=device)
    with torch.no_grad():
        ms, scores, peak, base = peak_of(lambda: D.din_retrieval_scores(params, rb, cfg),
                                         DIN_RETRIEVAL_REPS)
        k = DIN_RETRIEVAL_CHECKED
        idx = torch.from_numpy(np.random.default_rng(0).choice(N, k, replace=False)).to(device)
        fwd = D.din_forward(params, {"user": rb["user"].repeat(k),
                                     "hist_items": rb["hist_items"].repeat(k, 1),
                                     "hist_mask": rb["hist_mask"].repeat(k, 1),
                                     "cand_item": rb["cand_items"][idx]}, cfg)
    err = float((scores[idx] - fwd).abs().max() / scores.abs().max())
    if scores.shape != (N,) or not bool(torch.isfinite(scores).all()) \
            or err > DIN_RETRIEVAL_TOL:
        raise AssertionError(f"path r1 retrieval: {tuple(scores.shape)} scores, finite"
                             f" {bool(torch.isfinite(scores).all())}, against din_forward {err}")
    row = cfg.embed_dim * 4
    bound, by = bound_ms(N * (row + 8) + din_row_bytes(cfg) + w_bytes, 2 * act * N)
    rec["retrieval_cand"] = {"candidates": N, "chunk": D.RETRIEVAL_CHUNK, "ms": ms,
                             "candidates_per_s": N / ms * 1e3, "bound_ms": bound,
                             "bound_by": by, "peak_allocated_bytes": peak,
                             "peak_over_live_bytes": peak - base, "rel_err_vs_forward": err,
                             "checked": k}
    log(f"  [{card}] r1 DIN retrieval_cand, {N} candidates in chunks of {D.RETRIEVAL_CHUNK}:"
        f" {ms:.2f} ms ({N / ms * 1e3:.4g} candidates/s) against a bound of {bound:.3f} ms ({by});"
        f" peak allocated {peak} B, {gib(peak - base)} over the live bytes; {k} scores against"
        f" din_forward {err:.3g} of the largest (tolerance {DIN_RETRIEVAL_TOL})")
    del rb, scores, fwd

    B = DIN_SHAPES["train_batch"]["batch"]
    batches = [make_din_batch(B, **kw, seed=10 + s, device=device)
               for s in range(DIN_TRAIN_BATCHES)]
    step = make_train_step(lambda p, bb: D.din_loss(p, bb, cfg), DIN.opt)
    p, state = params, adamw_init(params, DIN.opt)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for s in range(DIN_TRAIN_STEPS):
        sync()
        t0 = time.perf_counter()
        p, state, m = step(p, state, batches[s % DIN_TRAIN_BATCHES])
        losses.append(float(m["loss"]))  # waits for the device
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    firsts = losses[::DIN_TRAIN_BATCHES]  # the first batch at each visit
    if not all(np.isfinite(losses)) or not firsts[-1] < firsts[0]:
        raise AssertionError(f"path r1 train: the loss on the first batch did not fall: {losses}")
    n = rec["params"]
    # the step reads the batch's rows, writes their gradients, and AdamW reads
    # p, g, m, v and writes p, m, v over every leaf
    bound, by = bound_ms(B * (din_row_bytes(cfg) + 8 + (T + 2) * row) + 7 * 4 * n,
                         6 * act * B)
    rec["train_batch"] = {"batch": B, "losses": losses, "step_ms": statistics.median(times[1:])
                          * 1e3, "step_ms_first": times[0] * 1e3, "bound_ms": bound,
                          "bound_by": by, "peak_allocated_bytes": peak,
                          "peak_over_live_bytes": peak - base}
    rec["train_batch"]["examples_per_s"] = B / rec["train_batch"]["step_ms"] * 1e3
    log(f"  [{card}] r1 DIN train_batch B = {B}, AdamW lr 1e-3, {DIN_TRAIN_STEPS} steps over"
        f" {DIN_TRAIN_BATCHES} batches: step {rec['train_batch']['step_ms']:.2f} ms median (first"
        f" {times[0] * 1e3:.1f}; {rec['train_batch']['examples_per_s']:.0f} examples/s) against a"
        f" bound of {bound:.3f} ms ({by}: 6·active·B, the rows and AdamW's passes over"
        f" {n} params); the first batch's loss {' → '.join(f'{x:.5f}' for x in firsts)};"
        f" peak allocated {peak} B ({gib(peak)})")
    del batches, p, state

    # masked history positions do not move a logit (tests/test_recsys.py:48)
    hist = b512["hist_items"].clone()
    masked = b512["hist_mask"] == 0
    hist[masked] = torch.randint(0, cfg.n_items, (int(masked.sum()),), device=device,
                                 generator=torch.Generator(device).manual_seed(3),
                                 dtype=hist.dtype)
    with torch.no_grad():
        s1 = D.din_forward(params, b512, cfg)
        s2 = D.din_forward(params, dict(b512, hist_items=hist), cfg)
    if not torch.allclose(s1, s2, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"path r1: masked history moved a logit by"
                             f" {float((s1 - s2).abs().max())}")

    # the card against the CPU on the same weights
    cpu_p = tree_map(lambda t: t.cpu(), params)
    cb = {kk: v.cpu() for kk, v in b512.items()}
    with torch.no_grad():
        logit_err = rel_err(D.din_forward(params, b512, cfg), D.din_forward(cpu_p, cb, cfg))
    t0 = time.perf_counter()
    (lg, _), gg = value_and_grad(lambda q, bb: D.din_loss(q, bb, cfg), params, b512)
    sync()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    (lc, _), gc = value_and_grad(lambda q, bb: D.din_loss(q, bb, cfg), cpu_p, cb)
    t_cpu = time.perf_counter() - t0
    loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
    grads = leaf_errors(dict(tree_leaves_with_path(gg)), dict(tree_leaves_with_path(gc)))
    worst = max(grads.items(), key=lambda kv: kv[1])
    if logit_err > DIN_OUT_TOL or loss_err > DIN_OUT_TOL or worst[1] > DIN_GRAD_TOL:
        raise AssertionError(f"path r1: DIN card against CPU: logits {logit_err}, loss"
                             f" {loss_err}, worst gradient {worst}")
    rec["card_vs_cpu"] = {"batch": DIN_CPU_BATCH, "logits_rel": logit_err, "loss_rel": loss_err,
                          "grad_rel": grads, "card_s": t_card, "cpu_s": t_cpu}
    log(f"  [{card}] r1 DIN card against CPU, B = {DIN_CPU_BATCH}: logits {logit_err:.3g}, loss"
        f" {loss_err:.3g} (tolerance {DIN_OUT_TOL}), {len(grads)} gradient leaves worst"
        f" {worst[0]} {worst[1]:.3g} (tolerance {DIN_GRAD_TOL}); masked history moves no logit")
    return rec


def step_flops(fn) -> int:
    """The GEMM operations of one train step: 3× the forward's (its backward
    multiplies by the transposes of both operands), the forward's counted by
    ``FlopCounterMode`` under ``no_grad``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn()
    return 3 * fc.get_total_flops()


def gnn_train_steps(label: str, cfg, params, batches: list, n_graphs: int, opt, card: str,
                    device) -> dict:
    """``len(batches)`` train steps (autograd, then AdamW): ms a step, peak
    bytes, losses finite; the bound from the step's GEMM operations and its
    bytes (the batch once, AdamW's passes over every leaf)."""
    import torch

    from repro_torch.models.common import count_params
    from repro_torch.models.gnn.models import gnn_apply, gnn_loss
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import make_train_step

    n = count_params(params)
    flops = step_flops(lambda: gnn_apply(params, batches[0], cfg, n_graphs))
    nbytes = sum(int(v.numel() * v.element_size()) for v in batches[0].values()) + 7 * 4 * n
    step = make_train_step(lambda p, b: gnn_loss(p, b, cfg, n_graphs), opt)
    state = adamw_init(params, opt)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for b in batches:
        sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"path {label}: a loss is not finite: {losses}")
    bound, by = bound_ms(nbytes, flops)
    rec = {"params": n, "losses": losses, "step_ms": statistics.median(times[1:]) * 1e3,
           "step_ms_first": times[0] * 1e3, "step_flops": flops, "bound_ms": bound,
           "bound_by": by, "peak_allocated_bytes": peak, "peak_over_live_bytes": peak - base}
    log(f"  [{card}] {label} {cfg.name} ({n} params): a train step {rec['step_ms']:.2f} ms"
        f" median of {len(times) - 1} (first {times[0] * 1e3:.1f}) against a bound of"
        f" {bound:.4f} ms ({by}: {flops:.4g} GEMM operations); peak allocated {peak} B"
        f" ({gib(peak)}), {gib(peak - base)} over the live bytes; losses "
        + ", ".join(f"{x:.4g}" for x in losses))
    return rec


def rand_rotation(seed: int) -> np.ndarray:
    """A proper rotation from a seeded QR (tests/test_models_gnn.py's)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q.astype(np.float32)


def drive_gnn_molecule(card: str, device) -> dict:
    """r2: MACE, EGNN, EquiformerV2 and SchNet at their full configs on the
    molecule shape: energies finite, rotation and translation invariance,
    the card against the CPU on the same weights (EquiformerV2 at
    EQV2_CPU_LAYERS layers on both), GNN_STEPS train steps."""
    import torch

    from repro_torch.configs.gnn_family import EGNN, EQUIFORMER_V2, GNN_SHAPES, MACE, SCHNET
    from repro_torch.data.graphs import make_molecule_batch
    from repro_torch.models.gnn.models import gnn_apply, gnn_init, gnn_loss
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_leaves_with_path, tree_map

    sh = GNN_SHAPES["molecule"]
    mol = make_molecule_batch(*GNN_MOLECULE, device="cpu")
    cb, b = mol.as_inputs(), mol.to(device).as_inputs()
    G = sh["graphs"]
    if (b["pos"].shape[0], b["edge_src"].shape[0], mol.n_graphs) != (sh["n"], sh["e"], G):
        raise AssertionError(f"path r2: the molecule batch {b['pos'].shape}, {b['edge_src'].shape}")
    R = torch.from_numpy(rand_rotation(7)).to(device)
    shift = torch.tensor([1.5, -2.0, 0.7], device=device)
    rec = {}
    for seed, arch in enumerate((MACE, EGNN, EQUIFORMER_V2, SCHNET)):
        cfg = arch.cfg_for("molecule")
        params = gnn_init(cfg, torch.Generator(device).manual_seed(10 + seed))
        with torch.no_grad():
            e = gnn_apply(params, b, cfg, G)
            e_rot = gnn_apply(params, dict(b, pos=b["pos"] @ R.T), cfg, G)
            e_tr = gnn_apply(params, dict(b, pos=b["pos"] + shift), cfg, G)
        if e.shape != (G,) or not bool(torch.isfinite(e).all()):
            raise AssertionError(f"path r2 {arch.arch_id}: energies {tuple(e.shape)}, finite"
                                 f" {bool(torch.isfinite(e).all())}")
        rot = float((e - e_rot).abs().max()) / (float(e.abs().max()) + 1e-9)
        tr_ok = bool(((e - e_tr).abs() <= GNN_TRANS_ATOL + GNN_TRANS_RTOL * e_tr.abs()).all())
        if rot >= GNN_ROT_TOL or not tr_ok:
            raise AssertionError(f"path r2 {arch.arch_id}: rotation {rot} (tolerance"
                                 f" {GNN_ROT_TOL}), translation within rtol/atol {tr_ok}")
        # the card against the CPU on the same weights
        ccfg, cp = cfg, params
        if arch is EQUIFORMER_V2:
            ccfg = dataclasses.replace(cfg, n_layers=EQV2_CPU_LAYERS)
            cp = {"backbone": {**params["backbone"],
                               "blocks": params["backbone"]["blocks"][:EQV2_CPU_LAYERS]},
                  "head": params["head"]}
        cpu_p = tree_map(lambda t: t.cpu(), cp)
        with torch.no_grad():
            out_err = rel_err(gnn_apply(cp, b, ccfg, G), gnn_apply(cpu_p, cb, ccfg, G))
        t0 = time.perf_counter()
        (lg, _), gg = value_and_grad(lambda p, x: gnn_loss(p, x, ccfg, G), cp, b)
        (lc, _), gc = value_and_grad(lambda p, x: gnn_loss(p, x, ccfg, G), cpu_p, cb)
        t_cmp = time.perf_counter() - t0
        loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
        want = dict(tree_leaves_with_path(gc))
        # EquiformerV2's attention output bias: a gradient of 0 in exact
        # arithmetic (the per-destination softmax cancels a head's shift)
        zero = [k for k in want if k.endswith("/attn/[1]/b")]
        grads = leaf_errors(dict(tree_leaves_with_path(gg)),
                            {k: v for k, v in want.items() if k not in zero})
        scale = max(float(v.abs().max()) for v in want.values())
        zero_rel = max([float(dict(tree_leaves_with_path(gg))[k].abs().max()) / scale
                        for k in zero] or [0.0])
        worst = max(grads.items(), key=lambda kv: kv[1])
        if out_err > GNN_OUT_TOL or loss_err > GNN_OUT_TOL or worst[1] > GNN_GRAD_TOL \
                or zero_rel > GNN_OUT_TOL:
            raise AssertionError(f"path r2 {arch.arch_id}: card against CPU: energies {out_err},"
                                 f" loss {loss_err}, worst gradient {worst}, the attention"
                                 f" bias {zero_rel}")
        r = {"layers_vs_cpu": ccfg.n_layers, "energies_rel": out_err, "loss_rel": loss_err,
             "grad_rel": grads, "zero_grad_rel": zero_rel, "compare_s": t_cmp,
             "rotation_rel": rot}
        del cp, cpu_p, gg, gc
        log(f"  [{card}] r2 {arch.arch_id} ({cfg.name}): energies finite; rotation {rot:.3g}"
            f" (tolerance {GNN_ROT_TOL}), translation within rtol {GNN_TRANS_RTOL} atol"
            f" {GNN_TRANS_ATOL}; card against CPU at {ccfg.n_layers} layers: energies"
            f" {out_err:.3g}, loss {loss_err:.3g} (tolerance {GNN_OUT_TOL}), {len(grads)}"
            f" gradient leaves worst {worst[0]} {worst[1]:.3g} (tolerance {GNN_GRAD_TOL})"
            f" ({t_cmp:.1f} s)")
        r.update(gnn_train_steps("r2", cfg, params, [b] * GNN_STEPS, G, arch.opt, card, device))
        rec[arch.arch_id] = r
        del params
        torch.cuda.empty_cache()
    return rec


def drive_mace_minibatch(card: str, device) -> dict:
    """r3: MACE at full width on minibatch_lg: a Reddit-sized random CSR
    graph (REDDIT, edges cut), NeighborSampler batches of MINIBATCH_NODES
    seeds at fanouts 15-10, MACE_LG_STEPS train steps."""
    import torch

    from repro_torch.configs.gnn_family import GNN_SHAPES, MACE
    from repro_torch.data.graphs import CSRGraph, NeighborSampler
    from repro_torch.models.gnn.models import gnn_init

    t0 = time.perf_counter()
    g = CSRGraph.random(REDDIT["n_nodes"], REDDIT["n_edges"], REDDIT["d_feat"],
                        REDDIT["n_classes"], seed=0)
    t_graph = time.perf_counter() - t0
    sampler = NeighborSampler(g, MINIBATCH_FANOUTS, MINIBATCH_NODES, seed=0, device=device)
    t0 = time.perf_counter()
    batches = [sampler.sample().as_inputs() for _ in range(MACE_LG_STEPS)]
    t_sample = (time.perf_counter() - t0) / MACE_LG_STEPS
    del g
    sh = GNN_SHAPES["minibatch_lg"]
    for bb in batches:
        if bb["edge_src"].shape[0] != sh["e"] or bb["pos"].shape[0] > sh["n"]:
            raise AssertionError(f"path r3: a batch of {bb['pos'].shape[0]} nodes and"
                                 f" {bb['edge_src'].shape[0]} edges against {sh}")
    cfg = MACE.cfg_for("minibatch_lg")
    params = gnn_init(cfg, torch.Generator(device).manual_seed(20))
    nodes = [int(bb["pos"].shape[0]) for bb in batches]
    log(f"  r3: a random CSR graph of {REDDIT['n_nodes']} nodes, {REDDIT['n_edges']} edges and"
        f" {REDDIT['d_feat']} features in {t_graph:.1f} s on the host; batches of {nodes} nodes"
        f" and {sh['e']} edges ({t_sample:.2f} s a batch)")
    rec = {"graph_s": t_graph, "sample_s": t_sample, "nodes": nodes, "edges": sh["e"]}
    rec.update(gnn_train_steps("r3", cfg, params, batches, 1, MACE.opt, card, device))
    return rec


def r_train_child(cfg: dict) -> int:
    """``chip_smoke.py --path-r4-child CONFIG``: under deterministic CUDA
    (the parent sets ``CUBLAS_WORKSPACE_CONFIG``), DIN's and MACE's smoke
    configs through ``train()``: R_CHILD_STEPS steps uninterrupted, then
    preempted at R_PREEMPT_AT and resumed; and every new arch's
    ``smoke(device=...)``. The record goes to ``cfg["out"]``."""
    import torch

    torch.use_deterministic_algorithms(True)
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.graphs import make_molecule_batch
    from repro_torch.data.recsys import make_din_batch
    from repro_torch.models.din import din_init, din_loss
    from repro_torch.models.gnn.models import gnn_init, gnn_loss
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train
    from repro_torch.tree import tree_leaves

    t_child = time.perf_counter()
    device = torch.device(cfg["device"])
    rec = {"smoke": {aid: get_arch(aid).smoke(device=device.type) for aid in R_ARCHS}}
    for aid in ("din", "mace"):
        mc = get_arch(aid).smoke_cfg
        gen = torch.Generator(device).manual_seed(0)
        if aid == "mace":
            p0, lf = gnn_init(mc, gen), (lambda p, b, mc=mc: gnn_loss(p, b, mc, 8))
            batches = [make_molecule_batch(8, 10, 24, seed=s, device=device).as_inputs()
                       for s in range(4)]

            def data(s, batches=batches):
                return batches[s % 4]
        else:
            p0, lf = din_init(mc, gen), (lambda p, b, mc=mc: din_loss(p, b, mc))

            def data(s, mc=mc):
                return make_din_batch(64, seq_len=mc.seq_len, n_items=mc.n_items,
                                      n_users=mc.n_users, seed=s % 8, device=device)

        def run(label, **kw):
            loop = TrainLoopConfig(total_steps=R_CHILD_STEPS, ckpt_every=100,
                                   ckpt_dir=os.path.join(cfg["tmp"], f"{aid}_{label}"))
            return train(p0, lf, data, loop, AdamWConfig(lr=1e-3), **kw)

        pA, rA = run("a", resume=False)
        _, r1 = run("b", resume=False, preempt_at=R_PREEMPT_AT)
        pB, r2 = run("b", resume=True)
        rec[aid] = {"losses": [h["loss"] for h in rA.history],
                    "preempted": [h["loss"] for h in r1.history],
                    "resumed": [h["loss"] for h in r2.history],
                    "preempted_at": r1.step, "resumed_from": r2.resumed_from,
                    "params_equal": all(torch.equal(a, b) for a, b in
                                        zip(tree_leaves(pA), tree_leaves(pB)))}
    rec["child_s"] = time.perf_counter() - t_child
    Path(cfg["out"]).write_text(json.dumps(rec))
    return 0


class RBackground(Background):
    """Path r's entry points beside phase 3 (r4): ``launch.train --arch A
    --steps 12``, then ``--steps 16 --resume``, for each of R_ARCHS, and both
    examples at their default scale, R_WORKERS chains at a time; the child
    :func:`r_train_child` under deterministic CUDA."""

    def __init__(self, device):
        chains = train_chains(R_ARCHS, "{tmp}/r4", device, 12, 16)
        chains.append([[str(ROOT / "examples" / e), *device_flag(device),
                        "--ckpt-dir", "{tmp}/" + e]
                       for e in ("torch_gnn_molecules.py", "torch_recsys_din.py")])
        super().__init__("gnn_din_path_r_", "--path-r4-child", {"device": device.type}, chains,
                         R_WORKERS, env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})

    def finish(self, card: str) -> tuple[dict, dict]:
        """(the child's record, the entry points' record), each held to its
        gates."""
        child, runs = super().finish("r4", R_CHILD_TIMEOUT_S)
        lines = [r["stdout"].strip() for r in runs["runs"]]
        check_train_lines("r4", [ln for ln in lines if ln.startswith("[train]")], 12, 16)
        gnn_out, din_out = lines[-2].splitlines(), lines[-1].splitlines()
        if not gnn_out[-1].startswith("final ") or \
                not din_out[-1].startswith("retrieval: scored 100k candidates in "):
            raise AssertionError(f"path r4: the examples ended {gnn_out[-1]!r}, {din_out[-1]!r}")
        bad = {a: o for a, o in child["smoke"].items() if not o["finite"]}
        if bad:
            raise AssertionError(f"path r4: smoke not finite: {bad}")
        for aid in ("din", "mace"):
            r = child[aid]
            if r["preempted_at"] != R_PREEMPT_AT or r["resumed_from"] != R_PREEMPT_AT \
                    or not r["params_equal"] or r["preempted"] + r["resumed"] != r["losses"]:
                raise AssertionError(f"path r4: {aid} preempted at {r['preempted_at']} and"
                                     f" resumed differs from the uninterrupted run: {r}")
        log(f"  [{card}] r4 the child (deterministic CUDA, {child['child_s']:.1f} s): DIN and"
            f" MACE preempted at step {R_PREEMPT_AT} and resumed equal the uninterrupted"
            " runs bit for bit (params and losses); every new arch's smoke finite: "
            + ", ".join(f"{a} loss {o['loss']:.3f}" for a, o in child["smoke"].items()))
        return child, runs


def drive_gnn_din(card: str, device, background: RBackground | None = None) -> tuple[dict, dict]:
    """Path r: the GNN family and DIN. r1, r2 and r3 here, on the quiet
    card; r4's entry points and child from ``background`` (started before
    phase 3; started here, after the rest, when None). Returns (the record,
    the launch counts of KERNELS over the in-process part), which must all
    be 0: path r reaches no GQ-Fast kernel."""
    import torch

    t_path = time.perf_counter()
    reset_counts()
    rec = {"r1_din": drive_din(card, device)}
    torch.cuda.empty_cache()
    rec["r2_molecule"] = drive_gnn_molecule(card, device)
    torch.cuda.empty_cache()
    rec["r3_minibatch_lg"] = drive_mace_minibatch(card, device)
    torch.cuda.empty_cache()
    counts = read_counts()
    rec["seconds_in_process"] = time.perf_counter() - t_path
    rec["r4_child"], rec["r4_entry_points"] = (background or RBackground(device)).finish(card)
    rec["seconds"] = time.perf_counter() - t_path
    if any(counts.values()):
        raise AssertionError(f"path r launched GQ-Fast kernels: {counts}")
    log(f"  [{card}] path r: {rec['seconds_in_process']:.1f} s in process; beside phase 3 the"
        f" child {rec['r4_child']['child_s']:.1f} s and the chains"
        f" {', '.join(f'{t:.1f}' for t in rec['r4_entry_points']['chains_s'])} s; launches of"
        " the GQ-Fast kernels: none (the GNN family and DIN reach none)")
    return rec, counts


class DryRunBackground:
    """Path s's child: ``python -m repro_torch.launch.dryrun --cells`` over
    S_CELLS, with CUDA hidden (the dry run computes nothing on a device),
    beside phase 3. :meth:`finish` waits for it and returns its records."""

    def __init__(self):
        import atexit

        self.tmp = tempfile.mkdtemp(prefix="dryrun_path_s_")
        self.log_path = os.path.join(self.tmp, "child.log")
        self.log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", self.tmp, "--cells",
             *(":".join(c) for c in S_CELLS)], cwd=ROOT, stdout=self.log,
            stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""})
        atexit.register(self.stop)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def finish(self) -> tuple[list[dict], float]:
        """(the records, the child's seconds); raises when the child fails or
        a record is not ``ok``."""
        from repro_torch.roofline.analysis import load_records

        self.proc.wait(timeout=S_TIMEOUT_S)
        secs = time.perf_counter() - self.t0
        self.log.flush()
        lines = Path(self.log_path).read_text().splitlines()
        recs = load_records(self.tmp)
        bad = [r for r in recs if r["status"] != "ok"]
        if self.proc.returncode != 0 or bad or len(recs) != len(S_CELLS):
            for line in lines[-40:]:
                log(f"    [s child] {line}")
            raise AssertionError(f"path s: the dry run exited with {self.proc.returncode},"
                                 f" {len(recs)} records, not ok: "
                                 + "; ".join(f"{r['arch']}/{r['shape']}: {r.get('error')}"
                                             for r in bad))
        self.stop()
        return recs, secs


def drive_dryrun(card: str, gnn_din: dict, background: DryRunBackground) -> dict:
    """Path s: the dry run's records held to path r's walls. Each 1×1
    record's roofline bound must not exceed the wall path r measured for the
    same cell; measured over bound and the record's flops beside path r's
    count are logged, and the pod records' roofline rows printed."""
    from repro_torch.configs.din_arch import DIN, DIN_SHAPES
    from repro_torch.roofline.analysis import (
        HBM_BW,
        LINK_BW,
        PEAK_FLOPS,
        roofline_from_record,
    )

    recs, secs = background.finish()
    by = {(r["mesh"], r["arch"], r["shape"]): r for r in recs}
    r1, r3 = gnn_din["r1_din"], gnn_din["r3_minibatch_lg"]
    act = DIN.full.active_param_count()
    # cell → (path r's wall in ms, path r's operation count, what it counts)
    walls = {
        ("din", "serve_bulk"): (r1["serve_bulk"]["ms"],
                                2 * act * DIN_SHAPES["serve_bulk"]["batch"], "2·active·B"),
        ("din", "train_batch"): (r1["train_batch"]["step_ms"],
                                 6 * act * DIN_SHAPES["train_batch"]["batch"], "6·active·B"),
        ("din", "retrieval_cand"): (r1["retrieval_cand"]["ms"],
                                    2 * act * DIN_SHAPES["retrieval_cand"]["candidates"],
                                    "2·active·N"),
        ("mace", "minibatch_lg"): (r3["step_ms"], r3["step_flops"],
                                   "3× the forward's GEMMs, FlopCounterMode"),
    }
    out = {"child_s": secs, "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                                          "link_bw": LINK_BW}, "cells": {}}
    log(f"  [{card}] s the dry run's child: {len(recs)} records ok in {secs:.1f} s (beside"
        " phase 3)")
    for (aid, sid), (wall, count, what) in walls.items():
        rec = by[("local_1x1", aid, sid)]
        rl = roofline_from_record(rec)
        bound_ms = rl.bound_s * 1e3
        row = {"measured_ms": wall, "bound_ms": bound_ms, "dominant": rl.dominant,
               "compute_ms": rl.compute_s * 1e3, "memory_ms": rl.memory_s * 1e3,
               "flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
               "path_r_count": count, "traced_s": rec["lower_s"]}
        out["cells"][f"local_1x1/{aid}/{sid}"] = row
        log(f"  [{card}] s {aid} × {sid} (1×1): measured {wall:.3f} ms over the roofline bound"
            f" {bound_ms:.4f} ms ({rl.dominant}) = {wall / bound_ms:.3f}; the record's flops"
            f" {rec['flops']:.4g} beside path r's {count:.4g} ({what}), bytes"
            f" {rec['bytes_accessed']:.4g}; traced in {rec['lower_s']:.1f} s")
        if bound_ms > wall:
            raise AssertionError(f"path s: {aid} × {sid}: the roofline bound {bound_ms} ms"
                                 f" exceeds the measured {wall} ms: the count is wrong")
    for (mesh, aid, sid), rec in by.items():
        if mesh != "pod_16x16":
            continue
        rl = roofline_from_record(rec)
        row = {"compute_s": rl.compute_s, "memory_s": rl.memory_s,
               "collective_s": rl.collective_s, "dominant": rl.dominant, "bound_s": rl.bound_s,
               "flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
               "collectives": rec["collectives"], "model_flops": rec["model_flops"],
               "memory": rec["memory"], "notes": rec["notes"], "traced_s": rec["lower_s"]}
        out["cells"][f"{mesh}/{aid}/{sid}"] = row
        print(f"| {aid} | {sid} | {mesh} | {rl.compute_s:.4f} | {rl.memory_s:.4f} |"
              f" {rl.collective_s:.4f} | **{rl.dominant}** | {rec['flops']:.4g} |"
              f" {rec['bytes_accessed']:.4g} | {sum(rec['collectives'].values()):.4g} |"
              f" {rec['notes']} |", flush=True)
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a"
              " checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--path-p-child"]:
        return distributed_child(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--path-q3-child"]:
        return lm_train_child(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--path-r4-child"]:
        return r_train_child(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--path-q"]:  # path q alone, no kernel built
        card = card_line()
        rec, _ = drive_lm(card, torch.device("cuda"))  # q3's gates and q4 after the rest
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_path_q.json").write_text(json.dumps(rec, indent=2))
        print(card, flush=True)
        return 0
    if sys.argv[1:2] == ["--path-r"]:  # path r alone, no kernel built
        card = card_line()
        rec, _ = drive_gnn_din(card, torch.device("cuda"))  # r4 after the rest
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_path_r.json").write_text(json.dumps(rec, indent=2))
        print(card, flush=True)
        return 0
    if sys.argv[1:2] == ["--path-s"]:  # paths r and s alone, no kernel built
        card = card_line()
        s_background = DryRunBackground()
        rec, _ = drive_gnn_din(card, torch.device("cuda"))
        rec = {"r_gnn_din": rec, "s_dryrun": drive_dryrun(card, rec, s_background)}
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_path_s.json").write_text(json.dumps(rec, indent=2))
        print(card, flush=True)
        return 0
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
    run(torch.device("cuda"))
    return 0


def device_bytes(db) -> dict:
    from repro_torch.storage import device_space_report

    rep = device_space_report(db.device)
    return {"total_bytes": rep["total_bytes"], "dense_bytes": rep["dense_bytes"],
            "ratio": rep["ratio"],
            "indexes": {k: {"device_bytes": v["device_bytes"], "dense_bytes": v["dense_bytes"],
                            "columns": {c: (d["kind"], d["device_bytes"])
                                        for c, d in v["columns"].items()}}
                        for k, v in rep["indexes"].items()}}


def run(device) -> None:
    """All phases on ``device``; raises on the first failure."""
    import torch

    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastDatabase, GQFastEngine
    from repro_torch.core.reference import run_sql
    from repro_torch.data import synth_graph as SG
    from repro_torch.kernels import active
    from repro_torch.kernels import fragment_spmv_fused as fk
    from repro_torch.kernels.cuda_build import build_all
    from repro_torch.kernels.params import (
        FRAGMENT_LOOP_CROSSOVER,
        FUSED_SCRATCH_BUDGET_BYTES,
        SKIP_MIN_BLOCKS,
    )

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # phase 1: build every kernel library at once
    t0 = time.perf_counter()
    libs = build_all()
    t_build = time.perf_counter() - t0
    log(f"[1] built {len(libs)} kernel libraries in {t_build:.2f} s (parallel nvcc)")
    builds = {}
    for lib in libs:
        builds[lib.name] = lib.build_seconds
        log(f"  {lib.source.name}: nvcc {lib.build_seconds if lib.build_seconds is not None else 'cached'} s")
        for line in (lib.build_log or "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    log(f"  fragment_spmv_fused2: {fk.max_grid('sum')} CTAs of 256 threads co-resident, with"
        f" the table {fk.max_grid('sum', table=True)}; the SpMM form at 8 rows a chunk"
        f" {fk.max_grid('sum', batched=True)}, with the table"
        f" {fk.max_grid('sum', batched=True, table=True)}")

    # phase 2: data, dense and auto storage over the same host indexes
    t0 = time.perf_counter()
    pub = SG.make_pubmed(**PUBMED)
    sem = SG.make_semmeddb(**SEMMED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    kw = dict(account_space=False, keep_packed=True, device=device, device_encodings="dense")
    db_dense = GQFastDatabase(pub, **kw)
    dbs_dense = GQFastDatabase(sem, **kw)
    sync()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = GQFastDatabase.from_parts(pub, db_dense.host_indexes, X.build_device_db(
        pub, db_dense.host_indexes, "auto", device=device))
    dbs = GQFastDatabase.from_parts(sem, dbs_dense.host_indexes, X.build_device_db(
        sem, dbs_dense.host_indexes, "auto", device=device))
    dict_db = GQFastDatabase.from_parts(pub, {("DT", "Term"): db_dense.host_indexes[("DT", "Term")]},
                                        X.build_device_db(
        pub, {("DT", "Term"): db_dense.host_indexes[("DT", "Term")]},
        {("DT", "Term", "Fre"): "dict"}, device=device))
    sync()
    t_auto = time.perf_counter() - t0
    space = {"pubmed_dense": device_bytes(db_dense), "semmed_dense": device_bytes(dbs_dense),
             "pubmed_auto": device_bytes(db), "semmed_auto": device_bytes(dbs)}
    log(f"[2] PubMed DT={pub.relationships['DT'].num_rows} DA={pub.relationships['DA'].num_rows}"
        f" rows, SemMedDB SP={sem.relationships['SP'].num_rows}; generated in {t_gen:.1f} s,"
        f" indexed and loaded dense in {t_load:.1f} s, auto from the same host indexes in"
        f" {t_auto:.1f} s")
    for label in ("pubmed_auto", "semmed_auto"):
        s = space[label]
        log(f"  {label}: {s['total_bytes']} device bytes vs {s['dense_bytes']} dense"
            f" (ratio {s['ratio']:.4f})")
        for k, v in s["indexes"].items():
            log(f"    {k}: {v['device_bytes']} B (dense {v['dense_bytes']} B) columns {v['columns']}")
    # each index's hot share and the packed hop's choice from it
    tables = {}
    for label, d in (("pubmed", db), ("semmed", dbs)):
        for (table, key), di in d.device.indexes.items():
            tables[f"{label} I_{table}.{key}"] = {"hot_share": di.hot_share,
                                                  "table": uses_table(di)}
    log("  packed hop per index (hot share: table on/off): " + ", ".join(
        f"{k} {v['hot_share']:.3g}: {'on' if v['table'] else 'off'}" for k, v in tables.items()))
    # the scalar walk's sizes, and the column store's bytes around it
    t0 = time.perf_counter()
    sizes = walk_sizes(pub)
    loop_a0 = int(near(sizes["author"], LOOP_AUTHOR_PATHS, 1)[0])
    log(f"  the walk's paths (host, {time.perf_counter() - t0:.1f} s): SD from d0=5"
        f" {sizes['doc'][5]:.0f} (documents' median {np.median(sizes['doc']):.0f}, max"
        f" {sizes['doc'].max():.0f}); AS from a0=7 {sizes['author'][7]:.4g}, from a0={loop_a0}"
        f" {sizes['author'][loop_a0]:.0f} (fragment_loop's AS seed)")
    space["fragment_loop_walk"] = walk_bytes(db, GQFastEngine(db, strategy="fragment_loop"),
                                             SG, loop_a0)

    # paths q's and r's work that needs no quiet card runs beside phase 3's checks
    lm_background = LMBackground(device)
    r_background = RBackground(device)
    s_background = DryRunBackground()

    # phase 3: kernels against their plain versions
    phase("[3] kernels against their plain versions on the card", t_start)
    worst = {k: 0.0 for k in KERNELS}
    dense_worst, dense_checks = check_dense_kernel(db_dense, device)
    mark("the dense pair", t_start)
    round_trip = storage_round_trip([("pubmed", db), ("semmed", dbs), ("pubmed dict", dict_db)])
    worst["bitunpack"] = check_bitunpack(device)
    mark("the storage round trip and bitunpack", t_start)
    worst["fragment_spmv_packed"], packed_checks = check_packed_kernel(
        packed_cases(db, dict_db, device), device)
    mark("the packed hop", t_start)
    act_worst, active_checks = check_active_kernels(db, db_dense, device)
    mark("the active kernels", t_start)
    worst.update(act_worst)
    for k, v in dense_worst.items():
        worst[k] = max(worst[k], v)
    worst["block_list"], list_checks = check_block_lists([("pubmed", db), ("semmed", dbs)],
                                                         device)
    mark("the list kernel", t_start)
    hot = check_hot_packed(device)
    mark("the packed pair on hot destinations", t_start)
    for k in PACKED_HOPS:
        worst[k] = max(worst[k], hot)
    worst.update(check_bitmap(device))
    del dict_db
    phase("[3c] crc32c against its plain version, then on every column of the PubMed cell",
          t_start)
    crc_checks = check_crc(db, device)
    worst["crc32c"] = 0.0  # every value equal
    mark("crc32c", t_start)
    fused_small, n_small = check_fused_small(device)
    mark("the small fused regions", t_start)
    specs = region_specs(db, SG, device)
    from repro_torch.core.fuse import REACH_DENSITY_MAX

    for sp in specs:
        log(f"  region {sp['name']}: prepared in {sp['prepare_s']:.2f} s, reach on the card"
            f" {sp['reach_bytes']} B, reach density {sp['reach_density']} ('auto' forms a"
            f" two-hop region up to {REACH_DENSITY_MAX})")
    fused_big, fused_checks = check_fused_regions(specs, device)
    for k in fused_small:
        worst[k] = max(fused_small[k], fused_big[k])
    phase("[3h] the batched kernels (SpMM and the fused regions' SpMM form)", t_start)
    spmm_small, n_spmm_small = check_spmm_small(device)
    mark("the small SpMM cases", t_start)
    spmm_path, spmm_path_checks = check_spmm_path(db, db_dense, device)
    mark("the SpMM kernels at the path's shapes", t_start)
    spmm_hot, n_spmm_hot = check_spmm_hot(device)
    mark("the SpMM kernels on hot destinations", t_start)
    for k in spmm_small:
        worst[k] = max(spmm_small[k], spmm_path[k], spmm_hot[k])
    spmm_fused, n_spmm_fused = check_spmm_fused(specs, device)
    worst.update(spmm_fused)

    # phase 4: the main paths
    c0 = busy_concept(sem)
    engines = {}
    for label, (p, s) in {"dense": (db_dense, dbs_dense), "auto": (db, dbs)}.items():
        ep, es = GQFastEngine(p), GQFastEngine(s)
        engines[label] = {n: (es if n == "CS" else ep) for n, _, _ in cases(SG, c0, True)}
    phase("[4] main paths through GQFastEngine.query / query_topk", t_start)
    paths, plans = {}, {}
    res_a, *rest, _ = drive_path("a: dense, skipping off, fusion off", engines["dense"], SG, c0,
                                 "off", "off", ["fragment_spmv"], topk=False)
    mark("path a", t_start)
    paths["a_dense_off"] = dict(zip(("counts", "hop_ops", "skip"), rest))
    res_b, *rest, _ = drive_path("b: auto storage, auto skipping, fusion off", engines["auto"],
                                 SG, c0, "auto", "off", PACKED_HOPS, topk=False, nine=True)
    paths["b_auto_auto_off"] = dict(zip(("counts", "hop_ops", "skip"), rest))
    for h in rest[2]:
        log(f"    {h['query']:10s} hop: {h['n_active']}/{h['n_blocks']} blocks active"
            f" (scan order above {h['scan_above']})")
    res_c, *rest, _ = drive_path("c: auto storage, skipping off, fusion off", engines["auto"],
                                 SG, c0, "off", "off", ["fragment_spmv_packed"], topk=False)
    paths["c_auto_off"] = dict(zip(("counts", "hop_ops", "skip"), rest))
    res_d, *rest, _ = drive_path("d: dense storage, auto skipping, fusion off", engines["dense"],
                                 SG, c0, "auto", "off", ["fragment_spmv", "fragment_spmv_active"],
                                 topk=False)
    mark("paths b, c and d", t_start)
    paths["d_dense_auto"] = dict(zip(("counts", "hop_ops", "skip"), rest))
    # e: a composite measure over a packed column decodes through bitunpack
    fre = db.device.index("DT", "Term").measure_cols["Fre"]
    fre._dense = None  # no decoded copy yet: the query makes it
    eng = engines["auto"]["SD"]
    reset_counts()
    comp = eng.query(Q_COMPOSITE, d0=5)
    counts_e = read_counts()
    if counts_e["bitunpack"] < 1:
        raise AssertionError(f"path e: bitunpack never launched ({counts_e})")
    paths["e_composite"] = {"counts": counts_e}
    log(f"  path e: composite measure SUM(dt2.Fre * dt2.Fre): launches {counts_e}")
    fused_res = {}
    for key, label, fusion, must in (
        ("f_defaults", "f: the defaults (auto storage, auto skipping, fusion auto)", "auto",
         ("fragment_spmv_fused1",)),
        ("g_fusion_on", "g: auto storage, auto skipping, fusion on", "on",
         ("fragment_spmv_fused2",)),
    ):
        # under fusion on, fused2's hops on I_DT.Doc, I_DA.Doc, I_SP.SID and
        # I_PA.PID take the table (hot shares 0.08-0.10)
        res, *rest, plan = drive_path(label, engines["auto"], SG, c0, "auto", fusion, PACKED_HOPS,
                                      topk=fusion == "auto", nine=True, must=must,
                                      must_table=must if fusion == "on" else ())
        fused_res[fusion] = res
        paths[key] = dict(zip(("counts", "hop_ops", "skip"), rest))
        plans[key] = plan
        for name, pr in plan.items():
            log(f"    {name:10s} prepare {pr['prepare_s']:.3f} s, reach on the card"
                f" {pr['reach_bytes']} B, regions {pr['regions'] or 'none'}")
        for h in rest[2]:
            if "fused" in h["query"]:
                log(f"    {h['query']:22s}: {h['n_active']}/{h['n_blocks']} blocks listed")
        mark(f"path {key[0]}", t_start)
    gates = {}  # the gate ratios of the gated float comparisons
    errs = {"dense": check_results("a", res_a, engines["dense"], SG, c0, "off", "off",
                                   gates=gates),
            "auto_auto_off": check_results("b", res_b, engines["auto"], SG, c0, "auto", "off",
                                           nine=True, gates=gates),
            "defaults": check_results("f", fused_res["auto"], engines["auto"], SG, c0, "auto",
                                      "auto", nine=True, gates=gates),
            "fusion_on": check_results("g", fused_res["on"], engines["auto"], SG, c0, "auto",
                                       "on", nine=True, gates=gates),
            "auto_off": check_results("c", res_c, engines["auto"], SG, c0, "off", "off",
                                      gates=gates),
            "dense_auto": check_results("d", res_d, engines["dense"], SG, c0, "auto", "off",
                                        gates=gates)}
    # every path's float sums against the plain versions' float64 sums
    mark("paths a-g against the plain versions", t_start)
    truth = truth_single(engines["auto"], SG, c0)
    float64_rel = {
        lbl: hold_f64(lbl, res, {k: v for k, v in truth.items() if k in res}, "single")
        for lbl, res in (("a", res_a), ("b", res_b), ("c", res_c), ("d", res_d),
                         ("f", fused_res["auto"]), ("g", fused_res["on"]))}
    cross = {}
    for name, _, _ in cases(SG, c0):
        for other, lbl in ((res_c, "auto/off"), (res_a, "dense/off"), (res_d, "dense/auto")):
            compare(res_b[name], other[name], name in EXACT_QUERIES,
                    f"auto/auto {name} vs {lbl}")
            if name not in EXACT_QUERIES:
                cross.setdefault(f"b vs {lbl}", {})[name] = gate_ratio(res_b[name], other[name])
    for what, ratios in cross.items():
        log_gates(what, ratios, gates)
    top_gate = max((v, f"{w} {q}") for w, r in gates.items() for q, v in r.items())
    log(f"  the largest gate ratio of a gated single-call comparison: {top_gate[0]:.4g}"
        f" ({top_gate[1]})")
    for name, _, _ in cases(SG, c0, True):
        for fusion, res in fused_res.items():
            compare(res[name], res_b[name], name in EXACT_QUERIES,
                    f"fusion {fusion} {name} vs fusion off")
    log("  auto/auto equals auto/off and the dense paths (exact for SD/AD/RECENT/CS; every"
        " path held to the float64 sums too); fusion auto and on equal fusion off for all"
        " nine (exact for the counts)")
    pq = eng.prepare(Q_COMPOSITE)
    plain = X.compile_frontier(db.device, pq.phys, use_kernel=False)(5).cpu().numpy()
    compare(comp, plain, False, "composite vs plain")
    compare(comp, engines["dense"]["SD"].query(Q_COMPOSITE, d0=5), False, "composite vs dense")
    t0 = time.perf_counter()
    want = run_sql(pub, SG.QUERY_SD, {"d0": 5})
    for res, lbl in ((res_b, "auto"), (res_a, "dense"), (fused_res["on"], "fusion on")):
        compare(res["SD"], want.astype(np.float32), True, f"{lbl} SD vs run_sql (full scale)")
    log(f"  SD matches run_sql at full scale on both storages and fused"
        f" ({time.perf_counter() - t0:.1f} s oracle)")
    # the defaults (fusion on too before path q came, dense/off before path p
    # came: both equal the defaults at full scale, exactly for the counts)
    check_quickstart(SG, run_sql, GQFastDatabase, GQFastEngine, device, "auto", "auto")
    mark("the quickstart scale against run_sql", t_start)

    # phase 4h/4i: batched serving through execute_batch / query_topk_batch
    phase("[4h] batched serving: execute_batch over the nine queries", t_start)
    draws = draw_params(SG, c0, param_pools(db, dbs),
                        tuple(sorted(set(BATCHES + TIME_BATCHES + (8,)))), 41)
    batched, brecords = {}, {}
    res_h, counts, brecords["h_defaults"] = drive_batched(
        "4h: the defaults", engines["auto"], SG, c0, draws, "auto", "auto", SPMM_HOPS,
        BATCHES + (8,), must=("fragment_spmm_fused1",), topk=8)
    paths["h_batched_defaults"] = {"counts": counts}
    mark("4h the defaults", t_start)
    dense_res = {}
    for key, label, enc, bs, kernels_ in (
        ("h_batched_dense_off", "4h: dense storage, skipping off, fusion off", "dense", "off",
         ["fragment_spmm"]),
        ("h_batched_dense_auto", "4h: dense storage, auto skipping, fusion off", "dense",
         "auto", SPMM_DENSE_HOPS),
        ("h_batched_auto_off", "4h: auto storage, skipping off, fusion off", "auto", "off",
         ["fragment_spmm_packed"]),
    ):
        res, counts, brecords[key] = drive_batched(label, engines[enc], SG, c0, draws, bs,
                                                   "off", kernels_, (8,))
        paths[key] = {"counts": counts}
        dense_res[key] = res
        for name, _, _ in cases(SG, c0, True):
            compare(res[(name, 8)][1], res_h[(name, 8)][1], name in EXACT_QUERIES,
                    f"{label} {name} B=8 vs the defaults")
    mark("4h the dense and skipping-off paths", t_start)
    batched["rows_vs_single_defaults"] = check_batched_rows(
        "4h", res_h, engines["auto"], SG, c0, "auto", "auto", gates)
    for key, enc, bs in (("h_batched_dense_off", "dense", "off"),
                         ("h_batched_dense_auto", "dense", "auto")):
        batched[f"rows_vs_single_{key}"] = check_batched_rows(
            "4h " + key[2:], dense_res[key], engines[enc], SG, c0, bs, "off", gates)
    mark("4h rows against single calls", t_start)
    truth8 = truth_batched(engines["auto"], SG, c0, res_h)
    float64_rel["h_B8"] = hold_f64("4h B=8", res_h, truth8, "batched",
                                   key=lambda name: (name, 8))
    batched["plain_defaults"] = check_batched_plain("4h", res_h, engines["auto"], SG, c0,
                                                    "auto", "auto", gates)
    log("  the dense and skipping-off batched paths equal the defaults at B = 8 (exact for"
        " the counts)")
    phase("[4i] batched serving under fusion on", t_start)
    res_i, counts, brecords["i_fusion_on"] = drive_batched(
        "4i: fusion on", engines["auto"], SG, c0, draws, "auto", "on", SPMM_HOPS,
        (8,), must=("fragment_spmm_fused2",), must_table=("fragment_spmm_fused2",))
    paths["i_batched_fusion_on"] = {"counts": counts}
    mark("4i the batches", t_start)
    ratios = {}
    for key, (params, out) in res_i.items():
        compare_gated(out, res_h[key][1], key[0], f"4i {key} vs 4h", ratios)
    log_gates("path 4i vs 4h", ratios, gates)
    batched["rows_vs_single_fusion_on"] = check_batched_rows(
        "4i", res_i, engines["auto"], SG, c0, "auto", "on", gates)
    float64_rel["i_B8"] = hold_f64("4i B=8", res_i, truth8, "batched",
                                   key=lambda name: (name, 8))
    batched["plain_fusion_on"] = check_batched_plain("4i", res_i, engines["auto"], SG, c0,
                                                     "auto", "on", gates)
    mark("4i against 4h, single calls and the plain versions", t_start)
    for fusion in ("auto", "on"):
        batched[f"quickstart_{fusion}"] = check_batched_quickstart(
            SG, run_sql, GQFastDatabase, GQFastEngine, device, fusion)

    # phase 4j: the intersection a user asks for
    phase("[4j] the merge intersection through ops.bitmap_and / bitmap_and_popcount", t_start)
    paths["j_intersection"], masks = drive_intersection(db_dense, device)

    # phase 4k/4l: the strategies and query profiling
    phase("[4k] fragment_loop and auto through GQFastEngine.query / query_topk /"
          " execute_batch", t_start)
    lqs = loop_cases(SG, c0, sizes)
    strat, strategy_records = {}, {}
    for s in ("fragment_loop", "auto"):
        ep, es = GQFastEngine(db, strategy=s), GQFastEngine(dbs, strategy=s)
        strat[s] = {n: (es if n == "CS" else ep) for n, _, _ in lqs}
    defaults_k = {n: engines["auto"][n].query(q, **p) for n, q, p in lqs}
    truth_k = truth_for(engines["auto"], lqs)
    rows8 = {n: ({"a0": near(sizes["author"], LOOP_AUTHOR_PATHS / 5, 8)}
                 if n in ("AS", "AS_RECENT") else draws[n][8]) for n, _, _ in lqs}
    for s in strat:
        _, counts, strategy_records[s] = drive_strategy(f"k: {s}", strat[s], defaults_k, SG,
                                                        lqs, truth_k, gates)
        paths[f"k_{s}"] = {"counts": counts}
        if counts["fragment_spmv_packed"] < 1:
            raise AssertionError(f"path k {s}: the frontier's packed hop never launched")
        strategy_records[s]["batched_gates"] = drive_strategy_batched(
            f"k: {s}", strat[s], SG, lqs, rows8, gates)
    phase("[4l] profile() and explain(analyze=True) on the card", t_start)
    reset_counts()
    profiles = drive_profiles({"defaults": engines["auto"],
                               "fragment_loop": strat["fragment_loop"]}, SG, lqs, truth_k, gates)
    paths["l_profile"] = {"counts": read_counts()}
    phase("[4m] the degradation ladder: run_with_policy / run_batch_with_policy, faults,"
          " deadlines, admission", t_start)
    ladder, counts = drive_ladder(engines["auto"], SG, lqs, defaults_k, rows8, draws, sizes,
                                  gates)
    paths["m_ladder"] = {"counts": counts}
    phase("[4n] durability: snapshot, restore, scrub and heal at the PubMed cell", t_start)
    tmp = tempfile.mkdtemp(prefix="gqfast_snapshot_")
    try:
        durability, counts = drive_durability({"pubmed": db, "semmed": dbs}, SG, c0,
                                              fused_res["auto"], gates, tmp)
        paths["n_durability"] = {"counts": counts}
        phase("[4o] serving: the analytics server's CI lanes and the PubMed cell from a"
              " snapshot", t_start)
        serving, counts = drive_serving(db, f"{tmp}/pubmed", tmp, gates, card, device)
        paths["o_serving"] = {"counts": counts}
        phase("[4p] the distributed strategy: a world of 1 on NCCL, a world of 4 over gloo on"
              " the one card", t_start)
        distributed, counts = drive_distributed(
            engines["auto"], SG, c0, fused_res["auto"], truth, draws,
            {g: f"{tmp}/{g}" for g in ("pubmed", "semmed")}, tmp, gates, card, device)
        paths["p_distributed"] = {"counts": counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if Path(tmp).exists():
        raise AssertionError(f"paths n, o and p: {tmp} was not removed")

    # phase 5: times
    phase("[5] times", t_start)
    qtimes = time_modes(engines, SG, c0, {"defaults": ("auto", "auto", "auto"),
                                          "fusion_on": ("auto", "auto", "on"),
                                          "fusion_off": ("auto", "auto", "off"),
                                          "skip_off": ("auto", "off", "auto"),
                                          "dense": ("dense", "off", "off")})
    over = {n: qtimes["defaults"][n]["median_ms"] / qtimes["dense"][n]["median_ms"]
            for n in qtimes["dense"]}
    over_skip = {n: qtimes["defaults"][n]["median_ms"] / qtimes["skip_off"][n]["median_ms"]
                 for n in qtimes["dense"]}
    log("  the defaults' wall against dense storage with skipping off (fault 2 closes at"
        f" {AUTO_OVER_SCAN}x for every query): " + ", ".join(
            f"{n} {v:.3f}x" for n, v in over.items()))
    log("  the defaults' wall against the defaults with skipping off (skipping's own"
        " cost): " + ", ".join(f"{n} {v:.3f}x" for n, v in over_skip.items()))
    missed = [n for n, v in over.items() if v > AUTO_OVER_SCAN]
    log(f"  fault 2: {'closed in this run' if not missed else f'open for {missed}'}")
    mark("5 the query walls", t_start)
    manifest_walls = time_manifest(engines, SG, c0)
    mark("5 the manifest walls", t_start)
    split = {"defaults": breakdown("defaults", engines["auto"], SG, c0, "auto", "auto", True),
             "dense": breakdown("dense", engines["dense"], SG, c0, "off", "off", nine=True),
             "fusion_on": breakdown("on", engines["auto"], SG, c0, "auto", "on", True),
             "fusion_off": breakdown("off", engines["auto"], SG, c0, "auto", "off", True)}
    mark("5 the device breakdowns", t_start)
    ktimes = time_kernels(db, db_dense, device)
    mark("5 the kernels", t_start)
    for shape in ("I_DA.Doc", "I_DT.Term"):
        t = {k: next(r["ms"] for r in ktimes[k] if r["shape"] == shape)
             for k in ("fragment_spmv", *PACKED_HOPS)}
        log(f"  {shape}: packed pair against the dense fragment_spmv (the same form):"
            f" scan {t['fragment_spmv_packed'] / t['fragment_spmv']:.3f}x, active"
            f" {t['fragment_spmv_packed_active'] / t['fragment_spmv']:.3f}x its time")
    hot_err = hot_author_error(db, db_dense, device)
    ktimes.update(time_bitmap(masks, device))
    ktimes["crc32c"] = time_crc(db, device)
    mark("5 the hot author, the bitmaps and crc32c", t_start)
    fused_rows, budget_rows, budget = time_fused(specs, device)
    ktimes.update(fused_rows)
    mark("5 the fused kernels", t_start)
    skipping, skip_fraction, ktimes["block_list"] = time_skipping(db, db_dense, device)
    mark("5 skipping", t_start)
    threshold_rows, min_blocks = time_list_threshold(db, device)
    mark("5 the list threshold", t_start)
    host = time_wrappers(dbs, dbs_dense, masks, device)
    phase("[5k] the strategies' crossover", t_start)
    crossover_rows, crossover = time_crossover(engines["auto"]["SD"], strat["fragment_loop"]["SD"],
                                               SG, sizes)
    stimes = time_modes({"defaults": engines["auto"], "fragment_loop": strat["fragment_loop"],
                         "auto": strat["auto"]}, SG, c0,
                        {k: (k, "auto", "auto") for k in ("defaults", "fragment_loop", "auto")},
                        qs=lqs)
    ssplit = {s: breakdown(s, strat[s], SG, c0, "auto", qs=lqs) for s in strat}
    phase("[5h] batched serving: execute_batch against B single calls, and the batched"
          " kernels", t_start)
    btimes = time_batched(engines["auto"], SG, c0, draws)
    mark("5h the batched walls", t_start)
    ktimes.update(time_spmm_kernels(db, db_dense, device))
    mark("5h the SpMM kernels", t_start)
    ktimes.update(time_spmm_fused(specs, device))
    state = card_state()
    log(f"  card state after timing (clocks.sm, power.draw, power.limit, temp): {state}")
    log(f"  SKIP_BLOCK_FRACTION in use: {active.SKIP_BLOCK_FRACTION}; measured here:"
        f" {skip_fraction:.4f}")
    log(f"  SKIP_MIN_BLOCKS in use: {SKIP_MIN_BLOCKS}; measured here: {min_blocks}")
    log(f"  FUSED_SCRATCH_BUDGET_BYTES in use: {FUSED_SCRATCH_BUDGET_BYTES}; fused no slower"
        f" up to 4·n_mid = {budget} bytes here")
    log(f"  FRAGMENT_LOOP_CROSSOVER in use: {FRAGMENT_LOOP_CROSSOVER}; measured here:"
        f" {crossover:.6g}")

    # path q: the transformer family (after the times: its 12 GB come and go)
    phase("[4q] the transformer family: Qwen2.5-3B served and trained at full width, the"
          " card against the CPU, the entry points", t_start)
    lm, counts = drive_lm(card, device, lm_background)
    paths["q_lm"] = {"counts": counts}
    torch.cuda.empty_cache()
    # path r: the GNN family and DIN (after q, on the quiet card)
    phase("[4r] the GNN family and DIN: DIN at full width served, retrieving and trained,"
          " the four GNNs at full width on molecules, MACE on minibatch_lg, the entry points",
          t_start)
    gnn_din, counts = drive_gnn_din(card, device, r_background)
    paths["r_gnn_din"] = {"counts": counts}
    torch.cuda.empty_cache()
    # path s: the dry run's records (a child beside phase 3) against path r
    phase("[4s] the dry run: DIN and MACE on a 1×1 mesh held to path r's walls, GQ-Fast and"
          " Llama-3-8B on the 16×16 pod mesh", t_start)
    dryrun = drive_dryrun(card, gnn_din, s_background)

    launches = {k: sum(p["counts"][k] for p in paths.values()) for k in KERNELS}
    table_launches = {k: sum(t[k] for t in TABLE_BY_PATH.values())
                      for k in next(iter(TABLE_BY_PATH.values()))}
    entries = []
    for k, (_, _, src, replaces) in KERNELS.items():
        if k.startswith("fragment_spmv_fused"):
            primary = ktimes[k][-1]
        elif k.startswith("fragment_spmm_fused"):
            primary = ktimes[k][0] if k.endswith("1") else ktimes[k][1]  # SD-recent; AS-recent
        elif k.startswith("fragment_spmm"):
            primary = next(r for r in ktimes[k] if r["B"] == 8)  # I_DT.Term at B = 8
        elif k == "block_list":
            primary = ktimes[k][-1]  # I_DT.Term at 100% support: 'auto' does not skip
        else:
            primary = ktimes[k][0]
        if k.startswith("bitmap"):
            timed = f"{primary['shape']}, {primary['E']} words"
        elif k == "block_list":
            timed = f"{primary['shape']}, {primary['E']} blocks"
        elif k == "crc32c":
            timed = f"{primary['shape']}, {primary['E']} bytes"
        else:
            timed = (f"{primary['shape']} sum, E={primary['E']}"
                     + (f", B={primary['B']}" if "B" in primary else "")
                     + (f", {primary['form']}" if "form" in primary else ""))
        entries.append({
            "name": k, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[k], "max_abs_err": worst[k],
            "ms": primary["ms"], "plain_ms": primary["plain_ms"],
            "bound_ms": primary["bound_ms"], "bound_by": primary["bound_by"],
            "library_ms": primary["library_ms"], "timed_shape": timed,
            **({"table_launches": table_launches[k]} if k in table_launches else {}),
        })
    record = {
        "card": card, "card_state": state, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_seconds": builds, "build_wall_seconds": t_build,
        "config": {"pubmed": PUBMED, "semmed": SEMMED,
                   "dt_rows": int(pub.relationships["DT"].num_rows),
                   "da_rows": int(pub.relationships["DA"].num_rows)},
        "device_bytes": space,
        "setup_seconds": {"generate": t_gen, "index_and_load_dense": t_load,
                          "load_auto": t_auto},
        "checks": {"dense": dense_checks, "packed": packed_checks, "active": active_checks,
                   "block_list": list_checks,
                   "round_trip": round_trip, "fused_small": n_small,
                   "fused_regions": fused_checks},
        "regions": [{k: sp[k] for k in ("name", "prepare_s", "reach_bytes", "reach_density")}
                    for sp in specs],
        "paths": paths, "table_launches_by_path": TABLE_BY_PATH, "fused_plans": plans, "query_max_abs_err_vs_plain": errs,
        "queries": qtimes, "query_device_breakdown": split, "kernel_times": ktimes,
        "hot_author_float32": hot_err, "query_float64_rel": float64_rel,
        "float64_limit": FLOAT64_LIMIT, "gate_ratios": gates, "top_gate_ratio": top_gate, "index_tables": tables,
        "fault2_defaults_over_dense": over, "fault2_defaults_over_skip_off": over_skip,
        "list_threshold": threshold_rows, "skip_min_blocks": SKIP_MIN_BLOCKS,
        "skip_min_blocks_measured": min_blocks, "wrapper_host_us": host,
        "skipping": skipping, "skip_block_fraction": active.SKIP_BLOCK_FRACTION,
        "skip_block_fraction_measured": skip_fraction, "fused_vs_unfused": budget_rows,
        "fused_scratch_budget_bytes": FUSED_SCRATCH_BUDGET_BYTES,
        "fused_scratch_budget_measured": budget,
        "strategies": {"walk_author": loop_a0, "paths": strategy_records,
                       "profiles": profiles, "crossover": crossover_rows,
                       "times": stimes, "device_breakdown": ssplit,
                       "fragment_loop_crossover": FRAGMENT_LOOP_CROSSOVER,
                       "fragment_loop_crossover_measured": crossover},
        "batched": {"checks": {"spmm_small": n_spmm_small, "spmm_path": spmm_path_checks,
                               "spmm_hot": n_spmm_hot,
                               "spmm_fused": n_spmm_fused, **batched},
                    "launch_records": brecords, "times": btimes},
        "robust": {"crc_checks": crc_checks, "ladder": ladder, "durability": durability,
                   "manifest_walls": manifest_walls},
        "serving": serving, "distributed": distributed, "lm": lm, "gnn_din": gnn_din,
        "dryrun": dryrun,
        "kernels": entries,
        "total_seconds": time.perf_counter() - t_start,
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=2))
    log(f"done in {record['total_seconds']:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
