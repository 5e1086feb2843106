"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
``repro``, so it runs on a machine where JAX is not installed."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# `import jax`, `from jax…`, and absolute imports of the reference package
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.MULTILINE)


def test_port_query_loads_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import sys
        from repro_torch.core.engine import GQFastDatabase, GQFastEngine
        from repro_torch.data import synth_graph as SG
        schema = SG.make_pubmed(n_docs=200, n_terms=20, n_authors=50, seed=1)
        eng = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu"))
        out = eng.query(SG.QUERY_AS, a0=3)
        assert out.shape == (50,) and (out != 0).any()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_sources_import_neither_jax_nor_repro():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 5, examples
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + examples
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files for m in FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders


def test_port_batched_serving_loads_neither_jax_nor_repro():
    """execute_batch and query_topk_batch (the batched kernels' modules
    included) run without JAX or the JAX package."""
    code = textwrap.dedent("""
        import sys
        from repro_torch.core.engine import GQFastDatabase, GQFastEngine
        from repro_torch.data import synth_graph as SG
        schema = SG.make_pubmed(n_docs=200, n_terms=20, n_authors=50, seed=1)
        eng = GQFastEngine(GQFastDatabase(schema, account_space=False, device="cpu"))
        out = eng.prepare(SG.QUERY_AS_RECENT, fusion="on").execute_batch(a0=[3, 4, 5])
        assert out.shape == (3, 50)
        assert len(eng.query_topk_batch(SG.QUERY_SD, k=3, d0=[1, 2])) == 2
        for m in ("fragment_spmm", "fragment_spmm_packed", "fragment_spmv_fused"):
            assert f"repro_torch.kernels.{m}" in sys.modules, m
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_bitmap_ops_load_neither_jax_nor_repro():
    """The bitmap intersection entries (and their kernel module) run without
    JAX or the JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch.kernels import ops
        a = np.arange(1, 65, dtype=np.uint32)
        assert int(ops.bitmap_and_popcount(a, a)) == sum(bin(v).count("1") for v in range(1, 65))
        assert ops.bitmap_and(a, a).shape == (64,)
        assert "repro_torch.kernels.bitmap_ops" in sys.modules
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_block_list_loads_neither_jax_nor_repro():
    """The list entry (its kernel module included) and a dense hop that takes
    the table by its hot share run without JAX or the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        from repro_torch.kernels import ops
        w = torch.zeros(50)
        w[7] = 1.0
        smin = torch.tensor([0, 5, 20], dtype=torch.int32)
        smax = torch.tensor([5, 20, 49], dtype=torch.int32)
        bi, na, fl = ops.active_block_list(w, 0.0, smin, smax, flags=True)
        assert bi.tolist() == [1, 1, 1] and int(na[0]) == 1 and fl.tolist() == [False, True, False]
        src = torch.arange(50, dtype=torch.int32)
        one_block = (torch.zeros(1, dtype=torch.int32), torch.full((1,), 49, dtype=torch.int32))
        y = ops.fragment_spmv(w, src, src % 3, None, 3, hot_share=0.5, blocks=one_block,
                              block_skipping="on")
        assert y.tolist() == [0.0, 1.0, 0.0]
        assert "repro_torch.kernels.block_list" in sys.modules
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_strategies_and_profile_load_neither_jax_nor_repro():
    """fragment_loop (single and batched), auto, profile() and
    explain(analyze=True) run without JAX or the JAX package."""
    code = textwrap.dedent("""
        import sys
        from repro_torch.core.engine import GQFastDatabase, GQFastEngine
        from repro_torch.data import synth_graph as SG
        schema = SG.make_pubmed(n_docs=200, n_terms=20, n_authors=50, seed=1)
        db = GQFastDatabase(schema, account_space=False, device="cpu")
        loop = GQFastEngine(db, strategy="fragment_loop")
        assert loop.query(SG.QUERY_AS, a0=3).shape == (50,)
        assert loop.prepare(SG.QUERY_SD).execute_batch(d0=[1, 2]).shape == (2, 200)
        pq = GQFastEngine(db, strategy="auto").prepare(SG.QUERY_FSD)
        assert pq.profile(reps=1, d0=4).hops
        assert "analyze: total" in pq.explain(analyze=True, d0=4)
        assert "repro_torch.obs.profile" in sys.modules
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_robustness_and_durability_load_neither_jax_nor_repro(tmp_path):
    """The ladder, a fault plan, a manifest, a snapshot and its restore, and
    a scrub run without JAX or the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        from repro_torch.core.engine import GQFastDatabase, GQFastEngine
        from repro_torch.data import synth_graph as SG
        from repro_torch.robust import LADDER, RobustPolicy, Scrubber, faults, run_with_policy
        from repro_torch.storage import attach_manifest, restore_db, snapshot_db
        schema = SG.make_pubmed(n_docs=200, n_terms=20, n_authors=50, seed=1)
        db = GQFastDatabase(schema, account_space=False, device="cpu")
        pq = GQFastEngine(db).prepare(SG.QUERY_SD)
        plan = faults.FaultPlan().add(faults.FaultSpec(site="ops.", mode="raise"))
        with faults.active(plan):
            oc = run_with_policy(pq, {{"d0": 3}})
        assert oc.ok and oc.rung == "xla", oc.to_dict()
        snapshot_db(db, {str(tmp_path)!r})
        db2 = restore_db({str(tmp_path)!r}, device="cpu")
        attach_manifest(db2.device)
        assert Scrubber(db2, snapshot_dir={str(tmp_path)!r}).scrub_full()["failed"] == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_serve_loop_loads_neither_jax_nor_repro(tmp_path):
    """The port's serve loop (a snapshot published, a reload, the scrubber,
    the oracle replay) runs without JAX or the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        from repro_torch.launch import serve
        run = serve.main(["--device", "cpu", "--requests", "12", "--docs", "300",
                          "--batch", "4", "--snapshot-dir", {str(tmp_path)!r},
                          "--reload-at", "1", "--scrub", "--verify-responses"])
        c = run.registry.snapshot()["counters"]
        assert c["serve.requests_ok"] == 12 and c["serve.generation_reloads"] >= 1, c
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_lm_family_loads_neither_jax_nor_repro(tmp_path):
    """The transformer family (models, optim, train, ckpt.manager, configs
    and the launchers' lm paths) runs without JAX or the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        from repro_torch.ckpt.manager import CheckpointManager
        from repro_torch.configs.registry import get_arch
        from repro_torch.launch import serve, train as launch_train
        from repro_torch.models import transformer as T
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.train.loop import TrainLoopConfig, train
        from repro_torch.data.lm_data import lm_batch
        assert get_arch("olmoe-1b-7b").smoke(device="cpu")["finite"]
        cfg = get_arch("qwen2.5-3b").smoke_cfg
        p = T.init_params(cfg, torch.Generator().manual_seed(0))
        _, res = train(p, lambda q, b: T.loss_fn(q, b, cfg),
                       lambda s: lm_batch(s, 2, 16, cfg.vocab, device="cpu"),
                       TrainLoopConfig(total_steps=2, ckpt_dir={str(tmp_path / "a")!r}),
                       AdamWConfig(quantize_moments=True))
        assert CheckpointManager({str(tmp_path / "a")!r}).latest_step() == 2
        launch_train.main(["--arch", "arctic-480b", "--steps", "2", "--device", "cpu",
                           "--ckpt-dir", {str(tmp_path / "b")!r}])
        serve.main(["--workload", "lm", "--device", "cpu", "--requests", "2"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_gnn_and_din_load_neither_jax_nor_repro(tmp_path):
    """The GNN family and DIN (models, the embedding substrate, the data
    generators, configs, the launcher's gnn and recsys paths and both
    examples' modules) run without JAX or the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        from repro_torch.configs.registry import get_arch
        from repro_torch.data.graphs import CSRGraph, NeighborSampler, make_feature_graph
        from repro_torch.launch import train as launch_train
        from repro_torch.models.embedding import embedding_bag
        for aid in ("mace", "egnn", "equiformer-v2", "schnet", "din"):
            assert get_arch(aid).smoke(device="cpu")["finite"], aid
        b = NeighborSampler(CSRGraph.random(500, 4000, 4), [3, 2], 8, device="cpu").sample()
        assert b.edge_src.shape == (8 * 3 * 3,)
        g = make_feature_graph(50, 200, 4, device="cpu")
        assert embedding_bag(g.node_feat, g.edge_src, g.edge_dst, 50, mode="max").shape == (50, 4)
        launch_train.main(["--arch", "schnet", "--steps", "2", "--device", "cpu",
                           "--ckpt-dir", {str(tmp_path)!r}])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_dry_run_tools_load_neither_jax_nor_repro(tmp_path):
    """The sharding rules, the compressed all-reduce, the roofline and the
    dry run (a DIN cell on a 1×1 mesh over a fake process group) run
    without JAX or the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        from repro_torch.dist import compression, sharding
        from repro_torch.launch.dryrun import run_cells
        from repro_torch.roofline.analysis import report
        recs = run_cells([("local_1x1", "din", "serve_p99")], {str(tmp_path)!r})
        assert recs[0]["status"] == "ok", recs[0]
        assert "din" in report({str(tmp_path)!r}, mesh="local_1x1")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
