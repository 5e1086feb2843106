"""The port's dry-run tools against the JAX package's, on the CPU.

  * the sharding rules: on the reference's ``AbstractMesh`` (16×16 and
    2×16×16, no devices) every leaf's filtered spec of the reference's
    family functions equals the port's, over a transformer's params and
    AdamW state, an MoE config's, a GNN batch, DIN's params and batches;
  * the roofline: the HLO collective parser on the reference test's sample,
    ``loop_trips`` on reference-style records and on a port record, the
    three terms from the port's H100 constants;
  * over a fake process group (``launch.mesh.make_dry_run_mesh``), in ONE
    child process (a fake group of 256 ranks left in a test worker would
    break every later test there): the cells the reference's tests build
    and a GQ-Fast cell (args and placements align leaf for leaf; ``kind``,
    ``notes`` and ``model_flops`` equal the reference's ``make_cell`` on a
    1×1 mesh), a product's per-rank flops, one layer counted once however
    many layers and microbatches, ``shard_hint``'s placements, and a dry
    run's record with the reference's keys.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.dist import sharding as J  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.roofline import analysis as JA  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}

#: The cells the reference's tests build (tests/test_configs_roofline.py),
#: and one GQ-Fast cell.
CELLS = [("llama3-8b", "train_4k"), ("qwen2.5-3b", "decode_32k"),
         ("arctic-480b", "prefill_32k"), ("schnet", "molecule"),
         ("din", "retrieval_cand"), ("gqfast-pubmed", "as_b1")]


def _stand_in(name):
    """What the port's rules read of a ``DeviceMesh``: its names and sizes."""
    shape, axes = MESHES[name]
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _jspecs(tree):
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: hasattr(x, "spec"))
    return [tuple(x.spec) for x in leaves]


def _is_axis(e) -> bool:
    return e is None or isinstance(e, str) or (
        isinstance(e, tuple) and all(isinstance(a, str) for a in e))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(_is_axis(e) for e in x)


def _pspecs(tree, is_leaf=_is_spec):
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf=is_leaf)]


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


def _abstract(shapes: dict, dtype) -> dict:
    return {k: jax.ShapeDtypeStruct(v, dtype) for k, v in shapes.items()}


def _meta(shapes: dict) -> dict:
    return {k: torch.empty(v, device="meta") for k, v in shapes.items()}


def _trees():
    """(family, reference tree, port tree): abstract trees of the same
    structure in both packages."""
    from repro.configs.din_arch import DIN as JDIN
    from repro.models import din as jdin
    from repro.models import transformer as JT
    from repro.optim.adamw import AdamWConfig as JAdamW, adamw_init as jadamw_init
    from repro_torch.configs.din_arch import DIN
    from repro_torch.models import din as pdin
    from repro_torch.models import transformer as T
    from repro_torch.models.common import MetaGenerator
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    out = []
    for moe in (None, "moe"):
        jmoe = JT.MoEConfig(8, 2, 32) if moe else None
        pmoe = T.MoEConfig(8, 2, 32) if moe else None
        jcfg = JT.TransformerConfig("t", 2, 64, 4, 2, 128, 97, d_head=16, moe=jmoe)
        pcfg = T.TransformerConfig("t", 2, 64, 4, 2, 128, 97, d_head=16, moe=pmoe)
        jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
        jo = jax.eval_shape(lambda: jadamw_init(jp, JAdamW()))
        pp = T.init_params(pcfg, MetaGenerator())
        out.append(("lm_state", (jp, jo), (pp, adamw_init(pp, AdamWConfig()))))
        jq = jax.eval_shape(lambda: jadamw_init(jp, JAdamW(quantize_moments=True)))
        out.append(("lm_state", jq, adamw_init(pp, AdamWConfig(quantize_moments=True))))
    jcache = jax.eval_shape(lambda: JT.init_kv_cache(jcfg, 32, 64))
    out.append(("kv_cache", jcache, T.init_kv_cache(pcfg, 32, 64, "meta")))
    for B in (256, 8):
        out.append(("lm_batch", {"tokens": jax.ShapeDtypeStruct((B, 64), jnp.int32)},
                    {"tokens": torch.empty((B, 64), dtype=torch.int32, device="meta")}))
    for N, E in ((2708, 10752), (3840, 8192)):
        shapes = {"pos": (N, 3), "z": (N,), "edge_src": (E,), "edge_dst": (E,),
                  "node_mask": (N,), "edge_mask": (E,), "node_feat": (N, 7)}
        out.append(("gnn_input", _abstract(shapes, jnp.float32), _meta(shapes)))
    jp = jax.eval_shape(lambda: jdin.din_init(JDIN.full, jax.random.key(0)))
    pp = pdin.din_init(DIN.full, MetaGenerator())
    out.append(("recsys_state", (jp, jax.eval_shape(lambda: jadamw_init(jp, JAdamW()))),
                (pp, adamw_init(pp, AdamWConfig()))))
    for NC in (1_000_448, 1000):
        shapes = {"user": (1,), "hist_items": (1, 100), "hist_mask": (1, 100), "cand_items": (NC,)}
        out.append(("recsys_batch", _abstract(shapes, jnp.int32), _meta(shapes)))
    shapes = {"user": (65536,), "hist_items": (65536, 100), "label": (65536,)}
    out.append(("recsys_batch", _abstract(shapes, jnp.int32), _meta(shapes)))
    return out


FAMILIES = {
    "lm_state": (J.lm_state_shardings, S.lm_state_shardings,
                 lambda n, s: S.lm_param_spec(n, s)),
    "lm_batch": (J.lm_batch_shardings, S.lm_batch_shardings, S.lm_batch_spec),
    "kv_cache": (J.kv_cache_shardings, S.kv_cache_shardings, S.kv_cache_spec),
    "gnn_input": (J.gnn_input_shardings, S.gnn_input_shardings, S.gnn_input_spec),
    "recsys_state": (J.recsys_state_shardings, S.recsys_state_shardings, S.recsys_state_spec),
    "recsys_batch": (J.recsys_batch_shardings, S.recsys_batch_shardings, S.recsys_batch_spec),
}


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_filtered_specs_equal_the_references_leaf_for_leaf(trees, mesh):
    """Every leaf's spec, filtered to the mesh and the leaf's shape, is the
    reference's; the port's placements are those of the reference's spec."""
    amesh = AbstractMesh(*MESHES[mesh])
    pmesh = _stand_in(mesh)
    seen = set()
    for fam, jtree, ptree in trees:
        jfn, pfn, spec_fn = FAMILIES[fam]
        want = _jspecs(jfn(jtree, amesh))
        got = _pspecs(S.filtered_specs(ptree, pmesh, spec_fn))
        shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree)]
        assert len(want) == len(got) == len(shapes), fam
        for w, g, shp in zip(want, got, shapes):
            assert _pad(w, len(shp)) == g, (fam, shp, w, g)
            # and the reference's own _filter gives the same tuple
            assert _pad(tuple(J._filter(amesh, _pad(w, len(shp)), shp)), len(shp)) == g
        placed = _pspecs(pfn(ptree, pmesh), S.is_placements)
        assert placed == [S.placements(pmesh, g) for g in got], fam
        seen.add(fam)
    assert seen == set(FAMILIES)


def test_a_spec_listing_axes_out_of_mesh_order_raises():
    with pytest.raises(ValueError, match="mesh-dim order"):
        S.placements(_stand_in("pod"), (("model", "data"),))


def test_collective_parser_equals_the_references():
    hlo = """
  %ag = f32[2048,1,128]{2,1,0} all-gather(%x), replica_groups=...
  %ar.1 = bf16[64,32]{1,0} all-reduce-start(%y)
  %ar.2 = bf16[64,32]{1,0} all-reduce-done(%ar.1)
  %cp = u32[16]{0} collective-permute(%z)
  %rs = (f32[8]{0}, s8[4]{0}) reduce-scatter(%a, %b)
  %notacoll = f32[8,8]{1,0} add(%a, %b)
"""
    assert A.collective_bytes_from_hlo(hlo) == JA.collective_bytes_from_hlo(hlo)
    assert A.collective_bytes_from_hlo(hlo)["all-gather"] == 2048 * 128 * 4


@pytest.mark.parametrize("rec", [
    {"arch": "llama3-8b", "kind": "train", "notes": "micro=8 seq_shard=True"},
    {"arch": "llama3-8b", "kind": "decode", "notes": ""},
    {"arch": "olmoe-1b-7b", "kind": "train", "notes": "micro=16 seq_shard=True"},
    {"arch": "schnet", "kind": "train", "notes": ""},
    {"arch": "gqfast-pubmed", "kind": "serve", "notes": ""},
    {"arch": "nope", "kind": "train", "notes": ""},
])
def test_loop_trips_match_the_reference_and_a_port_record_counts_once(rec):
    assert A.loop_trips(rec) == JA.loop_trips(rec)
    assert A.loop_trips({**rec, "trips": 1}) == 1


def test_roofline_terms_from_the_h100_constants():
    rec = {"arch": "llama3-8b", "kind": "train", "notes": "micro=8", "trips": 1,
           "flops": A.PEAK_FLOPS, "bytes_accessed": A.HBM_BW * 2,
           "collectives": {"all-reduce": A.LINK_BW * 3}}
    rl = A.roofline_from_record(rec)
    assert abs(rl.compute_s - 1.0) < 1e-9
    assert abs(rl.memory_s - 2.0) < 1e-9
    assert abs(rl.collective_s - 3.0) < 1e-9
    assert rl.dominant == "collective" and rl.bound_s == rl.collective_s
    assert (A.PEAK_FLOPS, A.HBM_BW, A.LINK_BW) == (989.4e12, 3.35e12, 50e9)


def test_hop_work_is_the_smoke_scripts_hop_count():
    b, ops = A.hop_work(1000, 10, 20, 4000, 4000)
    assert (b, ops) == (4 * 1000 + 4000 + 4000 + 40 + 80, 2000)
    b8, ops8 = A.hop_work(1000, 10, 20, 4000, 0, extra=12, batch=8)
    assert (b8, ops8) == (4 * 1000 + 4000 + 8 * 40 + 8 * 80 + 12, 16000)


def test_report_reads_records(tmp_path):
    recs = [
        {"arch": "llama3-8b", "shape": "train_4k", "mesh": "pod_16x16", "variant": "",
         "status": "ok", "kind": "train", "notes": "micro=8", "trips": 1,
         "model_flops": 256 * A.PEAK_FLOPS, "flops": A.PEAK_FLOPS,
         "bytes_accessed": 1.0, "collectives": {}, "memory": {"argument_size_in_bytes": 2e9}},
        {"arch": "llama3-8b", "shape": "long_500k", "mesh": "pod_16x16", "variant": "",
         "status": "skipped", "reason": "pure full-attention architecture"},
        {"arch": "mace", "shape": "molecule", "mesh": "pod_16x16", "variant": "",
         "status": "error", "error": "RuntimeError: x"},
    ]
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    table = A.report(str(tmp_path)).splitlines()
    assert len(table) == 5
    assert "**compute**" in table[2] and "| 1.00 |" in table[2] and "2.00 GB" in table[2]
    assert "SKIP" in table[3] and "ERROR: RuntimeError: x" in table[4]


# ---------------------------------------------------------------------------
# over a fake process group, in one child process
# ---------------------------------------------------------------------------

CHILD = textwrap.dedent('''
    import json, sys, time
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.lm_family import make_lm_arch
    from repro_torch.dist.sharding import distribute_meta, is_placements, named
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import end_dry_run_mesh, make_dry_run_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import shard_hint, use_mesh
    from repro_torch.roofline.analysis import make_op_tally
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    CELLS = json.loads(sys.argv[1])
    out_dir = sys.argv[2]
    res = {"cells": {}}

    def leaves(tree, pl):
        return [x for _, x in tree_leaves_with_path(tree, is_leaf=is_placements if pl else None)]

    mesh = make_dry_run_mesh("local_1x1")
    for aid, sid in CELLS:
        cell = get_arch(aid).make_cell(sid, mesh)
        args = [leaves(a, False) for a in cell.args]
        shs = [leaves(s, True) for s in cell.in_shardings]
        res["cells"][f"{aid}/{sid}"] = {
            "kind": cell.kind, "notes": cell.notes, "model_flops": cell.model_flops,
            "n_args": [len(a) for a in args], "n_sh": [len(s) for s in shs],
            "aligned": all(
                tuple(x.placements) == s if isinstance(x, DTensor) else s == named(mesh, ())
                for a, ss in zip(args, shs) for x, s in zip(a, ss)),
            "meta": all(x.to_local().is_meta for a in args for x in a if isinstance(x, DTensor)),
        }

    def lm_flops(L, variant=""):
        cfg = T.TransformerConfig("t", L, 64, 4, 2, 128, 97, d_head=16, remat=False,
                                  attn_kv_chunk=4096)
        return dryrun.trace_cell(make_lm_arch("t", cfg).make_cell("train_4k", mesh, variant),
                                 mesh)["flops"]

    res["layers"] = [lm_flops(L) for L in (1, 2, 3)]
    res["micro16"] = lm_flops(1, "micro16")
    end_dry_run_mesh()

    mesh = make_dry_run_mesh("pod_16x16")
    a = distribute_meta(torch.empty(4096, 4096, device="meta"), mesh, (Shard(0), Replicate()))
    b = distribute_meta(torch.empty(4096, 11008, device="meta"), mesh, (Replicate(), Shard(1)))
    r = distribute_meta(torch.empty(4096, 11008, device="meta"), mesh, (Replicate(), Replicate()))
    with make_op_tally() as t:
        c = a @ b
    ar = a.redistribute(mesh, (Replicate(), Replicate()))
    with make_op_tally() as t3:
        ar @ r
    res["product"] = {"flops": t.flops, "local": list(c.to_local().shape),
                      "replicated_flops": t3.flops}
    x = distribute_meta(torch.empty(32, 4096, 64, device="meta"), mesh, (Replicate(), Replicate()))
    res["hint_no_mesh"] = shard_hint(x, "data", "model") is x
    with use_mesh(mesh), implicit_replication():
        y = shard_hint(x, ("pod", "data"), "model", None)
        z = shard_hint(x, None, None, "model")
        w = shard_hint(torch.ones(3), "data")
    res["hint"] = [str(y.placements), str(z.placements), list(y.to_local().shape)]
    res["hint_plain"] = bool(isinstance(w, DTensor))
    rec = dryrun.run_cell("gqfast-pubmed", "as_b8", mesh, "pod_16x16", out_dir)
    res["record"] = rec
    end_dry_run_mesh()
    print("RESULT " + json.dumps(res))
''')


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(CELLS), str(out)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("aid,shape", CELLS)
def test_cells_align_and_equal_the_references(child, aid, shape):
    got = child["cells"][f"{aid}/{shape}"]
    assert got["aligned"] and got["meta"]
    assert got["n_args"] == got["n_sh"]
    ref = jget_arch(aid).make_cell(shape, jmake_mesh((1, 1), ("data", "model")))
    assert got["kind"] == ref.kind
    assert got["notes"] == ref.notes
    assert got["model_flops"] == pytest.approx(ref.model_flops, rel=1e-12)
    assert len(got["n_args"]) == len(ref.args)
    if aid != "gqfast-pubmed":  # the port's shards need no padding column
        for n, arg in zip(got["n_args"], ref.args):
            assert n == len(jax.tree_util.tree_leaves(arg)), (aid, shape)


def test_per_rank_flops_of_a_product(child):
    """On the 16×16 mesh, (Shard(0), Replicate) @ (Replicate, Shard(1))
    counts a rank's share, 2·M·K·N/256, on a [256, 688] shard; a fully
    replicated product counts its global flops."""
    p = child["product"]
    full = 2 * 4096 * 4096 * 11008
    assert p["local"] == [256, 688]
    assert p["flops"] == full / 256
    assert p["replicated_flops"] == full


def test_each_layer_is_counted_once(child):
    """From 1 to 2 to 3 layers an LM train cell's flops grow by the same
    step (one layer, every microbatch of it once); 16 microbatches over the
    same tokens count what 8 do."""
    f1, f2, f3 = child["layers"]
    assert f2 - f1 > 0
    assert (f3 - f2) == pytest.approx(f2 - f1, rel=1e-9)
    assert child["micro16"] == pytest.approx(f1, rel=1e-9)


def test_shard_hint_places_as_the_filter_says(child):
    assert child["hint_no_mesh"] is True
    y, z, local = child["hint"]
    assert y == "(Shard(dim=0), Shard(dim=1))" and local == [2, 256, 64]
    assert z == "(Replicate(), Shard(dim=2))"
    assert child["hint_plain"] is False


def test_a_record_has_the_references_keys(child):
    rec = child["record"]
    assert rec["status"] == "ok", rec
    keys = ("arch shape mesh variant time status kind model_flops notes lower_s compile_s"
            " memory flops bytes_accessed collectives").split()
    assert set(keys) <= set(rec)
    assert rec["compile_s"] == 0.0 and rec["trips"] == 1
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes"}
    # 4 hops of AS at B = 8, each one all_reduce of [8, n_dst] and 4 flags
    assert set(rec["collectives"]) == {"all-reduce"}
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
