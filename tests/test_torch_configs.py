"""The architecture configs and the training launcher of the PyTorch port,
on the CPU, against the JAX package's: the registry's ids and cells, every
LM arch's full and smoke ``TransformerConfig`` field for field (dtypes mapped
by name), the GNN and DIN archs' configs, shapes and optimizers, shapes and
skip reasons, every arch's smoke, ``make_cell`` building each arch's cell on
a 1×1 dry-run mesh (a fake process group, in one child process) as the
reference's, the production mesh's refusal in a one-rank process, and
``python -m repro_torch.launch.train`` run and resumed as a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry  # noqa: E402
from repro.configs.din_arch import DIN_SHAPES as J_DIN_SHAPES  # noqa: E402
from repro.configs.gnn_family import GNN_SHAPES as J_GNN_SHAPES  # noqa: E402
from repro.configs.lm_family import LM_SHAPES as J_LM_SHAPES  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.din_arch import DIN_SHAPES  # noqa: E402
from repro_torch.configs.gnn_family import GNN_SHAPES  # noqa: E402
from repro_torch.configs.gqfast_arch import FULL, GQFAST  # noqa: E402
from repro_torch.configs.lm_family import LM_SHAPES  # noqa: E402

from torch_fixtures import port_config, two_threads  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
LM_IDS = [a for a, arch in jregistry.ARCHS.items() if arch.kind == "lm"]
GNN_DIN_IDS = [a for a, arch in jregistry.ARCHS.items() if arch.kind in ("gnn", "recsys")]
#: The cells built on a 1×1 dry-run mesh: each GNN/DIN arch's first shape, and
#: an LM and the GQ-Fast arch's.
CELL_IDS = [(a, jregistry.get_arch(a).shape_ids[0]) for a in GNN_DIN_IDS] \
    + [("qwen2.5-3b", "train_4k"), ("gqfast-pubmed", "as_b1")]

CELL_CHILD = textwrap.dedent('''
    import json, sys
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.registry import get_arch
    from repro_torch.dist.sharding import is_placements, named
    from repro_torch.launch.mesh import end_dry_run_mesh, make_dry_run_mesh
    from repro_torch.tree import tree_leaves

    mesh = make_dry_run_mesh("local_1x1")
    res = {}
    for aid, sid in json.loads(sys.argv[1]):
        cell = get_arch(aid).make_cell(sid, mesh)
        args = [tree_leaves(a) for a in cell.args]
        shs = [tree_leaves(s, is_leaf=is_placements) for s in cell.in_shardings]
        res[f"{aid}/{sid}"] = {
            "kind": cell.kind, "model_flops": cell.model_flops,
            "leaves": [len(a) for a in args], "aligned": [len(a) == len(s) and all(
                tuple(x.placements) == p if isinstance(x, DTensor) else p == named(mesh, ())
                for x, p in zip(a, s)) for a, s in zip(args, shs)],
            "meta": all(x.to_local().is_meta for a in args for x in a if isinstance(x, DTensor)),
        }
    end_dry_run_mesh()
    print("RESULT " + json.dumps(res))
''')


@pytest.fixture(scope="module")
def cells():
    proc = subprocess.run(
        [sys.executable, "-c", CELL_CHILD, json.dumps(CELL_IDS)], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _hold_cell(cells, aid: str, sid: str) -> None:
    """The port's cell (meta DTensors laid out as its placements, leaf for
    leaf) has the reference's kind and model_flops on a 1×1 mesh."""
    from repro.launch.mesh import make_mesh as jmake_mesh

    got = cells[f"{aid}/{sid}"]
    assert all(got["aligned"]) and got["meta"] and all(got["leaves"])
    ref = jregistry.get_arch(aid).make_cell(sid, jmake_mesh((1, 1), ("data", "model")))
    assert got["kind"] == ref.kind
    assert got["model_flops"] == pytest.approx(ref.model_flops, rel=1e-12)


def test_registry_ids_equal_the_reference():
    assert list(registry.ARCHS) == list(jregistry.ARCHS)
    assert registry.ASSIGNED == jregistry.ASSIGNED
    assert registry.all_cells() == jregistry.all_cells()
    assert sorted(LM_IDS) == sorted(a for a, x in registry.ARCHS.items() if x.kind == "lm")
    for aid, arch in registry.ARCHS.items():
        ref = jregistry.get_arch(aid)
        assert (arch.arch_id, arch.kind, arch.shape_ids) == (ref.arch_id, ref.kind, ref.shape_ids)
    with pytest.raises(KeyError):
        registry.get_arch("no-such-arch")


@pytest.mark.parametrize("aid", LM_IDS)
def test_lm_configs_equal_the_reference(aid):
    arch, ref = registry.get_arch(aid), jregistry.get_arch(aid)
    assert arch.full == port_config(ref.full)
    assert arch.smoke_cfg == port_config(ref.smoke_cfg)
    assert arch.full.param_count() == ref.full.param_count()
    ro = ref.opt
    assert (arch.opt.lr, arch.opt.b1, arch.opt.b2, arch.opt.weight_decay) == \
        (ro.lr, ro.b1, ro.b2, ro.weight_decay)
    assert arch.opt.moment_dtype == getattr(torch, np.dtype(ro.moment_dtype).name)
    for sid in arch.shape_ids:
        assert arch.skip_reason(sid) == ref.skip_reason(sid)
    assert arch.skip_reason("long_500k") and arch.skip_reason("train_4k") is None
    assert LM_SHAPES == J_LM_SHAPES


@pytest.mark.parametrize("aid", LM_IDS)
def test_lm_smoke_on_the_cpu(aid):
    out = registry.get_arch(aid).smoke(device="cpu")
    vocab = registry.get_arch(aid).smoke_cfg.vocab
    assert out["finite"] and out["logits_shape"] == (2, vocab)
    assert out["loss"] > 0 and out["grad_norm"] > 0


def test_gqfast_smoke_matches_the_oracle():
    from repro.configs.gqfast_arch import FULL as J_FULL
    from repro.configs.gqfast_arch import GQFAST_SHAPES as J_SHAPES
    from repro_torch.configs.gqfast_arch import GQFAST_SHAPES

    out = GQFAST.smoke(device="cpu")
    assert out["match"] and out["finite"] and out["nnz"] > 0
    assert FULL == J_FULL and GQFAST_SHAPES == J_SHAPES


@pytest.mark.parametrize("aid", GNN_DIN_IDS)
def test_gnn_and_recsys_archs_name_item_15b(aid, cells):
    """Item 15b (the GNN family and DIN) is ported: ``get_arch`` returns each
    of its archs, whose ``make_cell`` builds its first shape's cell as the
    reference's, and whose configs, shapes and optimizer are the
    reference's."""
    arch, ref = registry.get_arch(aid), jregistry.get_arch(aid)
    assert (arch.arch_id, arch.kind, arch.shape_ids) == (ref.arch_id, ref.kind, ref.shape_ids)
    _hold_cell(cells, aid, arch.shape_ids[0])
    if arch.kind == "gnn":
        assert dataclasses.asdict(arch.base) == dataclasses.asdict(ref.base)
        assert dataclasses.asdict(arch.smoke_cfg) == dataclasses.asdict(ref.smoke_cfg)
        for sid in arch.shape_ids:
            assert dataclasses.asdict(arch.cfg_for(sid)) == dataclasses.asdict(ref._cfg_for(sid))
    else:
        assert dataclasses.asdict(arch.full) == dataclasses.asdict(ref.full)
        assert dataclasses.asdict(arch.smoke_cfg) == dataclasses.asdict(ref.smoke_cfg)
        assert arch.full.param_count() == ref.full.param_count()
        assert arch.full.active_param_count() == ref.full.active_param_count()
    ro = ref.opt
    assert (arch.opt.lr, arch.opt.b1, arch.opt.b2, arch.opt.weight_decay, arch.opt.clip_norm) \
        == (ro.lr, ro.b1, ro.b2, ro.weight_decay, ro.clip_norm)
    for sid in arch.shape_ids:
        assert arch.skip_reason(sid) == ref.skip_reason(sid)
    assert GNN_SHAPES == J_GNN_SHAPES and DIN_SHAPES == J_DIN_SHAPES


@pytest.mark.parametrize("aid", GNN_DIN_IDS)
def test_gnn_and_din_smoke_on_the_cpu(aid):
    out = registry.get_arch(aid).smoke(device="cpu")
    assert out["finite"] and out["loss"] > 0
    if aid == "din":
        assert out["scores_shape"] == (256,)
    else:
        assert out["grad_norm"] > 0


def test_make_cell_names_item_15c(cells):
    """Item 15c is ported: ``make_cell`` builds a cell of each family."""
    for aid in ("qwen2.5-3b", "gqfast-pubmed", "mace", "din"):
        sid = "train_4k" if aid == "qwen2.5-3b" else registry.get_arch(aid).shape_ids[0]
        _hold_cell(cells, aid, sid)


def test_production_mesh_needs_its_ranks():
    """The reference's test_mesh_factory_requires_devices: a 512-rank mesh in
    a one-rank process raises and names 512."""
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def _port_train(*args, check=True):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        capture_output=True, text=True, check=check, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"},
    )


def test_launch_train_runs_and_resumes(tmp_path):
    first = _port_train("--arch", "llama3-8b", "--steps", "6", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path))
    assert "[train] llama3-8b: 6 steps, loss" in first.stdout, first.stdout + first.stderr
    assert sorted(os.listdir(tmp_path / "llama3-8b")) == ["step_0000000006"]
    again = _port_train("--arch", "llama3-8b", "--steps", "12", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path), "--resume")
    assert "6 steps" in again.stdout and "(resumed from 6)" in again.stdout, again.stdout
    assert "step_0000000012" in os.listdir(tmp_path / "llama3-8b")


def test_launch_train_refusals(tmp_path):
    from repro_torch.launch import train as launch_train

    assert launch_train.parse_args(["--arch", "llama3-8b"]).device == "cuda"
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", "gqfast-pubmed", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    assert "serving workload" in str(e.value.code)
    if torch.cuda.is_available():
        return
    proc = _port_train("--arch", "llama3-8b", "--steps", "1", "--ckpt-dir", str(tmp_path),
                       check=False)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_smoke_configs_cut_only_what_the_reference_cuts():
    """The smoke config keeps the full config's kind of model (bias, tying,
    MoE with a dense residual or not, param dtype) at the reference's cut."""
    for aid in LM_IDS:
        arch = registry.get_arch(aid)
        full, smoke = arch.full, arch.smoke_cfg
        kept = ("qkv_bias", "tie_embeddings", "param_dtype", "compute_dtype", "rope_theta")
        assert all(getattr(full, f) == getattr(smoke, f) for f in kept)
        assert (full.moe is None) == (smoke.moe is None)
        if full.moe is not None:
            assert smoke.moe == dataclasses.replace(
                full.moe, n_experts=8, top_k=min(full.moe.top_k, 2), d_ff_expert=64)
