"""Checkpoints, the optimizer and the fault-tolerant training loop of the
PyTorch port, on the CPU: ``tests/test_checkpoint_train.py`` case for case,
plus the port against the JAX package: ``adamw_update`` over three steps
(float32 moments and params within 1e-6 of the reference's, relative to
each leaf's largest value; int8 moments' ``q`` equal except one quantum at a
rounding tie, where the two packages' float32 divisions may land on either
side; bf16 moments within two bf16 quanta, 2^-7, and the params that read
them within 1e-4),
``cosine_warmup`` and ``lm_batch``, and checkpoints that cross between the
packages key for key and byte for byte; then the GNN family and DIN through
``launch.train --device cpu`` (trained and resumed) and the loop (a
preempted run resumed bit for bit).
"""
import json
import os
import re
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.data.lm_data import lm_batch as jlm_batch  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.lm_data import lm_batch  # noqa: E402
from repro_torch.models.transformer import TransformerConfig, init_params, loss_fn  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_warmup,
)
from repro_torch.train.loop import TrainLoopConfig, train  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

from torch_fixtures import two_threads  # noqa: E402,F401 (autouse)

CFG = TransformerConfig("t", 2, 64, 4, 2, 128, 211, d_head=16, remat=False,
                        attn_kv_chunk=32)


@pytest.fixture()
def tmp(tmp_path):
    return str(tmp_path)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0))


def _lf(p, b):
    return loss_fn(p, b, CFG)


def _data(s):
    return lm_batch(s, 8, 32, 211, seed=1, device="cpu")


def test_save_restore_roundtrip(tmp):
    mgr = CheckpointManager(tmp, keep=2)
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4)), "d": [torch.zeros(2)]},
            "h": torch.arange(6.0).to(torch.bfloat16), "q": torch.arange(-4, 4, dtype=torch.int8)}
    mgr.save(5, tree)
    restored, meta = mgr.restore(tree_map(lambda x: torch.empty_like(x, device="meta"), tree))
    assert meta["step"] == 5
    for (k, a), (_, b) in zip(tree_leaves_with_path(tree), tree_leaves_with_path(restored)):
        assert b.dtype == a.dtype and b.device.type == "cpu" and torch.equal(a, b), k


def test_retention(tmp):
    mgr = CheckpointManager(tmp, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(3) * s})
    assert mgr.list_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_atomicity_no_partial_dirs(tmp):
    mgr = CheckpointManager(tmp, keep=3)
    mgr.save(1, {"x": torch.ones(3)})
    names = os.listdir(tmp)
    assert all(not n.startswith(".tmp_ckpt_") for n in names)


def test_restore_onto_a_device(tmp):
    """The reference restores under a mesh's shardings (its elastic case);
    the port places each leaf on its template's device, or on the one asked
    for."""
    mgr = CheckpointManager(tmp, keep=1)
    tree = {"w": torch.arange(16.0).reshape(4, 4), "n": torch.tensor(3, dtype=torch.int32)}
    mgr.save(1, tree)
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["w"], tree["w"]) and restored["n"].dtype == torch.int32
    meta_t = tree_map(lambda x: torch.empty_like(x, device="meta"), tree)
    restored, _ = mgr.restore(meta_t, device="cpu")
    assert restored["w"].device.type == "cpu" and torch.equal(restored["w"], tree["w"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(os.path.join(tmp, "empty")).restore(tree)


def test_loss_decreases(tmp, params):
    lc = TrainLoopConfig(total_steps=20, ckpt_every=100, ckpt_dir=tmp)
    oc = AdamWConfig(lr=cosine_warmup(3e-3, 3, 20), weight_decay=0.01)
    _, res = train(params, _lf, _data, lc, oc, resume=False)
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    assert res.step == 20


def test_preempt_resume_bit_identical(tmp, params):
    lc = TrainLoopConfig(total_steps=14, ckpt_every=100, ckpt_dir=tmp)
    oc = AdamWConfig(lr=1e-3)
    before = tree_map(torch.clone, params)
    pA, rA = train(params, _lf, _data, lc, oc, resume=False)
    shutil.rmtree(tmp)
    _, r1 = train(params, _lf, _data, lc, oc, resume=False, preempt_at=7)
    assert r1.preempted and r1.step == 7 and len(r1.history) == 7
    pB, r2 = train(params, _lf, _data, lc, oc, resume=True)
    assert r2.resumed_from == 7 and r2.step == 14
    assert [h["loss"] for h in r1.history + r2.history] == [h["loss"] for h in rA.history]
    for a, b in zip(tree_leaves(pA), tree_leaves(pB)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(before), tree_leaves(params)):  # the caller's tree
        assert torch.equal(a, b)


def test_int8_moments_match_fp32_convergence(tmp, params):
    lcs = TrainLoopConfig(total_steps=10, ckpt_every=100, ckpt_dir=tmp)
    losses = {}
    for name, oc in [("fp32", AdamWConfig(lr=3e-3)),
                     ("int8", AdamWConfig(lr=3e-3, quantize_moments=True))]:
        shutil.rmtree(tmp, ignore_errors=True)
        _, res = train(params, _lf, _data, lcs, oc, resume=False)
        losses[name] = res.history[-1]["loss"]
    assert abs(losses["int8"] - losses["fp32"]) / losses["fp32"] < 0.05


def test_straggler_telemetry_fields(tmp, params):
    lc = TrainLoopConfig(total_steps=5, ckpt_every=100, ckpt_dir=tmp)
    _, res = train(params, _lf, _data, lc, AdamWConfig(lr=1e-3), resume=False)
    for rec in res.history:
        assert set(rec) >= {"step", "loss", "grad_norm", "step_time", "straggler"}
        assert isinstance(rec["straggler"], bool) and rec["step_time"] > 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _tree_pair(seed: int, bf16: bool = False):
    """A small parameter-shaped tree (one leaf not a multiple of the int8
    block) as the reference's arrays and the port's tensors."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((37, 19)), "layers": {"a": rng.standard_normal((3, 300)),
                                                           "b": rng.standard_normal((5,))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    jt = jax.tree.map(jnp.asarray, tree)
    if bf16:
        jt = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jt)
    return jt, params_from_numpy(jax.tree.map(np.asarray, jt), "cpu")


def _keyed(jtree) -> dict:
    """The reference's leaves by the checkpoint's key path."""
    return {"/".join(str(k.key) if hasattr(k, "key") else f"[{k.idx}]" for k in path):
            np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(jtree)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("mode", ["f32", "int8", "bf16"])
def test_adamw_update_matches_reference_over_three_steps(mode):
    kw = {"f32": {}, "int8": {"quantize_moments": True},
          "bf16": {"moment_dtype": "bf16"}}[mode]
    jcfg = JA.AdamWConfig(lr=JA.cosine_warmup(1e-2, 2, 3), clip_norm=0.5,
                          **{k: (jnp.bfloat16 if v == "bf16" else v) for k, v in kw.items()})
    pcfg = AdamWConfig(lr=cosine_warmup(1e-2, 2, 3), clip_norm=0.5,
                       **{k: (torch.bfloat16 if v == "bf16" else v) for k, v in kw.items()})
    jp, pp = _tree_pair(0)
    js, ps = JA.adamw_init(jp, jcfg), adamw_init(pp, pcfg)
    for step in range(3):
        jg, pg = _tree_pair(10 + step)
        jp, js, jm = JA.adamw_update(jg, js, jp, jcfg)
        pp, ps, pm = adamw_update(pg, ps, pp, pcfg)
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
    assert int(ps["step"]) == int(js["step"]) == 3 and ps["step"].dtype == torch.int32
    want, got = _keyed((jp, js)), dict(tree_leaves_with_path((pp, ps)))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        w = want[key]
        if key.endswith("/q"):  # int8 codes: one quantum apart at a tie at most
            assert g.dtype == torch.int8 and np.abs(g.numpy().astype(int) - w.astype(int)).max() <= 1
            continue
        w = np.asarray(w, np.float32)
        # bf16 moments: two bf16 quanta (2^-7) apart at most, the params
        # that read them 1e-4
        tol = 1e-6 if mode != "bf16" else (2**-7 if "/m/" in key or "/v/" in key else 1e-4)
        tol *= max(np.abs(w).max(), 1e-30)
        assert np.abs(_np(g) - w).max() <= tol, key


def test_cosine_warmup_and_lm_batch_equal_reference():
    js, ps = JA.cosine_warmup(3e-3, 3, 20), cosine_warmup(3e-3, 3, 20)
    steps = np.arange(0, 25, dtype=np.int32)
    np.testing.assert_allclose(ps(torch.from_numpy(steps)).numpy(),
                               np.asarray(js(jnp.asarray(steps))), rtol=1e-6, atol=0)
    for step, shard in ((0, 0), (7, 0), (3, 2)):
        want = jlm_batch(step, 4, 33, 211, seed=5, shard=shard)
        got = lm_batch(step, 4, 33, 211, seed=5, shard=shard, device="cpu")
        assert got["tokens"].dtype == torch.int32
        assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        assert got["labels"] is got["tokens"]


def _opt_tree(quantize: bool, bf16: bool = False):
    """(reference tree, port tree): params and an AdamW state after one
    update, the reference's computed by the reference, carried across."""
    jcfg = JA.AdamWConfig(lr=1e-3, quantize_moments=quantize,
                          moment_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    jp, _ = _tree_pair(1, bf16)
    jg, _ = _tree_pair(2, bf16)
    jp, js, _ = JA.adamw_update(jg, JA.adamw_init(jp, jcfg), jp, jcfg)
    jtree = (jp, js)
    return jtree, params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _members(path: str) -> dict:
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_checkpoints_cross_between_packages(tmp, kind):
    """A checkpoint of the reference restores in the port, leaf for leaf; the
    port's of the same tree holds the same members, byte for byte, and
    (float32 and int8 trees: the reference cannot restore a bf16 leaf)
    restores in the reference."""
    jtree, ptree = _opt_tree(kind == "int8", kind == "bf16")
    jdir, pdir = os.path.join(tmp, "j"), os.path.join(tmp, "p")
    jpath = JCheckpointManager(jdir).save(3, jtree)
    ppath = CheckpointManager(pdir).save(3, ptree)
    assert _members(jpath) == _members(ppath)
    jmeta, pmeta = (json.load(open(os.path.join(p, "meta.json"))) for p in (jpath, ppath))
    assert jmeta["keys"] == pmeta["keys"] and jmeta["step"] == pmeta["step"] == 3
    if kind == "bf16":
        assert any(k.endswith("/m/w") for k in pmeta["keys"])
    template = tree_map(lambda x: torch.empty_like(x, device="meta"), ptree)
    got, meta = CheckpointManager(jdir).restore(template, device="cpu")
    assert meta["step"] == 3
    for (k, a), (_, b) in zip(tree_leaves_with_path(ptree), tree_leaves_with_path(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    if kind == "bf16":
        return
    back, _ = JCheckpointManager(pdir).restore(jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the GNN family and DIN through the loop and the launcher
# ---------------------------------------------------------------------------

GNN_DIN_IDS = ["mace", "egnn", "equiformer-v2", "schnet", "din"]
TRAIN_LINE = re.compile(r"^\[train\] (\S+): (\d+) steps, loss (\d+\.\d{4}) → (\d+\.\d{4})"
                        r"( \(resumed from (\d+)\))?$")


@pytest.mark.parametrize("aid", GNN_DIN_IDS)
def test_launch_train_trains_and_resumes_gnn_and_din(aid, tmp, capsys):
    """``launch.train --device cpu`` on each new arch: the reference
    launcher's batches, loss and line; a resume continues from the last
    checkpoint."""
    from repro_torch.launch import train as launch_train

    res = launch_train.main(["--arch", aid, "--steps", "3", "--device", "cpu",
                             "--ckpt-dir", tmp])
    line = capsys.readouterr().out.strip()
    m = TRAIN_LINE.match(line)
    assert m and m.group(1) == aid and m.group(2) == "3" and not m.group(5), line
    assert res.step == 3 and all(np.isfinite(h["loss"]) for h in res.history)
    assert sorted(os.listdir(os.path.join(tmp, aid))) == ["step_0000000003"]
    again = launch_train.main(["--arch", aid, "--steps", "5", "--device", "cpu",
                               "--ckpt-dir", tmp, "--resume"])
    m = TRAIN_LINE.match(capsys.readouterr().out.strip())
    assert m and m.group(2) == "2" and m.group(6) == "3"
    assert again.resumed_from == 3 and again.step == 5


@pytest.mark.parametrize("aid", ["mace", "din"])
def test_gnn_and_din_preempt_resume_bit_identical(aid, tmp):
    """The loop's resume on the new families: preempted at step 3 and resumed
    equals the uninterrupted run bit for bit (params and losses)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.graphs import make_molecule_batch
    from repro_torch.data.recsys import make_din_batch
    from repro_torch.models.din import din_init, din_loss
    from repro_torch.models.gnn.models import gnn_init, gnn_loss

    cfg = get_arch(aid).smoke_cfg
    gen = torch.Generator().manual_seed(0)
    if aid == "mace":
        p0, lf = gnn_init(cfg, gen), (lambda p, b: gnn_loss(p, b, cfg, 8))
        batches = [make_molecule_batch(8, 10, 24, seed=s, device="cpu").as_inputs()
                   for s in range(4)]

        def data(s):
            return batches[s % 4]
    else:
        p0, lf = din_init(cfg, gen), (lambda p, b: din_loss(p, b, cfg))

        def data(s):
            return make_din_batch(64, seq_len=cfg.seq_len, n_items=cfg.n_items,
                                  n_users=cfg.n_users, seed=s % 8, device="cpu")
    lc = TrainLoopConfig(total_steps=6, ckpt_every=100, ckpt_dir=tmp)
    pA, rA = train(p0, lf, data, lc, AdamWConfig(lr=1e-3), resume=False)
    shutil.rmtree(tmp)
    _, r1 = train(p0, lf, data, lc, AdamWConfig(lr=1e-3), resume=False, preempt_at=3)
    pB, r2 = train(p0, lf, data, lc, AdamWConfig(lr=1e-3), resume=True)
    assert r1.preempted and r2.resumed_from == 3
    assert [h["loss"] for h in r1.history + r2.history] == [h["loss"] for h in rA.history]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pA), tree_leaves(pB)))
