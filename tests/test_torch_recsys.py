"""DIN and the embedding substrate of the PyTorch port against the JAX
package, on the CPU: ``tests/test_recsys.py`` case for case on the port,
then both packages on the same weights (the reference's ``din_init``, carried
by ``convert.params_from_numpy``) and the same numpy batches.

Tolerances: DIN's logits, retrieval scores, loss and every gradient leaf
within 1e-4 of the reference's, relative to the largest value (float32; the
order of float adds differs); ``embedding_bag`` within rtol 1e-5 of the
reference's in every mode, empty bags included (0 under sum and mean,
``-inf`` under max, as the reference's ``segment_max`` gives). The batches
and the row-mod tables are equal exactly; the sharded lookup on a gloo world
of 4 equals a plain lookup.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need the [test] extra")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.recsys import make_din_batch as j_make_din_batch  # noqa: E402
from repro.models import din as JD  # noqa: E402
from repro.models.embedding import embedding_bag as j_embedding_bag  # noqa: E402
from repro.models.embedding import mod_shard_table as j_mod_shard_table  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.recsys import make_din_batch  # noqa: E402
from repro_torch.models import din as D  # noqa: E402
from repro_torch.models.din import (  # noqa: E402
    DINConfig,
    din_forward,
    din_init,
    din_loss,
    din_retrieval_scores,
)
from repro_torch.models.embedding import embedding_bag, mod_shard_table  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

from torch_fixtures import two_threads  # noqa: E402,F401 (autouse)

settings.register_profile("tr", deadline=None, max_examples=15)
settings.load_profile("tr")

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
CFG = DINConfig(n_items=5000, n_users=500, n_cates=50, seq_len=16)
JCFG = JD.DINConfig(n_items=5000, n_users=500, n_cates=50, seq_len=16)
BATCH_KW = dict(seq_len=16, n_items=5000, n_users=500)

# the reference's functions, compiled once each (eager JAX compiles op by op)
J_INIT = jax.jit(JD.din_init, static_argnums=0)
J_FORWARD = jax.jit(JD.din_forward, static_argnums=2)
J_RETRIEVAL = jax.jit(JD.din_retrieval_scores, static_argnums=2)
J_GRAD = jax.jit(jax.value_and_grad(JD.din_loss, has_aux=True), static_argnums=2)


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    """(reference params, the port's copy of them)."""
    jp = J_INIT(JCFG, jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def params():
    return din_init(CFG, torch.Generator().manual_seed(0))


def _batch(n: int, **kw) -> tuple[dict, dict]:
    """(the reference's batch, the port's) from the same seed."""
    return (j_make_din_batch(n, **BATCH_KW, **kw),
            make_din_batch(n, **BATCH_KW, **kw, device="cpu"))


# ---------------------------------------------------------------------------
# tests/test_recsys.py, case for case, on the port
# ---------------------------------------------------------------------------


def test_forward_shapes(params):
    b = make_din_batch(32, **BATCH_KW, device="cpu")
    with torch.no_grad():
        logits = din_forward(params, b, CFG)
    assert logits.shape == (32,)
    assert bool(torch.isfinite(logits).all())


def test_retrieval_consistent_with_forward(params):
    """Scoring candidate c for one user via retrieval == via pointwise forward."""
    rb = make_din_batch(1, **BATCH_KW, n_candidates=64, device="cpu")
    fwd_b = {
        "user": rb["user"].repeat(64),
        "hist_items": rb["hist_items"].repeat(64, 1),
        "hist_mask": rb["hist_mask"].repeat(64, 1),
        "cand_item": rb["cand_items"],
    }
    with torch.no_grad():
        scores = din_retrieval_scores(params, rb, CFG)
        fwd = din_forward(params, fwd_b, CFG)
    np.testing.assert_allclose(scores.numpy(), fwd.numpy(), rtol=1e-4, atol=1e-5)


def test_history_mask_effect(params):
    """Masked history positions must not influence the score."""
    b = make_din_batch(8, **BATCH_KW, device="cpu")
    rng = np.random.default_rng(0)
    hist = b["hist_items"].numpy().copy()
    mask = b["hist_mask"].numpy()
    hist[mask == 0] = rng.integers(0, 5000, (mask == 0).sum())
    b2 = dict(b, hist_items=torch.from_numpy(hist))
    with torch.no_grad():
        s1, s2 = din_forward(params, b, CFG), din_forward(params, b2, CFG)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-4, atol=1e-5)


def test_train_decreases_loss(params):
    oc = AdamWConfig(lr=1e-2, weight_decay=0.0)
    p, opt, losses = params, adamw_init(params, oc), []
    for step in range(12):
        b = make_din_batch(64, **BATCH_KW, seed=step % 3, device="cpu")
        (loss, _), g = value_and_grad(lambda q, bb: din_loss(q, bb, CFG), p, b)
        p, opt, _ = adamw_update(g, opt, p, oc)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


@given(st.integers(0, 2**31), st.integers(1, 12), st.sampled_from(["sum", "mean", "max"]))
def test_embedding_bag_property(seed, n_bags, mode):
    """The reference test's property, and the reference's values, empty bags
    included."""
    rng = np.random.default_rng(seed)
    V, D, n_ids = 50, 6, 40
    tb = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, n_ids).astype(np.int32)
    bags = np.sort(rng.integers(0, n_bags, n_ids)).astype(np.int32)
    out = embedding_bag(torch.from_numpy(tb), torch.from_numpy(ids), torch.from_numpy(bags),
                        n_bags, mode=mode).numpy()
    want = np.asarray(j_embedding_bag(jnp.asarray(tb), jnp.asarray(ids), jnp.asarray(bags),
                                      n_bags, mode=mode))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    for bg in range(n_bags):
        rows = tb[ids[bags == bg]]
        if rows.shape[0] == 0:
            if mode != "max":
                np.testing.assert_allclose(out[bg], 0.0, atol=1e-6)
            continue
        expect = {"sum": rows.sum(0), "mean": rows.mean(0), "max": rows.max(0)}[mode]
        np.testing.assert_allclose(out[bg], expect, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_empty_bags_and_weights_match_the_reference(mode):
    """Bags 1 and 4 are empty: 0 under sum and mean, -inf under max (the
    reference's; torch's own ``embedding_bag`` gives 0)."""
    rng = np.random.default_rng(4)
    tb = rng.normal(size=(20, 3)).astype(np.float32)
    ids = np.array([1, 2, 3, 4, 5, 6], np.int32)
    bags = np.array([0, 0, 2, 2, 3, 5], np.int32)
    w = np.array([0.5, 2.0, 1.0, 0.0, -1.5, 3.0], np.float32)
    for weights in (None, w):
        got = embedding_bag(torch.from_numpy(tb), torch.from_numpy(ids), torch.from_numpy(bags),
                            6, None if weights is None else torch.from_numpy(weights),
                            mode=mode).numpy()
        want = np.asarray(j_embedding_bag(jnp.asarray(tb), jnp.asarray(ids), jnp.asarray(bags),
                                          6, None if weights is None else jnp.asarray(weights),
                                          mode=mode))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        empty = want[[1, 4]]
        assert (np.isneginf(empty).all() if mode == "max" else (empty == 0).all())


def test_embedding_bag_weighted():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(20, 4)).astype(np.float32))
    ids = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    bags = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    w = torch.tensor([0.5, 2.0, 1.0, 0.0])
    out = embedding_bag(table, ids, bags, 2, weights=w).numpy()
    tb = table.numpy()
    np.testing.assert_allclose(out[0], 0.5 * tb[1] + 2.0 * tb[2], rtol=1e-5)
    np.testing.assert_allclose(out[1], tb[3], rtol=1e-5)


def test_mod_shard_table_roundtrip():
    rng = np.random.default_rng(2)
    tbl = rng.normal(size=(103, 8)).astype(np.float32)
    sh = mod_shard_table(tbl, 4)
    assert sh.shape == (4, 26, 8)
    for v in range(103):
        r, local = v % 4, v // 4
        np.testing.assert_array_equal(sh[r, local], tbl[v])
    want = j_mod_shard_table(tbl, 4)
    assert sh.dtype == want.dtype and np.array_equal(sh, want)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_make_din_batch_equals_the_reference(seed):
    for kw in ({"seed": seed}, {"seed": seed, "n_candidates": 300}):
        want, got = _batch(24 if "n_candidates" not in kw else 1, **kw)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].numpy().dtype == w.dtype and np.array_equal(got[k].numpy(), w), k


def test_forward_and_retrieval_match_the_reference(weights, monkeypatch):
    jp, pp = weights
    jb, pb = _batch(48, seed=1)
    with torch.no_grad():
        assert _rel(din_forward(pp, pb, CFG), J_FORWARD(jp, jb, JCFG)) <= TOL
    jr, pr = _batch(1, seed=2, n_candidates=1000)
    want = J_RETRIEVAL(jp, jr, JCFG)
    with torch.no_grad():
        assert _rel(din_retrieval_scores(pp, pr, CFG), want) <= TOL
        whole = din_retrieval_scores(pp, pr, CFG)
        # each candidate is scored alone, so any chunk gives its score (up to
        # the rounding of a product whose row count differs)
        monkeypatch.setattr(D, "RETRIEVAL_CHUNK", 333)
        assert _rel(din_retrieval_scores(pp, pr, CFG), whole.numpy()) <= 1e-6


def test_loss_and_every_gradient_match_the_reference(weights):
    jp, pp = weights
    jb, pb = _batch(64, seed=3)
    (jloss, _), jg = J_GRAD(jp, jb, JCFG)
    (ploss, _), pg = value_and_grad(lambda p, b: din_loss(p, b, CFG), pp, pb)
    assert abs(float(ploss) - float(jloss)) <= TOL * abs(float(jloss))
    want = {"/".join(str(k.key) if hasattr(k, "key") else f"[{k.idx}]" for k in path):
            np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(jg)}
    got = dict(tree_leaves_with_path(pg))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        if not np.abs(want[k]).max():  # cate_emb: no batch reads it
            assert not g.abs().max(), k
            continue
        assert _rel(g, want[k]) <= TOL, k


def test_parameter_tree_equals_the_reference_s(weights):
    jp, _ = weights
    want = [(np.asarray(v).shape, np.asarray(v).dtype.name) for v in jax.tree.leaves(jp)]
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for _, t in tree_leaves_with_path(din_init(CFG, torch.Generator().manual_seed(0)))]
    assert got == want
    assert CFG.param_count() == JCFG.param_count()
    assert CFG.active_param_count() == JCFG.active_param_count()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


RANK_CODE = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.embedding import mod_shard_table, sharded_embedding_lookup

    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    mesh = make_mesh((world,), ("model",), "cpu")
    rng = np.random.default_rng(0)
    tbl = rng.normal(size=(103, 5)).astype(np.float32)
    ids = torch.from_numpy(rng.integers(0, 103, (6, 7)).astype(np.int32))
    shard = torch.from_numpy(mod_shard_table(tbl, world)[rank]).requires_grad_(True)
    out = sharded_embedding_lookup(shard, ids, world, mesh)
    want = torch.from_numpy(tbl)[ids.long()]
    assert torch.equal(out, want), (out - want).abs().max()
    # the gradient reaches each row's owner only: a row's count of lookups
    out.sum().backward()
    counts = np.bincount(ids.numpy().ravel(), minlength=103)
    rows = np.arange(rank, 103, world)
    g = shard.grad.numpy()
    assert np.array_equal(g[: rows.shape[0], 0], world * counts[rows].astype(np.float32)), g[:, 0]
    dist.destroy_process_group()
    print("RANK_OK", rank)
""")


def test_sharded_embedding_lookup_on_a_gloo_world_of_4():
    """Rank r holds the rows v % 4 == r; every rank's lookup of the whole id
    batch equals the plain lookup, and the backward (the reference's psum:
    an all_reduce of the cotangent) reaches each row's owner."""
    port, world = _free_port(), 4
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(r), str(world), str(port)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = [p.communicate(timeout=120) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, err[-3000:]
