"""The transformer family of the PyTorch port against the JAX package, on the
CPU: ``tests/test_models_lm.py`` case for case, both packages on the same
weights (the reference's ``init_params``, carried by
``convert.params_from_numpy``) and the same seeded numpy inputs.

Tolerances, each a bound on max|port − reference| over max|reference|:
  * float32 compute: 1e-4 (the order of float adds differs);
  * bfloat16 compute (the configs' default), dense config: 5e-2 (bf16 keeps
    8 bits, each product and sum rounds to it, and the two packages round at
    other points of the same ops). The MoE config is held under float32
    only: under bf16 a router input one rounding apart can send a token to
    another expert, which no tolerance on the output bounds.
Routing, capacity slots, greedy tokens and parameter counts are integers and
are equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.common import apply_rope, count_params, dense_init  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

from torch_fixtures import port_config, two_threads  # noqa: E402,F401 (autouse)

F32_TOL = 1e-4
BF16_TOL = 5e-2

CFG = JT.TransformerConfig("t", 2, 64, 4, 2, 128, 97, d_head=16, qkv_bias=True,
                           remat=False, attn_kv_chunk=16)
MCFG = JT.TransformerConfig("tm", 2, 64, 4, 4, 96, 97, d_head=16, remat=False,
                            attn_kv_chunk=16,
                            moe=JT.MoEConfig(8, 2, 32, dense_residual=True))
CONFIGS = {"dense": CFG, "moe": MCFG}
COMPUTE = {"f32": (jnp.float32, F32_TOL), "bf16": (jnp.bfloat16, BF16_TOL)}

# the reference's functions, compiled once each (eager JAX compiles op by op)
J_FORWARD = jax.jit(JT.forward, static_argnums=2)
J_LOSS = jax.jit(JT.loss_fn, static_argnums=2)
J_PREFILL = jax.jit(JT.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JT.decode_step, static_argnums=4)
J_MOE = jax.jit(JT.moe_ffn, static_argnums=2)
J_INIT = jax.jit(JT.init_params, static_argnums=0)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(seed: int, shape, vocab: int = 97) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _model(name: str, compute: str, key: int = 0):
    """(JAX config, port config, JAX params, port params) for one config at
    one compute dtype, the port's weights carried from the reference's."""
    jcfg = dataclasses.replace(CONFIGS[name], compute_dtype=COMPUTE[compute][0])
    jp = _init(name, key)
    return jcfg, port_config(jcfg), jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def _init(name: str, key: int):
    return J_INIT(CONFIGS[name], jax.random.key(key))


@pytest.mark.parametrize("S,kv_chunk,causal", [(37, 8, True), (64, 64, True), (16, 4, False)])
def test_chunked_attention_matches_reference(S, kv_chunk, causal):
    B, H, Hkv, hd = 2, 4, 2, 16
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32) for h in (H, Hkv, Hkv))
    want = JT.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, kv_chunk=kv_chunk)
    got = PT.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                               kv_chunk=kv_chunk)
    assert _rel(got, want) <= F32_TOL
    # and the full softmax oracle (the reference test's)
    kr, vr = np.repeat(k, H // Hkv, 2), np.repeat(v, H // Hkv, 2)
    s = np.einsum("bshk,bthk->bhst", q, kr) / np.sqrt(hd)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool))[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    oracle = np.einsum("bhst,bthk->bshk", p / p.sum(-1, keepdims=True), vr)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name,compute", [("dense", "f32"), ("dense", "bf16"), ("moe", "f32")])
def test_forward_and_loss_match_reference(name, compute):
    jcfg, pcfg, jp, pp = _model(name, compute)
    tol = COMPUTE[compute][1]
    toks = _tokens(1, (2, 33))
    jl, ja = J_FORWARD(jp, jnp.asarray(toks), jcfg)
    pl, pa = PT.forward(pp, torch.from_numpy(toks), pcfg)
    assert pl.dtype == pcfg.compute_dtype and _rel(pl, jl) <= tol
    if name == "moe":
        assert float(pa) > 0 and abs(float(pa) - float(ja)) <= tol * float(ja)
    batch = {"tokens": toks, "labels": toks}
    jloss, jm = J_LOSS(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    ploss, pm = PT.loss_fn(pp, {k: torch.from_numpy(v) for k, v in batch.items()}, pcfg)
    assert abs(float(ploss) - float(jloss)) <= tol * float(jloss)
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= tol * float(jm["loss"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gradient_of_every_leaf_matches_reference(name):
    jcfg, pcfg, jp, pp = _model(name, "f32")
    toks = _tokens(2, (2, 24))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    (ploss, _), pg = value_and_grad(lambda p, b: PT.loss_fn(p, b, pcfg), pp, pb)
    assert abs(float(ploss) - float(jloss)) <= F32_TOL * float(jloss)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): g
            for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    got = dict(tree_leaves_with_path(pg))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        assert g.dtype == torch.float32 and _rel(g, want[key]) <= F32_TOL, key


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_reference_and_forward(name):
    jcfg, pcfg, jp, pp = _model(name, "f32")
    toks = _tokens(3, (2, 33))
    jl, jcache, jS = J_PREFILL(jp, jnp.asarray(toks), jcfg, 64)
    pl, pcache, pS = PT.prefill(pp, torch.from_numpy(toks), pcfg, 64)
    assert pS == int(jS) == 33 and _rel(pl, jl) <= F32_TOL
    for k in ("k", "v"):
        assert _rel(pcache[k], jcache[k]) <= F32_TOL
    f_logits, _ = PT.forward(pp, torch.from_numpy(toks), pcfg)
    assert _rel(pl, f_logits[:, -1].detach()) <= F32_TOL
    nt = torch.argmax(pl, -1)
    assert np.array_equal(nt.numpy(), np.asarray(jnp.argmax(jl, -1)))
    jd, _ = J_DECODE(jp, jcache, jnp.asarray(nt.numpy(), jnp.int32), jnp.int32(33), jcfg)
    pd, _ = PT.decode_step(pp, pcache, nt, 33, pcfg)
    assert _rel(pd, jd) <= F32_TOL
    if name == "moe":
        return  # a step of 2 tokens drops other entries than a forward of 68
    ext = torch.cat([torch.from_numpy(toks), nt[:, None].int()], 1)
    f2, _ = PT.forward(pp, ext, pcfg)
    assert _rel(pd, f2[:, -1].detach()) <= F32_TOL


@pytest.mark.parametrize("compute", list(COMPUTE))
def test_multistep_decode_is_greedy_forward(compute):
    """Greedy decode equals greedy by repeated full forward (the reference
    test's case at the config's bf16 compute), and under float32 the tokens
    equal the reference's greedy decode."""
    jcfg, pcfg, jp, pp = _model("dense", compute)
    toks = _tokens(4, (2, 10))
    logits, cache, _ = PT.prefill(pp, torch.from_numpy(toks), pcfg, 32)
    cur = torch.argmax(logits, -1)
    seq = [cur]
    for i in range(3):
        logits, cache = PT.decode_step(pp, cache, cur, 10 + i, pcfg)
        cur = torch.argmax(logits, -1)
        seq.append(cur)
    full = torch.from_numpy(toks)
    for i in range(4):
        fl, _ = PT.forward(pp, full, pcfg)
        nxt = torch.argmax(fl[:, -1], -1)
        assert torch.equal(nxt, seq[i]), f"step {i}"
        full = torch.cat([full, nxt[:, None].int()], 1)
    if compute != "f32":
        return
    jl, jc, _ = J_PREFILL(jp, jnp.asarray(toks), jcfg, 32)
    jcur = jnp.argmax(jl, -1).astype(jnp.int32)
    jseq = [jcur]
    for i in range(3):
        jl, jc = J_DECODE(jp, jc, jcur, jnp.int32(10 + i), jcfg)
        jcur = jnp.argmax(jl, -1).astype(jnp.int32)
        jseq.append(jcur)
    assert np.array_equal(torch.stack(seq).numpy(), np.asarray(jnp.stack(jseq)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_remat_equals_no_remat(name):
    """Remat recomputes each layer in the backward: the same loss and
    gradients, bit for bit (remat off is held to the reference above)."""
    _, pcfg, _, pp = _model(name, "f32")
    toks = torch.from_numpy(_tokens(5, (2, 20)))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, remat=remat)
        out[remat] = value_and_grad(lambda p, b: PT.loss_fn(p, b, cfg), pp, batch)
    (l0, _), g0 = out[False]
    (l1, _), g1 = out[True]
    assert torch.equal(l0, l1)
    for (k, a), (_, b) in zip(tree_leaves_with_path(g0), tree_leaves_with_path(g1)):
        assert torch.equal(a, b), k


def _moe_layer(jcfg, seed: int = 0):
    """One MoE layer's weights (what ``moe_ffn`` reads) drawn like
    ``init_params``', as the reference's arrays and the port's tensors."""
    rng = np.random.default_rng(seed)
    d, m = jcfg.d_model, jcfg.moe
    shapes = {"router": (d, m.n_experts), "e_gate": (m.n_experts, d, m.d_ff_expert),
              "e_up": (m.n_experts, d, m.d_ff_expert), "e_down": (m.n_experts, m.d_ff_expert, d)}
    lp = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
          for k, s in shapes.items()}
    return {k: jnp.asarray(v) for k, v in lp.items()}, params_from_numpy(lp, "cpu")


@pytest.mark.parametrize("case", ["aux", "overflow", "identical"])
def test_moe_ffn_matches_reference(case):
    """The reference's MoE cases: aux active, capacity overflow drops
    cleanly, identical tokens get identical outputs; each against the
    reference's ``moe_ffn`` on the same weights and tokens."""
    if case == "aux":
        jcfg, x = MCFG, np.random.default_rng(6).standard_normal((64, 64))
    elif case == "overflow":
        jcfg = JT.TransformerConfig("o", 1, 32, 2, 2, 32, 31, d_head=16, remat=False,
                                    moe=JT.MoEConfig(4, 2, 16, capacity_factor=0.25))
        x = np.random.default_rng(7).standard_normal((64, 32))
    else:
        jcfg = JT.TransformerConfig("p", 1, 32, 2, 2, 32, 31, d_head=16, remat=False,
                                    moe=JT.MoEConfig(4, 1, 16, capacity_factor=4.0))
        x = np.tile(np.random.default_rng(8).standard_normal((1, 32)), (16, 1))
    x = x.astype(np.float32)
    jlp, plp = _moe_layer(jcfg)
    pcfg = port_config(jcfg)
    jy, jaux = J_MOE(jlp, jnp.asarray(x), jcfg)
    py, paux = PT.moe_ffn(plp, torch.from_numpy(x), pcfg)
    assert py.shape == x.shape and bool(torch.isfinite(py).all())
    assert _rel(py, jy) <= F32_TOL and abs(float(paux) - float(jaux)) <= F32_TOL * float(jaux)
    r = PT.moe_route(plp, torch.from_numpy(x), pcfg)
    if case == "aux":
        assert float(paux) > 0
    if case == "overflow":
        assert not bool(r["keep"].all()) and int(r["slot"].max()) == r["C"]
    if case == "identical":
        np.testing.assert_allclose((py - py[0]).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (2, 0.25), (1, 4.0)])
def test_moe_routing_equals_reference(top_k, cf):
    """topi, keep and the capacity slots, integer for integer, against the
    reference's routing steps (``moe_ffn``'s first lines, on its arrays)."""
    jcfg = JT.TransformerConfig("r", 1, 32, 2, 2, 32, 31, d_head=16, remat=False,
                                moe=JT.MoEConfig(8, top_k, 16, capacity_factor=cf))
    jlp, plp = _moe_layer(jcfg, 3)
    x = np.random.default_rng(9).standard_normal((96, 32)).astype(np.float32)
    E, K, T = 8, top_k, 96
    probs = jax.nn.softmax(jnp.asarray(x) @ jlp["router"], axis=-1)
    _, topi = jax.lax.top_k(probs, K)
    C = max(8, int(-(-T * K * cf // E)))
    flat_e = topi.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - onehot, flat_e[:, None], 1)[:, 0]
    r = PT.moe_route(plp, torch.from_numpy(x), port_config(jcfg))
    assert r["C"] == C
    assert np.array_equal(r["topi"].numpy(), np.asarray(topi))
    assert np.array_equal(r["keep"].numpy(), np.asarray(pos < C))
    assert np.array_equal(r["slot"].numpy(), np.asarray(jnp.where(pos < C, pos, C)))


def test_param_count_and_pad_heads():
    from repro.configs.lm_archs import ARCTIC_480B, OLMOE_1B_7B, QWEN25_3B

    for name in CONFIGS:
        jcfg, pcfg, jp, pp = _model(name, "f32")
        actual = sum(x.size for x in jax.tree.leaves(jp))
        assert count_params(pp) == actual
        assert pcfg.param_count() == jcfg.param_count()
        assert abs(actual - pcfg.param_count()) / actual < 0.02  # biases excluded
        gen = torch.Generator().manual_seed(0)
        mine = PT.init_params(pcfg, gen)
        assert {k: (tuple(v.shape), v.dtype) for k, v in tree_leaves_with_path(mine)} == \
            {k: (tuple(v.shape), v.dtype) for k, v in tree_leaves_with_path(pp)}
    for arch in (QWEN25_3B, ARCTIC_480B, OLMOE_1B_7B):
        pcfg = port_config(arch.full)
        assert pcfg.param_count() == arch.full.param_count()
        assert pcfg.active_param_count() == arch.full.active_param_count()
        assert pcfg.n_rep == arch.full.n_rep
    cfg = PT.TransformerConfig("x", 1, 64, 56, 8, 64, 100, d_head=16)
    padded = cfg.pad_heads(16)
    assert padded.n_heads == 64 and padded.n_kv_heads == 8
    assert cfg.pad_heads(8).n_heads == 56
    assert JAdamWConfig().lr == 3e-4  # the optimizer default the configs inherit


def test_dense_init_scales_by_fan_in():
    gen = torch.Generator().manual_seed(0)
    for shape, axis in (((256, 64), -2), ((4, 512, 8), -2), ((300, 128), -1),
                        ((2, 128, 4, 16), -3)):
        w = dense_init(gen, shape, axis)
        assert w.shape == shape and w.dtype == torch.float32
        assert abs(float(w.std()) * np.sqrt(shape[axis]) - 1.0) < 0.05
    assert dense_init(gen, (8, 8), dtype=torch.bfloat16).dtype == torch.bfloat16


def test_rope_matches_reference_at_long_positions():
    from repro.models.common import apply_rope as japply_rope

    x = np.random.default_rng(10).standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 4095, 32767, 131071]] * 2, np.int32)
    for theta in (10000.0, 500000.0, 1_000_000.0):
        want = japply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        assert _rel(got, want) <= F32_TOL
