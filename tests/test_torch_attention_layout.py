"""The transformer's chunked attention in its one layout (the state
[B, Hkv, Sq, G], K and V laid out [B, Hkv, Sk, hd] once a call) against the
JAX package's ``chunked_attention``, on the CPU, at grouped-query shapes
(G = H / Hkv up to 8), with KV chunks that divide the keys and chunks that
leave padding, causal and not, from a q offset with a valid-key count (the
cached attention's arguments), in float32 (1e-4 of the largest value: the
order of float adds differs) and bfloat16 (5e-2, tests/test_torch_models_lm.py's
tolerances), forward and backward; and the products copy nothing a chunk:
the copies a call makes do not grow with the number of KV chunks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

from torch_fixtures import two_threads  # noqa: E402,F401 (autouse)

TOL = {"f32": (torch.float32, jnp.float32, 1e-4), "bf16": (torch.bfloat16, jnp.bfloat16, 5e-2)}

#: (B, Sq, Sk, H, Hkv, hd, kv_chunk, q_offset, kv_valid): chunks dividing Sk
#: and leaving padding; G = 1, 2, 4, 8; prefill and decode shapes.
SHAPES = [
    (2, 32, 32, 8, 2, 16, 8, 0, None),     # G = 4, 4 chunks, no padding
    (2, 37, 37, 8, 1, 16, 8, 0, None),     # G = 8, the last chunk padded
    (1, 24, 24, 4, 4, 8, 24, 0, None),     # G = 1, one chunk
    (3, 19, 19, 6, 3, 16, 5, 0, None),     # G = 2, padded
    (2, 4, 40, 8, 2, 16, 16, 30, 34),      # decode-like: q at 30, 34 keys valid, padded
    (2, 1, 64, 16, 2, 8, 16, 47, 48),      # one query against a cache
]
JIT = jax.jit(JT.chunked_attention, static_argnames=("causal", "q_offset", "kv_valid",
                                                     "kv_chunk"))


def _inputs(B, Sq, Sk, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))


def _rel(got, want) -> float:
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", SHAPES, ids=[f"B{s[0]}-Sq{s[1]}-Sk{s[2]}-H{s[3]}-Hkv{s[4]}"
                                              f"-c{s[6]}" for s in SHAPES])
def test_chunked_attention_layout_matches_reference(shape, dtype, causal):
    B, Sq, Sk, H, Hkv, hd, chunk, q_offset, kv_valid = shape
    tdt, jdt, tol = TOL[dtype]
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, hd, sum(shape[:6]))
    kw = dict(causal=causal, q_offset=q_offset, kv_valid=kv_valid, kv_chunk=chunk)
    want = JIT(*(jnp.asarray(a, jdt) for a in (q, k, v)), **kw)
    got = PT.chunked_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    assert got.shape == (B, Sq, H, hd) and got.dtype == tdt
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("shape", SHAPES[:4], ids=["G4", "G8-padded", "G1", "G2-padded"])
def test_chunked_attention_gradients_match_reference(shape):
    """d(Σ out · r)/d(q, k, v) in float32 against ``jax.grad`` of the
    reference, causal, with and without the chunk padding."""
    B, Sq, Sk, H, Hkv, hd, chunk, _, _ = shape
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, hd, 7 + sum(shape[:6]))
    r = np.random.default_rng(3).standard_normal((B, Sq, H, hd)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(JT.chunked_attention(q, k, v, causal=True, kv_chunk=chunk) * r)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (PT.chunked_attention(*ts, causal=True, kv_chunk=chunk) * torch.from_numpy(r)).sum().backward()
    for t, w in zip(ts, want):
        assert _rel(t.grad, w) <= 1e-4


class _Copies(TorchDispatchMode):
    """Counts the ops that copy a tensor's elements into a new layout (a
    reshape or matmul that cannot view its operand clones it); the dtype
    casts of the online softmax are not layout copies."""

    COPIES = {"clone", "copy_", "constant_pad_nd"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.COPIES:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_copies_nothing_a_chunk(dtype):
    """The forward's layout copies (q's once, K's and V's once, the
    output's) are as many with 8 KV chunks as with 1: no product copies an
    operand a chunk."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(2, 64, 64, 8, 2, 16, 1))
    counts = []
    for chunk in (64, 8):
        mode = _Copies()
        with mode:
            PT.chunked_attention(q, k, v, causal=True, kv_chunk=chunk)
        counts.append(mode.n)
    assert counts[0] == counts[1], counts
