"""The port's error-feedback int8 all-reduce (``repro_torch.dist.compression``)
against the JAX package's, on the CPU.

The reference runs ``compressed_psum`` in a ``shard_map`` over 8 forced host
devices, in a subprocess (as ``tests/test_distributed.py`` runs it); the port
runs a gloo world of 8 ranks (``tests/test_torch_distributed.py``'s
launcher), the same per-rank gradients from the same seed, two steps each.
Each rank's residual equals the reference's bit for bit (the same float32
quantization: absmax scale, round half to even); the mean within rtol 1e-6
(the sums run in another order); and error feedback brings the two-step
mean closer to the exact one. The same world checks that a dim sharded over
two mesh axes is laid out in the axes' order (``dist.sharding.named``).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_distributed import RANK_PREAMBLE, _start_world, _wait  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = textwrap.dedent("""
    import json
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.compression import compressed_psum
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((8,), ("data",))
    rng = np.random.default_rng(0)
    gl = rng.normal(size=(8, 256)).astype(np.float32)  # per-device grads
    g_sh = jax.device_put(jnp.asarray(gl), jax.sharding.NamedSharding(mesh, P("data", None)))
    e0 = jax.device_put(jnp.zeros((8, 256)), jax.sharding.NamedSharding(mesh, P("data", None)))
    def body(g, e):
        m, er = compressed_psum(g[0], e[0], "data")
        return m, er[None]
    try:
        shard_map = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data", None), P("data", None)),
                          out_specs=(P(), P("data", None))))
    mean, err = f(g_sh, e0)
    mean2, err2 = f(g_sh, err)
    print("RESULT " + json.dumps({k: np.asarray(v).tolist() for k, v in
                                  dict(mean=mean, err=err, mean2=mean2, err2=err2).items()}))
""")

PORT_RANK = RANK_PREAMBLE + textwrap.dedent("""
    import json
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist.compression import compressed_psum
    from repro_torch.dist.sharding import EDGE, named
    gl = np.random.default_rng(0).normal(size=(8, 256)).astype(np.float32)
    g = torch.from_numpy(gl[rank])
    mean, err = compressed_psum(g, torch.zeros(256), None)
    mean2, err2 = compressed_psum(g, err, None)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    x = distribute_tensor(torch.arange(64.0), mesh, named(mesh, (EDGE,), (64,)))
    with open(out, "w") as f:
        json.dump({"mean": mean.tolist(), "err": err.tolist(), "mean2": mean2.tolist(),
                   "err2": err2.tolist(), "local": x.to_local().tolist()}, f)
""")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True, text=True,
                         env=env, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    line = [ln for ln in ref.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    want = {k: np.asarray(v, np.float32) for k, v in json.loads(line[7:]).items()}
    out = tmp_path_factory.mktemp("compression")
    _wait(_start_world(PORT_RANK, 8, out), "compressed_psum, a world of 8")
    ranks = [json.loads((out / f"rank{r}").read_text()) for r in range(8)]
    got = {k: np.asarray([r[k] for r in ranks], np.float32) for k in ("mean", "err", "mean2",
                                                                     "err2", "local")}
    return want, got


def test_residuals_equal_the_references_bit_for_bit(both):
    want, got = both
    assert np.array_equal(got["err"], want["err"])
    assert np.array_equal(got["err2"], want["err2"])


def test_means_equal_the_references(both):
    want, got = both
    for k in ("mean", "mean2"):
        for r in range(8):  # every rank holds the same mean
            np.testing.assert_allclose(got[k][r], want[k], rtol=1e-6, atol=1e-7)


def test_error_feedback_brings_the_mean_closer(both):
    """One step is within int8 tolerance of the exact mean; two steps'
    accumulated mean is closer to twice it (the reference test's bound)."""
    _, got = both
    true = np.random.default_rng(0).normal(size=(8, 256)).astype(np.float32).mean(0)
    rel = np.abs(got["mean"][0] - true).max() / np.abs(true).max()
    assert rel < 0.05
    rel2 = np.abs(got["mean"][0] + got["mean2"][0] - 2 * true).max() / np.abs(2 * true).max()
    assert rel2 < rel, (rel2, rel)


def test_a_dim_over_two_axes_is_sharded_in_their_order(both):
    """(data, model) on a 2×4 mesh: rank r = 4·data + model holds chunk r."""
    _, got = both
    assert got["local"].tolist() == np.arange(64.0).reshape(8, 8).tolist()
