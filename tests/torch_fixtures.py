"""Fixtures shared by the port's test modules (``test_torch_*.py``), which
import what they use."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def lists_at_every_size():
    """'auto' builds its block list at every index size
    (``params.SKIP_MIN_BLOCKS`` = 0), as it did before that threshold: the
    tests' small graphs, all below it, keep running the list path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("repro_torch.kernels.params.SKIP_MIN_BLOCKS", 0)
        yield


class LiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """The peak of the bytes that tensors made inside the mode hold: a
    storage counts from the op that made it until the last tensor on it
    dies (storages of the inputs, such as the column store, never count)."""

    def __init__(self):
        super().__init__()
        self.storages: dict[int, list[int]] = {}
        self.now = self.peak = 0

    def _drop(self, key):
        held = self.storages.get(key)
        if held is not None:
            held[1] -= 1
            if held[1] == 0:
                self.now -= held[0]
                del self.storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import weakref

        from torch.utils._pytree import tree_flatten

        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr() for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st.data_ptr()
            if key in self.storages:
                self.storages[key][1] += 1
            elif key in ins:
                continue
            else:
                self.storages[key] = [st.nbytes(), 1]
                self.now += st.nbytes()
                self.peak = max(self.peak, self.now)
            weakref.finalize(t, self._drop, key)
        return out


def port_config(jcfg):
    """The port's TransformerConfig for the JAX package's ``jcfg``, field for
    field (dtypes mapped by name; the MoE config likewise)."""
    import dataclasses

    import numpy as np

    from repro_torch.models import transformer as PT

    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            v = getattr(torch, np.dtype(v).name)
        elif f.name == "moe" and v is not None:
            v = PT.MoEConfig(**dataclasses.asdict(v))
        kw[f.name] = v
    return PT.TransformerConfig(**kw)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for the module (the transformer family's tests):
    their small ops run faster on two than on every core, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
