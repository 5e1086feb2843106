"""The plain reference: each query of ``queries/`` worked out again from the
generated columns with plain PyTorch (dense frontiers, gathers and
``index_add_``), in float64 for the comparison that decides ``correct`` and
in a lower precision for its control. It imports nothing of the program
under test and nothing of the JAX package."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def query(name: str):
    """The module ``reference/<name>.py``: its ``run(graph, params, dtype,
    work=None)`` gives the ``[B, dom]`` dense rows of ``B`` bindings."""
    spec = importlib.util.spec_from_file_location(f"gqbench.reference.{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
