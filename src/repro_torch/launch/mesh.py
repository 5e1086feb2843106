"""Device meshes for the distributed strategy, over ``torch.distributed``.

PyTorch runs a mesh as one process a rank, each running the same program
(SPMD), where the reference runs one controller over every device. Start the
ranks with ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE`` and
``MASTER_ADDR``/``MASTER_PORT``), or call
``torch.distributed.init_process_group`` with an address, a world size and a
rank yourself; then every rank builds the same mesh::

    torchrun --nproc-per-node 4 my_job.py          # in my_job.py:
    mesh = make_mesh((4,), ("data",))              # NCCL over four cards
    engine = GQFastEngine(db, mesh=mesh)           # every rank, same queries

``device_type`` is ``"cuda"`` by default and ``"cpu"`` (gloo) when asked
for, as the tests do. A ``"cuda"`` mesh without a card is an error. With no
process group yet and a mesh of one rank, the group is made here, in this
process (a world of one: what a single-process test or example needs); a
larger mesh with no group and no ``torchrun`` environment raises, as a mesh
with more ranks than the world has does (the reference raises the same way
with too few devices)."""
from __future__ import annotations

import os
from datetime import timedelta

#: The process group's timeout when this module makes the group: a rank that
#: stops taking part makes the others raise within it, not hang.
GROUP_TIMEOUT = timedelta(seconds=300)

#: The backend of a group this module makes, by the mesh's device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _check_device_type(device_type: str) -> None:
    import torch

    from ..robust.errors import ValidationError

    if device_type not in BACKENDS:
        raise ValidationError(
            f"mesh device_type must be one of {tuple(BACKENDS)}, got {device_type!r}",
            device_type=device_type,
        )
    if device_type == "cuda" and not torch.cuda.is_available():
        raise ValidationError(
            "a 'cuda' mesh was asked for but torch.cuda.is_available() is False;"
            " pass device_type='cpu' for a gloo mesh on the CPU",
            device_type=device_type,
        )


def _ensure_group(n: int, device_type: str) -> int:
    """The default group's world size, making a world of one in this process
    when there is no group, no ``torchrun`` environment and ``n`` is 1."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKENDS[device_type], timeout=GROUP_TIMEOUT)
        return dist.get_world_size()
    if n != 1:
        raise RuntimeError(
            f"mesh needs {n} ranks, found 1 (no process group) — start the ranks"
            f" with torchrun --nproc-per-node {n}, or init_process_group first"
        )
    dist.init_process_group(BACKENDS[device_type], store=dist.HashStore(), rank=0,
                            world_size=1, timeout=GROUP_TIMEOUT)
    return 1


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 … n−1 of
    the default group (``init_device_mesh``). Raises with fewer ranks than
    the mesh needs."""
    from torch.distributed.device_mesh import init_device_mesh

    _check_device_type(device_type)
    n = 1
    for s in shape:
        n *= s
    world = _ensure_group(n, device_type)
    if world < n:
        raise RuntimeError(f"mesh needs {n} ranks, found {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512; the pod axis is pure data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(axes: tuple[str, ...] = ("data",), shape: tuple[int, ...] | None = None,
                    device_type: str = "cuda"):
    """Development mesh over whatever ranks exist (tests, examples): a 1-D
    mesh over the whole world unless ``shape`` is given; a world of one made
    here when there is no group."""
    import torch.distributed as dist

    if shape is None:
        shape = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)),)
    return make_mesh(shape, axes, device_type)
