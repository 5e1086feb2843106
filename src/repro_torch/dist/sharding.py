"""Sharding-spec derivation for the arch-config families (DESIGN.md §6), on
DTensor.

The JAX package's rule tables (``repro.dist.sharding``), copied verbatim:
one table per family maps parameter/batch leaf *names* to specs on the
production mesh axes — ``pod`` (data parallel across pods), ``data`` (FSDP)
and ``model`` (tensor parallel). A spec is a plain tuple with one entry a
tensor dim: ``None`` (not sharded), an axis name, or a tuple of axis names
(the dim sharded over each, in the tuple's order) — a ``PartitionSpec``'s
entries. Every spec goes through :func:`_filter` before it becomes
placements, which (a) drops axis names the mesh doesn't have and (b) drops
an axis whenever it doesn't divide the dimension, so the same rule table
serves a 1×1 mesh, the 256-rank pod and the 512-rank multi-pod mesh.

:func:`named` turns a filtered spec into DTensor placements over a
``DeviceMesh``: for each mesh dim, ``Shard(i)`` where tensor dim ``i``
names it, else ``Replicate()``. A tuple of axes on one dim must list them in
the mesh's order (``FSDP`` and ``EDGE`` do), since DTensor shards a dim over
several mesh dims in mesh-dim order.
"""
from __future__ import annotations

from ..tree import map_with_path

FSDP = ("pod", "data")  # fully-sharded data-parallel axes
EDGE = ("data", "model")  # flat edge/candidate axes (counts padded to 512)


def _axes(mesh) -> tuple[tuple[str, ...], dict[str, int]]:
    names = tuple(mesh.mesh_dim_names or ())
    return names, dict(zip(names, tuple(mesh.shape)))


def _filter(mesh, spec, shape=None) -> tuple:
    """Adapt a spec to ``mesh``: drop absent axis names, collapse
    single-axis tuples, and (when ``shape`` is given) drop any axis whose
    total size doesn't divide the dimension. The reference's ``_filter``
    entry for entry, as a tuple."""
    names, sizes = _axes(mesh)
    out = []
    for i, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        axes = tuple(a for a in ((s,) if isinstance(s, str) else s) if a in names)
        if not axes:
            out.append(None)
            continue
        n = 1
        for a in axes:
            n *= sizes[a]
        if shape is not None and shape[i] % n != 0:
            out.append(None)
            continue
        out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def placements(mesh, spec) -> tuple:
    """DTensor placements of an already filtered ``spec`` on ``mesh``. A
    mesh dim of size 1 replicates (sharding over one rank is holding the
    whole), which keeps DTensor on its simple paths."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = _axes(mesh)
    out = [Replicate()] * len(names)
    for i, s in enumerate(spec):
        if s is None:
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {i} lists mesh axes {axes} out of the mesh's"
                             f" order {names}; DTensor shards a dim in mesh-dim order")
        for d in order:
            if sizes[names[d]] > 1:
                out[d] = Shard(i)
    return tuple(out)


def named(mesh, spec, shape=None) -> tuple:
    """The placements of ``spec`` filtered to ``mesh`` (and ``shape``)."""
    return placements(mesh, _filter(mesh, spec, shape))


def replicated(tree, mesh):
    return map_with_path(lambda _p, _x: named(mesh, ()), tree)


def _leaf_name(path: str) -> str:
    """Last dict key on a tree key path (param name; moments mirror the
    params, so 'm'/'v' wrappers and ``[i]`` sequence indices are skipped by
    taking the last key)."""
    name = ""
    for k in path.split("/"):
        if k and not k.startswith("["):
            name = k
    return name


def leaf_spec(spec_fn, path: str, shape) -> tuple:
    """The unfiltered spec ``spec_fn`` gives the leaf at ``path``, padded or
    cut to the leaf's rank."""
    spec = tuple(spec_fn(_leaf_name(path), shape))
    return (spec + (None,) * (len(shape) - len(spec)))[: len(shape)]


def filtered_specs(tree, mesh, spec_fn):
    """The tree of each leaf's spec from ``spec_fn(leaf name, shape)``,
    filtered to ``mesh`` and the leaf's shape (what the reference's
    ``NamedSharding``s hold)."""
    return map_with_path(
        lambda path, leaf: _filter(mesh, leaf_spec(spec_fn, path, leaf.shape), leaf.shape), tree)


def _shard_by_name(tree, mesh, spec_fn):
    return map_with_path(
        lambda path, leaf: named(mesh, leaf_spec(spec_fn, path, leaf.shape), leaf.shape), tree)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

# name → spec over the *parameter* dims; layer-stacked leaves carry a leading
# (L, …) dim which is never sharded (the layer loop runs over it)
_LM_RULES = {
    # attention: FSDP on d_model, tensor parallel on (kv-)heads
    "wq": (None, FSDP, "model", None),
    "wk": (None, FSDP, "model", None),
    "wv": (None, FSDP, "model", None),
    "wo": (None, "model", None, FSDP),
    "bq": (None, "model", None),
    "bk": (None, "model", None),
    "bv": (None, "model", None),
    # dense mlp: tensor parallel on d_ff
    "w_gate": (None, FSDP, "model"),
    "w_up": (None, FSDP, "model"),
    "w_down": (None, "model", FSDP),
    # MoE: experts over model, FSDP inside the expert
    "router": (None, FSDP, None),
    "e_gate": (None, "model", FSDP, None),
    "e_up": (None, "model", FSDP, None),
    "e_down": (None, "model", None, FSDP),
    # embeddings / head: vocab over FSDP, model over d
    "embed": (FSDP, "model"),
    "lm_head": (FSDP, "model"),
    # norms
    "ln1": (None, FSDP),
    "ln2": (None, FSDP),
    "ln_f": (FSDP,),
    # int8-blocked optimizer moments ([nb, 256] + per-block scales)
    "q": (EDGE, None),
    "s": (EDGE,),
}


def lm_param_spec(path: str, shape, mesh=None, n_kv_heads: int = 1) -> tuple:
    """Unfiltered spec for one LM parameter; ``path`` is '/'-joined tree keys.
    ``n_kv_heads`` documents the head-dim divisibility contract — the actual
    check happens in :func:`_filter` against the concrete shape."""
    name = path.split("/")[-1]
    spec = _LM_RULES.get(name, (None,) * len(shape))
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    return full[: len(shape)]


def lm_state_shardings(tree, mesh, n_kv_heads: int = 1):
    """Placements for params or (params, opt) trees: moments mirror the
    param layout (leaf names repeat under 'm'/'v'); scalars replicate."""
    return _shard_by_name(
        tree, mesh, lambda name, shape: lm_param_spec(name, shape, mesh, n_kv_heads)
    )


def lm_batch_spec(name, shape) -> tuple:
    return (FSDP,)


def lm_batch_shardings(tree, mesh):
    """Token batches: batch dim over (pod, data), sequence dim replicated."""
    return _shard_by_name(tree, mesh, lm_batch_spec)


def kv_cache_spec(name, shape) -> tuple:
    return (None, FSDP, None, "model", None)


def kv_cache_shardings(cache, mesh, n_kv_heads: int = 1):
    """KV cache [L, B, S, H_kv, hd]: batch over (pod, data), heads over model
    (dropped by the filter when model ∤ H_kv — the GQA small-head case)."""
    return _shard_by_name(cache, mesh, kv_cache_spec)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def gnn_input_spec(name, shape) -> tuple:
    return (EDGE,) if name.startswith("edge_") else (("data",),)


def gnn_input_shardings(batch, mesh):
    """Edge arrays (padded to 512) shard over data×model; node/graph arrays
    over data when divisible, else replicate (the filter decides)."""
    return _shard_by_name(batch, mesh, gnn_input_spec)


# ---------------------------------------------------------------------------
# Recsys family
# ---------------------------------------------------------------------------


def recsys_state_spec(name, shape) -> tuple:
    if name.endswith("_emb"):
        return ("model", None)
    if name == "q":
        return (EDGE, None)
    if name == "s":
        return (EDGE,)
    return ()


def recsys_state_shardings(tree, mesh):
    """Embedding tables row-sharded over model (the big-vocab lever); the tiny
    MLP towers and their moments replicate."""
    return _shard_by_name(tree, mesh, recsys_state_spec)


def recsys_batch_spec(name, shape) -> tuple:
    return (EDGE,) if name == "cand_items" else (FSDP,)


def recsys_batch_shardings(batch, mesh):
    """Request batches over (pod, data); the flat retrieval candidate array
    (padded to 512) over data×model."""
    return _shard_by_name(batch, mesh, recsys_batch_spec)


# ---------------------------------------------------------------------------
# Abstract (meta) DTensors
# ---------------------------------------------------------------------------


def is_placements(x) -> bool:
    """Whether ``x`` is a leaf of a placement tree (a tuple of DTensor
    placements, one a mesh dim)."""
    from torch.distributed.tensor import Placement

    return isinstance(x, tuple) and bool(x) and all(isinstance(p, Placement) for p in x)


def local_shape(mesh, shape, placements_) -> tuple:
    """One rank's shard shape of a ``shape`` tensor laid out as
    ``placements_`` (every placement here divides its dim: :func:`_filter`
    saw to it)."""
    from torch.distributed.tensor import Shard

    local = list(shape)
    for size, p in zip(tuple(mesh.shape), placements_):
        if isinstance(p, Shard):
            local[p.dim] //= size
    return tuple(local)


def from_local(local, mesh, placements_, shape):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local``."""
    import torch
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements_, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def distribute_meta(x, mesh, placements_):
    """A DTensor of ``x``'s global shape and dtype on ``mesh`` with
    ``placements_``, its local shard a meta tensor: nothing is allocated."""
    import torch

    local = torch.empty(local_shape(mesh, x.shape, placements_), dtype=x.dtype, device="meta")
    return from_local(local, mesh, placements_, tuple(x.shape))


def distribute_tree(tree, shardings, mesh):
    """:func:`distribute_meta` over a tree of meta tensors and the matching
    placement tree; non-tensor leaves stay as they are."""
    import torch

    from ..tree import tree_map

    return tree_map(lambda x, pl: distribute_meta(x, mesh, pl)
                    if isinstance(x, torch.Tensor) else x, tree, shardings)
