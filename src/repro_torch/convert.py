"""Carry a database's device state, or a model's weights, across from the
JAX package.

The counterpart of loading weights: :func:`device_db_from_numpy` takes the
arrays of a reference ``DeviceDB``, as numpy, and builds the port's
:class:`~repro_torch.core.executor.DeviceDB` holding the same integers, floats,
packed words and dictionaries on ``device``. Nothing here imports the
reference; the caller turns its arrays into numpy first.

``arrays`` layout::

    {
      "indexes": {
        (table, key): {
          "indptr": int[h+1], "src_ids": int[E], "degrees": int[h],
          "dst_ids": column, "measures": {name: column, ...},
        },
        ...
      },
      "entity_attrs": {(entity, attr): float[dom], ...},
    }

where a column is a decoded array (dense) or a dict naming its kind:
``{"kind": "dense", "values": array}``,
``{"kind": "packed", "words": uint32[n], "width": w, "count": E}`` or
``{"kind": "dict", "words": uint32[n], "width": w, "count": E,
"dictionary": float[u]}``.

:func:`params_from_numpy` does the same for a parameter or optimizer tree
(the reference's pytree with its leaves as numpy arrays: the transformer's
stacked layers, the GNNs' lists of dicts inside dicts, DIN's tables and
MLPs), and :func:`graph_batch_from_numpy` for a reference ``GraphBatch``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ckpt.manager import from_numpy
from .core.executor import DeviceDB, make_device_index, to_device
from .core.schema import Schema
from .robust.errors import ValidationError
from .storage import DenseColumn, DeviceColumn, DictPackedColumn, PackedColumn
from .storage.policy import words_tensor
from .tree import tree_map


def column_from_numpy(spec, dtype: torch.dtype, device, where: str) -> DeviceColumn:
    """One column of ``arrays`` (see the module docstring) on ``device``;
    ``dtype`` is the decoded type (int32 keys, float32 measures)."""
    if not isinstance(spec, dict):
        return DenseColumn(to_device(spec, dtype, device))
    kind = spec.get("kind")
    if kind == "dense":
        return DenseColumn(to_device(spec["values"], dtype, device))
    if kind not in ("packed", "dict"):
        raise ValidationError(f"{where}: unknown column kind {kind!r}", kind=kind)
    width, count = int(spec["width"]), int(spec["count"])
    words = np.asarray(spec["words"])
    if not 1 <= width <= 32 or words.shape[0] < -(-count * width // 32):
        raise ValidationError(
            f"{where}: {words.shape[0]} words cannot hold {count} values of {width} bits",
            width=width, count=count,
        )
    if kind == "packed":
        return PackedColumn(words_tensor(words, device), width, count, dtype)
    return DictPackedColumn(words_tensor(words, device), width, count,
                            to_device(spec["dictionary"], dtype, device))


def device_db_from_numpy(schema: Schema, arrays: dict, device="cuda",
                         host_indexes: dict | None = None) -> DeviceDB:
    """Build the port's DeviceDB from the reference's arrays. ``degrees`` is
    checked against ``indptr`` (the port derives it the same way);
    ``host_indexes`` (the host FragmentIndex objects, which the engine's
    selectivity estimates read) is optional."""
    device = torch.device(device)
    indexes = {}
    for (table, key), a in arrays["indexes"].items():
        where = f"I_{table}.{key}"
        indptr = np.asarray(a["indptr"])
        if not np.array_equal(np.asarray(a["degrees"]), np.diff(indptr)):
            raise ValidationError(
                f"{where}: degrees disagree with indptr", table=table, key=key,
            )
        dst_col = column_from_numpy(a["dst_ids"], torch.int32, device, where)
        # the dst column's host values, for the index's hot share: the host
        # index's column under the relationship's other key, else decoded
        host = (host_indexes or {}).get((table, key))
        dst_values = (host.columns[schema.relationships[table].other_fk(key)].values
                      if host is not None
                      else dst_col.materialize(use_kernel=False).cpu().numpy())
        indexes[(table, key)] = make_device_index(
            indptr, a["src_ids"], dst_col,
            {m: column_from_numpy(v, torch.float32, device, f"{where}/{m}")
             for m, v in a["measures"].items()},
            device, dst_values,
        )
    attrs = {
        k: to_device(v, torch.float32, device)
        for k, v in arrays["entity_attrs"].items()
    }
    return DeviceDB(schema, indexes, attrs, host_indexes or {})


def params_from_numpy(tree, device="cuda"):
    """The reference's parameter or optimizer tree (dicts, tuples and lists
    of numpy arrays: ``jax.tree.map(np.asarray, params)``) as the port's
    tensors on ``device``, each in its array's dtype; bfloat16 leaves (numpy
    has no bfloat16: ml_dtypes' arrays, or ``|V2`` as a checkpoint loads
    them) become ``torch.bfloat16``."""

    return tree_map(lambda a: from_numpy(a, None, device), tree)


def graph_batch_from_numpy(fields: dict, device="cuda"):
    """The port's :class:`~repro_torch.models.gnn.common.GraphBatch` from a
    reference ``GraphBatch``'s fields (``{name: numpy array, int or None}``),
    each array as a tensor of its dtype on ``device``."""
    from .models.gnn.common import GraphBatch

    return GraphBatch(**{k: from_numpy(np.asarray(v), None, device)
                         if v is not None and not isinstance(v, int) else v
                         for k, v in fields.items()})
