"""Carry a database's device state across from the JAX package.

The counterpart of loading weights: :func:`device_db_from_numpy` takes the
arrays of a reference ``DeviceDB`` (dense device encodings), as numpy, and
builds the port's :class:`~repro_torch.core.executor.DeviceDB` holding the same
integers and floats on ``device``. Nothing here imports the reference; the
caller turns its arrays into numpy first.

``arrays`` layout::

    {
      "indexes": {
        (table, key): {
          "indptr": int[h+1], "src_ids": int[E], "dst_ids": int[E],
          "degrees": int[h], "measures": {name: float[E], ...},
        },
        ...
      },
      "entity_attrs": {(entity, attr): float[dom], ...},
    }
"""
from __future__ import annotations

import numpy as np
import torch

from .core.executor import DeviceDB, make_device_index, to_device
from .core.schema import Schema
from .robust.errors import ValidationError


def device_db_from_numpy(schema: Schema, arrays: dict, device="cuda",
                         host_indexes: dict | None = None) -> DeviceDB:
    """Build the port's DeviceDB from the reference's arrays. ``degrees`` is
    checked against ``indptr`` (the port derives it the same way);
    ``host_indexes`` (the host FragmentIndex objects, which the engine's
    selectivity estimates read) is optional."""
    device = torch.device(device)
    indexes = {}
    for (table, key), a in arrays["indexes"].items():
        indptr = np.asarray(a["indptr"])
        if not np.array_equal(np.asarray(a["degrees"]), np.diff(indptr)):
            raise ValidationError(
                f"I_{table}.{key}: degrees disagree with indptr",
                table=table, key=key,
            )
        indexes[(table, key)] = make_device_index(
            indptr, a["src_ids"], a["dst_ids"], a["measures"], device
        )
    attrs = {
        k: to_device(v, torch.float32, device)
        for k, v in arrays["entity_attrs"].items()
    }
    return DeviceDB(schema, indexes, attrs, host_indexes or {})
