"""Checksummed, generation-stamped database snapshots.

The engine rebuilds its §5 data organization — fragment indexes plus the
compressed device column store — from raw tables on every process start.
This module makes that state durable and *verifiable*, in the reference's
format (``repro.storage.snapshot``: the same ``FORMAT``, directory layout,
logical array names, dtypes and CRC per array), so that a generation written
by either package restores in the other:

  * :func:`snapshot_db` persists a ``GQFastDatabase`` as ``gen_<n>/`` under a
    snapshot directory: one ``.npy`` file per logical array plus a
    ``MANIFEST.json`` carrying a CRC-32C per array, the schema/layout
    metadata, and the per-column integrity digests
    (``storage/integrity.py``). Device columns are written as their
    *encoded* bytes (packed BCA words, dictionaries, dense arrays) so
    restore round-trips without re-encoding. Packed words, held on the
    device as int32 tensors of the uint32 bits, are written as uint32, the
    reference's dtype. CRCs of device tensors are taken on the device
    before the copy to the host. Publication is crash-safe via the atomic
    writer (``ckpt/atomic.py``): a generation is either fully visible with
    fsynced contents or absent.

  * :func:`restore_db` loads a generation, verifies **every** array file
    against its manifest CRC (hashed on the device the DB is restored to)
    and the rebuilt device columns against their encoded digests *before*
    the database is handed to the engine, and raises a typed, non-retryable
    :class:`~repro_torch.robust.errors.IntegrityError` naming the offending
    table/column on any mismatch — a corrupted snapshot never serves data.
    The device indexes are rebuilt through
    :func:`~repro_torch.core.executor.make_device_index` on the asked
    device, and the restored DB carries its integrity manifest, so verified
    reads and the scrubber (robust/scrub.py) work out of the box.

Layout::

    <dir>/gen_0000000042/
        MANIFEST.json            # format, generation, schema, arrays, digests
        arrays/a00000.npy …      # one file per logical array (manifest maps
                                 # logical name → file + crc32c/dtype/shape)

Logical array names: ``host/<t>.<k>/indptr``, ``host/<t>.<k>/<col>/values``
(+``/packed``), ``dev/<t>.<k>/<col>/{array|words|dict}``,
``dev/<t>.<k>/block_src_{min,max}``, ``attr/<entity>/<name>``. Derivable
arrays (CSR ``src_ids``, ``degrees``, the block ranges) are rebuilt from
``indptr`` on restore. Relationship-table rows are reconstructed from the
fk1-direction index, so restored raw tables are in (fk1, fk2)-sorted order —
relationally identical to the originals (aggregation is order-independent),
not byte-identical row order.

Fault site ``snapshot.load`` (robust/faults.py): ``raise``/``delay`` fire at
restore entry; ``corrupt`` transforms each loaded array *before* checksum
verification, so chaos plans can prove restore-time corruption is caught.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any

import numpy as np
import torch

from ..ckpt.atomic import list_stamped, publish_dir, retain_stamped, stamped_name
from ..robust import faults as _faults
from ..robust.errors import IntegrityError
from .columns import DenseColumn, DictPackedColumn, PackedColumn
from .integrity import (
    attach_manifest,
    build_manifest,
    crc32c,
    crc32c_parts,
    encoded_parts,
)
from .policy import words_tensor

#: Manifest format version — bump on layout changes; restore refuses formats
#: it does not understand rather than misreading them.
FORMAT = 1

GEN_PREFIX = "gen_"
MANIFEST = "MANIFEST.json"
ARRAY_DIR = "arrays"

_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32}


def list_generations(directory: str) -> list[int]:
    return list_stamped(directory, GEN_PREFIX)


def latest_generation(directory: str) -> int | None:
    gens = list_generations(directory)
    return gens[-1] if gens else None


def generation_path(directory: str, generation: int) -> str:
    return os.path.join(directory, stamped_name(GEN_PREFIX, generation))


# ---------------------------------------------------------------------------
# Snapshot (write)
# ---------------------------------------------------------------------------


def _device_column_arrays(col) -> dict[str, torch.Tensor]:
    """The encoded device tensors of one column keyed by their role — written
    to disk exactly as stored, the no-re-encoding contract."""
    if isinstance(col, DenseColumn):
        return {"array": col.array}
    if isinstance(col, DictPackedColumn):
        return {"words": col.words, "dict": col.dictionary}
    if isinstance(col, PackedColumn):
        return {"words": col.words}
    raise TypeError(f"not a device column: {type(col).__name__}")


def _numpy_dtype(dtype: torch.dtype) -> str:
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def _on_host(name: str, a) -> np.ndarray:
    """One logical array as written: a device tensor copied to the host, its
    packed words as uint32 (the reference's dtype, the same bytes)."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    out = a.cpu().numpy()
    return out.view(np.uint32) if name.endswith("/words") else out


def _collect(db) -> tuple[dict[str, Any], dict[str, Any]]:
    """Flatten ``db`` into (logical-name → host array or device tensor,
    schema/layout meta)."""
    arrays: dict[str, Any] = {}
    indexes_meta: dict[str, Any] = {}
    for (t, k), idx in db.host_indexes.items():
        iid = f"{t}.{k}"
        arrays[f"host/{iid}/indptr"] = np.asarray(idx.indptr)
        cols_meta: dict[str, Any] = {}
        for c, cf in idx.columns.items():
            arrays[f"host/{iid}/{c}/values"] = np.asarray(cf.values)
            if cf.packed is not None:
                arrays[f"host/{iid}/{c}/packed"] = np.asarray(cf.packed)
            cols_meta[c] = {
                "domain": int(cf.domain),
                "encoding": cf.encoding,
                "encoded_bytes": int(cf.encoded_bytes),
                "packed_width": int(cf.packed_width),
                "has_packed": cf.packed is not None,
            }
        di = db.device.indexes[(t, k)]
        dev_meta: dict[str, Any] = {}
        for name, col in [("__dst__", di.dst_col), *di.measure_cols.items()]:
            for role, arr in _device_column_arrays(col).items():
                arrays[f"dev/{iid}/{name}/{role}"] = arr
            if isinstance(col, DenseColumn):
                odt = col.array.dtype
            elif isinstance(col, DictPackedColumn):
                odt = col.dictionary.dtype
            else:
                odt = col.out_dtype
            dev_meta[name] = {
                "kind": col.kind,
                "count": int(col.count),
                "width": int(getattr(col, "width", 0)),
                "out_dtype": _numpy_dtype(odt),
            }
        if di.block_src_min is not None:
            arrays[f"dev/{iid}/block_src_min"] = di.block_src_min
            arrays[f"dev/{iid}/block_src_max"] = di.block_src_max
        indexes_meta[iid] = {
            "table": t, "key": k, "key_entity": idx.key_entity,
            "num_edges": int(idx.num_edges),
            "columns": cols_meta, "device": dev_meta,
        }
    for e in db.schema.entities.values():
        for a, col in e.attributes.items():
            arrays[f"attr/{e.name}/{a}"] = np.asarray(col)
    schema_meta = {
        "entities": {
            e.name: {"size": int(e.size), "attributes": sorted(e.attributes)}
            for e in db.schema.entities.values()
        },
        "relationships": {
            r.name: {
                "fk1": r.fk1, "fk2": r.fk2,
                "entity1": r.entity1, "entity2": r.entity2,
                "measures": list(r.measures),
            }
            for r in db.schema.relationships.values()
        },
    }
    return arrays, {"schema": schema_meta, "indexes": indexes_meta}


def snapshot_db(db, directory: str, keep: int | None = None) -> str:
    """Persist ``db`` as the next generation under ``directory`` and return
    the published path. ``keep`` ages out all but the newest ``keep``
    generations (None: keep everything). Atomic: a crash mid-write leaves no
    partially visible generation. Every CRC is taken on the DB's device."""
    arrays, meta = _collect(db)
    dev = db.device.device
    generation = (latest_generation(directory) or 0) + 1
    manifest: dict[str, Any] = {
        "format": FORMAT,
        "generation": generation,
        "created": time.time(),
        **meta,
        "integrity": getattr(db.device, "integrity", None) or build_manifest(db.device),
        "arrays": {},
    }
    width = max(5, int(math.ceil(math.log10(max(len(arrays), 2)))))
    for i, name in enumerate(sorted(arrays)):
        arr = arrays[name]
        if isinstance(arr, torch.Tensor):
            dtype = "uint32" if name.endswith("/words") else _numpy_dtype(arr.dtype)
            shape, nbytes = list(arr.shape), arr.numel() * arr.element_size()
        else:
            dtype, shape, nbytes = str(arr.dtype), list(arr.shape), int(arr.nbytes)
        manifest["arrays"][name] = {
            "file": f"a{i:0{width}d}.npy",
            "crc32c": crc32c(arr, device=dev),
            "dtype": dtype,
            "shape": shape,
            "nbytes": nbytes,
        }

    def write(tmp: str) -> None:
        adir = os.path.join(tmp, ARRAY_DIR)
        os.makedirs(adir)
        for name, spec in manifest["arrays"].items():
            np.save(os.path.join(adir, spec["file"]), _on_host(name, arrays[name]))
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)

    final = publish_dir(generation_path(directory, generation), write,
                        tmp_prefix=".tmp_snap_")
    if keep is not None:
        retain_stamped(directory, GEN_PREFIX, keep)
    return final


# ---------------------------------------------------------------------------
# Restore (read + verify)
# ---------------------------------------------------------------------------


def _name_context(name: str) -> dict[str, Any]:
    """Best-effort (table, key, column) context parsed from a logical array
    name — what the IntegrityError carries so operators know *which* column
    went bad, not just which file."""
    parts = name.split("/")
    ctx: dict[str, Any] = {"array": name}
    if len(parts) >= 2 and parts[0] in ("host", "dev") and "." in parts[1]:
        t, k = parts[1].split(".", 1)
        ctx["table"], ctx["key"] = t, k
        if len(parts) >= 3:
            ctx["column"] = parts[2]
    elif len(parts) == 3 and parts[0] == "attr":
        ctx["table"], ctx["column"] = parts[1], parts[2]
    return ctx


def read_manifest(gen_path: str) -> dict[str, Any]:
    mpath = os.path.join(gen_path, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 — truncated/garbled JSON
        raise IntegrityError(
            f"snapshot manifest unreadable: {e}", path=mpath,
        ) from e
    if manifest.get("format") != FORMAT:
        raise IntegrityError(
            f"snapshot format {manifest.get('format')!r} not supported "
            f"(expected {FORMAT})", path=mpath, format=manifest.get("format"),
        )
    return manifest


def _load_array(gen_path: str, name: str, spec: dict[str, Any],
                generation: int, fault_site: str | None, device) -> np.ndarray:
    """Load + verify one array file (its CRC taken on ``device``). Any
    deviation — unreadable file, wrong dtype/shape (a flipped header byte),
    data bytes off-digest (a flipped payload byte) — raises IntegrityError;
    corrupted snapshots never return data."""
    path = os.path.join(gen_path, ARRAY_DIR, spec["file"])
    try:
        arr = np.load(path)
    except Exception as e:  # noqa: BLE001 — np.load raises a zoo of types
        raise IntegrityError(
            f"snapshot array {name!r} unreadable: {e}",
            path=path, generation=generation, **_name_context(name),
        ) from e
    if fault_site is not None:
        arr = _faults.corrupt(fault_site, arr)
    if str(arr.dtype) != spec["dtype"] or list(arr.shape) != spec["shape"]:
        raise IntegrityError(
            f"snapshot array {name!r} header mismatch: "
            f"{arr.dtype}{list(arr.shape)} != {spec['dtype']}{spec['shape']}",
            path=path, generation=generation, **_name_context(name),
        )
    actual = crc32c(arr, device=device)
    if actual != spec["crc32c"]:
        raise IntegrityError(
            f"snapshot array {name!r} failed checksum verification",
            path=path, generation=generation,
            expected_crc=spec["crc32c"], actual_crc=actual,
            **_name_context(name),
        )
    return arr


def column_from_arrays(arrays: dict[str, np.ndarray], cmeta: dict[str, Any], device,
                       where: str):
    """One device column from its stored encoded arrays (role → array, as
    :func:`load_column_arrays` returns them) on ``device`` — the stored
    bytes, never the encoders."""
    out_dtype = _TORCH_DTYPES.get(cmeta["out_dtype"])
    kind = cmeta["kind"]
    if kind == "dense":
        return DenseColumn(torch.from_numpy(np.ascontiguousarray(arrays["array"])).to(device))
    if kind in ("packed", "dict") and out_dtype is not None:
        words = words_tensor(arrays["words"], device)
        if kind == "dict":
            return DictPackedColumn(
                words, int(cmeta["width"]), int(cmeta["count"]),
                torch.tensor(np.asarray(arrays["dict"]), dtype=out_dtype, device=device),
            )
        return PackedColumn(words, int(cmeta["width"]), int(cmeta["count"]), out_dtype)
    raise IntegrityError(
        f"snapshot device column {where!r} has unknown kind {kind!r} or type "
        f"{cmeta['out_dtype']!r}", array=where, kind=kind,
    )


def _build_device_index(iid: str, imeta: dict[str, Any], arrays: dict[str, np.ndarray],
                        indptr: np.ndarray, dst_values: np.ndarray, device):
    """Rebuild one DeviceIndex on ``device`` straight from snapshot bytes
    through ``make_device_index`` (structure, block ranges, hot share)."""
    from ..core.executor import make_device_index

    def col_for(name: str, cmeta: dict[str, Any]):
        base = f"dev/{iid}/{name}/"
        roles = {n[len(base):]: a for n, a in arrays.items() if n.startswith(base)}
        return column_from_arrays(roles, cmeta, device, base[:-1])

    dev_meta = imeta["device"]
    src = np.repeat(np.arange(indptr.shape[0] - 1, dtype=np.int64), np.diff(indptr))
    return make_device_index(
        indptr, src, col_for("__dst__", dev_meta["__dst__"]),
        {name: col_for(name, cmeta) for name, cmeta in dev_meta.items()
         if name != "__dst__"},
        device, dst_values,
    )


def restore_db(directory: str, generation: int | None = None,
               verify_reads: bool = True, device=None):
    """Rebuild a ``GQFastDatabase`` on ``device`` (None: the card) from
    snapshot generation ``generation`` (default: latest). Every array file is
    checksum-verified and the rebuilt device columns are cross-checked
    against their encoded digests *before* the database object exists — on
    any mismatch this raises :class:`IntegrityError` and returns nothing. The
    integrity manifest is attached to the restored DB (``verify_reads``
    additionally enables per-materialize decoded-view verification)."""
    from ..core.engine import GQFastDatabase, resolve_device
    from ..core.executor import DeviceDB, to_device
    from ..core.fragments import ColumnFragments, FragmentIndex
    from ..core.schema import EntityTable, RelationshipTable, Schema

    dev = resolve_device(device)
    _faults.fire("snapshot.load", directory=directory)
    if generation is None:
        generation = latest_generation(directory)
        if generation is None:
            raise FileNotFoundError(f"no snapshot generations in {directory}")
    gen_path = generation_path(directory, generation)
    manifest = read_manifest(gen_path)

    arrays = {
        name: _load_array(gen_path, name, spec, generation,
                          fault_site="snapshot.load", device=dev)
        for name, spec in manifest["arrays"].items()
    }

    # --- schema -----------------------------------------------------------
    entities = {
        name: EntityTable(
            name, emeta["size"],
            {a: arrays[f"attr/{name}/{a}"] for a in emeta["attributes"]},
        )
        for name, emeta in manifest["schema"]["entities"].items()
    }
    relationships = {}
    for name, rmeta in manifest["schema"]["relationships"].items():
        iid = f"{name}.{rmeta['fk1']}"
        indptr = arrays[f"host/{iid}/indptr"]
        fk1_col = np.repeat(
            np.arange(indptr.shape[0] - 1, dtype=np.int64), np.diff(indptr)
        )
        cols = {rmeta["fk1"]: fk1_col,
                rmeta["fk2"]: arrays[f"host/{iid}/{rmeta['fk2']}/values"]}
        for m in rmeta["measures"]:
            cols[m] = arrays[f"host/{iid}/{m}/values"]
        relationships[name] = RelationshipTable(
            name, rmeta["fk1"], rmeta["fk2"],
            rmeta["entity1"], rmeta["entity2"], cols,
        )
    schema = Schema(entities, relationships)

    # --- host indexes + device store --------------------------------------
    host_indexes: dict[tuple[str, str], FragmentIndex] = {}
    indexes: dict[tuple[str, str], Any] = {}
    for iid, imeta in manifest["indexes"].items():
        t, k = imeta["table"], imeta["key"]
        indptr = arrays[f"host/{iid}/indptr"]
        idx = FragmentIndex(t, k, imeta["key_entity"], indptr)
        for c, cmeta in imeta["columns"].items():
            idx.columns[c] = ColumnFragments(
                c, arrays[f"host/{iid}/{c}/values"], cmeta["domain"],
                cmeta["encoding"], cmeta["encoded_bytes"],
                packed=arrays.get(f"host/{iid}/{c}/packed"),
                packed_width=cmeta["packed_width"],
            )
        host_indexes[(t, k)] = idx
        dst_values = idx.columns[schema.relationships[t].other_fk(k)].values
        indexes[(t, k)] = _build_device_index(iid, imeta, arrays, indptr, dst_values, dev)

    attrs = {
        (e.name, a): to_device(col, torch.float32, dev)
        for e in schema.entities.values()
        for a, col in e.attributes.items()
    }
    device_db = DeviceDB(schema, indexes, attrs, host_indexes)

    # final gate: the rebuilt device columns must hash to the digests the
    # snapshot recorded — catches writer/restorer layout drift, not just disk
    # corruption (file-level CRCs already verified above)
    digests = manifest.get("integrity", {})
    for (t, k), di in indexes.items():
        for name, col in [("__dst__", di.dst_col), *di.measure_cols.items()]:
            dig = digests.get(f"I_{t}.{k}/{name}")
            if dig is None:
                continue
            actual = crc32c_parts(encoded_parts(col))
            if actual != dig["encoded_crc"]:
                raise IntegrityError(
                    f"restored column I_{t}.{k}/{name} does not match its "
                    "snapshot digest",
                    table=t, key=k, column=name, generation=generation,
                    expected_crc=dig["encoded_crc"], actual_crc=actual,
                )

    db = GQFastDatabase.from_parts(schema, host_indexes, device_db)
    attach_manifest(device_db, digests or None, verify_reads=verify_reads)
    return db


def load_column_arrays(directory: str, generation: int, table: str, key: str,
                       column: str, device="cuda") -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    """Read (and checksum-verify, on ``device``) the encoded arrays of ONE
    device column from a snapshot — the scrubber's repair source. Returns
    (role → array, column meta). No fault site: heal reads must not be
    re-corrupted by the ``snapshot.load`` chaos spec aimed at full
    restores."""
    gen_path = generation_path(directory, generation)
    manifest = read_manifest(gen_path)
    iid = f"{table}.{key}"
    cmeta = manifest["indexes"][iid]["device"][column]
    base = f"dev/{iid}/{column}/"
    out = {
        name[len(base):]: _load_array(gen_path, name, spec, generation,
                                      fault_site=None, device=device)
        for name, spec in manifest["arrays"].items()
        if name.startswith(base)
    }
    if not out:
        raise IntegrityError(
            f"snapshot has no arrays for column I_{iid}/{column}",
            table=table, key=key, column=column, generation=generation,
        )
    return out, cmeta
