"""Checkpoint manager: atomic, retained, restored onto any device.

Layout: ``<dir>/step_<n>/arrays.npz`` + ``meta.json``, published through
the crash-safe writer (``ckpt/atomic.py``: tmp dir + fsync + ``os.rename`` +
parent fsync). The JAX package's format (``repro.ckpt.manager``), leaf for
leaf: each leaf is stored under its key path (``[0]/embed``,
``[1]/m/layers/wq``, ``[1]/step``: dict keys and ``[i]`` for tuple indices,
joined by ``/``), so a checkpoint written by either package restores in the
other.

bfloat16 leaves: numpy has no bfloat16, and the reference's (ml_dtypes')
bfloat16 arrays go into the ``.npy`` member as 2-byte void records with the
descriptor ``'<V2'``. This module writes bfloat16 leaves the same way, byte
for byte, and reads any 2-byte void array (``np.load`` gives ``|V2``) back
through a uint16 view. The reference cannot restore such a leaf itself
(``jax.device_put`` refuses ``|V2``); the port restores both packages'.

Retention keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import time
import zipfile

import numpy as np
import torch

from ..tree import map_with_path, tree_leaves_with_path
from .atomic import list_stamped, publish_dir, retain_stamped, stamped_name

STEP_PREFIX = "step_"
#: The ``.npy`` descriptor numpy writes for the reference's bfloat16 arrays.
BF16_DESCR = "<V2"


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; bfloat16 as a uint16 view (its bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: torch.dtype | None, device) -> torch.Tensor:
    """``a`` as a tensor of ``dtype`` (``None``: its own) on ``device``; a 2-byte void or
    bfloat16 array (the reference's bfloat16, as saved or in memory) is read
    through a uint16 view."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):  # a tensor may be written
        a = a.copy(order="C")
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _write_npz(path: str, flat: dict[str, tuple[np.ndarray, bool]]) -> None:
    """``np.savez``'s container, member for member; ``(array, is_bf16)``
    values, a bfloat16 member with the reference's descriptor."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, bf16) in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if not bf16:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": BF16_DESCR, "fortran_order": False, "shape": arr.shape})
                fid.write(np.ascontiguousarray(arr).tobytes())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra_meta: dict | None = None) -> str:
        leaves = tree_leaves_with_path(tree)
        flat = {k: (to_numpy(v), v.dtype == torch.bfloat16) for k, v in leaves}
        final = os.path.join(self.dir, stamped_name(STEP_PREFIX, step))

        def write(tmp: str) -> None:
            _write_npz(os.path.join(tmp, "arrays.npz"), flat)
            meta = {
                "step": step,
                "treedef": ", ".join(k for k, _ in leaves),
                "keys": sorted(flat),
                "time": time.time(),
                **(extra_meta or {}),
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)

        publish_dir(final, write, tmp_prefix=".tmp_ckpt_")
        self._retain()
        return final

    def _retain(self) -> None:
        retain_stamped(self.dir, STEP_PREFIX, self.keep)

    def list_steps(self) -> list[int]:
        return list_stamped(self.dir, STEP_PREFIX)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, template, step: int | None = None, device=None):
        """Restore into the structure of ``template``, a tree of tensors
        (``device="meta"`` ones will do): each leaf takes its template's
        dtype, and its device, or ``device`` where one is given (a meta
        template without ``device`` lands on the CPU)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, stamped_name(STEP_PREFIX, step))
        with np.load(os.path.join(path, "arrays.npz")) as data:
            def load(key: str, t: torch.Tensor) -> torch.Tensor:
                dev = device if device is not None else t.device
                if torch.device(dev).type == "meta":
                    dev = "cpu"
                return from_numpy(data[key], t.dtype, dev)

            tree = map_with_path(load, template)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return tree, meta
