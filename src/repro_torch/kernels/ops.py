"""Hop dispatch: the one entry the executor calls for every HopOp.

  * CPU tensors take the plain PyTorch version (:mod:`.ref`);
  * CUDA tensors with ``use_kernel=True`` launch the CUDA kernel
    (:mod:`.fragment_spmv`). A kernel that fails to build or launch raises:
    there is no quiet fallback;
  * ``use_kernel=False`` is the explicit plain-version path on any device —
    what the tests and the on-card check compare the kernel with.
"""
from __future__ import annotations

import torch

from ..robust.errors import ValidationError
from . import fragment_spmv as _kernel
from . import ref
from .ref import IDENTITY


def fragment_spmv(weights, src_ids, dst_ids, measures, n_dst: int,
                  op: str = "sum", use_kernel: bool = True) -> torch.Tensor:
    """y[dst] ⊕= w[src] ⊗ m. ``measures=None`` means measure 1 on every
    edge. Arrays that are not tensors (numpy, lists) land on the CPU."""
    if op not in IDENTITY:
        raise ValueError(f"unknown combine op {op!r}")
    w = torch.as_tensor(weights, dtype=torch.float32)
    s = torch.as_tensor(src_ids, dtype=torch.int32, device=w.device)
    d = torch.as_tensor(dst_ids, dtype=torch.int32, device=w.device)
    m = None if measures is None else torch.as_tensor(
        measures, dtype=torch.float32, device=w.device
    )
    if not use_kernel or w.device.type == "cpu":
        return ref.fragment_spmv_ref(w, s, d, m, n_dst, op=op)
    if w.device.type == "cuda":
        return _kernel.fragment_spmv(w, s, d, m, n_dst, op=op)
    raise ValidationError(
        f"no fragment_spmv kernel for device {w.device}; use 'cuda' or 'cpu'",
        device=str(w.device),
    )
