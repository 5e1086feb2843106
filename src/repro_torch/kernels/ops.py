"""Kernel dispatch: the one entry the executor and the storage layer call.

  * CPU tensors take the plain PyTorch versions (:mod:`.ref`);
  * CUDA tensors with ``use_kernel=True`` launch the CUDA kernels
    (:mod:`.fragment_spmv`, :mod:`.fragment_spmv_packed`, :mod:`.bitunpack`).
    A kernel that fails to build or launch raises: there is no quiet fallback;
  * ``use_kernel=False`` is the explicit plain-version path on any device —
    what the tests and the on-card check compare the kernels with.

Frontier-sparsity dispatch (:mod:`.active`): the hop entries take
``blocks=(src_min, src_max)`` per-block metadata (device tensors) and a
``block_skipping`` mode ('off' | 'on' | 'auto'). With metadata present and
skipping engaged, the hop builds the active-block list on the device and runs
the ``*_active`` kernel over it. 'auto' never asks the host: the kernel reads
``n_active`` and takes every block in scan order when more than
``SKIP_BLOCK_FRACTION`` of them survive (the reference's runtime ``lax.cond``).
Both choices give the scan's result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..robust.errors import ValidationError
from . import active as _active
from . import bitunpack as _bitunpack
from . import fragment_spmv as _dense
from . import fragment_spmv_packed as _packed
from . import ref
from .ref import IDENTITY

BLOCK_SKIPPING_MODES = ("off", "on", "auto")


def _plain(t: torch.Tensor, use_kernel: bool) -> bool:
    """Plain version for CPU tensors or on request; the kernel for CUDA."""
    if not use_kernel or t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValidationError(
        f"no kernel for device {t.device}; use 'cuda' or 'cpu'", device=str(t.device),
    )


def _plan_skip(w, op: str, E: int, blocks, block_skipping: str):
    """Scan or skip for one hop, decided without the host seeing the frontier.
    ``None`` → scan; otherwise ``(block_idx, n_active, scan_above)``, the
    device-resident list and the count above which the kernel scans."""
    if block_skipping not in BLOCK_SKIPPING_MODES:
        raise ValidationError(
            f"unknown block_skipping mode {block_skipping!r}",
            block_skipping=block_skipping, valid=BLOCK_SKIPPING_MODES,
        )
    if block_skipping == "off" or blocks is None or E == 0:
        return None
    nb = _active.n_edge_blocks(E)
    if nb <= 1 and block_skipping != "on":
        # nothing to skip on a 1-block index; 'on' still engages the active
        # kernel so small shapes exercise the real code path
        return None
    src_min, src_max = (torch.as_tensor(b, device=w.device) for b in blocks)
    bi, na = _active.active_block_list(w, IDENTITY[op], src_min, src_max)
    if block_skipping == "on":
        return bi, na, nb
    return bi, na, max(1, int(_active.SKIP_BLOCK_FRACTION * nb))


def _words(a, device=None) -> torch.Tensor:
    """A word stream as the int32 tensor the kernels take (numpy uint32 words
    are reinterpreted, not converted)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, dtype=torch.int32, device=device)


def bitunpack(words, width: int, count: int, use_kernel: bool = True) -> torch.Tensor:
    """Decode ``count`` ``width``-bit values from a word stream; int32."""
    wt = _words(words)
    if _plain(wt, use_kernel):
        return ref.bitunpack_ref(wt, width, count)
    return _bitunpack.bitunpack(wt, width, count)


def fragment_spmv(weights, src_ids, dst_ids, measures, n_dst: int,
                  op: str = "sum", use_kernel: bool = True,
                  blocks=None, block_skipping: str = "off") -> torch.Tensor:
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
    plain = _plain(w, use_kernel)
    plan = _plan_skip(w, op, s.shape[0], blocks, block_skipping)
    if plan is None:
        if plain:
            return ref.fragment_spmv_ref(w, s, d, m, n_dst, op=op)
        return _dense.fragment_spmv(w, s, d, m, n_dst, op=op)
    bi, na, scan_above = plan
    if plain:
        return ref.fragment_spmv_active_ref(w, s, d, m, bi, na, n_dst, op=op,
                                            scan_above=scan_above)
    return _dense.fragment_spmv_active(w, s, d, m, bi, na, n_dst, op=op,
                                       scan_above=scan_above)


def fragment_spmv_packed(weights, src_ids, dst, measure=None, mdict=None, *,
                         n_dst: int, dst_width: int = 0, m_mode: str = "none",
                         m_width: int = 0, op: str = "sum",
                         use_kernel: bool = True,
                         blocks=None, block_skipping: str = "off") -> torch.Tensor:
    """Decode-fused hop: ``dst``/``measure`` may be BCA word streams, decoded
    inside the hop (see fragment_spmv_packed.py)."""
    if op not in IDENTITY:
        raise ValueError(f"unknown combine op {op!r}")
    w = torch.as_tensor(weights, dtype=torch.float32)
    s = torch.as_tensor(src_ids, dtype=torch.int32, device=w.device)
    d = _words(dst, w.device) if dst_width else torch.as_tensor(
        dst, dtype=torch.int32, device=w.device)
    m, md = None, None
    if m_mode == "dense":
        m = torch.as_tensor(measure, dtype=torch.float32, device=w.device)
    elif m_mode in ("packed", "dict"):
        m = _words(measure, w.device)
        if m_mode == "dict":
            md = torch.as_tensor(mdict, dtype=torch.float32, device=w.device)
    elif m_mode != "none":
        raise ValidationError(f"unknown measure mode {m_mode!r}", m_mode=m_mode)
    kw = dict(dst_width=dst_width, m_mode=m_mode, m_width=m_width, op=op)
    plain = _plain(w, use_kernel)
    plan = _plan_skip(w, op, s.shape[0], blocks, block_skipping)
    if plan is None:
        if plain:
            return ref.fragment_spmv_packed_ref(w, s, d, m, md, n_dst, **kw)
        return _packed.fragment_spmv_packed(w, s, d, m, md, n_dst, **kw)
    bi, na, scan_above = plan
    if plain:
        return ref.fragment_spmv_packed_active_ref(w, s, d, m, md, bi, na, n_dst,
                                                   scan_above=scan_above, **kw)
    return _packed.fragment_spmv_packed_active(w, s, d, m, md, bi, na, n_dst,
                                               scan_above=scan_above, **kw)
