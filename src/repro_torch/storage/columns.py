"""Device column store: per-column physical representation.

Whether a column lives decoded or bit-packed is a per-column physical property
the rest of the engine is agnostic to: every column kind's ``materialize()``
returns the full decoded device tensor.

This port holds :class:`DenseColumn` only; the bit-packed and dictionary
kinds come with ROADMAP Queue 1 item 4, and the integrity hooks with item 11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


class DeviceColumn:
    """Abstract device-resident column; see module docstring for the contract."""

    kind: str = "abstract"
    count: int

    def materialize(self) -> torch.Tensor:
        raise NotImplementedError


@dataclass(eq=False)
class DenseColumn(DeviceColumn):
    """Fully decoded device tensor — zero-cost materialize."""

    array: Any  # torch.Tensor

    kind = "dense"

    @property
    def count(self) -> int:
        return int(self.array.shape[0])

    def materialize(self) -> torch.Tensor:
        return self.array
