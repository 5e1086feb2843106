"""Config protocol: every architecture exposes cells (arch × shape) that the
dry run (``launch.dryrun``) runs over a production mesh, and runs a reduced
config end to end (``smoke``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass
class Cell:
    """One (arch × shape) dry-run unit: ``fn(*args)`` over ``args``, trees
    of meta DTensors (nothing allocated) laid out as ``in_shardings``, the
    matching trees of DTensor placements. (The reference's
    ``out_shardings`` are its jit's; eager DTensor outputs carry their own.)"""

    arch_id: str
    shape_id: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    kind: str = "train"  # train | prefill | decode | serve
    model_flops: float | None = None  # 6·N·D convention (see EXPERIMENTS.md)
    notes: str = ""


class ArchConfig:
    arch_id: str = ""
    kind: str = ""
    shape_ids: list[str] = []

    def skip_reason(self, shape_id: str) -> str | None:
        return None

    def make_cell(self, shape_id: str, mesh, variant: str = "") -> Cell:
        """The cell of ``shape_id`` on ``mesh`` (a ``DeviceMesh``).
        variant='' is the optimized default; 'naive' disables the
        beyond-baseline optimizations."""
        raise NotImplementedError

    def smoke(self, device="cuda") -> dict:
        """Run a reduced config end to end on ``device``; returns metrics to
        assert."""
        raise NotImplementedError
