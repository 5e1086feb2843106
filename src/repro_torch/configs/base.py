"""Config protocol: every architecture names its shapes and runs a reduced
config end to end (``smoke``). Lowering a shape onto a production mesh
(the JAX package's ``make_cell``) comes with ROADMAP Queue 1 item 15c."""
from __future__ import annotations

from ..core.executor import not_ported


class ArchConfig:
    arch_id: str = ""
    kind: str = ""
    shape_ids: list[str] = []

    def skip_reason(self, shape_id: str) -> str | None:
        return None

    def make_cell(self, shape_id: str, mesh, variant: str = ""):
        raise not_ported(f"make_cell ({self.arch_id} × {shape_id}: a dry-run cell on a "
                         "production mesh)", "15c")

    def smoke(self, device="cuda") -> dict:
        """Run a reduced config end to end on ``device``; returns metrics to
        assert."""
        raise NotImplementedError
