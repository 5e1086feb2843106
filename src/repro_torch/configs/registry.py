"""Architecture registry: --arch <id> → ArchConfig (the 10 assigned + the
paper's own workload), the JAX package's ids."""
from __future__ import annotations

from .base import ArchConfig
from .din_arch import DIN
from .gnn_family import EGNN, EQUIFORMER_V2, MACE, SCHNET
from .gqfast_arch import GQFAST
from .lm_archs import ARCTIC_480B, CODEQWEN15_7B, LLAMA3_8B, OLMOE_1B_7B, QWEN25_3B

ARCHS: dict[str, ArchConfig] = {
    "codeqwen1.5-7b": CODEQWEN15_7B,
    "qwen2.5-3b": QWEN25_3B,
    "llama3-8b": LLAMA3_8B,
    "arctic-480b": ARCTIC_480B,
    "olmoe-1b-7b": OLMOE_1B_7B,
    "mace": MACE,
    "egnn": EGNN,
    "equiformer-v2": EQUIFORMER_V2,
    "schnet": SCHNET,
    "din": DIN,
    "gqfast-pubmed": GQFAST,
}

ASSIGNED = [a for a in ARCHS if a != "gqfast-pubmed"]


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id}; available: {list(ARCHS)}")
    return ARCHS[arch_id]


def all_cells() -> list[tuple[str, str]]:
    out = []
    for aid, arch in ARCHS.items():
        for sid in arch.shape_ids:
            out.append((aid, sid))
    return out
