"""Architecture registry: --arch <id> → ArchConfig (the five LM archs and
the paper's own workload). The JAX package's GNN and recsys ids come with
ROADMAP Queue 1 item 15b: ``get_arch`` names the item for them."""
from __future__ import annotations

from ..core.executor import not_ported
from .base import ArchConfig
from .gqfast_arch import GQFAST
from .lm_archs import ARCTIC_480B, CODEQWEN15_7B, LLAMA3_8B, OLMOE_1B_7B, QWEN25_3B

ARCHS: dict[str, ArchConfig] = {
    "codeqwen1.5-7b": CODEQWEN15_7B,
    "qwen2.5-3b": QWEN25_3B,
    "llama3-8b": LLAMA3_8B,
    "arctic-480b": ARCTIC_480B,
    "olmoe-1b-7b": OLMOE_1B_7B,
    "gqfast-pubmed": GQFAST,
}

#: The JAX package's archs still to port: the GNN family and DIN.
NOT_PORTED = ("mace", "egnn", "equiformer-v2", "schnet", "din")


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id in NOT_PORTED:
        raise not_ported(f"--arch {arch_id}", "15b (GNN and DIN)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id}; available: {list(ARCHS)}")
    return ARCHS[arch_id]
