"""Small stand-ins of the benchmark's cells for the CPU tests: the cells of
``BENCHMARK.json`` with each configuration's scale cut to a test's size."""
from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {
    "pubmed-m": {"documents": 3000},
}
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 77


def cell(name: str, trace: bool = False, bench: dict = BENCH):
    from gqbench import harness

    c = harness.Cell.find(bench, name, trace)
    c.manifest.update(TINY[c.manifest["name"]])
    return c


def run(name: str, seed: int = SEED, seconds: float = 0.5, trace: bool = False) -> dict:
    """One run of the cell on the CPU, as the benchmark runs it on the card
    past its look for a card."""
    from gqbench import harness

    return harness.run_cell(cell(name, trace), seed, seconds, trace, "cpu", time.time())
