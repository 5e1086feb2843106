"""BENCHMARK.json against the benchmark's contract: names, units and
lengths; every file it names under ``paths``; every metric's reader; the
configurations' ``reduced`` keys present in their files."""
import json
import re

import pytest

from gqtiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(text_ok(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and text_ok(w["why"])
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert text_ok(c["source"]) and text_ok(c["why"])
    for m in BENCH["per_layer"]:
        assert text_ok(m["layer"])


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_metrics_and_cells_fit_together():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for c in cells:
        per_layer = [m for m in BENCH["per_layer"] if c in m.get("workloads", cells)]
        assert per_layer
        assert all(c in m.get("workloads", cells) for m in BENCH["end_to_end"]
                   if m["name"] in {p["moves"] for p in per_layer})
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    path = ROOT / entry["file"]
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    manifest = json.loads(path.read_text())
    assert manifest["name"] == entry["name"]
    assert manifest["reduced"] == entry["reduced"]
    assert all(k in manifest for k in entry["reduced"])
    assert (ROOT / "gqbench" / "configs" / f"{entry['name']}.py").exists()


def test_every_named_file_exists():
    for w in BENCH["workloads"]:
        traffic = json.loads((ROOT / "gqbench" / "traffic" / f"{w['traffic']}.json").read_text())
        for s in traffic["shapes"]:
            assert (ROOT / "gqbench" / "queries" / f"{s['query']}.sql").exists()
            assert (ROOT / "gqbench" / "reference" / f"{s['query']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "gqbench" / "metrics" / f"{m['name']}.py").exists()
