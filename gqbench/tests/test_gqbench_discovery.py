"""The harness is driven by data: a configuration, a traffic mix and a
metric added as new files (and entries in BENCHMARK.json) in a copy of the
benchmark run without an edit to any file that was there."""
import json
import shutil
import subprocess
import sys

from gqtiny import ROOT, TINY

CONFIG_PY = '''
from gqbench import gen


def generate(m, seed, device):
    g = gen.generator(seed, device, 0)
    a, b = gen.relation(m["people"], m["people"], m["links_per_person"], 1.0, g, device)
    return {
        "entities": {"Person": {"size": m["people"], "attributes": {}}},
        "relationships": {"KN": {"fk1": "A", "fk2": "B", "entity1": "Person", "entity2": "Person",
                                 "columns": {"A": a, "B": b}}},
    }
'''
QUERY = """SELECT k2.B, COUNT(*)
FROM KN k1 JOIN KN k2 ON k1.B = k2.A
WHERE k1.A = :p0
GROUP BY k2.B
"""
REFERENCE = '''
def run(g, params, dtype, work=None):
    x = g.seed("Person", params["p0"], dtype)
    x = g.hop(x, "KN", "A", work=work)
    return g.hop(x, "KN", "A", work=work)
'''
METRIC = '''
def read(ctx):
    return float(len(ctx.batch_log))
'''


def test_new_cell_config_and_metric_are_found(tmp_path):
    shutil.copytree(ROOT / "gqbench", tmp_path / "gqbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "gqbench").rglob("*") if p.is_file()}
    g = tmp_path / "gqbench"
    (g / "configs" / "friends.json").write_text(json.dumps(
        {"name": "friends", "people": 500, "links_per_person": 4.0, "reduced": [],
         "check": {"max_rel_err": 1e-4}}))
    (g / "configs" / "friends.py").write_text(CONFIG_PY)
    (g / "traffic" / "fof-b8.json").write_text(json.dumps(
        {"loop": "closed", "clients": 8, "max_batch": 8, "compared_per_shape": 4,
         "shapes": [{"query": "FOF", "weight": 1,
                     "params": {"p0": {"sampler": "uniform", "entity": "Person"}}}]}))
    (g / "queries" / "FOF.sql").write_text(QUERY)
    (g / "reference" / "FOF.py").write_text(REFERENCE)
    (g / "metrics" / "batches_run.py").write_text(METRIC)
    bench["configs"].append({"name": "friends", "source": "a throwaway graph",
                             "file": "gqbench/configs/friends.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "friends.fof-b8", "config": "friends",
                               "traffic": "fof-b8", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "batches_run", "unit": "batches", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["friends.fof-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    prog = f"""
import sys, json, time
sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]
from gqbench import harness
assert str(harness.HERE).startswith({str(tmp_path)!r})
bench = json.load(open({str(tmp_path / 'BENCHMARK.json')!r}))
cell = harness.Cell.find(bench, 'friends.fof-b8', False)
print(json.dumps(harness.run_cell(cell, 3, 0.3, False, 'cpu', time.time())))
"""
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r
    assert r["metrics"]["batches_run"]["value"] >= 1
    # every end-to-end metric of the new cell but the device's store, which a CPU run leaves out
    assert set(r["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                 if "friends.fof-b8" in m.get("workloads", ["friends.fof-b8"])
                                 and m["name"] != "store_ratio"}
    after = {p: p.read_bytes() for p in before}
    assert after == before
    assert list(TINY)  # the stand-ins cover every configuration of the real file
