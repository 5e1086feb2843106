"""What the benchmark loads: neither JAX nor the JAX package ``repro``,
compared by whole top-level names (``repro_torch`` begins with ``repro``),
and a reference that loads nothing of the program. Each check runs in a
fresh interpreter."""
import json
import subprocess
import sys

from gqtiny import ROOT

BANNED = ("jax", "jaxlib", "flax", "repro")


def loaded_after(code: str) -> set:
    prog = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         check=True, cwd=ROOT, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_generators_readers_and_reference_load_no_jax():
    code = """
import glob, os
from gqbench import harness, control, loop, gen, devtrace, compare, sweep
from gqbench import reference as R
for kind in ('reference', 'metrics', 'configs'):
    for p in glob.glob(os.path.join(harness.HERE, kind, '*.py')):
        n = os.path.basename(p)[:-3]
        if n not in ('__init__', 'graph'):
            harness.load_module(p, kind + '_' + n.replace('-', '_'))
"""
    assert not loaded_after(code) & set(BANNED)


def test_reference_loads_nothing_of_the_program():
    code = """
import glob, os, torch
from gqbench import reference as R, gen
from gqbench.reference.graph import Graph
for q in glob.glob(os.path.join(R.HERE, '*.py')):
    n = os.path.basename(q)[:-3]
    if n not in ('__init__', 'graph'):
        R.query(n)
"""
    assert "repro_torch" not in loaded_after(code)


def test_a_whole_cpu_run_loads_no_jax():
    code = """
sys.path.insert(0, %r)
import gqtiny
r = gqtiny.run(gqtiny.CELLS[0], seconds=0.2)
assert r['correct']
from gqbench import harness
assert harness.banned_modules() == []
""" % str(ROOT / "gqbench" / "tests")
    assert not loaded_after(code) & set(BANNED)
