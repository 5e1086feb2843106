"""Each reference query against the program on ``device="cpu"`` on a tiny
graph, for every shape the cells use, through the batched entry the window
drives."""
import numpy as np
import pytest
import torch

from gqbench import compare, gen, loop
from gqbench import reference as R
from gqbench.reference.graph import Graph
from gqtiny import CELLS, cell


def shapes():
    return sorted({(c, s["query"]) for c in CELLS for s in cell(c).traffic["shapes"]})


@pytest.mark.parametrize("name,query", shapes())
def test_reference_matches_the_program(name, query):
    from repro_torch.core.engine import GQFastDatabase, GQFastEngine
    from repro_torch.core.schema import EntityTable, RelationshipTable, Schema

    c = cell(name)
    host = gen.to_host(c.generator.generate(c.manifest, 11, "cpu"))
    schema = Schema(
        entities={k: EntityTable(k, e["size"], dict(e["attributes"]))
                  for k, e in host["entities"].items()},
        relationships={k: RelationshipTable(k, r["fk1"], r["fk2"], r["entity1"], r["entity2"],
                                            dict(r["columns"])) for k, r in host["relationships"].items()},
    )
    pq = GQFastEngine(GQFastDatabase(schema, device="cpu")).prepare(c.sql[query])
    st = loop.Stream(c.traffic, host, 11)
    params = st.arrays(st.batch_of(query, 12))
    served = pq.execute_batch(**params)
    ref = R.query(query).run(Graph(host, "cpu"), params, torch.float64)
    assert ref.abs().sum() > 0
    assert compare.max_rel_err(list(served), ref) <= 1e-6


def test_compare_reads_gaps():
    ref = torch.tensor([[0.0, 2.0, 4.0]], dtype=torch.float64)
    assert compare.max_rel_err([np.array([0.0, 2.0, 4.0], np.float32)], ref) == 0.0
    assert compare.max_rel_err([np.array([0.0, 2.0, 5.0], np.float32)], ref) == pytest.approx(0.2)
    assert compare.max_rel_err([np.array([1.0, 2.0, 4.0], np.float32)], ref) == 1.0
    assert compare.max_rel_err([np.array([2.0, 4.0], np.float32)], ref) == 1.0
    assert compare.max_rel_err([np.array([0.0, np.nan, 4.0], np.float32)], ref) == 1.0
