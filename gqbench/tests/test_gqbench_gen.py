"""The generators: the published ratios after de-duplication, and the seed
fixing the graph."""
import numpy as np
import pytest
import torch

from gqbench import gen
from gqtiny import CELLS, cell


def rows(g, table):
    return len(next(iter(g["relationships"][table]["columns"].values())))


def draw(name, seed=5, **over):
    c = cell(name)
    c.manifest.update(over)
    return c.manifest, gen.to_host(c.generator.generate(c.manifest, seed, "cpu"))


def test_pubmed_ratios():
    m, g = draw("pubmed-m.fad-closed", documents=20000)
    n = m["documents"]
    assert rows(g, "DT") / n == pytest.approx(m["dt_rows_per_document"], rel=0.02)
    assert rows(g, "DA") / n == pytest.approx(m["da_rows_per_document"], rel=0.03)
    assert g["entities"]["Author"]["size"] == round(m["authors_per_document"] * n)
    assert g["entities"]["Term"]["size"] == m["terms"]
    fre = g["relationships"]["DT"]["columns"]["Fre"]
    assert fre.min() >= 1 and fre.max() <= m["fre_values"]
    year = g["entities"]["Document"]["attributes"]["Year"]
    assert year.min() >= m["year_min"] and year.max() <= m["year_max"]
    dt = g["relationships"]["DT"]["columns"]
    key = dt["Doc"] * m["terms"] + dt["Term"]
    assert np.unique(key).shape[0] == key.shape[0]
    # Zipf popularity: term 0 is the most frequent
    assert np.argmax(np.bincount(dt["Term"])) == 0


@pytest.mark.parametrize("name", CELLS)
def test_seed_fixes_the_graph(name):
    _, a = draw(name, seed=2**31 + 5)
    _, b = draw(name, seed=2**31 + 5)
    _, c = draw(name, seed=2**31 + 6)
    for t, r in a["relationships"].items():
        for col, v in r["columns"].items():
            assert np.array_equal(v, b["relationships"][t]["columns"][col])
    assert any(not np.array_equal(v, c["relationships"][t]["columns"][col])
               for t, r in a["relationships"].items() for col, v in r["columns"].items())


def test_fanout_solve_inverts_the_expectation():
    p = gen.zipf_probs(1000, 1.1)
    lam = gen.draws_for_fanout(30.0, p)
    assert float(np.sum(-np.expm1(-lam * p))) == pytest.approx(30.0, rel=1e-6)
    with pytest.raises(ValueError):
        gen.draws_for_fanout(1000.0, p)


def test_zipf_draws_follow_the_probabilities():
    g = torch.Generator().manual_seed(3)
    x = gen.zipf(5, 1.5, 200000, g, "cpu").numpy()
    freq = np.bincount(x, minlength=5) / x.shape[0]
    assert np.allclose(freq, gen.zipf_probs(5, 1.5), atol=5e-3)
