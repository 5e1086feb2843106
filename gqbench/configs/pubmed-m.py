"""PubMed-M's graph (GQ-Fast, Table 1) drawn on the device from the seed:
DT(Doc, Term, Fre) with Zipf term popularity, DA(Doc, Author) with Zipf
authors, Document(Year). Fanouts are the published ones after
de-duplication."""
from __future__ import annotations

import torch

from gqbench import gen


def generate(m: dict, seed: int, device) -> dict:
    n_docs, n_terms = int(m["documents"]), int(m["terms"])
    n_authors = int(round(m["authors_per_document"] * n_docs))
    g = gen.generator(seed, device, 0)
    dt_doc, dt_term = gen.relation(n_docs, n_terms, m["dt_rows_per_document"],
                                   m["term_zipf"], g, device)
    fre = 1 + gen.zipf(int(m["fre_values"]), m["fre_zipf"], dt_doc.shape[0],
                       gen.generator(seed, device, 1), device)
    da_doc, da_author = gen.relation(n_docs, n_authors, m["da_rows_per_document"],
                                     m["author_zipf"], gen.generator(seed, device, 2), device)
    year = torch.randint(int(m["year_min"]), int(m["year_max"]) + 1, (n_docs,),
                         generator=gen.generator(seed, device, 3), device=device)
    return {
        "entities": {
            "Document": {"size": n_docs, "attributes": {"Year": year}},
            "Term": {"size": n_terms, "attributes": {}},
            "Author": {"size": n_authors, "attributes": {}},
        },
        "relationships": {
            "DT": {"fk1": "Doc", "fk2": "Term", "entity1": "Document", "entity2": "Term",
                   "columns": {"Doc": dt_doc, "Term": dt_term, "Fre": fre}},
            "DA": {"fk1": "Doc", "fk2": "Author", "entity1": "Document", "entity2": "Author",
                   "columns": {"Doc": da_doc, "Author": da_author}},
        },
    }
