"""Synthetic Zipf-matched stand-ins for the paper's datasets (Tables 1-2).

PubMed is a public corpus but not shipped offline; these generators match the
statistics that drive GQ-Fast's behaviour — domain sizes, fanout, and Zipf skew
of term popularity / frequency measures — at a configurable scale factor.
"""
from __future__ import annotations

import numpy as np

from ..core.schema import EntityTable, RelationshipTable, Schema


def _zipf_choice(rng: np.random.Generator, n: int, size: int, s: float = 1.1) -> np.ndarray:
    """Zipf-distributed ids in [0, n) (popular ids are small)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def _dedupe_pairs(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    key = a.astype(np.int64) * (b.max() + 1) + b
    _, idx = np.unique(key, return_index=True)
    return a[idx], b[idx]


def make_pubmed(
    n_docs: int = 20_000,
    n_terms: int = 500,
    n_authors: int = 5_000,
    avg_terms_per_doc: float = 8.0,
    avg_authors_per_doc: float = 3.0,
    zipf_term: float = 1.1,
    fre_zipf: float = 1.5,
    seed: int = 0,
) -> Schema:
    """PubMed-M/MS-shaped schema: DT(Doc, Term, Fre), DA(Doc, Author),
    Document(ID, Year). Raise ``n_terms`` (lower term fanout) for the -MS flavor."""
    rng = np.random.default_rng(seed)

    e_dt = int(n_docs * avg_terms_per_doc)
    dt_doc = rng.integers(0, n_docs, size=e_dt)
    dt_term = _zipf_choice(rng, n_terms, e_dt, zipf_term)
    dt_doc, dt_term = _dedupe_pairs(dt_doc, dt_term)
    fre = 1 + _zipf_choice(rng, 50, dt_doc.shape[0], fre_zipf)

    e_da = int(n_docs * avg_authors_per_doc)
    da_doc = rng.integers(0, n_docs, size=e_da)
    da_author = _zipf_choice(rng, n_authors, e_da, 1.05)
    da_doc, da_author = _dedupe_pairs(da_doc, da_author)

    year = rng.integers(1990, 2016, size=n_docs)

    schema = Schema(
        entities={
            "Document": EntityTable("Document", n_docs, {"Year": year}),
            "Term": EntityTable("Term", n_terms),
            "Author": EntityTable("Author", n_authors),
        },
        relationships={
            "DT": RelationshipTable(
                "DT", "Doc", "Term", "Document", "Term",
                {"Doc": dt_doc, "Term": dt_term, "Fre": fre},
            ),
            "DA": RelationshipTable(
                "DA", "Doc", "Author", "Document", "Author",
                {"Doc": da_doc, "Author": da_author},
            ),
        },
    )
    schema.validate()
    return schema


def make_semmeddb(
    n_concepts: int = 4_000,
    n_csemtypes: int = 5_000,
    n_predications: int = 8_000,
    n_sentences: int = 30_000,
    seed: int = 1,
) -> Schema:
    """SemMedDB-shaped schema (paper Fig. 10 / Table 2 — low fanout):
    CS(CID, CSID), PA(CSID, PID), SP(PID, SID)."""
    rng = np.random.default_rng(seed)

    # CS: each concept has ~1.16 semtypes
    n_cs = int(n_csemtypes)
    cs_cid = rng.integers(0, n_concepts, size=n_cs)
    cs_csid = np.arange(n_csemtypes)  # concept_semtype ids are unique per row
    # PA: each predication links ~2.15 concept_semtypes
    n_pa = int(n_predications * 2.15)
    pa_csid = _zipf_choice(rng, n_csemtypes, n_pa, 1.05)
    pa_pid = rng.integers(0, n_predications, size=n_pa)
    pa_csid, pa_pid = _dedupe_pairs(pa_csid, pa_pid)
    # SP: sentences → predications, fanout ~1.61
    n_sp = int(n_sentences * 1.6)
    sp_pid = _zipf_choice(rng, n_predications, n_sp, 1.05)
    sp_sid = rng.integers(0, n_sentences, size=n_sp)
    sp_pid, sp_sid = _dedupe_pairs(sp_pid, sp_sid)

    schema = Schema(
        entities={
            "Concept": EntityTable("Concept", n_concepts),
            "ConceptSemtype": EntityTable("ConceptSemtype", n_csemtypes),
            "Predication": EntityTable("Predication", n_predications),
            "Sentence": EntityTable("Sentence", n_sentences),
        },
        relationships={
            "CS": RelationshipTable(
                "CS", "CID", "CSID", "Concept", "ConceptSemtype",
                {"CID": cs_cid, "CSID": cs_csid},
            ),
            "PA": RelationshipTable(
                "PA", "CSID", "PID", "ConceptSemtype", "Predication",
                {"CSID": pa_csid, "PID": pa_pid},
            ),
            "SP": RelationshipTable(
                "SP", "PID", "SID", "Predication", "Sentence",
                {"PID": sp_pid, "SID": sp_sid},
            ),
        },
    )
    schema.validate()
    return schema


# ---------------------------------------------------------------------------
# The paper's benchmark queries (§4), parameterized
# ---------------------------------------------------------------------------

QUERY_SD = """
SELECT dt2.Doc, COUNT(*)
FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
WHERE dt1.Doc = :d0
GROUP BY dt2.Doc
"""

QUERY_FSD = """
SELECT dt2.Doc, SUM(dt1.Fre * dt2.Fre) / (abs(d1.Year - d2.Year) + 1)
FROM (((Document d1 JOIN DT dt1 ON d1.ID = dt1.Doc)
  JOIN DT dt2 ON dt1.Term = dt2.Term)
  JOIN Document d2 ON d2.ID = dt2.Doc)
WHERE d1.ID = :d0
GROUP BY dt2.Doc
"""

QUERY_AS = """
SELECT da2.Author, SUM(dt1.Fre * dt2.Fre) / (2017 - d.Year)
FROM ((((DA da1 JOIN DT dt1 ON da1.Doc = dt1.Doc)
  JOIN DT dt2 ON dt1.Term = dt2.Term)
  JOIN Document d ON dt2.Doc = d.ID)
  JOIN DA da2 ON dt2.Doc = da2.Doc)
WHERE da1.Author = :a0
GROUP BY da2.ID
"""

QUERY_AD = """
SELECT da.Author, COUNT(*)
FROM DA da
WHERE da.Doc IN
  (SELECT dt.Doc FROM DT dt WHERE dt.Term = :t1)
  INTERSECT
  (SELECT dt.Doc FROM DT dt WHERE dt.Term = :t2)
GROUP BY da.Author
"""

QUERY_FAD = """
SELECT dt2.Term, SUM(dt2.Fre)
FROM DT dt2
WHERE dt2.Doc IN
  (SELECT dt.Doc FROM DT dt WHERE dt.Term = :t1)
  INTERSECT
  (SELECT dt.Doc FROM DT dt WHERE dt.Term = :t2)
GROUP BY dt2.Term
"""

QUERY_RECENT_AUTHORS = """
SELECT da.Author
FROM DA da
WHERE da.Doc IN
  (SELECT dt.Doc FROM DT dt WHERE dt.Term = :t1)
  INTERSECT
  (SELECT d.ID FROM Document d WHERE d.Year > :y)
  INTERSECT
  (SELECT da.Doc FROM DA da JOIN DT dt ON da.Doc = dt.Doc WHERE dt.Term = :t2)
"""

QUERY_CS = """
SELECT c2.CID, COUNT(*)
FROM CS c2, PA p2, SP s2
WHERE s2.PID = p2.PID AND p2.CSID = c2.CSID AND s2.SID IN (
  SELECT s1.SID
  FROM CS c1, PA p1, SP s1
  WHERE s1.PID = p1.PID AND p1.CSID = c1.CSID AND c1.CID = :c0)
GROUP BY CID
"""

# Two variants that carry a constant filter on the last hop's Document, the
# shape that forms fused regions with a mask (core/fuse.py): SD restricted to
# recent documents (under fusion="auto" a degenerate hop + filter region), and
# AS restricted to recent documents without the year factor (under
# fusion="on" a two-hop region with a mid mask).
QUERY_SD_RECENT = """
SELECT dt2.Doc, COUNT(*)
FROM ((DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term)
  JOIN Document d ON dt2.Doc = d.ID)
WHERE dt1.Doc = :d0 AND d.Year >= 2005
GROUP BY dt2.Doc
"""

QUERY_AS_RECENT = """
SELECT da2.Author, SUM(dt1.Fre * dt2.Fre)
FROM ((((DA da1 JOIN DT dt1 ON da1.Doc = dt1.Doc)
  JOIN DT dt2 ON dt1.Term = dt2.Term)
  JOIN Document d ON dt2.Doc = d.ID)
  JOIN DA da2 ON dt2.Doc = da2.Doc)
WHERE da1.Author = :a0 AND d.Year >= 2005
GROUP BY da2.ID
"""

PUBMED_QUERIES = {
    "SD": QUERY_SD,
    "FSD": QUERY_FSD,
    "AS": QUERY_AS,
    "AD": QUERY_AD,
    "FAD": QUERY_FAD,
}
