"""Pipelined fusion in the PyTorch port against the JAX package, on the CPU.

The region pass (formation boundaries, recursion into mask seeds, the unfuse
inverse, the reach matrix), the fused dispatch's block lists and results
(every op × dense/packed operands × skip mode × two-hop/degenerate region),
and the engine surface (the nine queries and every aggregate under 'auto' and
'on', explain, modes). The same numpy inputs go through both packages; the
JAX kernels run in interpret mode, the port its plain versions. Integer data
(plans, reach matrices, block lists) is equal; min/max/bool results are equal
and sum within rtol=atol=1e-4.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fuse as jfuse  # noqa: E402
from repro.core import lower as jlower  # noqa: E402
from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.storage import DenseColumn as JDenseColumn  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.fragments import _pack_words  # noqa: E402
from repro_torch.core.fuse import (  # noqa: E402
    _block_reach,
    fuse_plan,
    fusion_groups,
    has_fused,
    unfuse_plan,
)
from repro_torch.core.lower import (  # noqa: E402
    DegreeFilterOp,
    EntityFilterOp,
    FusedHopOp,
    GroupOp,
    HopOp,
    LCond,
    PhysicalPlan,
    SeedOp,
)
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import active, ops  # noqa: E402
from repro_torch.kernels.params import EDGE_BLOCK  # noqa: E402
from repro_torch.robust.errors import ValidationError  # noqa: E402
from repro_torch.storage import DenseColumn  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

OPS = ["sum", "min", "max", "bool"]
ZERO = {"sum": 0.0, "min": np.inf, "max": -np.inf, "bool": 0.0}


def _assert_match(got, want, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# IR pass: region formation
# ---------------------------------------------------------------------------


def _edges(n_src, n_dst, E, seed):
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n_src, E)).astype(np.int32)
    dst = rng.integers(0, n_dst, E).astype(np.int32)
    indptr = np.searchsorted(src, np.arange(n_src + 1)).astype(np.int32)
    return src, dst, indptr


def _mk_hop(n_src: int, n_dst: int, E: int, seed: int, **kw) -> HopOp:
    src, dst, indptr = _edges(n_src, n_dst, E, seed)
    smin, smax = active.block_ranges(src)
    t = torch.from_numpy
    return HopOp("T", f"K{seed}", "E2", n_dst, t(indptr), t(src), DenseColumn(t(dst)),
                 block_src_min=t(smin), block_src_max=t(smax), **{"hot_share": 0.0, **kw})


def _mk_jhop(n_src: int, n_dst: int, E: int, seed: int) -> jlower.HopOp:
    src, dst, indptr = _edges(n_src, n_dst, E, seed)
    smin, smax = active.block_ranges(src)
    return jlower.HopOp("T", f"K{seed}", "E2", n_dst, jnp.asarray(indptr), jnp.asarray(src),
                        JDenseColumn(jnp.asarray(dst)), block_src_min=smin,
                        block_src_max=smax)


def _mk_plan(ops_, agg="sum", out_dom=64):
    return PhysicalPlan(tuple(ops_), (), agg, out_dom, None)


def _seed(dom=64):
    return SeedOp("E0", dom, ids=(3,))


def _ones(n):
    return torch.ones(n, dtype=torch.float32)


def test_two_hop_chain_fuses_with_trailing_group():
    h1, h2 = _mk_hop(64, 48, 500, 1), _mk_hop(48, 64, 600, 2)
    p = _mk_plan([_seed(), h1, h2, GroupOp("E2", 64)])
    f = fuse_plan(p)
    assert [type(o).__name__ for o in f.ops] == ["SeedOp", "FusedHopOp"]
    region = f.ops[1]
    assert region.members == (h1, h2, p.ops[3])
    assert region.n_mid == h1.dom_dst
    assert region.hops == (h1, h2) and region.group is p.ops[3]
    assert region.reach is not None and region.reach.dtype == bool
    assert "Fused[" in f.op_signature()[1]
    assert fusion_groups(f) and "Hop(" in fusion_groups(f)[0]


def test_mid_mask_filter_joins_region():
    h1, h2 = _mk_hop(64, 48, 500, 1), _mk_hop(48, 64, 600, 2)
    filt = EntityFilterOp("E1", const_mask=_ones(48))
    p = _mk_plan([_seed(), h1, filt, h2, GroupOp("E2", 64)])
    f = fuse_plan(p)
    assert [type(o).__name__ for o in f.ops] == ["SeedOp", "FusedHopOp"]
    assert f.ops[1].mid_filters == (filt,)


def test_bare_single_hop_stays_unfused():
    p = _mk_plan([_seed(), _mk_hop(64, 64, 500, 1), GroupOp("E2", 64)])
    f = fuse_plan(p)
    assert not has_fused(f)
    assert f.ops == p.ops


def test_one_hop_plus_mask_filter_fuses_degenerate():
    h1 = _mk_hop(64, 64, 500, 1)
    filt = EntityFilterOp("E2", const_mask=_ones(64))
    p = _mk_plan([_seed(), h1, filt, GroupOp("E2", 64)])
    f = fuse_plan(p)
    assert isinstance(f.ops[1], FusedHopOp)
    assert f.ops[1].hops == (h1,) and f.ops[1].reach is None


def test_degree_filter_ends_region():
    h1, h2 = _mk_hop(64, 48, 500, 1), _mk_hop(48, 64, 600, 2)
    dfilt = DegreeFilterOp("T", "K", torch.ones(48, dtype=torch.int32))
    p = _mk_plan([_seed(), h1, dfilt, h2, GroupOp("E2", 64)])
    f = fuse_plan(p)
    assert not has_fused(f)
    assert [type(o).__name__ for o in f.ops] == [
        "SeedOp", "HopOp", "DegreeFilterOp", "HopOp", "GroupOp",
    ]


@pytest.mark.parametrize("kind", ["param_conds", "factor"])
def test_factor_or_param_filter_ends_region(kind):
    from repro_torch.core.lower import LConst

    h1, h2 = _mk_hop(64, 48, 500, 1), _mk_hop(48, 64, 600, 2)
    if kind == "param_conds":
        filt = EntityFilterOp("E1", param_conds=(LCond(("attr", "E1", "x"), _ones(48), ">", 0),))
    else:
        filt = EntityFilterOp("E1", factor=LConst(2.0))
    p = _mk_plan([_seed(), h1, filt, h2, GroupOp("E2", 64)])
    assert not has_fused(fuse_plan(p))


def test_group_only_joins_as_plan_tail():
    h1, h2 = _mk_hop(64, 48, 500, 1), _mk_hop(48, 64, 600, 2)
    p = _mk_plan([_seed(), h1, h2, GroupOp(None, 64),
                  EntityFilterOp("E2", const_mask=_ones(64))])
    f = fuse_plan(p)
    region = f.ops[1]
    assert isinstance(region, FusedHopOp) and region.group is None
    assert [type(o).__name__ for o in f.ops] == [
        "SeedOp", "FusedHopOp", "GroupOp", "EntityFilterOp",
    ]


def test_mask_seed_subprograms_fuse_recursively():
    sub = _mk_plan(
        [SeedOp("E0", 64, ids=(1,)), _mk_hop(64, 48, 500, 3),
         _mk_hop(48, 64, 600, 4), GroupOp(None, 64)], agg=None,
    )
    seed = SeedOp("E0", 64, ids=None, programs=(sub,))
    p = _mk_plan([seed, _mk_hop(64, 64, 500, 1), GroupOp("E2", 64)])
    f = fuse_plan(p)
    assert has_fused(f)  # only via the sub-program
    assert isinstance(f.ops[0].programs[0].ops[1], FusedHopOp)
    assert not has_fused(unfuse_plan(f))


def test_unfuse_is_exact_inverse():
    h1, h2 = _mk_hop(64, 48, 500, 1), _mk_hop(48, 64, 600, 2)
    filt = EntityFilterOp("E1", const_mask=_ones(48))
    p = _mk_plan([_seed(), h1, filt, h2, GroupOp("E2", 64)])
    assert unfuse_plan(fuse_plan(p)).ops == p.ops  # same member objects, same order


@pytest.mark.parametrize("shape", [(64, 9000, 6000, 2 * EDGE_BLOCK), (500, 300, 3 * EDGE_BLOCK + 5,
                                                                       2 * EDGE_BLOCK + 1000),
                                   (40, 7, 1, 1)])
def test_reach_matrix_matches_brute_force_and_reference(shape):
    n0, n1, e1, e2 = shape
    h1, h2 = _mk_hop(n0, n1, e1, 7), _mk_hop(n1, 64, e2, 8)
    reach = _block_reach(h1, h2)
    dst1 = h1.dst_ids.numpy()
    smin2, smax2 = h2.block_src_min.numpy(), h2.block_src_max.numpy()
    nb1, nb2 = reach.shape
    assert nb1 == active.n_edge_blocks(dst1.shape[0]) and nb2 == smin2.shape[0]
    for b1 in range(nb1):
        vals = dst1[b1 * EDGE_BLOCK:(b1 + 1) * EDGE_BLOCK]
        want = ((vals[:, None] >= smin2) & (vals[:, None] <= smax2)).any(0)
        np.testing.assert_array_equal(reach[b1], want)
    jreach = jfuse._block_reach(_mk_jhop(n0, n1, e1, 7), _mk_jhop(n1, 64, e2, 8))
    assert reach.dtype == jreach.dtype == bool
    np.testing.assert_array_equal(reach, jreach)
    # the host column gives the same matrix as the device column
    h1.host_dst = dst1.astype(np.int64)
    np.testing.assert_array_equal(_block_reach(h1, h2), reach)


# ---------------------------------------------------------------------------
# The fused dispatch: block lists and results against the reference
# ---------------------------------------------------------------------------


N0, N1, N2 = 512, 300, 256
MDICT = np.array([0.5, 3.0, 0.0, 7.25, 1.0], np.float32)


@pytest.fixture(scope="module")
def chain():
    """Two-hop chain over several edge blocks: hop1 E0→E1, hop2 E1→E2 (hop2's
    length not block-aligned)."""
    rng = np.random.default_rng(11)
    E1, E2 = 2 * EDGE_BLOCK, 2 * EDGE_BLOCK + 1000
    src1 = np.sort(rng.integers(0, N0, E1)).astype(np.int32)
    dst1 = rng.integers(0, N1, E1).astype(np.int32)
    m1 = rng.integers(1, 8, E1)
    src2 = np.sort(rng.integers(0, N1, E2)).astype(np.int32)
    dst2 = rng.integers(0, N2, E2).astype(np.int32)
    m2 = rng.integers(0, 5, E2)  # dictionary indices (packed) or values (dense)
    mask = (rng.random(N1) < 0.7).astype(np.float32)
    return dict(src1=src1, dst1=dst1, m1=m1, src2=src2, dst2=dst2, m2=m2, mask=mask,
                E1=E1, E2=E2)


def _reach(c):
    r = np.zeros((active.n_edge_blocks(c["E1"]), active.n_edge_blocks(c["E2"])), bool)
    smin2, smax2 = active.block_ranges(c["src2"])
    for b in range(r.shape[0]):
        vals = c["dst1"][b * EDGE_BLOCK:(b + 1) * EDGE_BLOCK]
        r[b] = ((vals[:, None] >= smin2) & (vals[:, None] <= smax2)).any(0)
    return r


def _operands(c, layout, pkg):
    """(hop1, hop2) operand bundles for ``pkg`` ('port' | 'jax'): dense —
    int32 dst and float32 measures; packed — BCA dst (9 and 8 bits), hop1's
    measure packed (3 bits), hop2's a 3-bit dictionary index."""
    Cls = (partial(ops.FusedHopOperands, hot_share=0.0) if pkg == "port"
           else jops.FusedHopOperands)
    conv = (lambda a: torch.from_numpy(np.ascontiguousarray(a))) if pkg == "port" else np.asarray
    words = (lambda v, b: conv(_pack_words(v, b).view(np.int32))) if pkg == "port" else (
        lambda v, b: _pack_words(v, b))
    b1 = tuple(conv(b) for b in active.block_ranges(c["src1"]))
    b2 = tuple(conv(b) for b in active.block_ranges(c["src2"]))
    reach = _reach(c)
    if layout == "dense":
        h1 = Cls(conv(c["src1"]), conv(c["dst1"]), conv(c["m1"].astype(np.float32)),
                 n_dst=N1, m_mode="dense", blocks=b1)
        h2 = Cls(conv(c["src2"]), conv(c["dst2"]), conv(MDICT[c["m2"]]), n_dst=N2,
                 m_mode="dense", blocks=b2, reach=reach)
    else:
        h1 = Cls(conv(c["src1"]), words(c["dst1"], 9), words(c["m1"], 3), n_dst=N1,
                 dst_width=9, m_mode="packed", m_width=3, blocks=b1)
        h2 = Cls(conv(c["src2"]), words(c["dst2"], 8), words(c["m2"], 3), conv(MDICT),
                 n_dst=N2, dst_width=8, m_mode="dict", m_width=3, blocks=b2, reach=reach)
    return h1, h2


def _frontier(op, support, seed=5):
    """Weights on the sources ``support`` (a slice), the identity elsewhere."""
    rng = np.random.default_rng(seed)
    w = np.full(N0, ZERO[op], np.float32)
    vals = rng.random(N0).astype(np.float32) * 2 + 0.1
    if op == "bool":
        vals = (vals > 1).astype(np.float32)
    w[support] = vals[support]
    return w


SUPPORTS = {"one_seed": slice(7, 8), "first_block": slice(0, 40), "all": slice(0, N0)}


@pytest.mark.parametrize("block_skipping", ["off", "on", "auto"])
@pytest.mark.parametrize("support", list(SUPPORTS))
def test_fused_block_lists_match_reference_under_jit(chain, support, block_skipping):
    w = _frontier("sum", SUPPORTS[support])
    h1, h2 = _operands(chain, "dense", "port")
    j1, j2 = _operands(chain, "dense", "jax")
    E1, E2 = chain["E1"], chain["E2"]
    got = ops._fused_block_lists(torch.from_numpy(w), "sum", h1, h2, E1, E2, block_skipping)
    want = jax.jit(lambda x: jops._fused_block_lists(x, "sum", j1, j2, E1, E2,
                                                     block_skipping))(jnp.asarray(w))
    for (bi, na), (jbi, jna) in ((got[:2], want[:2]), (got[2:], want[2:])):
        n = int(na[0])
        assert n == int(np.asarray(jna)[0])
        np.testing.assert_array_equal(bi[:n].numpy(), np.asarray(jbi)[:n])
    if block_skipping != "off" and support == "one_seed":
        assert int(got[1][0]) < active.n_edge_blocks(E1)  # the support list skips


@pytest.mark.parametrize("kind", ["two_hop", "degenerate"])
@pytest.mark.parametrize("block_skipping", ["off", "on", "auto"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("op", OPS)
def test_fused_dispatch_matches_reference(chain, op, layout, block_skipping, kind):
    """ops.fragment_spmv_fused (plain on the CPU) against the reference's
    fused kernel in interpret mode and against the port's unfused
    composition; the two-hop region carries a mid mask and binarizes."""
    w = _frontier(op, SUPPORTS["first_block"])
    h1, h2 = _operands(chain, layout, "port")
    j1, j2 = _operands(chain, layout, "jax")
    two = kind == "two_hop"
    kw = dict(op=op, mid_binarize=two, block_skipping=block_skipping)
    mask = chain["mask"] if two else (np.arange(N1) % 3 != 0).astype(np.float32)
    got = ops.fragment_spmv_fused(torch.from_numpy(w), h1, h2 if two else None,
                                  torch.from_numpy(mask), fusion="on", **kw)
    want = jops.fragment_spmv_fused(w, j1, j2 if two else None, mask, fusion="on", **kw)
    unfused = ops.fragment_spmv_fused(torch.from_numpy(w), h1, h2 if two else None,
                                      torch.from_numpy(mask), fusion="off", **kw)
    _assert_match(got.numpy(), np.asarray(want), op)
    _assert_match(got.numpy(), unfused.numpy(), op)
    assert (got.numpy() != ZERO[op]).any(), "degenerate test: empty result"


def test_auto_over_the_scratch_budget_runs_unfused(chain, monkeypatch):
    """'auto' with a two-hop region's intermediate above
    FUSED_SCRATCH_BUDGET_BYTES composes the unfused hops, and fuses one at
    the budget; the result is the same."""
    w = torch.from_numpy(_frontier("max", SUPPORTS["all"]))
    h1, h2 = _operands(chain, "packed", "port")
    calls = []
    real = ops._compose_unfused
    monkeypatch.setattr(ops, "_compose_unfused", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(ops, "FUSED_SCRATCH_BUDGET_BYTES", 4 * N1)
    fused = ops.fragment_spmv_fused(w, h1, h2, op="max", fusion="auto")
    assert not calls
    monkeypatch.setattr(ops, "FUSED_SCRATCH_BUDGET_BYTES", 4 * N1 - 1)
    unfused = ops.fragment_spmv_fused(w, h1, h2, op="max", fusion="auto")
    assert calls == [1]
    np.testing.assert_array_equal(fused.numpy(), unfused.numpy())
    # the degenerate region keeps no intermediate: no budget applies to it
    ops.fragment_spmv_fused(w, h1, None, _ones(N1), op="max", fusion="auto")
    assert calls == [1]
    with pytest.raises(ValidationError, match="unknown fusion mode"):
        ops.fragment_spmv_fused(w, h1, h2, fusion="bogus")


# ---------------------------------------------------------------------------
# Engine surface
# ---------------------------------------------------------------------------


PUBMED_KW = dict(n_docs=400, n_terms=40, n_authors=120, seed=2)
SEMMED_KW = dict(n_concepts=300, n_csemtypes=400, n_predications=600, n_sentences=2000)

QUERIES = [
    ("SD", SG.QUERY_SD, {"d0": 5}),
    ("FSD", SG.QUERY_FSD, {"d0": 5}),
    ("AS", SG.QUERY_AS, {"a0": 7}),
    ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
    ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
    ("CS", SG.QUERY_CS, {"c0": 11}),
    ("SD_RECENT", SG.QUERY_SD_RECENT, {"d0": 5}),
    ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 7}),
]
EXACT = ("SD", "AD", "RECENT", "CS", "SD_RECENT")

Q_SCORE = """
SELECT dt2.Doc, {call}
FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
WHERE dt1.Doc = :d0
GROUP BY dt2.Doc
"""


@pytest.fixture(scope="module")
def engines():
    out = {}
    for kind, make, kw in (("pubmed", "make_pubmed", PUBMED_KW),
                           ("semmed", "make_semmeddb", SEMMED_KW)):
        pschema, jschema = getattr(SG, make)(**kw), getattr(JSG, make)(**kw)
        out[kind] = (pschema,
                     GQFastEngine(GQFastDatabase(pschema, account_space=False, device="cpu")),
                     JEngine(JDatabase(jschema, account_space=False)))
    return out


def _regions(phys):
    """Every fused region of a plan, mask sub-programs included, in order."""
    out = []
    for op in phys.ops:
        if type(op).__name__ == "FusedHopOp":
            out.append(op)
        for p in getattr(op, "programs", ()):
            out.extend(_regions(p))
    return out


@pytest.mark.parametrize("fusion", ["auto", "on"])
@pytest.mark.parametrize("name,q,params", QUERIES, ids=[c[0] for c in QUERIES])
def test_queries_match_jax_plans_reach_and_results(engines, name, q, params, fusion):
    """Same op signature and reach matrices as the reference's fused plan;
    results equal to the JAX engine, the port's unfused plan and run_sql."""
    schema, port, jax_ = engines["semmed" if name == "CS" else "pubmed"]
    pq = port.prepare(q, fusion=fusion)
    jpq = jax_.prepare(q, fusion=fusion)
    assert pq.phys.op_signature() == jpq.phys.op_signature()
    regions, jregions = _regions(pq.phys), _regions(jpq.phys)
    assert len(regions) == len(jregions)
    for r, jr in zip(regions, jregions):
        assert (r.reach is None) == (jr.reach is None)
        if r.reach is not None:
            np.testing.assert_array_equal(r.reach, np.asarray(jr.reach))
    got = pq(**params)
    off = port.prepare(q, fusion="off")(**params)
    jgot = np.asarray(jpq(**params))
    want = run_sql(schema, q, params).astype(np.float32)
    if name in EXACT:
        for other in (off, jgot, want):
            np.testing.assert_array_equal(got, other)
    else:
        for other in (off, jgot, want):
            np.testing.assert_allclose(got, other, rtol=1e-4, atol=1e-4)
    assert (got != 0).any(), "degenerate test: empty result"


def test_the_expected_regions_form(engines):
    """SD-recent forms a degenerate region under 'auto', AS-recent a masked
    two-hop region under 'on', CS a semijoin two-hop region under 'on'."""
    _, port, _ = engines["pubmed"]
    _, sport, _ = engines["semmed"]
    sig = port.prepare(SG.QUERY_SD_RECENT).phys.op_signature()
    assert sig[-1] == ("Fused[Hop(DT.Term->Document)+EntityFilter(Document;const_mask)"
                       "+Group(Document)]")
    sig = port.prepare(SG.QUERY_AS_RECENT, fusion="on").phys.op_signature()
    assert sig[-1] == ("Fused[Hop(DT.Term->Document;measure)+EntityFilter(Document;const_mask)"
                       "+Hop(DA.Doc->Author)+Group(Author)]")
    assert any("semijoin" in s and s.startswith("Fused[")
               for s in sport.prepare(SG.QUERY_CS, fusion="on").phys.op_signature())


@pytest.mark.parametrize("fusion", ["auto", "on"])
@pytest.mark.parametrize("agg", ["SUM", "COUNT", "MIN", "MAX", "AVG", "EXISTS"])
def test_every_aggregate_matches_jax(engines, agg, fusion):
    schema, port, jax_ = engines["pubmed"]
    call = {"COUNT": "COUNT(*)", "EXISTS": "EXISTS(*)"}.get(agg, f"{agg}(dt1.Fre * dt2.Fre)")
    q = Q_SCORE.format(call=call)
    pq = port.prepare(q, fusion=fusion)
    assert has_fused(pq.phys) == (fusion == "on")
    got = pq(d0=7)
    jgot = np.asarray(jax_.prepare(q, fusion=fusion)(d0=7))
    off = port.prepare(q, fusion="off")(d0=7)
    if agg in ("SUM", "AVG"):
        np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, off, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_array_equal(got, off)
    np.testing.assert_allclose(got, run_sql(schema, q, {"d0": 7}), rtol=1e-4, atol=1e-4)
    assert (got != 0).any(), "degenerate test: empty result"


def test_explain_prints_one_line_per_region_as_the_reference(engines):
    _, port, jax_ = engines["pubmed"]
    for q, fusion in ((SG.QUERY_AS_RECENT, "on"), (SG.QUERY_SD_RECENT, "auto")):
        text = port.prepare(q, fusion=fusion).explain()
        assert text == jax_.prepare(q, fusion=fusion).explain()
        lines = [ln for ln in text.splitlines() if ln.startswith("  fused region: ")]
        assert len(lines) == len(_regions(port.prepare(q, fusion=fusion).phys)) >= 1
        assert f"fusion: {fusion}" in text


def test_fusion_modes_are_validated_and_cached_apart(engines):
    _, port, _ = engines["pubmed"]
    with pytest.raises(ValidationError, match="fusion must be one of"):
        port.prepare(SG.QUERY_SD, fusion="bogus")
    pqs = {f: port.prepare(SG.QUERY_AS_RECENT, fusion=f) for f in ("off", "on", "auto")}
    assert len({id(p) for p in pqs.values()}) == 3
    assert all(pqs[f].fusion == f for f in pqs)
    assert port.prepare(SG.QUERY_AS_RECENT) is pqs["auto"]  # 'auto' is the default
    assert not has_fused(pqs["off"].phys) and has_fused(pqs["on"].phys)


def test_reach_reaches_the_device_once_per_prepared_plan(engines):
    """The compiled plan holds the device copy of every region's reach
    matrix; calls reuse it."""
    _, port, _ = engines["pubmed"]
    pq = port.prepare(SG.QUERY_SD, fusion="on")
    (region,) = _regions(pq.phys)
    copy = pq.fn.reach[id(region)]
    assert copy.dtype == torch.bool and np.array_equal(copy.numpy(), region.reach)
    pq(d0=5)
    assert pq.fn.reach[id(region)] is copy
