"""Query profiling in the PyTorch port on the CPU: ``PreparedQuery.profile``,
``explain(analyze=True)``, the recorded walk and the calibration feed, as
tests/test_obs.py checks them in the JAX package (its distributed case
waits for the port's mesh), and the observed hop fractions against the JAX
package's numpy walk of the same plan, integer for integer."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.obs.profile import observed_hop_fractions as j_observed  # noqa: E402
from repro_torch.core import executor as X  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import params as KP  # noqa: E402
from repro_torch.obs import metrics as M  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.obs.profile import mispredicted, observed_hop_fractions  # noqa: E402
from torch_fixtures import lists_at_every_size  # noqa: E402,F401 (autouse)

PUBMED = dict(n_docs=1500, n_terms=80, n_authors=400, seed=3)


@pytest.fixture(scope="module")
def small_db():
    return GQFastDatabase(SG.make_pubmed(**PUBMED), account_space=False, device="cpu")


CASES = [
    ("frontier", SG.QUERY_SD, {"d0": 17}),
    ("frontier", SG.QUERY_AD, {"t1": 3, "t2": 7}),  # mask seed + semijoin
    ("fragment_loop", SG.QUERY_SD, {"d0": 17}),  # the scalar walk
    ("fragment_loop", SG.QUERY_AD, {"t1": 3, "t2": 7}),  # frontier fallback
]


@pytest.mark.parametrize("strategy,sql,params", CASES,
                         ids=["frontier-SD", "frontier-AD", "fragment_loop-SD",
                              "fragment_loop-AD"])
def test_profile_bit_identical_to_call(small_db, strategy, sql, params):
    pq = GQFastEngine(small_db, strategy=strategy).prepare(sql)
    plain = pq(**params)
    prof = pq.profile(reps=1, **params)
    # the profile's result comes from the executable __call__ runs
    assert np.array_equal(prof.result, plain)
    assert prof.strategy == strategy
    assert prof.total_wall_ms > 0


def test_profile_covers_every_ir_op_and_hops(small_db):
    pq = GQFastEngine(small_db).prepare(SG.QUERY_AS)
    prof = pq.profile(reps=1, a0=5)
    assert len(prof.ops) == len(pq.phys.ops)
    assert all(not o.fused and o.wall_ms is not None for o in prof.ops)
    # one HopProfile per hop estimate, with both fractions populated
    assert len(prof.hops) == len(pq.hop_estimates)
    for h in prof.hops:
        assert 0.0 <= h.observed_active_fraction <= 1.0
        assert h.est_active_fraction >= 0.0
    hop_ops = [o for o in prof.ops if o.name.startswith("Hop(")]
    assert len(hop_ops) == len(prof.hops)
    for o, h in zip(hop_ops, prof.hops):
        # the recorded walk's own observation on the frontier, and the walk's
        assert o.meta["observed_active_fraction"] == pytest.approx(
            h.observed_active_fraction, abs=1e-6)
        assert o.meta["active_blocks"] == h.meta["active_blocks"]
    d = json.loads(prof.to_json())
    assert d["strategy"] == "frontier" and d["ops"] and d["hops"]
    assert list(prof.phase_summary()) == [f"[{o.index}] {o.name}" for o in prof.ops]


def test_explain_analyze_renders_timings_and_fractions(small_db):
    pq = GQFastEngine(small_db).prepare(SG.QUERY_SD)
    plain = pq.explain()
    text = pq.explain(analyze=True, d0=17)
    assert text.startswith(plain)  # analyze extends, never replaces, the plan
    assert "analyze: total" in text
    assert "wall" in text and "kernel" in text
    assert "predicted vs observed active fraction" in text
    assert "est=" in text and "obs=" in text
    assert "memory: device" in text


def test_mispredict_classification():
    assert not mispredicted(0.1, 0.15)  # within 2x
    assert mispredicted(0.1, 0.30)  # observed 3x over
    assert mispredicted(0.1, 0.01)  # observed 10x under
    assert not mispredicted(0.0, 0.0)  # both empty: agree
    assert mispredicted(0.0, 0.5)  # predicted none, saw plenty
    assert not mispredicted(0.2, 0.4, factor=2.0)  # the boundary is inclusive
    assert not mispredicted(None, 0.4)


@pytest.mark.parametrize("strategy", ["frontier", "fragment_loop"])
def test_per_op_self_walls_sum_to_total(small_db, strategy):
    pq = GQFastEngine(small_db, strategy=strategy).prepare(SG.QUERY_FSD)
    prof = pq.profile(reps=3, d0=17)
    assert prof.timing_method == "eager-span-scaled"
    walls = [o.wall_ms for o in prof.ops if o.wall_ms is not None]
    assert walls, "at least the non-fused ops must carry a self wall"
    assert abs(sum(walls) - prof.total_wall_ms) <= max(1e-6 * prof.total_wall_ms, 1e-9)
    for o in prof.ops:
        if o.wall_ms is not None:  # the raw recorded measurement kept per op
            assert o.meta["eager_wall_ms"] >= 0.0
            assert o.kernel_ms is None or o.kernel_ms <= o.wall_ms + 1e-9


def test_profile_feeds_strategy_calibration(small_db, monkeypatch):
    monkeypatch.setattr(KP, "FRAGMENT_LOOP_CROSSOVER", 0.15)
    eng = GQFastEngine(small_db, strategy="auto")
    pq = eng.prepare(SG.QUERY_SD)
    assert pq.plan_sig and eng.calibration.get(pq.plan_sig) is None
    prof = pq.profile(reps=1, d0=17)
    obs = eng.calibration.get(pq.plan_sig)
    assert obs == [h.observed_active_fraction for h in prof.hops]
    # the store overrides the fanout model on the next strategy choice
    eng.calibration.record(pq.plan_sig, [0.01])
    assert eng._pick_strategy(pq.plan, pq.plan_sig) == "fragment_loop"
    eng.calibration.record(pq.plan_sig, [0.5])
    assert eng._pick_strategy(pq.plan, pq.plan_sig) == "frontier"


def test_strategy_mispredict_counter_increments(small_db):
    pq = GQFastEngine(small_db).prepare(SG.QUERY_AD)  # semijoin: the estimate is 1.0
    before = M.REGISTRY.counter("strategy_mispredict").value
    runs = M.REGISTRY.counter("profile_runs").value
    prof = pq.profile(reps=1, t1=3, t2=7)
    n_mis = sum(1 for h in prof.hops if h.mispredict)
    assert n_mis >= 1
    assert M.REGISTRY.counter("strategy_mispredict").value - before == n_mis
    assert M.REGISTRY.counter("profile_runs").value - runs == 1


def test_disabled_call_path_untouched(small_db, monkeypatch):
    """With no tracer installed, __call__ never reaches the instrumented
    walk; under recording it does, and matches the plain result."""
    pq = GQFastEngine(small_db).prepare(SG.QUERY_SD)
    with monkeypatch.context() as mp:
        def boom(*a, **k):
            raise AssertionError("the instrumented walk ran with no tracer")

        mp.setattr(X, "_walk_ir_recorded", boom)
        mp.setattr(X, "_annotate_op_span", boom)
        plain = pq(d0=9)
        batch = pq.execute_batch(d0=[9, 10])
    np.testing.assert_array_equal(batch[0], plain)
    with T.recording() as tr:
        recorded = pq(d0=9)
    assert np.array_equal(plain, recorded)
    names = [s.name for s in tr.iter_spans()]
    assert "execute" in names
    assert sum(1 for s in tr.iter_spans() if "op_index" in s.meta) == len(pq.phys.ops)


def test_prepare_emits_lifecycle_spans(small_db):
    for strategy in ("frontier", "fragment_loop"):
        eng = GQFastEngine(small_db, strategy=strategy)
        with T.recording() as tr:
            eng.prepare(SG.QUERY_AS)
        names = [s.name for s in tr.iter_spans()]
        for phase in ("prepare", "parse", "plan", "lower", "compile"):
            assert phase in names, names
        prep = tr.roots[0]
        assert prep.name == "prepare"
        assert [c.name for c in prep.children] == ["parse", "plan", "lower", "compile"]
        assert prep.children[-1].meta["strategy"] == strategy


CASES_NINE = [
    ("SD", SG.QUERY_SD, {"d0": 17}),
    ("FSD", SG.QUERY_FSD, {"d0": 17}),
    ("AS", SG.QUERY_AS, {"a0": 5}),
    ("AD", SG.QUERY_AD, {"t1": 3, "t2": 7}),
    ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 7}),
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 7, "y": 2005}),
    ("CS", SG.QUERY_CS, {"c0": 11}),
    ("SD_RECENT", SG.QUERY_SD_RECENT, {"d0": 17}),
    ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 5}),
]
SEMMED = dict(n_concepts=400, n_csemtypes=500, n_predications=800, n_sentences=3000)


@pytest.fixture(scope="module")
def pairs(small_db):
    """The port's and the JAX package's engines on each graph (auto storage,
    fusion on, so both sides' fused regions are walked member by member)."""
    sem = GQFastDatabase(SG.make_semmeddb(**SEMMED), account_space=False, device="cpu")
    return {
        "pubmed": (GQFastEngine(small_db),
                   JEngine(JDatabase(JSG.make_pubmed(**PUBMED), account_space=False))),
        "semmed": (GQFastEngine(sem),
                   JEngine(JDatabase(JSG.make_semmeddb(**SEMMED), account_space=False))),
    }


@pytest.mark.parametrize("name,q,params", CASES_NINE, ids=[c[0] for c in CASES_NINE])
def test_observed_fractions_equal_the_reference_walk(pairs, name, q, params):
    port, jax_ = pairs["semmed" if name == "CS" else "pubmed"]
    got = observed_hop_fractions(port.prepare(q, fusion="on").phys, params)
    want = j_observed(jax_.prepare(q, fusion="on").phys, params)
    assert got, "every query has a hop"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("table", "src_key", "touched_edges", "E", "frontier_nnz", "reached",
                  "active_blocks", "n_blocks"):
            assert g[k] == w[k], (name, k, g, w)
        assert g["observed_active_fraction"] == w["observed_active_fraction"]
        assert g["active_block_fraction"] == w["active_block_fraction"]


def test_walk_prefix_equals_the_reference(pairs):
    """``walk_ir(..., stop=k)``, the profiling prefix entry, returns the raw
    state after k ops: the frontier after each of SD's ops, equal to the JAX
    package's prefix walk."""
    import jax.numpy as jnp
    from repro.core import executor as JX
    from repro.core.semiring import SUM_PRODUCT as JSUM
    from repro_torch.core.semiring import SUM_PRODUCT

    port, jax_ = pairs["pubmed"]
    phys = port.prepare(SG.QUERY_SD, fusion="off").phys
    jphys = jax_.prepare(SG.QUERY_SD, fusion="off").phys
    for stop in range(1, len(phys.ops) + 1):
        got = X.walk_ir(phys, X._FrontierInterp({"d0": 17}, SUM_PRODUCT, device="cpu",
                                                block_skipping="off"), stop=stop)
        want = JX.walk_ir(jphys, JX._FrontierInterp({"d0": jnp.asarray(17)}, JSUM,
                                                    block_skipping="off"), stop=stop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
