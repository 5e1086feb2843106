"""The distributed strategy of the port against the JAX package's, on the CPU.

The JAX package runs one controller over 8 forced host devices, in a
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it); this module imports it nowhere else.
The port runs one process a rank over ``torch.distributed`` with gloo:

  * a world of 4 (a 1-D ``("data",)`` mesh, then a 2×2 ``("data", "model")``
    mesh with both axes sharded) on ``make_pubmed(500, 50, 200)`` and
    ``make_semmeddb()``: the nine queries plus EXISTS, MIN and MAX under the
    parity contract (counts, min, max and bool exact; sums within
    rtol=atol=1e-4) against the reference's 8-device distributed engine and
    ``run_sql``; every rank's answer equal to rank 0's; AS at a0 = 0..5
    batched on the 2×2 mesh against the reference's batched distributed form
    on its own 2×2 mesh; each rank's shard integer-equal to the reference's
    shard r of a 4-device mesh, its padding dropped; ``frontier_dtype=
    bfloat16`` against the reference's bf16 run;
  * worlds of 2 where one rank fails (a fault site, a kernel, a deadline, a
    ``runner.execute`` fault, a rank that exits): every rank ends with the
    same typed error within the group's timeout, each case in its own
    processes with their own time limit;
  * a world of 1 in this process: the ports of
    ``tests/test_obs.py::test_profile_distributed_bit_identical`` and
    ``tests/test_batched.py::test_distributed_batched``, the mesh's checks,
    the admission estimate against what the walk holds.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.core import executor as X  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.core.reference import run_sql  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_mesh  # noqa: E402
from repro_torch.robust import estimate_query_bytes  # noqa: E402
from repro_torch.robust.errors import ValidationError  # noqa: E402
from torch_fixtures import LiveBytes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: bfloat16 keeps 8 bits of mantissa: one rounding of a frontier entry errs by
#: up to 2^-8 of it, and a two-hop query rounds twice (each hop's all_reduce
#: input) in either package: 2 · 2^-8 relative, with the same bound again as
#: room for the two packages' different summation orders.
BF16_RTOL = 4 * 2.0 ** -8

#: Each world's time limit, and the group's timeout inside it.
WORLD_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 20

# The cases, as source shared by both sides: (name, query, params, graph).
CASES_SRC = textwrap.dedent('''
    Q_SCORE = """
    SELECT dt2.Doc, {agg}(dt1.Fre * dt2.Fre)
    FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
    WHERE dt1.Doc = :d0
    GROUP BY dt2.Doc
    """
    Q_EXISTS = """
    SELECT dt2.Doc, EXISTS(*)
    FROM DT dt1 JOIN DT dt2 ON dt1.Term = dt2.Term
    WHERE dt1.Doc = :d0
    GROUP BY dt2.Doc
    """
    CASES = [
        ("SD", SG.QUERY_SD, {"d0": 5}, "pubmed"),
        ("FSD", SG.QUERY_FSD, {"d0": 5}, "pubmed"),
        ("AS", SG.QUERY_AS, {"a0": 7}, "pubmed"),
        ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}, "pubmed"),
        ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}, "pubmed"),
        ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}, "pubmed"),
        ("CS", SG.QUERY_CS, {"c0": 4}, "semmed"),
        ("SD_RECENT", SG.QUERY_SD_RECENT, {"d0": 5}, "pubmed"),
        ("AS_RECENT", SG.QUERY_AS_RECENT, {"a0": 7}, "pubmed"),
        ("EXISTS", Q_EXISTS, {"d0": 5}, "pubmed"),
        ("MIN", Q_SCORE.format(agg="MIN"), {"d0": 5}, "pubmed"),
        ("MAX", Q_SCORE.format(agg="MAX"), {"d0": 5}, "pubmed"),
    ]
''')
_ns = {"SG": SG}
exec(CASES_SRC, _ns)
CASES = _ns["CASES"]
NAMES = [c[0] for c in CASES]
BF16 = ("SD", "AS", "FAD")

#: Each side reads the cases (SQL text included: the port's synth_graph has
#: queries the JAX package's lacks) from a JSON file, and makes the graphs
#: with its own package's generator.
CASES_IN = textwrap.dedent('''
    import json
    CASES = [tuple(c) for c in json.load(open(sys.argv[-1]))]
    BF16 = %r
    GRAPHS = {"pubmed": lambda: SG.make_pubmed(n_docs=500, n_terms=50, n_authors=200),
              "semmed": lambda: SG.make_semmeddb()}
''' % (BF16,))
#: counts, memberships, min and max: exact
EXACT = ("SD", "AD", "RECENT", "CS", "SD_RECENT", "EXISTS", "MIN", "MAX")

REFERENCE = textwrap.dedent('''
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.data import synth_graph as SG
    from repro.core import executor as X
    from repro.core.engine import GQFastDatabase, GQFastEngine
    from repro.core.planner import plan_query
    from repro.core.sql import parse
    from repro.launch.mesh import _mesh_from_devices, make_mesh
    ''') + CASES_IN + textwrap.dedent('''
    out = {}
    schemas = {g: make() for g, make in GRAPHS.items()}
    dbs = {g: GQFastDatabase(s, account_space=False) for g, s in schemas.items()}
    mesh8 = make_mesh((8,), ("data",))
    engines = {g: GQFastEngine(db, mesh=mesh8) for g, db in dbs.items()}
    for name, q, params, g in CASES:
        out[f"dist/{name}"] = np.asarray(engines[g].query(q, **params))
        if name in BF16:
            plan = plan_query(schemas[g], parse(q))
            fn = X.compile_frontier_distributed(dbs[g].device, plan, mesh8,
                                                frontier_dtype=jnp.bfloat16)
            out[f"bf16/{name}"] = np.asarray(fn(*params.values()))
    devices = np.asarray(jax.devices()[:4])
    mesh22 = _mesh_from_devices(devices.reshape(2, 2), ("data", "model"))
    plan = plan_query(schemas["pubmed"], parse(SG.QUERY_AS))
    fb = X.compile_frontier_distributed(dbs["pubmed"].device, plan, mesh22,
                                        ("data", "model"), batched=True)
    out["batched/AS"] = np.asarray(fb(jnp.arange(6)))
    mesh4 = _mesh_from_devices(devices, ("data",))
    for g, db in dbs.items():
        for (t, k), di in X.shard_edges(db.device, mesh4, ("data",)).indexes.items():
            cols = {"src": di.src_ids, "dst": di.dst_ids, **{f"m/{m}": v for m, v in
                                                           di.measures.items()}}
            for c, arr in cols.items():
                shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
                for r, s in enumerate(shards):
                    out[f"shard/{g}/{t}.{k}/{c}/{r}"] = np.asarray(s.data)
    np.savez(sys.argv[1], **out)
''')

RANK_PREAMBLE = textwrap.dedent('''
    import datetime, os, sys, time
    import numpy as np, torch, torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)  # the worlds' ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=%d))
    from repro_torch.core import executor as X
    from repro_torch.core.engine import GQFastDatabase, GQFastEngine
    from repro_torch.data import synth_graph as SG
    from repro_torch.launch.mesh import make_mesh
    ''' % GROUP_TIMEOUT_S)

PORT_WORLD = RANK_PREAMBLE + CASES_IN + textwrap.dedent('''
    res = {}
    schemas = {g: make() for g, make in GRAPHS.items()}
    dbs = {g: GQFastDatabase(s, account_space=False, device="cpu") for g, s in schemas.items()}
    mesh = make_mesh((world,), ("data",), device_type="cpu")
    engines = {g: GQFastEngine(db, mesh=mesh) for g, db in dbs.items()}
    for name, q, params, g in CASES:
        pq = engines[g].prepare(q)
        assert pq.strategy == "distributed"
        res[f"dist/{name}"] = pq(**params)
        if name in BF16:
            fn = X.compile_frontier_distributed(
                dbs[g].device, pq.phys, mesh, frontier_dtype=torch.bfloat16,
                sharded_db=engines[g].sharded_db())
            res[f"bf16/{name}"] = fn(*params.values()).numpy()
    for g, eng in engines.items():
        for (t, k), di in eng.sharded_db().indexes.items():
            res[f"shard/{g}/{t}.{k}/src"] = di.src_ids.numpy()
            res[f"shard/{g}/{t}.{k}/dst"] = di.dst_ids.numpy()
            for m, v in di.measures.items():
                res[f"shard/{g}/{t}.{k}/m/{m}"] = v.numpy()
    mesh22 = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    e22 = GQFastEngine(dbs["pubmed"], mesh=mesh22, shard_axes=("data", "model"))
    pq = e22.prepare(SG.QUERY_AS)
    res["batched/AS"] = pq.execute_batch(a0=np.arange(6))
    res["batched_rows/AS"] = np.stack([pq(a0=a) for a in range(6)])
    np.savez(out, **res)
''')

#: One world of 2 a case: rank 1 fails (or stops), and every rank writes what
#: it saw. A case's ``body`` runs on every rank after ``pq`` (SD on a mesh)
#: and ``eng`` exist; it sets ``seen``.
FAIL_CASES = {
    # a fault site on rank 1's first hop: the direct call raises on both, the
    # walk stays in step (the next call answers), and through the ladder the
    # retry on the sharded rung answers on both
    "fault": '''
        from repro_torch.robust import faults
        from repro_torch.robust.errors import ExecutionError
        spec = faults.FaultSpec("ops.fragment_spmv", max_fires=1)
        plan = faults.FaultPlan(0, [spec] if rank == 1 else [])
        with faults.active(plan):
            try:
                pq(d0=5)
                seen["direct"] = "ok"
            except ExecutionError as e:
                seen["direct"] = type(e).__name__ + ":" + e.code
            seen["after"] = float(pq(d0=5).sum())
            spec.fires = 0
            oc = run_with_policy(pq, {"d0": 5})
            seen["ladder"] = [oc.status, oc.rung, oc.attempts]
    ''',
    # a kernel that fails on rank 1: KERNEL on every rank, on the sharded
    # rung, no plain rung answers
    "kernel": '''
        from repro_torch.kernels import ops as K
        from repro_torch.kernels.cuda_build import KernelError
        if rank == 1:
            def failed(*a, **k):
                raise KernelError("nvcc failed building fragment_spmv.cu")
            K.fragment_spmv = failed
        oc = run_with_policy(pq, {"d0": 5})
        seen["ladder"] = [oc.status, oc.rung, oc.attempts, oc.error.code if oc.error else None,
                          list(oc.demotions)]
    ''',
    # rank 1's deadline is spent before the first hop; rank 0 has none
    "deadline": '''
        from repro_torch.robust.errors import DeadlineExceeded
        from repro_torch.robust.runner import Deadline, deadline_scope
        try:
            with deadline_scope(Deadline(1e-3) if rank == 1 else None):
                pq(d0=5)
            seen["direct"] = "ok"
        except DeadlineExceeded as e:
            seen["direct"] = type(e).__name__ + ":" + e.code
        oc = run_with_policy(pq, {"d0": 5}, deadline_ms=1e-3 if rank == 1 else None)
        seen["ladder"] = [oc.status, oc.rung, oc.attempts, oc.error.code if oc.error else None]
    ''',
    # the runner's own fault site fires on rank 1 before the walk: rank 1
    # enters the walk failed, both retry, both answer
    "runner": '''
        from repro_torch.robust import faults
        spec = faults.FaultSpec("runner.execute", max_fires=1)
        with faults.active(faults.FaultPlan(0, [spec] if rank == 1 else [])):
            oc = run_with_policy(pq, {"d0": 5})
        seen["ladder"] = [oc.status, oc.rung, oc.attempts]
    ''',
    # rank 1 exits before the query: rank 0 raises, it does not hang
    "exit": '''
        if rank == 1:
            os._exit(0)
        try:
            pq(d0=5)
            seen["direct"] = "ok"
        except Exception as e:
            seen["direct"] = type(e).__name__
    ''',
}


def _fail_script(body: str) -> str:
    return RANK_PREAMBLE + textwrap.dedent('''
        import json
        from repro_torch.robust.runner import run_with_policy
        schema = SG.make_pubmed(n_docs=300, n_terms=30, n_authors=100)
        db = GQFastDatabase(schema, account_space=False, device="cpu")
        eng = GQFastEngine(db, mesh=make_mesh((world,), ("data",), device_type="cpu"))
        pq = eng.prepare(SG.QUERY_SD)
        pq(d0=5)
        seen = {}
        t0 = time.perf_counter()
    ''') + textwrap.dedent(body) + textwrap.dedent('''
        seen["seconds"] = time.perf_counter() - t0
        with open(out, "w") as f:
            json.dump(seen, f)
    ''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **extra}
    env.pop("WORLD_SIZE", None)
    return env


def _start_world(code: str, world: int, out_dir: Path, *extra) -> list:
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(port), str(out_dir / f"rank{r}"),
         *extra],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for r in range(world)]


def _wait(procs: list, what: str) -> None:
    for p in procs:
        try:
            out, err = p.communicate(timeout=WORLD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what}: a rank did not end within {WORLD_TIMEOUT_S} s")
        assert p.returncode == 0, f"{what}\nSTDOUT:\n{out}\nSTDERR:\n{err[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run of the module, started together: the
    reference (8 devices), the port's world of 4, and one world of 2 a
    failure case. Returns their outputs."""
    tmp = tmp_path_factory.mktemp("distributed")
    cases = tmp / "cases.json"
    cases.write_text(json.dumps(CASES))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "reference.npz"), str(cases)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    (tmp / "port").mkdir()
    port = _start_world(PORT_WORLD, 4, tmp / "port", str(cases))
    fails = {}
    for case, body in FAIL_CASES.items():
        (tmp / case).mkdir()
        fails[case] = _start_world(_fail_script(body), 2, tmp / case)
    _wait([ref], "the reference's 8-device run")
    _wait(port, "the port's world of 4")
    out = {"ref": dict(np.load(tmp / "reference.npz")),
           "port": [dict(np.load(tmp / "port" / f"rank{r}.npz")) for r in range(4)],
           "fail": {}}
    for case, procs in fails.items():
        if case == "exit":  # rank 1 leaves: only rank 0 reports
            _wait(procs, f"failure case {case}")
            out["fail"][case] = [json.loads((tmp / case / "rank0").read_text())]
            continue
        _wait(procs, f"failure case {case}")
        out["fail"][case] = [json.loads((tmp / case / f"rank{r}").read_text())
                             for r in range(2)]
    return out


@pytest.fixture(scope="module")
def schemas():
    return {"pubmed": SG.make_pubmed(n_docs=500, n_terms=50, n_authors=200),
            "semmed": SG.make_semmeddb()}


def _hold(got, want, name: str, what: str, rtol: float = 1e-4) -> None:
    assert got.shape == want.shape, (name, what)
    if name in EXACT:
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {what}")
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol, err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", NAMES)
def test_world_of_four_matches_the_reference_and_run_sql(runs, schemas, name):
    _, q, params, g = CASES[NAMES.index(name)]
    got = runs["port"][0][f"dist/{name}"]
    _hold(got, runs["ref"][f"dist/{name}"], name, "vs the reference's 8-device engine")
    _hold(got, run_sql(schemas[g], q, params).astype(np.float32), name, "vs run_sql")
    assert np.isfinite(got).all() and (got != 0).any(), name


def test_every_rank_equals_rank_zero(runs):
    r0 = runs["port"][0]
    for r in range(1, 4):
        for k in r0:
            if k.startswith(("dist/", "bf16/", "batched")):
                np.testing.assert_array_equal(runs["port"][r][k], r0[k], err_msg=f"rank {r} {k}")


def test_batched_two_by_two_matches_the_reference(runs, schemas):
    got = runs["port"][0]["batched/AS"]
    np.testing.assert_allclose(got, runs["ref"]["batched/AS"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, runs["port"][0]["batched_rows/AS"], rtol=1e-4, atol=1e-4)
    want = np.stack([run_sql(schemas["pubmed"], SG.QUERY_AS, {"a0": a}) for a in range(6)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rank", range(4))
def test_shards_equal_the_references(runs, rank):
    """Rank r's shard of every index (src, dst, each measure) is the
    reference's shard r of a 4-device mesh, integer for integer once the
    reference's padding (``__valid__`` 0) is dropped."""
    ref, mine = runs["ref"], runs["port"][rank]
    keys = [k for k in mine if k.startswith("shard/")]
    assert len(keys) > 10
    for k in keys:
        index = "/".join(k.split("/")[:3])
        want = ref[f"{k}/{rank}"][ref[f"{index}/m/__valid__/{rank}"] > 0]
        assert mine[k].dtype.kind == want.dtype.kind, k
        np.testing.assert_array_equal(mine[k], want, err_msg=k)


@pytest.mark.parametrize("name", ["SD", "AS", "FAD"])
def test_bfloat16_frontier_matches_the_references_bfloat16(runs, name):
    """The bf16 all-reduce against the reference's bf16 run and against
    the float32 run, each within :data:`BF16_RTOL` of the larger value."""
    got = runs["port"][0][f"bf16/{name}"]
    for want in (runs["ref"][f"bf16/{name}"], runs["port"][0][f"dist/{name}"]):
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_RTOL)


@pytest.mark.parametrize("case,want", [
    ("fault", {"direct": "ExecutionError:EXECUTION", "ladder": ["degraded", "active", 2]}),
    ("kernel", {"ladder": ["error", "active", 1, "KERNEL", []]}),
    ("deadline", {"direct": "DeadlineExceeded:DEADLINE",
                  "ladder": ["error", "active", 1, "DEADLINE"]}),
    ("runner", {"ladder": ["degraded", "active", 2]}),
    ("exit", {}),
])
def test_a_failing_rank_ends_the_query_on_every_rank(runs, case, want):
    seen = runs["fail"][case]
    for r, s in enumerate(seen):
        for k, v in want.items():
            assert s[k] == v, (case, r, s)
        assert s["seconds"] < GROUP_TIMEOUT_S, (case, r, s)
    if case == "fault":
        assert seen[0]["after"] == seen[1]["after"] > 0
    if case == "exit":
        assert seen[0]["direct"] not in ("ok",), seen


# ---------------------------------------------------------------------------
# A world of 1, in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    made = not dist.is_initialized()
    mesh = make_mesh((1,), ("data",), device_type="cpu")
    yield mesh
    if made:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def small_db():
    schema = SG.make_pubmed(n_docs=300, n_terms=30, n_authors=100, seed=0)
    return GQFastDatabase(schema, account_space=False, device="cpu")


def test_profile_distributed_bit_identical(small_db, mesh1):
    eng = GQFastEngine(small_db, mesh=mesh1)
    pq = eng.prepare(SG.QUERY_SD)
    plain = pq(d0=17)
    prof = pq.profile(reps=1, d0=17)
    assert np.array_equal(prof.result, plain)
    assert prof.strategy == "distributed"
    assert prof.timing_method == "prefix-delta"
    assert len(prof.ops) == len(pq.phys.ops)
    assert all(o.wall_ms is not None for o in prof.ops)
    assert prof.memory["shard_bytes"] == X.shard_bytes(pq.sharded_db) > 0
    text = pq.explain(analyze=True, d0=17)
    assert "per-op via prefix-delta" in text and "strategy: distributed" in text


@pytest.mark.parametrize("enc", ["packed", "dense"])
def test_distributed_batched(small_db, mesh1, enc):
    """A 1-rank mesh: execute_batch's rows equal their single calls (the
    batched walk hops with fragment_spmm over the shard)."""
    db = GQFastDatabase(small_db.schema, account_space=False, device="cpu",
                        device_encodings=enc)
    pq = GQFastEngine(db, mesh=mesh1).prepare(SG.QUERY_SD)
    ids = np.random.default_rng(5).integers(0, 300, 3)
    got = pq.execute_batch(d0=ids)
    want = np.stack([pq(d0=int(i)) for i in ids])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        got, np.stack([GQFastEngine(db).query(SG.QUERY_SD, d0=int(i)) for i in ids]))


def _hops(phys) -> int:
    """HopOps a walk of ``phys`` executes, its mask seed's sub-programs
    included."""
    return sum(1 if isinstance(op, X.HopOp) else
               sum(_hops(p) for p in op.programs) if isinstance(op, X.SeedOp) else 0
               for op in X.iter_flat_ops(phys))


def test_each_hop_runs_the_hop_entry_over_the_shard(small_db, mesh1, monkeypatch):
    """Every HopOp is one ``ops.fragment_spmv`` (single) or
    ``ops.fragment_spmm`` (batched) over the shard's edges, with the
    shard's hot share; nothing else of ops runs a hop."""
    calls = []
    for entry in ("fragment_spmv", "fragment_spmm", "fragment_spmv_packed",
                  "fragment_spmm_packed", "fragment_spmv_fused", "fragment_spmm_fused"):
        real = getattr(K, entry)
        monkeypatch.setattr(K, entry, lambda *a, _e=entry, _r=real, **k: (
            calls.append((_e, id(a[1]), k.get("hot_share"))), _r(*a, **k))[1])
    eng = GQFastEngine(small_db, mesh=mesh1)
    pq = eng.prepare(SG.QUERY_AD)
    pq(t1=2, t2=3)
    n_hops = _hops(pq.phys)
    shares = {id(di.src_ids): di.hot_share for di in eng.sharded_db().indexes.values()}
    assert [c[0] for c in calls] == ["fragment_spmv"] * n_hops
    assert all(shares[src] == hs for _, src, hs in calls)
    calls.clear()
    pq.execute_batch(t1=[2, 3], t2=[3, 4])
    assert [c[0] for c in calls] == ["fragment_spmm"] * n_hops


def test_shard_hot_share_is_the_shards_own(small_db):
    """A shard's hot share is its own destinations' (largest degree over
    its edges), not the whole index's; a shard has no skip metadata."""
    differs = 0
    for r in range(3):
        sdb = X.shard_edges(small_db.device, None, spec=X.ShardSpec(None, r, 3, "cpu"))
        for key, di in sdb.indexes.items():
            assert di.hot_share == X.dst_hot_share(di.dst_ids.numpy()), key
            assert di.block_src_min is None
            differs += di.hot_share != small_db.device.indexes[key].hot_share
    assert differs > 0


def test_bfloat16_needs_a_backend_that_reduces_it(small_db, mesh1, monkeypatch):
    real = dist.all_reduce

    def no_bf16(t, *a, **k):
        if t.dtype == torch.bfloat16:
            raise RuntimeError("Unsupported dtype BFloat16")
        return real(t, *a, **k)

    monkeypatch.setattr(dist, "all_reduce", no_bf16)
    eng = GQFastEngine(small_db, mesh=mesh1)
    pq = eng.prepare(SG.QUERY_SD)
    fn = X.compile_frontier_distributed(small_db.device, pq.phys, mesh1,
                                        frontier_dtype=torch.bfloat16,
                                        sharded_db=eng.sharded_db())
    err = pytest.raises(ValidationError, fn, 5).value
    assert "gloo" in str(err) and "bfloat16" in str(err)
    pytest.raises(ValidationError, X.compile_frontier_distributed, small_db.device,
                  pq.phys, mesh1, frontier_dtype=torch.float16,
                  sharded_db=eng.sharded_db())


def test_mesh_checks(small_db, mesh1, monkeypatch):
    err = pytest.raises(ValidationError, GQFastEngine, small_db, mesh=object()).value
    assert "DeviceMesh" in str(err)
    pytest.raises(ValidationError, GQFastEngine, small_db, mesh=mesh1, shard_axes=("model",))
    pytest.raises(RuntimeError, make_mesh, (2,), ("data",), device_type="cpu")
    assert make_local_mesh(device_type="cpu").size() == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = pytest.raises(ValidationError, make_mesh, (1,), ("data",)).value
    assert "cuda" in str(err) and "device_type='cpu'" in str(err)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name,q,params", [
    ("SD", SG.QUERY_SD, {"d0": 3}), ("AS", SG.QUERY_AS, {"a0": 2}),
    ("AD", SG.QUERY_AD, {"t1": 2, "t2": 3}), ("FSD", SG.QUERY_FSD, {"d0": 3}),
], ids=["SD", "AS", "AD", "FSD"])
def test_estimate_bounds_what_the_sharded_walk_holds(small_db, mesh1, monkeypatch, name, q,
                                                     params, batch):
    """The estimate counts the rank's shard (resident) and the all-reduce
    buffer (working), and its working term stays above what the walk holds,
    the hops stood in by entries that allocate only their output."""
    def out(w, n_dst):
        return torch.zeros(tuple(w.shape[:-1]) + (n_dst,))

    for entry in ("fragment_spmv", "fragment_spmm"):
        monkeypatch.setattr(K, entry, lambda w, s, d, m, n_dst, **kw: out(w, n_dst))
    eng = GQFastEngine(small_db, mesh=mesh1)
    pq = eng.prepare(q)
    single = GQFastEngine(small_db).prepare(q, fusion="off")
    if batch == 1:
        run = lambda: pq(**params)  # noqa: E731
    else:
        rows = {k: np.arange(batch) + v for k, v in params.items()}
        run = lambda: pq.execute_batch(**rows)  # noqa: E731
    run()
    mode = LiveBytes()
    with mode:
        run()
    est, base = estimate_query_bytes(pq, batch), estimate_query_bytes(single, batch)
    assert est["working_bytes"] >= mode.peak > 0, (name, est, mode.peak)
    assert est["resident_bytes"] == base["resident_bytes"] + sum(
        -(-int(di.src_ids.shape[0]) // 1) * 4 * (2 + len(di.measure_cols))
        for di in small_db.device.indexes.values())
    assert est["working_bytes"] > base["working_bytes"]
