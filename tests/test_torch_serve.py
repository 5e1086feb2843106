"""The PyTorch port's analytics server (``repro_torch.launch.serve``) on the
CPU, held to the JAX package's (``repro.launch.serve``):

  * the three CI lanes (``.github/workflows/ci.yml``: obs, chaos,
    corrupt-and-heal) through ``python -m repro_torch.launch.serve --device
    cpu`` with the CI's arguments and its assertions as written;
  * ``load_generation`` case for case with ``tests/test_snapshot.py``
    (warms and serves; a corrupted generation rolls back);
  * a generation written by ``repro.storage.snapshot_db`` loaded by both
    packages' ``load_generation``: every shape's single and bucketed answers
    agree (exact for the counts, rtol=atol=1e-4 for the sums), and the
    port's server fast-starts from it;
  * one run of each package's server with the same arguments: equal
    deterministic counters, no corrupt response under ``--verify-responses``;
  * the chaos plan spec for spec the reference's; a SIGHUP in process leads
    to one verified swap at a batch boundary; ``--workload lm`` and a missing
    card end the program with the typed error; ``stream_scratch`` hands every
    thread the one buffer of a stream.
"""
from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.storage import snapshot_db as j_snapshot_db  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.robust import IntegrityError, ValidationError  # noqa: E402
from repro_torch.storage import snapshot_db  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
#: Seconds a server process may take; the port's lanes take a few.
TIMEOUT = 300
EXACT = ("SD", "AD")  # COUNT(*): exact; the other shapes sum floats
#: The server's database at --docs n (its make_pubmed call).
DOCS = 2000
PUBMED = dict(n_docs=DOCS, n_terms=1_200, n_authors=DOCS // 5, seed=5)
PARAMS = {"AS": {"a0": 7}, "SD": {"d0": 5}, "FSD": {"d0": 5},
          "AD": {"t1": 3, "t2": 9}, "FAD": {"t1": 3, "t2": 9}}
#: One no-chaos run of either server (the parity test's arguments).
PARITY_ARGS = ["--workload", "analytics", "--requests", "40", "--docs", str(DOCS),
               "--batch", "8", "--verify-responses"]
DETERMINISTIC = ("serve.requests_served", "serve.batches_executed", "serve.padded_rows",
                 "serve.requests_ok")


def _port_serve(*argv, timeout=TIMEOUT, check=True):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv], cwd=ROOT,
        capture_output=True, text=True, env=ENV, timeout=timeout,
    )
    if check:
        assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def _check(got, want, exact, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=what)


# ---------------------------------------------------------------------------
# The CI lanes, their assertions as the workflow writes them
# ---------------------------------------------------------------------------


def test_ci_obs_lane(tmp_path):
    art = tmp_path / "artifacts"
    _port_serve("--device", "cpu", "--workload", "analytics",
                "--requests", "48", "--docs", "4000", "--batch", "8",
                "--metrics-json", str(art / "obs/serve_metrics.json"),
                "--profile-json", str(art / "obs/query_profile.json"))
    m = json.load(open(art / "obs/serve_metrics.json"))
    lat = m["histograms"]["serve.request_latency_ms"]
    assert lat["count"] == 48, lat["count"]
    assert "p50" in lat and "p99" in lat, sorted(lat)
    assert lat["p50"] <= lat["p99"], (lat["p50"], lat["p99"])
    assert m["gauges"]["serve.batch_occupancy"] > 0
    p = json.load(open(art / "obs/query_profile.json"))
    assert p["ops"] and p["hops"] and p["total_wall_ms"] > 0


def test_ci_chaos_lane(tmp_path):
    art = tmp_path / "artifacts"
    _port_serve("--device", "cpu", "--workload", "analytics",
                "--requests", "64", "--docs", "4000", "--batch", "8",
                "--chaos", "--chaos-seed", "3", "--deadline-ms", "2000",
                "--queue-bound", "56",
                "--metrics-json", str(art / "obs/chaos_metrics.json"))
    m = json.load(open(art / "obs/chaos_metrics.json"))
    c = m["counters"]
    # every request completed (served, typed-error, or shed) — no crash
    answered = (c.get("serve.requests_ok", 0)
                + c.get("serve.requests_degraded", 0)
                + c.get("serve.requests_error", 0)
                + c.get("serve.requests_shed", 0))
    assert answered == 64, (answered, c)
    assert c.get("serve.requests_degraded", 0) > 0, c
    errs = {k: v for k, v in c.items() if k.startswith("robust.errors.")}
    assert errs and sum(errs.values()) > 0, c


def test_ci_corrupt_and_heal_lane(tmp_path):
    art = tmp_path / "artifacts"
    snaps = str(art / "snapshots")
    # the first run builds the database and publishes generation 1
    _port_serve("--device", "cpu", "--workload", "analytics",
                "--requests", "8", "--docs", "2000", "--batch", "8",
                "--snapshot-dir", snaps,
                "--metrics-json", str(art / "obs/heal_publish_metrics.json"))
    # the second fast-starts from it under corruption chaos
    _port_serve("--device", "cpu", "--workload", "analytics",
                "--requests", "48", "--docs", "2000", "--batch", "8",
                "--snapshot-dir", snaps, "--reload-at", "2",
                "--scrub", "--verify-responses",
                "--chaos", "--chaos-seed", "3", "--chaos-corrupt", "--deadline-ms", "4000",
                "--metrics-json", str(art / "obs/heal_metrics.json"))
    m = json.load(open(art / "obs/heal_metrics.json"))
    c = m["counters"]
    # zero corrupted responses: every oracle-replayed answer matched
    assert c.get("serve.responses_corrupt", 0) == 0, c
    assert c.get("serve.responses_verified", 0) > 0, c
    # the scrubber detected injected corruption and healed from snapshot
    assert c.get("robust.integrity.scrub_repairs", 0) >= 1, c
    # hot swap exercised: at least one succeeded, and the corrupted
    # generation load was rejected and rolled back (old gen kept serving)
    assert c.get("serve.generation_reloads", 0) >= 1, c
    assert c.get("serve.reload_failures", 0) >= 1, c
    assert c.get("serve.fast_starts", 0) == 1, c
    # no request was dropped by a swap or heal
    answered = (c.get("serve.requests_ok", 0)
                + c.get("serve.requests_degraded", 0)
                + c.get("serve.requests_error", 0)
                + c.get("serve.requests_shed", 0))
    assert answered == 48, (answered, c)
    manifests = glob.glob(os.path.join(snaps, "gen_*", "MANIFEST.json"))
    assert manifests  # what the workflow uploads


# ---------------------------------------------------------------------------
# load_generation, case for case with tests/test_snapshot.py
# ---------------------------------------------------------------------------

SQL = ("SELECT d2.Term, COUNT(*) FROM DT d1 JOIN DT d2 ON d1.Doc = d2.Doc "
       "WHERE d1.Term = :t GROUP BY d2.Term")


@pytest.fixture(scope="module")
def small_schema():
    return SG.make_pubmed(n_docs=250, n_terms=40, n_authors=80, seed=11)


def _packed_db(schema):
    return GQFastDatabase(schema, device_encodings="packed", account_space=False,
                          device="cpu")


def test_load_generation_warms_and_serves(small_schema, tmp_path):
    db = _packed_db(small_schema)
    ref = GQFastEngine(db).prepare(SQL)(t=4)
    snapshot_db(db, str(tmp_path))
    eng2, prepared, gen = serve.load_generation(
        str(tmp_path), {"Q": SQL}, lambda _k: {"t": 4}, bucket=4, device="cpu")
    assert gen == 1 and set(prepared) == {"Q"}
    assert isinstance(eng2, GQFastEngine)
    assert np.array_equal(prepared["Q"](t=4), ref)


def test_load_generation_corrupted_rolls_back(small_schema, tmp_path):
    """A bad generation raises before any serving state could change — the
    rollback contract is that the caller simply keeps its old references."""
    gen_path = snapshot_db(_packed_db(small_schema), str(tmp_path))
    f = sorted(glob.glob(os.path.join(gen_path, "arrays", "*.npy")))[3]
    raw = bytearray(open(f, "rb").read())
    raw[len(raw) // 2] ^= 0x10
    open(f, "wb").write(bytes(raw))
    with pytest.raises(IntegrityError):
        serve.load_generation(str(tmp_path), {"Q": SQL}, lambda _k: {"t": 4}, bucket=4,
                              device="cpu")


def test_load_generation_without_generations_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        serve.load_generation(str(tmp_path), {"Q": SQL}, lambda _k: {"t": 4}, bucket=4,
                              device="cpu")


# ---------------------------------------------------------------------------
# Parity with the JAX package's server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """A generation of the server's database written by the JAX package's
    ``snapshot_db``, and the JAX server's run with PARITY_ARGS started
    beside it (its process is waited for where its counters are read)."""
    d = tmp_path_factory.mktemp("jax_side")
    gen_dir = str(d / "snapshots")
    j_snapshot_db(JDatabase(JSG.make_pubmed(**PUBMED), account_space=False), gen_dir)
    metrics = str(d / "jax_metrics.json")
    with open(d / "jax_serve.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.serve", *PARITY_ARGS,
             "--metrics-json", metrics],
            cwd=ROOT, env=ENV, stdout=log, stderr=subprocess.STDOUT,
        )
    try:
        yield {"gen_dir": gen_dir, "metrics": metrics, "proc": proc,
               "log": d / "jax_serve.log"}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def test_load_generation_matches_the_jax_package(jax_side):
    """Both packages' load_generation on one JAX-written generation: every
    shape's single call and bucketed batch agree."""
    queries = serve.QUERIES
    assert set(queries) == {"AS", "SD", "FSD", "AD", "FAD"}
    bucket = 8
    j_eng, j_prep, j_gen = jserve.load_generation(
        jax_side["gen_dir"], queries, lambda k: dict(PARAMS[k]), bucket)
    p_eng, p_prep, p_gen = serve.load_generation(
        jax_side["gen_dir"], queries, lambda k: dict(PARAMS[k]), bucket, device="cpu")
    assert j_gen == p_gen == 1 and set(j_prep) == set(p_prep) == set(queries)
    rng = np.random.default_rng(3)
    sizes = {"a0": PUBMED["n_authors"], "d0": PUBMED["n_docs"],
             "t1": PUBMED["n_terms"], "t2": PUBMED["n_terms"]}
    for name in queries:
        exact = name in EXACT
        _check(p_prep[name](**PARAMS[name]), np.asarray(j_prep[name](**PARAMS[name])),
               exact, f"{name} single")
        arrays = {k: rng.integers(0, sizes[k], bucket) for k in PARAMS[name]}
        _check(p_prep[name].execute_batch(**arrays),
               np.asarray(j_prep[name].execute_batch(**arrays)), exact, f"{name} bucket")


def test_server_counters_match_the_jax_package(jax_side, tmp_path):
    """One no-chaos run of each server with the same arguments: the same
    request stream gives the same batches, padding and outcomes, and every
    answer passes the oracle."""
    rc = jax_side["proc"].wait(timeout=TIMEOUT)
    assert rc == 0, jax_side["log"].read_text()
    mine = str(tmp_path / "port_metrics.json")
    _port_serve("--device", "cpu", *PARITY_ARGS, "--metrics-json", mine)
    j, p = (json.load(open(f)) for f in (jax_side["metrics"], mine))
    for k in DETERMINISTIC:
        assert p["counters"][k] == j["counters"][k], k
    for k in ("serve.batch_occupancy", "serve.bucket_padding_waste"):
        assert p["gauges"][k] == j["gauges"][k], k
    assert p["counters"]["serve.requests_ok"] == 40
    for m in (j, p):
        assert m["counters"]["serve.responses_verified"] == 40
        assert m["counters"].get("serve.responses_corrupt", 0) == 0
    assert p["histograms"]["serve.request_latency_ms"]["count"] == 40


def test_port_server_fast_starts_from_a_jax_generation(jax_side, tmp_path):
    run = serve.main(["--device", "cpu", "--requests", "16", "--batch", "8",
                      "--snapshot-dir", jax_side["gen_dir"], "--verify-responses",
                      "--scrub", "--scrub-interval-ms", "0"])
    c = run.registry.snapshot()["counters"]
    assert c["serve.fast_starts"] == 1 and "serve.restore_failures" not in c
    assert c["serve.requests_ok"] == 16 and c["serve.responses_verified"] == 16
    assert c.get("serve.responses_corrupt", 0) == 0
    assert run.scrub_gate["verified"] > 0
    assert run.scrub_gate["healed"] == run.scrub_gate["failed"] == 0


# ---------------------------------------------------------------------------
# The plan, signals, the lm workload, the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_chaos_plan_is_the_references(seed, corrupt):
    fields = ("site", "mode", "prob", "delay_ms", "after", "max_fires")
    mine, ref = serve._chaos_plan(seed, corrupt), jserve._chaos_plan(seed, corrupt)
    assert mine.seed == ref.seed
    assert [tuple(getattr(s, f) for f in fields) for s in mine.specs] == \
        [tuple(getattr(s, f) for f in fields) for s in ref.specs]
    # the same seeded draws, spec for spec
    assert [[s._rng.random() for _ in range(8)] for s in mine.specs] == \
        [[s._rng.random() for _ in range(8)] for s in ref.specs]


def test_sighup_leads_to_one_verified_swap(tmp_path, monkeypatch):
    """SIGHUP raised in process during the first batch: the reload starts at
    the next boundary, loads the generation published meanwhile (2) with
    every CRC checked, and swaps it in at a boundary; the batches before it
    carry generation 1, those after it 2, and every answer passes the
    oracle. The old handler is back afterwards."""
    d = str(tmp_path / "snapshots")
    db = GQFastDatabase(SG.make_pubmed(**PUBMED), account_space=False, device="cpu")
    snapshot_db(db, d)
    real = serve.run_batch_with_policy
    calls = []

    def first_batch_hup(*a, **kw):
        if not calls:
            snapshot_db(db, d)  # generation 2, published while serving
            signal.raise_signal(signal.SIGHUP)
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(serve, "run_batch_with_policy", first_batch_hup)
    before = signal.getsignal(signal.SIGHUP)
    run = serve.main(["--device", "cpu", "--requests", "40", "--batch", "4",
                      "--snapshot-dir", d, "--verify-responses"])
    assert signal.getsignal(signal.SIGHUP) is before
    c = run.registry.snapshot()["counters"]
    assert c["serve.fast_starts"] == 1
    assert c["serve.generation_reloads"] == 1 and "serve.reload_failures" not in c
    assert c["serve.requests_ok"] == 40 and c.get("serve.responses_corrupt", 0) == 0
    gens = [g for _, _, g in run.batches]
    assert gens[:2] == [1, 1] and gens == sorted(gens), gens
    assert run.registry.snapshot()["gauges"]["serve.serving_generation"] == 2
    assert all(t.name not in ("reloader", "scrubber") for t in threading.enumerate())


@pytest.mark.parametrize("signum", [signal.SIGINT, signal.SIGTERM], ids=["SIGINT", "SIGTERM"])
def test_signal_drains_and_flushes(tmp_path, monkeypatch, signum):
    """A SIGINT or SIGTERM during the first batch: that batch is answered,
    the rest of the queue counts as unserved, the metrics reach disk and the
    old handlers are back."""
    real = serve.run_batch_with_policy

    def first_batch_signal(*a, **kw):
        signal.raise_signal(signum)
        return real(*a, **kw)

    monkeypatch.setattr(serve, "run_batch_with_policy", first_batch_signal)
    before = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP)}
    path = tmp_path / "m.json"
    run = serve.main(["--device", "cpu", "--requests", "20", "--docs", "500",
                      "--batch", "4", "--metrics-json", str(path)])
    assert {s: signal.getsignal(s) for s in before} == before
    c = json.load(open(path))["counters"]
    (_, group, _), = run.batches
    assert c["serve.requests_served"] == len(group)
    assert c["serve.requests_unserved"] == 20 - len(group)
    assert sum(r is not None for r in run.results) == len(group)


def test_batches_cover_the_stream_once():
    """Every request of the stream is served once, in a batch of its own
    shape no larger than --batch, and its outcome's value is its row."""
    run = serve.main(["--device", "cpu", "--requests", "30", "--docs", "500",
                      "--batch", "4"])
    ids = [i for _, group, _ in run.batches for i in group]
    assert sorted(ids) == list(range(30))
    for kind, group, _ in run.batches:
        assert 1 <= len(group) <= 4 and {run.stream[i][1] for i in group} == {kind}
    assert run.bucket == 4
    assert all(r.status == "ok" and r.value is not None for r in run.results)


def test_workload_lm_serves(capsys, monkeypatch):
    """--workload lm is the reference's decode loop: the same two lines (the
    reference's run beside it), the greedy tokens of the port's own
    prefill and decode steps; on the card unless --device cpu is given."""
    import re

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import decode_step, init_params, prefill

    run = serve.main(["--workload", "lm", "--device", "cpu", "--requests", "4"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve", "--workload", "lm", "--requests", "4"])
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    line = r"\[serve/lm\] 4 decode steps × batch 4: \d+\.\d ms/step, \d+\.\d tok/s"
    for out in (got, want):
        assert len(out) == 2 and re.fullmatch(line, out[0]), out
        assert re.fullmatch(r"sample tokens: \[\d+(, \d+){4}\]", out[1]), out
    assert got[1] == f"sample tokens: {run.tokens[:10, 0].tolist()}"
    cfg = get_arch("qwen2.5-3b").smoke_cfg
    params = init_params(cfg, torch.Generator("cpu").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=torch.Generator("cpu").manual_seed(1))
    logits, cache, _ = prefill(params, toks, cfg, 128)
    cur = torch.argmax(logits, -1)
    for i in range(5):
        assert np.array_equal(run.tokens[i], cur.numpy()), i
        logits, cache = decode_step(params, cache, cur, 32 + i, cfg)
        cur = torch.argmax(logits, -1)
    assert serve.parse_args(["--workload", "lm"]).requests == 60
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as e:
        serve.main(["--workload", "lm", "--requests", "4"])
    assert "torch.cuda.is_available() is False" in str(e.value.code)
    proc = _port_serve("--workload", "lm", "--requests", "4", check=False)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_device_defaults_to_cuda():
    assert serve.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as e:
        serve.main(["--requests", "4", "--docs", "200"])
    assert "torch.cuda.is_available() is False" in str(e.value.code)
    with pytest.raises(ValidationError):
        serve.run_analytics(serve.parse_args(["--requests", "4", "--docs", "200"]))
    with pytest.raises(ValidationError):
        serve.load_generation("unused", {"Q": SQL}, lambda _k: {"t": 4}, bucket=4)
    proc = _port_serve("--requests", "4", "--docs", "200", check=False)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_stream_scratch_is_one_buffer_a_stream(monkeypatch):
    """Threads that miss a stream's scratch at once all get the buffer that
    was stored (with a short switch interval, more threads than cores)."""
    got = []
    start = threading.Barrier(32)

    def take():
        start.wait(timeout=30)
        got.append(cuda_build.stream_scratch("test_serve", 4, torch.int32,
                                             torch.device("cpu"), 12345))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            monkeypatch.setattr(cuda_build, "_STREAM_SCRATCH", {})
            got.clear()
            threads = [threading.Thread(target=take) for _ in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert len(got) == 32 and all(b is got[0] for b in got)
            assert got[0] is cuda_build._STREAM_SCRATCH[("test_serve", None, 12345)]
    finally:
        sys.setswitchinterval(interval)
