"""Serving launcher of the PyTorch port: the GQ-Fast analytics micro-batching
server, and the LM decode loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload analytics
  PYTHONPATH=src python -m repro_torch.launch.serve --workload analytics --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --requests 60

The lm workload (:func:`run_lm`) is the reference's: Qwen2.5-3B's smoke
config, a prompt of 4×32 tokens prefilled into a 128-slot KV cache, then
``--requests`` greedy decode steps (default 60), with the reference's
printed lines.

The analytics workload is the paper's target deployment as a serving loop:
many concurrent dashboard queries that differ only in parameter bindings. The
server collects queued requests per query shape, pads each micro-batch to a
fixed bucket (:func:`repro_torch.core.engine.batch_bucket`), runs ONE
batched pass through the fault-tolerant runner
(:func:`repro_torch.robust.run_batch_with_policy` → ``execute_batch``'s
executable: every hop streams the edges once for the whole bucket, on the
card through the SpMM kernels), scatters the per-request outcomes back, and
reports queries/s against the sequential single-query baseline. Flags,
counters, output and the request stream (``np.random.default_rng(0)``, the
same samplers in the same order) are the JAX package's
(``repro.launch.serve``), so both servers draw the same parameters; the one
flag of the port's own is ``--device`` (default ``cuda``: without a card the
server refuses to start unless ``--device cpu`` is given).

Robustness: every micro-batch runs under a :class:`~repro_torch.robust.
RobustPolicy` (``--deadline-ms``, retry, the degradation ladder), failures
come back as typed per-request errors; ``--queue-bound N`` sheds the queue's
tail with typed OVERLOAD errors; SIGINT/SIGTERM drain the loop and still
flush ``--metrics-json``; ``--chaos`` serves under a seeded fault plan
(:func:`_chaos_plan`) installed before prepare.

Durability: ``--snapshot-dir`` fast-starts from the latest checksummed
generation (every CRC-32C checked on the DB's device) or builds and
publishes generation 1; SIGHUP or ``--reload-at N`` loads the latest
generation on a background thread (:func:`load_generation`) and swaps it in
at a micro-batch boundary, or rolls back when it fails
(``serve.reload_failures``); ``--scrub`` runs a full integrity pass before
serving and scrubber ticks during it, re-preparing every shape after a heal;
``--verify-responses`` replays every answered request on the numpy oracle
(``core/reference.py``) and counts ``serve.responses_corrupt``.

Threads and streams: the serving thread, the reloader and the scrubber's
ticks all launch kernels, and all on the device's default stream (a thread's
current stream is the default one unless it sets another; none of them
does). Their launches therefore run on the card in the order they were
enqueued: the last-CTA tickets that the list and CRC kernels keep in
``cuda_build.stream_scratch`` are zero again when the next launch on the
stream starts, whichever thread enqueued it, and a tensor one thread frees is
handed out again by the caching allocator only behind the work already
enqueued on that stream. While a reload runs, two generations sit on the
card.

:func:`run_analytics` is the loop; it returns a :class:`ServeRun` (the
registry, the request stream, every request's outcome and the batches as
served), so callers in the same process can hold each answer. :func:`main`
is the command line over it.
"""
from __future__ import annotations

import argparse
import contextlib
import contextvars
import json
import os
import signal
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..core.engine import GQFastDatabase, GQFastEngine, batch_bucket, resolve_device
from ..core.reference import run_sql
from ..data import synth_graph as SG
from ..obs.metrics import MetricsRegistry
from ..robust import RetryPolicy, RobustPolicy, faults, run_batch_with_policy
from ..robust.errors import IntegrityError, QueryError, ResourceError, ValidationError
from ..robust.scrub import Scrubber
from ..storage import attach_manifest, latest_generation, restore_db, snapshot_db

#: The dashboard's query shapes, in the reference's order (the request
#: stream draws a shape by its index here).
QUERIES = {
    "AS": SG.QUERY_AS, "SD": SG.QUERY_SD, "FSD": SG.QUERY_FSD,
    "AD": SG.QUERY_AD, "FAD": SG.QUERY_FAD,
}


def _chaos_plan(seed: int, corrupt: bool = False) -> faults.FaultPlan:
    """The chaos lane's seeded fault mix, the reference's specs, seeds and
    probabilities: a bounded burst of kernel-dispatch failures (``ops.``,
    ladder demotions), sporadic 50 ms per-attempt delays (trips
    ``--deadline-ms``) and sporadic retryable attempt failures.

    The port's ``ops.*`` sites fire on every call that asks for a kernel,
    where the reference's fire when a program is traced: here the burst is
    spent on the warm-up's raw calls and the first batches' rungs, which is
    where the reference's traces happen too.

    ``corrupt`` adds the durability mix: two corrupted materialize reads
    (healed by the verified-read path), three corrupted scrubber reads
    (detect → quarantine → heal from the snapshot → re-verify) and one
    corrupted snapshot-restore read (the first hot-swap reload fails
    verification and rolls back; the next succeeds)."""
    plan = (
        faults.FaultPlan(seed=seed)
        .add(faults.FaultSpec(site="ops.", mode="raise", prob=0.5, max_fires=4))
        .add(faults.FaultSpec(site="runner.execute", mode="delay",
                              delay_ms=50.0, prob=0.2))
        .add(faults.FaultSpec(site="runner.execute", mode="raise",
                              prob=0.15, max_fires=6))
    )
    if corrupt:
        plan.add(faults.FaultSpec(site="storage.materialize", mode="corrupt",
                                  max_fires=2))
        plan.add(faults.FaultSpec(site="scrub.verify", mode="corrupt",
                                  max_fires=3))
        plan.add(faults.FaultSpec(site="snapshot.load", mode="corrupt",
                                  max_fires=1))
    return plan


def load_generation(snapshot_dir: str, queries: dict, sample_params,
                    bucket: int, generation: int | None = None,
                    strategy: str = "frontier", device=None):
    """The fallible half of a verified hot swap: restore one snapshot
    generation on ``device`` (None: the card) with every CRC-32C checked
    there (raises :class:`~repro_torch.robust.errors.IntegrityError` on any
    mismatch), build an engine on it, prepare and warm every query shape
    (a single call and ``execute_batch`` at ``bucket``), and return
    ``(engine, prepared, generation)``. Raises without touching the
    caller's serving state: rollback is simply "don't swap"."""
    device = resolve_device(device)
    gen = generation if generation is not None else latest_generation(snapshot_dir)
    if gen is None:
        raise FileNotFoundError(f"no snapshot generations in {snapshot_dir}")
    db = restore_db(snapshot_dir, gen, device=device)
    eng = GQFastEngine(db, strategy=strategy)
    prepared = {}
    for name, sql in queries.items():
        pq = eng.prepare(sql)
        p = sample_params(name)
        pq(**p)
        pq.execute_batch(**{k: np.full(bucket, v) for k, v in p.items()})
        prepared[name] = pq
    return eng, prepared, gen


@dataclass
class ServeRun:
    """What one run of the analytics loop leaves: its metrics ``registry``;
    the request ``stream`` as ``(request id, shape, params)``; ``results``,
    one per request — the :class:`~repro_torch.robust.QueryOutcome` of an
    answered one, the error dict of a failed or shed one, None where a
    signal left it unserved; the ``bucket`` every batch was padded to (by
    repeating its last request's parameters); ``batches`` as served,
    ``(shape, request ids, generation)`` in order; the scrub gate's stats
    (None without ``--scrub``)."""

    registry: MetricsRegistry
    stream: list[tuple[int, str, dict[str, int]]]
    results: list
    bucket: int
    batches: list[tuple[str, list[int], int]] = field(default_factory=list)
    scrub_gate: dict[str, int] | None = None


def _open_out(path: str):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return open(path, "w")


def run_analytics(args) -> ServeRun:
    """The analytics serving loop over parsed ``args`` (see :func:`main`'s
    flags). Installs SIGINT/SIGTERM/SIGHUP handlers for its run (so it runs
    on the main thread) and restores the old ones; every thread it starts
    (the reloader, the scrubber) has ended when it returns."""
    device = resolve_device(args.device)
    reg = MetricsRegistry()

    print(f"loading database on {device}…")
    t0 = time.time()
    db = None
    generation = 0
    if args.snapshot_dir:
        gen = latest_generation(args.snapshot_dir)
        if gen is not None:
            try:
                db = restore_db(args.snapshot_dir, gen, device=device)
                generation = gen
                reg.counter("serve.fast_starts").inc()
                print(f"  fast start: restored generation {gen} "
                      f"from {args.snapshot_dir}")
            except IntegrityError as e:
                # a corrupted snapshot never serves; rebuild from source
                reg.counter("serve.restore_failures").inc()
                reg.counter(f"robust.errors.{e.code}").inc()
                print(f"  snapshot restore REJECTED [{e.code}]: {e}\n"
                      "  rebuilding from source data…")
    if db is None:
        schema = SG.make_pubmed(
            n_docs=args.docs, n_terms=1_200, n_authors=args.docs // 5, seed=5
        )
        db = GQFastDatabase(schema, account_space=False, device=device)
        if args.snapshot_dir:
            snapshot_db(db, args.snapshot_dir)
            generation = latest_generation(args.snapshot_dir) or 1
            print(f"  published snapshot generation {generation} "
                  f"to {args.snapshot_dir}")
    schema = db.schema
    eng = GQFastEngine(db)
    reg.gauge("serve.db_load_ms").set((time.time() - t0) * 1e3)
    print(f"  {time.time()-t0:.1f}s "
          f"(DT {schema.relationships['DT'].num_rows} rows, "
          f"DA {schema.relationships['DA'].num_rows} rows)")

    # integrity manifest: a restored DB carries one; a fresh build gets one
    # whenever something will check it (scrubber ticks or corrupt-mode chaos)
    if (args.scrub or args.chaos_corrupt) \
            and getattr(db.device, "integrity", None) is None:
        attach_manifest(db.device)

    queries = QUERIES
    rng = np.random.default_rng(0)

    # parameter samplers draw from the loaded graph's actual id domains
    n_authors = schema.entities["Author"].size
    n_docs = schema.entities["Document"].size
    n_terms = schema.entities["Term"].size

    def sample_params(kind: str) -> dict[str, int]:
        if kind == "AS":
            return {"a0": int(rng.integers(0, n_authors))}
        if kind in ("SD", "FSD"):
            return {"d0": int(rng.integers(0, n_docs))}
        return {"t1": int(rng.integers(0, n_terms)),
                "t2": int(rng.integers(0, n_terms))}

    policy = RobustPolicy(
        retry=RetryPolicy(max_attempts=2, base_ms=2.0, seed=args.chaos_seed),
        deadline_ms=args.deadline_ms,
        registry=reg,
    )

    def dump_metrics() -> None:
        if args.metrics_json:
            with _open_out(args.metrics_json) as fh:
                fh.write(reg.to_json(indent=2))

    # the chaos plan is live BEFORE prepare, as the reference's is
    chaos = faults.active(_chaos_plan(args.chaos_seed, args.chaos_corrupt)) \
        if args.chaos else contextlib.nullcontext()
    stop: dict = {"signal": None}
    reload_req = {"pending": 0}

    def _on_signal(signum, frame):  # drain, flush, exit cleanly
        stop["signal"] = signum

    def _on_hup(signum, frame):  # verified hot swap at the next batch boundary
        reload_req["pending"] += 1

    old_handlers = {
        s: signal.signal(s, _on_signal)
        for s in (signal.SIGINT, signal.SIGTERM)
    }
    if hasattr(signal, "SIGHUP"):
        old_handlers[signal.SIGHUP] = signal.signal(signal.SIGHUP, _on_hup)

    results: list = []
    sizes: list[int] = []
    stream: list = []
    batches: list = []
    gate = None
    seq_qps = None
    dt = 0.0
    plan = None
    serving: dict = {"scrubber": None}
    reload_state: dict = {"thread": None, "result": None, "error": None}
    try:
        with chaos as plan:
            # prepare every shape; under chaos a prepare may eat an injected
            # fault — retry once, then serve the remaining shapes and fail
            # that shape's requests with the typed error
            prepared, prep_errors = {}, {}
            for name, sql in queries.items():
                for attempt in (1, 2):
                    try:
                        prepared[name] = eng.prepare(sql)
                        break
                    except QueryError as e:
                        prep_errors[name] = e
                        reg.counter(f"robust.errors.{e.code}").inc()
                        reg.counter("serve.prepare_failures").inc()
            for name in list(prep_errors):
                if name in prepared:
                    prep_errors.pop(name, None)

            bucket = batch_bucket(args.batch)

            # one mutable serving reference: the hot swap replaces these
            # entries together at a batch boundary
            serving.update(eng=eng, prepared=prepared, prep_errors=prep_errors,
                           generation=generation)
            reg.gauge("serve.serving_generation").set(float(generation))

            heal_events: list[str] = []

            def _make_scrubber(for_db):
                return Scrubber(
                    for_db, snapshot_dir=args.snapshot_dir, cols_per_tick=2,
                    registry=reg, on_heal=heal_events.append,
                )

            if args.scrub:
                # pre-serving gate: one full pass — at-rest corruption is
                # detected (and healed from snapshot) before any query reads it
                sc = _make_scrubber(db)
                gate = sc.scrub_full()
                print(f"  integrity gate: {gate['verified']} verified, "
                      f"{gate['healed']} healed, {gate['failed']} failed")
                if args.scrub_interval_ms > 0:
                    sc.start(args.scrub_interval_ms / 1e3)
                serving["scrubber"] = sc

            def _start_reload() -> None:
                def work():
                    try:
                        reload_state["result"] = load_generation(
                            args.snapshot_dir, queries, sample_params, bucket,
                            device=device,
                        )
                    except BaseException as e:  # noqa: BLE001 — typed below
                        reload_state["error"] = e

                # copy_context: the chaos FaultPlan is a ContextVar, which
                # threads do not inherit — the reload runs under the plan
                ctx = contextvars.copy_context()
                th = threading.Thread(
                    target=lambda: ctx.run(work), name="reloader", daemon=True
                )
                reload_state["thread"] = th
                th.start()

            def _apply_reload() -> None:
                """Runs only at micro-batch boundaries: the previous batch is
                fully answered, so the swap drops no in-flight request."""
                th = reload_state["thread"]
                if th is None or th.is_alive():
                    return
                th.join()
                reload_state["thread"] = None
                err = reload_state.pop("error", None)
                res = reload_state.pop("result", None)
                reload_state.update(result=None, error=None)
                if err is not None:
                    # rollback: the old generation keeps serving untouched
                    code = getattr(err, "code", type(err).__name__)
                    reg.counter("serve.reload_failures").inc()
                    reg.counter(f"robust.errors.{code}").inc()
                    print(f"  reload FAILED, generation "
                          f"{serving['generation']} keeps serving "
                          f"[{code}]: {err}")
                    return
                new_eng, new_prepared, gen = res
                old_sc = serving["scrubber"]
                if old_sc is not None:
                    old_sc.stop()
                serving.update(
                    eng=new_eng, prepared=new_prepared, prep_errors={},
                    generation=gen,
                )
                if old_sc is not None:
                    sc = _make_scrubber(new_eng.db)
                    if args.scrub_interval_ms > 0:
                        sc.start(args.scrub_interval_ms / 1e3)
                    serving["scrubber"] = sc
                reg.counter("serve.generation_reloads").inc()
                reg.gauge("serve.serving_generation").set(float(gen))
                print(f"  hot-swapped to generation {gen}")

            def _reprepare_after_heal() -> None:
                """Plans lowered before a heal hold the replaced tensors:
                drop and rebuild every prepared shape."""
                n_heals = len(heal_events)
                heal_events.clear()
                serving["eng"].invalidate_prepared()
                fresh = 0
                for name, sql in queries.items():
                    try:
                        serving["prepared"][name] = serving["eng"].prepare(sql)
                        serving["prep_errors"].pop(name, None)
                        fresh += 1
                    except QueryError as e:
                        serving["prep_errors"][name] = e
                        reg.counter(f"robust.errors.{e.code}").inc()
                reg.counter("serve.reprepares").inc(fresh)
                print(f"  re-prepared {fresh} shapes after "
                      f"{n_heals} heal(s)")
            names = list(queries)
            stream = [
                (i, names[int(rng.integers(0, len(names)))])
                for i in range(args.requests)
            ]
            stream = [(i, kind, sample_params(kind)) for i, kind in stream]

            print(f"warmup (a single call and one batch per shape, bucket={bucket})…")
            t0 = time.time()
            for kind in prepared:
                p = sample_params(kind)
                try:
                    prepared[kind](**p)  # the single-query executable (baseline)
                    prepared[kind].execute_batch(
                        **{k: np.full(bucket, v) for k, v in p.items()}
                    )
                except QueryError as e:  # chaos can fail a warm-up call; the
                    reg.counter(f"robust.errors.{e.code}").inc()  # ladder
                    # takes the batch at serve time, so keep going
            print(f"  {time.time()-t0:.1f}s")

            if args.profile_json:
                # one EXPLAIN ANALYZE profile of the first shape, for artifacts
                try:
                    kind = next(iter(prepared))
                    prof = prepared[kind].profile(**sample_params(kind))
                    with _open_out(args.profile_json) as fh:
                        fh.write(prof.to_json(indent=2))
                    print(f"  wrote QueryProfile({kind}) to {args.profile_json}")
                except QueryError as e:
                    print(f"  profile skipped (injected fault): {e.code}")

            # sequential baseline: the same mix served one query at a time
            # (skipped under chaos — raw calls would surface injected faults)
            if not args.chaos and prepared:
                base_n = min(args.requests, 25)
                t0 = time.perf_counter()
                served = 0
                for _, kind, params in stream[:base_n]:
                    if kind in prepared:
                        prepared[kind](**params)
                        served += 1
                seq_dt = time.perf_counter() - t0
                seq_qps = served / seq_dt if seq_dt > 0 else None
                if seq_qps:
                    reg.gauge("serve.sequential_queries_per_sec").set(seq_qps)

            print(f"serving {args.requests} requests, micro-batch ≤ {args.batch}"
                  + (f", deadline {args.deadline_ms:.0f}ms"
                     if args.deadline_ms else "")
                  + (" [CHAOS]" if args.chaos else "") + "…")
            results = [None] * len(stream)
            queue = deque(stream)

            # load shedding: beyond --queue-bound queued requests, reject the
            # tail with a typed OVERLOAD error instead of queueing unboundedly
            if args.queue_bound and len(queue) > args.queue_bound:
                shed = ResourceError(
                    f"queue bound {args.queue_bound} exceeded; request shed",
                    code="OVERLOAD", retryable=True,
                    queue_bound=args.queue_bound,
                )
                n_shed = len(queue) - args.queue_bound
                for _ in range(n_shed):
                    i, _, _ = queue.pop()
                    results[i] = {"status": "error", **shed.to_dict()}
                reg.counter("serve.requests_shed").inc(n_shed)
                reg.counter(f"robust.errors.{shed.code}").inc(n_shed)
                print(f"  shed {n_shed} requests over queue bound "
                      f"{args.queue_bound}")

            lat_all = reg.histogram("serve.request_latency_ms")
            t0 = time.perf_counter()
            while queue:
                if stop["signal"] is not None:
                    n = len(queue)
                    reg.counter("serve.requests_unserved").inc(n)
                    print(f"  signal {stop['signal']}: draining, {n} requests"
                          " unserved")
                    break
                # batch boundary: apply a finished reload, launch a requested
                # one, re-prepare after heals — never mid-batch
                _apply_reload()
                if (reload_req["pending"] > 0 and reload_state["thread"] is None
                        and args.snapshot_dir):
                    reload_req["pending"] -= 1
                    _start_reload()
                if heal_events:
                    _reprepare_after_heal()
                prepared = serving["prepared"]
                prep_errors = serving["prep_errors"]
                tb = time.perf_counter()
                # collect: drain up to `batch` requests of the head's shape
                i0, kind, p0 = queue.popleft()
                group = [(i0, p0)]
                skipped: deque = deque()
                while queue and len(group) < args.batch:
                    item = queue.popleft()
                    if item[1] == kind:
                        group.append((item[0], item[2]))
                    else:
                        skipped.append(item)
                queue.extendleft(reversed(skipped))
                if kind not in prepared:  # shape never prepared (chaos)
                    err = prep_errors[kind]
                    for req_id, _ in group:
                        results[req_id] = {"status": "error", **err.to_dict()}
                    reg.counter("serve.requests_error").inc(len(group))
                    continue
                # pad to the warmed bucket (repeat the last binding)
                arrays = {
                    k: np.asarray([p[k] for _, p in group]
                                  + [group[-1][1][k]] * (bucket - len(group)))
                    for k in p0
                }
                try:
                    faults.fire("serve.request", kind=kind, n=len(group))
                    outcomes = run_batch_with_policy(
                        prepared[kind], arrays,
                        deadline_ms=args.deadline_ms, policy=policy,
                    )[:len(group)]
                except QueryError as e:  # the serve.request fault site
                    reg.counter(f"robust.errors.{e.code}").inc()
                    outcomes = None
                batches.append((kind, [req_id for req_id, _ in group],
                                serving["generation"]))
                for row, (req_id, _) in enumerate(group):
                    oc = outcomes[row] if outcomes is not None else None
                    if oc is None:
                        results[req_id] = {"status": "error",
                                           "code": "FAULT_INJECTED"}
                        reg.counter("serve.requests_error").inc()
                    elif oc.status == "error":
                        results[req_id] = oc.to_dict()
                        reg.counter("serve.requests_error").inc()
                    else:
                        results[req_id] = oc
                        reg.counter(f"serve.requests_{oc.status}").inc()
                sizes.append(len(group))
                # every request in the group completes when its batch does
                batch_ms = (time.perf_counter() - tb) * 1e3
                for _ in group:
                    lat_all.observe(batch_ms)
                reg.histogram(f"serve.request_latency_ms.{kind}").observe(batch_ms)
                reg.counter("serve.requests_served").inc(len(group))
                reg.counter("serve.batches_executed").inc()
                reg.counter("serve.padded_rows").inc(bucket - len(group))
                if args.verify_responses and outcomes is not None:
                    # replay every answered request on the numpy oracle,
                    # outside the latency measurement
                    sdb = serving["eng"].db.schema
                    for row, (_, pr) in enumerate(group):
                        oc = outcomes[row]
                        if oc is None or oc.status == "error" or oc.value is None:
                            continue
                        expect = run_sql(sdb, queries[kind], pr)
                        reg.counter("serve.responses_verified").inc()
                        got = np.asarray(oc.value)
                        if got.shape != expect.shape or not np.allclose(
                                got, expect, rtol=1e-4, atol=1e-5):
                            reg.counter("serve.responses_corrupt").inc()
                            print(f"  CORRUPT RESPONSE: {kind} params={pr} "
                                  f"max|Δ|={np.abs(got - expect).max():.3g}")
                if args.reload_at and len(sizes) % args.reload_at == 0:
                    reload_req["pending"] += 1
                reg.gauge("serve.batch_occupancy").set(float(np.mean(sizes)))
                reg.gauge("serve.bucket_padding_waste").set(
                    1.0 - float(np.sum(sizes)) / (len(sizes) * bucket)
                )
                elapsed = time.perf_counter() - t0
                reg.gauge("serve.queries_per_sec").set(
                    float(np.sum(sizes)) / elapsed if elapsed > 0 else 0.0
                )
                if args.metrics_every and len(sizes) % args.metrics_every == 0:
                    dump_metrics()

            dt = time.perf_counter() - t0
            # finish outstanding hot swaps: every requested reload completes
            # (or rolls back) before the summary
            while stop["signal"] is None and args.snapshot_dir and (
                    reload_state["thread"] is not None
                    or reload_req["pending"] > 0):
                if reload_state["thread"] is None:
                    reload_req["pending"] -= 1
                    _start_reload()
                reload_state["thread"].join()
                _apply_reload()
    finally:
        # no thread outlives the call (the reference leaves daemon threads to
        # the process's exit; the port's loop also runs inside callers)
        if serving["scrubber"] is not None:
            serving["scrubber"].stop()
        if reload_state["thread"] is not None:
            reload_state["thread"].join()
        for s, h in old_handlers.items():
            signal.signal(s, h)
        # the flush contract: metrics reach disk on clean exit, signal drain,
        # and unexpected failure alike
        dump_metrics()

    if plan is not None:
        print("  chaos fault stats:", json.dumps(plan.stats()))
        print("  robust counters:",
              json.dumps(reg.counters_with_prefix("robust.")))
    if args.snapshot_dir or args.scrub or args.verify_responses:
        durable = {
            k: v for k, v in reg.counters_with_prefix("serve.").items()
            if k.split(".", 1)[1] in (
                "fast_starts", "restore_failures", "generation_reloads",
                "reload_failures", "reprepares", "responses_verified",
                "responses_corrupt",
            )
        }
        print("  durability counters:", json.dumps(durable))
        print("  integrity counters:",
              json.dumps(reg.counters_with_prefix("robust.integrity.")))

    answered = sum(r is not None for r in results)
    by_status = {"ok": 0, "degraded": 0, "error": 0}
    for r in results:
        if r is None:
            continue
        status = r["status"] if isinstance(r, dict) else r.status
        by_status[status] = by_status.get(status, 0) + 1
    if stop["signal"] is None and answered != len(results):
        # no crash, no silent loss: every request has a structured outcome
        raise RuntimeError(f"{answered} of {len(results)} requests answered")
    qps = answered / dt if dt > 0 else 0.0
    reg.gauge("serve.queries_per_sec").set(qps)
    if seq_qps:
        reg.gauge("serve.speedup_vs_sequential").set(qps / seq_qps)
    dump_metrics()
    snap = reg.histogram("serve.request_latency_ms").snapshot()
    print(f"\n  {answered}/{len(results)} requests answered in {dt:.2f}s over "
          f"{len(sizes)} batched passes "
          f"(mean occupancy {np.mean(sizes) if sizes else 0:.1f}/{bucket})")
    print(f"  outcomes: {by_status['ok']} ok, {by_status['degraded']} degraded,"
          f" {by_status['error']} error")
    if snap.get("count"):
        print(f"  latency p50/p95/p99: {snap['p50']:.1f} / {snap['p95']:.1f} / "
              f"{snap['p99']:.1f} ms")
    print(f"  micro-batched: {qps:8.1f} queries/s")
    if seq_qps:
        print(f"  sequential:    {seq_qps:8.1f} queries/s "
              f"(speedup ×{qps/seq_qps:.1f})")
    if args.metrics_json:
        print(f"  metrics written to {args.metrics_json}")
    if args.echo_metrics:
        print(json.dumps(reg.snapshot()["gauges"], indent=2))
    return ServeRun(reg, stream, results, bucket, batches, gate)


@dataclass
class LMServeRun:
    """What :func:`run_lm` served: the greedy tokens ([steps + 1, 4], the
    prefill's pick first) and the decode loop's wall."""
    tokens: np.ndarray
    ms_per_step: float
    tokens_per_s: float


def run_lm(args) -> LMServeRun:
    """The reference's LM decode loop on ``args.device``: Qwen2.5-3B's smoke
    config, weights from seed 0, a 4×32 prompt from seed 1, a 128-slot
    cache, ``args.requests`` greedy decode steps."""
    import torch

    from ..configs.registry import get_arch
    from ..models.transformer import decode_step, init_params, prefill

    device = resolve_device(args.device)
    cfg = get_arch("qwen2.5-3b").smoke_cfg
    params = init_params(cfg, torch.Generator(device).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 32), device=device,
                         generator=torch.Generator(device).manual_seed(1))
    logits, cache, pos = prefill(params, toks, cfg, 128)
    cur = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    out = [cur]
    for i in range(args.requests):
        logits, cache = decode_step(params, cache, cur, pos + i, cfg)
        cur = torch.argmax(logits, -1)
        out.append(cur)
    tokens = torch.stack(out).cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    run = LMServeRun(tokens, dt / max(args.requests, 1) * 1e3, 4 * args.requests / dt)
    print(f"[serve/lm] {args.requests} decode steps × batch 4: "
          f"{run.ms_per_step:.1f} ms/step, {run.tokens_per_s:.1f} tok/s")
    print("sample tokens:", tokens[:10, 0].tolist())
    return run


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--workload", choices=["analytics", "lm"], default="analytics")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the database lives and the queries run "
                         "(default cuda; without a card the server refuses "
                         "to start unless --device cpu is given)")
    ap.add_argument("--requests", type=int, default=None,
                    help="request count (default: 256 analytics; lm: 60 "
                         "decode steps)")
    ap.add_argument("--batch", type=int, default=32,
                    help="analytics: max requests per micro-batch "
                         "(padded to the engine's bucket size)")
    ap.add_argument("--docs", type=int, default=20_000,
                    help="analytics: synthetic database scale")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="analytics: dump the metrics registry (latency "
                         "histograms, occupancy/padding gauges, qps) as JSON")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="analytics: rewrite --metrics-json every N batches "
                         "(0: only at exit)")
    ap.add_argument("--profile-json", default=None, metavar="PATH",
                    help="analytics: dump one QueryProfile as JSON after warmup")
    ap.add_argument("--echo-metrics", action="store_true",
                    help="analytics: print the gauge snapshot at exit")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="analytics: per-request wall-clock deadline; overruns"
                         " return typed DEADLINE errors")
    ap.add_argument("--queue-bound", type=int, default=0,
                    help="analytics: shed requests beyond this queue depth "
                         "with typed OVERLOAD errors (0: unbounded)")
    ap.add_argument("--chaos", action="store_true",
                    help="analytics: serve under a seeded fault-injection "
                         "plan (kernel raises + attempt delays/raises)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="analytics: FaultPlan / retry-jitter seed")
    ap.add_argument("--chaos-corrupt", action="store_true",
                    help="analytics: add corrupt-mode faults to the chaos "
                         "plan (materialize reads, scrubber reads, snapshot "
                         "restore) — requires --chaos")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="analytics: fast-start from the latest checksummed "
                         "snapshot generation here (publishing one on fresh "
                         "build); enables SIGHUP/--reload-at hot swaps")
    ap.add_argument("--reload-at", type=int, default=0, metavar="N",
                    help="analytics: trigger a verified hot-swap reload "
                         "every N served batches (0: SIGHUP only)")
    ap.add_argument("--scrub", action="store_true",
                    help="analytics: full integrity scrub before serving + "
                         "background scrubber ticks during it")
    ap.add_argument("--scrub-interval-ms", type=float, default=200.0,
                    help="analytics: background scrub tick interval "
                         "(0: pre-serve gate only)")
    ap.add_argument("--verify-responses", action="store_true",
                    help="analytics: replay every answered request on the "
                         "numpy oracle; count serve.responses_corrupt")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = 256 if args.workload == "analytics" else 60
    return args


def main(argv: list[str] | None = None) -> ServeRun | LMServeRun:
    """The command line: parse ``argv`` and serve. A device that is not
    there ends the program with the typed error's message and a nonzero
    status."""
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except ValidationError as e:
        raise SystemExit(f"serve: {e}") from e
    return run_lm(args) if args.workload == "lm" else run_analytics(args)


if __name__ == "__main__":
    main()
