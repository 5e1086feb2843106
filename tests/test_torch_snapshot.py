"""The PyTorch port's durability layer on the CPU, case for case with
``tests/test_snapshot.py`` (serve's ``load_generation`` and the training
``CheckpointManager`` come with later items), held against the JAX package
on the same seeded graphs:

  * CRC-32C — the port's (the kernel's plain version on the CPU) equal to
    ``repro.storage.integrity.crc32c`` at lengths 0–9, 4095–4097 and ~1 MB,
    chained and in parts, from bytes, numpy arrays and tensors;
  * manifests equal to the reference's, digest for digest, on the same
    schema and encodings;
  * snapshot round trips — every device encoding × both strategies give the
    same answers after restore, without re-encoding; cross-restore both
    ways: a generation written by ``repro.storage.snapshot_db`` restores in
    the port, passes every CRC and answers the seven queries as the reference
    does, and a port generation restores in ``repro.storage.restore_db``;
  * detection — any single flipped byte in any snapshot array file makes
    restore raise IntegrityError naming the table/column;
  * verified reads, quarantine and the scrubber: detect → heal from the
    snapshot → ``invalidate_prepared`` → the original answers;
  * the atomic writer and the thread-safety under it all.

Counts exact, float sums within rtol=atol=1e-4.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro.storage import build_manifest as j_build_manifest  # noqa: E402
from repro.storage import integrity as JI  # noqa: E402
from repro.storage import restore_db as j_restore_db  # noqa: E402
from repro.storage import snapshot_db as j_snapshot_db  # noqa: E402
from repro_torch.ckpt.atomic import publish_dir, retain_stamped, stamped_name  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry  # noqa: E402
from repro_torch.robust import IntegrityError, PreparedCache, QueryError, Scrubber, faults  # noqa: E402
from repro_torch.robust.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.storage import (  # noqa: E402
    attach_manifest,
    build_manifest,
    crc32c,
    crc32c_parts,
    detach_manifest,
    latest_generation,
    list_generations,
    restore_db,
    snapshot_db,
)
from repro_torch.storage.snapshot import load_column_arrays  # noqa: E402

SQL = ("SELECT d2.Term, COUNT(*) FROM DT d1 JOIN DT d2 ON d1.Doc = d2.Doc "
       "WHERE d1.Term = :t GROUP BY d2.Term")
SQL_SUM = ("SELECT dt.Doc, SUM(dt.Fre) FROM DT dt WHERE dt.Term = :t "
           "GROUP BY dt.Doc")

PUBMED = dict(n_docs=250, n_terms=40, n_authors=80, seed=11)
SEMMED = dict(n_concepts=120, n_csemtypes=150, n_predications=300, n_sentences=900)

SEVEN = [
    ("SD", SG.QUERY_SD, {"d0": 5}),
    ("FSD", SG.QUERY_FSD, {"d0": 5}),
    ("AS", SG.QUERY_AS, {"a0": 7}),
    ("AD", SG.QUERY_AD, {"t1": 3, "t2": 9}),
    ("FAD", SG.QUERY_FAD, {"t1": 3, "t2": 9}),
    ("RECENT", SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
    ("CS", SG.QUERY_CS, {"c0": 11}),
]
EXACT = ("SD", "AD", "RECENT", "CS")
CPU = "cpu"


@pytest.fixture(scope="module")
def schema():
    return SG.make_pubmed(**PUBMED)


def _db(schema, enc):
    return GQFastDatabase(schema, device_encodings=enc, account_space=False, device=CPU)


def _check(got, want, exact, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if exact:
        np.testing.assert_array_equal(got, want.astype(np.float32), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=what)


# ---------------------------------------------------------------------------
# CRC-32C
# ---------------------------------------------------------------------------


def test_crc32c_vector():
    assert crc32c(b"123456789", device=CPU) == 0xE3069283
    assert crc32c(b"", device=CPU) == 0


def test_crc32c_chaining():
    whole = crc32c(b"hello world", device=CPU)
    assert crc32c(b" world", crc32c(b"hello", device=CPU), device=CPU) == whole


def test_crc32c_pure_python_fallback_matches():
    """The port's value equals the reference's through its hardware path and
    through its table-driven byte loop."""
    data = np.random.default_rng(0).integers(0, 2**32, 4096, np.uint32)
    got = crc32c(data, device=CPU)
    assert JI.crc32c(data) == got
    gcrc, JI._gcrc = JI._gcrc, None
    try:
        assert JI.crc32c(data) == got
    finally:
        JI._gcrc = gcrc


@pytest.mark.parametrize("n", [*range(10), 4095, 4096, 4097, 2**20 + 3])
def test_crc32c_equals_the_reference(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    value = int(rng.integers(0, 2**32))
    assert crc32c(data, device=CPU) == JI.crc32c(data)
    assert crc32c(data, value, device=CPU) == JI.crc32c(data, value)
    half = n // 2
    assert crc32c(data[half:], crc32c(data[:half], device=CPU), device=CPU) == JI.crc32c(data)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32, np.int64, np.uint8])
def test_crc32c_of_arrays_and_tensors(dtype):
    """A numpy array and a tensor of the same values hash as their bytes,
    as the reference hashes arrays; views at every byte offset too."""
    a = (np.random.default_rng(1).random(1031) * 1e6).astype(dtype)
    want = JI.crc32c(a)
    assert crc32c(a, device=CPU) == want
    assert crc32c(torch.from_numpy(a.copy())) == want
    raw = np.frombuffer(a.tobytes(), dtype=np.uint8)
    t = torch.from_numpy(raw.copy())
    for off in range(5):  # views off every alignment
        assert crc32c(t[off:]) == JI.crc32c(raw[off:].tobytes())


def test_crc32c_parts_chain_like_the_reference():
    rng = np.random.default_rng(2)
    parts = [rng.integers(0, 2**32, n, dtype=np.uint32) for n in (0, 7, 4096, 33)]
    assert crc32c_parts(parts, device=CPU) == JI.crc32c_parts(parts)
    assert crc32c_parts([torch.from_numpy(p.view(np.int32).copy()) for p in parts]) == \
        JI.crc32c_parts(parts)


@pytest.mark.parametrize("n", [16, 40, 10_007, 100_003])
def test_plain_crc_does_not_depend_on_the_chunking(n):
    """Lengths that cut the stream into 1, 3, 626 (313 after one level) and
    4,001 chunks: the pairwise combine meets an odd count at some level of
    each but the first."""
    C = -(-n // max(16, -(-n // ref.CRC_CHUNKS["cpu"])))
    assert C == {16: 1, 40: 3, 10_007: 626, 100_003: 4_001}[n]
    data = np.random.default_rng(3).integers(0, 256, n, dtype=np.uint8)
    got = int(ref.crc32c_ref(torch.from_numpy(data), 0x1234))
    assert got == JI.crc32c(data.tobytes(), 0x1234)


def test_kernel_constants_equal_the_plain_versions():
    """``csrc/crc32c.cu`` carries x^(2^k) mod P as literals: they must be the
    plain version's (the card's build is the only other check)."""
    src = (Path(ref.__file__).parent / "csrc" / "crc32c.cu").read_text()
    body = src[src.index("#define CRC32C_X2N"):src.index("namespace {")]
    lits = [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert lits == ref.X2N
    assert "0x82F63B78u" in src and ref.CRC32C_POLY == 0x82F63B78


@pytest.mark.parametrize("name,count,span", [("kThreadPow[kThreads]", 1024,
                                              lambda t: 16 * (1023 - t)),
                                             ("kCtaPow[kMaxCtas]", 256, lambda d: 16_384 * d)])
def test_kernel_carry_tables_equal_the_plain_versions(name, count, span):
    """The kernel's end-of-run carries (a thread's register over the bytes
    after its last uint4 in its CTA's tiles, over the CTAs after it) are
    literals: each must be ``ref.x8nmodp`` of its span."""
    src = (Path(ref.__file__).parent / "csrc" / "crc32c.cu").read_text()
    body = src[src.index(f" uint32_t {name} = {{"):]
    body = body[:body.index("};")]
    lits = [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert lits == [ref.x8nmodp(span(i)) for i in range(count)]


# ---------------------------------------------------------------------------
# Manifests against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc", ["dense", "packed", "auto"])
def test_manifest_equals_the_reference(schema, enc):
    mine = build_manifest(_db(schema, enc).device)
    jdb = JDatabase(JSG.make_pubmed(**PUBMED), device_encodings=enc, account_space=False)
    theirs = j_build_manifest(jdb.device)
    assert set(mine) == set(theirs)
    for addr, dig in theirs.items():
        assert mine[addr] == {k: (int(v) if k.endswith("crc") or k == "count" else v)
                              for k, v in dig.items()}, addr


# ---------------------------------------------------------------------------
# Snapshot round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc", ["dense", "packed", "auto"])
@pytest.mark.parametrize("strategy", ["frontier", "fragment_loop"])
def test_roundtrip_bit_identical(schema, enc, strategy, tmp_path):
    db = _db(schema, enc)
    eng = GQFastEngine(db, strategy=strategy)
    refs = [eng.prepare(sql)(t=7) for sql in (SQL, SQL_SUM)]

    snapshot_db(db, str(tmp_path))
    db2 = restore_db(str(tmp_path), device=CPU)
    eng2 = GQFastEngine(db2, strategy=strategy)
    for sql, want in zip((SQL, SQL_SUM), refs):
        got = eng2.prepare(sql)(t=7)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want), f"{enc}/{strategy}: not bit-identical"


@pytest.mark.parametrize("enc", ["dense", "packed", "auto"])
def test_roundtrip_preserves_encodings(schema, enc, tmp_path):
    db = _db(schema, enc)
    snapshot_db(db, str(tmp_path))
    db2 = restore_db(str(tmp_path), device=CPU)
    for (t, k), di in db.device.indexes.items():
        di2 = db2.device.indexes[(t, k)]
        assert di2.hot_share == di.hot_share
        assert torch.equal(di2.block_src_min, di.block_src_min)
        cols = [("__dst__", di.dst_col, di2.dst_col)] + [
            (m, c, di2.measure_cols[m]) for m, c in di.measure_cols.items()
        ]
        for name, a, b in cols:
            assert a.kind == b.kind, (t, k, name)
            if a.kind in ("packed", "dict"):
                assert b.words.dtype == torch.int32
                assert torch.equal(a.words, b.words)
                assert a.width == b.width and a.count == b.count
            if a.kind == "dict":
                assert torch.equal(a.dictionary, b.dictionary)
            if a.kind == "dense":
                assert torch.equal(a.array, b.array) and a.array.dtype == b.array.dtype


def test_snapshot_stores_words_as_uint32(schema, tmp_path):
    gen_path = snapshot_db(_db(schema, "packed"), str(tmp_path))
    manifest = json.load(open(os.path.join(gen_path, "MANIFEST.json")))
    words = {n: s for n, s in manifest["arrays"].items() if n.endswith("/words")}
    assert words and all(s["dtype"] == "uint32" for s in words.values())
    arr = np.load(os.path.join(gen_path, "arrays", next(iter(words.values()))["file"]))
    assert arr.dtype == np.uint32


def test_roundtrip_host_indexes_and_schema(schema, tmp_path):
    db = _db(schema, "auto")
    snapshot_db(db, str(tmp_path))
    db2 = restore_db(str(tmp_path), device=CPU)
    assert set(db2.host_indexes) == set(db.host_indexes)
    for key, idx in db.host_indexes.items():
        idx2 = db2.host_indexes[key]
        assert np.array_equal(idx.indptr, idx2.indptr)
        assert set(idx.columns) == set(idx2.columns)
        for c, cf in idx.columns.items():
            cf2 = idx2.columns[c]
            assert np.array_equal(cf.values, cf2.values)
            assert cf.encoding == cf2.encoding
            assert cf.encoded_bytes == cf2.encoded_bytes
    for e in schema.entities.values():
        e2 = db2.schema.entities[e.name]
        assert e2.size == e.size
        for a, col in e.attributes.items():
            assert np.array_equal(col, e2.attributes[a])
    db2.schema.validate()


def test_restored_db_has_manifest_and_verified_reads(schema, tmp_path):
    db = _db(schema, "packed")
    snapshot_db(db, str(tmp_path))
    db2 = restore_db(str(tmp_path), device=CPU)
    assert db2.device.integrity
    col = db2.device.indexes[("DT", "Doc")].dst_col
    assert col._expected_crc is not None


def test_generations_and_retention(schema, tmp_path):
    db = _db(schema, "dense")
    for _ in range(3):
        snapshot_db(db, str(tmp_path))
    assert list_generations(str(tmp_path)) == [1, 2, 3]
    snapshot_db(db, str(tmp_path), keep=2)
    assert list_generations(str(tmp_path)) == [3, 4]
    assert latest_generation(str(tmp_path)) == 4
    db2 = restore_db(str(tmp_path), generation=3, device=CPU)
    assert torch.equal(db.device.indexes[("DT", "Doc")].indptr,
                       db2.device.indexes[("DT", "Doc")].indptr)


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_db(str(tmp_path), device=CPU)


# ---------------------------------------------------------------------------
# Cross-restore with the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_side():
    """Per graph: the reference's DB (auto storage) and its answers to the
    queries on that graph (the reference's fragment_loop engine)."""
    out = {}
    for make, kw in (("make_pubmed", PUBMED), ("make_semmeddb", SEMMED)):
        jdb = JDatabase(getattr(JSG, make)(**kw), account_space=False)
        eng = JEngine(jdb, strategy="fragment_loop")
        qs = [c for c in SEVEN if (c[0] == "CS") == (make == "make_semmeddb")]
        out[make] = (jdb, {n: np.asarray(eng.prepare(q)(**p)) for n, q, p in qs}, qs)
    return out


@pytest.mark.parametrize("make", ["make_pubmed", "make_semmeddb"])
def test_reference_generation_restores_in_the_port(reference_side, make, tmp_path):
    jdb, answers, qs = reference_side[make]
    j_snapshot_db(jdb, str(tmp_path))
    db = restore_db(str(tmp_path), device=CPU)  # every CRC verified on the way
    assert db.device.integrity
    assert build_manifest(db.device) == {
        a: {k: (int(v) if k != "kind" else v) for k, v in d.items()}
        for a, d in j_build_manifest(jdb.device).items()}
    eng = GQFastEngine(db)
    for name, q, p in qs:
        _check(eng.prepare(q)(**p), answers[name], name in EXACT, f"{name} restored")


@pytest.mark.parametrize("make", ["make_pubmed", "make_semmeddb"])
def test_port_generation_restores_in_the_reference(reference_side, make, tmp_path):
    _, answers, qs = reference_side[make]
    kw = PUBMED if make == "make_pubmed" else SEMMED
    db = GQFastDatabase(getattr(SG, make)(**kw), account_space=False, device=CPU)
    snapshot_db(db, str(tmp_path))
    jdb = j_restore_db(str(tmp_path))  # the reference verifies every CRC
    eng = JEngine(jdb, strategy="fragment_loop")
    for name, q, p in qs:
        _check(np.asarray(eng.prepare(q)(**p)), answers[name], name in EXACT,
               f"{name} restored in the reference")


# ---------------------------------------------------------------------------
# Corruption detection: every flipped byte raises IntegrityError
# ---------------------------------------------------------------------------


def test_every_single_byte_flip_detected(schema, tmp_path):
    db = _db(schema, "auto")
    gen_path = snapshot_db(db, str(tmp_path))
    files = sorted(glob.glob(os.path.join(gen_path, "arrays", "*.npy")))
    assert len(files) > 10
    manifest = json.load(open(os.path.join(gen_path, "MANIFEST.json")))
    by_file = {spec["file"]: name for name, spec in manifest["arrays"].items()}
    for f in files:
        shutil.copy(f, f + ".bak")
        raw = bytearray(open(f, "rb").read())
        raw[len(raw) // 2] ^= 0x20
        open(f, "wb").write(bytes(raw))
        try:
            with pytest.raises(IntegrityError) as ei:
                restore_db(str(tmp_path), device=CPU)
            err = ei.value
            assert err.code == "INTEGRITY"
            assert not err.retryable
            logical = by_file[os.path.basename(f)]
            assert err.context.get("array") == logical
            assert err.context.get("table"), logical
        finally:
            shutil.move(f + ".bak", f)
    restore_db(str(tmp_path), device=CPU)


def test_header_flip_detected(schema, tmp_path):
    db = _db(schema, "dense")
    gen_path = snapshot_db(db, str(tmp_path))
    f = sorted(glob.glob(os.path.join(gen_path, "arrays", "*.npy")))[0]
    raw = bytearray(open(f, "rb").read())
    raw[9] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    with pytest.raises(IntegrityError):
        restore_db(str(tmp_path), device=CPU)


def test_truncated_manifest_detected(schema, tmp_path):
    db = _db(schema, "dense")
    gen_path = snapshot_db(db, str(tmp_path))
    mpath = os.path.join(gen_path, "MANIFEST.json")
    open(mpath, "w").write(open(mpath).read()[:100])
    with pytest.raises(IntegrityError):
        restore_db(str(tmp_path), device=CPU)


def test_snapshot_load_fault_sites(schema, tmp_path):
    db = _db(schema, "dense")
    snapshot_db(db, str(tmp_path))
    plan = FaultPlan(seed=0, specs=[FaultSpec("snapshot.load", mode="raise",
                                              max_fires=1)])
    with faults.active(plan):
        with pytest.raises(QueryError):
            restore_db(str(tmp_path), device=CPU)
        restore_db(str(tmp_path), device=CPU)
    plan = FaultPlan(seed=0, specs=[FaultSpec("snapshot.load", mode="corrupt",
                                              max_fires=1)])
    with faults.active(plan):
        with pytest.raises(IntegrityError):
            restore_db(str(tmp_path), device=CPU)


# ---------------------------------------------------------------------------
# Verified reads
# ---------------------------------------------------------------------------


def test_verified_read_transient_heals(schema):
    db = _db(schema, "packed")
    attach_manifest(db.device)
    col = db.device.indexes[("DT", "Doc")].dst_col
    truth = col.materialize().clone()
    heals0 = REGISTRY.counter("robust.integrity.read_heals").value
    plan = FaultPlan(seed=0, specs=[FaultSpec(
        "storage.materialize", mode="corrupt", max_fires=1)])
    with faults.active(plan):
        out = col.materialize()
    assert torch.equal(out, truth)
    assert REGISTRY.counter("robust.integrity.read_heals").value == heals0 + 1
    detach_manifest(db.device)


def test_verified_read_persistent_raises(schema):
    db = _db(schema, "packed")
    attach_manifest(db.device)
    col = db.device.indexes[("DT", "Doc")].dst_col
    bad = col.words.clone()
    bad[0] ^= 1
    col.words = bad
    col._dense = None
    with pytest.raises(IntegrityError) as ei:
        col.materialize()
    assert ei.value.context["table"] == "DT"
    assert ei.value.context["column"] == "__dst__"
    assert not ei.value.retryable


def test_verified_read_of_a_dense_column(schema):
    """A dense column is its own storage: a flipped value raises at once."""
    db = _db(schema, "dense")
    attach_manifest(db.device)
    col = db.device.indexes[("DT", "Doc")].dst_col
    assert torch.equal(col.materialize(), col.array)
    col.array = col.array.clone()
    col.array[3] += 1
    with pytest.raises(IntegrityError):
        col.materialize()


def test_quarantined_read_raises(schema):
    db = _db(schema, "packed")
    attach_manifest(db.device)
    col = db.device.indexes[("DT", "Doc")].dst_col
    col._quarantined = True
    with pytest.raises(IntegrityError):
        col.materialize()
    col._quarantined = False


def test_manifest_detach_restores_zero_overhead(schema):
    db = _db(schema, "packed")
    attach_manifest(db.device)
    detach_manifest(db.device)
    col = db.device.indexes[("DT", "Doc")].dst_col
    assert col._expected_crc is None and not col._quarantined


# ---------------------------------------------------------------------------
# Scrubber: detect → quarantine → heal from snapshot → the same answers
# ---------------------------------------------------------------------------


def _corrupt_in_place(col):
    bad = col.words.clone()
    bad[bad.shape[0] // 2] ^= 0x01000000
    col.words = bad
    col._dense = None


def test_scrub_detects_and_heals(schema, tmp_path):
    db = _db(schema, "packed")
    eng = GQFastEngine(db)
    want = eng.prepare(SQL)(t=3)
    snapshot_db(db, str(tmp_path))
    attach_manifest(db.device)

    reg = MetricsRegistry()
    healed_addrs: list[str] = []
    s = Scrubber(db, snapshot_dir=str(tmp_path), cols_per_tick=2,
                 registry=reg, on_heal=healed_addrs.append)
    assert s.scrub_full()["failed"] == 0

    col = db.device.indexes[("DT", "Doc")].dst_col
    _corrupt_in_place(col)
    assert not np.array_equal(GQFastEngine(db).prepare(SQL)(t=3), want)  # it poisons
    stats = s.scrub_full()
    assert stats["healed"] == 1 and stats["failed"] == 0
    assert healed_addrs == ["I_DT.Doc/__dst__"]
    assert reg.counter("robust.integrity.scrub_detected").value == 1
    assert reg.counter("robust.integrity.scrub_repairs").value == 1

    # the heal swapped in new tensors: a plan prepared after
    # invalidate_prepared reads them and gives the original answer
    eng.invalidate_prepared()
    assert np.array_equal(eng.prepare(SQL)(t=3), want)


def test_scrub_heal_lets_a_kernel_error_escape(schema, tmp_path, monkeypatch):
    """A kernel that fails while a column heals is no failed heal to count:
    the error reaches the caller of scrub_full."""
    from repro_torch.kernels.cuda_build import KernelError
    from repro_torch.storage import snapshot as S

    db = _db(schema, "packed")
    snapshot_db(db, str(tmp_path))
    attach_manifest(db.device)
    _corrupt_in_place(db.device.indexes[("DT", "Doc")].dst_col)

    def kernel_fails(*a, **k):
        raise KernelError("bitunpack kernel launch failed: CUDA error 719")

    monkeypatch.setattr(S, "column_from_arrays", kernel_fails)
    reg = MetricsRegistry()
    with pytest.raises(KernelError, match="CUDA error 719"):
        Scrubber(db, snapshot_dir=str(tmp_path), registry=reg).scrub_full()
    assert reg.counter("robust.integrity.scrub_detected").value == 1
    assert reg.counter("robust.integrity.scrub_failures").value == 0


def test_scrub_without_snapshot_quarantines(schema):
    db = _db(schema, "packed")
    attach_manifest(db.device)
    col = db.device.indexes[("DT", "Doc")].dst_col
    _corrupt_in_place(col)
    reg = MetricsRegistry()
    s = Scrubber(db, snapshot_dir=None, registry=reg)
    stats = s.scrub_full()
    assert stats["failed"] == 1
    assert reg.counter("robust.integrity.scrub_failures").value == 1
    assert col._quarantined
    with pytest.raises(IntegrityError):
        col.materialize()


def test_scrub_memo_corruption_healed_by_drop(schema):
    db = _db(schema, "packed")
    attach_manifest(db.device)
    col = db.device.indexes[("DT", "Doc")].dst_col
    truth = col.materialize().clone()
    bad = truth.clone()
    bad[0] ^= 1
    col._dense = bad
    reg = MetricsRegistry()
    s = Scrubber(db, registry=reg)
    s.scrub_full()
    assert reg.counter("robust.integrity.memo_drops").value == 1
    assert col._dense is None
    assert torch.equal(col.materialize(), truth)


def test_scrub_verify_fault_site_drives_heal(schema, tmp_path):
    db = _db(schema, "packed")
    snapshot_db(db, str(tmp_path))
    reg = MetricsRegistry()
    s = Scrubber(db, snapshot_dir=str(tmp_path), registry=reg)
    plan = FaultPlan(seed=5, specs=[FaultSpec("scrub.verify", mode="corrupt",
                                              max_fires=3)])
    with faults.active(plan):
        stats = s.scrub_full()
    assert stats["healed"] == 1 and stats["failed"] == 0
    assert reg.counter("robust.integrity.scrub_repairs").value == 1
    assert s.scrub_full()["failed"] == 0


def test_corrupt_scrub_heal_end_to_end(schema, tmp_path):
    db = _db(schema, "auto")
    eng = GQFastEngine(db)
    refs = {sql: eng.prepare(sql)(t=9) for sql in (SQL, SQL_SUM)}
    snapshot_db(db, str(tmp_path))
    attach_manifest(db.device)

    di = db.device.indexes[("DT", "Doc")]
    _corrupt_in_place(di.dst_col)
    for col in di.measure_cols.values():
        if hasattr(col, "words"):
            _corrupt_in_place(col)
            break
    reg = MetricsRegistry()
    s = Scrubber(db, snapshot_dir=str(tmp_path), registry=reg)
    stats = s.scrub_full()
    assert stats["healed"] >= 2 and stats["failed"] == 0
    eng.invalidate_prepared()
    for sql, want in refs.items():
        assert np.array_equal(eng.prepare(sql)(t=9), want)


def test_scrubber_thread_heals(schema, tmp_path):
    """``start`` runs ticks on the scrubber's own thread (its hashes on that
    thread's stream); ``stop`` joins it."""
    db = _db(schema, "packed")
    snapshot_db(db, str(tmp_path))
    attach_manifest(db.device)
    healed = threading.Event()
    s = Scrubber(db, snapshot_dir=str(tmp_path), cols_per_tick=4,
                 registry=MetricsRegistry(), on_heal=lambda addr: healed.set())
    _corrupt_in_place(db.device.indexes[("DT", "Doc")].dst_col)
    s.start(interval_s=0.01)
    try:
        assert healed.wait(timeout=60)
    finally:
        s.stop()
    assert s._thread is None
    stats = s.scrub_full()
    assert stats["healed"] == 0 and stats["failed"] == 0 and stats["verified"] > 0


def test_load_column_arrays_verified(schema, tmp_path):
    db = _db(schema, "packed")
    gen_path = snapshot_db(db, str(tmp_path))
    arrays, meta = load_column_arrays(str(tmp_path), 1, "DT", "Doc", "__dst__", device=CPU)
    assert meta["kind"] == "packed"
    assert np.array_equal(
        arrays["words"],
        db.device.indexes[("DT", "Doc")].dst_col.words.numpy().view(np.uint32))
    manifest = json.load(open(os.path.join(gen_path, "MANIFEST.json")))
    spec = manifest["arrays"]["dev/DT.Doc/__dst__/words"]
    f = os.path.join(gen_path, "arrays", spec["file"])
    raw = bytearray(open(f, "rb").read())
    raw[-1] ^= 0x80
    open(f, "wb").write(bytes(raw))
    with pytest.raises(IntegrityError):
        load_column_arrays(str(tmp_path), 1, "DT", "Doc", "__dst__", device=CPU)


# ---------------------------------------------------------------------------
# Atomic writer + retention
# ---------------------------------------------------------------------------


def test_publish_dir_atomic_on_failure(tmp_path):
    final = str(tmp_path / "out")

    def bad_write(tmp):
        open(os.path.join(tmp, "partial"), "w").write("x")
        raise RuntimeError("crash mid-write")

    with pytest.raises(RuntimeError):
        publish_dir(final, bad_write)
    assert not os.path.exists(final)
    assert os.listdir(str(tmp_path)) == []

    publish_dir(final, lambda t: open(os.path.join(t, "ok"), "w").write("y"))
    assert os.path.exists(os.path.join(final, "ok"))


def test_retain_stamped(tmp_path):
    for n in (1, 2, 5, 9):
        os.makedirs(tmp_path / stamped_name("gen_", n))
    removed = retain_stamped(str(tmp_path), "gen_", 2)
    assert removed == [1, 2]
    assert sorted(os.listdir(tmp_path)) == [
        stamped_name("gen_", 5), stamped_name("gen_", 9)
    ]


# ---------------------------------------------------------------------------
# Thread safety
# ---------------------------------------------------------------------------


def test_counter_concurrent_increments_exact():
    reg = MetricsRegistry()
    c = reg.counter("t.c")
    N, T = 5_000, 8

    def work():
        for _ in range(N):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(T)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert c.value == N * T


def test_histogram_concurrent_observe_exact_count():
    reg = MetricsRegistry()
    h = reg.histogram("t.h")
    N, T = 2_000, 8

    def work():
        for i in range(N):
            h.observe(float(i % 50))

    threads = [threading.Thread(target=work) for _ in range(T)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert h.count == N * T
    assert int(h.counts.sum()) == N * T


def test_registry_concurrent_get_or_create():
    reg = MetricsRegistry()
    out = []

    def work():
        out.append(id(reg.counter("same.name")))

    threads = [threading.Thread(target=work) for _ in range(16)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert len(set(out)) == 1


def test_prepared_cache_concurrent_ops():
    cache = PreparedCache(capacity=8, registry=MetricsRegistry())
    errs = []

    def work(tid):
        try:
            for i in range(2_000):
                cache.put((tid, i % 16), i)
                cache.get((tid, (i * 7) % 16))
                len(cache)
        except BaseException as e:  # OrderedDict corruption raises here
            errs.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert not errs
    assert len(cache) <= 8


def test_prepared_cache_clear_and_engine_invalidate(schema):
    db = _db(schema, "dense")
    eng = GQFastEngine(db)
    eng.prepare(SQL)
    assert len(eng._cache) == 1
    assert eng.invalidate_prepared() == 1
    assert len(eng._cache) == 0
    eng.prepare(SQL)


# ---------------------------------------------------------------------------
# Taxonomy
# ---------------------------------------------------------------------------


def test_integrity_error_taxonomy():
    e = IntegrityError("bad bytes", table="DT", key="Doc", column="__dst__",
                       expected_crc=1, actual_crc=2)
    assert isinstance(e, QueryError) and isinstance(e, RuntimeError)
    assert e.code == "INTEGRITY"
    assert not e.retryable
    d = e.to_dict()
    assert d["code"] == "INTEGRITY" and d["context"]["table"] == "DT"


def test_build_manifest_covers_every_column(schema):
    db = _db(schema, "auto")
    man = build_manifest(db.device)
    expect = set()
    for (t, k), di in db.device.indexes.items():
        expect.add(f"I_{t}.{k}/__dst__")
        expect.update(f"I_{t}.{k}/{m}" for m in di.measure_cols)
    assert set(man) == expect
    for dig in man.values():
        assert {"kind", "count", "encoded_crc", "decoded_crc"} <= set(dig)
