"""Carrying device state across: the JAX package's DeviceDB, as numpy, loaded
into the PyTorch port, equals the port's own build and answers the same
queries bit for bit (both run the plain versions on the CPU). Dense storage,
and the reference's default packed storage with a dictionary column: packed
words, widths and dictionaries carry across equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
from repro.core.engine import GQFastEngine as JEngine  # noqa: E402
from repro.data import synth_graph as JSG  # noqa: E402
from repro_torch.convert import device_db_from_numpy  # noqa: E402
from repro_torch.core.engine import GQFastDatabase, GQFastEngine  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.robust.errors import ValidationError  # noqa: E402

QUERIES = [
    (SG.QUERY_SD, {"d0": 5}), (SG.QUERY_FSD, {"d0": 5}), (SG.QUERY_AS, {"a0": 7}),
    (SG.QUERY_AD, {"t1": 3, "t2": 9}), (SG.QUERY_FAD, {"t1": 3, "t2": 9}),
    (SG.QUERY_RECENT_AUTHORS, {"t1": 3, "t2": 9, "y": 2005}),
]


def jax_column(col):
    """One reference DeviceColumn in convert's column layout."""
    if col.kind == "dense":
        return np.asarray(col.array)
    spec = {"kind": col.kind, "words": np.asarray(col.words), "width": col.width,
            "count": col.count}
    if col.kind == "dict":
        spec["dictionary"] = np.asarray(col.dictionary)
    return spec


def jax_device_arrays(device_db) -> dict:
    """The reference DeviceDB's arrays as numpy, in convert's layout."""
    return {
        "indexes": {
            k: {
                "indptr": np.asarray(di.indptr),
                "src_ids": np.asarray(di.src_ids),
                "dst_ids": jax_column(di.dst_col),
                "degrees": np.asarray(di.degrees),
                "measures": {m: jax_column(c) for m, c in di.measure_cols.items()},
            }
            for k, di in device_db.indexes.items()
        },
        "entity_attrs": {k: np.asarray(v) for k, v in device_db.entity_attrs.items()},
    }


@pytest.fixture(scope="module")
def dbs():
    kw = dict(n_docs=600, n_terms=50, n_authors=200, seed=4)
    jdb = JDatabase(JSG.make_pubmed(**kw), account_space=False, device_encodings="dense")
    own = GQFastDatabase(SG.make_pubmed(**kw), account_space=False, device="cpu",
                         device_encodings="dense")
    arrays = jax_device_arrays(jdb.device)
    carried = GQFastDatabase.from_parts(
        own.schema, own.host_indexes,
        device_db_from_numpy(own.schema, arrays, "cpu", host_indexes=own.host_indexes),
    )
    return own, carried, arrays


def test_carried_arrays_equal_the_ports_build(dbs):
    own, carried, _ = dbs
    assert own.device.indexes.keys() == carried.device.indexes.keys()
    for k, di in own.device.indexes.items():
        ci = carried.device.indexes[k]
        for name in ("indptr", "src_ids", "dst_ids", "degrees"):
            a, b = getattr(di, name), getattr(ci, name)
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b), (k, name)
        assert di.measures.keys() == ci.measures.keys()
        for m, v in di.measures.items():
            assert v.dtype == torch.float32 and torch.equal(v, ci.measures[m])
        np.testing.assert_array_equal(di.block_src_min, ci.block_src_min)
        np.testing.assert_array_equal(di.block_src_max, ci.block_src_max)
    assert own.device.entity_attrs.keys() == carried.device.entity_attrs.keys()
    for k, v in own.device.entity_attrs.items():
        assert torch.equal(v, carried.device.entity_attrs[k])


@pytest.mark.parametrize("q,params", QUERIES, ids=["SD", "FSD", "AS", "AD", "FAD", "RECENT"])
def test_queries_over_carried_state_agree(dbs, q, params):
    own, carried, _ = dbs
    a = GQFastEngine(own).query(q, **params)
    b = GQFastEngine(carried).query(q, **params)
    np.testing.assert_array_equal(a, b)
    assert (a != 0).any()


def test_inconsistent_degrees_are_rejected(dbs):
    own, _, arrays = dbs
    bad = {**arrays, "indexes": dict(arrays["indexes"])}
    key = ("DT", "Doc")
    bad["indexes"][key] = {**bad["indexes"][key],
                           "degrees": bad["indexes"][key]["degrees"] + 1}
    with pytest.raises(ValidationError, match="degrees"):
        device_db_from_numpy(own.schema, bad, "cpu")


DICT_FRE = {("DT", "Term", "Fre"): "dict"}


@pytest.fixture(scope="module")
def packed_dbs():
    """The reference's default storage (packed keys and measures) with one
    dictionary column, carried across, beside the port's own build."""
    kw = dict(n_docs=600, n_terms=50, n_authors=200, seed=4)
    jdb = JDatabase(JSG.make_pubmed(**kw), account_space=False, device_encodings=DICT_FRE)
    own = GQFastDatabase(SG.make_pubmed(**kw), account_space=False, device="cpu",
                         device_encodings=DICT_FRE)
    carried = GQFastDatabase.from_parts(
        own.schema, own.host_indexes,
        device_db_from_numpy(own.schema, jax_device_arrays(jdb.device), "cpu",
                             host_indexes=own.host_indexes),
    )
    return jdb, own, carried


def test_carried_packed_columns_equal_the_reference_and_the_ports_build(packed_dbs):
    jdb, own, carried = packed_dbs
    kinds = set()
    for k, ci in carried.device.indexes.items():
        ji, oi = jdb.device.indexes[k], own.device.indexes[k]
        for name in ["__dst__", *ci.measure_cols]:
            c, j, o = ((x.dst_col if name == "__dst__" else x.measure_cols[name])
                       for x in (ci, ji, oi))
            assert c.kind == j.kind == o.kind, (k, name)
            kinds.add(c.kind)
            if c.kind in ("packed", "dict"):
                assert c.width == j.width == o.width and c.count == j.count
                np.testing.assert_array_equal(c.words.numpy().view(np.uint32), np.asarray(j.words))
                assert torch.equal(c.words, o.words)
            if c.kind == "dict":
                np.testing.assert_array_equal(c.dictionary.numpy(), np.asarray(j.dictionary))
                assert torch.equal(c.dictionary, o.dictionary)
            assert c.device_nbytes == j.device_nbytes
    assert kinds == {"packed", "dict"}
    assert carried.space_report()["device"] == own.space_report()["device"]


@pytest.mark.parametrize("q,params", QUERIES, ids=["SD", "FSD", "AS", "AD", "FAD", "RECENT"])
def test_queries_over_carried_packed_state_agree(packed_dbs, q, params):
    jdb, own, carried = packed_dbs
    a = GQFastEngine(own).query(q, **params)
    b = GQFastEngine(carried).query(q, **params)
    np.testing.assert_array_equal(a, b)
    j = np.asarray(JEngine(jdb).prepare(q, fusion="off")(**params))
    np.testing.assert_allclose(b, j, rtol=1e-4, atol=1e-4)
    assert (a != 0).any()


def test_malformed_packed_columns_are_rejected(packed_dbs):
    jdb, own, _ = packed_dbs
    arrays = jax_device_arrays(jdb.device)
    key = ("DT", "Doc")
    spec = arrays["indexes"][key]["dst_ids"]
    bad = {**arrays, "indexes": dict(arrays["indexes"])}
    bad["indexes"][key] = {**bad["indexes"][key],
                           "dst_ids": {**spec, "words": spec["words"][:-1]}}
    with pytest.raises(ValidationError, match="words cannot hold"):
        device_db_from_numpy(own.schema, bad, "cpu")
    bad["indexes"][key] = {**bad["indexes"][key], "dst_ids": {**spec, "kind": "zip"}}
    with pytest.raises(ValidationError, match="unknown column kind"):
        device_db_from_numpy(own.schema, bad, "cpu")
