"""Carrying device state across: the JAX package's dense DeviceDB, as numpy,
loaded into the PyTorch port, equals the port's own build and answers the
same queries bit for bit (both run the plain version on the CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GQFastDatabase as JDatabase  # noqa: E402
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


def jax_device_arrays(device_db) -> dict:
    """The reference DeviceDB's arrays as numpy, in convert's layout."""
    return {
        "indexes": {
            k: {
                "indptr": np.asarray(di.indptr),
                "src_ids": np.asarray(di.src_ids),
                "dst_ids": np.asarray(di.dst_ids),
                "degrees": np.asarray(di.degrees),
                "measures": {m: np.asarray(v) for m, v in di.measures.items()},
            }
            for k, di in device_db.indexes.items()
        },
        "entity_attrs": {k: np.asarray(v) for k, v in device_db.entity_attrs.items()},
    }


@pytest.fixture(scope="module")
def dbs():
    kw = dict(n_docs=600, n_terms=50, n_authors=200, seed=4)
    jdb = JDatabase(JSG.make_pubmed(**kw), account_space=False, device_encodings="dense")
    own = GQFastDatabase(SG.make_pubmed(**kw), account_space=False, device="cpu")
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
