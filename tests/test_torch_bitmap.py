"""The port's bitmap intersection (``repro_torch.kernels.ops.bitmap_and`` /
``bitmap_and_popcount``, the paper's §6.1 merge-intersection) against the JAX
package's (``repro.kernels.ops``, whose Pallas kernels run in interpret mode
on the CPU), on the same numpy words. On the CPU the port's entries take
their plain versions; the CUDA kernels are held to those on the card in
``tests/test_torch_cuda.py``. Words and counts are exact."""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need the [test] extra")
torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import GQFastDatabase  # noqa: E402
from repro_torch.data import synth_graph as SG  # noqa: E402
from repro_torch.kernels import bitmap_ops, ops, ref  # noqa: E402

settings.register_profile("bitmap", deadline=None, max_examples=15)


def _words(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, n, dtype=np.uint32)
    b = rng.integers(0, 2**32, n, dtype=np.uint32)
    return a, b


def _popcount(x) -> int:
    return int(np.unpackbits(np.asarray(x, np.uint32).view(np.uint8)).sum())


def _as_input(a, kind):
    return torch.from_numpy(a.view(np.int32)) if kind == "tensor" else a


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("n", [1, 100, 1024, 5000])
def test_bitmap_ops_sweep_matches_reference(n, kind):
    """tests/test_kernels.py's sweep (same seeds), the port against the JAX
    package's Pallas kernels in interpret mode."""
    a, b = _words(n, n)
    got = ops.bitmap_and(_as_input(a, kind), _as_input(b, kind))
    want = np.asarray(jops.bitmap_and(a, b))
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(want, a & b)
    pc = ops.bitmap_and_popcount(_as_input(a, kind), _as_input(b, kind))
    assert pc.dtype == torch.int32 and pc.shape == ()
    assert int(pc) == int(jops.bitmap_and_popcount(a, b)) == _popcount(a & b)


@settings(settings.get_profile("bitmap"))
@given(st.integers(1, 4000), st.integers(0, 2**31))
def test_bitmap_popcount_property_matches_reference(n, seed):
    """tests/test_kernels.py's property: the plain popcount of both packages
    equals numpy's."""
    a, b = _words(n, seed)
    got = ops.bitmap_and_popcount(a, b, use_kernel=False)
    assert int(got) == int(jops.bitmap_and_popcount(a, b, use_pallas=False)) == _popcount(a & b)
    assert np.array_equal(ops.bitmap_and(a, b, use_kernel=False).numpy().view(np.uint32),
                          np.asarray(jops.bitmap_and(a, b, use_pallas=False)))


def test_sign_bits_count():
    """Words with the top bit set (negative as int32) count all 32 bits."""
    full = torch.full((9,), -1, dtype=torch.int32)
    assert int(ref.bitmap_and_popcount_ref(full, full)) == 9 * 32
    top = torch.full((9,), -2**31, dtype=torch.int32)
    assert int(ops.bitmap_and_popcount(top, full)) == 9
    assert torch.equal(ops.bitmap_and(top, full), top)


def test_empty_bitmaps():
    e = np.zeros(0, np.uint32)
    assert ops.bitmap_and(e, e).shape == (0,)
    pc = ops.bitmap_and_popcount(e, e)
    assert pc.dtype == torch.int32 and int(pc) == 0


def test_misaligned_view():
    """A view a[1:] is contiguous but starts 4 bytes past the allocation."""
    a, b = _words(1001, 3)
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    got = ops.bitmap_and(ta[1:], tb[:-1])
    assert np.array_equal(got.numpy().view(np.uint32), a[1:] & b[:-1])
    assert int(ops.bitmap_and_popcount(ta[1:], tb[:-1])) == _popcount(a[1:] & b[:-1])


def test_lists_and_other_integer_arrays_are_uint32_words():
    """Like the reference's jnp.asarray(a, jnp.uint32)."""
    a = [0xFFFFFFFF, 5, 2**31]
    b = np.array([0x0F0F0F0F, 4, 2**31], np.int64)
    got = ops.bitmap_and(a, b).numpy().view(np.uint32)
    assert got.tolist() == [0x0F0F0F0F, 4, 2**31]
    assert int(ops.bitmap_and_popcount(a, b)) == 16 + 1 + 1


@pytest.mark.parametrize("fn", [ops.bitmap_and, ops.bitmap_and_popcount])
def test_length_mismatch_raises(fn):
    a, b = _words(10, 1)
    with pytest.raises(ValueError):
        fn(a, b[:9])
    with pytest.raises(ValueError):
        fn(a, b[:9], use_kernel=False)


def test_popcount_refuses_counts_past_int32():
    """From 2^26 words on a count can pass 2^31 - 1, where the reference's
    int32 sum wraps; the port raises instead (the pages are never touched)."""
    big = torch.empty(bitmap_ops.MAX_POPCOUNT_WORDS + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.bitmap_and_popcount(big, big)
    assert bitmap_ops.MAX_POPCOUNT_WORDS * 32 <= 2**31 - 1


def test_kernel_wrappers_need_cuda_tensors():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        bitmap_ops.bitmap_and(a, a)
    with pytest.raises(ValueError):
        bitmap_ops.bitmap_and_popcount(a, a)


@pytest.fixture(scope="module")
def small_pubmed():
    schema = SG.make_pubmed(n_docs=3000, n_terms=60, n_authors=400, seed=4)
    return schema, GQFastDatabase(schema, account_space=False, device="cpu")


@pytest.mark.parametrize("t1,t2", [(3, 9), (0, 1), (5, 5), (2, 59)])
def test_membership_masks_intersect_like_numpy(small_pubmed, t1, t2):
    """The intersection a user asks for: two terms' document sets as bitmaps
    (32 documents a word, built from I_DT.Term) — their AND is the bitmap of
    np.intersect1d of the two document lists, its popcount their count, in
    the port and in the JAX package."""
    schema, db = small_pubmed
    di = db.device.index("DT", "Term")
    host = db.host_indexes[("DT", "Term")]
    n_doc = schema.domain_size("Document")
    ip = di.indptr.tolist()
    masks = [ops.membership_bitmap(di.dst_ids[ip[t]:ip[t + 1]], n_doc) for t in (t1, t2)]
    assert masks[0].shape == (-(-n_doc // 32),) and masks[0].dtype == torch.int32
    both = np.intersect1d(host.fragment(t1, "Doc"), host.fragment(t2, "Doc"))
    got = ops.bitmap_and(*masks)
    assert torch.equal(got, ops.membership_bitmap(torch.from_numpy(both), n_doc))
    assert int(ops.bitmap_and_popcount(*masks)) == both.shape[0]
    words = [m.numpy().view(np.uint32) for m in masks]
    assert int(jops.bitmap_and_popcount(*words)) == both.shape[0]
    bits = np.unpackbits(got.numpy().view(np.uint8), bitorder="little")
    assert np.array_equal(np.flatnonzero(bits), both)
