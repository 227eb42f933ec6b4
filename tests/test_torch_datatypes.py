"""The port's value stores (``datatypes.py``) and test signals
(``utils/signals.py``) against the JAX package's, on the CPU.

The stores' cases are ``tests/test_datatypes.py``'s (lifecycle, hash
semantics, the NotAllocated/NotFound/NotValid exceptions), with the dense
stores on the CPU (``device="cpu"``; the card is the default).  Beyond
them: ``set`` never changes the store it came from, ``to_bcoo`` (a
coalesced ``torch.sparse_coo_tensor``) equals ``to_array``, and
``SuperLine.windows`` gives JAX's windows, an empty window axis included.
The generators are copies: bitwise JAX's arrays.
"""
import numpy as np
import pytest
import torch

from jwave_pro_tpu import datatypes as jdt
from jwave_pro_tpu.utils import signals as jsig
from jwave_pro_tpu_torch import datatypes, exceptions
from jwave_pro_tpu_torch.utils import signals

CPU = {"device": "cpu"}


def test_line_block_space_dense():
    ln = datatypes.Line.create(8, **CPU).set(3, 5.0)
    assert float(ln.get(3)) == 5.0
    assert ln.to_array().device.type == "cpu"
    assert ln.to_array().dtype == torch.float64
    blk = datatypes.Block.create(4, 4, offset=(2, 2), **CPU).set(3, 3, 7.0)
    assert float(blk.get(3, 3)) == 7.0
    spc = datatypes.Space.create(2, 3, 4, **CPU).set(1, 2, 3, 9.0)
    assert float(spc.get(1, 2, 3)) == 9.0
    assert spc.shape == (2, 3, 4) and spc.nnz == 24
    ref = jdt.Space.create(2, 3, 4).set(1, 2, 3, 9.0)
    np.testing.assert_array_equal(spc.to_array().numpy(),
                                  np.asarray(ref.to_array()))


def test_sparse_stores():
    blk = datatypes.Block.sparse_create(4, 4, **CPU).set(1, 2, 7.0)
    assert float(blk.get(1, 2)) == 7.0
    assert tuple(blk.to_array().shape) == (4, 4)


def test_set_never_changes_the_store_it_came_from():
    ln = datatypes.Line.create(8, **CPU)
    cp = ln.copy()
    ln2 = ln.set(3, 5.0)
    assert float(ln.get(3)) == 0.0 and float(cp.get(3)) == 0.0
    assert float(ln2.get(3)) == 5.0
    assert ln2.data.data_ptr() != ln.data.data_ptr()
    cp2 = cp.set(4, 1.0)
    assert float(ln.get(4)) == 0.0 and float(cp.get(4)) == 0.0
    assert float(cp2.get(4)) == 1.0
    hs = datatypes.Line.sparse_create(8, **CPU).set(1, 2.0)
    hs2 = hs.set(2, 3.0)
    assert hs.nnz == 1 and hs2.nnz == 2


def test_super_lifecycle_parity():
    """Super.java:36-100: access before alloc raises NotAllocated; erase
    drops storage; alloc is idempotent."""
    ln = datatypes.Line.unallocated(8, **CPU)
    assert not ln.is_allocated and ln.nnz == 0
    with pytest.raises(exceptions.NotAllocated):
        ln.get(0)
    with pytest.raises(exceptions.NotAllocated):
        ln.set(0, 1.0)
    with pytest.raises(exceptions.NotAllocated):
        ln.to_array()
    ln = ln.alloc().set(2, 4.0)
    assert float(ln.get(2)) == 4.0
    with pytest.raises(exceptions.NotAllocated):
        ln.erase().get(2)
    assert ln.alloc() is ln
    sp = datatypes.Line.unallocated(8, sparse=True, **CPU).alloc()
    assert sp.is_allocated and sp.nnz == 0


def test_hash_store_semantics():
    """LineHash parity: O(1) sparse set (no densify), NotFound for unset
    indices (LineHash.java:183-199), NotValid out of range."""
    ln = datatypes.Line.sparse_create(1 << 20, **CPU)
    ln = ln.set(5, 2.5).set(999999, 1.5)
    assert ln.nnz == 2 and float(ln.get(5)) == 2.5
    with pytest.raises(exceptions.NotFound):
        ln.get(6)
    with pytest.raises(exceptions.NotValid):
        ln.get(1 << 21)
    with pytest.raises(exceptions.NotValid):
        ln.get(1, 2)
    bc = ln.to_bcoo()
    assert bc.is_sparse and bc.is_coalesced() and bc._nnz() == 2
    assert tuple(bc.shape) == (1 << 20,)
    blk = datatypes.Block.sparse_create(4, 4, offset=(1, 1), **CPU).set(
        2, 3, 7.0)
    dense = blk.to_array().numpy()
    assert dense[1, 2] == 7.0 and dense.sum() == 7.0
    assert blk.to_bcoo().to_dense().sum() == 7.0
    assert float(blk.copy().get(2, 3)) == 7.0
    with pytest.raises(exceptions.NotValid):
        blk.get(0, 0)


@pytest.mark.parametrize("sparse", [False, True])
def test_to_bcoo_equals_to_array(sparse):
    make = datatypes.Space.sparse_create if sparse else datatypes.Space.create
    ref_make = jdt.Space.sparse_create if sparse else jdt.Space.create
    st, ref = make(3, 4, 5, **CPU), ref_make(3, 4, 5)
    for idx, v in (((0, 1, 2), 1.5), ((2, 3, 4), -2.0), ((1, 0, 0), 3.25),
                   ((0, 1, 2), 4.0)):
        st, ref = st.set(*idx, v), ref.set(*idx, v)
    bc = st.to_bcoo()
    assert bc.is_coalesced() and bc._nnz() == 3
    np.testing.assert_array_equal(bc.to_dense().numpy(),
                                  st.to_array().numpy())
    np.testing.assert_array_equal(st.to_array().numpy(),
                                  np.asarray(ref.to_array()))
    np.testing.assert_array_equal(bc.to_dense().numpy(),
                                  np.asarray(ref.to_bcoo().todense()))
    empty = (datatypes.Line.sparse_create(6, **CPU) if sparse
             else datatypes.Line.create(6, **CPU)).to_bcoo()
    assert empty._nnz() == 0 and tuple(empty.shape) == (6,)


@pytest.mark.parametrize("n,window,hop", [(10, 4, 2), (10, 4, 3), (3, 4, 2),
                                          (4, 4, 1), (1, 4, 2)])
def test_superline_windows_match_jax(n, window, hop):
    x = np.arange(float(n)).reshape(1, n) * np.array([[1.0], [-2.0]])
    got = datatypes.SuperLine(torch.from_numpy(x), window, hop).windows()
    want = np.asarray(jdt.SuperLine(x, window, hop).windows())
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if n < window:
        assert tuple(got.shape) == (2, 0, window)


def test_superline_windows_are_a_copy():
    x = torch.arange(10.0)
    w = datatypes.SuperLine(x, 4, 2).windows()
    w[0, 0] = 99.0
    assert float(x[0]) == 0.0
    np.testing.assert_allclose(w[1].numpy(), [2, 3, 4, 5])


@pytest.mark.parametrize("name,args", [
    ("sine_oscillation", (64, 2, 1.5)), ("cosine_oscillation", (64,)),
    ("chirp", (256,)), ("chirp", (300, 2.0, 80.0, 500.0)),
    ("ecg_like", (720,)), ("ecg_like", (1000, 250.0, 60.0, 3)),
    ("noisy_sine", (128,)), ("noisy_sine", (100, 3, 2.0, 7))])
def test_signal_generators_bitwise_jax(name, args):
    got = getattr(signals, name)(*args)
    want = getattr(jsig, name)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)


def test_signal_generators_properties():
    s = signals.sine_oscillation(64, oscillations=2)
    assert abs(s[0]) < 1e-12 and len(s) == 64
    assert abs(signals.cosine_oscillation(64)[0] - 1.0) < 1e-12
    e = signals.ecg_like(720)
    assert len(e) == 720 and np.max(e) > 0.5
    noisy, clean = signals.noisy_sine(128)
    assert np.std(noisy - clean) > 0
