"""Native (C++) BVH builder vs the pure-Python reference implementation.

The reference's BVH build is native (Embree3, external/CrossRT/EmbreeRT.cpp);
ours is native/bvh_builder.cpp behind a ctypes ABI.  Both builders implement
the identical binned-SAH algorithm, so the emitted flat trees must match
bit-for-bit; traversal correctness is covered by test_bvh.py.
"""
import numpy as np
import pytest

from hydracore3.accel import build_bvh as BB


@pytest.fixture(scope='module')
def tris():
    rs = np.random.RandomState(7)
    T = 3000
    v0 = rs.randn(T, 3).astype(np.float32)
    e1 = (rs.randn(T, 3) * 0.1).astype(np.float32)
    e2 = (rs.randn(T, 3) * 0.1).astype(np.float32)
    return v0, e1, e2


def test_native_lib_loads():
    assert BB._load_native() is not None, (
        'native/bvh_builder.cpp failed to compile or load')


def test_native_matches_python(tris):
    v0, e1, e2 = tris
    nat = BB.build(v0, e1, e2, use_native=True)
    py = BB.build(v0, e1, e2, use_native=False)
    assert np.array_equal(nat.skip, py.skip)
    assert np.array_equal(nat.tri_offset, py.tri_offset)
    assert np.array_equal(nat.tri_count, py.tri_count)
    assert np.array_equal(nat.order, py.order)
    assert np.allclose(nat.bmin, py.bmin)
    assert np.allclose(nat.bmax, py.bmax)


def test_native_matches_python_motion(tris):
    v0, e1, e2 = tris
    rs = np.random.RandomState(9)
    dv = (rs.randn(*v0.shape) * 0.05).astype(np.float32)
    motion = (v0 + dv, e1, e2)
    nat = BB.build(v0, e1, e2, motion_end=motion, use_native=True)
    py = BB.build(v0, e1, e2, motion_end=motion, use_native=False)
    assert np.array_equal(nat.skip, py.skip)
    assert np.array_equal(nat.order, py.order)
    assert np.allclose(nat.bmin, py.bmin)


def test_structural_invariants(tris):
    v0, e1, e2 = tris
    b = BB.build(v0, e1, e2, use_native=True)
    T = len(v0)
    assert sorted(b.order.tolist()) == list(range(T))
    assert int(b.tri_count.sum()) == T
    leaves = b.tri_count > 0
    assert (b.tri_count[leaves] <= BB.MAX_LEAF).all()
    assert (b.tri_offset[~leaves] == -1).all()
