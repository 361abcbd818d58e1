"""Intersector tests: brute-force Moller-Trumbore against analytic cases."""
import numpy as np
import jax.numpy as jnp

from hydracore3.accel import traverse as ACC


def _soup(tris):
    tris = np.asarray(tris, np.float32)
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = len(tris)
    ids = np.arange(n, dtype=np.int32)
    return (jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
            jnp.asarray(np.zeros(n, np.int32)), jnp.asarray(np.zeros(n, np.int32)),
            jnp.asarray(ids))


def test_single_triangle_hit_miss():
    v0, e1, e2, inst, geom, prim = _soup([
        [[-1, -1, 0], [1, -1, 0], [0, 1, 0]]])
    pos = jnp.asarray([[0.0, 0.0, -5.0], [5.0, 5.0, -5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], jnp.float32)
    tmin = jnp.zeros(2)
    tmax = jnp.full((2,), 1e30)
    hit = ACC.intersect_brute(v0, e1, e2, inst, geom, prim, pos, d, tmin, tmax)
    assert float(hit.t[0]) == 5.0
    assert int(hit.geom_id[0]) == 0
    assert int(hit.geom_id[1]) == -1


def test_nearest_of_two():
    v0, e1, e2, inst, geom, prim = _soup([
        [[-1, -1, 2], [1, -1, 2], [0, 1, 2]],
        [[-1, -1, 1], [1, -1, 1], [0, 1, 1]]])
    pos = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    hit = ACC.intersect_brute(v0, e1, e2, inst, geom, prim, pos, d,
                              jnp.zeros(1), jnp.full((1,), 1e30))
    assert float(hit.t[0]) == 1.0
    assert int(hit.prim_id[0]) == 1


def test_barycentric_convention():
    """coords: u weights vertex B, v weights vertex C (EmbreeRT.cpp:350-352)."""
    v0, e1, e2, inst, geom, prim = _soup([
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]]])
    # aim near vertex B=(1,0,0)
    pos = jnp.asarray([[0.9, 0.05, -1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    hit = ACC.intersect_brute(v0, e1, e2, inst, geom, prim, pos, d,
                              jnp.zeros(1), jnp.full((1,), 1e30))
    assert float(hit.u[0]) > 0.85   # weight of B
    assert float(hit.v[0]) < 0.1    # weight of C


def test_any_hit_respects_tmax():
    v0, e1, e2, inst, geom, prim = _soup([
        [[-1, -1, 5], [1, -1, 5], [0, 1, 5]]])
    pos = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    occ_far = ACC.any_hit_brute(v0, e1, e2, geom, pos, d,
                                jnp.zeros(1), jnp.full((1,), 10.0))
    occ_near = ACC.any_hit_brute(v0, e1, e2, geom, pos, d,
                                 jnp.zeros(1), jnp.full((1,), 4.0))
    assert bool(occ_far[0]) and not bool(occ_near[0])


def test_chunked_matches_unchunked():
    rng = np.random.default_rng(0)
    tris = rng.normal(size=(100, 3, 3)).astype(np.float32)
    v0, e1, e2, inst, geom, prim = _soup(tris)
    pos = rng.normal(size=(64, 3)).astype(np.float32) * 3
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = jnp.zeros(64)
    tmax = jnp.full((64,), 1e30)
    h1 = ACC.intersect_brute(v0, e1, e2, inst, geom, prim, jnp.asarray(pos),
                             jnp.asarray(d), tmin, tmax, chunk=512)
    h2 = ACC.intersect_brute(v0, e1, e2, inst, geom, prim, jnp.asarray(pos),
                             jnp.asarray(d), tmin, tmax, chunk=16)
    np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(h1.prim_id), np.asarray(h2.prim_id))
