"""BVH build + traversal correctness vs the brute-force oracle."""
import numpy as np
import jax.numpy as jnp

from hydracore3.accel import build_bvh, traverse as ACC


def _random_soup(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, size=(n, 1, 3))
    tri = base + rng.normal(scale=0.5, size=(n, 3, 3))
    tri = tri.astype(np.float32)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    return v0, e1, e2


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos, d


def test_bvh_matches_brute_force():
    v0, e1, e2 = _random_soup(300)
    bvh = build_bvh.build(v0, e1, e2)
    order = bvh.order
    assert sorted(order.tolist()) == list(range(300))

    inst = np.zeros(300, np.int32)
    geom = np.zeros(300, np.int32)
    prim = np.arange(300, dtype=np.int32)

    pos, d = _rays(256)
    tmin = jnp.zeros(256)
    tmax = jnp.full((256,), 1e30)

    ref = ACC.intersect_brute(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
                              jnp.asarray(inst), jnp.asarray(geom), jnp.asarray(prim),
                              jnp.asarray(pos), jnp.asarray(d), tmin, tmax)

    bvh_arrays = dict(bmin=jnp.asarray(bvh.bmin), bmax=jnp.asarray(bvh.bmax),
                      skip=jnp.asarray(bvh.skip), tri_offset=jnp.asarray(bvh.tri_offset),
                      tri_count=jnp.asarray(bvh.tri_count))
    got = ACC.intersect_bvh(bvh_arrays,
                            jnp.asarray(v0[order]), jnp.asarray(e1[order]),
                            jnp.asarray(e2[order]),
                            jnp.asarray(inst[order]), jnp.asarray(geom[order]),
                            jnp.asarray(prim[order]),
                            jnp.asarray(pos), jnp.asarray(d), tmin, tmax)

    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t), rtol=2e-5)
    np.testing.assert_array_equal(np.asarray(got.prim_id), np.asarray(ref.prim_id))


def test_bvh_any_hit():
    v0, e1, e2 = _random_soup(150, seed=5)
    bvh = build_bvh.build(v0, e1, e2)
    order = bvh.order
    geom = np.zeros(150, np.int32)
    pos, d = _rays(128, seed=6)
    tmin = jnp.zeros(128)
    tmax = jnp.full((128,), 1e30)

    ref = ACC.any_hit_brute(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
                            jnp.asarray(geom), jnp.asarray(pos), jnp.asarray(d),
                            tmin, tmax)
    bvh_arrays = dict(bmin=jnp.asarray(bvh.bmin), bmax=jnp.asarray(bvh.bmax),
                      skip=jnp.asarray(bvh.skip), tri_offset=jnp.asarray(bvh.tri_offset),
                      tri_count=jnp.asarray(bvh.tri_count))
    got = ACC.any_hit_bvh(bvh_arrays, jnp.asarray(v0[order]), jnp.asarray(e1[order]),
                          jnp.asarray(e2[order]), jnp.asarray(geom[order]),
                          jnp.asarray(pos), jnp.asarray(d), tmin, tmax)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_bvh_miss_with_tmax_above_sentinel():
    """t_max at float32's max (the integrator's live-ray interval) is above
    the FLT_MAX miss sentinel: a leaf the ray's box test reaches but whose
    triangles it misses must not report a hit."""
    v0, e1, e2 = _random_soup(200, seed=4)
    bvh = build_bvh.build(v0, e1, e2)
    order = bvh.order
    v0, e1, e2 = v0[order], e1[order], e2[order]
    pos, d = _rays(256, seed=5)
    arrs = {k: jnp.asarray(getattr(bvh, k))
            for k in ('bmin', 'bmax', 'skip', 'tri_offset', 'tri_count')}
    z = jnp.zeros(len(v0), jnp.int32)
    tmax = jnp.full((256,), float(np.finfo(np.float32).max))
    hit = ACC.intersect_bvh(arrs, jnp.asarray(v0), jnp.asarray(e1),
                            jnp.asarray(e2), z, z, z, jnp.asarray(pos),
                            jnp.asarray(d), jnp.zeros(256), tmax)
    ref = ACC.intersect_brute(jnp.asarray(v0), jnp.asarray(e1),
                              jnp.asarray(e2), z, z, z, jnp.asarray(pos),
                              jnp.asarray(d), jnp.zeros(256), tmax)
    np.testing.assert_array_equal(np.asarray(hit.soup_id) >= 0,
                                  np.asarray(ref.soup_id) >= 0)
    assert (np.asarray(hit.soup_id) < 0).any()
