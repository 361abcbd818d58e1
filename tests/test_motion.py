"""Motion blur: per-ray time-lerped triangle intersection
(RayQuery_NearestHitMotion / AnyHitMotion, CrossRT.h:160-174) and the
motion_test.xml end-to-end render."""
import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`

MOTION_XML = '/root/reference/scenes/test_035/motion_test.xml'


def _one_tri():
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    e1 = jnp.array([[1.0, 0.0, 0.0]])
    e2 = jnp.array([[0.0, 0.0, 1.0]])
    # moves +2 in x at t=1
    dv0 = jnp.array([[2.0, 0.0, 0.0]])
    dz = jnp.zeros((1, 3))
    return v0, e1, e2, (dv0, dz, dz)


def test_brute_motion_lerp():
    from hydracore3.accel import traverse as ACC
    v0, e1, e2, deltas = _one_tri()
    inst = jnp.zeros(1, jnp.int32)
    pos = jnp.array([[0.5, 1.0, 0.25],   # above original tri
                     [0.5, 1.0, 0.25],
                     [2.5, 1.0, 0.25],   # above moved tri
                     [1.5, 1.0, 0.25]])  # above midpoint position
    d = jnp.tile(jnp.array([[0.0, -1.0, 0.0]]), (4, 1))
    times = jnp.array([0.0, 1.0, 1.0, 0.5])
    tmin = jnp.zeros(4)
    tmax = jnp.full(4, 1e30)
    hit = ACC.intersect_brute(v0, e1, e2, inst, inst, inst, pos, d, tmin,
                              tmax, motion=deltas + (times,))
    found = np.asarray(hit.geom_id >= 0)
    assert list(found) == [True, False, True, True]

    occ = ACC.any_hit_brute(v0, e1, e2, inst, pos, d, tmin, tmax,
                            motion=deltas + (times,))
    assert list(np.asarray(occ)) == [True, False, True, True]


def test_bvh_motion_lerp():
    from hydracore3.accel import traverse as ACC
    from hydracore3.accel import build_bvh
    v0, e1, e2, deltas = _one_tri()
    b = build_bvh.build(np.asarray(v0), np.asarray(e1), np.asarray(e2),
                        motion_end=(np.asarray(v0 + deltas[0]),
                                    np.asarray(e1), np.asarray(e2)))
    bvh = dict(bmin=jnp.asarray(b.bmin), bmax=jnp.asarray(b.bmax),
               skip=jnp.asarray(b.skip), tri_offset=jnp.asarray(b.tri_offset),
               tri_count=jnp.asarray(b.tri_count))
    inst = jnp.zeros(1, jnp.int32)
    pos = jnp.array([[0.5, 1.0, 0.25],
                     [0.5, 1.0, 0.25],
                     [2.5, 1.0, 0.25]])
    d = jnp.tile(jnp.array([[0.0, -1.0, 0.0]]), (3, 1))
    times = jnp.array([0.0, 1.0, 1.0])
    hit = ACC.intersect_bvh(bvh, v0, e1, e2, inst, inst, inst, pos, d,
                            jnp.zeros(3), jnp.full(3, 1e30),
                            motion=deltas + (times,))
    assert list(np.asarray(hit.geom_id >= 0)) == [True, False, True]


def test_motion_scene_end_to_end():
    from hydracore3.scene import build as SB
    from hydracore3 import render as R
    scene, meta = SB.load_scene(MOTION_XML, width=32, height=24)
    assert meta.has_motion
    assert float(jnp.abs(scene.tri_dv0).max()) > 0.1
    img = np.asarray(R.render(scene, meta, spp=8, integrator='mispt'))
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0.005
