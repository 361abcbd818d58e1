"""Two-level BLAS/TLAS accel vs the brute-force oracle.

Covers CrossRT's AddGeom/AddInstance(Motion)/CommitScene semantics
(CrossRT.h:45-176): instanced geometry with O(mesh) memory and
matrix-lerped motion blur."""
import jax
import jax.numpy as jnp
import numpy as np

from hydracore3.accel import two_level as TL
from hydracore3.accel import traverse as TRV


def make_mesh(rng, n_tris, scale=1.0):
    v0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32) * scale
    e1 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32) * scale
    e2 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32) * scale
    return v0, e1, e2


def translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def rot_z(a):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(a), np.sin(a)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def world_soup(mesh_tris, instances):
    v0s, e1s, e2s, inst_ids = [], [], [], []
    for i, inst in enumerate(instances):
        v0, e1, e2 = mesh_tris[inst['geom_id']]
        m = inst['m0']
        w0 = v0 @ m[:3, :3].T + m[:3, 3]
        w1 = (v0 + e1) @ m[:3, :3].T + m[:3, 3]
        w2 = (v0 + e2) @ m[:3, :3].T + m[:3, 3]
        v0s.append(w0); e1s.append(w1 - w0); e2s.append(w2 - w0)
        inst_ids.append(np.full(len(v0), i, np.int32))
    return (np.concatenate(v0s), np.concatenate(e1s), np.concatenate(e2s),
            np.concatenate(inst_ids))


def rays(rng, n):
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(pos), jnp.asarray(d)


def test_two_level_matches_brute():
    rng = np.random.default_rng(7)
    meshes = [make_mesh(rng, 33), make_mesh(rng, 17, scale=0.5)]
    instances = [
        dict(geom_id=0, m0=translate([0, 0, 0]), m1=None),
        dict(geom_id=0, m0=translate([2.5, 0.3, -1]) @ rot_z(0.7), m1=None),
        dict(geom_id=1, m0=translate([-2, 1, 1]), m1=None),
        dict(geom_id=1, m0=rot_z(1.2) @ translate([0, -2, 0.5]), m1=None),
    ]
    tl_np = TL.build_two_level(meshes, instances)
    tl = jax.tree_util.tree_map(jnp.asarray, tl_np)

    N = 512
    pos, d = rays(rng, N)
    tmin = jnp.zeros((N,))
    tmax = jnp.full((N,), 1e30)

    sv0, se1, se2, sinst = world_soup(meshes, instances)
    ref = TRV.intersect_brute(
        jnp.asarray(sv0), jnp.asarray(se1), jnp.asarray(se2),
        jnp.asarray(sinst), jnp.asarray(sinst * 0), jnp.asarray(sinst * 0),
        pos, d, tmin, tmax)

    t, tri, inst, u, v = TL.intersect_two_level(tl, pos, d, tmin, tmax)

    hit_ref = np.asarray(ref.t) < 1e29
    hit_tl = np.asarray(t) < 1e29
    np.testing.assert_array_equal(hit_ref, hit_tl)
    # t values match to f32 tolerance (object-space vs world-space math)
    np.testing.assert_allclose(np.asarray(t)[hit_tl],
                               np.asarray(ref.t)[hit_ref], rtol=2e-3)
    np.testing.assert_array_equal(np.asarray(inst)[hit_tl],
                                  np.asarray(ref.inst_id)[hit_ref])


def test_two_level_any_hit():
    rng = np.random.default_rng(3)
    meshes = [make_mesh(rng, 25)]
    instances = [dict(geom_id=0, m0=translate([0, 0, 0]), m1=None),
                 dict(geom_id=0, m0=translate([1, 1, 1]), m1=None)]
    tl = jax.tree_util.tree_map(jnp.asarray,
                                TL.build_two_level(meshes, instances))
    N = 256
    pos, d = rays(rng, N)
    tmin = jnp.zeros((N,))
    tmax = jnp.full((N,), 1e30)
    t, tri, inst, u, v = TL.intersect_two_level(tl, pos, d, tmin, tmax)
    t2, tri2, _, _, _ = TL.intersect_two_level(tl, pos, d, tmin, tmax,
                                               any_hit=True)
    np.testing.assert_array_equal(np.asarray(tri) >= 0, np.asarray(tri2) >= 0)


def test_two_level_motion_matrix_lerp():
    """Matrix-lerped motion: at time t the instance transform is
    lerp(m0, m1, t) — for a rotating instance this differs from lerping
    triangle endpoints (the r1 approximation this module replaces)."""
    rng = np.random.default_rng(11)
    meshes = [make_mesh(rng, 19)]
    m0 = translate([0, 0, 0])
    m1 = translate([3, 0, 0])
    instances = [dict(geom_id=0, m0=m0, m1=m1)]
    tl = jax.tree_util.tree_map(jnp.asarray,
                                TL.build_two_level(meshes, instances))
    N = 256
    pos, d = rays(rng, N)
    tmin = jnp.zeros((N,))
    tmax = jnp.full((N,), 1e30)

    for tt in (0.0, 0.5, 1.0):
        time = jnp.full((N,), tt)
        t, tri, inst, u, v = TL.intersect_two_level(tl, pos, d, tmin, tmax,
                                                    time=time)
        # oracle: world soup at the lerped matrix
        mlerp = m0 * (1 - tt) + m1 * tt
        sv0, se1, se2, sinst = world_soup(
            meshes, [dict(geom_id=0, m0=mlerp, m1=None)])
        ref = TRV.intersect_brute(
            jnp.asarray(sv0), jnp.asarray(se1), jnp.asarray(se2),
            jnp.asarray(sinst), jnp.asarray(sinst * 0), jnp.asarray(sinst * 0),
            pos, d, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(t) < 1e29,
                                      np.asarray(ref.t) < 1e29)
        sel = np.asarray(t) < 1e29
        np.testing.assert_allclose(np.asarray(t)[sel], np.asarray(ref.t)[sel],
                                   rtol=2e-3)


def test_instancing_memory():
    """1000 instances of one mesh cost O(mesh) triangles."""
    rng = np.random.default_rng(5)
    meshes = [make_mesh(rng, 64)]
    instances = [dict(geom_id=0, m0=translate(rng.uniform(-50, 50, 3)),
                      m1=None) for _ in range(1000)]
    tl = TL.build_two_level(meshes, instances)
    assert tl.obj_v0.shape[0] == 64
    assert tl.inst_m0.shape[0] == 1000
