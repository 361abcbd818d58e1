"""Per-ray BVH kernel (accel/traverse_gpu.py) against the XLA oracles.

On the CPU the kernel runs through the Pallas interpreter
(``interpret=True``), which executes the same kernel body; the compiled
Triton lowering is checked by the ``gpu`` tests here on a card and at full
size by chip_smoke.py.  Batches stay small so the interpreter stays fast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hydracore3.accel import build_bvh
from hydracore3.accel import traverse as ACC
from hydracore3.accel import traverse_gpu as TG


def random_soup(n_tris, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def city_soup():
    """The leaf-ordered soup of a small synthetic city (axis-aligned
    boxes and a ground grid: shared edges, coplanar faces, exact ties)."""
    from hydracore3.scene import synth
    scene, _ = synth.city_scene(n_blocks=3, subdiv=1, seed=5, width=16,
                                height=16, depth=1, ground_subdiv=4,
                                accel='bvh')
    return tuple(np.asarray(a) for a in (scene.tri_v0, scene.tri_e1,
                                         scene.tri_e2))


def leaf_ordered(v0, e1, e2):
    bvh = build_bvh.build(v0, e1, e2)
    o = bvh.order
    return bvh, v0[o], e1[o], e2[o]


def packed(bvh, v0, e1, e2):
    nodes, tris = TG.pack(bvh.bmin, bvh.bmax, bvh.skip, bvh.tri_offset,
                          bvh.tri_count, v0, e1, e2)
    return jnp.asarray(nodes), jnp.asarray(tris)


def random_rays(n, seed=1, spread=1.5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(pos), jnp.asarray(d)


def brute(v0, e1, e2, pos, d, tmin, tmax):
    z = jnp.zeros(len(v0), jnp.int32)
    return ACC.intersect_brute(jnp.asarray(v0), jnp.asarray(e1),
                               jnp.asarray(e2), z, z, z, pos, d, tmin, tmax)


def assert_matches(t, tri, u, v, ref):
    t, tri, u, v = (np.asarray(x) for x in (t, tri, u, v))
    rtri = np.asarray(ref.soup_id)
    np.testing.assert_array_equal(tri >= 0, rtri >= 0)
    # ties between coplanar triangles may pick either: compare the rest
    same = (tri == rtri) & (tri >= 0)
    assert same.sum() >= 0.99 * (tri >= 0).sum()
    hit = tri >= 0
    np.testing.assert_allclose(t[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    np.testing.assert_allclose(u[same], np.asarray(ref.u)[same], atol=1e-5)
    np.testing.assert_allclose(v[same], np.asarray(ref.v)[same], atol=1e-5)
    assert (t[~hit] == ACC.FLT_MAX).all()


SOUPS = {
    '37': lambda: random_soup(37, seed=2),
    '300': lambda: random_soup(300, seed=3),
    '2000': lambda: random_soup(2000, seed=4, spread=2.0),
    'city': city_soup,
}


@pytest.mark.parametrize('any_hit', [False, True], ids=['nearest', 'any'])
@pytest.mark.parametrize('soup', list(SOUPS))
def test_kernel_matches_brute(soup, any_hit):
    bvh, v0, e1, e2 = leaf_ordered(*SOUPS[soup]())
    nodes, tris = packed(bvh, v0, e1, e2)
    if soup == 'city':
        lo, hi = v0.min(0), (v0 + e1).max(0)
        rng = np.random.default_rng(9)
        pos = jnp.asarray(rng.uniform(lo, hi + [0, 5, 0], (384, 3))
                          .astype(np.float32))
        _, d = random_rays(384, seed=10)
    else:
        pos, d = random_rays(384)
    n = pos.shape[0]
    tmin = jnp.zeros(n)
    tmax = jnp.full((n,), 1e30)
    out = TG.intersect(nodes, tris, pos, d, tmin, tmax, any_hit=any_hit,
                       interpret=True)
    ref = brute(v0, e1, e2, pos, d, tmin, tmax)
    if any_hit:
        np.testing.assert_array_equal(np.asarray(out[1]) >= 0,
                                      np.asarray(ref.soup_id) >= 0)
    else:
        assert_matches(*out, ref)


def test_interval_and_dead_lanes():
    """Strict t_min < t < t_max, and lanes with t_max <= t_min do no work:
    a ray through two parallel triangles at z=1 and z=2."""
    v0 = np.array([[-1, -1, 1], [-1, -1, 2]], np.float32)
    e1 = np.array([[2, 0, 0], [2, 0, 0]], np.float32)
    e2 = np.array([[0, 2, 0], [0, 2, 0]], np.float32)
    bvh, v0, e1, e2 = leaf_ordered(v0, e1, e2)
    nodes, tris = packed(bvh, v0, e1, e2)
    pos = jnp.zeros((6, 3))
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (6, 1))
    tmin = jnp.array([0.0, 1.0, 1.5, 0.0, 0.0, 3.0])
    tmax = jnp.array([9.0, 9.0, 9.0, 1.0, 0.0, 3.0])
    t, idx, _, _ = TG.intersect(nodes, tris, pos, d, tmin, tmax,
                                interpret=True)
    np.testing.assert_allclose(np.asarray(t)[:3], [1.0, 2.0, 2.0])
    # t == t_max (lane 3) and empty intervals (lanes 4, 5) miss
    assert (np.asarray(idx)[3:] == -1).all()
    assert (np.asarray(t)[3:] == ACC.FLT_MAX).all()
    _, idx_any, _, _ = TG.intersect(nodes, tris, pos, d, tmin, tmax,
                                    any_hit=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(idx_any) >= 0,
                                  [True, True, True, False, False, False])


def test_degenerate_triangles_never_hit():
    """Zero-area padding rows (zero edges) are skipped by the det test."""
    v0, e1, e2 = random_soup(40, seed=6)
    e1[::3] = 0.0
    e2[::3] = 0.0
    bvh, v0, e1, e2 = leaf_ordered(v0, e1, e2)
    nodes, tris = packed(bvh, v0, e1, e2)
    pos, d = random_rays(256, seed=7)
    tmin, tmax = jnp.zeros(256), jnp.full((256,), 1e30)
    t, idx, u, v = TG.intersect(nodes, tris, pos, d, tmin, tmax,
                                interpret=True)
    flat = (np.abs(e1).sum(1) == 0) & (np.abs(e2).sum(1) == 0)
    hit = np.asarray(idx)
    assert not flat[hit[hit >= 0]].any()
    assert_matches(t, idx, u, v, brute(v0, e1, e2, pos, d, tmin, tmax))


@pytest.mark.parametrize('n', [1, 127, 129, 300])
def test_ray_count_not_a_block_multiple(n):
    bvh, v0, e1, e2 = leaf_ordered(*random_soup(64, seed=8))
    nodes, tris = packed(bvh, v0, e1, e2)
    pos, d = random_rays(n, seed=n)
    tmin, tmax = jnp.zeros(n), jnp.full((n,), 1e30)
    out = TG.intersect(nodes, tris, pos, d, tmin, tmax, interpret=True)
    assert all(x.shape == (n,) for x in out)
    assert_matches(*out, brute(v0, e1, e2, pos, d, tmin, tmax))


def test_matches_bvh_oracle():
    """Same BVH, same leaf order, same formula: the kernel hits the
    oracle's triangles, with t equal up to instruction-level rounding."""
    bvh, v0, e1, e2 = leaf_ordered(*random_soup(500, seed=12))
    nodes, tris = packed(bvh, v0, e1, e2)
    pos, d = random_rays(256, seed=13)
    tmin, tmax = jnp.zeros(256), jnp.full((256,), 1e30)
    t, idx, _, _ = TG.intersect(nodes, tris, pos, d, tmin, tmax,
                                interpret=True)
    arrs = {k: jnp.asarray(getattr(bvh, k))
            for k in ('bmin', 'bmax', 'skip', 'tri_offset', 'tri_count')}
    z = jnp.zeros(len(v0), jnp.int32)
    ref = ACC.intersect_bvh(arrs, jnp.asarray(v0), jnp.asarray(e1),
                            jnp.asarray(e2), z, z, z, pos, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref.soup_id))
    np.testing.assert_allclose(np.asarray(t), np.asarray(ref.t), rtol=1e-5,
                               atol=1e-6)


def test_pack_layout():
    """Node rows hold bmin, bmax, the skip pointer and the leaf word
    (offset * 8 + count) bit for bit; triangles are v0|e1|e2 rows."""
    bvh, v0, e1, e2 = leaf_ordered(*random_soup(50, seed=14))
    nodes, tris = TG.pack(bvh.bmin, bvh.bmax, bvh.skip, bvh.tri_offset,
                          bvh.tri_count, v0, e1, e2)
    rows = nodes.reshape(-1, TG.NODE_W)
    np.testing.assert_array_equal(rows[:, 0:3], bvh.bmin)
    np.testing.assert_array_equal(rows[:, 3:6], bvh.bmax)
    ints = rows[:, 6:8].view(np.int32)
    np.testing.assert_array_equal(ints[:, 0], bvh.skip)
    leaf = bvh.tri_count > 0
    np.testing.assert_array_equal(ints[leaf, 1] & 7, bvh.tri_count[leaf])
    np.testing.assert_array_equal(ints[leaf, 1] >> 3, bvh.tri_offset[leaf])
    assert (ints[~leaf, 1] == 0).all()
    np.testing.assert_array_equal(tris.reshape(-1, 9)[:, 3:6], e1)
    with pytest.raises(ValueError):
        TG.pack(bvh.bmin, bvh.bmax, bvh.skip, bvh.tri_offset,
                bvh.tri_count + 5, v0, e1, e2)


def test_gradient_rule():
    """The trace is a constant under differentiation: grad flows around it
    (zero through t/u/v) without differentiating the pallas_call."""
    bvh, v0, e1, e2 = leaf_ordered(*random_soup(60, seed=15))
    nodes, tris = packed(bvh, v0, e1, e2)
    pos, d = random_rays(128, seed=16)
    tmin, tmax = jnp.zeros(128), jnp.full((128,), 1e30)

    def f(p, dd):
        t, idx, u, v = TG.intersect(nodes, tris, p, dd, tmin, tmax,
                                    interpret=True)
        hit = idx >= 0
        return jnp.sum(jnp.where(hit, t + u + v, 0.0)) + jnp.sum(p)

    gp, gd = jax.grad(f, argnums=(0, 1))(pos, d)
    np.testing.assert_array_equal(np.asarray(gp), 1.0)
    np.testing.assert_array_equal(np.asarray(gd), 0.0)


def test_gradient_through_kernel_render_matches_oracle():
    """Texture gradient of a small kernel-routed render (interpret mode)
    equals the XLA-oracle route's: same samples, hits stop gradients."""
    import dataclasses
    from hydracore3.models import dr as DR
    from hydracore3.ops import rng as RNG
    from hydracore3.scene import synth
    scene, meta = synth.city_scene(n_blocks=2, subdiv=1, seed=4, width=8,
                                   height=8, depth=2, ground_subdiv=2,
                                   textured=True, accel='kernel')
    setup = DR.put_diff_tex(scene, int(scene.mat_texid[0, 0]))
    params = scene.textures.texels[
        setup.texel_offset:setup.texel_offset + setup.size]
    pix = jnp.arange(64, dtype=jnp.int32)
    ref = jnp.zeros((64, 3))
    grads = []
    for m in (dataclasses.replace(meta, kernel_interpret=True),
              dataclasses.replace(meta, use_kernel=False, use_bvh=True)):
        _, g, _, _ = DR.loss_and_grad(params, scene, m, setup,
                                      RNG.gen_init(pix), pix, ref)
        grads.append(np.asarray(g))
    assert np.abs(grads[0]).max() > 0
    # rounding of t moves hit points by ulps, which the shading carries
    rel = np.linalg.norm(grads[0] - grads[1]) / np.linalg.norm(grads[1])
    assert rel < 1e-4, rel


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle(gpu_only):
    """The Triton-compiled kernel on a card agrees with the oracle."""
    bvh, v0, e1, e2 = leaf_ordered(*random_soup(3000, seed=17, spread=3.0))
    nodes, tris = packed(bvh, v0, e1, e2)
    pos, d = random_rays(4096, seed=18, spread=3.5)
    tmin, tmax = jnp.zeros(4096), jnp.full((4096,), 1e30)
    for any_hit in (False, True):
        out = TG.intersect(nodes, tris, pos, d, tmin, tmax, any_hit=any_hit)
        ref = brute(v0, e1, e2, pos, d, tmin, tmax)
        if any_hit:
            np.testing.assert_array_equal(np.asarray(out[1]) >= 0,
                                          np.asarray(ref.soup_id) >= 0)
        else:
            assert_matches(*out, ref)
