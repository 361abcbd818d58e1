"""Big-scene (per-ray BVH kernel) end-to-end correctness.

A small synthetic city is traced twice over the SAME committed scene — the
GPU kernel (Pallas interpreter on the CPU) vs the brute-force oracle — by
flipping meta.use_kernel.  Same soup order, same RNG, same shading: the
single-sample radiance must agree to f32 intersection numerics, and the
per-ray liveness flags must agree except for knife-edge barycentric
boundary flips.

(Comparing two separately-loaded scenes is avoided on purpose: equal-t
ties at shared edges would then pick different winners, which flips
masked-RNG draws and decorrelates the noise — same expectation, different
samples.)

The full 215k-triangle city runs compiled on a GPU in chip_smoke.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from hydracore3.scene import synth
from hydracore3.models import integrator_pt as IPT
from hydracore3.ops import rng as RNG

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`

CITY_KW = dict(n_blocks=4, subdiv=1, seed=3, width=32, height=16, depth=2,
               ground_subdiv=8)


@pytest.fixture(scope='module')
def city(tmp_path_factory):
    base = tmp_path_factory.mktemp('city')
    scene, meta = synth.city_scene(**CITY_KW, accel='kernel',
                                   cache_dir=str(base / 's'))
    return scene, dataclasses.replace(meta, kernel_interpret=True)


def test_city_uses_stream(city):
    """The city routes to the per-ray kernel, whose packed tables cover
    the whole leaf-ordered soup."""
    scene, meta = city
    assert meta.use_kernel and not meta.use_two_level
    assert scene.kn_tris.shape[0] == scene.tri_v0.shape[0] * 9
    assert scene.kn_nodes.shape[0] == scene.bvh_skip.shape[0] * 8


def test_stream_pass_matches_brute_same_scene(city):
    scene, meta = city
    # the vectorized brute oracle compiles in seconds on the CPU
    meta_brute = dataclasses.replace(meta, use_kernel=False, use_bvh=False)
    N = meta.width * meta.height
    pix = jnp.arange(N, dtype=jnp.int32)

    def one(m):
        r = RNG.gen_init(pix)
        acc, _, fl, r2, _ = IPT.trace_pass(scene, m, r, pix,
                                           IPT.INTEGRATOR_MIS_PT,
                                           IPT.FB_COLOR, None)
        return np.asarray(acc), np.asarray(fl), np.asarray(r2)

    acc_s, fl_s, rng_s = one(meta)
    acc_b, fl_b, rng_b = one(meta_brute)
    np.testing.assert_allclose(acc_s, acc_b, rtol=1e-4, atol=1e-4)
    # knife-edge barycentric flips may change liveness on isolated rays
    flag_agree = (fl_s == fl_b).mean()
    assert flag_agree > 0.999, f'flags agree only {flag_agree:.4%}'
    assert (rng_s == rng_b).all(axis=1).mean() > 0.999


def test_padded_soup_is_degenerate(city):
    """The kernel pads rays, never triangles: the soup holds exactly the
    scene's triangles, none of them degenerate, and the BVH leaves cover
    each of them once."""
    scene, meta = city
    e1 = np.asarray(scene.tri_e1)
    e2 = np.asarray(scene.tri_e2)
    area = np.linalg.norm(np.cross(e1, e2), axis=1)
    assert len(area) == meta.num_tris and (area > 0).all()
    cnt = np.asarray(scene.bvh_tri_count)
    off = np.asarray(scene.bvh_tri_offset)
    covered = np.concatenate([np.arange(o, o + c)
                              for o, c in zip(off[cnt > 0], cnt[cnt > 0])])
    np.testing.assert_array_equal(np.sort(covered), np.arange(meta.num_tris))
