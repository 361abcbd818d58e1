"""Trace routing (scene/build.choose_accel), the instanced two-level path,
and the compile-cache directory choice."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

import hydracore3
from hydracore3.models import integrator_pt as IPT
from hydracore3.ops import rng as RNG
from hydracore3.scene import build as SB
from hydracore3.scene import synth

SMALL_CITY = dict(n_blocks=2, subdiv=1, seed=3, width=16, height=8, depth=1,
                  ground_subdiv=2)


@pytest.mark.parametrize('accel, platform, motion, soup, unique, want', [
    ('auto', 'gpu', False, 345_000, 345_000, (False, True, True)),
    ('auto', 'cpu', False, 345_000, 345_000, (False, False, True)),
    ('auto', 'cpu', False, 100, 100, (False, False, False)),
    ('auto', 'gpu', True, 1_000, 1_000, (True, False, True)),
    ('auto', 'gpu', False, 500_000, 10_000, (True, False, True)),
    ('bvh', 'gpu', False, 100, 100, (False, False, True)),
    ('kernel', 'cpu', False, 100, 100, (False, True, False)),
    ('two_level', 'gpu', False, 1_000, 1_000, (True, False, True)),
], ids=['gpu-kernel', 'cpu-oracle', 'cpu-brute', 'motion-two-level',
        'instanced-two-level', 'bvh-forced', 'kernel-forced',
        'two-level-forced'])
def test_choose_accel(accel, platform, motion, soup, unique, want):
    assert SB.choose_accel(accel, platform, motion, soup, unique) == want


@pytest.mark.parametrize('accel, motion', [('stream', False),
                                           ('stream_tlas', False),
                                           ('kernel', True)])
def test_choose_accel_rejects(accel, motion):
    with pytest.raises(ValueError):
        SB.choose_accel(accel, 'gpu', motion, 1000, 1000)


def test_load_scene_routes_once():
    """On the CPU 'auto' takes the oracle and packs no kernel tables;
    'kernel' packs them over the same BVH and leaf order, so switching
    ``use_kernel`` off gives exactly the 'bvh' route."""
    sa, ma = synth.city_scene(**SMALL_CITY, accel='auto')
    sk, mk = synth.city_scene(**SMALL_CITY, accel='kernel')
    sb, mb = synth.city_scene(**SMALL_CITY, accel='bvh')
    assert not ma.use_kernel and sa.kn_nodes is None
    assert mk.use_kernel and not mk.kernel_interpret
    assert sk.kn_nodes.shape[0] == sk.bvh_skip.shape[0] * 8
    assert mb.use_bvh and not mb.use_kernel
    assert dataclasses.replace(mk, use_kernel=False, use_bvh=True) == mb
    np.testing.assert_array_equal(np.asarray(sk.tri_v0), np.asarray(sb.tri_v0))
    np.testing.assert_array_equal(np.asarray(sk.bvh_skip),
                                  np.asarray(sb.bvh_skip))


def test_instanced_two_level_matches_flattened():
    """The instanced city through the two-level walk hits what the
    flattened world-space soup's BVH oracle hits."""
    kw = dict(n_blocks=3, subdiv=1, seed=2, width=16, height=12, depth=1,
              ground_subdiv=2)
    st, mt = synth.instanced_city_scene(**kw, accel='two_level')
    sf, mf = synth.instanced_city_scene(**kw, accel='bvh')
    assert mt.use_two_level and not mf.use_two_level
    n = mt.width * mt.height
    pix = jnp.arange(n, dtype=jnp.int32)
    out = []
    for scene, meta in ((st, mt), (sf, mf)):
        state, _ = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix), pix)
        out.append(IPT.kernel_ray_trace(scene, meta, state, 0))
    hit_t = ~IPT._is_dead(out[0].flags)
    hit_f = ~IPT._is_dead(out[1].flags)
    np.testing.assert_array_equal(np.asarray(hit_t), np.asarray(hit_f))
    h = np.asarray(hit_t)
    np.testing.assert_allclose(np.asarray(out[0].hit_dist)[h],
                               np.asarray(out[1].hit_dist)[h], rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out[0].hit_norm)[h],
                               np.asarray(out[1].hit_norm)[h], atol=1e-3)


@pytest.mark.parametrize('env', [None, 'custom'])
def test_compile_cache_dir(env, monkeypatch, tmp_path):
    if env is None:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        want = os.path.join(hydracore3.CHECKOUT_DIR, '.jax_cache')
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', want)
    assert hydracore3.compile_cache_dir() == want
