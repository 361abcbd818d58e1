"""Camera-plugin subsystem (ICamRaysAPI2 analog, SURVEY.md §2.10).

The plugin path — external ray generation -> PathTraceFromInputRays ->
sensor contribution — must reproduce the built-in camera's render when the
plugin camera matches the scene camera (the reference drives the same
Integrator through both paths, main_with_cam.cpp vs main.cpp).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from hydracore3 import camera_plugin as CP
from hydracore3 import render as R

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def test_pinhole_matches_builtin_camera(cornell_scene):
    scene, meta = cornell_scene
    params = CP.CamParameters(width=meta.width, height=meta.height)
    cam = CP.CamPinHole.match_scene_camera(params, scene)
    spp = 16
    img_plugin = CP.render_with_camera_plugin(scene, meta, cam, spp=spp)
    img_builtin = R.render(scene, meta, spp=spp, integrator='mispt')
    a = np.clip(img_plugin[..., :3], 0, 1)
    b = np.clip(np.asarray(img_builtin)[..., :3], 0, 1)
    psnr = _psnr(a, b)
    assert psnr > 25.0, f'plugin vs builtin camera PSNR too low: {psnr:.1f} dB'


def test_pinhole_ray_payload_shapes():
    params = CP.CamParameters(width=16, height=8, spectral=True)
    cam = CP.CamPinHole(params)
    pix = jnp.arange(16 * 8, dtype=jnp.int32)
    rng = cam.init_rng(len(pix))
    rng, pos, d, waves, time, aux = cam.make_rays_block(rng, pix)
    assert pos.shape == (128, 3) and d.shape == (128, 3)
    assert waves.shape == (128,) and time.shape == (128,)
    w = np.asarray(waves)
    assert (w >= 360.0).all() and (w <= 830.0).all()
    # directions normalized
    assert np.allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-4)


def test_table_lens_camera_produces_valid_rays():
    # biconvex lens (same table as test_optics.py): film->scene order,
    # line[i].eta is the incident medium of interface i
    lens = [(-0.05, 0.05, 1.0, 0.01), (0.05, 0.005, 1.5, 0.01)]
    params = CP.CamParameters(width=16, height=16)
    cam = CP.CamTableLens(params, lens, phys_size=(0.035, 0.035))
    pix = jnp.arange(256, dtype=jnp.int32)
    rng = cam.init_rng(len(pix))
    rng, pos, d, waves, time, aux = cam.make_rays_block(rng, pix)
    ok = np.asarray(aux) > 0
    assert ok.sum() > 32, 'no rays made it through the lens stack'
    dn = np.linalg.norm(np.asarray(d)[ok], axis=-1)
    assert np.allclose(dn, 1.0, atol=1e-4)


def test_sensor_accumulation_spectral():
    params = CP.CamParameters(width=4, height=4, spectral=True)
    cam = CP.CamPinHole(params)
    fb = jnp.zeros((16, 4), jnp.float32)
    colors = jnp.ones((16, 4), jnp.float32)
    pix = jnp.arange(16, dtype=jnp.int32)
    waves = jnp.full((16,), 555.0, jnp.float32)  # photopic peak
    fb = cam.add_samples_contribution_block(fb, colors, pix, waves)
    out = np.asarray(fb)
    assert (out[:, :3] > 0).any(), 'CIE response at 555nm must contribute'
