"""Whitted RT + G-buffer tests on the Cornell scene."""
import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`


def test_cast_single_ray(cornell_scene):
    from hydracore3.models import integrator_rt as IRT
    scene, meta = cornell_scene
    N = meta.width * meta.height
    pix = jnp.arange(N, dtype=jnp.int32)
    color = np.asarray(IRT.cast_single_ray(scene, meta, pix)).reshape(
        meta.height, meta.width, 4)
    assert np.isfinite(color).all()
    assert color[..., :3].max() > 0.1     # something visible
    h, w = color.shape[:2]
    center = color[h // 2, w // 2, :3]
    assert center.sum() > 0               # cube or back wall at image center


def test_whitted_raytrace(cornell_scene):
    from hydracore3.models import integrator_rt as IRT
    scene, meta = cornell_scene
    N = meta.width * meta.height
    pix = jnp.arange(N, dtype=jnp.int32)
    img = np.asarray(IRT.ray_trace(scene, meta, pix)).reshape(
        meta.height, meta.width, 4)
    assert np.isfinite(img).all()
    # note: like the reference (integrator_rt.cpp:261), Whitted uses
    # light.intensity WITHOUT the multiplier, so this scene renders dim
    assert img[..., :3].max() > 0.005     # direct lighting visible
    assert (img[..., :3] > 0).any()


def test_whitted_rotated_light_attenuation():
    """Regression (r3 item 9 / r4 weak #8): the Whitted light-hit
    attenuation must use the INSTANCED light normal (integrator_rt.cpp:
    222-243), not a hardcoded (0,-1,0).  A light rotated 90 deg about Z
    emits toward +X: a camera on +X sees the bright face, a camera on -X
    sees the dark back face."""
    import jax.numpy as jnp
    from hydracore3 import api as HR
    from hydracore3.models import integrator_rt as IRT

    def build(cam_pos):
        ctx = HR.hr2_create_scene()
        # Rz(90): area-light normal (0,-1,0) -> (1,0,0)
        rz = np.array([[0, -1, 0, 0], [1, 0, 0, 0],
                       [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        ctx.light_area(name='side', color=(1.0, 1.0, 1.0), multiplier=4.0,
                       half_width=1.5, half_length=1.5, matrix=rz)
        ctx.camera_set(pos=cam_pos, look_at=(0.0, 0.0, 0.0),
                       up=(0.0, 1.0, 0.0), fov=45.0)
        ctx.settings_set(width=32, height=24, depth=2, spp=1)
        return ctx.commit()

    def light_pixels(cam_pos):
        scene, meta = build(cam_pos)
        pix = jnp.arange(meta.width * meta.height, dtype=jnp.int32)
        img = np.asarray(IRT.ray_trace(scene, meta, pix)).reshape(
            meta.height, meta.width, 4)
        # center rows/cols hold the light quad
        return img[8:16, 12:20, :3]

    bright = light_pixels((6.0, 0.0, 0.0))    # facing the emitting side
    dark = light_pixels((-6.0, 0.0, 0.0))     # facing the back side
    assert bright.max() > 0.5, bright.max()
    assert dark.max() < 1e-4, dark.max()


def test_gbuffer(cornell_scene):
    from hydracore3.models import gbuffer as GB
    scene, meta = cornell_scene
    N = meta.width * meta.height
    pix = jnp.arange(N, dtype=jnp.int32)
    gb = GB.eval_gbuffer(scene, meta, pix)
    depth = np.asarray(gb.depth).reshape(meta.height, meta.width)
    inst = np.asarray(gb.inst_id).reshape(meta.height, meta.width)
    cov = np.asarray(gb.coverage)
    assert np.isfinite(depth).all()
    assert depth.max() > 5.0              # box is ~15 units away
    assert (inst >= 0).mean() > 0.3       # most pixels hit something
    assert (cov >= 0).all() and (cov <= 1.0 + 1e-5).all()
    # normals normalized where hit
    nrm = np.asarray(gb.norm)
    ln = np.linalg.norm(nrm, axis=-1)
    assert np.all(ln[np.asarray(gb.inst_id) >= 0] > 0.9)
