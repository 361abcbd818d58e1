"""Lens-stack optics simulator tests (TraceLensesFromFilm,
integrator_pt.cpp:852-938).

Physics-based checks: a biconvex lens has a back focal plane where a point
source on the axis collimates; an aperture stop culls off-axis rays.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`


def _meta_with_lens(lines, phys=(0.036, 0.024)):
    from hydracore3.scene.build import SceneMeta
    return SceneMeta(width=8, height=8, trace_depth=1, spp=1, num_lights=0,
                     num_materials=1, lens_lines=tuple(lines),
                     phys_size=phys)


def _fan_from_film(meta, n=64):
    """Point source at film center shooting a fan at the rear element."""
    import jax.numpy as jnp
    from hydracore3.models import integrator_pt as IPT
    rear_z = meta.lens_lines[0][1]
    rear_r = meta.lens_lines[0][3]
    xs = np.linspace(-0.8, 0.8, n) * rear_r
    pos = np.zeros((n, 3), np.float32)
    to = np.stack([xs, np.zeros(n), np.full(n, rear_z)], -1).astype(np.float32)
    d = to - pos
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return IPT.trace_lenses_from_film(meta, jnp.asarray(pos), jnp.asarray(d))


# biconvex lens, n=1.5, |R|=50mm, 5mm thick, aperture 10mm.
# film->scene order: gap(air) is line 0's thickness.
def _biconvex(gap):
    # line[i].eta is the INCIDENT medium of interface i (the reference
    # refracts with etaI=lines[i].eta, etaT=lines[i+1].eta,
    # integrator_pt.cpp:922-923): air gap first, then glass
    return [
        (-0.05, gap, 1.0, 0.01),     # rear surface (air -> glass)
        (0.05, 0.005, 1.5, 0.01),    # front surface (glass -> air)
    ]


def test_back_focal_plane_collimates():
    """Scanning the film gap, the output fan's angular spread has a sharp
    minimum (the back focal plane) with near-zero spread."""
    spreads = {}
    for gap in np.linspace(0.02, 0.08, 13):
        meta = _meta_with_lens(_biconvex(float(gap)))
        pos, d, ok = _fan_from_film(meta)
        ok = np.asarray(ok)
        if ok.sum() < 10:
            continue
        dn = np.asarray(d)[ok]
        dn = dn / np.linalg.norm(dn, axis=-1, keepdims=True)
        spreads[float(gap)] = float(np.ptp(np.arctan2(dn[:, 0], dn[:, 2])))
    assert spreads, 'no gap produced surviving rays'
    best_gap = min(spreads, key=spreads.get)
    # paraxial focal length of this lens is ~51mm; the minimum must be
    # interior and sharply collimated
    assert 0.02 < best_gap < 0.08
    assert spreads[best_gap] < 0.02
    assert spreads[best_gap] < 0.2 * max(spreads.values())


def test_aperture_stop_culls():
    """A tiny stop between the film and the lens kills off-axis rays."""
    import jax.numpy as jnp
    from hydracore3.models import integrator_pt as IPT
    lines = [(0.0, 0.02, 0.0, 0.0005)] + _biconvex(0.03)
    meta = _meta_with_lens(lines)
    n = 64
    xs = np.linspace(-0.01, 0.01, n)
    pos = np.zeros((n, 3), np.float32)
    to = np.stack([xs, np.zeros(n), np.full(n, 0.02)], -1).astype(np.float32)
    d = to - pos
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _, _, ok = IPT.trace_lenses_from_film(meta, jnp.asarray(pos),
                                          jnp.asarray(d))
    ok = np.asarray(ok)
    assert ok.sum() < n / 4  # off-axis culled by the 0.5mm stop
    assert ok[31] or ok[32]  # near-axis survives


def test_optic_sim_camera_rays():
    """sample_camera_ray with a lens stack produces finite rays and marks
    failed ones as under-the-floor (integrator_pt.cpp:93-97)."""
    import jax.numpy as jnp
    from hydracore3.models import integrator_pt as IPT
    from hydracore3.ops import rng as RNG
    from hydracore3.scene import build as SB
    scene, meta0 = SB.load_scene('/root/reference/scenes/test_035/statex_00001.xml',
                                 width=16, height=16)
    import dataclasses
    meta = dataclasses.replace(meta0, lens_lines=tuple(_biconvex(0.051)),
                               phys_size=(0.036, 0.024))
    pix = jnp.arange(256, dtype=jnp.int32)
    rng = RNG.gen_init(pix)
    state, out_pix = IPT.kernel_init_eye_ray(scene, meta, rng, pix)
    rp = np.asarray(state.ray_pos)
    rd = np.asarray(state.ray_dir)
    assert np.isfinite(rp).all() and np.isfinite(rd).all()
    np.testing.assert_allclose(np.linalg.norm(rd, axis=-1), 1.0, atol=1e-4)
