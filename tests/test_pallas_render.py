"""End-to-end render through the per-ray BVH kernel.

Builds a 5408-triangle scene via the in-process API, routes it to the
kernel (Pallas interpreter on the CPU) and checks the full MIS-PT render
against the same scene forced down the brute-force path — identical sample
streams and triangle order, so images agree to float tolerance.
"""
import dataclasses

import numpy as np
import pytest

from hydracore3 import api as HR
from hydracore3.scene import build as SB
from hydracore3 import render as R

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`


def tessellated_quad(n, y, scale=4.0, flip=False):
    """n x n grid in the XZ plane at height y -> 2*n*n triangles."""
    xs = np.linspace(-scale, scale, n + 1, dtype=np.float32)
    vx, vz = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([vx, np.full_like(vx, y), vz], -1).reshape(-1, 3)
    idx = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            b = a + 1
            c = a + (n + 1)
            d = c + 1
            if flip:
                idx += [[a, b, c], [b, d, c]]
            else:
                idx += [[a, c, b], [b, c, d]]
    return pos, np.array(idx, np.int32).reshape(-1)


@pytest.fixture(scope='module')
def big_scene(tmp_path_factory):
    hr = HR.hr2_create_scene()
    white = hr.material_create(name='white', diffuse_color=(0.7, 0.7, 0.7))
    # floor: 52x52 grid = 5408 triangles
    pos, idx = tessellated_quad(52, 0.0)
    floor = hr.mesh_from_data(pos, idx,
                              mat_indices=np.full(len(idx) // 3, white))
    hr.instance_add(floor)
    lmat = np.eye(4, dtype=np.float32)
    lmat[1, 3] = 6.0
    hr.light_area(color=(1, 1, 1), multiplier=8.0, half_width=1.0,
                  half_length=1.0, matrix=lmat)
    hr.camera_set(pos=(0, 5, 9), look_at=(0, 0, 0), up=(0, 1, 0), fov=45)
    hr.settings_set(width=64, height=48, depth=3, spp=1)
    out = str(tmp_path_factory.mktemp('kernel_scene'))
    hr.commit(out_dir=out)
    import os
    return os.path.join(out, 'statex_00001.xml')


def test_pallas_render_matches_brute(big_scene):
    scene, meta = SB.load_scene(big_scene, width=64, height=48,
                                accel='kernel')
    assert meta.use_kernel, 'scene should select the kernel path'
    meta = dataclasses.replace(meta, kernel_interpret=True)
    img_p = R.render(scene, meta, spp=4, integrator='mispt')

    meta_b = dataclasses.replace(meta, use_kernel=False, use_bvh=False)
    img_b = R.render(scene, meta_b, spp=4, integrator='mispt')

    # same soup order and same RNG streams: only the nearest-hit reduction
    # order differs
    mse = float(np.mean((img_p - img_b) ** 2))
    assert mse < 1e-6, mse
    assert np.isfinite(img_p).all()
    assert float(img_p.max()) > 0
