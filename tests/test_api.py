"""In-process scene-construction API (hydra_api analog, SURVEY.md §2.11).

Builds a Cornell-like box purely from numpy data — no XML authoring — then
commits and renders it through the exact same pipeline as the CLI.
"""
import numpy as np

from hydracore3 import api as HR


def _quad(p0, p1, p2, p3):
    return np.array([p0, p1, p2, p3], np.float32), np.array(
        [0, 1, 2, 0, 2, 3], np.uint32)


def _build_box(ctx):
    white = ctx.material_create(name='white', diffuse_color=(0.5, 0.5, 0.5))
    red = ctx.material_create(name='red', diffuse_color=(0.5, 0.0, 0.0))
    green = ctx.material_create(name='green', diffuse_color=(0.0, 0.5, 0.0))

    s = 4.0
    # floor (+Y normal), ceiling, back wall, left (red), right (green)
    quads = [
        (((-s, -s, -s), (-s, -s, s), (s, -s, s), (s, -s, -s)), white),
        (((-s, s, -s), (s, s, -s), (s, s, s), (-s, s, s)), white),
        (((-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s)), white),
        (((-s, -s, -s), (-s, s, -s), (-s, s, s), (-s, -s, s)), red),
        (((s, -s, -s), (s, -s, s), (s, s, s), (s, s, -s)), green),
    ]
    for pts, mat in quads:
        pos, ind = _quad(*pts)
        mid = ctx.mesh_from_data(pos, ind, mat_indices=[mat, mat])
        ctx.instance_add(mid)

    lmat = np.eye(4, dtype=np.float32)
    lmat[1, 3] = s - 0.05  # just under the ceiling
    ctx.light_area(name='top', color=(1.0, 1.0, 1.0), multiplier=12.0,
                   half_width=1.0, half_length=1.0, matrix=lmat)
    # camera inside the box so the side walls reach the image borders
    ctx.camera_set(pos=(0.0, 0.0, 6.0), look_at=(0.0, 0.0, 0.0),
                   up=(0.0, 1.0, 0.0), fov=45.0)
    ctx.settings_set(width=64, height=48, depth=4, spp=8)


def test_commit_builds_scene(tmp_path):
    ctx = HR.hr2_create_scene()
    _build_box(ctx)
    scene, meta = ctx.commit(str(tmp_path / 'lib'))
    # 5 quads x 2 tris + auto light mesh 2 tris
    assert meta.num_tris == 12
    assert meta.num_lights == 1
    assert meta.width == 64 and meta.height == 48


def test_simple_lights_and_remap_lists(tmp_path):
    """hydra_api surface completion (VERDICT r4 missing #7): point/spot/
    sphere lights and per-instance material remap lists round-trip through
    commit() into the loaded scene."""
    from hydracore3.scene.build import (
        LIGHT_GEOM_POINT, LIGHT_GEOM_SPHERE)
    ctx = HR.hr2_create_scene()
    red = ctx.material_create(name='red', diffuse_color=(0.6, 0.1, 0.1))
    blue = ctx.material_create(name='blue', diffuse_color=(0.1, 0.1, 0.6))
    pos, ind = _quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2))
    mid = ctx.mesh_from_data(pos, ind, mat_indices=[red, red])
    rl = ctx.remap_list_create([(red, blue)])
    ctx.instance_add(mid)                       # red floor
    m2 = np.eye(4, dtype=np.float32)
    m2[0, 3] = 5.0
    ctx.instance_add(mid, m2, rmap_id=rl)       # remapped to blue

    pm = np.eye(4, dtype=np.float32)
    pm[1, 3] = 3.0
    ctx.light_point(color=(1, 1, 1), multiplier=6.0, matrix=pm)
    ctx.light_sphere(color=(1, 0.8, 0.6), multiplier=3.0, radius=0.4,
                     matrix=pm)
    ctx.light_spot(color=(1, 1, 1), multiplier=8.0, falloff_angle=70.0,
                   falloff_angle2=30.0, matrix=pm)
    ctx.camera_set(pos=(0.0, 4.0, 8.0), look_at=(0.0, 0.0, 0.0))
    ctx.settings_set(width=48, height=32, depth=2, spp=4)
    scene, meta = ctx.commit(str(tmp_path / 'lib'))

    assert meta.num_lights == 3
    gts = set(int(g) for g in np.asarray(scene.light_geom_type))
    assert LIGHT_GEOM_POINT in gts and LIGHT_GEOM_SPHERE in gts
    assert meta.has_spot
    # remap list survives: instance 1 maps red -> blue
    assert int(np.asarray(scene.remap_inst)[1, 0]) == rl
    img = np.asarray(ctx.commit_and_render(spp=4, out_dir=str(tmp_path / 'lib')))
    assert np.isfinite(img).all()
    assert img[..., :3].max() > 0.01, 'point/spot/sphere lights light the quad'
    # the remapped instance renders blue-ish, the original red-ish
    left = img[:, :img.shape[1] // 2, :3].reshape(-1, 3)
    lit = left[left.sum(-1) > 0.02]
    assert len(lit) and lit[:, 0].mean() > lit[:, 2].mean(), 'original is red'


def test_commit_and_render(tmp_path):
    ctx = HR.hr2_create_scene()
    _build_box(ctx)
    img = np.asarray(ctx.commit_and_render(spp=8, out_dir=str(tmp_path / 'lib')))
    assert img.shape == (48, 64, 4)
    assert np.isfinite(img).all()
    mid = img[10:38, 10:54, :3]
    assert mid.mean() > 0.01, 'scene should be lit by the area light'
    # red wall on the left, green on the right
    left = img[16:32, 2:8]
    right = img[16:32, 56:62]
    assert left[..., 0].mean() > left[..., 1].mean() * 1.5
    assert right[..., 1].mean() > right[..., 0].mean() * 1.5
