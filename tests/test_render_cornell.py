"""End-to-end render tests on the in-repo Cornell scene (test_035).

The reference's own smoke scenes (SURVEY.md §4) drive these: the render must
produce a plausible Cornell image and the three integrators must estimate
the same integral (cross-estimator consistency replaces golden images until
reference goldens are generated).
"""
import numpy as np
import pytest

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`


@pytest.fixture(scope='module')
def small_render(cornell_scene):
    from hydracore3 import render as R
    scene, meta = cornell_scene
    img = R.render(scene, meta, spp=8, integrator='mispt')
    return np.asarray(img)


def test_image_nonzero_finite(small_render):
    img = small_render
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0.01
    assert img[..., :3].max() > 0.2


def test_light_region_bright(small_render):
    """The area light (top of the box, bottom rows in buffer order) must be
    the brightest region."""
    img = small_render[..., :3].mean(-1)
    h = img.shape[0]
    assert img.max() > 5.0  # light intensity is ~25


def test_walls_colored(small_render):
    """Left wall red-ish, right wall green-ish (Cornell box materials)."""
    img = small_render
    h, w = img.shape[:2]
    left = img[h // 3:2 * h // 3, w // 8:w // 5, :3].mean((0, 1))
    right = img[h // 3:2 * h // 3, -w // 5:-w // 8, :3].mean((0, 1))
    assert left[0] > left[1] * 1.5, left
    assert right[1] > right[0] * 1.5, right


def test_mis_vs_shadow_consistency(cornell_scene):
    """Different estimators, same integral: images must agree (PSNR)."""
    from hydracore3 import render as R
    from hydracore3.utils.imageio import psnr
    from conftest import box_downsample
    scene, meta = cornell_scene
    a = np.asarray(R.render(scene, meta, spp=24, integrator='mispt'))
    b = np.asarray(R.render(scene, meta, spp=24, integrator='shadowpt'))
    # box-downsample 4x4 before PSNR: averages MC noise (~16x variance
    # reduction) so a 24-spp CPU run compares like a ~384-spp one
    la = np.clip(box_downsample(a[..., :3]), 0, 1) ** (1 / 2.2) * 255
    lb = np.clip(box_downsample(b[..., :3]), 0, 1) ** (1 / 2.2) * 255
    val = psnr(la, lb)
    assert val > 28.0, val


def test_rng_advances_across_passes(cornell_scene):
    """Two 1-spp renders accumulated must differ from one 1-spp render
    (passes must not repeat the sample sequence)."""
    from hydracore3 import render as R
    scene, meta = cornell_scene
    img1 = np.asarray(R.render(scene, meta, spp=1))
    img2 = np.asarray(R.render(scene, meta, spp=2))
    assert np.abs(img1 - img2).max() > 1e-4
