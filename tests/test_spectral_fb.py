"""N-channel spectral framebuffer (-channels > 4, integrator_pt.cpp:642-654)
and multi-channel EXR export (imageutils.cpp spectral 3D EXR)."""
import numpy as np
import pytest

from hydracore3.scene import build as SB
from hydracore3 import render as R
from hydracore3.utils import imageio as IIO

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`

SPECTRAL_SCENE = ('/root/reference/scenes/test_spectral/'
                  'spectral_cornell_conductor.xml')


@pytest.fixture(scope='module')
def spectral_scene():
    return SB.load_scene(SPECTRAL_SCENE, '/root/reference/scenes',
                         width=32, height=24, spectral_mode=True)


def test_nchannel_spectral_fb(spectral_scene):
    scene, meta = spectral_scene
    C = 16
    img = np.asarray(R.render(scene, meta, spp=8, integrator='mispt',
                              channels=C))
    assert img.shape == (24, 32, C)
    assert np.isfinite(img).all()
    band_energy = img.sum((0, 1))
    assert (band_energy > 0).sum() >= C // 2, (
        'hero wavelengths must populate most spectral bands')


def test_multichannel_exr_roundtrip(tmp_path, spectral_scene):
    scene, meta = spectral_scene
    img = np.asarray(R.render(scene, meta, spp=2, integrator='mispt',
                              channels=8))
    p = str(tmp_path / 'spec.exr')
    IIO.save_exr(p, img, 1.0)
    back = IIO.load_exr(p)
    assert back.shape == img.shape
    assert np.allclose(back, img, atol=1e-5)
