"""Spectral textures (KSPEC_SPD_TEX) and measured camera response spectra.

Covers SampleMatColorSpectrumTexture (integrator_spectrum.cpp:127-183):
spectra declared with lambda_ref_ids reference one TEXTURE per wavelength
knot; the shader lerps between the two neighboring textures' texel values.
And SpectralCamRespoceToRGB (integrator_spectrum.cpp:67-125): measured
X/Y/Z response spectra with fallback chain X -> Y -> Z.
"""
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest

from hydracore3.scene import build as SB
from hydracore3.bsdf import dispatch as MAT
from hydracore3 import render as R

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`


def write_image4ub(path, value_rgb):
    """1x1 .image4ub chunk: int32 w,h then RGBA bytes."""
    v = int(round(value_rgb * 255.0))
    with open(path, 'wb') as f:
        f.write(struct.pack('<ii', 1, 1))
        f.write(bytes([v, v, v, 255]))


SCENE_XML = """<?xml version="1.0"?>
<textures_lib>
  <texture id="0" name="d" loc="white.image4ub" offset="8" width="1" height="1"/>
  <texture id="1" name="a" loc="texA.image4ub" offset="8" width="1" height="1"/>
  <texture id="2" name="b" loc="texB.image4ub" offset="8" width="1" height="1"/>
</textures_lib>
<spectra_lib>
  <spectrum id="0" name="spdtex" lambda_ref_ids="400 1 800 2"/>
  <spectrum id="1" name="flat" value="360 2.0 830 2.0"/>
</spectra_lib>
<materials_lib>
  <material id="0" name="white" type="diffuse">
    <bsdf type="lambert"/>
    <reflectance val="1.0"><spectrum id="0" type="ref"/></reflectance>
  </material>
  <material id="1" name="lightmat" type="hydra_material" light_id="0">
    <emission><color val="1 1 1"/></emission>
  </material>
</materials_lib>
<geometry_lib>
  <mesh id="0" name="box" type="vsgf" loc="../data/cornell_open.vsgf" offset="0"/>
</geometry_lib>
<lights_lib>
  <light id="0" type="area" shape="rect" distribution="diffuse">
    <size half_length="0.5" half_width="0.5"/>
    <intensity><color val="1 1 1"/><multiplier val="1"/></intensity>
  </light>
</lights_lib>
<cam_lib>
  <camera id="0" type="uvn">
    <fov>45</fov><nearClipPlane>0.01</nearClipPlane><farClipPlane>100</farClipPlane>
    <position>0 0 10</position><look_at>0 0 0</look_at><up>0 1 0</up>
    <sensor>
      <response type="{rtype}">
        <spectrum id="1"/>
      </response>
    </sensor>
  </camera>
</cam_lib>
<render_lib>
  <render_settings type="HydraModern" id="0">
    <width>16</width><height>16</height><trace_depth>3</trace_depth>
    <spp>1</spp>
  </render_settings>
</render_lib>
<scenes>
  <scene id="0" name="s">
    <instance id="0" mesh_id="0" matrix="1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1"/>
  </scene>
</scenes>
"""


@pytest.fixture(scope='module')
def spd_tex_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp('spdtex')
    write_image4ub(d / 'white.image4ub', 1.0)
    write_image4ub(d / 'texA.image4ub', 0.2)
    write_image4ub(d / 'texB.image4ub', 0.8)
    # mesh path points at the shared cornell mesh
    data = '/root/reference/scenes/data/cornell_open.vsgf'
    xml = SCENE_XML.replace('../data/cornell_open.vsgf', data)
    p = d / 'scene.xml'
    p.write_text(xml.format(rtype='rgb'))
    return str(p)


def test_spectral_texture_fetch(spd_tex_scene):
    scene, meta = SB.load_scene(spd_tex_scene, spectral_mode=True,
                                width=16, height=16)
    assert meta.has_spd_tex and meta.spd_tex_max_sz == 2
    md = MAT.gather_material(scene, jnp.zeros((1,), jnp.int32))
    waves = jnp.array([[400.0, 600.0, 800.0, 360.0]], jnp.float32)
    tc = jnp.array([[0.5, 0.5]], jnp.float32)
    out = np.asarray(MAT.sample_mat_color_spectrum(
        scene, md, waves, MAT.DIFFUSE_COLOR, 0, meta, tc))[0]
    # knots: 400nm -> texA (0.2), 800nm -> texB (0.8); linear between;
    # outside [400, 800] -> 0 (integrator_spectrum.cpp:152-158)
    # spectral textures load with gamma DISABLED (LoadTextureById,
    # integrator_pt_scene_tex.cpp:129-144)
    vA = np.round(0.2 * 255) / 255.0
    vB = np.round(0.8 * 255) / 255.0
    exp_400 = vA
    exp_600 = vA + (600.0 - 400.0) / 400.0 * (vB - vA)
    exp_800 = vB
    np.testing.assert_allclose(out[0], exp_400, rtol=1e-3)
    np.testing.assert_allclose(out[1], exp_600, rtol=1e-3)
    np.testing.assert_allclose(out[2], exp_800, rtol=1e-3)
    assert out[3] == 0.0  # 360nm is outside the knot range


def test_cam_response_spectra(spd_tex_scene):
    scene, meta = SB.load_scene(spd_tex_scene, spectral_mode=True,
                                width=16, height=16)
    assert meta.has_cam_response_spectra
    assert meta.cam_response_type == 1  # rgb
    assert int(scene.cam_response_spec_id[0]) == 1
    # flat response of 2.0 with type rgb: each output channel is
    # sum(spec * 2.0) over the 4 hero lanes
    img = R.render(scene, meta, spp=2, integrator='mispt')
    assert np.isfinite(img).all()
