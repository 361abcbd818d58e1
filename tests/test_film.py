"""Thin-film BSDF tests: optics-core physics + end-to-end renders.

The reference has no unit tests here (SURVEY.md §4); these check the film
math against closed forms (plain Fresnel at zero thickness, quarter-wave
antireflection null, energy conservation) and render a Cornell variant
with film materials end-to-end.
"""
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`

CORNELL = '/root/reference/scenes/test_035/statex_00001.xml'


# ---------------------------------------------------------------------------
# optics core (numpy path)
# ---------------------------------------------------------------------------

def test_zero_thickness_film_is_plain_fresnel():
    import jax.numpy as jnp
    from hydracore3.bsdf import film as F
    from hydracore3.bsdf import common as C
    cos_i = np.linspace(0.05, 1.0, 32)
    r, t = F.fr_film(cos_i, 1.0 + 0j, 1.38 + 0j, 1.5 + 0j, 0.0, 550.0, xp=np)
    r_ref = np.array(C.fr_dielectric(jnp.asarray(cos_i), 1.5))
    np.testing.assert_allclose(r, r_ref, atol=1e-5)
    np.testing.assert_allclose(r + t, 1.0, atol=1e-5)


def test_quarter_wave_antireflection_null():
    from hydracore3.bsdf import film as F
    n_f = np.sqrt(1.5)
    thick = 550.0 / (4.0 * n_f)
    r, _ = F.fr_film(np.array([1.0]), 1.0 + 0j, n_f + 0j, 1.5 + 0j,
                     thick, 550.0, xp=np)
    uncoated = ((1.5 - 1.0) / (1.5 + 1.0)) ** 2
    assert r[0] < 1e-6 < uncoated


def test_multilayer_matches_single_layer():
    from hydracore3.bsdf import film as F
    iors = [np.full(8, 1.0 + 0j), np.full(8, 1.38 + 0j), np.full(8, 1.5 + 0j)]
    cos_i = np.linspace(0.1, 1.0, 8)
    rm, tm = F.mult_fr_film(cos_i, iors, [300.0], 550.0, xp=np)
    rs, ts = F.fr_film(cos_i, 1.0 + 0j, 1.38 + 0j, 1.5 + 0j, 300.0, 550.0,
                       xp=np)
    np.testing.assert_allclose(rm, rs, atol=1e-5)
    np.testing.assert_allclose(tm, ts, atol=1e-5)


def test_metal_substrate_film_reflectance_reasonable():
    """Gold-ish substrate under a dielectric film: R in (0,1], T = 0."""
    from hydracore3.bsdf import film as F
    r, t = F.fr_film(np.linspace(0.1, 1.0, 16), 1.0 + 0j, 1.45 + 0j,
                     0.2 + 3.0j, 200.0, 550.0, xp=np)
    assert (r > 0.0).all() and (r <= 1.0 + 1e-5).all()
    np.testing.assert_allclose(t, 0.0, atol=1e-6)


def test_precompute_tables_shapes_and_range():
    from hydracore3.scene import build_film as BF
    from hydracore3.bsdf.film import (FILM_ANGLE_RES, FILM_LENGTH_RES,
                                          FILM_THICKNESS_RES)
    inval = BF.INVALID_ID
    spec_tab = BF.precompute_film_spectral(
        1.0, [1.45, 0.2], [0.0, 3.0], [inval, inval], [inval, inval],
        [300.0], None, None)
    assert spec_tab.shape == (4 * FILM_LENGTH_RES * FILM_ANGLE_RES,)
    assert np.isfinite(spec_tab).all() and (spec_tab >= 0).all()

    rgb_tab = BF.precompute_film_rgb(
        1.0, [1.45, 1.5], [0.0, 0.0], [inval, inval], [inval, inval],
        [300.0], None, None)
    assert rgb_tab.shape == (4 * FILM_ANGLE_RES * 3,)
    assert np.isfinite(rgb_tab).all()

    rgb_tmap = BF.precompute_film_rgb(
        1.0, [1.45, 1.5], [0.0, 0.0], [inval, inval], [inval, inval],
        [300.0], None, None, FILM_THICKNESS_RES, 100.0, 700.0)
    assert rgb_tmap.shape == (4 * FILM_THICKNESS_RES * FILM_ANGLE_RES * 3,)


# ---------------------------------------------------------------------------
# end-to-end
# ---------------------------------------------------------------------------

def _film_scene_xml(tmp_path, transparent):
    """Cornell with one wall turned into a thin-film material.

    Hydra statex files have multiple top-level elements; wrap like
    hydra_xml.HydraScene does, then write the children back."""
    text = open(CORNELL, 'rb').read()
    if text.startswith(b'<?xml'):
        text = text.split(b'?>', 1)[1]
    root = ET.fromstring(b'<hydra_root>' + text + b'</hydra_root>')
    mats = root.find('materials_lib')
    target = None
    for m in mats:
        if m.get('light_id') is None and target is None:
            target = m
    target.clear()
    target.set('id', target.get('id') or '0')
    target.set('name', 'film_test')
    target.set('type', 'thin_film')
    ET.SubElement(target, 'ext_ior', val='1.0')
    ET.SubElement(target, 'transparent', val='1' if transparent else '0')
    layers = ET.SubElement(target, 'layers')
    layer = ET.SubElement(layers, 'layer')
    ET.SubElement(layer, 'thickness', val='300.0')
    ET.SubElement(layer, 'eta', val='1.45')
    ET.SubElement(layer, 'k', val='0.0')
    if transparent:
        ET.SubElement(target, 'eta', val='1.5')
        ET.SubElement(target, 'k', val='0.0')
    else:
        ET.SubElement(target, 'eta', val='0.2')
        ET.SubElement(target, 'k', val='3.0')
    out = os.path.join(tmp_path, 'film_scene.xml')
    # material ids get lost in clear(); restore from position
    for i, m in enumerate(mats):
        if m.get('id') is None:
            m.set('id', str(i))
    with open(out, 'wb') as f:
        for child in root:
            f.write(ET.tostring(child))
    return out


@pytest.mark.parametrize('transparent', [False, True])
def test_film_render_end_to_end(tmp_path, transparent):
    from hydracore3.scene import build as SB
    from hydracore3 import render as R
    from hydracore3.scene.build import MAT_TYPE_THIN_FILM
    path = _film_scene_xml(str(tmp_path), transparent)
    scene, meta = SB.load_scene(path, os.path.dirname(CORNELL),
                                width=32, height=24)
    assert MAT_TYPE_THIN_FILM in meta.mat_types_present
    img = np.asarray(R.render(scene, meta, spp=4, integrator='mispt'))
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0.005


def test_film_render_spectral():
    """Spectral mode: single-layer film, direct Airy path (no tables)."""
    import tempfile
    from hydracore3.scene import build as SB
    from hydracore3 import render as R
    with tempfile.TemporaryDirectory() as td:
        path = _film_scene_xml(td, transparent=False)
        scene, meta = SB.load_scene(path, os.path.dirname(CORNELL),
                                    spectral_mode=True, width=32, height=24)
        img = np.asarray(R.render(scene, meta, spp=4, integrator='mispt'))
        assert np.isfinite(img).all()
        assert img[..., :3].mean() > 0.001


def test_transfer_matrix_vs_recursive_airy():
    """TransferMatrixForward (transfer_matrix.h:46-199) must agree with the
    recursive Airy combination (airy_reflectance.h:102-209) — both compute
    the exact multilayer R/T; sign/phase bugs show up immediately."""
    import numpy as np
    from hydracore3.bsdf import film as F

    rng = np.random.default_rng(1)
    cos_i = np.linspace(0.05, 1.0, 40)
    for lam in (400.0, 550.0, 700.0):
        # 2-layer dielectric stack: air | 1.38 | 2.35 | glass
        iors = [np.full_like(cos_i, 1.0, np.complex128),
                np.full_like(cos_i, 1.38, np.complex128),
                np.full_like(cos_i, 2.35, np.complex128),
                np.full_like(cos_i, 1.52, np.complex128)]
        th = [100.0, 120.0]
        r1, t1 = F.mult_fr_film(cos_i, iors, th, lam, xp=np)
        r2, t2 = F.transfer_matrix_fr(cos_i, iors, th, lam, xp=np)
        np.testing.assert_allclose(r1, r2, atol=1e-4)
        np.testing.assert_allclose(t1, t2, atol=1e-4)

        # absorbing metal film on glass: air | Au-ish | glass
        iors_m = [np.full_like(cos_i, 1.0, np.complex128),
                  np.full_like(cos_i, 0.4 + 2.5j, np.complex128),
                  np.full_like(cos_i, 1.52, np.complex128)]
        r1, t1 = F.mult_fr_film(cos_i, iors_m, [40.0], lam, xp=np)
        r2, t2 = F.transfer_matrix_fr(cos_i, iors_m, [40.0], lam, xp=np)
        np.testing.assert_allclose(r1, r2, atol=1e-4)
        np.testing.assert_allclose(t1, t2, atol=1e-4)

        # 8-layer alternating stack (the reference test-suite case)
        iors8 = [np.full_like(cos_i, 1.0, np.complex128)]
        for i in range(8):
            iors8.append(np.full_like(cos_i, 1.38 if i % 2 == 0 else 2.35,
                                      np.complex128))
        iors8.append(np.full_like(cos_i, 1.52, np.complex128))
        th8 = [90.0 + 10.0 * i for i in range(8)]
        r1, t1 = F.mult_fr_film(cos_i, iors8, th8, lam, xp=np)
        r2, t2 = F.transfer_matrix_fr(cos_i, iors8, th8, lam, xp=np)
        np.testing.assert_allclose(r1, r2, atol=1e-4)
        np.testing.assert_allclose(t1, t2, atol=1e-4)

        # reverse direction (glass side entry)
        r1, t1 = F.mult_fr_film(cos_i, iors8, th8, lam, xp=np, reverse=True)
        r2, t2 = F.transfer_matrix_fr(cos_i, iors8, th8, lam, xp=np,
                                      reverse=True)
        np.testing.assert_allclose(r1, r2, atol=1e-4)
        np.testing.assert_allclose(t1, t2, atol=1e-4)


def test_transfer_matrix_single_layer_vs_fr_film():
    import numpy as np
    from hydracore3.bsdf import film as F
    cos_i = np.linspace(0.05, 1.0, 64)
    eta_i = np.full_like(cos_i, 1.0, np.complex128)
    eta_f = np.full_like(cos_i, 1.45, np.complex128)
    eta_t = np.full_like(cos_i, 1.52, np.complex128)
    r1, t1 = F.fr_film(cos_i, eta_i, eta_f, eta_t, 250.0, 550.0, xp=np)
    r2, t2 = F.transfer_matrix_fr(cos_i, [eta_i, eta_f, eta_t], [250.0],
                                  550.0, xp=np)
    np.testing.assert_allclose(r1, r2, atol=1e-4)
    np.testing.assert_allclose(t1, t2, atol=1e-4)
