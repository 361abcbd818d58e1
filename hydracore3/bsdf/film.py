"""Thin-film BSDF: Airy single-layer + multi-layer recursive interference.

The batched JAX take on the reference's thin-film subsystem
(include/cmat_film.h, include/airy_reflectance.h, include/transfer_matrix.h):

* The *optics core* (complex Fresnel, phase accumulation, single-layer Airy
  summation, multi-layer recursive combination — airy_reflectance.h:9-209)
  is written once over an ``xp`` array module so the same code runs in
  numpy at scene build (table precompute, integrator_pt_scene_mat.cpp:
  791-1018) and in JAX at trace time (direct spectral path).
* At trace time everything is batched over the ray dimension; the
  reference's per-material scalar branches (precomputed-vs-direct,
  smooth-vs-rough, transparent-vs-metal substrate) become masked selects.
* Precomputed reflectance/transmittance tables are gathered with bilinear
  interpolation exactly like filmSmoothSampleAndEval (cmat_film.h:41-143);
  the table layout is [4 sections][...] with sections
  (ext_refl, ext_refr, int_refl, int_refr).

Wavelength convention: in spectral mode only hero lane 0 carries film
energy and RAY_FLAG_WAVES_DIVERGED is raised (integrator_pt_mat.cpp:248);
in RGB mode R/T are 3-vectors from CIE-converted tables.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.lmath import dot, normalize, coordinate_system_v2
from . import common as C

POL_S = 0
POL_P = 1

# table resolutions (cglobals.h:19-21)
FILM_ANGLE_RES = 180
FILM_LENGTH_RES = 94
FILM_THICKNESS_RES = 32

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0


# ---------------------------------------------------------------------------
# Optics core (xp = numpy at build time, jnp at trace time)
# ---------------------------------------------------------------------------

def _cnorm(z):
    """std::norm: squared magnitude."""
    return z.real * z.real + z.imag * z.imag


def fr_complex_refl(cos_i, cos_t, ior_i, ior_t, pol, xp=jnp):
    """Complex amplitude reflectance (cmaterial.h:995-1010)."""
    if pol == POL_S:
        num, den = ior_i * cos_i - ior_t * cos_t, ior_i * cos_i + ior_t * cos_t
    else:
        num, den = ior_t * cos_i - ior_i * cos_t, ior_t * cos_i + ior_i * cos_t
    r = num / den
    grazing = _cnorm(cos_i) < 1e-6
    return xp.where(grazing, xp.asarray(-1.0 + 0.0j, dtype=r.dtype), r)


def fr_complex_refr(cos_i, cos_t, ior_i, ior_t, pol, xp=jnp):
    """Complex amplitude transmittance (cmaterial.h:1012-1031)."""
    if pol == POL_S:
        den = ior_i * cos_i + ior_t * cos_t
    else:
        den = ior_t * cos_i + ior_i * cos_t
    t = (2.0 * ior_i * cos_i) / den
    grazing = _cnorm(cos_i) < 1e-6
    match = _cnorm(ior_i - ior_t) < 1e-6
    lim = xp.where(match, xp.asarray(1.0 + 0.0j, dtype=t.dtype),
                   xp.asarray(0.0 + 0.0j, dtype=t.dtype))
    return xp.where(grazing, lim, t)


def film_phase_diff(cos_theta, eta, thickness, lam):
    """Optical phase over one film layer (cmaterial.h:1033-1036)."""
    return 4.0 * np.pi * eta * cos_theta * thickness / lam


def refraction_factor(cos_i, cos_t, ior_i, ior_t, xp=jnp):
    """Radiance scaling across an interface (cmaterial.h:967-975).

    cos_i is real; cos_t/iors complex.
    """
    mult = cos_t * ior_t
    bad = (cos_i <= 1e-6) | (mult.imag > 1e-6)
    return xp.where(bad, 0.0, mult.real / (ior_i.real * cos_i))


def fr_film(cos_theta_i, eta_i, eta_f, eta_t, thickness, lam, xp=jnp):
    """Single-layer Airy reflectance/transmittance (airy_reflectance.h:62-100).

    All args broadcastable; cos_theta_i real, etas complex.
    Returns (refl, refr) real arrays.
    """
    cdt = xp.result_type(eta_f, xp.complex64)
    cos_theta_i = xp.asarray(cos_theta_i)
    sin2_i = (1.0 - cos_theta_i * cos_theta_i).astype(cdt)
    eta_i = xp.asarray(eta_i, dtype=cdt)
    eta_f = xp.asarray(eta_f, dtype=cdt)
    eta_t = xp.asarray(eta_t, dtype=cdt)
    sin2_f = sin2_i * (eta_i.real * eta_i.real) / (eta_f * eta_f)
    cos_f = xp.sqrt((1.0 - sin2_f).astype(cdt))
    sin2_t = sin2_i * (eta_i.real * eta_i.real) / (eta_t * eta_t)
    cos_t = xp.sqrt((1.0 - sin2_t).astype(cdt))

    phase = film_phase_diff(cos_f, eta_f, thickness, lam)
    exp_1 = xp.exp(-phase.imag / 2.0) * (xp.cos(phase.real / 2.0)
                                         + 1j * xp.sin(phase.real / 2.0))
    exp_2 = exp_1 * exp_1

    refl = 0.0
    refr = 0.0
    for pol in (POL_S, POL_P):
        r_i = fr_complex_refl(cos_theta_i.astype(cdt), cos_f, eta_i, eta_f, pol, xp)
        r_f = fr_complex_refl(cos_f, cos_t, eta_f, eta_t, pol, xp)
        t_i = fr_complex_refr(cos_theta_i.astype(cdt), cos_f, eta_i, eta_f, pol, xp)
        t_f = fr_complex_refr(cos_f, cos_t, eta_f, eta_t, pol, xp)
        denom = 1.0 + r_i * r_f * exp_2
        sing = _cnorm(denom) < 1e-6
        denom_safe = xp.where(sing, xp.asarray(1.0 + 0.0j, dtype=cdt), denom)
        refl = refl + xp.where(sing, 0.5,
                               _cnorm((r_i + r_f * exp_2) / denom_safe) / 2.0)
        refr = refr + xp.where(sing, 0.0,
                               _cnorm(t_i * t_f * exp_1 / denom_safe) / 2.0)
    refr = refr * refraction_factor(cos_theta_i, cos_t, eta_i, eta_t, xp)
    return refl, refr


def mult_fr_film(cos_theta_i, iors, thicknesses, lam, xp=np, reverse=False):
    """Multi-layer recursive Airy combination (airy_reflectance.h:102-209).

    iors: list of ``layers+1`` complex arrays (external medium first,
    substrate last); thicknesses: list of ``layers-1`` floats. ``reverse``
    gives the light path entering from the substrate side (multFrFilm_r).
    Static layer count — build-time only in practice (numpy), but xp-generic.
    Returns (refl, refr).
    """
    layers = len(iors) - 1
    cdt = np.complex128 if xp is np else xp.complex64
    cos_theta_i = xp.asarray(cos_theta_i)
    sin2_i = 1.0 - cos_theta_i * cos_theta_i

    if reverse:
        iors = list(reversed(iors))
        thicknesses = list(reversed(thicknesses))

    head = xp.asarray(iors[0], dtype=cdt)
    cos_theta = [cos_theta_i.astype(cdt)]
    phase = []
    for i in range(1, layers + 1):
        eta = xp.asarray(iors[i], dtype=cdt)
        sin2 = sin2_i * head.real * head.real / (eta * eta)
        ct = xp.sqrt((1.0 - sin2).astype(cdt))
        cos_theta.append(ct)
        if i < layers:
            phase.append(film_phase_diff(ct, eta, thicknesses[i - 1], lam))

    def combine(pol):
        # calculateMultFrFilmForward (airy_reflectance.h:102-129)
        r = fr_complex_refl(cos_theta[layers - 1], cos_theta[layers],
                            xp.asarray(iors[layers - 1], cdt),
                            xp.asarray(iors[layers], cdt), pol, xp)
        t = fr_complex_refr(cos_theta[layers - 1], cos_theta[layers],
                            xp.asarray(iors[layers - 1], cdt),
                            xp.asarray(iors[layers], cdt), pol, xp)
        for i in range(layers - 2, -1, -1):
            r_i = fr_complex_refl(cos_theta[i], cos_theta[i + 1],
                                  xp.asarray(iors[i], cdt),
                                  xp.asarray(iors[i + 1], cdt), pol, xp)
            t_i = fr_complex_refr(cos_theta[i], cos_theta[i + 1],
                                  xp.asarray(iors[i], cdt),
                                  xp.asarray(iors[i + 1], cdt), pol, xp)
            exp_1 = xp.exp(-phase[i].imag / 2.0) * (xp.cos(phase[i].real / 2.0)
                                                    + 1j * xp.sin(phase[i].real / 2.0))
            t = t_i * t * exp_1
            r = r * exp_1 * exp_1
            denom = 1.0 + r_i * r
            sing = _cnorm(denom) < 1e-6
            denom_safe = xp.where(sing, xp.asarray(1.0 + 0.0j, cdt), denom)
            t = xp.where(sing, xp.asarray(0.0 + 0.0j, cdt), t / denom_safe)
            r = xp.where(sing, xp.asarray(1.0 + 0.0j, cdt), (r_i + r) / denom_safe)
        return _cnorm(r), _cnorm(t)

    refl_s, refr_s = combine(POL_S)
    refl_p, refr_p = combine(POL_P)
    refl = (refl_s + refl_p) / 2.0
    refr = (refr_s + refr_p) / 2.0
    refr = refr * refraction_factor(cos_theta_i, cos_theta[layers],
                                    xp.asarray(iors[0], cdt),
                                    xp.asarray(iors[layers], cdt), xp)
    return refl, refr


def transfer_matrix_fr(cos_theta_i, iors, thicknesses, lam, xp=np,
                       reverse=False):
    """N-layer film via 2x2 complex transfer matrices per polarization
    (TransferMatrixForward/Backward, transfer_matrix.h:46-199).

    Same signature/convention as ``mult_fr_film`` (iors: layers+1 entries,
    external medium first; thicknesses: layers-1). The reference factors
    the per-interface 1/t out of the matrix into a running ``coeff`` and
    normalizes the propagation matrix by max(|phi|, 1/|phi|) to avoid
    overflow for absorbing layers; reproduced exactly.  Returns (R, T).
    """
    layers = len(iors) - 1
    cdt = np.complex128 if xp is np else xp.complex64
    cos_theta_i = xp.asarray(cos_theta_i)

    if reverse:
        iors = list(reversed(iors))
        thicknesses = list(reversed(thicknesses))
    iors = [xp.asarray(e, dtype=cdt) for e in iors]

    sin2_i = (1.0 - cos_theta_i * cos_theta_i).astype(cdt)
    head2 = iors[0].real * iors[0].real

    def prop_split(phase_exp):
        """(P00, P11, prop_coeff) of the normalized propagation matrix."""
        n = _cnorm(phase_exp)
        one = xp.asarray(1.0 + 0.0j, cdt)
        p00 = xp.where(n > 1.0, one / (phase_exp * phase_exp), one)
        p11 = xp.where(n > 1.0, one, phase_exp * phase_exp)
        big = xp.asarray(1e6 + 0.0j, cdt)
        coeff = xp.where(n > 1.0, xp.where(n > 1e6, big, phase_exp),
                         xp.where(n < 1e-6, big, one / phase_exp))
        return p00, p11, coeff

    def run(pol):
        sin2_f = sin2_i * head2 / (iors[1] * iors[1])
        cos_f = xp.sqrt((1.0 - sin2_f).astype(cdt))
        ci = cos_theta_i.astype(cdt)
        r = fr_complex_refl(ci, cos_f, iors[0], iors[1], pol, xp)
        t = fr_complex_refr(ci, cos_f, iors[0], iors[1], pol, xp)
        # M = D(r); coeff accumulates the interface transmittances
        m00, m01, m10, m11 = (xp.ones_like(r), r, r, xp.ones_like(r))
        coeff = t

        phase = film_phase_diff(cos_f, iors[1], thicknesses[0], lam) / 2.0
        pe = xp.exp(-phase.imag) * (xp.cos(phase.real) + 1j * xp.sin(phase.real))
        p00, p11, pc = prop_split(pe)
        m00, m01, m10, m11 = m00 * p00, m01 * p11, m10 * p00, m11 * p11
        coeff = coeff / pc

        cos_prev = cos_f
        for i in range(1, layers):
            sin2_t = sin2_i * head2 / (iors[i + 1] * iors[i + 1])
            cos_t = xp.sqrt((1.0 - sin2_t).astype(cdt))
            r = fr_complex_refl(cos_prev, cos_t, iors[i], iors[i + 1], pol, xp)
            t = fr_complex_refr(cos_prev, cos_t, iors[i], iors[i + 1], pol, xp)
            # M = M * D(r)
            n00 = m00 + m01 * r
            n01 = m00 * r + m01
            n10 = m10 + m11 * r
            n11 = m10 * r + m11
            m00, m01, m10, m11 = n00, n01, n10, n11
            coeff = coeff * t
            if i < layers - 1:
                phase = film_phase_diff(cos_t, iors[i + 1],
                                        thicknesses[i], lam) / 2.0
                pe = (xp.exp(-phase.imag)
                      * (xp.cos(phase.real) + 1j * xp.sin(phase.real)))
                p00, p11, pc = prop_split(pe)
                m00, m01, m10, m11 = m00 * p00, m01 * p11, m10 * p00, m11 * p11
                coeff = coeff / pc
            cos_prev = cos_t
        R = _cnorm(m10 / m00)
        T = _cnorm(coeff / m00)
        return R, T, cos_prev

    r_p, t_p, cos_last = run(POL_P)
    r_s, t_s, _ = run(POL_S)
    refl = (r_p + r_s) / 2.0
    # per-polarization factors (cmaterial.h:977-993): S uses Re(n·cos),
    # P uses Re(n·conj(cos))
    ci = cos_theta_i.astype(cdt)
    bad = _cnorm(ci) <= 1e-6
    n0, nl = iors[0], iors[layers]
    fac_s = xp.where(bad, 0.0, (nl * cos_last).real / (n0 * ci).real)
    fac_p = xp.where(bad, 0.0, (nl * xp.conj(cos_last)).real
                     / (n0 * xp.conj(ci)).real)
    refr = (t_p * fac_p + t_s * fac_s) / 2.0
    return refl, refr


# ---------------------------------------------------------------------------
# Trace-time table fetch (cmat_film.h bilinear lookups)
# ---------------------------------------------------------------------------

def _bilerp_flat(table, offset, sec, i1_f, n1, i2_f, n2, stride=1, chan=0):
    """Bilinear fetch from flat ``table`` at [sec][i1][i2] with section layout
    [4, n1, n2, stride]. i1_f/i2_f are continuous grid coords."""
    i1 = jnp.minimum(i1_f.astype(jnp.int32), n1 - 2)
    i2 = jnp.minimum(i2_f.astype(jnp.int32), n2 - 2)
    a = i1_f - i1.astype(jnp.float32)
    b = i2_f - i2.astype(jnp.float32)
    base = offset + (sec * n1 * n2) * stride + chan

    def at(di, dj):
        idx = base + ((i1 + di) * n2 + (i2 + dj)) * stride
        return table[jnp.clip(idx, 0, table.shape[0] - 1)]

    v0 = at(0, 0) * (1 - a) + at(1, 0) * a
    v1 = at(0, 1) * (1 - a) + at(1, 1) * a
    return v0 * (1 - b) + v1 * b


def _theta_coord(cos_theta_i):
    t = jnp.clip(jnp.arccos(jnp.clip(cos_theta_i, -1.0, 1.0)) * 2.0 / jnp.pi,
                 0.0, 1.0)
    return t * (FILM_ANGLE_RES - 1)


def _fetch_tables_spectral(precomp, offset, lam0, cos_theta_i, reversed_):
    """Spectral [4, L, A] table fetch (cmat_film.h:43-62)."""
    w = jnp.clip((lam0 - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN), 0.0, 1.0)
    w = w * (FILM_LENGTH_RES - 1)
    th = _theta_coord(cos_theta_i)
    sec_r = jnp.where(reversed_, 2, 0)
    sec_t = sec_r + 1
    r = _bilerp_flat(precomp, offset, sec_r, w, FILM_LENGTH_RES, th,
                     FILM_ANGLE_RES)
    t = _bilerp_flat(precomp, offset, sec_t, w, FILM_LENGTH_RES, th,
                     FILM_ANGLE_RES)
    zeros = jnp.zeros(r.shape + (3,), r.dtype)
    return (jnp.concatenate([r[..., None], zeros], -1),
            jnp.concatenate([t[..., None], zeros], -1))


def _fetch_tables_rgb(precomp, offset, cos_theta_i, reversed_, has_tmap,
                      thickness, t_min, t_max):
    """RGB [4, T, A, 3] table fetch (cmat_film.h:81-142); T=1 without a
    thickness map."""
    th = _theta_coord(cos_theta_i)
    sec_r = jnp.where(reversed_, 2, 0)
    sec_t = sec_r + 1

    tt = jnp.clip((thickness - t_min) / jnp.maximum(t_max - t_min, 1e-9),
                  0.0, 1.0) * (FILM_THICKNESS_RES - 1)

    def fetch(sec, chan):
        with_map = _bilerp_flat(precomp, offset, sec, tt, FILM_THICKNESS_RES,
                                th, FILM_ANGLE_RES, stride=3, chan=chan)
        # T=1: pure 1-D lerp over theta
        i2 = jnp.minimum(th.astype(jnp.int32), FILM_ANGLE_RES - 2)
        b = th - i2.astype(jnp.float32)
        base = offset + sec * FILM_ANGLE_RES * 3 + chan
        v0 = precomp[jnp.clip(base + i2 * 3, 0, precomp.shape[0] - 1)]
        v1 = precomp[jnp.clip(base + (i2 + 1) * 3, 0, precomp.shape[0] - 1)]
        no_map = v0 * (1 - b) + v1 * b
        return jnp.where(has_tmap, with_map, no_map)

    r = jnp.stack([fetch(sec_r, c) for c in range(3)], -1)
    t = jnp.stack([fetch(sec_t, c) for c in range(3)], -1)
    pad = jnp.zeros(r.shape[:-1] + (1,), r.dtype)
    return jnp.concatenate([r, pad], -1), jnp.concatenate([t, pad], -1)


# ---------------------------------------------------------------------------
# Material data slots (cmaterial.h:160-180)
# ---------------------------------------------------------------------------

FILM_ROUGH_U = 0
FILM_ROUGH_V = 1
FILM_PRECOMP_FLAG = 2
FILM_PRECOMP_OFFSET = 3
FILM_ETA_OFFSET = 4
FILM_K_OFFSET = 5
FILM_ETA_SPECID_OFFSET = 6
FILM_K_SPECID_OFFSET = 7
FILM_ETA_EXT = 8
FILM_THICKNESS_OFFSET = 9
FILM_THICKNESS_MIN = 10
FILM_THICKNESS_MAX = 11
FILM_THICKNESS_MAP = 12
FILM_THICKNESS = 13
FILM_LAYERS_COUNT = 14
FILM_TRANSPARENT = 15


def _sample_films_spectrum(scene, md, lam0, param_slot, specid_slot, layer):
    """SampleFilmsSpectrum (integrator_spectrum.cpp:46-65), lane 0 only.

    layer: int32 array (per-ray)."""
    idx_p = md['data'][..., param_slot].astype(jnp.int32) + layer
    res = scene.films_eta_k[jnp.clip(idx_p, 0, scene.films_eta_k.shape[0] - 1)]
    idx_s = md['data'][..., specid_slot].astype(jnp.int32) + layer
    spec_id = scene.films_spec_id[jnp.clip(idx_s, 0,
                                           scene.films_spec_id.shape[0] - 1)]
    has_spd = spec_id >= 0
    offset = scene.spec_offset_sz[jnp.clip(spec_id, 0,
                                           scene.spec_offset_sz.shape[0] - 1), 0]
    from ..ops import spectrum as SPEC
    sampled = SPEC.sample_uniform_spectrum(scene.spec_values, offset,
                                           lam0[..., None])[..., 0]
    return jnp.where(has_spd, sampled, res)


def _film_rt(scene, md, cos_theta_i, lam0, spectral_mode, reversed_,
             thickness, ext_ior, film_ior, int_ior):
    """R/T [N,4] for the incident cosine, via tables or direct Airy."""
    precomp = md['data'][..., FILM_PRECOMP_FLAG] > 0.5
    offset = md['data'][..., FILM_PRECOMP_OFFSET].astype(jnp.int32)
    has_tmap = md['data'][..., FILM_THICKNESS_MAP] > 0.5

    if spectral_mode:
        r_tab, t_tab = _fetch_tables_spectral(scene.precomp_films, offset,
                                              lam0, cos_theta_i, reversed_)
        # direct single-layer Airy for the non-precomputed path
        eta_i = jnp.where(reversed_, int_ior, ext_ior.astype(jnp.complex64))
        eta_t = jnp.where(reversed_, ext_ior.astype(jnp.complex64), int_ior)
        r_d, t_d = fr_film(cos_theta_i, eta_i, film_ior, eta_t, thickness,
                           lam0, xp=jnp)
        zeros = jnp.zeros(r_d.shape + (3,), jnp.float32)
        r_dir = jnp.concatenate([r_d[..., None].astype(jnp.float32), zeros], -1)
        t_dir = jnp.concatenate([t_d[..., None].astype(jnp.float32), zeros], -1)
        R = jnp.where(precomp[..., None], r_tab, r_dir)
        T = jnp.where(precomp[..., None], t_tab, t_dir)
    else:
        # RGB mode is always precomputed (LoadThinFilmMaterial:1148)
        R, T = _fetch_tables_rgb(scene.precomp_films, offset, cos_theta_i,
                                 reversed_, has_tmap, thickness,
                                 md['data'][..., FILM_THICKNESS_MIN],
                                 md['data'][..., FILM_THICKNESS_MAX])
    return R, T


def _film_inputs(scene, md, wavelengths, tc, spectral_mode, tex_pool):
    """Common per-ray film parameters (integrator_pt_mat.cpp:197-237)."""
    from ..ops import texture as TEX
    from ..utils.lmath import mul_rows_2x4

    layers = md['data'][..., FILM_LAYERS_COUNT].astype(jnp.int32)
    lam0 = wavelengths[..., 0] if spectral_mode else jnp.full(
        md['data'].shape[:-1], 525.0, jnp.float32)
    ext_ior = md['data'][..., FILM_ETA_EXT]
    int_eta = _sample_films_spectrum(scene, md, lam0, FILM_ETA_OFFSET,
                                     FILM_ETA_SPECID_OFFSET, layers - 1)
    int_k = _sample_films_spectrum(scene, md, lam0, FILM_K_OFFSET,
                                   FILM_K_SPECID_OFFSET, layers - 1)
    zero_l = jnp.zeros_like(layers)
    film_eta = _sample_films_spectrum(scene, md, lam0, FILM_ETA_OFFSET,
                                      FILM_ETA_SPECID_OFFSET, zero_l)
    film_k = _sample_films_spectrum(scene, md, lam0, FILM_K_OFFSET,
                                    FILM_K_SPECID_OFFSET, zero_l)
    int_ior = int_eta + 1j * int_k
    film_ior = film_eta + 1j * film_k

    has_tmap = md['data'][..., FILM_THICKNESS_MAP] > 0.5
    tc_t = mul_rows_2x4(md['row0'][..., 2, :], md['row1'][..., 2, :], tc)
    texid = md['texid'][..., 2]
    bad = (texid < 0) | (texid >= tex_pool.offset.shape[0])
    tval = TEX.sample(tex_pool, jnp.where(bad, 0, texid), tc_t)[..., 0]
    t_min = md['data'][..., FILM_THICKNESS_MIN]
    t_max = md['data'][..., FILM_THICKNESS_MAX]
    thickness = jnp.where(has_tmap, (t_max - t_min) * tval + t_min,
                          md['data'][..., FILM_THICKNESS])
    return lam0, ext_ior, film_ior, int_ior, thickness


def sample_and_eval(scene, md, wavelengths, rands, v, n_in, tc, mis_ior,
                    ray_flags, spectral_mode, tex_pool, alpha_tex):
    """filmSmooth/RoughSampleAndEval (cmat_film.h:9-410), batched.

    Returns the standard sample dict; caller ORs RAY_FLAG_WAVES_DIVERGED.
    """
    N = v.shape[0]
    lam0, ext_ior, film_ior, int_ior, thickness = _film_inputs(
        scene, md, wavelengths, tc, spectral_mode, tex_pool)

    transparent = md['data'][..., FILM_TRANSPARENT] > 0.5
    metal_sub = int_ior.imag > 0.001

    # un-flip the normal back to geometric orientation (cmat_film.h:17-20)
    inv = (ray_flags & jnp.uint32(C.RAY_FLAG_HAS_INV_NORMAL)) != 0
    n = jnp.where(inv[..., None], -n_in, n_in)

    reversed_ = (dot(n, v) < 0.0) & ~metal_sub

    s_ax, t_ax = coordinate_system_v2(n)
    wi = jnp.stack([dot(v, s_ax), dot(v, t_ax), dot(v, n)], -1)
    ior_ratio = int_ior.real / jnp.maximum(ext_ior, 1e-6)

    alpha = jnp.stack([
        jnp.minimum(md['data'][..., FILM_ROUGH_V], alpha_tex[..., 0]),
        jnp.minimum(md['data'][..., FILM_ROUGH_U], alpha_tex[..., 1])], -1)
    smooth = C.tr_effectively_smooth(alpha)

    # ======================= smooth path (cmat_film.h:9-181) ===============
    cos_i_s = jnp.clip(jnp.abs(wi[..., 2]), 1e-4, 1.0)
    R_s, T_s = _film_rt(scene, md, cos_i_s, lam0, spectral_mode, reversed_,
                        thickness, ext_ior, film_ior, int_ior)
    sum_r = jnp.sum(R_s, -1)
    sum_t = jnp.sum(T_s, -1)
    mirror_only = metal_sub | ~transparent
    pick_refl = mirror_only | (rands[..., 0] * (sum_r + sum_t) < sum_r)

    wo_refl = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    _fr_r, cos_t_t, _eta_it_s, eta_ti = C.fr_dielectric_detailed_v2(
        wi[..., 2], ior_ratio)
    wo_refr = C.refract_local(wi, cos_t_t, eta_ti)
    wo_s = jnp.where(pick_refl[..., None], wo_refl, wo_refr)
    dir_s = normalize(wo_s[..., 0:1] * s_ax + wo_s[..., 1:2] * t_ax
                      + wo_s[..., 2:3] * n)
    pdf_s = jnp.where(mirror_only, 1.0,
                      jnp.where(pick_refl,
                                sum_r / jnp.maximum(sum_r + sum_t, 1e-20),
                                sum_t / jnp.maximum(sum_r + sum_t, 1e-20)))
    val_s = jnp.where(pick_refl[..., None], R_s, T_s)
    val_s = val_s / jnp.maximum(jnp.abs(dot(dir_s, n)), 1e-6)[..., None]
    flags_s = jnp.where(pick_refl, jnp.uint32(C.RAY_EVENT_S),
                        jnp.uint32(C.RAY_EVENT_S | C.RAY_EVENT_T))
    ior_keep = mis_ior
    ior_cross = jnp.where(jnp.abs(mis_ior - int_ior.real) < 1e-6, ext_ior,
                          int_ior.real)
    ior_s = jnp.where(pick_refl, ior_keep, ior_cross)

    # ======================= rough path (cmat_film.h:183-410) ==============
    wi_r = jnp.where(reversed_[..., None], -wi, wi)
    ior_r = jnp.where(reversed_, 1.0 / ior_ratio, ior_ratio)
    wm = C.tr_sample(wi_r, rands[..., :2], alpha)
    cos_i_r = jnp.clip(jnp.abs(dot(wi_r, wm)), 1e-5, 1.0)
    R_r, T_r = _film_rt(scene, md, cos_i_r, lam0, spectral_mode, reversed_,
                        thickness, ext_ior, film_ior, int_ior)
    sum_rr = jnp.sum(R_r, -1)
    sum_tr = jnp.sum(T_r, -1)
    pick_refl_r = mirror_only | (rands[..., 3] * (sum_rr + sum_tr) < sum_rr)

    # reflection branch
    wo_rr = -wi_r + 2.0 * dot(wi_r, wm)[..., None] * wm  # reflect about wm
    bad_refl = (wi_r[..., 2] < 0.0) | (wo_rr[..., 2] <= 0.0)
    cti = jnp.maximum(wi_r[..., 2], 1e-6)
    cto = jnp.maximum(wo_rr[..., 2], 1e-6)
    pdf_refl = (C.tr_pdf(wi_r, wm, alpha)
                / jnp.maximum(4.0 * jnp.abs(dot(wi_r, wm)), 1e-20))
    pdf_refl = jnp.where(mirror_only, pdf_refl,
                         pdf_refl * sum_rr / jnp.maximum(sum_rr + sum_tr, 1e-20))
    val_refl = R_r * (C.tr_d(wm, alpha) * C.microfacet_g(wi_r, wo_rr, wm, alpha)
                      / (4.0 * cti * cto))[..., None]

    # transmission branch (metal/opaque never reaches it)
    _fr_rr, cos_t_r, eta_it, eta_ti_r = C.fr_dielectric_detailed_v2(
        dot(wi_r, wm), ior_r)
    ws, wt = coordinate_system_v2(wm)
    local_wi = jnp.stack([dot(ws, wi_r), dot(wt, wi_r), dot(wm, wi_r)], -1)
    local_wo = C.refract_local(local_wi, cos_t_r, eta_ti_r)
    wo_tr = (local_wo[..., 0:1] * ws + local_wo[..., 1:2] * wt
             + local_wo[..., 2:3] * wm)
    bad_tr = wo_tr[..., 2] > 0.0
    cto_t = jnp.minimum(wo_tr[..., 2], -1e-6)
    index_matched = jnp.abs(eta_it - 1.0) <= 1e-6
    denom_t = (dot(wo_tr, wm) + dot(wi_r, wm) / jnp.where(
        jnp.abs(eta_it) < 1e-9, 1e-9, eta_it)) ** 2
    dwm_dwi = jnp.abs(dot(wo_tr, wm)) / jnp.maximum(denom_t, 1e-20)
    pdf_tr_m = (C.tr_pdf(wi_r, wm, alpha)
                / jnp.maximum(4.0 * jnp.abs(dot(wi_r, wm)), 1e-20))
    pdf_tr = jnp.where(index_matched, pdf_tr_m,
                       C.tr_pdf(wi_r, wm, alpha) * dwm_dwi)
    pdf_tr = pdf_tr * sum_tr / jnp.maximum(sum_rr + sum_tr, 1e-20)
    dg = C.tr_d(wm, alpha) * C.microfacet_g(wi_r, wo_tr, wm, alpha)
    val_tr_m = T_r * (dg / jnp.maximum(4.0 * -cti * cto_t, 1e-20))[..., None]
    val_tr_g = T_r * (dg * jnp.abs(dot(wi_r, wm) * dot(wo_tr, wm)
                                   / (cti * cto_t * jnp.where(
                                       denom_t == 0, 1e-20, denom_t))))[..., None]
    val_tr = jnp.where(index_matched[..., None], val_tr_m, val_tr_g)

    bad_r = jnp.where(pick_refl_r, bad_refl, bad_tr)
    wo_r = jnp.where(pick_refl_r[..., None], wo_rr, wo_tr)
    wo_r = jnp.where(reversed_[..., None], -wo_r, wo_r)
    dir_r = normalize(wo_r[..., 0:1] * s_ax + wo_r[..., 1:2] * t_ax
                      + wo_r[..., 2:3] * n)
    val_r = jnp.where(pick_refl_r[..., None], val_refl, val_tr)
    pdf_r = jnp.where(pick_refl_r, pdf_refl, pdf_tr)
    ior_rr = jnp.where(pick_refl_r, ior_keep, ior_cross)
    # invalid rough sample: keep the dispatcher's defaults (val 0, pdf 1)
    val_r = jnp.where(bad_r[..., None], 0.0, val_r)
    pdf_r = jnp.where(bad_r, 1.0, pdf_r)
    dir_r = jnp.where(bad_r[..., None],
                      jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), dir_r.shape),
                      dir_r)
    flags_r = jnp.where(bad_r, jnp.uint32(0),
                        jnp.uint32(C.RAY_FLAG_HAS_NON_SPEC))

    # ======================= merge ==========================================
    val = jnp.where(smooth[..., None], val_s, val_r)
    out_dir = jnp.where(smooth[..., None], dir_s, dir_r)
    pdf = jnp.where(smooth, pdf_s, pdf_r)
    flags = jnp.where(smooth, flags_s, flags_r)
    ior = jnp.where(smooth, ior_s, ior_rr)
    return dict(val=val, dir=out_dir, pdf=pdf, flags=flags, ior=ior)


def eval(scene, md, wavelengths, l, v, n, tc, spectral_mode, tex_pool,
         alpha_tex):
    """filmRoughEval (cmat_film.h:413-544): only metal-substrate rough films
    contribute to NEE; everything else is delta."""
    lam0, ext_ior, film_ior, int_ior, thickness = _film_inputs(
        scene, md, wavelengths, tc, spectral_mode, tex_pool)
    metal_sub = int_ior.imag >= 0.001

    alpha = jnp.stack([
        jnp.minimum(md['data'][..., FILM_ROUGH_V], alpha_tex[..., 0]),
        jnp.minimum(md['data'][..., FILM_ROUGH_U], alpha_tex[..., 1])], -1)
    smooth = C.tr_effectively_smooth(alpha)

    s_ax, t_ax = coordinate_system_v2(n)
    wo = jnp.stack([dot(l, s_ax), dot(l, t_ax), dot(l, n)], -1)
    wi = jnp.stack([dot(v, s_ax), dot(v, t_ax), dot(v, n)], -1)
    wm = normalize(wo + wi)
    opposite = wi[..., 2] * wo[..., 2] < 0.0

    cos_i = jnp.clip(jnp.abs(dot(wo, wm)), 1e-5, 1.0)
    reversed_ = jnp.zeros_like(metal_sub)  # eval path is never reversed
    R, _T = _film_rt(scene, md, cos_i, lam0, spectral_mode, reversed_,
                     thickness, ext_ior, film_ior, int_ior)

    cti = jnp.maximum(wi[..., 2], 1e-6)
    cto = jnp.maximum(wo[..., 2], 1e-6)
    val = R * (C.tr_d(wm, alpha) * C.microfacet_g(wi, wo, wm, alpha)
               / (4.0 * cti * cto))[..., None]
    pdf = (C.tr_pdf(wi, wm, alpha)
           / jnp.maximum(4.0 * jnp.abs(dot(wi, wm)), 1e-20))
    bad = ~metal_sub | smooth | opposite
    return dict(val=jnp.where(bad[..., None], 0.0, val),
                pdf=jnp.where(bad, 0.0, pdf))
