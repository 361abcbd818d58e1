"""Mitsuba-style plastic material (include/cmat_plastic.h).

The 64-entry rough-transmittance LUT lives in scene.arrays1f at
mat.datai[0] (reference m_arrays1f, integrator_pt_mat.cpp:273-274).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils.lmath import INV_PI, dot, normalize, coordinate_system_v2, lerp
from . import common as C
from ..scene import build as B

MI_ROUGH_TRANSMITTANCE_RES = 64
EPS32 = 5.960464477539063e-8


def _lerp_lut(arrays1f, offset, x):
    xf = x * (MI_ROUGH_TRANSMITTANCE_RES - 1)
    idx = jnp.minimum(xf.astype(jnp.int32), MI_ROUGH_TRANSMITTANCE_RES - 2)
    v0 = arrays1f[offset + idx]
    v1 = arrays1f[offset + idx + 1]
    return lerp(v0, v1, xf - idx.astype(jnp.float32))


def sample_and_eval(scene, md, refl_spec, rands, v, n):
    """plasticSampleAndEval (cmat_plastic.h:7-107)."""
    alpha = md['data'][..., B.PLASTIC_ROUGHNESS]
    eta = md['data'][..., B.PLASTIC_IOR_RATIO]
    spec_weight = md['data'][..., B.PLASTIC_SPEC_SAMPLE_WEIGHT]
    internal_refl = md['data'][..., B.PLASTIC_PRECOMP_REFLECTANCE]
    tr_offset = md['datai'][..., 0]
    alpha2 = jnp.stack([alpha, alpha], -1)

    s, t = coordinate_system_v2(n)
    wi = jnp.stack([dot(v, s), dot(v, t), dot(v, n)], -1)
    dead = wi[..., 2] <= 0
    cos_i = jnp.maximum(wi[..., 2], EPS32)

    t_i = _lerp_lut(scene.arrays1f, tr_offset, cos_i)
    prob_spec = (1.0 - t_i) * spec_weight
    prob_diff = t_i * (1.0 - spec_weight)
    both = (prob_diff != 0.0) & (prob_spec != 0.0)
    ps = jnp.where(both, prob_spec / jnp.maximum(prob_spec + prob_diff, 1e-20), 0.0)
    pd = jnp.where(both, 1.0 - ps, 1.0)

    pick_spec = rands[..., 2] < ps
    wm, _ = C.sample_visible_normal(wi, rands[..., :2], alpha2)
    wo_spec = 2.0 * dot(wi, wm)[..., None] * wm - wi
    wo_diff = C.square_to_cosine_hemisphere(rands[..., :2])
    wo = jnp.where(pick_spec[..., None], wo_spec, wo_diff)
    dead = dead | (cos_i * wo[..., 2] <= 0)
    cos_o = jnp.maximum(wo[..., 2], EPS32)

    h = normalize(wo + wi)
    d = C.eval_microfacet_ggx(h, alpha2)
    pdf = d * C.smith_g1(wi, h, alpha2) / (4.0 * cos_i)
    pdf = pdf * ps + pd * INV_PI * cos_o

    f = C.fr_dielectric(dot(wi, h), eta)
    g = C.microfacet_g(wi, wo, h, alpha2)
    val = f * d * g / (4.0 * cos_i * cos_o)
    t_o = _lerp_lut(scene.arrays1f, tr_offset, cos_o)

    nonlinear = md['nonlinear']
    denom_lin = 1.0 - internal_refl[..., None]
    denom_nl = 1.0 - refl_spec * internal_refl[..., None]
    diffuse = refl_spec / jnp.where((nonlinear > 0)[..., None], denom_nl, denom_lin)
    inv_eta2 = 1.0 / (eta * eta)

    out_dir = normalize(wo[..., 0:1] * s + wo[..., 1:2] * t + wo[..., 2:3] * n)
    out_val = val[..., None] + diffuse * (INV_PI * inv_eta2 * t_i * t_o)[..., None]
    out_val = jnp.where(dead[..., None], 0.0, out_val)
    out_pdf = jnp.where(dead, 1.0, pdf)
    out_dir = jnp.where(dead[..., None],
                        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), out_dir.shape), out_dir)
    return dict(val=out_val, dir=out_dir, pdf=out_pdf,
                flags=jnp.full(out_pdf.shape, C.RAY_FLAG_HAS_NON_SPEC, jnp.uint32),
                ior=jnp.ones_like(out_pdf))


def eval(scene, md, refl_spec, l, v, n):
    """plasticEval (cmat_plastic.h:110-191)."""
    alpha = md['data'][..., B.PLASTIC_ROUGHNESS]
    eta = md['data'][..., B.PLASTIC_IOR_RATIO]
    spec_weight = md['data'][..., B.PLASTIC_SPEC_SAMPLE_WEIGHT]
    internal_refl = md['data'][..., B.PLASTIC_PRECOMP_REFLECTANCE]
    tr_offset = md['datai'][..., 0]
    alpha2 = jnp.stack([alpha, alpha], -1)

    s, t = coordinate_system_v2(n)
    wo = jnp.stack([dot(l, s), dot(l, t), dot(l, n)], -1)
    wi = jnp.stack([dot(v, s), dot(v, t), dot(v, n)], -1)
    dead = wi[..., 2] * wo[..., 2] <= 0
    cos_i = jnp.maximum(wi[..., 2], EPS32)
    cos_o = jnp.maximum(wo[..., 2], EPS32)

    t_i = _lerp_lut(scene.arrays1f, tr_offset, cos_i)
    prob_spec = (1.0 - t_i) * spec_weight
    prob_diff = t_i * (1.0 - spec_weight)
    both = (prob_diff != 0.0) & (prob_spec != 0.0)
    ps = jnp.where(both, prob_spec / jnp.maximum(prob_spec + prob_diff, 1e-20), 0.0)
    pd = jnp.where(both, 1.0 - ps, 1.0)

    h = normalize(wo + wi)
    d = C.eval_microfacet_ggx(h, alpha2)
    g1_wi = C.smith_g1(wi, h, alpha2)
    pdf = d * g1_wi / (4.0 * cos_i)
    pdf = pdf * ps + pd * INV_PI * cos_o

    f = C.fr_dielectric(dot(wi, h), eta)
    g = C.smith_g1(wo, h, alpha2) * g1_wi
    val = f * d * g / (4.0 * cos_i * cos_o)
    t_o = _lerp_lut(scene.arrays1f, tr_offset, cos_o)

    nonlinear = md['nonlinear']
    denom_lin = 1.0 - internal_refl[..., None]
    denom_nl = 1.0 - refl_spec * internal_refl[..., None]
    diffuse = refl_spec / jnp.where((nonlinear > 0)[..., None], denom_nl, denom_lin)
    inv_eta2 = 1.0 / (eta * eta)

    out_val = val[..., None] + diffuse * (INV_PI * inv_eta2 * t_i * t_o)[..., None]
    return dict(val=jnp.where(dead[..., None], 0.0, out_val),
                pdf=jnp.where(dead, 0.0, pdf))
