"""Material dispatch: batched MaterialSampleAndEval / MaterialEval.

Mirrors integrator_pt_mat.cpp:109-528.  Per-ray material rows are gathered
from the Scene SoA; then each material type *present in the scene* (the
KSPEC trace-time specialization, SURVEY.md §1) is evaluated for the whole
batch and merged with selects.  The blend tree descends with masked draws
(sample: iterative loop :125-130; eval: fixed-depth stack of 4 :317-525).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.lmath import dot, normalize, mul_rows_2x4, cross
from ..ops import rng as RNG
from ..ops import texture as TEX
from ..ops import spectrum as SPEC
from ..scene.build import (
    Scene, SceneMeta,
    MAT_TYPE_GLTF, MAT_TYPE_GLASS, MAT_TYPE_CONDUCTOR, MAT_TYPE_DIFFUSE,
    MAT_TYPE_PLASTIC, MAT_TYPE_BLEND, MAT_TYPE_DIELECTRIC, MAT_TYPE_THIN_FILM,
    MAT_TYPE_LIGHT_SOURCE,
    GLTF_COLOR_BASE, DIFFUSE_COLOR, PLASTIC_COLOR, BLEND_WEIGHT,
    CONDUCTOR_ROUGH_U, CONDUCTOR_ROUGH_V, CONDUCTOR_ETA, CONDUCTOR_K,
    DIELECTRIC_ETA_INT,
    FLAG_FOUR_TEXTURES, FLAG_PACK_FOUR_PARAMS_IN_TEXTURE,
    FLAG_NMAP_INVERT_X, FLAG_NMAP_INVERT_Y, FLAG_NMAP_SWAP_XY,
    INVALID_ID,
)
from . import common as C
from . import gltf as GLTF
from . import diffuse as DIFF
from . import conductor as COND
from . import dielectric as DIEL
from . import glass as GLASS
from . import plastic as PLAST


def gather_material(scene: Scene, mat_id):
    """Fetch per-ray material rows from the packed tables.

    ONE f32 row [64] and ONE i32 row [16] per ray replace ~10 scattered
    gathers over the struct-of-arrays tables (cmaterial.h Material layout:
    colors/row0/row1/data + mtype/cflags/texid/spdid/datai).
    """
    f = scene.mat_packed_f32[mat_id]
    ints = scene.mat_packed_i32[mat_id]
    return dict(
        mtype=ints[..., 0].astype(jnp.uint32),
        cflags=ints[..., 1].astype(jnp.uint32),
        nonlinear=ints[..., 2],
        texid=ints[..., 4:8],
        spdid=ints[..., 8:12],
        datai=ints[..., 12:16],
        colors=f[..., 0:16].reshape(f.shape[:-1] + (4, 4)),
        row0=f[..., 16:32].reshape(f.shape[:-1] + (4, 4)),
        row1=f[..., 32:48].reshape(f.shape[:-1] + (4, 4)),
        data=f[..., 48:64],
    )


def sample_mat_color_spectrum(scene, md, wavelengths, color_slot, spec_slot,
                              meta=None, tc=None):
    """SampleMatColorParamSpectrum (integrator_spectrum.cpp:4-23) and, when
    the scene has per-wavelength texture stacks and ``meta``/``tc`` are
    given, SampleMatColorSpectrumTexture (integrator_spectrum.cpp:127-183,
    KSPEC_SPD_TEX)."""
    res = md['colors'][..., color_slot, :]
    spectral = wavelengths[..., 0] > 0.0
    spec_id = md['spdid'][..., spec_slot]
    has_spd = spec_id != jnp.int32(-1)
    sid = jnp.clip(spec_id, 0, scene.spec_offset_sz.shape[0] - 1)
    offset = scene.spec_offset_sz[sid, 0]
    sampled = SPEC.sample_uniform_spectrum(scene.spec_values, offset, wavelengths)
    out = jnp.where((spectral & has_spd)[..., None], sampled, res)

    if meta is not None and getattr(meta, 'has_spd_tex', False) and tc is not None:
        toff = scene.spec_tex_offset_sz[sid]
        tex_off, tex_sz = toff[..., 0], toff[..., 1]
        has_tex = has_spd & (tex_sz > 0)
        tc_t = mul_rows_2x4(md['row0'][..., 0, :], md['row1'][..., 0, :], tc)
        K = meta.spd_tex_max_sz
        base = jnp.clip(tex_off, 0, scene.spec_tex_wl.shape[0] - 1)
        w_first = scene.spec_tex_wl[base]
        w_last = scene.spec_tex_wl[jnp.clip(base + tex_sz - 1, 0,
                                            scene.spec_tex_wl.shape[0] - 1)]
        lane_vals = [jnp.zeros(wavelengths.shape[:-1], jnp.float32)
                     for _ in range(4)]
        for j in range(max(K - 1, 0)):
            idx0 = jnp.clip(base + j, 0, scene.spec_tex_wl.shape[0] - 1)
            idx1 = jnp.clip(base + j + 1, 0, scene.spec_tex_wl.shape[0] - 1)
            w0 = scene.spec_tex_wl[idx0]
            w1 = scene.spec_tex_wl[idx1]
            t1 = scene.spec_tex_texid[idx0]
            t2 = scene.spec_tex_texid[idx1]
            c1 = TEX.sample(scene.textures, _clamp_tex(scene, t1), tc_t)[..., 0]
            c2 = TEX.sample(scene.textures, _clamp_tex(scene, t2), tc_t)[..., 0]
            seg_ok = (j + 1) < tex_sz
            for i in range(4):
                wl_i = wavelengths[..., i]
                inseg = seg_ok & (wl_i >= w0) & (wl_i < w1)
                # last segment includes its right endpoint
                inseg = inseg | (seg_ok & ((j + 2) == tex_sz) & (wl_i == w1))
                t = (wl_i - w0) / jnp.maximum(w1 - w0, 1e-6)
                lane_vals[i] = jnp.where(inseg, c1 * (1.0 - t) + c2 * t,
                                         lane_vals[i])
        tex_res = jnp.stack(lane_vals, axis=-1)
        in_range = ((wavelengths >= w_first[..., None])
                    & (wavelengths <= w_last[..., None]))
        tex_res = jnp.where(in_range, tex_res, 0.0)
        out = jnp.where((spectral & has_tex)[..., None], tex_res, out)
    return out


def sample_mat_param_spectrum(scene, md, wavelengths, param_slot, spec_slot):
    res = md['data'][..., param_slot][..., None] * jnp.ones_like(wavelengths)
    spectral = wavelengths[..., 0] > 0.0
    spec_id = md['spdid'][..., spec_slot]
    has_spd = spec_id != jnp.int32(-1)
    offset = scene.spec_offset_sz[jnp.clip(spec_id, 0, scene.spec_offset_sz.shape[0] - 1), 0]
    sampled = SPEC.sample_uniform_spectrum(scene.spec_values, offset, wavelengths)
    return jnp.where((spectral & has_spd)[..., None], sampled, res)


def _normal_map_transform(mflags, normal_from_tex):
    """NormalMapTransform (integrator_pt_mat.cpp:76-94)."""
    nx = 2.0 * normal_from_tex[..., 0] - 1.0
    ny = 2.0 * normal_from_tex[..., 1] - 1.0
    nz = normal_from_tex[..., 2]
    nx = jnp.where((mflags & FLAG_NMAP_INVERT_X) != 0, -nx, nx)
    ny = jnp.where((mflags & FLAG_NMAP_INVERT_Y) != 0, -ny, ny)
    swap = (mflags & FLAG_NMAP_SWAP_XY) != 0
    nx2 = jnp.where(swap, ny, nx)
    ny2 = jnp.where(swap, nx, ny)
    return jnp.stack([nx2, ny2, nz], -1)


def bump_mapping(scene, md, n, tang, tc):
    """BumpMapping (integrator_pt_mat.cpp:96-107)."""
    tc_t = mul_rows_2x4(md['row0'][..., 1, :], md['row1'][..., 1, :], tc)
    normal_tex = TEX.sample(scene.textures, _clamp_tex(scene, md['texid'][..., 1]), tc_t)
    normal_ts = _normal_map_transform(md['cflags'], normal_tex[..., :3])
    bitan = cross(n, tang)
    # tangentTransform = rows (tan, bitan, n); world normal = M^-1 @ n_ts
    # For an orthonormal frame M^-1 = M^T, i.e. columns (tan, bitan, n).
    world = (tang * normal_ts[..., 0:1] + bitan * normal_ts[..., 1:2]
             + n * normal_ts[..., 2:3])
    return normalize(world)


def _clamp_tex(scene, texid):
    """Invalid texture ids (0xFFFFFFFF) -> white dummy slot 0."""
    t = texid
    bad = (t < 0) | (t >= scene.textures.offset.shape[0])
    return jnp.where(bad, 0, t)


def slot0_tex_color(scene: Scene, meta: SceneMeta, md, mat_id, tc):
    """Material slot-0 texture tap.

    With the const-texture fold (every slot-0 texture is 1x1, see
    scene/build.py mat_tex0_const) the tap is ONE per-material row fetch
    instead of a bilinear texture tap."""
    if meta.tex0_all_const and scene.mat_tex0_const is not None:
        return scene.mat_tex0_const[mat_id]
    tc_t = mul_rows_2x4(md['row0'][..., 0, :], md['row1'][..., 0, :], tc)
    return TEX.sample(scene.textures, _clamp_tex(scene, md['texid'][..., 0]),
                      tc_t)


def _four_scalar_params(scene, meta, md, tc):
    """4-texture scalar params (integrator_pt_mat.cpp:151-167)."""
    ones = jnp.ones(md['cflags'].shape + (4,), jnp.float32)
    if not meta.has_four_textures:
        return ones
    tc2 = mul_rows_2x4(md['row0'][..., 2, :], md['row1'][..., 2, :], tc)
    tc3 = mul_rows_2x4(md['row0'][..., 3, :], md['row1'][..., 3, :], tc)
    color2 = TEX.sample(scene.textures, _clamp_tex(scene, md['texid'][..., 2]), tc2)
    color3 = TEX.sample(scene.textures, _clamp_tex(scene, md['texid'][..., 3]), tc3)
    packed = color2
    split = jnp.stack([color2[..., 0], color3[..., 0],
                       jnp.ones_like(color2[..., 0]), jnp.ones_like(color2[..., 0])], -1)
    four = jnp.where(((md['cflags'] & FLAG_PACK_FOUR_PARAMS_IN_TEXTURE) != 0)[..., None],
                     packed, split)
    return jnp.where(((md['cflags'] & FLAG_FOUR_TEXTURES) != 0)[..., None], four, ones)


def make_shading_ctx(scene: Scene, meta: SceneMeta, mat_id, n, tang, tc):
    """Per-bounce shared shading data, computed ONCE and reused by NEE's
    MaterialEval, the bounce's MaterialSampleAndEval, and the emissive-hit
    branch, where the reference recomputes them per kernel
    (integrator_pt_mat.cpp:109-528).

    Only used when the scene has no blend materials (blend descent changes
    the leaf material per stochastic draw)."""
    md = gather_material(scene, mat_id)
    geom_normal = n
    shade_normal = n
    if meta.has_bump:
        has_nmap = md['texid'][..., 1] != jnp.int32(-1)
        bn = bump_mapping(scene, md, geom_normal, tang, tc)
        shade_normal = jnp.where(has_nmap[..., None], bn, geom_normal)
    tex_color = slot0_tex_color(scene, meta, md, mat_id, tc)
    four_params = _four_scalar_params(scene, meta, md, tc)
    return dict(md=md, shade_normal=shade_normal, tex_color=tex_color,
                four_params=four_params)


def _empty_sample(shape_n):
    return dict(val=jnp.zeros((shape_n, 4), jnp.float32),
                dir=jnp.tile(jnp.array([0.0, 1.0, 0.0], jnp.float32), (shape_n, 1)),
                pdf=jnp.ones((shape_n,), jnp.float32),
                flags=jnp.zeros((shape_n,), jnp.uint32),
                ior=jnp.ones((shape_n,), jnp.float32))


def _merge(sel, a, b):
    """Select sample-dict a where sel else b."""
    out = {}
    for k in b:
        av, bv = a[k], b[k]
        s = sel
        if av.ndim > sel.ndim:
            s = sel[..., None]
        out[k] = jnp.where(s, av, bv)
    return out


def material_sample_and_eval(scene: Scene, meta: SceneMeta, mat_id, wavelengths,
                             rng_state, live, v, n, tang, tc, mis_ior, ray_flags,
                             rnd_mats_override=None,
                             rnd_mats_override_full=None, ctx=None):
    """MaterialSampleAndEval (integrator_pt_mat.cpp:109-306), batched.

    Returns (sample_dict, new_rng_state, new_mis_ior).
    sample_dict: val [N,4], dir [N,3], pdf [N], flags [N] u32, ior [N].
    ``ctx``: optional precomputed shading context (make_shading_ctx).
    """
    N = mat_id.shape[0]
    curr_mat = mat_id
    res_pdf_mult = jnp.ones((N,), jnp.float32)
    res_val_mult = jnp.ones((N,), jnp.float32)

    # blend descent (iterative while, max BLEND_STACK_SIZE layers)
    if meta.has_blend:
        ctx = None
        for _layer in range(meta.max_blend_stack):
            md_b = gather_material(scene, curr_mat)
            is_blend = (md_b['mtype'] == MAT_TYPE_BLEND) & live
            rng_state, select = RNG.rnd_matb(rng_state, is_blend)
            wtex = slot0_tex_color(scene, meta, md_b, curr_mat, tc)[..., 0]
            weight = md_b['data'][..., BLEND_WEIGHT] * wtex
            pick2 = select < weight
            mult = jnp.where(pick2, weight, 1.0 - weight)
            next_mat = jnp.where(pick2, md_b['datai'][..., 1], md_b['datai'][..., 0])
            curr_mat = jnp.where(is_blend, next_mat, curr_mat)
            res_pdf_mult = jnp.where(is_blend, res_pdf_mult * mult, res_pdf_mult)
            res_val_mult = jnp.where(is_blend, res_val_mult * mult, res_val_mult)

    if ctx is not None:
        md = ctx['md']
        geom_normal = n
        shade_normal = ctx['shade_normal']
        tex_color = ctx['tex_color']
    else:
        md = gather_material(scene, curr_mat)
        geom_normal = n
        shade_normal = n
        if meta.has_bump:
            has_nmap = md['texid'][..., 1] != jnp.int32(-1)
            bn = bump_mapping(scene, md, geom_normal, tang, tc)
            shade_normal = jnp.where(has_nmap[..., None], bn, geom_normal)

        tex_color = slot0_tex_color(scene, meta, md, curr_mat, tc)
    rng_state, rands = RNG.rnd_mats(rng_state, live)
    if rnd_mats_override_full is not None:
        rands = rnd_mats_override_full   # KMLT: full 4-vector from chain state
    elif rnd_mats_override is not None:
        # IntegratorQMC bounce-0 dims (integrator_qmc.cpp:118-127)
        rands = jnp.concatenate([rnd_mats_override, rands[..., 2:4]], -1)
    four_params = (ctx['four_params'] if ctx is not None
                   else _four_scalar_params(scene, meta, md, tc))

    res = _empty_sample(N)
    new_ior = mis_ior

    types = set(meta.mat_types_present)
    if MAT_TYPE_GLTF in types:
        base = md['colors'][..., GLTF_COLOR_BASE, :] * tex_color
        s = GLTF.sample_and_eval(md, rands, v, shade_normal, base, four_params)
        res = _merge(md['mtype'] == MAT_TYPE_GLTF, s, res)
    if MAT_TYPE_DIFFUSE in types:
        refl = sample_mat_color_spectrum(scene, md, wavelengths, DIFFUSE_COLOR, 0, meta, tc)
        if not meta.spectral_mode:
            refl = refl * tex_color
        s = DIFF.sample_and_eval(md, refl, rands, v, shade_normal)
        res = _merge(md['mtype'] == MAT_TYPE_DIFFUSE, s, res)
    if MAT_TYPE_CONDUCTOR in types:
        eta_spec = sample_mat_param_spectrum(scene, md, wavelengths, CONDUCTOR_ETA, 0)
        k_spec = sample_mat_param_spectrum(scene, md, wavelengths, CONDUCTOR_K, 1)
        s = COND.sample_and_eval(md, eta_spec, k_spec, rands, v, shade_normal,
                                 tex_color[..., :3])
        res = _merge(md['mtype'] == MAT_TYPE_CONDUCTOR, s, res)
    if MAT_TYPE_DIELECTRIC in types:
        int_ior_spec = sample_mat_param_spectrum(scene, md, wavelengths, DIELECTRIC_ETA_INT, 0)
        s = DIEL.sample_and_eval(md, int_ior_spec, mis_ior, rands, v, shade_normal, ray_flags)
        is_diel = md['mtype'] == MAT_TYPE_DIELECTRIC
        has_spd = md['spdid'][..., 0] != jnp.int32(-1)
        s['flags'] = s['flags'] | jnp.where(
            has_spd, jnp.uint32(C.RAY_FLAG_WAVES_DIVERGED), jnp.uint32(0))
        res = _merge(is_diel, s, res)
        new_ior = jnp.where(is_diel, s['ior'], new_ior)
    if MAT_TYPE_GLASS in types:
        s = GLASS.sample_and_eval(md, rands, v, geom_normal, mis_ior, ray_flags)
        is_glass = md['mtype'] == MAT_TYPE_GLASS
        res = _merge(is_glass, s, res)
        new_ior = jnp.where(is_glass, s['ior'], new_ior)
    if MAT_TYPE_PLASTIC in types:
        refl = sample_mat_color_spectrum(scene, md, wavelengths, PLASTIC_COLOR, 0, meta, tc)
        if not meta.spectral_mode:
            refl = refl * tex_color
        s = PLAST.sample_and_eval(scene, md, refl, rands, v, shade_normal)
        res = _merge(md['mtype'] == MAT_TYPE_PLASTIC, s, res)
    if MAT_TYPE_THIN_FILM in types:
        from . import film as FILM
        s = FILM.sample_and_eval(scene, md, wavelengths, rands, v,
                                 shade_normal, tc, mis_ior, ray_flags,
                                 meta.spectral_mode, scene.textures,
                                 tex_color[..., :3])
        # films always diverge the hero wavelengths (integrator_pt_mat.cpp:248)
        s['flags'] = s['flags'] | jnp.uint32(C.RAY_FLAG_WAVES_DIVERGED)
        is_film = md['mtype'] == MAT_TYPE_THIN_FILM
        res = _merge(is_film, s, res)
        new_ior = jnp.where(is_film, s['ior'], new_ior)

    # bump cosine correction (integrator_pt_mat.cpp:298-303)
    if meta.has_bump:
        has_nmap = md['texid'][..., 1] != jnp.int32(-1)
        cos1 = jnp.abs(dot(res['dir'], geom_normal))
        cos2 = jnp.abs(dot(res['dir'], shade_normal))
        mult = cos2 / jnp.maximum(cos1, 1e-10)
        res['val'] = jnp.where(has_nmap[..., None], res['val'] * mult[..., None], res['val'])

    res['val'] = res['val'] * res_val_mult[..., None]
    res['pdf'] = res['pdf'] * res_pdf_mult
    return res, rng_state, new_ior


def material_eval(scene: Scene, meta: SceneMeta, mat_id, wavelengths,
                  l, v, n, tang, tc, ctx=None):
    """MaterialEval (integrator_pt_mat.cpp:308-528), batched.

    Blend handled with a fixed-size explicit stack of (matId, weight), fully
    unrolled (BLEND_STACK_SIZE=4 -> at most 2^depth leaf evaluations, but we
    walk the same stack discipline as the reference).
    Returns dict(val [N,4], pdf [N]).
    """
    N = mat_id.shape[0]
    out_val = jnp.zeros((N, 4), jnp.float32)
    out_pdf = jnp.zeros((N,), jnp.float32)

    # stack emulation: statically unrolled; without blends only one iteration
    max_iters = 1 if not meta.has_blend else (2 ** meta.max_blend_stack)
    stack_ids = jnp.zeros((N, meta.max_blend_stack), jnp.int32)
    stack_w = jnp.zeros((N, meta.max_blend_stack), jnp.float32)
    top = jnp.zeros((N,), jnp.int32)
    curr_id = mat_id
    curr_w = jnp.ones((N,), jnp.float32)
    active = jnp.ones((N,), bool)

    if meta.has_blend:
        ctx = None
    for _ in range(max_iters):
        geom_normal = n
        bump_mult = jnp.ones((N,), jnp.float32)
        if ctx is not None:
            md = ctx['md']
            shade_normal = ctx['shade_normal']
            tex_color = ctx['tex_color']
            four_params = ctx['four_params']
            if meta.has_bump:
                has_nmap = md['texid'][..., 1] != jnp.int32(-1)
                cos1 = jnp.maximum(dot(l, geom_normal), 0.0)
                cos2 = jnp.maximum(dot(l, shade_normal), 0.0)
                bm = jnp.where(cos1 <= 0.0, 0.0, cos2 / jnp.maximum(cos1, 1e-6))
                bump_mult = jnp.where(has_nmap, bm, bump_mult)
        else:
            md = gather_material(scene, curr_id)
            shade_normal = n
            if meta.has_bump:
                has_nmap = md['texid'][..., 1] != jnp.int32(-1)
                bn = bump_mapping(scene, md, geom_normal, tang, tc)
                shade_normal = jnp.where(has_nmap[..., None], bn, geom_normal)
                cos1 = jnp.maximum(dot(l, geom_normal), 0.0)
                cos2 = jnp.maximum(dot(l, shade_normal), 0.0)
                bm = jnp.where(cos1 <= 0.0, 0.0, cos2 / jnp.maximum(cos1, 1e-6))
                bump_mult = jnp.where(has_nmap, bm, bump_mult)

            tex_color = slot0_tex_color(scene, meta, md, curr_id, tc)
            four_params = _four_scalar_params(scene, meta, md, tc)

        val = jnp.zeros((N, 4), jnp.float32)
        pdf = jnp.zeros((N,), jnp.float32)
        types = set(meta.mat_types_present)
        if MAT_TYPE_GLTF in types:
            base = md['colors'][..., GLTF_COLOR_BASE, :] * tex_color
            e = GLTF.eval(md, l, v, shade_normal, base, four_params)
            sel = md['mtype'] == MAT_TYPE_GLTF
            val = jnp.where(sel[..., None], e['val'], val)
            pdf = jnp.where(sel, e['pdf'], pdf)
        if MAT_TYPE_DIFFUSE in types:
            refl = sample_mat_color_spectrum(scene, md, wavelengths, DIFFUSE_COLOR, 0, meta, tc)
            if not meta.spectral_mode:
                refl = refl * tex_color
            e = DIFF.eval(md, refl, l, v, shade_normal)
            sel = md['mtype'] == MAT_TYPE_DIFFUSE
            val = jnp.where(sel[..., None], e['val'], val)
            pdf = jnp.where(sel, e['pdf'], pdf)
        if MAT_TYPE_CONDUCTOR in types:
            eta_spec = sample_mat_param_spectrum(scene, md, wavelengths, CONDUCTOR_ETA, 0)
            k_spec = sample_mat_param_spectrum(scene, md, wavelengths, CONDUCTOR_K, 1)
            e = COND.eval(md, eta_spec, k_spec, l, v, shade_normal, tex_color[..., :3])
            sel = md['mtype'] == MAT_TYPE_CONDUCTOR
            val = jnp.where(sel[..., None], e['val'], val)
            pdf = jnp.where(sel, e['pdf'], pdf)
        if MAT_TYPE_GLASS in types:
            # glassEval: val and pdf are zero (delta) — nothing to add
            pass
        if MAT_TYPE_DIELECTRIC in types:
            # dielectricSmoothEval: zero
            pass
        if MAT_TYPE_PLASTIC in types:
            refl = sample_mat_color_spectrum(scene, md, wavelengths, PLASTIC_COLOR, 0, meta, tc)
            if not meta.spectral_mode:
                refl = refl * tex_color
            e = PLAST.eval(scene, md, refl, l, v, shade_normal)
            sel = md['mtype'] == MAT_TYPE_PLASTIC
            val = jnp.where(sel[..., None], e['val'], val)
            pdf = jnp.where(sel, e['pdf'], pdf)
        if MAT_TYPE_THIN_FILM in types:
            from . import film as FILM
            e = FILM.eval(scene, md, wavelengths, l, v, shade_normal, tc,
                          meta.spectral_mode, scene.textures,
                          tex_color[..., :3])
            sel = md['mtype'] == MAT_TYPE_THIN_FILM
            val = jnp.where(sel[..., None], e['val'], val)
            pdf = jnp.where(sel, e['pdf'], pdf)

        leaf = active & (md['mtype'] != MAT_TYPE_BLEND)
        out_val = out_val + jnp.where(leaf[..., None], val * (curr_w * bump_mult)[..., None], 0.0)
        out_pdf = out_pdf + jnp.where(leaf, pdf * curr_w, 0.0)

        if not meta.has_blend:
            break

        # blend node: push second child, descend into first
        is_blend = active & (md['mtype'] == MAT_TYPE_BLEND)
        wtex = slot0_tex_color(scene, meta, md, curr_id, tc)[..., 0]
        weight = md['data'][..., BLEND_WEIGHT] * wtex
        mat1 = md['datai'][..., 0]
        mat2 = md['datai'][..., 1]
        can_push = top < meta.max_blend_stack
        push = is_blend & can_push
        idx = jnp.clip(top, 0, meta.max_blend_stack - 1)
        stack_ids = jnp.where(push[..., None],
                              stack_ids.at[jnp.arange(N), idx].set(mat2), stack_ids)
        stack_w = jnp.where(push[..., None],
                            stack_w.at[jnp.arange(N), idx].set(curr_w * weight), stack_w)
        top = jnp.where(push, top + 1, top)
        # descend into first child with weight*(1-w)
        curr_id = jnp.where(is_blend, mat1, curr_id)
        curr_w = jnp.where(is_blend, curr_w * (1.0 - weight), curr_w)
        # leaves pop from the stack
        pop = leaf & (top > 0)
        top = jnp.where(pop, top - 1, top)
        idx2 = jnp.clip(top, 0, meta.max_blend_stack - 1)
        curr_id = jnp.where(pop, stack_ids[jnp.arange(N), idx2], curr_id)
        curr_w = jnp.where(pop, stack_w[jnp.arange(N), idx2], curr_w)
        active = is_blend | pop

    return dict(val=out_val, pdf=out_pdf)
