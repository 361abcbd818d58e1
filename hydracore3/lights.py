"""Light sampling, PDFs and intensity (clight.h + integrator_pt_lgt.cpp), batched.

All functions take per-ray gathered light rows (`gather_light`) and merge the
per-geometry-type branches with selects — the batched analog of the
``switch(gtype)`` dispatch in LightSampleRev (integrator_pt_lgt.cpp:21-58).
"""
from __future__ import annotations

import jax.numpy as jnp

from .utils.lmath import (
    M_PI, safe_arccos, dot, normalize, mul3x3, mul4x4_vec, epsilon_of_pos, map_samples_to_disc,
    pdf_a_to_w, mul_rows_2x4, sphere_map_to_2d_tex_coord, tex_coord_2d_to_sphere_map,
)
from .ops import texture as TEX
from .ops import spectrum as SPEC
from .scene.build import (
    Scene, SceneMeta,
    LIGHT_GEOM_RECT, LIGHT_GEOM_DISC, LIGHT_GEOM_SPHERE, LIGHT_GEOM_DIRECT,
    LIGHT_GEOM_POINT, LIGHT_GEOM_ENV, LIGHT_DIST_LAMBERT, LIGHT_DIST_OMNI,
    LIGHT_DIST_SPOT, LIGHT_FLAG_POINT_AREA, LIGHT_FLAG_PROJECTIVE,
)


def gather_light(scene: Scene, light_id):
    """Fetch per-ray light rows from the packed tables (clight.h LightSource
    SoA): one f32 row [66] + one i32 row [16] instead of ~22 gathers."""
    L = scene.light_packed_f32.shape[0]
    lid = jnp.clip(light_id, 0, L - 1)
    f = scene.light_packed_f32[lid]
    ints = scene.light_packed_i32[lid]
    sh = f.shape[:-1]
    return dict(
        pos=f[..., 0:4], norm=f[..., 4:8], intensity=f[..., 8:12],
        matrix=f[..., 12:28].reshape(sh + (4, 4)),
        ies_matrix=f[..., 28:44].reshape(sh + (4, 4)),
        sam_row0=f[..., 44:48], sam_row1=f[..., 48:52],
        sam_row0_inv=f[..., 52:56], sam_row1_inv=f[..., 56:60],
        size=f[..., 60:62], pdf_a=f[..., 62], mult=f[..., 63],
        cos1=f[..., 64], cos2=f[..., 65],
        geom_type=ints[..., 0], dist_type=ints[..., 1], flags=ints[..., 2],
        pdf_table_offset=ints[..., 3],
        pdf_table_size_x=ints[..., 4], pdf_table_size_y=ints[..., 5],
        spec_id=ints[..., 6], tex_id=ints[..., 7], ies_id=ints[..., 8])


def _sample_map_2d(scene: Scene, rands3, table_offset, size_x, size_y):
    """SampleMap2D (integrator_pt_lgt.cpp:217-239): CDF inversion on the
    prefix-summed luminance table via searchsorted."""
    fw = size_x.astype(jnp.float32)
    fh = size_y.astype(jnp.float32)
    n = size_x * size_y
    total = scene.arrays1f[table_offset + n]
    x = rands3[..., 2] * total
    # binary search over the prefix table: find largest i with accum[i] < x <= accum[i+1]
    # vectorized manual binary search (table is shared but offset per ray)
    lo = jnp.zeros_like(n)
    hi = n - 1
    # static iteration bound from the (static) backing-array size: any
    # light's table fits inside arrays1f, so ceil(log2(len)) steps suffice
    steps = max(int(scene.arrays1f.shape[0] - 1).bit_length(), 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        a = scene.arrays1f[table_offset + mid]
        go_right = a < x
        lo = jnp.where(go_right, jnp.minimum(mid + 1, hi), lo)
        hi = jnp.where(go_right, hi, mid)
    pixel = jnp.clip(lo - 1 + (scene.arrays1f[table_offset + lo]
                                < x).astype(jnp.int32), 0, n - 1)
    # ensure accum[pixel] < x <= accum[pixel+1] approximately
    pdf = ((scene.arrays1f[table_offset + pixel + 1]
            - scene.arrays1f[table_offset + pixel])
           / jnp.maximum(total, 1e-30))
    # integer divide by a dynamic divisor is a long instruction sequence;
    # float-divide then fix up exactly with one multiply/compare round
    y_pos = (pixel.astype(jnp.float32) / fw).astype(jnp.int32)
    rem = pixel - y_pos * size_x
    y_pos = jnp.where(rem < 0, y_pos - 1, jnp.where(rem >= size_x, y_pos + 1, y_pos))
    x_pos = pixel - y_pos * size_x
    tex_x = (1.0 / fw) * ((x_pos.astype(jnp.float32) + 0.5)
                          + (rands3[..., 0] * 2.0 - 1.0) * 0.5)
    tex_y = (1.0 / fh) * ((y_pos.astype(jnp.float32) + 0.5)
                          + (rands3[..., 1] * 2.0 - 1.0) * 0.5)
    map_pdf = pdf * fw * fh
    return jnp.stack([tex_x, tex_y], -1), map_pdf


def _eval_map_2d_pdf(scene: Scene, tex_coord, table_offset, size_x, size_y):
    """evalMap2DPdf (clight.h:190-218)."""
    fw = size_x.astype(jnp.float32)
    fh = size_y.astype(jnp.float32)
    tx = tex_coord[..., 0] - jnp.floor(tex_coord[..., 0])
    ty = tex_coord[..., 1] - jnp.floor(tex_coord[..., 1])
    px = jnp.clip((fw * tx - 0.5).astype(jnp.int32), 0, size_x - 1)
    py = jnp.clip((fh * ty - 0.5).astype(jnp.int32), 0, size_y - 1)
    off = py * size_x + px
    v0 = scene.arrays1f[table_offset + off]
    v1 = scene.arrays1f[table_offset + off + 1]
    total = scene.arrays1f[table_offset + size_x * size_y]
    return (v1 - v0) * fw * fh / jnp.maximum(total, 1e-30)


def light_sample_rev(scene: Scene, meta: SceneMeta, light_id, rands3, illum_point):
    """LightSampleRev: returns dict(pos, norm, pdf, is_omni, has_ies)."""
    ld = gather_light(scene, light_id)
    gt = ld['geom_type']
    rands2 = rands3[..., :2]
    has_ies = ld['ies_id'] >= 0

    # area (rect/disc) — clight.h:67-84
    sample_off_rect = 2.0 * (rands2 - 0.5) * ld['size']
    off_disc = map_samples_to_disc(rands2 * 2.0 - 1.0) * ld['size'][..., 0:1]
    sample_off = jnp.where((gt == LIGHT_GEOM_DISC)[..., None], off_disc, sample_off_rect)
    local = jnp.stack([sample_off[..., 0], jnp.zeros_like(sample_off[..., 0]),
                       sample_off[..., 1]], -1)
    area_pos = (mul3x3(ld['matrix'], local) + ld['pos'][..., :3]
                + epsilon_of_pos(ld['pos'][..., :3])[..., None] * ld['norm'][..., :3])

    # sphere — clight.h:86-103
    theta = 2.0 * M_PI * rands2[..., 0]
    phi = safe_arccos(1.0 - 2.0 * rands2[..., 1])
    sph_dir = jnp.stack([jnp.sin(phi) * jnp.cos(theta),
                         jnp.sin(phi) * jnp.sin(theta),
                         jnp.cos(phi)], -1)
    sph_pos = ld['pos'][..., :3] + (ld['size'][..., 0] * 1.000001)[..., None] * sph_dir
    sph_norm = normalize(sph_pos - ld['pos'][..., :3])

    # direct — clight.h:105-115
    dir_pos = illum_point - ld['norm'][..., :3] * 100000.0

    # point — clight.h:117-126
    pt_pos = ld['pos'][..., :3]

    pos = jnp.where((gt == LIGHT_GEOM_SPHERE)[..., None], sph_pos,
          jnp.where((gt == LIGHT_GEOM_DIRECT)[..., None], dir_pos,
          jnp.where((gt == LIGHT_GEOM_POINT)[..., None], pt_pos, area_pos)))
    norm = jnp.where((gt == LIGHT_GEOM_SPHERE)[..., None], sph_norm,
                     ld['norm'][..., :3])
    pdf = jnp.ones_like(rands3[..., 0])
    is_omni = (gt == LIGHT_GEOM_POINT) & (ld['dist_type'] == LIGHT_DIST_OMNI)
    has_ies_out = jnp.where(gt == LIGHT_GEOM_DIRECT, False, has_ies)

    if meta.env_enable_sam:
        # env light importance sample (integrator_pt_lgt.cpp:30-55)
        is_env = gt == LIGHT_GEOM_ENV
        tcs, map_pdf = _sample_map_2d(scene, rands3, ld['pdf_table_offset'],
                                      jnp.maximum(ld['pdf_table_size_x'], 1),
                                      jnp.maximum(ld['pdf_table_size_y'], 1))
        tc_t = mul_rows_2x4(ld['sam_row0_inv'], ld['sam_row1_inv'], tcs)
        sdir, sintheta = tex_coord_2d_to_sphere_map(tc_t)
        env_pos = illum_point + sdir * 1000.0
        env_pdf = map_pdf / (2.0 * M_PI * M_PI * jnp.maximum(jnp.abs(sintheta), 1e-20))
        pos = jnp.where(is_env[..., None], env_pos, pos)
        norm = jnp.where(is_env[..., None], sdir, norm)
        pdf = jnp.where(is_env, env_pdf, pdf)
        is_omni = is_omni | is_env
        has_ies_out = jnp.where(is_env, False, has_ies_out)

    return dict(pos=pos, norm=norm, pdf=pdf, is_omni=is_omni, has_ies=has_ies_out)


def light_pdf_select_rev(meta: SceneMeta):
    """LightPdfSelectRev: uniform 1/N (integrator_pt_lgt.cpp:60-63)."""
    return 1.0 / float(max(meta.num_lights, 1))


def light_eval_pdf(scene: Scene, meta: SceneMeta, light_id, illum_point, ray_dir,
                   lpos, lnorm, env_pdf):
    """LightEvalPDF (integrator_pt_lgt.cpp:71-107)."""
    ld = gather_light(scene, light_id)
    gt = ld['geom_type']
    hit_dist = jnp.sqrt(jnp.sum((illum_point - lpos) ** 2, -1))
    cos_tmp = dot(ray_dir, -lnorm)

    dir_to_v = normalize(lpos - illum_point)
    cos_sphere = jnp.abs(dot(dir_to_v, lnorm))
    cos_point = jnp.where(ld['dist_type'] == LIGHT_DIST_LAMBERT,
                          jnp.maximum(cos_tmp, 0.0), 1.0)
    cos_area = jnp.where(ld['ies_id'] < 0, jnp.maximum(cos_tmp, 0.0),
                         jnp.abs(cos_tmp))
    cos_val = jnp.where(gt == LIGHT_GEOM_SPHERE, cos_sphere,
              jnp.where(gt == LIGHT_GEOM_POINT, cos_point, cos_area))
    pdf = pdf_a_to_w(ld['pdf_a'], hit_dist, cos_val)
    return jnp.where(gt == LIGHT_GEOM_ENV, env_pdf, pdf)


def light_intensity(scene: Scene, meta: SceneMeta, light_id, wavelengths,
                    ray_pos, ray_dir):
    """LightIntensity (integrator_pt_lgt.cpp:109-173)."""
    ld = gather_light(scene, light_id)
    color = ld['intensity']

    if meta.spectral_mode:
        has_spd = ld['spec_id'] >= 0
        off = scene.spec_offset_sz[jnp.clip(ld['spec_id'], 0, scene.spec_offset_sz.shape[0] - 1), 0]
        sampled = SPEC.sample_uniform_spectrum(scene.spec_values, off, wavelengths)
        color = jnp.where(has_spd[..., None], sampled, color)
    color = color * ld['mult'][..., None]

    # IES modulation — trace-time gated (KSPEC_LIGHT_IES analog): never
    # emit the texture taps for scenes without IES profiles
    if meta.has_ies:
        has_ies = ld['ies_id'] >= 0
        ies_dir = jnp.where(((ld['flags'] & LIGHT_FLAG_POINT_AREA) != 0)[..., None],
                            normalize(ld['pos'][..., :3] - ray_pos), ray_dir)
        dir_trans = mul4x4_vec(ld['ies_matrix'],
                               jnp.concatenate([ies_dir, jnp.zeros_like(ies_dir[..., :1])], -1))[..., :3]
        tc_ies, _ = sphere_map_to_2d_tex_coord(-dir_trans)
        ies_col = TEX.sample(scene.textures, jnp.maximum(ld['ies_id'], 0), tc_ies)
        color = jnp.where(has_ies[..., None], color * ies_col, color)

    # spot cone + projective texture (integrator_pt_lgt.cpp:145-162)
    if meta.has_spot:
        is_spot = ld['dist_type'] == LIGHT_DIST_SPOT
        cos_theta = jnp.maximum(-dot(ray_dir, ld['norm'][..., :3]), 0.0)
        tval = jnp.clip((cos_theta - ld['cos2']) / jnp.maximum(ld['cos1'] - ld['cos2'], 1e-20), 0.0, 1.0)
        smooth = tval * tval * (3.0 - 2.0 * tval)
        color = jnp.where(is_spot[..., None], color * smooth[..., None], color)

        if meta.has_proj:
            is_proj = is_spot & ((ld['flags'] & LIGHT_FLAG_PROJECTIVE) != 0) & (ld['tex_id'] >= 0)
            pos_clip = mul4x4_vec(ld['ies_matrix'],
                                  jnp.concatenate([ray_pos, jnp.ones_like(ray_pos[..., :1])], -1))
            ndc = pos_clip[..., :3] / jnp.where(pos_clip[..., 3:4] == 0, 1.0, pos_clip[..., 3:4])
            shadow_tc = ndc[..., :2] * 0.5 + 0.5
            proj_col = TEX.sample(scene.textures, jnp.maximum(ld['tex_id'], 0), shadow_tc)
            color = jnp.where(is_proj[..., None], color * proj_col, color)

    # env texture (for visible env lights sampled explicitly).  Gate on the
    # light's geom type, NOT ~is_spot — is_spot only exists under has_spot
    # (env + no-spot scenes crashed on the unbound local before r4)
    if meta.has_env_map:
        is_env_tex = (ld['geom_type'] == LIGHT_GEOM_ENV) & (ld['tex_id'] >= 0)
        tc_env, _ = sphere_map_to_2d_tex_coord(ray_dir)
        tc_env_t = mul_rows_2x4(ld['sam_row0'], ld['sam_row1'], tc_env)
        env_col = TEX.sample(scene.textures, jnp.maximum(ld['tex_id'], 0), tc_env_t)
        color = jnp.where(is_env_tex[..., None], color * env_col, color)

    return color


def environment_color(scene: Scene, meta: SceneMeta, a_dir, wavelengths,
                      mis_pt: bool):
    """EnvironmentColor (integrator_pt_lgt.cpp:175-215).

    Returns (color [N,4], env_pdf [N]).
    """
    N = a_dir.shape[0]
    color = jnp.broadcast_to(scene.env_color, (N, 4))
    out_pdf = jnp.ones((N,), jnp.float32)

    if meta.spectral_mode:
        has_spd = scene.env_spec_id >= 0
        off = scene.spec_offset_sz[jnp.clip(scene.env_spec_id, 0, scene.spec_offset_sz.shape[0] - 1), 0]
        sampled = SPEC.sample_uniform_spectrum(
            scene.spec_values, jnp.broadcast_to(off, (N,)), wavelengths)
        sampled = sampled * scene.env_spec_mult / 106.856895
        color = jnp.where(has_spd, sampled, color)

    if meta.has_env_map:
        tc, sin_theta = sphere_map_to_2d_tex_coord(a_dir)
        tc_t = mul_rows_2x4(jnp.broadcast_to(scene.env_sam_row0, (N, 4)),
                            jnp.broadcast_to(scene.env_sam_row1, (N, 4)), tc)
        if meta.env_enable_sam and mis_pt:
            lid = jnp.broadcast_to(scene.env_light_id, (N,))
            ld = gather_light(scene, lid)
            map_pdf = _eval_map_2d_pdf(scene, tc_t, ld['pdf_table_offset'],
                                       jnp.maximum(ld['pdf_table_size_x'], 1),
                                       jnp.maximum(ld['pdf_table_size_y'], 1))
            pdf = map_pdf / (2.0 * M_PI * M_PI * jnp.maximum(jnp.abs(sin_theta), 1e-20))
            out_pdf = jnp.where(sin_theta != 0.0, pdf, out_pdf)
        tex_col = TEX.sample(scene.textures, jnp.maximum(scene.env_tex_id, 0), tc_t)
        color = color * tex_col
    return color, out_pdf
