"""Batched path-tracing integrators (naive / shadow / MIS).

The reference's per-thread hot loop (SURVEY.md §3.1, integrator_pt.cpp:719-758)
becomes ONE jitted program over a ``[N]`` ray batch: init eye rays ->
``trace_depth`` x (trace -> NEE -> next bounce) -> env -> contribute, with
dead-ray masking replacing ``break`` and masked RNG updates keeping the
random streams identical to the reference's per-thread sequences.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import lmath as LM
from ..ops import rng as RNG
from ..ops import texture as TEX
from ..ops import spectrum as SPEC
from ..accel import traverse as ACC
from ..accel import two_level as TL2
from ..accel import traverse_gpu as TGPU
from ..bsdf import common as C
from ..bsdf import dispatch as MAT
from ..scene.build import (
    Scene, SceneMeta, MAT_TYPE_LIGHT_SOURCE, EMISSION_COLOR,
    LIGHT_GEOM_DIRECT, LIGHT_GEOM_POINT, LIGHT_GEOM_SPHERE,
)
from .. import lights as LGT

INTEGRATOR_STUPID_PT = 0
INTEGRATOR_SHADOW_PT = 1
INTEGRATOR_MIS_PT = 2

FB_COLOR = 0
FB_DIRECT = 1
FB_INDIRECT = 2

_F32MAX = LM.FLT_MAX


def _is_dead(flags):
    return (flags & jnp.uint32(C.RAY_FLAG_IS_DEAD)) != 0


def _is_out_of_scene(flags):
    return (flags & jnp.uint32(C.RAY_FLAG_OUT_OF_SCENE)) != 0


def _has_non_spec(flags):
    return (flags & jnp.uint32(C.RAY_FLAG_HAS_NON_SPEC)) != 0


def _pack_mat_id(flags, mat_id):
    return (flags & jnp.uint32(0xFF000000)) | (mat_id.astype(jnp.uint32) & jnp.uint32(0x00FFFFFF))


def _extract_mat_id(flags):
    return (flags & jnp.uint32(0x00FFFFFF)).astype(jnp.int32)


class RayState(NamedTuple):
    ray_pos: jnp.ndarray       # [N,3]
    ray_dir: jnp.ndarray       # [N,3]
    flags: jnp.ndarray         # [N] u32 (top byte flags, low 24 bits matId)
    accum_color: jnp.ndarray   # [N,4]
    throughput: jnp.ndarray    # [N,4]
    mis_pdf: jnp.ndarray       # [N]
    mis_cos: jnp.ndarray       # [N]
    mis_ior: jnp.ndarray       # [N]
    wavelengths: jnp.ndarray   # [N,4]
    time: jnp.ndarray          # [N]
    rng: jnp.ndarray           # [N,2] u32
    # hit surface (filled by trace)
    hit_pos: jnp.ndarray       # [N,3]
    hit_norm: jnp.ndarray      # [N,3]
    hit_tang: jnp.ndarray      # [N,3]
    hit_uv: jnp.ndarray        # [N,2]
    hit_dist: jnp.ndarray      # [N]
    hit_inst: jnp.ndarray      # [N] i32


def _morton10(q):
    """Spread 10-bit ints to every 3rd bit (30-bit 3D Morton component)."""
    q = (q | (q << 16)) & 0x030000FF
    q = (q | (q << 8)) & 0x0300F00F
    q = (q | (q << 4)) & 0x030C30C3
    q = (q | (q << 2)) & 0x09249249
    return q


def _permute_state(state: RayState, orig, perm):
    """Apply a row permutation to the whole ray state with ONE row gather
    of the state packed into an [N, 39] f32 matrix (ints bitcast, exact)."""
    N = orig.shape[0]
    arrs = list(state) + [orig]

    def to_f32(a):
        a2 = a.reshape(N, -1)
        if a2.dtype != jnp.float32:
            a2 = jax.lax.bitcast_convert_type(a2, jnp.float32)
        return a2

    cols = [to_f32(a) for a in arrs]
    widths = [c.shape[1] for c in cols]
    flat = jnp.concatenate(cols, axis=1)[perm]
    out = []
    off = 0
    for a, w in zip(arrs, widths):
        c = flat[:, off:off + w]
        off += w
        if a.dtype != jnp.float32:
            c = jax.lax.bitcast_convert_type(c, a.dtype)
        out.append(c.reshape(a.shape))
    return RayState(*out[:-1]), out[-1]


def _sort_rays_for_trace(state: RayState, orig):
    """Bounce-ray coherence sort for the per-ray kernel: a kernel block
    loops while any of its lanes is walking, so live rays are packed into
    coherent blocks before every secondary trace and dead rays sort to the
    end, where their blocks exit at once (the wavefront compaction idea,
    kmake_wave.json:11, without moving rays between dispatches).

    Key: direction octant, then origin along a 27-bit Morton curve over the
    batch's extent.  ``orig`` tracks each row's original position so
    callers can invert the permutation at pass end.  Returns (state, orig)."""
    d = state.ray_dir
    p = state.ray_pos
    octant = ((d[:, 0] > 0).astype(jnp.int32) * 4
              + (d[:, 1] > 0).astype(jnp.int32) * 2
              + (d[:, 2] > 0).astype(jnp.int32))
    # origin quantized against a 512^3 lattice of the batch's rough extent
    # (9 bits/axis -> 27-bit Morton, so the octant bits at 27..29 stay
    # disjoint from the Morton code); out-of-range clamps are harmless
    lo = jnp.min(p, axis=0, keepdims=True)
    hi = jnp.max(p, axis=0, keepdims=True)
    q = jnp.clip(((p - lo) / jnp.maximum(hi - lo, 1e-6) * 511.0), 0, 511
                 ).astype(jnp.int32)
    key = (_morton10(q[:, 0]) | (_morton10(q[:, 1]) << 1)
           | (_morton10(q[:, 2]) << 2))
    # octant above morton; dead rays above everything
    key = key | (octant << 27)
    key = jnp.where(_is_dead(state.flags), jnp.int32(0x7FFFFFFF), key)
    perm = jnp.argsort(key)
    return _permute_state(state, orig, perm)


def _intersect_spherical_element(radius, z_center, pos, d):
    """IntersectSphericalElement (integrator_pt.cpp:852-874), batched.

    radius/z_center are python floats (static lens data). Returns (t, n, ok).
    """
    o = pos - jnp.array([0.0, 0.0, z_center], jnp.float32)
    a = jnp.sum(d * d, -1)
    b = 2.0 * jnp.sum(d * o, -1)
    c = jnp.sum(o * o, -1) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / a
    t1 = c / jnp.where(q == 0.0, 1e-20, q)
    lo, hi = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
    use_closer = (d[..., 2] > 0.0) != (radius < 0.0)
    t = jnp.where(use_closer, lo, hi)
    ok = ok & (t >= 0.0)
    n = LM.normalize(o + t[..., None] * d)
    n = jnp.where((LM.dot(n, -d) < 0.0)[..., None], -n, n)  # faceforward
    return t, n, ok


def _refract_pbrt(wi, n, eta):
    """Refract (integrator_pt.cpp:835-845): wi points AWAY from surface."""
    cos_i = LM.dot(n, wi)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wt = eta * -wi + (eta * cos_i - cos_t)[..., None] * n
    return wt, ok


def trace_lenses_from_film(meta: SceneMeta, ray_pos, ray_dir):
    """TraceLensesFromFilm (integrator_pt.cpp:876-938): the full spherical
    lens stack, unrolled over the static element list. Returns
    (pos, dir, ok) in camera space."""
    flip = jnp.array([1.0, 1.0, -1.0], jnp.float32)
    pos = ray_pos * flip
    d = ray_dir * flip
    ok = jnp.ones(pos.shape[:-1], bool)
    lines = meta.lens_lines
    element_z = 0.0
    for i, (curv, thick, eta_i, aper) in enumerate(lines):
        element_z -= thick
        if curv == 0.0:  # aperture stop
            ok = ok & (d[..., 2] < 0.0)
            t = (element_z - pos[..., 2]) / jnp.where(d[..., 2] == 0.0, -1e-20,
                                                      d[..., 2])
            n = None
        else:
            t, n, hit = _intersect_spherical_element(curv, element_z + curv,
                                                     pos, d)
            ok = ok & hit
        p_hit = pos + t[..., None] * d
        r2 = p_hit[..., 0] ** 2 + p_hit[..., 1] ** 2
        ok = ok & (r2 <= aper * aper)
        pos = jnp.where(ok[..., None], p_hit, pos)
        if curv != 0.0:
            eta_t = lines[i + 1][2] if i + 1 < len(lines) else 1.0
            if eta_t == 0.0:
                eta_t = 1.0
            wt, rok = _refract_pbrt(LM.normalize(-d), n, eta_i / eta_t)
            ok = ok & rok
            d = jnp.where(ok[..., None], wt, d)
    return pos * flip, d * flip, ok


def sample_camera_ray(scene: Scene, meta: SceneMeta, rng_state, xs, ys,
                      qmc_ctx=None):
    """SampleCameraRay (integrator_pt.cpp:44-126): pixel jitter + thin lens.

    With ``qmc_ctx`` (IntegratorQMC, mlt/integrator_qmc.cpp:148-216): the
    pixel position itself comes from QMC dims 0/1 and is RETURNED for
    scatter-style contribution; lens dims 2/3 replace the DoF randoms.
    """
    rng_state, pixel_offsets = RNG.rnd_lens(rng_state)
    if qmc_ctx is not None and 'mlt_rands' in qmc_ctx:
        # Kelemen MLT: all randoms served from the chain's primary-sample
        # vector (IntegratorKMLT::GetRandomNumbers*, integrator_kmlt.cpp:87-151)
        mr = qmc_ctx['mlt_rands']
        pixel_offsets = mr[..., 0:4]
        x_norm = pixel_offsets[..., 0]
        y_norm = pixel_offsets[..., 1]
        xs = jnp.minimum((x_norm * meta.width).astype(jnp.int32), meta.width - 1)
        ys = jnp.minimum((y_norm * meta.height).astype(jnp.int32), meta.height - 1)
    elif qmc_ctx is not None:
        from ..ops import qmc as QMC
        table, idx = qmc_ctx['table'], qmc_ctx['idx']
        ox = QMC.rnd_float(table, idx, 0)
        oy = QMC.rnd_float(table, idx, 1)
        if meta.cam_lens_radius > 0.0:
            oz = QMC.rnd_float(table, idx, 2)
            ow = QMC.rnd_float(table, idx, 3)
        else:
            oz, ow = pixel_offsets[..., 2], pixel_offsets[..., 3]
        pixel_offsets = jnp.stack([ox, oy, oz, ow], -1)
        x_norm = pixel_offsets[..., 0]
        y_norm = pixel_offsets[..., 1]
        xs = jnp.minimum((x_norm * meta.width).astype(jnp.int32), meta.width - 1)
        ys = jnp.minimum((y_norm * meta.height).astype(jnp.int32), meta.height - 1)
    else:
        fx = xs.astype(jnp.float32) + pixel_offsets[..., 0]
        fy = ys.astype(jnp.float32) + pixel_offsets[..., 1]
        x_norm = fx / float(meta.width)
        y_norm = fy / float(meta.height)

    ray_dir = LM.eye_ray_dir_normalized(x_norm, y_norm, scene.proj_inv)
    ray_pos = jnp.zeros_like(ray_dir)

    if meta.cam_lens_radius > 0.0:
        t_focus = meta.cam_target_dist / (-ray_dir[..., 2])
        focus_pos = ray_pos + ray_dir * t_focus[..., None]
        xy = meta.cam_lens_radius * 2.0 * LM.map_samples_to_disc(
            pixel_offsets[..., 2:4] - 0.5)
        ray_pos = ray_pos.at[..., 0].add(xy[..., 0]).at[..., 1].add(xy[..., 1])
        ray_dir = LM.normalize(focus_pos - ray_pos)
    elif len(meta.lens_lines) > 0:
        # optics simulator (SampleCameraRay, integrator_pt.cpp:78-103):
        # film point from pixel coords, shoot at the rear lens element,
        # trace the full stack; failed rays shoot under the floor.
        fx = 0.25 * meta.phys_size[0] * (2.0 * x_norm - 1.0)
        fy = 0.25 * meta.phys_size[1] * (2.0 * y_norm - 1.0)
        film_pos = jnp.stack([fx, fy, jnp.zeros_like(fx)], -1)
        rear_z = meta.lens_lines[0][1]
        rear_r = meta.lens_lines[0][3]
        rare = rear_r * 2.0 * LM.map_samples_to_disc(
            pixel_offsets[..., 2:4] - 0.5)
        shoot_to = jnp.stack([rare[..., 0], rare[..., 1],
                              jnp.full_like(fx, rear_z)], -1)
        dir_f = LM.normalize(shoot_to - film_pos)
        pos_o, dir_o, ok = trace_lenses_from_film(meta, film_pos, dir_f)
        miss_pos = jnp.array([0.0, -1e7, 0.0], jnp.float32)
        miss_dir = jnp.array([0.0, -1.0, 0.0], jnp.float32)
        ray_pos = jnp.where(ok[..., None], -pos_o, miss_pos)
        ray_dir = jnp.where(ok[..., None], -LM.normalize(dir_o), miss_dir)

    time = jnp.zeros_like(x_norm)
    if meta.has_motion:
        rng_state, time = RNG.rnd_time(rng_state)
    wave_sam = jnp.ones_like(x_norm)
    if meta.spectral_mode:
        rng_state, wave_sam = RNG.rnd_spec(rng_state)
        if qmc_ctx is not None and 'mlt_rands' in qmc_ctx:
            wave_sam = qmc_ctx['mlt_rands'][..., 4]
        elif qmc_ctx is not None and qmc_ctx.get('spd_dim', 0):
            from ..ops import qmc as QMC
            wave_sam = QMC.rnd_float(qmc_ctx['table'], qmc_ctx['idx'],
                                     qmc_ctx['spd_dim'])
    return rng_state, ray_pos, ray_dir, time, wave_sam, xs, ys


def kernel_init_eye_ray(scene: Scene, meta: SceneMeta, rng_state, pixel_ids,
                        qmc_ctx=None):
    """kernel_InitEyeRay2 (integrator_pt.cpp:129-157).

    Returns (state, out_pixel_ids) — out ids differ from input under QMC.
    """
    N = pixel_ids.shape[0]
    xs = pixel_ids % meta.width
    ys = pixel_ids // meta.width
    rng_state, ray_pos, ray_dir, time, wave_sam, xs, ys = sample_camera_ray(
        scene, meta, rng_state, xs, ys, qmc_ctx)
    out_pixel_ids = ys * meta.width + xs

    if meta.spectral_mode:
        wavelengths = SPEC.sample_wavelengths(wave_sam)
    else:
        wavelengths = jnp.zeros((N, 4), jnp.float32)

    ray_pos, ray_dir = LM.transform_ray3f(scene.world_view_inv, ray_pos, ray_dir)
    zeros3 = jnp.zeros((N, 3), jnp.float32)
    return RayState(
        ray_pos=ray_pos, ray_dir=ray_dir,
        flags=jnp.zeros((N,), jnp.uint32),
        accum_color=jnp.zeros((N, 4), jnp.float32),
        throughput=jnp.ones((N, 4), jnp.float32),
        mis_pdf=jnp.ones((N,), jnp.float32),
        mis_cos=jnp.ones((N,), jnp.float32),
        mis_ior=jnp.ones((N,), jnp.float32),
        wavelengths=wavelengths, time=time, rng=rng_state,
        hit_pos=zeros3, hit_norm=zeros3, hit_tang=zeros3,
        hit_uv=jnp.zeros((N, 2), jnp.float32),
        hit_dist=jnp.zeros((N,), jnp.float32),
        hit_inst=jnp.zeros((N,), jnp.int32)), out_pixel_ids


def _remap_material_id(scene: Scene, mat_id, inst_id):
    """RemapMaterialId (integrator_pt_mat.cpp:530-573), vectorized binary search."""
    remap_list_id = scene.remap_inst[
        jnp.clip(inst_id, 0, scene.remap_inst.shape[0] - 1), 0]
    has_remap = remap_list_id >= 0
    rl = jnp.maximum(remap_list_id, 0)
    base = scene.all_remap_lists_size
    r_offset = scene.all_remap_lists[base + rl]
    r_size = scene.all_remap_lists[base + rl + 1] - r_offset

    lo = jnp.zeros_like(mat_id)
    hi = r_size - 1
    for _ in range(20):
        valid = lo <= hi
        mid = lo + (hi - lo) // 2
        from_id = scene.all_remap_lists[r_offset + jnp.clip(mid, 0, None) * 2]
        go_left = from_id >= mat_id
        hi = jnp.where(valid & go_left, mid - 1, hi)
        lo = jnp.where(valid & ~go_left, mid + 1, lo)
    pos = hi + 1
    in_range = pos < r_size
    from_id = scene.all_remap_lists[r_offset + jnp.clip(pos, 0, None) * 2]
    to_id = scene.all_remap_lists[r_offset + jnp.clip(pos, 0, None) * 2 + 1]
    remapped = jnp.where(in_range & (from_id == mat_id), to_id, mat_id)
    return jnp.where(has_remap, remapped, mat_id)


def kernel_ray_trace(scene: Scene, meta: SceneMeta, state: RayState, bounce: int
                     ) -> RayState:
    """kernel_RayTrace2 (integrator_pt.cpp:214-348): nearest hit + shading prep."""
    live = ~_is_dead(state.flags)
    N = state.ray_pos.shape[0]
    t_min = jnp.zeros((N,), jnp.float32)
    t_max = jnp.where(live, _F32MAX, 0.0)  # dead rays trace nothing

    if meta.use_two_level:
        # two-level BLAS/TLAS query with matrix-lerped motion
        # (RayQuery_NearestHitMotion, CrossRT.h:160-174)
        tlv = scene.two_level
        time = state.time
        ht, tri_g, inst_id, hu, hv = TL2.intersect_two_level(
            tlv, state.ray_pos, state.ray_dir, t_min, t_max, time=time)
        found = tri_g >= 0
        hit_pos = state.ray_pos + (ht * (1.0 - 1e-6))[..., None] * state.ray_dir
        safe_tri = jnp.maximum(tri_g, 0)
        safe_inst = jnp.maximum(inst_id, 0)
        geom = tlv.inst_geom[safe_inst]
        prim = tlv.obj_prim_id[safe_tri]
        mv = scene.mat_vert_offset[geom]
        tri_off = mv[..., 0] + prim
        vert_off = mv[..., 1]
        tidx = scene.tri_indices.astype(jnp.int32)
        ia = tidx[tri_off * 3 + 0] + vert_off
        ib = tidx[tri_off * 3 + 1] + vert_off
        ic = tidx[tri_off * 3 + 2] + vert_off
        wa = (1.0 - hu - hv)[..., None]
        wb = hu[..., None]
        wc = hv[..., None]
        data = (wa * scene.vdata[ia] + wb * scene.vdata[ib]
                + wc * scene.vdata[ic])
        # motion normals: transform by BOTH endpoint normal matrices and
        # lerp the results — the reference's exact recipe
        # (integrator_pt.cpp:285-292 lerps hitNorm/hitNorm2 by time)
        nm0 = tlv.inst_nm0[safe_inst].reshape(-1, 4, 4)
        n0 = LM.mul3x3(nm0, data[..., 0:3])
        t0g = LM.mul3x3(nm0, data[..., 4:7])
        if meta.has_motion:
            nm1 = tlv.inst_nm1[safe_inst].reshape(-1, 4, 4)
            n1 = LM.mul3x3(nm1, data[..., 0:3])
            t1g = LM.mul3x3(nm1, data[..., 4:7])
            hit_norm = n0 + time[..., None] * (n1 - n0)
            hit_tang = t0g + time[..., None] * (t1g - t0g)
        else:
            hit_norm, hit_tang = n0, t0g
        hit_uv = jnp.stack([data[..., 3], data[..., 7]], -1)
        mid0 = scene.mat_id_by_prim[tri_off]
        mid = _remap_material_id(scene, mid0, inst_id)
        hit_t = ht
        hit_inst_id = inst_id
    else:
        motion = ((scene.tri_dv0, scene.tri_de1, scene.tri_de2, state.time)
                  if meta.has_motion else None)
        if meta.use_kernel:
            pt, ptri, pu, pv = TGPU.intersect(
                scene.kn_nodes, scene.kn_tris, state.ray_pos, state.ray_dir,
                t_min, t_max, interpret=meta.kernel_interpret)
            pfound = ptri >= 0
            safe = jnp.maximum(ptri, 0)
            hit = ACC.Hit(
                t=pt,
                prim_id=jnp.where(pfound, scene.tri_prim_id[safe], -1),
                inst_id=jnp.where(pfound, scene.tri_inst_id[safe], -1),
                geom_id=jnp.where(pfound, scene.tri_geom_id[safe], -1),
                u=pu, v=pv, soup_id=ptri)
        elif meta.use_bvh:
            bvh = dict(bmin=scene.bvh_bmin, bmax=scene.bvh_bmax, skip=scene.bvh_skip,
                       tri_offset=scene.bvh_tri_offset, tri_count=scene.bvh_tri_count)
            hit = ACC.intersect_bvh(
                bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2,
                scene.tri_inst_id, scene.tri_geom_id, scene.tri_prim_id,
                state.ray_pos, state.ray_dir, t_min, t_max, motion=motion)
        else:
            hit = ACC.intersect_brute(
                scene.tri_v0, scene.tri_e1, scene.tri_e2,
                scene.tri_inst_id, scene.tri_geom_id, scene.tri_prim_id,
                state.ray_pos, state.ray_dir, t_min, t_max, motion=motion)

        found = hit.geom_id >= 0
        hit_pos = state.ray_pos + (hit.t * (1.0 - 1e-6))[..., None] * state.ray_dir

        # baked world-space shading row: ONE gather [T,32] instead of
        # tri_indices x3 + vdata x3 + norm_matrix (the reference's layout,
        # integrator_pt.cpp:263-292, kept in scene.vdata for the two-level/
        # motion path)
        soup = jnp.maximum(hit.soup_id, 0)
        shade = scene.tri_shade[soup]                  # [N,32]
        if meta.has_motion:
            # normal/tangent lerp between the two endpoint matrices
            # (integrator_pt.cpp:285-292)
            shade = shade + state.time[..., None] * scene.tri_shade_d[soup]
        # CRT coords: u = weight(B), v = weight(C); barycentric lerp matching
        # integrator_pt.cpp:270-271 (data = (1-u-v)*A + u*B + v*C)
        wa = (1.0 - hit.u - hit.v)[..., None]
        wb = hit.u[..., None]
        wc = hit.v[..., None]
        data = wa * shade[..., 0:8] + wb * shade[..., 8:16] + wc * shade[..., 16:24]
        hit_norm = data[..., 0:3]
        hit_tang = data[..., 4:7]
        hit_uv = jnp.stack([data[..., 3], data[..., 7]], -1)
        mid = shade[..., 24].astype(jnp.int32)  # matId baked in the shade row
        hit_t = hit.t
        hit_inst_id = hit.inst_id

    hit_norm = LM.normalize(hit_norm)
    hit_tang = LM.normalize(hit_tang)

    flip = jnp.where(LM.dot(state.ray_dir, hit_norm) > 0.001, -1.0, 1.0)
    hit_norm = flip[..., None] * hit_norm
    hit_tang = flip[..., None] * hit_tang

    flags = state.flags
    inv_flag = jnp.uint32(C.RAY_FLAG_HAS_INV_NORMAL)
    flags = jnp.where(flip < 0.0, flags | inv_flag, flags & ~inv_flag)

    flags_hit = _pack_mat_id(flags, mid)

    miss_add = jnp.uint32(C.RAY_FLAG_IS_DEAD | C.RAY_FLAG_OUT_OF_SCENE
                          | (C.RAY_FLAG_PRIME_RAY_MISS if bounce == 0 else 0))
    flags_miss = state.flags | miss_add

    new_flags = jnp.where(live, jnp.where(found, flags_hit, flags_miss), state.flags)
    keep = (~live | ~found)[..., None]
    return state._replace(
        flags=new_flags,
        hit_pos=jnp.where(keep, state.hit_pos, hit_pos),
        hit_norm=jnp.where(keep, state.hit_norm, hit_norm),
        hit_tang=jnp.where(keep, state.hit_tang, hit_tang),
        hit_uv=jnp.where(keep, state.hit_uv, hit_uv),
        hit_dist=jnp.where(keep[..., 0], state.hit_dist, hit_t),
        hit_inst=jnp.where(keep[..., 0], state.hit_inst, hit_inst_id))


def kernel_sample_light_source(scene: Scene, meta: SceneMeta, state: RayState,
                               bounce: int, integrator_type: int, render_layer: int,
                               qmc_ctx=None, shading_ctx=None,
                               return_count: bool = False):
    """kernel_SampleLightSource (integrator_pt.cpp:350-424).

    Returns (shade_color [N,4], new_rng); with ``return_count`` also the
    number of shadow rays actually traced (live & in_illum lanes).
    """
    N = state.ray_pos.shape[0]
    live = ~_is_dead(state.flags)
    rng_state, rands = RNG.rnd_lgts(state.rng, live)
    if qmc_ctx is not None and 'mlt_rands' in qmc_ctx:
        mr = qmc_ctx['mlt_rands']
        b_dyn = qmc_ctx.get('bounce_dyn', bounce)
        off = 6 + b_dyn * 10 + 0   # BOUNCE_START + b*PER_BOUNCE + LGHT_ID
        rands = jax.lax.dynamic_slice_in_dim(mr, off, 4, axis=-1)
    elif qmc_ctx is not None and bounce == 0 and qmc_ctx.get('lgt_dim', 0):
        from ..ops import qmc as QMC
        table, idx, d0 = qmc_ctx['table'], qmc_ctx['idx'], qmc_ctx['lgt_dim']
        rands = jnp.stack([QMC.rnd_float(table, idx, d0),
                           QMC.rnd_float(table, idx, d0 + 1),
                           rands[..., 2],
                           QMC.rnd_float(table, idx, d0 + 2)], -1)
    if meta.num_lights == 0:
        if return_count:
            return jnp.zeros((N, 4), jnp.float32), rng_state, jnp.float32(0)
        return jnp.zeros((N, 4), jnp.float32), rng_state

    light_id = jnp.minimum((rands[..., 3] * meta.num_lights).astype(jnp.int32),
                           meta.num_lights - 1)
    lsam = LGT.light_sample_rev(scene, meta, light_id, rands[..., :3], state.hit_pos)
    hit_dist = jnp.sqrt(jnp.sum((state.hit_pos - lsam['pos']) ** 2, -1))
    shadow_dir = LM.normalize(lsam['pos'] - state.hit_pos)
    offs = jnp.maximum(LM.maxcomp(state.hit_pos), 1.0) * 5e-6
    shadow_pos = state.hit_pos + state.hit_norm * offs[..., None]

    in_illum = (LM.dot(shadow_dir, lsam['norm']) < 0.0) | lsam['is_omni'] | lsam['has_ies']
    need_trace = live & in_illum
    s_tmax = jnp.where(need_trace, hit_dist * 0.9995, 0.0)
    s_tmin = jnp.zeros((N,), jnp.float32)
    if meta.use_two_level:
        _, stri, _, _, _ = TL2.intersect_two_level(
            scene.two_level, shadow_pos, shadow_dir, s_tmin, s_tmax,
            time=state.time, any_hit=True)
        occluded = stri >= 0
    elif meta.use_kernel:
        _, stri, _, _ = TGPU.intersect(
            scene.kn_nodes, scene.kn_tris, shadow_pos, shadow_dir, s_tmin,
            s_tmax, any_hit=True, interpret=meta.kernel_interpret)
        occluded = stri >= 0
    else:
        motion = ((scene.tri_dv0, scene.tri_de1, scene.tri_de2, state.time)
                  if meta.has_motion else None)
        if meta.use_bvh:
            bvh = dict(bmin=scene.bvh_bmin, bmax=scene.bvh_bmax, skip=scene.bvh_skip,
                       tri_offset=scene.bvh_tri_offset, tri_count=scene.bvh_tri_count)
            occluded = ACC.any_hit_bvh(
                bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_geom_id,
                shadow_pos, shadow_dir, s_tmin, s_tmax, motion=motion)
        else:
            occluded = ACC.any_hit_brute(
                scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_geom_id,
                shadow_pos, shadow_dir, s_tmin, s_tmax, motion=motion)
    need_shade = need_trace & ~occluded

    mat_id = _extract_mat_id(state.flags)
    bsdf = MAT.material_eval(scene, meta, mat_id, state.wavelengths,
                             shadow_dir, -state.ray_dir,
                             state.hit_norm, state.hit_tang, state.hit_uv,
                             ctx=shading_ctx)
    cos_out = jnp.maximum(LM.dot(shadow_dir, state.hit_norm), 0.0)

    lgt_pdf_w = LGT.light_pdf_select_rev(meta) * LGT.light_eval_pdf(
        scene, meta, light_id, shadow_pos, shadow_dir, lsam['pos'], lsam['norm'],
        lsam['pdf'])
    mis = (LM.mis_weight_heuristic(lgt_pdf_w, bsdf['pdf'])
           if integrator_type == INTEGRATOR_MIS_PT else jnp.ones((N,), jnp.float32))

    gt = LGT.gather_light(scene, light_id)['geom_type']
    is_direct = gt == LIGHT_GEOM_DIRECT
    is_point = gt == LIGHT_GEOM_POINT
    mis = jnp.where(is_direct | is_point, 1.0, mis)
    lgt_pdf_w = jnp.where(is_direct, 1.0, lgt_pdf_w)

    if render_layer != FB_COLOR:
        is_direct_light = ~_has_non_spec(state.flags)
        if render_layer == FB_DIRECT:
            mis = jnp.where(~is_direct_light, 0.0, mis)
        elif render_layer == FB_INDIRECT:
            mis = jnp.where(is_direct_light, 0.0, mis)

    light_color = LGT.light_intensity(scene, meta, light_id, state.wavelengths,
                                      shadow_pos, shadow_dir)
    shade = (light_color * bsdf['val'] / jnp.maximum(lgt_pdf_w, 1e-30)[..., None]
             * (cos_out * mis)[..., None])
    shade = jnp.where(need_shade[..., None], shade, 0.0)
    if return_count:
        return shade, rng_state, jnp.sum(need_trace.astype(jnp.float32))
    return shade, rng_state


def kernel_next_bounce(scene: Scene, meta: SceneMeta, state: RayState, bounce: int,
                       shade_color, integrator_type: int, render_layer: int,
                       qmc_ctx=None, shading_ctx=None) -> RayState:
    """kernel_NextBounce (integrator_pt.cpp:426-548)."""
    live = ~_is_dead(state.flags)
    mat_id = _extract_mat_id(state.flags)
    if shading_ctx is not None:
        md = shading_ctx['md']
        tex_color = shading_ctx['tex_color']
    else:
        md = MAT.gather_material(scene, mat_id)
        tex_color = MAT.slot0_tex_color(scene, meta, md, mat_id, state.hit_uv)
    md_mtype = md['mtype']
    is_light_mat = md_mtype == jnp.uint32(MAT_TYPE_LIGHT_SOURCE)

    # ---- light-hit branch (integrator_pt.cpp:461-506) ----------------------
    light_id = scene.remap_inst[
        jnp.clip(state.hit_inst, 0, scene.remap_inst.shape[0] - 1), 1]
    emiss = md['colors'][..., EMISSION_COLOR, :]
    light_intensity = emiss * tex_color

    has_light = light_id >= 0
    ld_hit = LGT.gather_light(scene, light_id)
    ld_norm = ld_hit['norm'][..., :3]
    lgt_geom = ld_hit['geom_type']
    light_cos = LM.dot(state.ray_dir, ld_norm)
    atten = jnp.where((light_cos < 0.0) | (lgt_geom == LIGHT_GEOM_SPHERE), 1.0, 0.0)
    li_from_light = LGT.light_intensity(scene, meta, light_id, state.wavelengths,
                                        state.ray_pos, state.ray_dir) * atten[..., None]
    light_intensity = jnp.where(has_light[..., None], li_from_light, light_intensity)

    mis_weight_l = jnp.ones_like(state.mis_pdf)
    if integrator_type == INTEGRATOR_MIS_PT:
        if bounce > 0:
            lgt_pdf = LGT.light_pdf_select_rev(meta) * LGT.light_eval_pdf(
                scene, meta, light_id, state.ray_pos, state.ray_dir,
                state.hit_pos, state.hit_norm, jnp.ones_like(state.mis_pdf))
            w = LM.mis_weight_heuristic(state.mis_pdf, lgt_pdf)
            w = jnp.where(state.mis_pdf <= 0.0, 1.0, w)
            mis_weight_l = jnp.where(has_light, w, 1.0)
    elif integrator_type == INTEGRATOR_SHADOW_PT:
        mis_weight_l = jnp.where(_has_non_spec(state.flags), 0.0, 1.0)

    if render_layer == FB_INDIRECT:
        is_direct_light = ~_has_non_spec(state.flags)
        is_first_non_spec = (state.flags & jnp.uint32(C.RAY_FLAG_FIRST_NON_SPEC)) != 0
        mis_weight_l = jnp.where(is_direct_light | is_first_non_spec, 0.0, mis_weight_l)

    light_branch = live & is_light_mat
    accum_light = state.accum_color + state.throughput * light_intensity * mis_weight_l[..., None]
    flags_light = state.flags | jnp.uint32(C.RAY_FLAG_IS_DEAD | C.RAY_FLAG_HIT_LIGHT)

    # ---- surface branch: sample BSDF --------------------------------------
    surf_live = live & ~is_light_mat
    mats_override = None
    mats_override_full = None
    if qmc_ctx is not None and 'mlt_rands' in qmc_ctx:
        mr = qmc_ctx['mlt_rands']
        b_dyn = qmc_ctx.get('bounce_dyn', bounce)
        off = 6 + b_dyn * 10 + 4   # MATS_ID
        mats_override_full = jax.lax.dynamic_slice_in_dim(mr, off, 4, axis=-1)
    elif qmc_ctx is not None and bounce == 0 and qmc_ctx.get('mat_dim', 0):
        from ..ops import qmc as QMC
        table, idx, d0 = qmc_ctx['table'], qmc_ctx['idx'], qmc_ctx['mat_dim']
        mats_override = jnp.stack([QMC.rnd_float(table, idx, d0),
                                   QMC.rnd_float(table, idx, d0 + 1)], -1)
    mat_sam, rng_state, new_ior = MAT.material_sample_and_eval(
        scene, meta, mat_id, state.wavelengths, state.rng, surf_live,
        -state.ray_dir, state.hit_norm, state.hit_tang, state.hit_uv,
        state.mis_ior, state.flags, rnd_mats_override=mats_override,
        rnd_mats_override_full=mats_override_full, ctx=shading_ctx)

    bxdf_val = mat_sam['val'] / jnp.maximum(mat_sam['pdf'], 1e-20)[..., None]
    cos_theta = jnp.abs(LM.dot(mat_sam['dir'], state.hit_norm))

    new_mis_pdf = jnp.where((mat_sam['flags'] & jnp.uint32(C.RAY_EVENT_S)) != 0,
                            -1.0, mat_sam['pdf'])

    if integrator_type == INTEGRATOR_STUPID_PT:
        new_thr = state.throughput * cos_theta[..., None] * bxdf_val
        new_accum = state.accum_color
    else:
        new_accum = state.accum_color + state.throughput * shade_color
        new_thr = state.throughput * cos_theta[..., None] * bxdf_val

    # transmission offset (integrator_pt.cpp:534-537)
    hit_pos2 = jnp.where(((mat_sam['flags'] & jnp.uint32(C.RAY_EVENT_T)) != 0)[..., None],
                         state.hit_pos + (state.hit_dist * 2e-6)[..., None] * state.ray_dir,
                         state.hit_pos)
    new_pos = LM.offs_ray_pos(hit_pos2, state.hit_norm, mat_sam['dir'])

    next_flags = ((state.flags & ~jnp.uint32(C.RAY_FLAG_FIRST_NON_SPEC))
                  | mat_sam['flags'])
    if render_layer == FB_DIRECT:
        next_flags = jnp.where(_has_non_spec(state.flags),
                               next_flags | jnp.uint32(C.RAY_FLAG_IS_DEAD), next_flags)
    else:
        first_ns = ~_has_non_spec(state.flags) & _has_non_spec(next_flags)
        next_flags = jnp.where(first_ns,
                               next_flags | jnp.uint32(C.RAY_FLAG_FIRST_NON_SPEC),
                               next_flags)

    # ---- merge branches ----------------------------------------------------
    lb = light_branch[..., None]
    sb = surf_live[..., None]
    return state._replace(
        accum_color=jnp.where(lb, accum_light,
                              jnp.where(sb, new_accum, state.accum_color)),
        throughput=jnp.where(sb, new_thr, state.throughput),
        flags=jnp.where(light_branch, flags_light,
                        jnp.where(surf_live, next_flags, state.flags)),
        ray_pos=jnp.where(sb, new_pos, state.ray_pos),
        ray_dir=jnp.where(sb, mat_sam['dir'], state.ray_dir),
        mis_pdf=jnp.where(surf_live, new_mis_pdf, state.mis_pdf),
        mis_cos=jnp.where(surf_live, cos_theta, state.mis_cos),
        mis_ior=jnp.where(surf_live, new_ior, state.mis_ior),
        rng=rng_state)


def kernel_hit_environment(scene: Scene, meta: SceneMeta, state: RayState,
                           integrator_type: int, pixel_ids=None) -> RayState:
    """kernel_HitEnvironment (integrator_pt.cpp:550-595)."""
    out = _is_out_of_scene(state.flags)
    env_color, env_pdf = LGT.environment_color(
        scene, meta, state.ray_dir, state.wavelengths,
        integrator_type == INTEGRATOR_MIS_PT)

    is_spec = state.mis_pdf < 0.0
    exit_zero = (state.flags & jnp.uint32(C.RAY_FLAG_PRIME_RAY_MISS)) != 0

    if integrator_type == INTEGRATOR_MIS_PT and meta.env_enable_sam:
        lgt_pdf = LGT.light_pdf_select_rev(meta) * env_pdf
        mis = LM.mis_weight_heuristic(state.mis_pdf, lgt_pdf)
        env_color = jnp.where((~is_spec & ~exit_zero)[..., None],
                              env_color * mis[..., None], env_color)
    elif integrator_type == INTEGRATOR_SHADOW_PT and meta.env_enable_sam:
        env_color = jnp.zeros_like(env_color)

    if meta.has_cam_back and pixel_ids is not None:
        # camera-back texture replaces env color for prime-ray misses
        # (integrator_pt.cpp:578-589)
        x = (pixel_ids % meta.width).astype(jnp.float32)
        y = (pixel_ids // meta.width).astype(jnp.float32)
        tc = jnp.stack([(x + 0.5) / meta.width, (y + 0.5) / meta.height], -1)
        back_id = jnp.broadcast_to(scene.env_cam_back_id, pixel_ids.shape)
        back = TEX.sample(scene.textures, back_id, tc)
        env_color = jnp.where(exit_zero[..., None], back, env_color)

    if integrator_type == INTEGRATOR_STUPID_PT:
        new_accum = state.throughput * env_color
    else:
        new_accum = state.accum_color + state.throughput * env_color
    return state._replace(
        accum_color=jnp.where(out[..., None], new_accum, state.accum_color))


def init_state_from_input_rays(meta: SceneMeta, rng_state, ray_pos, ray_dir,
                               wavelengths=None, time=None):
    """kernel_InitEyeRayFromInput (integrator_pt.cpp:159-199): build the
    ray-state pytree from externally generated rays (camera plugin,
    PathTraceFromInputRays).  ``ray_pos``/``ray_dir`` are world-space [N,3];
    ``wavelengths`` is [N] (one hero λ per ray, the plugin's CHANNELS=1
    contract, cam_plugin/CamPluginAPI.h RayPosAndW.wave) or [N,4]."""
    N = ray_pos.shape[0]
    if wavelengths is None:
        waves4 = jnp.zeros((N, 4), jnp.float32)
    elif wavelengths.ndim == 1:
        waves4 = jnp.broadcast_to(wavelengths[:, None], (N, 4))
    else:
        waves4 = wavelengths
    if time is None:
        time = jnp.zeros((N,), jnp.float32)
    zeros3 = jnp.zeros((N, 3), jnp.float32)
    return RayState(
        ray_pos=ray_pos, ray_dir=ray_dir,
        flags=jnp.zeros((N,), jnp.uint32),
        accum_color=jnp.zeros((N, 4), jnp.float32),
        throughput=jnp.ones((N, 4), jnp.float32),
        mis_pdf=jnp.ones((N,), jnp.float32),
        mis_cos=jnp.ones((N,), jnp.float32),
        mis_ior=jnp.ones((N,), jnp.float32),
        wavelengths=waves4, time=time, rng=rng_state,
        hit_pos=zeros3, hit_norm=zeros3, hit_tang=zeros3,
        hit_uv=jnp.zeros((N, 2), jnp.float32),
        hit_dist=jnp.zeros((N,), jnp.float32),
        hit_inst=jnp.zeros((N,), jnp.int32))


def count_rays_pass(scene: Scene, meta: SceneMeta, rng_state, pixel_ids,
                    integrator_type: int = INTEGRATOR_MIS_PT):
    """Direct ray-count instrumentation (BASELINE.md:20 requires Mrays/s
    measured, not derived): one trace pass accumulating the number of
    nearest-hit rays actually traced (live lanes per bounce) and NEE
    shadow rays (live lanes entering kernel_SampleLightSource).  Returns
    (n_nearest, n_shadow) scalars for a single sample per pixel."""
    state, _ = kernel_init_eye_ray(scene, meta, rng_state, pixel_ids, None)
    depth = meta.trace_depth + (1 if integrator_type == INTEGRATOR_STUPID_PT else 0)
    n_near = jnp.int64(0) if False else jnp.float32(0)
    n_shadow = jnp.float32(0)
    for b in range(depth):
        live = ~_is_dead(state.flags)
        n_near = n_near + jnp.sum(live.astype(jnp.float32))
        state = kernel_ray_trace(scene, meta, state, bounce=b)
        sctx = None
        if not meta.has_blend:
            sctx = MAT.make_shading_ctx(
                scene, meta, _extract_mat_id(state.flags),
                state.hit_norm, state.hit_tang, state.hit_uv)
        if integrator_type != INTEGRATOR_STUPID_PT:
            # only lanes kernel_SampleLightSource actually traces count as
            # shadow rays (live & in_illum; ADVICE r2: live-after-trace alone
            # overstates mrays/s under orientation culling)
            shade, rng2, n_tr = kernel_sample_light_source(
                scene, meta, state, b, integrator_type, FB_COLOR, None,
                shading_ctx=sctx, return_count=True)
            n_shadow = n_shadow + n_tr
            state = state._replace(rng=rng2)
        else:
            shade = jnp.zeros_like(state.accum_color)
        state = kernel_next_bounce(scene, meta, state, b, shade,
                                   integrator_type, FB_COLOR, None,
                                   shading_ctx=sctx)
    return n_near, n_shadow


def trace_pass(scene: Scene, meta: SceneMeta, rng_state, pixel_ids,
               integrator_type: int = INTEGRATOR_MIS_PT,
               render_layer: int = FB_COLOR, qmc_ctx=None, input_state=None):
    """One full sample per pixel id. Returns (accum_color [N,4],
    wavelengths [N,4], flags [N], new rng_state, out_pixel_ids).

    Mirrors PathTrace/NaivePathTrace (integrator_pt.cpp:681-759); with
    qmc_ctx it is the IntegratorQMC variant (mlt/integrator_qmc.cpp); with
    ``input_state`` (from init_state_from_input_rays) it is
    PathTraceFromInputRays (integrator_pt.cpp:761-798).
    """
    if input_state is not None:
        state, out_pixels = input_state, pixel_ids
    else:
        state, out_pixels = kernel_init_eye_ray(scene, meta, rng_state,
                                                pixel_ids, qmc_ctx)

    depth = meta.trace_depth + (1 if integrator_type == INTEGRATOR_STUPID_PT else 0)

    is_mlt = qmc_ctx is not None and 'mlt_rands' in qmc_ctx

    # kernel-traced scenes: sort live rays into coherent blocks before every
    # secondary-bounce trace (see _sort_rays_for_trace); the permutation is
    # inverted at pass end so callers keep positional accumulation
    sort_rays = (meta.use_kernel and meta.sort_rays
                 and qmc_ctx is None and input_state is None)
    orig = jnp.arange(state.flags.shape[0], dtype=jnp.int32)

    def bounce_body(b, state, b_dyn=None, orig=None):
        ctx = qmc_ctx if (b == 0 or is_mlt) else None
        if is_mlt and b_dyn is not None:
            ctx = dict(qmc_ctx, bounce_dyn=b_dyn)
        if sort_rays and b > 0:
            state, orig = _sort_rays_for_trace(state, orig)
        state = kernel_ray_trace(scene, meta, state, bounce=b)
        # one shared shading context per bounce: material rows, slot-0
        # texture, bump normal reused by NEE + bounce + emissive branch
        sctx = None
        if not meta.has_blend:
            sctx = MAT.make_shading_ctx(
                scene, meta, _extract_mat_id(state.flags),
                state.hit_norm, state.hit_tang, state.hit_uv)
        if integrator_type != INTEGRATOR_STUPID_PT:
            shade, rng2 = kernel_sample_light_source(
                scene, meta, state, b, integrator_type, render_layer, ctx,
                shading_ctx=sctx)
            state = state._replace(rng=rng2)
        else:
            shade = jnp.zeros_like(state.accum_color)
        state = kernel_next_bounce(scene, meta, state, b, shade,
                                   integrator_type, render_layer, ctx,
                                   shading_ctx=sctx)
        return (state, orig) if sort_rays else state

    # The bounce loop is fully unrolled: depth is small and static, and a
    # fori_loop would materialize the 17-array RayState carry in device
    # memory at every iteration, defeating XLA's cross-bounce fusion.  Unrolling also
    # specializes the `bounce == 0` branches (prime-ray miss, emissive MIS,
    # QMC dims) and turns MLT's per-bounce rand offsets into static slices.
    _UNROLL_MAX = 12
    if depth <= _UNROLL_MAX:
        for b in range(depth):
            if is_mlt:
                state = bounce_body(min(b, 1), state, b_dyn=b)
            elif sort_rays:
                state, orig = bounce_body(b, state, orig=orig)
            else:
                state = bounce_body(b, state)
    else:
        if sort_rays:
            state, orig = bounce_body(0, state, orig=orig)

            def body_fn(i, carry):
                return bounce_body(1, carry[0], b_dyn=i, orig=carry[1])

            state, orig = jax.lax.fori_loop(1, depth, body_fn, (state, orig))
        else:
            state = bounce_body(0, state)

            def body_fn(i, st):
                return bounce_body(1, st, b_dyn=i)

            state = jax.lax.fori_loop(1, depth, body_fn, state)

    if sort_rays:
        # restore positional order (callers accumulate framebuffer tiles
        # positionally): inverse permutation of the composed sorts
        inv = jnp.argsort(orig)
        state, _ = _permute_state(state, orig, inv)

    state = kernel_hit_environment(scene, meta, state, integrator_type,
                                   out_pixels)
    return (state.accum_color, state.wavelengths, state.flags, state.rng,
            out_pixels)
