"""Render driver: pass loop, framebuffer accumulation, layers.

The analog of PathTraceBlock + main.cpp's frame loop (SURVEY.md §3.1 L6/L7):
jit one full sample-per-pixel pass, loop passes on the host accumulating into
the framebuffer, normalize by 1/passes at save time.  Rays are processed in
fixed-size tiles so huge framebuffers bound device memory; each tile reuses
the same compiled program.
"""
from __future__ import annotations

import functools
import os
import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from .ops import rng as RNG
from .ops import spectrum as SPEC
from .ops import texture as TEX
from .models import integrator_pt as IPT
from .scene.build import Scene, SceneMeta
from .bsdf import common as C
from .utils import lmath as LM

INTEGRATOR_BY_NAME = {
    'naivept': IPT.INTEGRATOR_STUPID_PT,
    'shadowpt': IPT.INTEGRATOR_SHADOW_PT,
    'mispt': IPT.INTEGRATOR_MIS_PT,
}

LAYER_BY_NAME = {
    'color': IPT.FB_COLOR,
    'direct': IPT.FB_DIRECT,
    'indirect': IPT.FB_INDIRECT,
}


def _one_sample(scene: Scene, meta: SceneMeta, rng_state, pixel_ids,
                integrator_type: int, render_layer: int, channels: int,
                qmc_ctx=None):
    """One sample for each pixel id; returns (contrib [N, C], rng_state,
    out_pixels).

    The spectral->RGB conversion is kernel_ContributeToImage
    (integrator_pt.cpp:598-657) / SpectralCamRespoceToRGB."""
    accum, wavelengths, flags, rng_state, out_pixels = IPT.trace_pass(
        scene, meta, rng_state, pixel_ids, integrator_type, render_layer,
        qmc_ctx)

    if channels == 1:
        contrib = accum[..., :1] * meta.exposure_mult
    elif channels > 4:
        # N-channel spectral framebuffer (integrator_pt.cpp:642-654): each
        # hero-wavelength lane adds into its spectral band channel
        t = ((wavelengths - SPEC.LAMBDA_MIN)
             / (SPEC.LAMBDA_MAX - SPEC.LAMBDA_MIN))
        ch = jnp.minimum((t * channels).astype(jnp.int32), channels - 1)
        color = accum * meta.exposure_mult
        contrib = jnp.zeros(accum.shape[:-1] + (channels,), jnp.float32)
        rows = jnp.arange(accum.shape[0])[:, None]
        contrib = contrib.at[rows, ch].add(color)
    elif meta.spectral_mode:
        if meta.has_cam_response_spectra:
            # measured camera response spectra (SpectralCamRespoceToRGB,
            # integrator_spectrum.cpp:78-125): responseY falls back to X,
            # Z to Y; type XYZ converts, type RGB is direct
            S = scene.spec_offset_sz.shape[0]
            ids = scene.cam_response_spec_id

            def resp(i, fallback):
                off = scene.spec_offset_sz[jnp.clip(ids[i], 0, S - 1), 0]
                off = jnp.broadcast_to(off, wavelengths.shape[:-1])
                r = SPEC.sample_uniform_spectrum(scene.spec_values, off,
                                                 wavelengths)
                return jnp.where(ids[i] >= 0, r, fallback)

            rx = resp(0, jnp.ones_like(wavelengths))
            ry = resp(1, rx)
            rz = resp(2, ry)
            xyz = jnp.stack([jnp.sum(accum * rx, -1),
                             jnp.sum(accum * ry, -1),
                             jnp.sum(accum * rz, -1)], -1)
            rgb = SPEC.xyz_to_rgb(xyz) if meta.cam_response_type == 0 else xyz
        else:
            terminate = (flags & jnp.uint32(C.RAY_FLAG_WAVES_DIVERGED)) != 0
            xyz = SPEC.spectrum_to_xyz(accum, wavelengths, scene.cie_xyz,
                                       terminate)
            rgb = SPEC.xyz_to_rgb(xyz)
        contrib = jnp.concatenate([rgb * meta.exposure_mult,
                                   jnp.ones_like(rgb[..., :1])], -1)[..., :channels]
    else:
        tmp = accum * scene.cam_response_rgb
        contrib = (tmp * meta.exposure_mult)[..., :channels]
    return contrib, rng_state, out_pixels


@functools.partial(jax.jit, static_argnames=('meta', 'integrator_type',
                                             'render_layer', 'channels'))
def _render_tile(scene: Scene, meta: SceneMeta, rng_state, pixel_ids,
                 integrator_type: int, render_layer: int, channels: int,
                 n_iters):
    """n_iters samples per pixel in one dispatch (the RTVPersistent_Iters
    loop, integrator_pt.cpp:721-723). Returns (sum contrib [N, C], rng).

    ``n_iters`` is a DYNAMIC scalar: one compiled executable serves every
    spp schedule (compiling the fused pass program is expensive)."""
    def body(_, carry):
        fb, rng = carry
        contrib, rng, _ = _one_sample(scene, meta, rng, pixel_ids,
                                      integrator_type, render_layer, channels)
        return fb + contrib, rng

    fb0 = jnp.zeros(pixel_ids.shape + (channels,), jnp.float32)
    if isinstance(n_iters, int):
        # static trip count: reverse-differentiable (the DR/dryrun path
        # calls ``_render_tile.__wrapped__`` with a Python int)
        if n_iters == 1:
            return body(0, (fb0, rng_state))
        return jax.lax.fori_loop(0, n_iters, body, (fb0, rng_state))
    return jax.lax.fori_loop(0, jnp.asarray(n_iters, jnp.int32), body,
                             (fb0, rng_state))


@functools.partial(jax.jit, static_argnames=('meta', 'integrator_type',
                                             'render_layer', 'channels',
                                             'spd_dim', 'mat_dim', 'lgt_dim'))
def _render_tile_qmc(scene: Scene, meta: SceneMeta, rng_state, pixel_ids,
                     sample_idx, qmc_table, integrator_type: int,
                     render_layer: int, channels: int,
                     spd_dim: int, mat_dim: int, lgt_dim: int):
    """QMC pass: sample index drives the Sobol dims; contributions are
    scatter-added to the QMC-chosen pixels (the reference's atomics,
    integrator_qmc.cpp:252-281). Returns (fb [N, C], rng)."""
    qmc_ctx = dict(table=qmc_table, idx=sample_idx,
                   spd_dim=spd_dim, mat_dim=mat_dim, lgt_dim=lgt_dim)
    contrib, rng, out_px = _one_sample(scene, meta, rng_state, pixel_ids,
                                       integrator_type, render_layer, channels,
                                       qmc_ctx)
    fb = jnp.zeros((meta.width * meta.height, channels), jnp.float32)
    fb = fb.at[out_px].add(contrib)
    return fb, rng


def _qmc_dims(meta: SceneMeta):
    """EnableQMC dim assignment (mlt/integrator_qmc.cpp:28-86).

    Returns (spd_dim, mat_dim, lgt_dim); dims 0/1 are always pixel position,
    2/3 lens when DoF is on.
    """
    # dof also covers the optics simulator (EnableQMC:13 checks
    # m_enableOpticSim too — both consume QMC lens dims 2/3)
    dof = meta.cam_lens_radius > 0.0 or len(meta.lens_lines) > 0
    spd = meta.spectral_mode
    motion = meta.has_motion
    if dof and spd and motion:
        return 4, 0, 0
    if dof and spd:
        return 4, 5, 7
    if spd and motion:
        return 3, 4, 6
    if dof and motion:
        return 0, 5, 7
    if dof:
        return 0, 4, 6
    if spd:
        return 4, 2, 5
    if motion:
        return 0, 2, 5
    return 0, 2, 4


def render_qmc(scene: Scene, meta: SceneMeta, spp: int = None,
               integrator: str = 'mispt', layer: str = 'color',
               channels: int = 4, tile_size: int = 1 << 17,
               progress: bool = False, return_timing: bool = False):
    """QMC (Sobol/Niederreiter) render: IntegratorQMC::PathTraceBlock
    (mlt/integrator_qmc.cpp:284-315). Pixels come from QMC dims 0/1, so
    each pass scatters N samples over the whole framebuffer."""
    from .ops import qmc as QMC
    spp = spp or meta.spp
    itype = INTEGRATOR_BY_NAME[integrator]
    rlayer = LAYER_BY_NAME[layer]
    W, H = meta.width, meta.height
    N = W * H
    spd_dim, mat_dim, lgt_dim = _qmc_dims(meta)
    table = jnp.asarray(QMC.nied_table())

    n_tiles = -(-N // tile_size)
    tile = min(tile_size, N)
    pixel_ids = jnp.zeros((tile,), jnp.int32)  # unused under QMC
    rng_dev = [RNG.gen_init(jnp.arange(t * tile, (t + 1) * tile))
               for t in range(n_tiles)]
    fb_dev = None

    t0 = _time.time()
    compile_time = 0.0
    sample_base = 0
    for p in range(spp):
        for t in range(n_tiles):
            idx = (jnp.arange(tile, dtype=jnp.uint32)
                   + jnp.uint32(sample_base))
            tc0 = _time.time()
            fb_t, rng_dev[t] = _render_tile_qmc(
                scene, meta, rng_dev[t], pixel_ids, idx, table,
                itype, rlayer, channels, spd_dim, mat_dim, lgt_dim)
            fb_dev = fb_t if fb_dev is None else fb_dev + fb_t
            if p == 0 and t == 0:
                fb_t.block_until_ready()
                compile_time = _time.time() - tc0
            sample_base += tile
        if progress:
            print(f'rendering, progress = {100.0 * (p + 1) / spp:.2f} %', end='\r')
    if progress:
        print()
    total = _time.time() - t0
    img = (np.asarray(fb_dev) / float(spp)).reshape(H, W, channels)
    if return_timing:
        return img, dict(total_s=total, compile_s=compile_time, spp=spp,
                         rays=N * spp)
    return img


def render(scene: Scene, meta: SceneMeta, spp: int = None,
           integrator: str = 'mispt', layer: str = 'color', channels: int = 4,
           tile_size: int = 1 << 15, iters_per_dispatch: int = 0,
           progress: bool = False, return_timing: bool = False,
           checkpoint_path: str = None, checkpoint_every: int = 0,
           resume: bool = False):
    """Render a full frame. Returns float32 [H, W, channels] (normalized).

    ``tile_size`` is the number of rays per dispatch; every tile reuses one
    compiled program.  The 32k default is untuned on the GPU.

    With ``checkpoint_path`` + ``checkpoint_every=K`` the accumulated
    framebuffer, per-tile RNG state, and samples-done counter persist every
    K dispatches; ``resume=True`` continues an interrupted render from the
    checkpoint (SURVEY.md §5 — pass-granular resume the reference lacks)."""
    spp = spp or meta.spp
    itype = INTEGRATOR_BY_NAME[integrator]
    rlayer = LAYER_BY_NAME[layer]
    W, H = meta.width, meta.height
    N = W * H

    if iters_per_dispatch <= 0:
        # default: the whole spp budget in one dispatch per tile, unless
        # checkpointing needs finer granularity
        iters_per_dispatch = 1 if (checkpoint_path and checkpoint_every) else spp

    pixel_all = np.arange(N, dtype=np.int32)
    rng_all = np.array(RNG.gen_init(pixel_all))  # copy: device views are read-only

    fb = np.zeros((N, channels), np.float32)
    n_tiles = -(-N // tile_size)
    pad = n_tiles * tile_size - N
    if pad:
        pixel_pad = np.concatenate([pixel_all, np.zeros(pad, np.int32)])
        rng_pad = np.concatenate([rng_all, np.zeros((pad, 2), rng_all.dtype)])
    else:
        pixel_pad, rng_pad = pixel_all, rng_all

    # split spp into dispatches of iters_per_dispatch samples
    iters = min(iters_per_dispatch, spp)
    schedule = [iters] * (spp // iters)
    if spp % iters:
        schedule.append(spp % iters)

    # keep all loop state on the device: no host round-trip per dispatch
    rng_dev = [jnp.asarray(rng_pad[t * tile_size:(t + 1) * tile_size])
               for t in range(n_tiles)]
    pix_dev = [jnp.asarray(pixel_pad[t * tile_size:(t + 1) * tile_size])
               for t in range(n_tiles)]
    fb_dev = [None] * n_tiles

    done_already = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        from .utils import checkpoint as CKPT
        (fb_loaded, rng_loaded), done_already, _ = CKPT.load_checkpoint(
            checkpoint_path, like=(rng_dev, rng_dev))
        fb_dev = [jnp.asarray(f) for f in fb_loaded]
        rng_dev = [jnp.asarray(r) for r in rng_loaded]
        # skip the passes already accumulated
        remaining = spp - done_already
        schedule = [iters] * (max(remaining, 0) // iters)
        if remaining % iters:
            schedule.append(remaining % iters)

    t0 = _time.time()
    compile_time = 0.0
    done = done_already
    for p, n_iters in enumerate(schedule):
        for t in range(n_tiles):
            tc0 = _time.time()
            contrib, rng_dev[t] = _render_tile(
                scene, meta, rng_dev[t], pix_dev[t],
                itype, rlayer, channels, n_iters)
            fb_dev[t] = contrib if fb_dev[t] is None else fb_dev[t] + contrib
            if p == 0 and t == 0:
                contrib.block_until_ready()
                compile_time = _time.time() - tc0
        done += n_iters
        if (checkpoint_path and checkpoint_every
                and (p + 1) % checkpoint_every == 0):
            from .utils import checkpoint as CKPT
            fb_host = [np.asarray(f) for f in fb_dev]
            rng_host = [np.asarray(r) for r in rng_dev]
            CKPT.save_checkpoint(checkpoint_path, (fb_host, rng_host),
                                 step=done)
        if progress:
            print(f'rendering, progress = {100.0 * done / spp:.2f} %', end='\r')
    if progress:
        print()
    for t in range(n_tiles):
        valid = min(tile_size, N - t * tile_size)
        fb[t * tile_size:t * tile_size + valid] += np.asarray(fb_dev[t])[:valid]
    total = _time.time() - t0
    img = (fb / float(spp)).reshape(H, W, channels)
    if return_timing:
        return img, dict(total_s=total, compile_s=compile_time,
                         spp=spp, rays=N * spp)
    return img
