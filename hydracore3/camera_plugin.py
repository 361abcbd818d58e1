"""Camera-plugin subsystem: external ray generators + sensor accumulators.

The batched JAX equivalent of the reference's ICamRaysAPI2 contract
(cam_plugin/CamPluginAPI.h:27-77): a camera object produces ray batches
(`make_rays_block` ≈ MakeRaysBlock, returning the RayPosAndW/RayDirAndT
payload: origin+wavelength, direction+time), the renderer path-traces them
via ``PathTraceFromInputRays`` (integrator_pt.cpp:761-798), and the camera
folds per-ray radiance back into its own framebuffer
(`add_samples_contribution_block` ≈ AddSamplesContributionBlock) applying
the sensor response.  Two cameras are provided, mirroring the reference:

* ``CamPinHole`` (cam_plugin/CamPinHole.{h,cpp}) — pinhole generator with a
  spectral 1-channel mode whose sensor applies the CIE response.
* ``CamTableLens`` (cam_plugin/CamTableLens.{h,cpp}) — tabulated lens-stack
  camera reading an ``optics.dat``-style element table; stores per-ray
  cos^4 vignetting weight applied at contribution time.

Everything is batched: one `make_rays` call is one jittable function over
the whole mega-tile (the reference processes 512x512-ray subtiles,
main_with_cam.cpp:96-170).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ops import rng as RNG
from .ops import spectrum as SPEC
from .utils import lmath as LM
from .models import integrator_pt as IPT

MEGA_TILE = 512 * 512  # reference subtile size (main_with_cam.cpp:33)


@dataclasses.dataclass(frozen=True)
class CamParameters:
    """CamParameters (cam_plugin/CamPluginAPI.h): projection + film setup."""
    width: int = 512
    height: int = 512
    fov_deg: float = 45.0
    near_plane: float = 0.01
    far_plane: float = 100.0
    pos: tuple = (0.0, 0.0, 0.0)
    look_at: tuple = (0.0, 0.0, -1.0)
    up: tuple = (0.0, 1.0, 0.0)
    spectral: bool = False


class CamPinHole:
    """Pinhole ray generator + sensor (cam_plugin/CamPinHole.cpp).

    kernel1D_MakeEyeRay: per-pixel jittered rays through the inverse
    projection; spectral mode samples ONE wavelength per ray (CHANNELS=1).
    kernel2D_AddSamplesContribution: RGB adds directly; spectral folds the
    per-λ radiance through the CIE response.
    """

    def __init__(self, params: CamParameters):
        self.params = params
        aspect = params.width / params.height
        proj = LM.perspective_matrix(params.fov_deg, aspect,
                                     params.near_plane, params.far_plane)
        self.proj_inv = jnp.asarray(np.linalg.inv(proj), jnp.float32)
        w2c = LM.look_at(np.asarray(params.pos, np.float32),
                         np.asarray(params.look_at, np.float32),
                         np.asarray(params.up, np.float32))
        self.c2w = jnp.asarray(np.linalg.inv(w2c), jnp.float32)
        self.cie = jnp.asarray(SPEC.cie_xyz_table())

    @classmethod
    def match_scene_camera(cls, params: CamParameters, scene):
        """Camera that reproduces the Hydra scene's own view — useful to
        cross-check the plugin path against the built-in camera."""
        cam = cls(params)
        cam.proj_inv = scene.proj_inv
        cam.c2w = scene.world_view_inv
        return cam

    @property
    def channels(self):
        return 1 if self.params.spectral else 4

    def init_rng(self, n):
        return RNG.gen_init(jnp.arange(n, dtype=jnp.int32))

    def _film_rays(self, rng_state, pixel_ids):
        p = self.params
        xs = (pixel_ids % p.width).astype(jnp.float32)
        ys = (pixel_ids // p.width).astype(jnp.float32)
        rng_state, offs = RNG.rnd_lens(rng_state)
        x_norm = (xs + offs[..., 0]) / float(p.width)
        y_norm = (ys + offs[..., 1]) / float(p.height)
        ray_dir = LM.eye_ray_dir_normalized(x_norm, y_norm, self.proj_inv)
        ray_pos = jnp.zeros_like(ray_dir)
        return rng_state, ray_pos, ray_dir, offs

    def make_rays_block(self, rng_state, pixel_ids):
        """Returns (rng_state, ray_pos [N,3], ray_dir [N,3], waves [N],
        time [N], aux) — the RayPosAndW/RayDirAndT payload, world space."""
        rng_state, ray_pos, ray_dir, _ = self._film_rays(rng_state, pixel_ids)
        ray_pos, ray_dir = LM.transform_ray3f(self.c2w, ray_pos, ray_dir)
        n = pixel_ids.shape[0]
        if self.params.spectral:
            rng_state, u = RNG.rnd_spec(rng_state)
            waves = SPEC.LAMBDA_MIN + u * (SPEC.LAMBDA_MAX - SPEC.LAMBDA_MIN)
        else:
            waves = jnp.zeros((n,), jnp.float32)
        time = jnp.zeros((n,), jnp.float32)
        return rng_state, ray_pos, ray_dir, waves, time, None

    def add_samples_contribution_block(self, fb, colors, pixel_ids, waves,
                                       aux=None):
        """fb: [W*H, C] accumulator; colors: [N, 4] per-ray radiance from
        PathTraceFromInputRays (spectral: lane 0 is the per-λ value)."""
        if self.params.spectral:
            lam4 = jnp.broadcast_to(waves[:, None], waves.shape + (4,))
            xyz = SPEC.spectrum_to_xyz(colors, lam4, self.cie,
                                       jnp.ones_like(waves, bool))
            rgb = SPEC.xyz_to_rgb(xyz)
            add = jnp.concatenate(
                [rgb, jnp.ones_like(rgb[..., :1])], -1)[..., :fb.shape[-1]]
        else:
            add = colors[..., :fb.shape[-1]]
        return fb.at[pixel_ids].add(add)


class CamTableLens(CamPinHole):
    """Tabulated lens-stack camera (cam_plugin/CamTableLens.{h,cpp}).

    ``lens_lines``: tuple of (curvature_radius, thickness, eta, aperture)
    rows, film-to-scene order — the optics.dat table.  Rays start on the
    film plane, are traced through every spherical element
    (TraceLensesFromFilm, integrator_pt.cpp:876-938), and carry a cos^4
    vignetting weight applied by the sensor (CamTableLens.cpp stores per-ray
    cos4 and λ)."""

    def __init__(self, params: CamParameters, lens_lines, phys_size):
        super().__init__(params)
        self.lens_lines = tuple(tuple(float(x) for x in row)
                                for row in lens_lines)
        self.phys_size = (float(phys_size[0]), float(phys_size[1]))

    @classmethod
    def from_optics_file(cls, params: CamParameters, path: str,
                         phys_size=(0.035, 0.035)):
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith('#'):
                    continue
                vals = [float(v) for v in line.replace(',', ' ').split()]
                if len(vals) >= 4:
                    rows.append(tuple(vals[:4]))
        return cls(params, rows, phys_size)

    def make_rays_block(self, rng_state, pixel_ids):
        p = self.params
        xs = (pixel_ids % p.width).astype(jnp.float32)
        ys = (pixel_ids // p.width).astype(jnp.float32)
        rng_state, offs = RNG.rnd_lens(rng_state)
        x_norm = (xs + offs[..., 0]) / float(p.width)
        y_norm = (ys + offs[..., 1]) / float(p.height)

        fx = 0.25 * self.phys_size[0] * (2.0 * x_norm - 1.0)
        fy = 0.25 * self.phys_size[1] * (2.0 * y_norm - 1.0)
        film_pos = jnp.stack([fx, fy, jnp.zeros_like(fx)], -1)
        rear_z = self.lens_lines[0][1]
        rear_r = self.lens_lines[0][3]
        rare = rear_r * 2.0 * LM.map_samples_to_disc(offs[..., 2:4] - 0.5)
        shoot_to = jnp.stack([rare[..., 0], rare[..., 1],
                              jnp.full_like(fx, rear_z)], -1)
        dir_f = LM.normalize(shoot_to - film_pos)

        meta_like = _LensMeta(self.lens_lines)
        pos_o, dir_o, ok = IPT.trace_lenses_from_film(meta_like, film_pos,
                                                      dir_f)
        pos_c = -pos_o
        dir_c = -LM.normalize(dir_o)
        # cos^4 falloff against the film normal (CamTableLens sensor weight)
        cos4 = jnp.clip(dir_f[..., 2] ** 2, 0.0, 1.0) ** 2
        miss_pos = jnp.array([0.0, -1e7, 0.0], jnp.float32)
        miss_dir = jnp.array([0.0, -1.0, 0.0], jnp.float32)
        ray_pos = jnp.where(ok[..., None], pos_c, miss_pos)
        ray_dir = jnp.where(ok[..., None], dir_c, miss_dir)
        ray_pos, ray_dir = LM.transform_ray3f(self.c2w, ray_pos, ray_dir)

        n = pixel_ids.shape[0]
        if p.spectral:
            rng_state, u = RNG.rnd_spec(rng_state)
            waves = SPEC.LAMBDA_MIN + u * (SPEC.LAMBDA_MAX - SPEC.LAMBDA_MIN)
        else:
            waves = jnp.zeros((n,), jnp.float32)
        time = jnp.zeros((n,), jnp.float32)
        aux = jnp.where(ok, cos4, 0.0)
        return rng_state, ray_pos, ray_dir, waves, time, aux

    def add_samples_contribution_block(self, fb, colors, pixel_ids, waves,
                                       aux=None):
        if aux is not None:
            colors = colors * aux[..., None]
        return super().add_samples_contribution_block(fb, colors, pixel_ids,
                                                      waves)


class _LensMeta:
    """Duck-typed meta carrying only lens_lines for trace_lenses_from_film."""

    def __init__(self, lens_lines):
        self.lens_lines = lens_lines


@functools.partial(jax.jit, static_argnames=('meta', 'spectral'))
def _trace_input_rays(scene, meta, rng_state, ray_pos, ray_dir, waves, time,
                      spectral: bool):
    """PathTraceFromInputRays (integrator_pt.cpp:761-798) over one ray batch;
    the final color copy is kernel_CopyColorToOutput (:659-676)."""
    state = IPT.init_state_from_input_rays(
        meta, rng_state, ray_pos, ray_dir,
        waves if spectral else None, time)
    accum, wavelengths, flags, rng_state, _ = IPT.trace_pass(
        scene, meta, rng_state, jnp.zeros(ray_pos.shape[:1], jnp.int32),
        IPT.INTEGRATOR_MIS_PT, IPT.FB_COLOR, input_state=state)
    return accum, rng_state


def render_with_camera_plugin(scene, meta, cam: CamPinHole, spp: int = 16,
                              tile: int = MEGA_TILE):
    """The main_with_cam.cpp driver loop (:96-170): per pass, per mega-tile,
    ping-pong ray buffers between the camera and the renderer.  Returns the
    camera's framebuffer [H, W, C] normalized by spp."""
    p = cam.params
    n_pixels = p.width * p.height
    channels = 4 if not p.spectral else 4  # sensor output is RGBA either way
    fb = jnp.zeros((n_pixels, channels), jnp.float32)
    spectral = bool(p.spectral)

    n_tiles = -(-n_pixels // tile)
    rngs = [cam.init_rng(min(tile, n_pixels - t * tile))
            for t in range(n_tiles)]
    for _ in range(spp):
        for t in range(n_tiles):
            lo = t * tile
            hi = min(lo + tile, n_pixels)
            pixel_ids = jnp.arange(lo, hi, dtype=jnp.int32)
            rngs[t], ray_pos, ray_dir, waves, time, aux = cam.make_rays_block(
                rngs[t], pixel_ids)
            colors, rngs[t] = _trace_input_rays(
                scene, meta, rngs[t], ray_pos, ray_dir, waves, time, spectral)
            fb = cam.add_samples_contribution_block(fb, colors, pixel_ids,
                                                    waves, aux)
    img = np.asarray(fb).reshape(p.height, p.width, channels) / float(spp)
    return img
