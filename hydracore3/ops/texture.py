"""Flattened texture pool with batched bilinear sampling.

Batched replacement for the reference's ``ICombinedImageSampler`` array
(LiteImage Image2D + Sampler; used e.g. integrator_pt_mat.cpp:146).  All
texture slots' texels live in ONE flat ``[P, 4]`` float32 array; a per-slot
table stores (offset, width, height, filter, addressU, addressV).  Sampling a
per-ray ``tex_id`` is then four dynamic gathers + bilinear weights — fully
batched, no per-texture dispatch.

Slot 0 is always a 1x1 white dummy (MakeWhiteDummy,
integrator_pt_scene_tex.cpp:7-16).  Gamma (sRGB -> linear, pow 2.2 like the
reference's LDR pipeline) is applied at load time so the device pool is
linear float.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

FILTER_NEAREST = 0
FILTER_LINEAR = 1

ADDR_WRAP = 0
ADDR_CLAMP = 1
ADDR_MIRROR = 2
ADDR_BORDER = 3
ADDR_MIRROR_ONCE = 4

_ADDR_FROM_STR = {
    'wrap': ADDR_WRAP, 'clamp': ADDR_CLAMP, 'mirror': ADDR_MIRROR,
    'border': ADDR_BORDER, 'mirror_once': ADDR_MIRROR_ONCE,
}


def addr_mode_from_string(s: str) -> int:
    return _ADDR_FROM_STR.get(s, ADDR_WRAP)


class TexturePoolBuilder:
    """Host-side accumulation of texture slots into one flat array."""

    def __init__(self):
        self._texels: list[np.ndarray] = []
        self._table: list[tuple] = []
        self._total = 0
        # slot 0: white dummy
        self.add(np.ones((1, 1, 4), np.float32),
                 filter_mode=FILTER_NEAREST, addr_u=ADDR_CLAMP, addr_v=ADDR_CLAMP)

    def add(self, img: np.ndarray, filter_mode=FILTER_LINEAR,
            addr_u=ADDR_WRAP, addr_v=ADDR_WRAP) -> int:
        """img: [H, W, 4] float32 linear. Returns slot id."""
        assert img.ndim == 3 and img.shape[2] == 4, img.shape
        h, w = img.shape[:2]
        slot = len(self._table)
        self._table.append((self._total, w, h, filter_mode, addr_u, addr_v))
        self._texels.append(img.reshape(-1, 4).astype(np.float32))
        self._total += w * h
        return slot

    def slot_dims(self, slot: int) -> tuple:
        """(width, height) of a committed slot."""
        _, w, h, _, _, _ = self._table[slot]
        return w, h

    def slot_const_value(self, slot: int):
        """The single texel of a 1x1 slot (for const-texture folding), or
        None when the slot is larger than 1x1."""
        if self.slot_dims(slot) != (1, 1):
            return None
        return self._texels[slot][0].copy()

    def finish(self, quad_pack_max_texels: int = 1 << 26) -> 'TexturePool':
        table = np.array(self._table, np.int32)
        texels = np.concatenate(self._texels, axis=0)
        all_linear = bool((table[:, 3] == FILTER_LINEAR).all()
                          or len(table) <= 1)

        # Quad packing: store each texel's full 2x2 bilinear footprint
        # (neighbors pre-wrapped per the slot's addressing mode) as one
        # 16-float row, so a bilinear tap is ONE 64-byte row gather instead
        # of four scattered texel reads.
        # 4x texel memory; disabled beyond quad_pack_max_texels.
        quad = None
        if self._total <= quad_pack_max_texels:
            quads = []
            for img, (off, w, h, filt, au, av) in zip(self._texels, self._table):
                t = img.reshape(h, w, 4)
                if au == ADDR_WRAP:
                    xr = np.roll(t, -1, axis=1)
                else:
                    xr = t[:, np.minimum(np.arange(w) + 1, w - 1), :]
                if av == ADDR_WRAP:
                    yr = np.roll(t, -1, axis=0)
                    xyr = np.roll(xr, -1, axis=0)
                else:
                    iy = np.minimum(np.arange(h) + 1, h - 1)
                    yr = t[iy]
                    xyr = xr[iy]
                q = np.concatenate([t, xr, yr, xyr], axis=-1)  # c00 c10 c01 c11
                quads.append(q.reshape(-1, 16).astype(np.float32))
            quad = np.concatenate(quads, axis=0)

        return TexturePool(
            texels=jnp.asarray(texels),
            quad_texels=None if quad is None else jnp.asarray(quad),
            offset=jnp.asarray(table[:, 0]),
            width=jnp.asarray(table[:, 1]),
            height=jnp.asarray(table[:, 2]),
            filter=jnp.asarray(table[:, 3]),
            addr_u=jnp.asarray(table[:, 4]),
            addr_v=jnp.asarray(table[:, 5]),
            all_linear=all_linear)


@dataclasses.dataclass(frozen=True)
class TexturePool:
    texels: jnp.ndarray   # [P, 4] f32
    offset: jnp.ndarray   # [T] i32
    width: jnp.ndarray    # [T] i32
    height: jnp.ndarray   # [T] i32
    filter: jnp.ndarray   # [T] i32
    addr_u: jnp.ndarray   # [T] i32
    addr_v: jnp.ndarray   # [T] i32
    # [P', 16] f32: per-texel 2x2 bilinear footprint (see finish()); None
    # when the pool is too large for 4x quad memory
    quad_texels: jnp.ndarray = None
    # static: every slot is FILTER_LINEAR -> the nearest tap is skipped
    all_linear: bool = False


jax.tree_util.register_dataclass(
    TexturePool,
    data_fields=['texels', 'offset', 'width', 'height', 'filter',
                 'addr_u', 'addr_v', 'quad_texels'],
    meta_fields=['all_linear'])


def _norm_coord(u, mode):
    """Map a normalized coord into [0,1) (wrap) / [0,1] (clamp) / reflected
    [0,1] (mirror) using ONLY float ops.

    Per-ray texture ids make `size` dynamic; integer remainder by a dynamic
    divisor expands to a long division sequence.  Wrapping in normalized
    space is translation-equivalent: frac(u)*w == u*w (mod w), so the texel
    index below only needs compare-based boundary fixups.
    """
    wrapped = u - jnp.floor(u)
    clamped = jnp.clip(u, 0.0, 1.0)
    half = 0.5 * u
    m2 = 2.0 * (half - jnp.floor(half))          # u mod 2 in [0,2)
    mirrored = jnp.where(m2 < 1.0, m2, 2.0 - m2)
    return jnp.where(mode == ADDR_WRAP, wrapped,
           jnp.where(mode == ADDR_MIRROR, mirrored, clamped))


def _sample_quad(pool: TexturePool, tex_id, uv):
    """Bilinear tap via the quad-packed pool: ONE wide gather per sample
    (all four 2x2 corners live in one 16-float row, neighbors pre-wrapped
    per the slot's addressing mode at build time)."""
    off = pool.offset[tex_id]
    w = pool.width[tex_id]
    h = pool.height[tex_id]
    au = pool.addr_u[tex_id]
    av = pool.addr_v[tex_id]
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    is_wrap_u = au == ADDR_WRAP
    is_wrap_v = av == ADDR_WRAP

    ffx = _norm_coord(uv[..., 0], au) * wf - 0.5
    ffy = _norm_coord(uv[..., 1], av) * hf - 0.5
    # clamp-family modes: pre-clamping ffx into [0, w-1] reproduces the
    # per-corner clip exactly (both corners collapse at the borders)
    ffx = jnp.where(is_wrap_u, ffx, jnp.clip(ffx, 0.0, wf - 1.0))
    ffy = jnp.where(is_wrap_v, ffy, jnp.clip(ffy, 0.0, hf - 1.0))
    px = jnp.floor(ffx)
    py = jnp.floor(ffy)
    fx = (ffx - px)[..., None]
    fy = (ffy - py)[..., None]
    px = px.astype(jnp.int32)
    py = py.astype(jnp.int32)
    # wrap is the only mode that can produce -1 here
    wx = jnp.where(px < 0, w - 1, px)
    wy = jnp.where(py < 0, h - 1, py)

    qidx = (off + wy * w + wx).reshape(-1)
    row = pool.quad_texels[qidx].reshape(uv.shape[:-1] + (16,))
    c00, c10 = row[..., 0:4], row[..., 4:8]
    c01, c11 = row[..., 8:12], row[..., 12:16]
    bilinear = (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
                + c01 * (1 - fx) * fy + c11 * fx * fy)
    if pool.all_linear:
        return bilinear

    # nearest = int(u*w) is always one of the quad corners (fx >= 0.5
    # selects the +1 corner; see the clamp/wrap case analysis above)
    right = fx >= 0.5
    down = fy >= 0.5
    nearest = jnp.where(right, jnp.where(down, c11, c10),
                        jnp.where(down, c01, c00))
    filt = pool.filter[tex_id]
    return jnp.where((filt == FILTER_LINEAR)[..., None], bilinear, nearest)


def sample(pool: TexturePool, tex_id, uv):
    """Batched texture sample.

    tex_id: int32 [...]; uv: float32 [..., 2]. Returns float32 [..., 4].
    Bilinear with half-texel centers, matching LiteImage's sample.
    No dynamic integer division anywhere (see _norm_coord).
    """
    tex_id = jnp.asarray(tex_id, jnp.int32)
    if pool.quad_texels is not None:
        return _sample_quad(pool, tex_id, uv)
    off = pool.offset[tex_id]
    w = pool.width[tex_id]
    h = pool.height[tex_id]
    filt = pool.filter[tex_id]
    au = pool.addr_u[tex_id]
    av = pool.addr_v[tex_id]

    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    is_wrap_u = au == ADDR_WRAP
    is_wrap_v = av == ADDR_WRAP

    # texel-space coords; LiteImage: ffx = tc.x*w - 0.5 (pre-wrapped into the
    # base period so indices only ever need one boundary fixup)
    ffx = _norm_coord(uv[..., 0], au) * wf - 0.5
    ffy = _norm_coord(uv[..., 1], av) * hf - 0.5
    px = jnp.floor(ffx)
    py = jnp.floor(ffy)
    fx = ffx - px
    fy = ffy - py
    px = px.astype(jnp.int32)    # in [-1, w-1]
    py = py.astype(jnp.int32)

    w1 = w - 1
    h1 = h - 1

    def wrap_ix(ix):
        # wrap: -1 -> w-1, w -> 0; clamp/mirror(base period): clip
        ix_w = jnp.where(ix < 0, w1, jnp.where(ix > w1, 0, ix))
        return jnp.where(is_wrap_u, ix_w, jnp.clip(ix, 0, w1))

    def wrap_iy(iy):
        iy_w = jnp.where(iy < 0, h1, jnp.where(iy > h1, 0, iy))
        return jnp.where(is_wrap_v, iy_w, jnp.clip(iy, 0, h1))

    def fetch(ix, iy):
        return pool.texels[off + iy * w + ix]

    x0 = wrap_ix(px)
    x1 = wrap_ix(px + 1)
    y0 = wrap_iy(py)
    y1 = wrap_iy(py + 1)
    c00 = fetch(x0, y0)
    c10 = fetch(x1, y0)
    c01 = fetch(x0, y1)
    c11 = fetch(x1, y1)
    fx1 = fx[..., None]
    fy1 = fy[..., None]
    bilinear = (c00 * (1 - fx1) * (1 - fy1) + c10 * fx1 * (1 - fy1)
                + c01 * (1 - fx1) * fy1 + c11 * fx1 * fy1)

    if pool.all_linear:
        return bilinear

    # nearest: LiteImage nearest = int(tc*size), truncation
    nx = jnp.clip((_norm_coord(uv[..., 0], au) * wf).astype(jnp.int32), 0, w1)
    ny = jnp.clip((_norm_coord(uv[..., 1], av) * hf).astype(jnp.int32), 0, h1)
    nearest = fetch(nx, ny)

    return jnp.where((filt == FILTER_LINEAR)[..., None], bilinear, nearest)


# ---------------------------------------------------------------------------
# Host-side image decoding for Hydra texture chunks
# ---------------------------------------------------------------------------

def decode_chunk(path: str, width: int, height: int, bpp: int, offset: int,
                 srgb_to_linear: bool) -> np.ndarray:
    """Read a Hydra .image4ub/.image4f chunk file -> [H, W, 4] float32 linear.

    File layout (integrator_pt_scene_tex.cpp:55-99): int32 w, int32 h, then
    w*h*4 bytes (u8 RGBA) or w*h*4 float32.
    """
    with open(path, 'rb') as f:
        raw = f.read()
    wh = np.frombuffer(raw, '<i4', count=2, offset=0)
    w, h = int(wh[0]), int(wh[1])
    if w == 0 or h == 0:
        return np.ones((1, 1, 4), np.float32)
    if bpp == 16:
        data = np.frombuffer(raw, '<f4', count=w * h * 4, offset=8)
        return data.reshape(h, w, 4).astype(np.float32)
    data = np.frombuffer(raw, np.uint8, count=w * h * 4, offset=8)
    img = data.reshape(h, w, 4).astype(np.float32) / 255.0
    if srgb_to_linear:
        img = img.copy()
        img[..., :3] = np.power(img[..., :3], 2.2, dtype=np.float32)
    return img


def load_image_file(path: str, srgb_to_linear: bool) -> np.ndarray:
    """Load .bmp/.png/.jpg/.exr via imageio -> [H, W, 4] float32 linear."""
    from ..utils.imageio import imageio_v3
    iio = imageio_v3()
    img = np.asarray(iio.imread(path))
    if img.dtype == np.uint8:
        imgf = img.astype(np.float32) / 255.0
        if srgb_to_linear:
            imgf = np.power(imgf, 2.2, dtype=np.float32)
    else:
        imgf = img.astype(np.float32)
    if imgf.ndim == 2:
        imgf = imgf[..., None].repeat(3, axis=-1)
    if imgf.shape[-1] == 3:
        imgf = np.concatenate([imgf, np.ones_like(imgf[..., :1])], axis=-1)
    return imgf
