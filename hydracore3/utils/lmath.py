"""Vector/matrix math helpers for the batched HydraCore3 framework.

Semantics mirror the reference's LiteMath + ``include/cglobals.h``
(/root/reference/include/cglobals.h) but are written batched-first: every
function accepts arrays whose last axis is the vector axis, so the same code
runs on single vectors and on ``[N, 3]`` ray batches without vmap.

Matrices are stored row-major ``[..., 4, 4]`` with the standard ``M @ v``
convention (matching the Hydra XML row-major matrix strings parsed by
hydraxml.cpp:261-276 in the reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Reference constants (cglobals.h:138-139, 22-24)
GEPSILON = 1e-5
DEPSILON = 1e-20
LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
EPSILON_32 = 5.960464477539063e-8

M_PI = float(np.pi)
M_TWOPI = float(2.0 * np.pi)
INV_PI = float(1.0 / np.pi)
DEG_TO_RAD = float(np.pi / 180.0)
FLT_MAX = float(np.finfo(np.float32).max)


def dot(a, b):
    """Dot product over the last axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def dot3(a, b):
    """Dot of the xyz components only (works on [...,3] or [...,4])."""
    return jnp.sum(a[..., :3] * b[..., :3], axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(v):
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v, eps=0.0):
    # guard must stay in the normal f32 range: 1e-38 is subnormal and gets
    # flushed to zero by XLA (flush-to-zero), making rsqrt return inf (0*inf = NaN
    # for zero-length inputs like degenerate half-vectors on missed rays)
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(n2, 1e-30))


@jax.custom_jvp
def safe_sqrt(x):
    """sqrt(max(x, 0)) (cmaterial.h:206-209) with a bounded gradient at 0.

    The derivative 1/(2 sqrt x) blows up at x=0 (hit constantly: sin_theta =
    sqrt(1-cos^2) at grazing/normal incidence), turning into inf*0=NaN in
    reverse mode. Clamp like Mitsuba's dr.safe_sqrt."""
    return jnp.sqrt(jnp.maximum(x, 0.0))


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = jnp.sqrt(jnp.maximum(x, 0.0))
    dy = dx * 0.5 / jnp.maximum(y, 1e-6)
    return y, jnp.where(x > 0, dy, jnp.zeros_like(dy))


@jax.custom_jvp
def safe_arccos(x):
    """arccos with clamped input and bounded gradient at |x|=1."""
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


@safe_arccos.defjvp
def _safe_arccos_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    xc = jnp.clip(x, -1.0, 1.0)
    y = jnp.arccos(xc)
    denom = jnp.maximum(jnp.sqrt(jnp.maximum(1.0 - xc * xc, 0.0)), 1e-6)
    return y, -dx / denom


def clamp(x, a, b):
    return jnp.clip(x, a, b)


def lerp(a, b, t):
    return a + (b - a) * t


def maxcomp(v):
    """max component of a [...,3] vector (cglobals.h:275)."""
    return jnp.max(v[..., :3], axis=-1)


def to_float3(v4):
    return v4[..., :3]


def to_float4(v3, w):
    w = jnp.broadcast_to(jnp.asarray(w, v3.dtype), v3.shape[:-1] + (1,))
    return jnp.concatenate([v3, w], axis=-1)


def f32(x):
    return jnp.asarray(x, jnp.float32)


# ---------------------------------------------------------------------------
# Matrix ops
#
# Small matrix-vector products are written as multiply-and-sum: XLA fuses
# them into the surrounding elementwise code, and unlike a dot they never
# take the GPU's TF32 tensor-core path, so they stay exact f32.
# ---------------------------------------------------------------------------

def matvec(m, v):
    """``m @ v`` over the last two / last axis, in plain f32."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def mul4x3(m, v3):
    """Transform a point: (M @ [v,1]).xyz  (LiteMath mul4x3)."""
    return matvec(m[..., :3, :3], v3) + m[..., :3, 3]


def mul3x3(m, v3):
    """Rotate a direction: (M @ [v,0]).xyz."""
    return matvec(m[..., :3, :3], v3)


def mul4x4_vec(m, v4):
    return matvec(m, v4)


def transform_ray3f(m, ray_pos, ray_dir):
    """Reference cglobals.h:254-263: transform pos and (pos+100*dir), renormalize."""
    pos = mul4x3(m, ray_pos)
    pos2 = mul4x3(m, ray_pos + 100.0 * ray_dir)
    return pos, normalize(pos2 - pos)


def perspective_matrix(fov_deg, aspect, z_near, z_far):
    """Standard OpenGL-style perspective (LiteMath perspectiveMatrix).

    fov is the vertical field of view in degrees (integrator_pt_scene.cpp:656).
    Returns a numpy [4,4] row-major matrix.
    """
    ymax = z_near * np.tan(fov_deg * np.pi / 360.0)
    xmax = ymax * aspect
    left, right, bottom, top = -xmax, xmax, -ymax, ymax
    temp, temp2, temp3, temp4 = 2.0 * z_near, right - left, top - bottom, z_far - z_near
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = temp / temp2
    m[1, 1] = temp / temp3
    m[0, 2] = (right + left) / temp2
    m[1, 2] = (top + bottom) / temp3
    m[2, 2] = (-z_far - z_near) / temp4
    m[3, 2] = -1.0
    m[2, 3] = (-temp * z_far) / temp4
    return m


def look_at(eye, center, up):
    """LiteMath lookAt: world->camera matrix, numpy [4,4] row-major."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    y = y / np.linalg.norm(y)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = x
    m[1, :3] = y
    m[2, :3] = z
    m[0, 3] = -np.dot(x, eye)
    m[1, 3] = -np.dot(y, eye)
    m[2, 3] = -np.dot(z, eye)
    return m


# ---------------------------------------------------------------------------
# ONB / sampling maps (cglobals.h)
# ---------------------------------------------------------------------------

def coordinate_system_v2(n):
    """Duff et al. orthonormal basis (cglobals.h:120-132). Returns (s, t)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    pos = nz >= 0
    sign = jnp.where(pos, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = jnp.stack([
        jnp.where(pos, nx * nx * a, -nx * nx * a) + 1.0,
        jnp.where(pos, b, -b),
        jnp.where(pos, -nx, nx),
    ], axis=-1)
    t = jnp.stack([b, ny * ny * a + sign, -ny], axis=-1)
    return s, t


def map_sample_to_cosine_distribution(r1, r2, direction, hit_norm, power):
    """cglobals.h:143-181 (power-cosine hemisphere sample around `direction`)."""
    sin_phi = jnp.sin(M_TWOPI * r1)
    cos_phi = jnp.cos(M_TWOPI * r1)
    cos_theta = jnp.power(jnp.maximum(1.0 - r2, 1e-20), 1.0 / (power + 1.0))
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    dx = sin_theta * cos_phi
    dy = sin_theta * sin_phi
    dz = cos_theta

    nx, nz_ = coordinate_system_v2(direction)
    ny = nz_
    nz = direction  # after the swap in the reference: ny<->nz with ny=direction initially
    # reference: ny = direction; CoordinateSystemV2(ny, &nx, &nz); swap(ny, nz)
    # so final: nx from CSV2-s, ny = CSV2-t, nz = direction
    res = nx * dx[..., None] + ny * dy[..., None] + nz * dz[..., None]

    inv_sign = jnp.where(dot(direction, hit_norm) > 0.0, 1.0, -1.0)
    below = inv_sign * dot(res, hit_norm) < 0.0
    res_flipped = -nx * dx[..., None] + ny * dy[..., None] - nz * dz[..., None]
    return jnp.where(below[..., None], res_flipped, res)


def map_samples_to_disc(xy):
    """cglobals.h:188-231: [-1,1]^2 -> unit disc (note the sin/cos swap quirk)."""
    x, y = xy[..., 0], xy[..., 1]
    qpi = 0.25 * 3.141592654

    c1 = (x > y) & (x > -y)
    c2 = (x < y) & (x > -y)
    c3 = (x < y) & (x < -y)
    c4 = (x > y) & (x < -y)

    # guard divisions
    sx = jnp.where(x == 0.0, 1.0, x)
    sy = jnp.where(y == 0.0, 1.0, y)

    r = jnp.where(c1, x, jnp.where(c2, y, jnp.where(c3, -x, jnp.where(c4, -y, 0.0))))
    phi = jnp.where(c1, qpi * (y / sx),
          jnp.where(c2, qpi * (2.0 - x / sy),
          jnp.where(c3, qpi * (4.0 + y / sx),
          jnp.where(c4, qpi * (6.0 - x / sy), 0.0))))
    return jnp.stack([r * jnp.sin(phi), r * jnp.cos(phi)], axis=-1)


def epsilon_of_pos(hit_pos):
    """cglobals.h:233."""
    m = jnp.maximum(jnp.max(jnp.abs(hit_pos[..., :3]), axis=-1), 2.0 * GEPSILON)
    return m * GEPSILON


def offs_ray_pos(hit_pos, surface_norm, sample_dir):
    """cglobals.h:242-247."""
    sign = jnp.where(dot(sample_dir, surface_norm) < 0.0, -1.0, 1.0)
    eps = epsilon_of_pos(hit_pos)
    return hit_pos + (sign * eps)[..., None] * surface_norm


def pdf_a_to_w(pdf_a, dist, cos_there):
    """cglobals.h:265."""
    return (pdf_a * dist * dist) / jnp.maximum(cos_there, 1e-30)


def mis_heuristic_power1(p):
    return jnp.where(jnp.isfinite(p), jnp.abs(p), 0.0)


def mis_weight_heuristic(a, b):
    """Balance heuristic, power 1 (cglobals.h:277-282)."""
    pa = mis_heuristic_power1(a)
    pb = mis_heuristic_power1(b)
    w = pa / jnp.maximum(pa + pb, 1e-30)
    return jnp.where(jnp.isfinite(w), w, 0.0)


def mul_rows_2x4(row0, row1, v):
    """2x4 texture-matrix transform of uv (cglobals.h:315-321)."""
    x = row0[..., 0] * v[..., 0] + row0[..., 1] * v[..., 1] + row0[..., 3]
    y = row1[..., 0] * v[..., 0] + row1[..., 1] * v[..., 1] + row1[..., 3]
    return jnp.stack([x, y], axis=-1)


def sphere_map_to_phi_theta(ray_dir):
    """cglobals.h:335-347."""
    x = ray_dir[..., 2]
    y = ray_dir[..., 0]
    z = -ray_dir[..., 1]
    theta = safe_arccos(z)
    phi = jnp.arctan2(y, x)
    phi = jnp.where(phi < 0.0, phi + M_TWOPI, phi)
    return phi, theta


def sphere_map_to_2d_tex_coord(ray_dir):
    """cglobals.h:349-358. Returns (texCoord[...,2], sinTheta)."""
    phi, theta = sphere_map_to_phi_theta(ray_dir)
    tex_x = jnp.clip(phi * 0.5 * INV_PI, 0.0, 1.0)
    tex_y = jnp.clip(theta * INV_PI, 0.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - ray_dir[..., 1] * ray_dir[..., 1], 0.0))
    return jnp.stack([tex_x, tex_y], axis=-1), sin_theta


def tex_coord_2d_to_sphere_map(tex_coord):
    """cglobals.h:360-373. Returns (dir[...,3], sinTheta)."""
    phi = tex_coord[..., 0] * 2.0 * M_PI
    theta = tex_coord[..., 1] * M_PI
    sin_theta = jnp.sin(theta)
    x = sin_theta * jnp.cos(phi)
    y = sin_theta * jnp.sin(phi)
    z = jnp.cos(theta)
    return jnp.stack([y, -z, x], axis=-1), sin_theta


def reflect(d, n):
    """Mirror reflect direction d about normal n (LiteMath reflect)."""
    return d - 2.0 * dot(d, n)[..., None] * n


def eye_ray_dir_normalized(x, y, proj_inv):
    """cglobals.h:49-55: NDC pixel -> camera-space ray direction."""
    ndc = jnp.stack([2.0 * x - 1.0, 2.0 * y - 1.0,
                     jnp.zeros_like(x), jnp.ones_like(x)], axis=-1)
    pos = matvec(proj_inv, ndc)
    pos = pos / pos[..., 3:4]
    return normalize(pos[..., :3])
