"""Synthetic large-scene generator (the sponza-class benchmark scene).

The reference's perf baseline is defined on ~262k-triangle scenes (sponza /
cry_sponza, testing/perf.txt:2-8) which are not shipped in-repo; this module
synthesizes a deterministic scene of the same class — a city block grid with
subdivided building boxes, a ground plane and one large overhead area light —
through the in-process API (api.py, the hydra_api analog), so the big-scene
benchmark and its correctness tests are reproducible from the repo alone.

The default city uses diffuse/emissive materials; ``textured=True`` adds
procedural facade/asphalt textures and an env sky.  On the GPU it renders
through the XLA integrator with the per-ray BVH kernel
(accel/traverse_gpu.py) — the big-scene production routing.
"""
from __future__ import annotations

import tempfile

import numpy as np

_CACHE = {}


def _box(cx, cz, w, d, h, subdiv=3, with_uv=False):
    """Axis-aligned building box [cx±w, 0..h, cz±d], each face subdivided
    subdiv x subdiv; returns (pos [V,3], idx [T,3]) with +y up, plus
    facade UVs ([V,2], u along the face, v up, ~1 unit per world unit)
    when ``with_uv``."""
    quads = []   # (origin, edge_u, edge_v)
    x0, x1 = cx - w, cx + w
    z0, z1 = cz - d, cz + d
    # walls (outward-facing CCW)
    quads.append(((x0, 0, z1), (x1 - x0, 0, 0), (0, h, 0)))     # front +z
    quads.append(((x1, 0, z0), (x0 - x1, 0, 0), (0, h, 0)))     # back -z
    quads.append(((x1, 0, z1), (0, 0, z0 - z1), (0, h, 0)))     # right +x
    quads.append(((x0, 0, z0), (0, 0, z1 - z0), (0, h, 0)))     # left -x
    quads.append(((x0, h, z1), (x1 - x0, 0, 0), (0, 0, z0 - z1)))  # roof
    pos = []
    idx = []
    uv = []
    for (o, eu, ev) in quads:
        o = np.array(o, np.float32)
        eu = np.array(eu, np.float32)
        ev = np.array(ev, np.float32)
        lu = float(np.linalg.norm(eu))
        lv = float(np.linalg.norm(ev))
        base = len(pos)
        n = subdiv + 1
        for j in range(n):
            for i in range(n):
                pos.append(o + eu * (i / subdiv) + ev * (j / subdiv))
                uv.append((lu * i / subdiv, lv * j / subdiv))
        for j in range(subdiv):
            for i in range(subdiv):
                a = base + j * n + i
                b = a + 1
                c = a + n
                dd = c + 1
                idx.append((a, b, dd))
                idx.append((a, dd, c))
    out = (np.array(pos, np.float32), np.array(idx, np.int64))
    return out + (np.array(uv, np.float32),) if with_uv else out


def _ground(half, subdiv, with_uv=False):
    pos = []
    idx = []
    uv = []
    n = subdiv + 1
    for j in range(n):
        for i in range(n):
            pos.append((-half + 2 * half * i / subdiv, 0.0,
                        -half + 2 * half * j / subdiv))
            uv.append((2 * half * i / subdiv, 2 * half * j / subdiv))
    for j in range(subdiv):
        for i in range(subdiv):
            a = j * n + i
            b = a + 1
            c = a + n
            d = c + 1
            idx.append((a, d, b))
            idx.append((a, c, d))
    out = (np.array(pos, np.float32), np.array(idx, np.int64))
    return out + (np.array(uv, np.float32),) if with_uv else out


def _facade_texture(rng, tint, size=128, win=16):
    """Procedural building facade: window grid on a tinted wall, a few
    windows lit; uint8 LDR (sRGB like file textures)."""
    img = np.empty((size, size, 3), np.float32)
    img[:] = np.asarray(tint, np.float32)
    for jy in range(0, size, win):
        for jx in range(0, size, win):
            lit = rng.random() < 0.12
            pane = (np.array([0.95, 0.85, 0.55], np.float32) if lit
                    else np.array([0.06, 0.07, 0.10], np.float32))
            img[jy + 4:jy + win - 3, jx + 3:jx + win - 3] = pane
    img *= rng.uniform(0.82, 1.0, (size, size, 1)).astype(np.float32)
    return (np.clip(img, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)


def _asphalt_texture(rng, size=128):
    """Ground: noisy asphalt with light lane lines along both axes."""
    img = np.full((size, size, 3), 0.30, np.float32)
    img *= rng.uniform(0.8, 1.1, (size, size, 1)).astype(np.float32)
    img[:, size // 2 - 2:size // 2 + 2] = 0.75   # lane line (u axis)
    img[size // 2 - 2:size // 2 + 2, :] = 0.75
    return (np.clip(img, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)


def _sky_env_map(w=64, h=32):
    """Smooth lat-long gradient sky (float32 -> importance-sampled env)."""
    v = (np.arange(h, dtype=np.float32) + 0.5) / h          # 0 = up
    zen = np.array([0.22, 0.42, 0.95], np.float32)
    hor = np.array([0.95, 0.85, 0.70], np.float32)
    gnd = np.array([0.18, 0.16, 0.14], np.float32)
    t = np.clip(v * 2.0, 0.0, 1.0)[:, None]                 # upper half
    upper = zen[None] * (1 - t) + hor[None] * t
    col = np.where((v < 0.5)[:, None], upper, gnd[None])
    img = np.repeat(col[:, None, :], w, axis=1)
    return img.astype(np.float32)


def build_city(n_blocks: int = 48, subdiv: int = 3, seed: int = 7,
               width: int = 1024, height: int = 1024, depth: int = 5,
               ground_subdiv: int = 64, textured: bool = False):
    """Assemble the city as an HRSceneInst (not yet committed).

    n_blocks=48, subdiv=3, ground_subdiv=64 gives 48^2 * 90 + 2 * 64^2 =
    215,552 triangles (plus the light's two) — the sponza class.  Deterministic in (n_blocks, subdiv, seed).
    ``textured`` adds procedural facade/asphalt textures and a lat-long
    env map so the scene carries sponza-class SHADING load too (BASELINE.md
    rows 2-3 are textured scenes), not just sponza-class geometry."""
    from .. import api
    rng = np.random.default_rng(seed)
    hr = api.hr2_create_scene()

    if textured:
        t_ground = hr.texture_create(_asphalt_texture(rng), 'asphalt')
        t_walls = [hr.texture_create(_facade_texture(rng, c), f'facade{i}')
                   for i, c in enumerate([(0.65, 0.55, 0.45),
                                          (0.55, 0.60, 0.70),
                                          (0.70, 0.45, 0.40),
                                          (0.75, 0.70, 0.60)])]
        # facade repeats every 4 world units, asphalt every 8 (street pitch)
        fm = (0.25, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0)
        gm = (0.125, 0.0, 0.0, 0.0, 0.0, 0.125, 0.0, 0.0)
        m_ground = hr.material_create(name='ground',
                                      diffuse_color=(1.0, 1.0, 1.0),
                                      diffuse_tex_id=t_ground,
                                      diffuse_tex_matrix=gm)
        m_walls = [hr.material_create(name=f'wall{i}',
                                      diffuse_color=(1.0, 1.0, 1.0),
                                      diffuse_tex_id=t,
                                      diffuse_tex_matrix=fm)
                   for i, t in enumerate(t_walls)]
        t_env = hr.texture_create(_sky_env_map(), 'sky')
        hr.light_env(color=(1.0, 1.0, 1.0), multiplier=1.0, tex_id=t_env)
    else:
        m_ground = hr.material_create(name='ground',
                                      diffuse_color=(0.30, 0.30, 0.32))
        palette = [(0.65, 0.55, 0.45), (0.55, 0.60, 0.70),
                   (0.70, 0.45, 0.40), (0.50, 0.65, 0.50),
                   (0.75, 0.70, 0.60), (0.45, 0.50, 0.60)]
        m_walls = [hr.material_create(name=f'wall{i}', diffuse_color=c)
                   for i, c in enumerate(palette)]

    # city extent: blocks on an 8-unit pitch, streets between
    pitch = 8.0
    half = n_blocks * pitch * 0.5 + 20.0
    all_pos = []
    all_idx = []
    all_mat = []
    all_uv = []
    gp, gi, guv = _ground(half, ground_subdiv, with_uv=True)
    all_pos.append(gp)
    all_idx.append(gi)
    all_uv.append(guv)
    all_mat.append(np.full(len(gi), m_ground, np.uint32))
    voff = len(gp)
    for by in range(n_blocks):
        for bx in range(n_blocks):
            cx = (bx - n_blocks / 2 + 0.5) * pitch
            cz = (by - n_blocks / 2 + 0.5) * pitch
            w = rng.uniform(2.0, 3.2)
            d = rng.uniform(2.0, 3.2)
            h = rng.uniform(4.0, 28.0)
            p, i, uv = _box(cx + rng.uniform(-0.8, 0.8),
                            cz + rng.uniform(-0.8, 0.8), w, d, h, subdiv,
                            with_uv=True)
            all_pos.append(p)
            all_idx.append(i + voff)
            all_uv.append(uv)
            m = m_walls[int(rng.integers(len(m_walls)))]
            all_mat.append(np.full(len(i), m, np.uint32))
            voff += len(p)
    pos = np.concatenate(all_pos)
    idx = np.concatenate(all_idx).reshape(-1)
    mats = np.concatenate(all_mat)
    uvs = np.concatenate(all_uv)
    hr.mesh_from_data(pos, idx, mat_indices=mats, texc=uvs)
    hr.instance_add(0)

    # one big overhead area light (the 'sun'): high above the city center,
    # large enough that NEE samples spread over the whole city
    lm = np.eye(4, dtype=np.float32)
    lm[1, 3] = 60.0
    hr.light_area(color=(1.0, 1.0, 1.0), multiplier=16.0,
                  half_width=40.0, half_length=40.0, matrix=lm)

    # street-level-ish camera looking down an avenue
    hr.camera_set(fov=60.0, pos=(0.0, 14.0, half * 0.92),
                  look_at=(0.0, 4.0, 0.0), up=(0.0, 1.0, 0.0),
                  near=0.1, far=1000.0)
    hr.settings_set(width=width, height=height, depth=depth, spp=64)
    return hr


def build_instanced_city(n_blocks: int = 32, subdiv: int = 3, seed: int = 7,
                         width: int = 1024, height: int = 1024,
                         depth: int = 5, ground_subdiv: int = 32):
    """Instanced city variant: ONE building mesh + ground, n_blocks^2
    rotated/scaled instances — exercises the two-level path
    (accel/two_level.py) where geometry memory is O(mesh) while the
    flattened soup would be O(instances x mesh) (VulkanRTX/Embree TLAS,
    CrossRT.h:45-176)."""
    from .. import api
    rng = np.random.default_rng(seed)
    hr = api.hr2_create_scene()
    m_ground = hr.material_create(name='ground',
                                  diffuse_color=(0.30, 0.30, 0.32))
    m_wall = hr.material_create(name='wall', diffuse_color=(0.62, 0.55, 0.48))

    pitch = 8.0
    half = n_blocks * pitch * 0.5 + 20.0
    gp, gi = _ground(half, ground_subdiv)
    gm = hr.mesh_from_data(gp, gi.reshape(-1),
                           mat_indices=np.full(len(gi), m_ground, np.uint32))
    hr.instance_add(gm)
    bp, bi = _box(0.0, 0.0, 1.0, 1.0, 1.0, subdiv)   # unit building
    bm = hr.mesh_from_data(bp, bi.reshape(-1),
                           mat_indices=np.full(len(bi), m_wall, np.uint32))
    for by in range(n_blocks):
        for bx in range(n_blocks):
            cx = (bx - n_blocks / 2 + 0.5) * pitch + rng.uniform(-0.8, 0.8)
            cz = (by - n_blocks / 2 + 0.5) * pitch + rng.uniform(-0.8, 0.8)
            sx = rng.uniform(2.0, 3.2)
            sz = rng.uniform(2.0, 3.2)
            sy = rng.uniform(4.0, 28.0)
            a = rng.uniform(0, np.pi / 2)
            c, s = np.cos(a), np.sin(a)
            m = np.array([[c * sx, 0, s * sz, cx],
                          [0, sy, 0, 0],
                          [-s * sx, 0, c * sz, cz],
                          [0, 0, 0, 1]], np.float32)
            hr.instance_add(bm, m)

    lm = np.eye(4, dtype=np.float32)
    lm[1, 3] = 60.0
    hr.light_area(color=(1.0, 1.0, 1.0), multiplier=16.0,
                  half_width=40.0, half_length=40.0, matrix=lm)
    hr.camera_set(fov=60.0, pos=(0.0, 14.0, half * 0.92),
                  look_at=(0.0, 4.0, 0.0), up=(0.0, 1.0, 0.0),
                  near=0.1, far=1000.0)
    hr.settings_set(width=width, height=height, depth=depth, spp=64)
    return hr


def instanced_city_scene(n_blocks: int = 32, subdiv: int = 3, seed: int = 7,
                         width: int = 1024, height: int = 1024,
                         depth: int = 5, ground_subdiv: int = 32,
                         accel: str = 'auto', cache_dir: str = None):
    key = ('inst', n_blocks, subdiv, seed, width, height, depth,
           ground_subdiv, accel)
    if key in _CACHE:
        return _CACHE[key]
    hr = build_instanced_city(n_blocks, subdiv, seed, width, height, depth,
                              ground_subdiv)
    _CACHE[key] = _commit(hr, cache_dir, accel)
    return _CACHE[key]


def _commit(hr, cache_dir, accel):
    """Write the scene to ``cache_dir`` (a fresh temporary directory when
    None, removed after loading) and load it."""
    if cache_dir:
        return hr.commit(cache_dir, accel=accel)
    with tempfile.TemporaryDirectory(prefix='hydra_city_') as out_dir:
        return hr.commit(out_dir, accel=accel)


def city_scene(n_blocks: int = 48, subdiv: int = 3, seed: int = 7,
               width: int = 1024, height: int = 1024, depth: int = 5,
               ground_subdiv: int = 64, accel: str = 'auto',
               cache_dir: str = None, textured: bool = False):
    """Commit (and memoize) the city scene; returns (scene, meta)."""
    key = (n_blocks, subdiv, seed, width, height, depth, ground_subdiv,
           accel, textured)
    if key in _CACHE:
        return _CACHE[key]
    hr = build_city(n_blocks, subdiv, seed, width, height, depth,
                    ground_subdiv, textured=textured)
    _CACHE[key] = _commit(hr, cache_dir, accel)
    return _CACHE[key]
