"""Ray-scene intersection (the CrossRT analog, SURVEY.md §2.7).

Implements ``RayQuery_NearestHit`` / ``RayQuery_AnyHit`` over a world-space
triangle soup in two ways:

* ``intersect_brute`` — chunked all-triangles Moller-Trumbore, a
  ``lax.scan`` over triangle chunks.  Exact; the correctness oracle for BVH
  tests and fast for small scenes.
* ``intersect_bvh`` — stackless skip-pointer BVH2 traversal inside a
  ``lax.while_loop`` (vmapped over rays).  Flat node arrays come from
  ``build_bvh.build``.

Both are the XLA oracle: the GPU traces the same BVH with the per-ray kernel
in ``traverse_gpu.py``, which keeps ``intersect_bvh``'s contract.

Hit record convention matches CRT_Hit (CrossRT.h): coords[1]=u (weight of
vertex B), coords[0]=v (weight of C) — see EmbreeRT.cpp:350-352 and the
barycentric lerp in kernel_RayTrace2 (integrator_pt.cpp:270-271).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

FLT_MAX = 3.4e38


class Hit(NamedTuple):
    t: jnp.ndarray        # [N] f32, FLT_MAX when miss
    prim_id: jnp.ndarray  # [N] i32 per-mesh primitive id, -1 when miss
    inst_id: jnp.ndarray  # [N] i32
    geom_id: jnp.ndarray  # [N] i32, -1 when miss
    u: jnp.ndarray        # [N] f32  (weight of vertex B)
    v: jnp.ndarray        # [N] f32  (weight of vertex C)
    soup_id: jnp.ndarray  # [N] i32 flat triangle index (for baked shade rows)


def _moller_trumbore(ray_pos, ray_dir, v0, e1, e2, t_min, t_max, motion=None):
    """Batched ray x tri intersection.

    ray_pos/dir: [N,3]; v0/e1/e2: [T,3]. Returns (hit_mask, t, u, v): [T,N].

    Laid out triangles-major / rays-minor: every 2-D intermediate is [T, N]
    with the big ray dimension minor (contiguous).

    ``motion``: optional (dv0, de1, de2, time) for motion blur — triangle
    endpoints lerp per ray (RayQuery_NearestHitMotion, CrossRT.h:160-174);
    time is [N].
    """
    dx, dy, dz = ray_dir[None, :, 0], ray_dir[None, :, 1], ray_dir[None, :, 2]
    px, py, pz = ray_pos[None, :, 0], ray_pos[None, :, 1], ray_pos[None, :, 2]
    e1x, e1y, e1z = e1[:, None, 0], e1[:, None, 1], e1[:, None, 2]
    e2x, e2y, e2z = e2[:, None, 0], e2[:, None, 1], e2[:, None, 2]
    v0x, v0y, v0z = v0[:, None, 0], v0[:, None, 1], v0[:, None, 2]
    if motion is not None:
        dv0, de1, de2, time = motion
        tt = time[None, :]
        v0x = v0x + tt * dv0[:, None, 0]
        v0y = v0y + tt * dv0[:, None, 1]
        v0z = v0z + tt * dv0[:, None, 2]
        e1x = e1x + tt * de1[:, None, 0]
        e1y = e1y + tt * de1[:, None, 1]
        e1z = e1z + tt * de1[:, None, 2]
        e2x = e2x + tt * de2[:, None, 0]
        e2y = e2y + tt * de2[:, None, 1]
        e2z = e2z + tt * de2[:, None, 2]

    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = pvx * e1x + pvy * e1y + pvz * e1z
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    # tvec = p - v0
    tvx = px - v0x
    tvy = py - v0y
    tvz = pz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0)
           & (t > t_min[None, :]) & (t < t_max[None, :]))
    return hit, t, u, vv


def _round_chunk(T, chunk):
    """Pick a chunk that avoids padding tiny scenes up to huge widths."""
    if T <= 0:
        return chunk
    aligned = -(-T // 8) * 8
    return min(chunk, max(aligned, 8))


def intersect_brute(tri_v0, tri_e1, tri_e2, tri_inst, tri_geom, tri_prim,
                    ray_pos, ray_dir, t_min, t_max, chunk=512, motion=None):
    """Nearest hit over all triangles, scanning chunks to bound memory."""
    T = tri_v0.shape[0]
    chunk = _round_chunk(T, chunk)
    n_chunks = max(1, -(-T // chunk))
    pad = n_chunks * chunk - T
    if pad:
        padv = jnp.zeros((pad, 3), tri_v0.dtype)
        tri_v0 = jnp.concatenate([tri_v0, padv])
        tri_e1 = jnp.concatenate([tri_e1, padv])
        tri_e2 = jnp.concatenate([tri_e2, padv])
        padi = jnp.full((pad,), -1, jnp.int32)
        tri_inst = jnp.concatenate([tri_inst, padi])
        tri_geom = jnp.concatenate([tri_geom, padi])
        tri_prim = jnp.concatenate([tri_prim, padi])
        if motion is not None:
            motion = (jnp.concatenate([motion[0], padv]),
                      jnp.concatenate([motion[1], padv]),
                      jnp.concatenate([motion[2], padv]), motion[3])

    soup_ids = jnp.concatenate([
        jnp.arange(T, dtype=jnp.int32),
        jnp.full((n_chunks * chunk - T,), -1, jnp.int32)])
    v0c = tri_v0.reshape(n_chunks, chunk, 3)
    e1c = tri_e1.reshape(n_chunks, chunk, 3)
    e2c = tri_e2.reshape(n_chunks, chunk, 3)
    instc = tri_inst.reshape(n_chunks, chunk)
    geomc = tri_geom.reshape(n_chunks, chunk)
    primc = tri_prim.reshape(n_chunks, chunk)
    soupc = soup_ids.reshape(n_chunks, chunk)
    if motion is not None:
        dv0c = motion[0].reshape(n_chunks, chunk, 3)
        de1c = motion[1].reshape(n_chunks, chunk, 3)
        de2c = motion[2].reshape(n_chunks, chunk, 3)
        mtime = motion[3]

    N = ray_pos.shape[0]
    init = Hit(
        t=jnp.full((N,), FLT_MAX, jnp.float32),
        prim_id=jnp.full((N,), -1, jnp.int32),
        inst_id=jnp.full((N,), -1, jnp.int32),
        geom_id=jnp.full((N,), -1, jnp.int32),
        u=jnp.zeros((N,), jnp.float32),
        v=jnp.zeros((N,), jnp.float32),
        soup_id=jnp.full((N,), -1, jnp.int32))

    def body(best, tris):
        if motion is not None:
            v0, e1, e2, inst, geom, prim, soup, dv0, de1, de2 = tris
            mo = (dv0, de1, de2, mtime)
        else:
            v0, e1, e2, inst, geom, prim, soup = tris
            mo = None
        hit, t, u, v = _moller_trumbore(ray_pos, ray_dir, v0, e1, e2, t_min,
                                        t_max, mo)                 # [T, N]
        valid = hit & (geom[:, None] >= 0)
        t = jnp.where(valid, t, FLT_MAX)
        j = jnp.argmin(t, axis=0)                       # [N]
        tj = jnp.min(t, axis=0)
        closer = tj < best.t
        # row-select as a masked reduction (fuses into one [T,N] pass)
        sel = jnp.arange(t.shape[0], dtype=jnp.int32)[:, None] == j[None, :]
        gather = lambda a: jnp.sum(jnp.where(sel, a, 0.0), axis=0)
        best = Hit(
            t=jnp.where(closer, tj, best.t),
            prim_id=jnp.where(closer, prim[j], best.prim_id),
            inst_id=jnp.where(closer, inst[j], best.inst_id),
            geom_id=jnp.where(closer, geom[j], best.geom_id),
            u=jnp.where(closer, gather(u), best.u),
            v=jnp.where(closer, gather(v), best.v),
            soup_id=jnp.where(closer, soup[j], best.soup_id))
        return best, None

    if motion is not None:
        chunks = (v0c, e1c, e2c, instc, geomc, primc, soupc,
                  dv0c, de1c, de2c)
    else:
        chunks = (v0c, e1c, e2c, instc, geomc, primc, soupc)
    if n_chunks == 1:
        best, _ = body(init, tuple(c[0] for c in chunks))
    else:
        best, _ = jax.lax.scan(body, init, chunks)
    return best


def _moller_leaf(ray_pos, ray_dir, v0, e1, e2, t_min, t_max):
    """Single ray vs [K,3] leaf triangles. Returns (hit, t, u, v) each [K]."""
    d = ray_dir[None, :]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(pvec * e1, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = ray_pos[None, :] - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    vv = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0)
           & (t > t_min) & (t < t_max))
    return hit, t, u, vv


def _slab_test(ray_pos, inv_dir, bmin, bmax, t_min, t_max):
    t0 = (bmin - ray_pos) * inv_dir
    t1 = (bmax - ray_pos) * inv_dir
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(tn), t_min)
    far = jnp.minimum(jnp.min(tf), t_max)
    return near <= far


def intersect_bvh(bvh, tri_v0, tri_e1, tri_e2, tri_inst, tri_geom, tri_prim,
                  ray_pos, ray_dir, t_min, t_max, max_leaf=4, any_hit=False,
                  motion=None):
    """Stackless skip-pointer BVH traversal, vmapped over rays.

    ``bvh``: dict/pytree with bmin/bmax [M,3], skip [M], tri_offset [M],
    tri_count [M]; triangle arrays must already be in BVH leaf order.
    With ``motion=(dv0, de1, de2, time)`` the leaf triangles lerp by the
    ray's time (node bounds must already cover both endpoints).
    """
    bmin, bmax = bvh['bmin'], bvh['bmax']
    skip, toff, tcnt = bvh['skip'], bvh['tri_offset'], bvh['tri_count']
    if motion is None:
        mtime = jnp.zeros(ray_pos.shape[:-1], jnp.float32)
    else:
        mtime = motion[3]

    def one_ray(pos, d, tmin, tmax, time):
        inv_dir = jnp.where(jnp.abs(d) > 1e-20, 1.0 / d,
                            jnp.sign(d) * 1e20 + jnp.where(d == 0, 1e20, 0.0))

        def cond(state):
            node, best_t, best_i, _, _, done = state
            return (node >= 0) & ~done

        def body(state):
            node, best_t, best_i, best_u, best_v, done = state
            hit_box = _slab_test(pos, inv_dir, bmin[node], bmax[node], tmin, best_t)
            is_leaf = tcnt[node] > 0
            off = toff[node]

            # leaf intersection (max_leaf static unroll)
            def leaf_test(best_t, best_i, best_u, best_v):
                idx = off + jnp.arange(max_leaf)
                valid = (jnp.arange(max_leaf) < tcnt[node])
                idx = jnp.clip(idx, 0, tri_v0.shape[0] - 1)
                lv0, le1, le2 = tri_v0[idx], tri_e1[idx], tri_e2[idx]
                if motion is not None:
                    lv0 = lv0 + time * motion[0][idx]
                    le1 = le1 + time * motion[1][idx]
                    le2 = le2 + time * motion[2][idx]
                h, t, u, v = _moller_leaf(pos, d, lv0, le1, le2, tmin, best_t)
                h = h & valid
                t = jnp.where(h, t, FLT_MAX)
                k = jnp.argmin(t)
                # h[k]: a leaf without hits must not win when best_t is
                # above the FLT_MAX miss sentinel
                closer = h[k] & (t[k] < best_t)
                return (jnp.where(closer, t[k], best_t),
                        jnp.where(closer, idx[k], best_i),
                        jnp.where(closer, u[k], best_u),
                        jnp.where(closer, v[k], best_v))

            do_leaf = hit_box & is_leaf
            nt, ni, nu, nv = leaf_test(best_t, best_i, best_u, best_v)
            best_t = jnp.where(do_leaf, nt, best_t)
            new_best_i = jnp.where(do_leaf, ni, best_i)
            best_u = jnp.where(do_leaf, nu, best_u)
            best_v = jnp.where(do_leaf, nv, best_v)
            if any_hit:
                done = done | (do_leaf & (new_best_i != best_i))
            next_node = jnp.where(hit_box & ~is_leaf, node + 1, skip[node])
            return (next_node, best_t, new_best_i, best_u, best_v, done)

        init = (jnp.int32(0), tmax, jnp.int32(-1),
                jnp.float32(0), jnp.float32(0), jnp.bool_(False))
        _, best_t, best_i, best_u, best_v, _ = jax.lax.while_loop(cond, body, init)
        return best_t, best_i, best_u, best_v

    best_t, best_i, best_u, best_v = jax.vmap(one_ray)(ray_pos, ray_dir,
                                                       t_min, t_max, mtime)
    found = best_i >= 0
    safe = jnp.maximum(best_i, 0)
    return Hit(
        t=jnp.where(found, best_t, FLT_MAX),
        prim_id=jnp.where(found, tri_prim[safe], -1),
        inst_id=jnp.where(found, tri_inst[safe], -1),
        geom_id=jnp.where(found, tri_geom[safe], -1),
        u=best_u, v=best_v,
        soup_id=jnp.where(found, best_i, -1))


def any_hit_bvh(bvh, tri_v0, tri_e1, tri_e2, tri_geom,
                ray_pos, ray_dir, t_min, t_max, max_leaf=4, motion=None):
    hit = intersect_bvh(bvh, tri_v0, tri_e1, tri_e2,
                        jnp.zeros_like(tri_geom), tri_geom,
                        jnp.zeros_like(tri_geom),
                        ray_pos, ray_dir, t_min, t_max, max_leaf,
                        any_hit=True, motion=motion)
    return hit.geom_id >= 0


def any_hit_brute(tri_v0, tri_e1, tri_e2, tri_geom,
                  ray_pos, ray_dir, t_min, t_max, chunk=512, motion=None):
    """Shadow-ray occlusion test: any hit in (t_min, t_max)."""
    T = tri_v0.shape[0]
    chunk = _round_chunk(T, chunk)
    n_chunks = max(1, -(-T // chunk))
    pad = n_chunks * chunk - T
    if pad:
        padv = jnp.zeros((pad, 3), tri_v0.dtype)
        tri_v0 = jnp.concatenate([tri_v0, padv])
        tri_e1 = jnp.concatenate([tri_e1, padv])
        tri_e2 = jnp.concatenate([tri_e2, padv])
        tri_geom = jnp.concatenate([tri_geom, jnp.full((pad,), -1, jnp.int32)])
        if motion is not None:
            motion = (jnp.concatenate([motion[0], padv]),
                      jnp.concatenate([motion[1], padv]),
                      jnp.concatenate([motion[2], padv]), motion[3])

    v0c = tri_v0.reshape(n_chunks, chunk, 3)
    e1c = tri_e1.reshape(n_chunks, chunk, 3)
    e2c = tri_e2.reshape(n_chunks, chunk, 3)
    geomc = tri_geom.reshape(n_chunks, chunk)

    N = ray_pos.shape[0]

    def body(occluded, tris):
        if motion is not None:
            v0, e1, e2, geom, dv0, de1, de2 = tris
            mo = (dv0, de1, de2, motion[3])
        else:
            v0, e1, e2, geom = tris
            mo = None
        hit, _, _, _ = _moller_trumbore(ray_pos, ray_dir, v0, e1, e2,
                                        t_min, t_max, mo)          # [T, N]
        return occluded | jnp.any(hit & (geom[:, None] >= 0), axis=0), None

    if motion is not None:
        chunks = (v0c, e1c, e2c, geomc,
                  motion[0].reshape(n_chunks, chunk, 3),
                  motion[1].reshape(n_chunks, chunk, 3),
                  motion[2].reshape(n_chunks, chunk, 3))
    else:
        chunks = (v0c, e1c, e2c, geomc)
    if n_chunks == 1:
        occ, _ = body(jnp.zeros((N,), bool), tuple(c[0] for c in chunks))
    else:
        occ, _ = jax.lax.scan(body, jnp.zeros((N,), bool), chunks)
    return occ
