"""Two-level acceleration structure: BLAS per mesh + TLAS over instances.

The CrossRT two-level contract (CrossRT.h:45-176: AddGeom_Triangles3f /
AddInstance(Motion) / CommitScene; queried via RayQuery_NearestHitMotion).
K instances of an N-triangle mesh cost O(N) device triangles (the flattened
world-space soup costs K*N), and motion blur lerps the INSTANCE MATRIX per
ray time — exactly the reference's semantics — instead of lerping triangle
endpoints.

Layout (all flat numpy/jnp arrays):
  * BLASes of all meshes concatenated; ``blas_node_base[g]`` is mesh g's
    root node, skip pointers are mesh-local (-1 terminates the mesh walk).
    Object-space triangles in BVH-leaf order, ``obj_tri_base[g]`` offsets.
  * TLAS: skip-pointer BVH over instance world AABBs (covering both motion
    endpoints), one instance per leaf.
  * Instances: both endpoint matrices; traversal inverts the time-lerped
    matrix per (ray, instance) — exact, like lerping the transform before
    the inverse on CPU (tools/litemath_shim/SimpleRT.cpp follows suit).

Traversal is the correctness-oracle form: per-ray nested while_loops under
vmap (the reference-style query, EmbreeRT.cpp:300-400).  It is also the
path instanced and motion scenes take on every platform.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import build_bvh

FLT_MAX = 3.4e38


@dataclasses.dataclass(frozen=True)
class TwoLevel:
    # BLAS (concatenated over meshes; node indices are GLOBAL, skip -1 ends)
    blas_bmin: jnp.ndarray      # [Mb,3]
    blas_bmax: jnp.ndarray      # [Mb,3]
    blas_skip: jnp.ndarray      # [Mb] GLOBAL index or -1
    blas_tri_offset: jnp.ndarray  # [Mb] GLOBAL triangle offset
    blas_tri_count: jnp.ndarray   # [Mb]
    blas_node_base: jnp.ndarray   # [G]
    # object-space triangles, BVH-leaf order
    obj_v0: jnp.ndarray         # [T,3]
    obj_e1: jnp.ndarray         # [T,3]
    obj_e2: jnp.ndarray         # [T,3]
    obj_prim_id: jnp.ndarray    # [T] original per-mesh primitive id
    # TLAS
    tlas_bmin: jnp.ndarray      # [Mt,3]
    tlas_bmax: jnp.ndarray      # [Mt,3]
    tlas_skip: jnp.ndarray      # [Mt]
    tlas_inst: jnp.ndarray      # [Mt] instance id for leaves, -1 internal
    # instances
    inst_m0: jnp.ndarray        # [I,16] row-major world matrix at t=0
    inst_m1: jnp.ndarray        # [I,16] at t=1 (== m0 when static)
    inst_nm0: jnp.ndarray       # [I,16] inverse-transpose (normal matrix) t=0
    inst_nm1: jnp.ndarray       # [I,16] t=1
    inst_geom: jnp.ndarray      # [I]
    inst_has_motion: jnp.ndarray  # [I] i32


jax.tree_util.register_dataclass(
    TwoLevel,
    data_fields=['blas_bmin', 'blas_bmax', 'blas_skip', 'blas_tri_offset',
                 'blas_tri_count', 'blas_node_base', 'obj_v0', 'obj_e1',
                 'obj_e2', 'obj_prim_id', 'tlas_bmin', 'tlas_bmax',
                 'tlas_skip', 'tlas_inst', 'inst_m0', 'inst_m1',
                 'inst_nm0', 'inst_nm1', 'inst_geom', 'inst_has_motion'],
    meta_fields=[])


def build_two_level(mesh_tris: list, instances: list, max_leaf: int = 4):
    """Host-side build.

    mesh_tris: per mesh (v0 [N,3], e1, e2) in OBJECT space.
    instances: list of dicts {geom_id, m0 [4,4], m1 [4,4] or None}.
    Returns a TwoLevel of numpy arrays (caller converts to jnp).
    """
    blas_bmin, blas_bmax, blas_skip = [], [], []
    blas_toff, blas_tcnt, node_base = [], [], []
    obj_v0, obj_e1, obj_e2, obj_prim = [], [], [], []
    mesh_bounds = []
    nbase = 0
    tbase = 0
    for (v0, e1, e2) in mesh_tris:
        b = build_bvh.build(v0, e1, e2, max_leaf=max_leaf)
        node_base.append(nbase)
        blas_bmin.append(b.bmin)
        blas_bmax.append(b.bmax)
        # globalize skip pointers and triangle offsets
        sk = b.skip.copy()
        sk[sk >= 0] += nbase
        blas_skip.append(sk)
        to = b.tri_offset.copy()
        to[to >= 0] += tbase
        blas_toff.append(to)
        blas_tcnt.append(b.tri_count)
        order = b.order
        obj_v0.append(np.asarray(v0, np.float32)[order])
        obj_e1.append(np.asarray(e1, np.float32)[order])
        obj_e2.append(np.asarray(e2, np.float32)[order])
        obj_prim.append(order.astype(np.int32))
        mesh_bounds.append((b.bmin[0] if len(b.bmin) else np.zeros(3),
                            b.bmax[0] if len(b.bmax) else np.zeros(3)))
        nbase += len(b.bmin)
        tbase += len(order)

    # instance world bounds over both endpoints (8 corners per endpoint)
    inst_bmin, inst_bmax = [], []
    inst_m0, inst_m1, inst_geom, inst_motion = [], [], [], []
    inst_nm0, inst_nm1 = [], []
    for inst in instances:
        g = inst['geom_id']
        m0 = np.asarray(inst['m0'], np.float32)
        m1 = np.asarray(inst['m1'], np.float32) if inst.get('m1') is not None else m0
        bmn, bmx = mesh_bounds[g]
        corners = np.array([[bmn[0] if i & 1 == 0 else bmx[0],
                             bmn[1] if i & 2 == 0 else bmx[1],
                             bmn[2] if i & 4 == 0 else bmx[2]]
                            for i in range(8)], np.float32)
        w0 = corners @ m0[:3, :3].T + m0[:3, 3]
        w1 = corners @ m1[:3, :3].T + m1[:3, 3]
        allw = np.concatenate([w0, w1])
        inst_bmin.append(allw.min(0))
        inst_bmax.append(allw.max(0))
        inst_m0.append(m0.reshape(16))
        inst_m1.append(m1.reshape(16))
        inst_nm0.append(np.linalg.inv(m0).T.astype(np.float32).reshape(16))
        inst_nm1.append(np.linalg.inv(m1).T.astype(np.float32).reshape(16))
        inst_geom.append(g)
        inst_motion.append(1 if inst.get('m1') is not None else 0)

    tl = build_bvh.build_from_aabbs(np.array(inst_bmin, np.float32),
                                    np.array(inst_bmax, np.float32),
                                    max_leaf=1)
    # leaves reference exactly one instance via the order permutation
    tlas_inst = np.full(len(tl.bmin), -1, np.int32)
    leaf = tl.tri_count > 0
    tlas_inst[leaf] = tl.order[tl.tri_offset[leaf]]

    return TwoLevel(
        blas_bmin=np.concatenate(blas_bmin),
        blas_bmax=np.concatenate(blas_bmax),
        blas_skip=np.concatenate(blas_skip),
        blas_tri_offset=np.concatenate(blas_toff),
        blas_tri_count=np.concatenate(blas_tcnt),
        blas_node_base=np.array(node_base, np.int32),
        obj_v0=np.concatenate(obj_v0),
        obj_e1=np.concatenate(obj_e1),
        obj_e2=np.concatenate(obj_e2),
        obj_prim_id=np.concatenate(obj_prim),
        tlas_bmin=tl.bmin, tlas_bmax=tl.bmax, tlas_skip=tl.skip,
        tlas_inst=tlas_inst,
        inst_m0=np.array(inst_m0, np.float32),
        inst_m1=np.array(inst_m1, np.float32),
        inst_nm0=np.array(inst_nm0, np.float32),
        inst_nm1=np.array(inst_nm1, np.float32),
        inst_geom=np.array(inst_geom, np.int32),
        inst_has_motion=np.array(inst_motion, np.int32))


def _inverse4x4(m):
    """Closed-form 4x4 inverse (cofactor expansion): pure elementwise
    arithmetic that fuses inside the vmapped while_loops (jnp.linalg.inv
    would lower to an LU factorization with dynamic pivoting per ray)."""
    a = [[m[..., r, c] for c in range(4)] for r in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (a[r0][c0] * (a[r1][c1] * a[r2][c2] - a[r1][c2] * a[r2][c1])
                - a[r0][c1] * (a[r1][c0] * a[r2][c2] - a[r1][c2] * a[r2][c0])
                + a[r0][c2] * (a[r1][c0] * a[r2][c1] - a[r1][c1] * a[r2][c0]))

    rows = (1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)
    cof = [[None] * 4 for _ in range(4)]
    for r in range(4):
        for c in range(4):
            rr = rows[r]
            cc = rows[c]
            sign = 1.0 if (r + c) % 2 == 0 else -1.0
            cof[r][c] = sign * det3(rr[0], rr[1], rr[2], cc[0], cc[1], cc[2])
    det = (a[0][0] * cof[0][0] + a[0][1] * cof[0][1]
           + a[0][2] * cof[0][2] + a[0][3] * cof[0][3])
    inv_det = jnp.where(det != 0.0, 1.0 / det, 0.0)
    # inverse = adjugate / det = transpose(cofactor) / det
    out = jnp.stack([jnp.stack([cof[c][r] * inv_det for c in range(4)], -1)
                     for r in range(4)], -2)
    return out


def _slab(pos, inv_dir, bmin, bmax, tmin, tmax):
    t0 = (bmin - pos) * inv_dir
    t1 = (bmax - pos) * inv_dir
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    return jnp.maximum(jnp.max(tn), tmin) <= jnp.minimum(jnp.min(tf), tmax)


def intersect_two_level(tl: TwoLevel, ray_pos, ray_dir, t_min, t_max,
                        time=None, any_hit: bool = False, max_leaf: int = 4):
    """Nearest-hit (or any-hit) query over the two-level structure.

    Returns (t, tri_idx(global, leaf order), inst_id, u, v); tri_idx = -1
    on miss.  Per-ray nested while_loops under vmap.
    """
    if time is None:
        time = jnp.zeros(ray_pos.shape[:-1], jnp.float32)
    T = tl.obj_v0.shape[0]

    def one_ray(wp, wd, tmin, tmax, tt):
        winv = jnp.where(jnp.abs(wd) > 1e-20, 1.0 / wd, 1e30)

        def blas_walk(inst_id, best):
            g = tl.inst_geom[inst_id]
            m0 = tl.inst_m0[inst_id].reshape(4, 4)
            m1 = tl.inst_m1[inst_id].reshape(4, 4)
            m = m0 + tt * (m1 - m0)
            inv = _inverse4x4(m)
            p = jnp.sum(inv[:3, :3] * wp, axis=1) + inv[:3, 3]   # exact f32
            d = jnp.sum(inv[:3, :3] * wd, axis=1)
            idir = jnp.where(jnp.abs(d) > 1e-20, 1.0 / d, 1e30)

            def cond(s):
                node, bt, bi, bu, bv, done = s
                return (node >= 0) & ~done

            def body(s):
                node, bt, bi, bu, bv, done = s
                hit_box = _slab(p, idir, tl.blas_bmin[node],
                                tl.blas_bmax[node], tmin, bt)
                is_leaf = tl.blas_tri_count[node] > 0
                off = tl.blas_tri_offset[node]

                idx = off + jnp.arange(max_leaf)
                valid = jnp.arange(max_leaf) < tl.blas_tri_count[node]
                idx = jnp.clip(idx, 0, T - 1)
                lv0 = tl.obj_v0[idx]
                le1 = tl.obj_e1[idx]
                le2 = tl.obj_e2[idx]
                pv = jnp.cross(d[None, :], le2)
                det = jnp.sum(pv * le1, axis=-1)
                invd = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
                tv = p[None, :] - lv0
                u = jnp.sum(tv * pv, axis=-1) * invd
                qv = jnp.cross(tv, le1)
                vv = jnp.sum(d[None, :] * qv, axis=-1) * invd
                t = jnp.sum(le2 * qv, axis=-1) * invd
                h = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (vv >= 0.0)
                     & (u + vv <= 1.0) & (t > tmin) & (t < bt) & valid)
                t = jnp.where(h, t, FLT_MAX)
                k = jnp.argmin(t)
                closer = hit_box & is_leaf & (t[k] < bt)
                nbt = jnp.where(closer, t[k], bt)
                nbi = jnp.where(closer, idx[k], bi)
                nbu = jnp.where(closer, u[k], bu)
                nbv = jnp.where(closer, vv[k], bv)
                ndone = done | (jnp.bool_(any_hit) & closer)
                nxt = jnp.where(hit_box & ~is_leaf, node + 1,
                                tl.blas_skip[node])
                return (nxt, nbt, nbi, nbu, nbv, ndone)

            root = tl.blas_node_base[g]
            init = (root, best[0], best[1], best[2], best[3], best[4])
            out = jax.lax.while_loop(cond, body, init)
            _, bt, bi, bu, bv, done = out
            # t strictly decreases on improvement (bi alone can collide when
            # two instances share a mesh and hit the same leaf triangle)
            new_inst = jnp.where(bt < best[0], inst_id, best[5])
            return (bt, bi, bu, bv, done, new_inst)

        def tcond(s):
            node, best = s
            return (node >= 0) & ~best[4]

        def tbody(s):
            node, best = s
            hit_box = _slab(wp, winv, tl.tlas_bmin[node], tl.tlas_bmax[node],
                            tmin, best[0])
            inst_id = tl.tlas_inst[node]
            is_leaf = inst_id >= 0

            def enter(_):
                return blas_walk(inst_id, best)

            best2 = jax.lax.cond(hit_box & is_leaf, enter, lambda _: best,
                                 operand=None)
            nxt = jnp.where(hit_box & ~is_leaf, node + 1, tl.tlas_skip[node])
            return (nxt, best2)

        init_best = (tmax, jnp.int32(-1), jnp.float32(0), jnp.float32(0),
                     jnp.bool_(False), jnp.int32(-1))
        _, best = jax.lax.while_loop(tcond, tbody, (jnp.int32(0), init_best))
        bt, bi, bu, bv, _, binst = best
        return bt, bi, bu, bv, binst

    bt, bi, bu, bv, binst = jax.vmap(one_ray)(ray_pos, ray_dir, t_min, t_max,
                                              time)
    found = bi >= 0
    return (jnp.where(found, bt, FLT_MAX), bi,
            jnp.where(found, binst, -1), bu, bv)
