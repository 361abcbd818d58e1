"""Per-ray BVH2 traversal kernel for the GPU (Pallas, Triton route).

One ray per lane, blocks of ``BLOCK`` rays (one lane per thread).  Each
lane walks the stackless skip-pointer BVH that ``build_bvh.build`` makes
for the XLA oracle (``traverse.intersect_bvh``): on an AABB hit an
internal node continues at ``node + 1``, otherwise (and after a leaf) at
its skip pointer.  The block loops while any of its lanes is still
walking; nodes and triangles are gathered per lane from device memory
(the city's ~11 MB of nodes and triangles stays in the 50 MB L2), with plain
f32 arithmetic — the standard GPU design for this workload (Aila & Laine,
"Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009).

Contract (kept identical to ``intersect_bvh``):

* returns ``(t, tri, u, v)``: ``t`` is ``FLT_MAX`` and ``tri`` is -1 on a
  miss, ``tri`` indexes the leaf-ordered soup, ``u``/``v`` are the
  barycentric weights of vertices B and C (0 on a miss);
* a triangle hits when ``t_min < t < t_max`` (Moller-Trumbore on the
  e1/e2 edge form, the same formula as ``_moller_leaf``); within a leaf
  and across leaves the first closest triangle in leaf order wins;
* a lane with ``t_max <= t_min`` (e.g. ``t_max = 0`` for dead rays) does
  no work;
* ``any_hit=True`` stops a lane at its first hit (shadow rays).

The result is constant under differentiation: hits are discrete and the
renderer's gradients flow through shading only (models/dr.py), so the
wrapper stops gradients at its inputs and the ``pallas_call`` is never
differentiated.

``interpret=True`` runs the same kernel through the Pallas interpreter
(the CPU tests); nothing picks it implicitly.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .traverse import FLT_MAX

NODE_W = 8    # f32 words per node row: bmin xyz, bmax xyz, skip, leaf word
TRI_W = 9     # f32 words per triangle: v0 xyz, e1 xyz, e2 xyz
MAX_LEAF = 4  # triangles per leaf (build_bvh.MAX_LEAF)
BLOCK = 128   # rays per block (256 measured slower on the H100)


def pack(bmin, bmax, skip, tri_offset, tri_count, v0, e1, e2):
    """Host-side packing of a ``build_bvh.FlatBVH`` and its leaf-ordered
    triangles into the kernel's two flat tables.

    Node row (32 bytes, one memory sector): bmin, bmax, then two int32
    words stored bit-for-bit in the f32 row — the skip pointer and the
    leaf word ``tri_offset * 8 + tri_count`` (0 for internal nodes).
    Returns ``(nodes [M * 8] f32, tris [T * 9] f32)``."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    cnt = np.asarray(tri_count, np.int64)
    if cnt.max(initial=0) > MAX_LEAF:
        raise ValueError(f'leaves hold at most {MAX_LEAF} triangles')
    leaf = np.where(cnt > 0, np.maximum(np.asarray(tri_offset, np.int64), 0)
                    * 8 + cnt, 0)
    if leaf.max(initial=0) >= 2 ** 31:
        raise ValueError('too many triangles for the 32-bit leaf word')
    ints = np.stack([np.asarray(skip, np.int32), leaf.astype(np.int32)], 1)
    nodes = np.concatenate([bmin, bmax, ints.view(np.float32)], axis=1)
    tris = np.concatenate([np.asarray(v0, np.float32),
                           np.asarray(e1, np.float32),
                           np.asarray(e2, np.float32)], axis=1)
    return (np.ascontiguousarray(nodes).reshape(-1),
            np.ascontiguousarray(tris).reshape(-1))


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmin_ref,
            tmax_ref, nodes_ref, tris_ref, t_ref, tri_ref, u_ref, v_ref, *,
            n_tris, any_hit):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    tmin = tmin_ref[...]
    tmax = tmax_ref[...]

    def inv(d):
        # same guard as intersect_bvh: axis-parallel rays get +-1e20
        big = jnp.where(d < 0.0, -1e20, 1e20)
        return jnp.where(jnp.abs(d) > 1e-20, 1.0 / d, big)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)

    def cond(c):
        return jnp.max(c[0]) >= 0

    def body(c):
        node, bt, bi, bu, bv = c
        act = node >= 0
        row = jnp.maximum(node, 0) * NODE_W

        def nf(k):
            return nodes_ref[row + k]

        def slab(lo, hi, o, i):
            a = (lo - o) * i
            b = (hi - o) * i
            return jnp.minimum(a, b), jnp.maximum(a, b)

        nx, fx = slab(nf(0), nf(3), ox, ix)
        ny, fy = slab(nf(1), nf(4), oy, iy)
        nz, fz = slab(nf(2), nf(5), oz, iz)
        near = jnp.maximum(jnp.maximum(jnp.maximum(nx, ny), nz), tmin)
        far = jnp.minimum(jnp.minimum(jnp.minimum(fx, fy), fz), bt)
        hit_box = act & (near <= far)
        skip = jax.lax.bitcast_convert_type(nf(6), jnp.int32)
        leaf = jax.lax.bitcast_convert_type(nf(7), jnp.int32)
        cnt = leaf & 7
        off = leaf >> 3
        is_leaf = cnt > 0
        do_leaf = hit_box & is_leaf
        found = jnp.zeros_like(act)
        for k in range(MAX_LEAF):
            tri = jnp.minimum(off + k, n_tris - 1)
            base = tri * TRI_W

            def tf(j):
                return tris_ref[base + j]

            v0x, v0y, v0z = tf(0), tf(1), tf(2)
            e1x, e1y, e1z = tf(3), tf(4), tf(5)
            e2x, e2y, e2z = tf(6), tf(7), tf(8)
            # Moller-Trumbore, term order as traverse._moller_leaf
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = (px * e1x + py * e1y) + pz * e1z
            ok = jnp.abs(det) > 1e-12
            inv_det = jnp.where(ok, 1.0 / det, 0.0)
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = ((tx * px + ty * py) + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = ((dx * qx + dy * qy) + dz * qz) * inv_det
            t = ((e2x * qx + e2y * qy) + e2z * qz) * inv_det
            h = (do_leaf & (k < cnt) & ok & (u >= 0.0) & (v >= 0.0)
                 & (u + v <= 1.0) & (t > tmin) & (t < bt))
            bt = jnp.where(h, t, bt)
            bi = jnp.where(h, off + k, bi)
            bu = jnp.where(h, u, bu)
            bv = jnp.where(h, v, bv)
            found = found | h
        nxt = jnp.where(hit_box & ~is_leaf, node + 1, skip)
        if any_hit:
            nxt = jnp.where(found, -1, nxt)
        node = jnp.where(act, nxt, node)
        return node, bt, bi, bu, bv

    node0 = jnp.where(tmax > tmin, 0, -1).astype(jnp.int32)
    init = (node0, tmax, jnp.full_like(node0, -1), jnp.zeros_like(tmax),
            jnp.zeros_like(tmax))
    _, bt, bi, bu, bv = jax.lax.while_loop(cond, body, init)
    t_ref[...] = jnp.where(bi >= 0, bt, FLT_MAX)
    tri_ref[...] = bi
    u_ref[...] = bu
    v_ref[...] = bv


@functools.partial(jax.jit, static_argnames=('any_hit', 'interpret'))
def _intersect(nodes, tris, ray_pos, ray_dir, t_min, t_max, any_hit,
               interpret):
    n = ray_pos.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    pad = n_pad - n

    def lane(x, fill=0.0):
        x = x.astype(jnp.float32)
        return jnp.pad(x, (0, pad), constant_values=fill) if pad else x

    rays = [lane(ray_pos[:, k]) for k in range(3)]
    rays += [lane(ray_dir[:, k], 1.0) for k in range(3)]
    # padded lanes get an empty interval: they do no work
    rays += [lane(t_min, 1.0), lane(t_max, 0.0)]
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    out_f = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    out_i = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    kernel = functools.partial(_kernel, n_tris=tris.shape[0] // TRI_W,
                               any_hit=any_hit)
    t, tri, u, v = pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[ray_spec] * 8 + [
            pl.BlockSpec(nodes.shape, lambda i: (0,)),
            pl.BlockSpec(tris.shape, lambda i: (0,))],
        out_specs=[ray_spec] * 4,
        out_shape=[out_f, out_i, out_f, out_f],
        compiler_params=plgpu.CompilerParams(num_warps=BLOCK // 32,
                                             num_stages=1),
        backend='triton',
        interpret=interpret,
        name='bvh_trace_any' if any_hit else 'bvh_trace_nearest',
    )(*rays, nodes, tris)
    return t[:n], tri[:n], u[:n], v[:n]


def intersect(nodes, tris, ray_pos, ray_dir, t_min, t_max, any_hit=False,
              interpret=False):
    """Nearest (or any) hit of ``[N]`` rays against the packed BVH.

    ``nodes``/``tris`` come from ``pack``.  Returns ``(t, tri, u, v)`` as
    described in the module docstring.  The trace is a constant under
    differentiation (see the module docstring)."""
    args = jax.lax.stop_gradient((nodes, tris, ray_pos, ray_dir, t_min, t_max))
    return _intersect(*args, any_hit=any_hit, interpret=interpret)
