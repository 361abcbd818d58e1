"""Binned-SAH BVH2 builder (host side, numpy).

The build-side of the CrossRT analog (SURVEY.md §2.7): triangles go into a
binary BVH built with a 16-bin surface-area heuristic, emitted as flat arrays
laid out for *stackless skip-pointer traversal* (each node knows where to go
on AABB hit vs miss), which maps onto vmapped XLA loops and the per-ray GPU
kernel (accel/traverse_gpu.py) without per-lane stacks — the same reasoning
that makes the reference's software-BVH variants (HeavyRT BVH2CommonLoft)
GPU-friendly.

Nodes are stored in DFS pre-order: an internal node's "hit" successor is
``i+1``; its "miss" successor is the skip pointer.  Leaves reference a
contiguous range of *reordered* triangles.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess

import numpy as np

N_BINS = 16
MAX_LEAF = 4

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'native')
_NATIVE_SRC = os.path.join(_NATIVE_DIR, 'bvh_builder.cpp')
_NATIVE_SO = os.path.join(_NATIVE_DIR, 'libhydra_native.so')
_native_lib = None
_native_tried = False


def _load_native():
    """Load (compiling if needed) the C++ builder; None if unavailable.

    The reference's BVH build is native (Embree3, EmbreeRT.cpp) — ours is
    too: native/bvh_builder.cpp, plain C ABI via ctypes."""
    global _native_lib, _native_tried
    if _native_tried:
        return _native_lib
    _native_tried = True
    try:
        need_build = (not os.path.exists(_NATIVE_SO) or
                      (os.path.exists(_NATIVE_SRC) and
                       os.path.getmtime(_NATIVE_SRC) > os.path.getmtime(_NATIVE_SO)))
        if need_build:
            if not os.path.exists(_NATIVE_SRC):
                return None
            subprocess.run(
                ['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
                 '-o', _NATIVE_SO, _NATIVE_SRC],
                check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(_NATIVE_SO)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.hydra_build_bvh.restype = ctypes.c_int32
        lib.hydra_build_bvh.argtypes = [f32p, f32p, ctypes.c_int32,
                                        ctypes.c_int32, f32p, f32p, i32p,
                                        i32p, i32p, i32p]
        _native_lib = lib
    except Exception:
        _native_lib = None
    return _native_lib


def _build_native(tmin: np.ndarray, tmax: np.ndarray,
                  max_leaf: int) -> 'FlatBVH | None':
    lib = _load_native()
    if lib is None:
        return None
    T = len(tmin)
    cap = 2 * T + 1
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    tri_offset = np.empty(cap, np.int32)
    tri_count = np.empty(cap, np.int32)
    order = np.empty(T, np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    tmin = np.ascontiguousarray(tmin, np.float32)
    tmax = np.ascontiguousarray(tmax, np.float32)
    n = lib.hydra_build_bvh(
        tmin.ctypes.data_as(f32p), tmax.ctypes.data_as(f32p),
        ctypes.c_int32(T), ctypes.c_int32(max_leaf),
        bmin.ctypes.data_as(f32p), bmax.ctypes.data_as(f32p),
        skip.ctypes.data_as(i32p), tri_offset.ctypes.data_as(i32p),
        tri_count.ctypes.data_as(i32p), order.ctypes.data_as(i32p))
    if n <= 0:
        return None
    return FlatBVH(bmin=bmin[:n].copy(), bmax=bmax[:n].copy(),
                   skip=skip[:n].copy(), tri_offset=tri_offset[:n].copy(),
                   tri_count=tri_count[:n].copy(), order=order)


@dataclasses.dataclass
class FlatBVH:
    bmin: np.ndarray        # [M, 3] f32
    bmax: np.ndarray        # [M, 3] f32
    skip: np.ndarray        # [M] i32: next node on AABB miss / after leaf (-1 = done)
    tri_offset: np.ndarray  # [M] i32: first triangle (leaves), -1 for internal
    tri_count: np.ndarray   # [M] i32: 0 for internal nodes
    order: np.ndarray       # [T] i32: new-to-old triangle permutation


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
          max_leaf: int = MAX_LEAF, motion_end=None,
          use_native: bool = True) -> FlatBVH:
    """``motion_end``: optional (v0_1, e1_1, e2_1) triangle endpoints at
    t=1 — node bounds then cover the whole motion segment (the conservative
    motion-blur BVH, VulkanRTX motion TLAS analog).

    Dispatches to the native C++ builder (native/bvh_builder.cpp) when
    available; the numpy path below is the reference implementation and
    fallback."""
    v0 = np.asarray(v0, np.float32)
    v1 = v0 + np.asarray(e1, np.float32)
    v2 = v0 + np.asarray(e2, np.float32)
    T = len(v0)
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    if motion_end is not None:
        v0b = np.asarray(motion_end[0], np.float32)
        v1b = v0b + np.asarray(motion_end[1], np.float32)
        v2b = v0b + np.asarray(motion_end[2], np.float32)
        tmin = np.minimum(tmin, np.minimum(np.minimum(v0b, v1b), v2b))
        tmax = np.maximum(tmax, np.maximum(np.maximum(v0b, v1b), v2b))
    return build_from_aabbs(tmin, tmax, max_leaf, use_native)


def build_from_aabbs(tmin: np.ndarray, tmax: np.ndarray,
                     max_leaf: int = MAX_LEAF,
                     use_native: bool = True) -> 'FlatBVH':
    """Build from per-primitive AABBs — used for both triangle BLASes and
    the instance TLAS (AddInstance/CommitScene analog, CrossRT.h:108-121)."""
    tmin = np.asarray(tmin, np.float32)
    tmax = np.asarray(tmax, np.float32)
    T = len(tmin)
    if use_native:
        native = _build_native(tmin, tmax, max_leaf)
        if native is not None:
            return native
    centroid = (tmin + tmax) * 0.5

    # recursion via explicit stack building a node list first (python objects)
    nodes = []  # (bmin, bmax, left_child, right_child, tri_ids)
    order: list[int] = []

    def make_node(ids: np.ndarray) -> int:
        idx = len(nodes)
        nb_min = tmin[ids].min(axis=0)
        nb_max = tmax[ids].max(axis=0)
        nodes.append([nb_min, nb_max, -1, -1, None])
        if len(ids) <= max_leaf:
            nodes[idx][4] = ids
            return idx
        # binned SAH over the widest centroid axis
        c = centroid[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            mid = len(ids) // 2
            l, r = ids[:mid], ids[mid:]
        else:
            rel = (c[:, axis] - cmin[axis]) / extent[axis]
            bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
            best_cost, best_split = np.inf, -1
            # prefix/suffix bounds over bins
            counts = np.zeros(N_BINS, np.int64)
            bb_min = np.full((N_BINS, 3), np.inf, np.float32)
            bb_max = np.full((N_BINS, 3), -np.inf, np.float32)
            for b in range(N_BINS):
                sel = bins == b
                counts[b] = sel.sum()
                if counts[b]:
                    bb_min[b] = tmin[ids[sel]].min(axis=0)
                    bb_max[b] = tmax[ids[sel]].max(axis=0)

            def area(mn, mx):
                d = np.maximum(mx - mn, 0)
                return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                              + d[..., 2] * d[..., 0])

            lmin = np.minimum.accumulate(bb_min, axis=0)
            lmax = np.maximum.accumulate(bb_max, axis=0)
            rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]
            for s in range(1, N_BINS):
                if lcnt[s - 1] == 0 or rcnt[s] == 0:
                    continue
                cost = (area(lmin[s - 1], lmax[s - 1]) * lcnt[s - 1]
                        + area(rmin[s], rmax[s]) * rcnt[s])
                if cost < best_cost:
                    best_cost, best_split = cost, s
            if best_split < 0:
                mid = len(ids) // 2
                l, r = ids[:mid], ids[mid:]
            else:
                sel = bins < best_split
                l, r = ids[sel], ids[~sel]
                if len(l) == 0 or len(r) == 0:
                    mid = len(ids) // 2
                    l, r = ids[:mid], ids[mid:]
        nodes[idx][2] = make_node(l)
        nodes[idx][3] = make_node(r)
        return idx

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, old_limit))
    try:
        make_node(np.arange(T))
    finally:
        sys.setrecursionlimit(old_limit)

    # flatten to DFS pre-order with skip pointers
    M = len(nodes)
    bmin = np.zeros((M, 3), np.float32)
    bmax = np.zeros((M, 3), np.float32)
    skip = np.full(M, -1, np.int32)
    tri_offset = np.full(M, -1, np.int32)
    tri_count = np.zeros(M, np.int32)
    flat_index = {}
    counter = [0]

    def assign(idx: int):
        my = counter[0]
        counter[0] += 1
        flat_index[idx] = my
        node = nodes[idx]
        if node[4] is None:
            assign(node[2])
            assign(node[3])

    sys.setrecursionlimit(max(10000, old_limit))
    assign(0)

    def fill(idx: int, skip_to: int):
        my = flat_index[idx]
        node = nodes[idx]
        bmin[my], bmax[my] = node[0], node[1]
        skip[my] = skip_to
        if node[4] is not None:
            tri_offset[my] = len(order)
            tri_count[my] = len(node[4])
            order.extend(int(i) for i in node[4])
        else:
            fill(node[2], flat_index[node[3]])
            fill(node[3], skip_to)

    fill(0, -1)
    return FlatBVH(bmin=bmin, bmax=bmax, skip=skip, tri_offset=tri_offset,
                   tri_count=tri_count, order=np.array(order, np.int32))
