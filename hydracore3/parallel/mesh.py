"""Device mesh + sharding for multi-chip rendering (SURVEY.md §2.5).

The workload is pure data parallelism over rays/pixels: scene tables are
MB-scale and replicated, the framebuffer is sharded by pixel tile, and (in
the differentiable path) parameter gradients are ``psum``-all-reduced over
the ``data`` axis — the reference's per-OMP-thread gradient buffers + final
reduction (integrator_dr.cpp:1141-1204) become one collective.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

DATA_AXIS = 'data'


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (DATA_AXIS,))


@functools.lru_cache(maxsize=32)
def sharded_render_tile(mesh: Mesh, meta, integrator_type: int = 2,
                        render_layer: int = 0, channels: int = 4,
                        n_iters: int = 1):
    """Build a pjit-able function rendering a pixel batch sharded over chips.

    Per-pixel radiance stays local to the owning chip (no communication at
    all in the forward pass, matching SURVEY §2.5 P5).  Cached per
    (mesh, meta, config): a fresh shard_map closure per call would miss the
    jit cache and re-compile every invocation (this was exactly the bug
    that made the r2 scaling report measure XLA compiles, not renders)."""
    from .. import render as R

    def tile_fn(scene_, rng_state, pixel_ids):
        return R._render_tile.__wrapped__(scene_, meta, rng_state, pixel_ids,
                                          integrator_type, render_layer,
                                          channels, n_iters)

    fn = shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)), check_vma=False)
    return jax.jit(fn)


def init_distributed() -> Mesh:
    """Multi-host entry (SURVEY §2.5 'Distributed comm backend').

    When launched under a multi-process runtime (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID set), calls
    ``jax.distributed.initialize`` so jax.devices() spans every host's
    cards; otherwise it is a no-op.  Returns the global 1-D 'data' mesh:
    the cards of a host are joined all to all, so the mesh follows the
    algorithm alone.  The only cross-card traffic is pmean'd parameter
    grads and the image gather at save time (render_sharded keeps radiance
    local).
    """
    import os
    coord = os.environ.get('JAX_COORDINATOR_ADDRESS')
    nproc = os.environ.get('JAX_NUM_PROCESSES')
    if coord and nproc:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(os.environ.get('JAX_PROCESS_ID', '0')))
    return make_mesh()


def render_sharded(mesh: Mesh, scene, meta, spp: int, integrator: str = 'mispt',
                   channels: int = 4):
    """Render a full frame sharded over the mesh; each device owns a
    contiguous pixel stripe (per-host tile writes, one device_get at save).

    Pixels are padded to a multiple of the device count; the per-pixel RNG
    is keyed by pixel id so the image is bitwise IDENTICAL for any device
    count (P7 in SURVEY §2.5 — resharding-invariant determinism).
    """
    from .. import render as R
    from ..ops import rng as RNG

    n_dev = mesh.devices.size
    W, H = meta.width, meta.height
    N = W * H
    pad = (-N) % n_dev
    pixel_ids = jnp.arange(N + pad, dtype=jnp.int32)
    rng0 = RNG.gen_init(pixel_ids)

    itype = R.INTEGRATOR_BY_NAME[integrator]
    fn = sharded_render_tile(mesh, meta, itype, 0, channels,
                             n_iters=int(spp))
    fb, _ = fn(scene, rng0, pixel_ids)
    img = np.asarray(fb)[:N] / float(spp)
    return img.reshape(H, W, channels)


def _timed(f):
    import time as _time
    t0 = _time.time()
    f()
    return _time.time() - t0


def scaling_report(scene, meta, spp: int = 4,
                   device_counts=None, verbose: bool = True):
    """Rays/s WEAK-scaling efficiency harness (BASELINE: >= 80% at N hosts).

    Keeps the per-device workload constant by scaling the sample budget with
    the device count (n devices render the same frame at n*spp): weak-scaling
    efficiency = thr_n / (thr_1 * n) = T_1 / T_n.  On real cards this
    measures collective + partitioning overhead.  On a virtual
    CPU mesh the n 'devices' share the same host cores, so total throughput
    — not per-device efficiency — is the meaningful number there; it is
    reported as ``overhead_efficiency`` = thr_n / thr_1 (1.0 means sharding
    added no overhead on fixed physical compute).
    """
    import time as _time
    all_dev = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(all_dev)]
    shared_cores = all_dev[0].platform == 'cpu'
    rows = []
    base = None
    for n in device_counts:
        mesh = make_mesh(all_dev[:n])
        spp_n = spp * n  # weak scaling: constant per-device sample budget
        render_sharded(mesh, scene, meta, spp_n)  # compile+warm
        dt = min(_timed(lambda: render_sharded(mesh, scene, meta, spp_n))
                 for _ in range(3))
        samples = meta.width * meta.height * spp_n
        thr = samples / dt / 1e6
        if base is None:
            base = thr
        eff = thr / (base * n)
        ovh = thr / base
        rows.append(dict(devices=n, msamples_s=thr, weak_efficiency=eff,
                         overhead_efficiency=ovh))
        if verbose:
            if shared_cores:
                print(f'[scaling]: devices={n:3d} {thr:10.2f} Msamples/s '
                      f'overhead_efficiency={ovh:6.1%} (virtual CPU mesh: '
                      f'devices share host cores; weak eff meaningful on '
                      f'real chips only)', flush=True)
            else:
                print(f'[scaling]: devices={n:3d} {thr:10.2f} Msamples/s '
                      f'weak_efficiency={eff:6.1%}', flush=True)
    return rows


def sharded_train_step(mesh: Mesh, scene, meta, loss_fn):
    """DP training step: per-chip pixel shard, psum'd parameter gradients.

    loss_fn(params, scene, rng, pixel_ids, ref_pixels) -> scalar local loss.
    Returns jitted step(params, rng, pixel_ids, ref) -> (loss, grads) with
    grads already all-reduced over the mesh (jax.lax.pmean in shard_map).
    """
    def local_step(params, rng_state, pixel_ids, ref):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, rng_state,
                                                  pixel_ids, ref)
        loss = jax.lax.pmean(loss, DATA_AXIS)
        grads = jax.lax.pmean(grads, DATA_AXIS)
        return loss, grads

    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(fn)
