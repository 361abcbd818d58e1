"""Time one city pass through each trace route, on one GPU.

The textured 215k-triangle city (scene/synth.py) at 1024x1024, MIS path
tracing, depth 5, spp=4 in 1M-ray tiles (bench.py's city cell), rendered
with:

* ``kernel``: the per-ray BVH kernel (accel/traverse_gpu.py), bounce rays
  sorted: the default route;
* ``kernel_nosort``: the same without the bounce-ray sort;
* ``oracle``: the XLA ``intersect_bvh`` walk.

``kernel`` runs first and last, so the spread between its two runs bounds
what a difference between routes can mean.  Each route compiles once
(spp=1 warm-up, reported as set-up) and then renders spp=4.  One JSON line
per route goes to standard output and to chiprun_out/trace_routes.jsonl.

Usage: python scripts/trace_routes.py [--routes kernel,oracle,...]
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROUTES = ('kernel', 'kernel_nosort', 'oracle', 'kernel')


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--routes', default=','.join(ROUTES))
    ap.add_argument('--spp', type=int, default=4)
    args = ap.parse_args()

    import jax
    import numpy as np
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit('trace_routes: needs a GPU')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)

    from hydracore3 import render as R
    from hydracore3.scene import synth
    scene, meta = synth.city_scene(width=1024, height=1024, depth=5,
                                   textured=True)
    assert meta.use_kernel
    metas = dict(
        kernel=meta,
        kernel_nosort=dataclasses.replace(meta, sort_rays=False),
        oracle=dataclasses.replace(meta, use_kernel=False, use_bvh=True))
    from hydracore3.models import integrator_pt as IPT
    from hydracore3.ops import rng as RNG
    pix = jax.numpy.arange(1 << 16, dtype=jax.numpy.int32)
    n_near, n_shadow = jax.jit(lambda r: IPT.count_rays_pass(
        scene, meta, r, pix))(RNG.gen_init(pix))
    rays_per_sample = float(n_near + n_shadow) / pix.shape[0]
    out_dir = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    n_px = meta.width * meta.height
    with open(os.path.join(out_dir, 'trace_routes.jsonl'), 'a') as log:
        for route in args.routes.split(','):
            m = metas[route]
            t0 = time.perf_counter()
            R.render(scene, m, spp=1, tile_size=1 << 20)
            setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            img = R.render(scene, m, spp=args.spp, tile_size=1 << 20)
            dt = time.perf_counter() - t0
            row = dict(route=route, card=card, kind=dev.device_kind,
                       spp=args.spp, pass_s=dt / args.spp,
                       msamples_s=n_px * args.spp / dt / 1e6,
                       mrays_s=n_px * args.spp * rays_per_sample / dt / 1e6,
                       rays_per_sample=rays_per_sample,
                       setup_s=setup_s, image_mean=float(np.mean(img[..., :3])),
                       peak_bytes=dev.memory_stats().get('peak_bytes_in_use'))
            line = json.dumps(row)
            print(line, flush=True)
            log.write(line + '\n')


if __name__ == '__main__':
    main()
