"""Measure the per-dispatch cost of the fused pass on the device.

Every timing loop CHAINS varying inputs (the rng state feeds back), so no
call can be elided or served from a cache of identical calls.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from hydracore3.scene import build as SB
from hydracore3 import render as R
from hydracore3.ops import rng as RNG

CORNELL = '/root/reference/scenes/test_035/statex_00001.xml'


def main():
    N = 1 << 15
    scene, meta = SB.load_scene(CORNELL, width=1024, height=768)
    pix = jnp.arange(N, dtype=jnp.int32)
    rng0 = RNG.gen_init(pix)
    print(f'backend={jax.default_backend()} '
          f'leaves={len(jax.tree_util.tree_leaves(scene))}', flush=True)

    def run_chained(fn, rng, k, n):
        fb, rng = fn(rng, pix, jnp.int32(k))       # warm/compile
        jax.block_until_ready(rng)
        t0 = time.time()
        for _ in range(n):
            fb, rng = fn(rng, pix, jnp.int32(k))   # rng feeds back: unique args
        jax.block_until_ready((fb, rng))
        dt = (time.time() - t0) / n
        print(f'  n_iters={k:3d}: {dt * 1e3:9.3f} ms/dispatch '
              f'-> {N * k / dt / 1e6:9.1f} Ms/s', flush=True)
        return rng

    print('scene-as-args:', flush=True)
    f_arg = jax.jit(lambda r, p, k: R._render_tile.__wrapped__(
        scene, meta, r, p, 2, 0, 4, k))
    # NOTE closure vs args distinction only matters if arg marshalling is
    # expensive; test that separately below
    rng = run_chained(f_arg, rng0, 1, 20)
    rng = run_chained(f_arg, rng, 8, 10)
    rng = run_chained(f_arg, rng, 64, 5)
    rng = run_chained(f_arg, rng, 256, 3)

    f_scene_arg = jax.jit(lambda s, r, p, k: R._render_tile.__wrapped__(
        s, meta, r, p, 2, 0, 4, k))

    def run_chained2(fn, rng, k, n):
        fb, rng = fn(scene, rng, pix, jnp.int32(k))
        jax.block_until_ready(rng)
        t0 = time.time()
        for _ in range(n):
            fb, rng = fn(scene, rng, pix, jnp.int32(k))
        jax.block_until_ready((fb, rng))
        dt = (time.time() - t0) / n
        print(f'  n_iters={k:3d}: {dt * 1e3:9.3f} ms/dispatch '
              f'-> {N * k / dt / 1e6:9.1f} Ms/s', flush=True)
        return rng

    print('scene passed as 93-leaf arg pytree:', flush=True)
    rng = run_chained2(f_scene_arg, rng, 1, 20)
    rng = run_chained2(f_scene_arg, rng, 64, 5)

    # pure dispatch floor: trivial chained computation
    g = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8,), jnp.float32)
    x = g(x)
    jax.block_until_ready(x)
    t0 = time.time()
    for _ in range(50):
        x = g(x)
    jax.block_until_ready(x)
    print(f'trivial chained dispatch: {(time.time() - t0) / 50 * 1e3:.3f} ms',
          flush=True)


if __name__ == '__main__':
    main()
