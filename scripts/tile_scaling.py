"""Honest tile-size scaling of the fused pass (chained rng, unique args)."""
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
    scene, meta = SB.load_scene(CORNELL, width=1024, height=768)
    for log2 in (15, 17, 18, 19, 20):
        N = 1 << log2
        pix = jnp.arange(N, dtype=jnp.int32) % (1024 * 768)
        rng = RNG.gen_init(jnp.arange(N, dtype=jnp.int32))
        f = jax.jit(lambda r, p, k: R._render_tile.__wrapped__(
            scene, meta, r, p, 2, 0, 4, k))
        k1 = max(1, (1 << 21) // N)      # constant total work per timing
        fb, rng = f(rng, pix, jnp.int32(1))
        jax.block_until_ready((fb, rng))
        t0 = time.time()
        fb, rng = f(rng, pix, jnp.int32(1))
        jax.block_until_ready((fb, rng))
        ms1 = (time.time() - t0) * 1e3
        t0 = time.time()
        fb, rng = f(rng, pix, jnp.int32(k1 + 1))
        jax.block_until_ready((fb, rng))
        msk = (time.time() - t0) * 1e3
        per_sample = (msk - ms1) / k1
        print(f'tile 2^{log2} ({N:8d}): 1-iter {ms1:9.3f} ms; '
              f'per-sample-iter {per_sample:9.3f} ms '
              f'-> {N / per_sample / 1e3:8.1f} Ms/s', flush=True)


if __name__ == '__main__':
    main()
