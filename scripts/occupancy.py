#!/usr/bin/env python3
"""Masked-pass occupancy: live-ray fraction per bounce.

Reference kmake_wave.json: the wavefront (compacted) GPU build exists
because masked whole-path kernels waste lanes once rays die.  This
measures the live fraction per bounce to decide whether a compaction pass
is worth it.

Usage: JAX_PLATFORMS=cpu python scripts/occupancy.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from hydracore3.scene import build as SB
from hydracore3.models import integrator_pt as IPT
from hydracore3.bsdf import dispatch as MAT
from hydracore3.ops import rng as RNG


def occupancy(scene, meta, n=1 << 14, depth=8):
    pix = jnp.arange(n, dtype=jnp.int32)

    @jax.jit
    def run(rng):
        state, _ = IPT.kernel_init_eye_ray(scene, meta, rng, pix, None)
        fracs = []
        for b in range(depth):
            live = ~IPT._is_dead(state.flags)
            fracs.append(jnp.mean(live.astype(jnp.float32)))
            state = IPT.kernel_ray_trace(scene, meta, state, bounce=b)
            sctx = None
            if not meta.has_blend:
                sctx = MAT.make_shading_ctx(
                    scene, meta, IPT._extract_mat_id(state.flags),
                    state.hit_norm, state.hit_tang, state.hit_uv)
            shade, rng2 = IPT.kernel_sample_light_source(
                scene, meta, state, b, IPT.INTEGRATOR_MIS_PT, IPT.FB_COLOR,
                None, shading_ctx=sctx)
            state = state._replace(rng=rng2)
            state = IPT.kernel_next_bounce(scene, meta, state, b, shade,
                                           IPT.INTEGRATOR_MIS_PT,
                                           IPT.FB_COLOR, None,
                                           shading_ctx=sctx)
        return jnp.stack(fracs)

    return [float(x) for x in run(RNG.gen_init(pix))]


def main():
    scenes = [
        ('cornell (closed, diffuse)',
         '/root/reference/scenes/test_035/statex_00001.xml'),
        ('ies room', '/root/reference/scenes/test_228/statex_00001.xml'),
    ]
    for name, path in scenes:
        scene, meta = SB.load_scene(path, width=128, height=128)
        fr = occupancy(scene, meta, depth=8)
        print(f'{name}: ' + ' '.join(f'{f:.2f}' for f in fr))


if __name__ == '__main__':
    main()
