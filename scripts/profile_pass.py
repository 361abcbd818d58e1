"""Stage-level timing of the MIS-PT sample pass on the device.

EVERY timed call receives unique argument values, so none can be elided or
served from a cache: each stage wrapper takes an extra eps scalar folded
into the state (value varies per call).

Usage: python scripts/profile_pass.py [tile_log2=15]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from hydracore3.scene import build as SB
from hydracore3 import render as R
from hydracore3.models import integrator_pt as IPT
from hydracore3.ops import rng as RNG
from hydracore3.bsdf import dispatch as MAT

CORNELL = '/root/reference/scenes/test_035/statex_00001.xml'


def chain_time(fn, state_args, n=20):
    """fn(eps, *state_args) -> out; eps varies per call (defeats caching)."""
    out = fn(jnp.float32(1e-12), *state_args)
    jax.block_until_ready(out)
    t0 = time.time()
    for i in range(n):
        out = fn(jnp.float32((i + 2) * 1e-12), *state_args)
    jax.block_until_ready(out)
    return (time.time() - t0) / n * 1e3


def main():
    tile_log2 = int(sys.argv[1]) if len(sys.argv) > 1 else 15
    N = 1 << tile_log2
    scene, meta = SB.load_scene(CORNELL, width=1024, height=768)
    print(f'backend={jax.default_backend()} tile={N} '
          f'tris={scene.tri_v0.shape[0]} mats={scene.mat_packed_f32.shape[0]}',
          flush=True)

    pix = jnp.arange(N, dtype=jnp.int32)
    rng0 = RNG.gen_init(pix)

    # dispatch floor (chained trivial op)
    g = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8,), jnp.float32)
    x = g(x); jax.block_until_ready(x)
    t0 = time.time()
    for _ in range(30):
        x = g(x)
    jax.block_until_ready(x)
    floor = (time.time() - t0) / 30 * 1e3
    print(f'dispatch floor: {floor:.3f} ms', flush=True)

    # fused whole-pass (chained rng)
    f = jax.jit(lambda r, p, k: R._render_tile.__wrapped__(
        scene, meta, r, p, 2, 0, 4, k))
    fb, rng = f(rng0, pix, jnp.int32(1)); jax.block_until_ready(rng)
    t0 = time.time()
    for _ in range(10):
        fb, rng = f(rng, pix, jnp.int32(1))
    jax.block_until_ready((fb, rng))
    ms_pass1 = (time.time() - t0) / 10 * 1e3
    t0 = time.time()
    fb, rng = f(rng, pix, jnp.int32(64))
    jax.block_until_ready((fb, rng))
    ms_pass64 = (time.time() - t0) * 1e3
    comp_per_sample = (ms_pass64 - ms_pass1) / 63.0
    print(f'full pass n_iters=1 : {ms_pass1:8.3f} ms', flush=True)
    print(f'full pass n_iters=64: {ms_pass64:8.3f} ms '
          f'-> per-sample compute {comp_per_sample:.3f} ms '
          f'({N / comp_per_sample / 1e3:.1f} Ms/s device ceiling)', flush=True)

    # ---- stage isolation (eps folded into ray_pos: unique args) ---------
    init = jax.jit(lambda e, r, p: IPT.kernel_init_eye_ray(
        scene, meta, r._replace(hi=r.hi + 0 * e.astype(jnp.uint32)) if hasattr(r, 'hi') else r, p, None))
    # rng state is a pytree/array; fold eps via pix instead
    init = jax.jit(lambda e, r, p: IPT.kernel_init_eye_ray(
        scene, meta, r, p + (e * 0).astype(jnp.int32), None))
    state0, _ = init(jnp.float32(0), rng0, pix)
    ms_init = chain_time(lambda e, r, p: init(e, r, p), (rng0, pix)) - floor

    def fold(st, e):
        return st._replace(ray_pos=st.ray_pos + e)

    trace = jax.jit(lambda e, st: IPT.kernel_ray_trace(
        scene, meta, fold(st, e), bounce=1))
    state1 = trace(jnp.float32(0), state0)
    ms_trace = chain_time(lambda e, st: trace(e, st), (state0,)) - floor

    mk_ctx = jax.jit(lambda e, st: MAT.make_shading_ctx(
        scene, meta, IPT._extract_mat_id(st.flags),
        st.hit_norm + e, st.hit_tang, st.hit_uv))
    ctx1 = mk_ctx(jnp.float32(0), state1)
    ms_ctx = chain_time(lambda e, st: mk_ctx(e, st), (state1,)) - floor

    nee = jax.jit(lambda e, st, ctx: IPT.kernel_sample_light_source(
        scene, meta, fold(st, e), 1, 2, 0, None, shading_ctx=ctx))
    shade1, _ = nee(jnp.float32(0), state1, ctx1)
    ms_nee = chain_time(lambda e, st, ctx: nee(e, st, ctx), (state1, ctx1)) - floor

    nxt = jax.jit(lambda e, st, sh, ctx: IPT.kernel_next_bounce(
        scene, meta, fold(st, e), 1, sh, 2, 0, None, shading_ctx=ctx))
    state2 = nxt(jnp.float32(0), state1, shade1, ctx1)
    ms_next = chain_time(lambda e, st, sh, ctx: nxt(e, st, sh, ctx),
                         (state1, shade1, ctx1)) - floor

    env = jax.jit(lambda e, st: IPT.kernel_hit_environment(
        scene, meta, fold(st, e), 2))
    ms_env = chain_time(lambda e, st: env(e, st), (state2,)) - floor

    depth = meta.trace_depth
    est = ms_init + depth * (ms_trace + ms_ctx + ms_nee + ms_next) + ms_env
    rows = [
        ('init_eye_ray (x1)', ms_init, 1),
        ('ray_trace', ms_trace, depth),
        ('shading_ctx', ms_ctx, depth),
        ('sample_light (NEE)', ms_nee, depth),
        ('next_bounce', ms_next, depth),
        ('hit_env (x1)', ms_env, 1),
    ]
    print(f'\nper-stage isolation, dispatch floor subtracted (depth={depth}):')
    for name, ms, mult in rows:
        print(f'  {name:22s} {ms:8.3f} ms x{mult}  = {ms * mult:8.3f} ms '
              f'({100 * ms * mult / est:5.1f}% of sum)', flush=True)
    print(f'  sum {est:8.3f} ms vs fused per-sample {comp_per_sample:8.3f} ms',
          flush=True)


if __name__ == '__main__':
    main()
