"""Smoke test of the renderer on one GPU (or, with --four-cards, on four).

Runs the main path once at full size: the 215k-triangle textured synthetic
city (scene/synth.py) rendered with MIS path tracing at 1024x1024, spp=4,
through ``render.render`` with the per-ray BVH kernel compiled for the card
(no Pallas interpret mode, no CPU fallback).  Phases, each printing its
numbers on one line:

1. device: platform, kind, count, and the card's name and power limit;
2. render: finite, non-black image whose 8x downsample matches the
   committed golden (tests/goldens/city_bench_128.npz);
3. trace parity: camera, bounce and shadow rays over the full soup through
   the kernel and through the XLA oracle (``intersect_bvh``), with timings;
4. gradient: ``jax.grad`` of an image loss with respect to the ground
   texture through a kernel-routed render, against the oracle route.

``--four-cards`` runs only the four-card phase: ``render_sharded`` and
``sharded_train_step`` over a 4-device 'data' mesh against one card.

Usage: ``python chip_smoke.py [--four-cards]``.  Exits non-zero, printing
no result, when JAX finds no GPU or any phase fails.  The last line of
standard output is one JSON object with ``ok`` and the device.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, 'tests', 'goldens', 'city_bench_128.npz')
CITY = dict(width=1024, height=1024, depth=5, textured=True)
SPP = 4
TILE = 1 << 20

# Golden PSNR floor.  The golden is this pipeline's own 8x-downsampled
# spp=16 render; at spp=4 the downsample averages 256 samples per golden
# pixel, so Monte Carlo noise alone leaves the PSNR in the 50s of dB.  A
# trace or shading fault (lost hits, wrong triangle, wrong texel) changes
# whole regions and drops it below 35 dB.
PSNR_MIN = 40.0
# Trace parity.  Kernel and oracle evaluate the same f32 formulas on the
# same BVH in the same leaf order; only instruction-level rounding differs
# (FMA contraction), which can flip a ray that grazes an edge or ends
# within an ulp of its interval.  So nearly every ray must agree exactly.
HIT_AGREE_MIN = 0.9999   # share of rays with the same hit/miss
TRI_AGREE_MIN = 0.999    # share of hits on the same triangle
T_RTOL = 1e-4            # t relative error where both hit one triangle
# Gradient: both routes run the same samples; a flipped ray moves at most
# a few texels' worth of one sample.
GRAD_RTOL = 1e-2         # ||g_kernel - g_oracle|| / ||g_oracle||
# Four cards: the per-pixel RNG makes the sharded frame the same samples
# as one card's; programs compiled for other shapes may round differently.
SHARD_ATOL = 1e-5
SHARD_GRAD_RTOL = 1e-4


def phase(name, **numbers):
    print(json.dumps(dict(phase=name, **numbers)), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(f, *args, reps=3):
    import jax
    jax.block_until_ready(f(*args))
    best = float('inf')
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def device_phase(want):
    import jax
    devs = jax.devices()
    d = devs[0]
    if d.platform != 'gpu':
        sys.exit(f'chip_smoke: no GPU (JAX default device is {d.platform})')
    if len(devs) < want:
        sys.exit(f'chip_smoke: {want} GPUs needed, JAX sees {len(devs)}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    phase('device', platform=d.platform, kind=d.device_kind, count=len(devs))
    return d


def load_city():
    from hydracore3.scene import synth
    t0 = time.perf_counter()
    scene, meta = synth.city_scene(**CITY)
    check(meta.use_kernel and not meta.kernel_interpret,
          'the city must route to the compiled GPU kernel')
    phase('scene', tris=meta.num_tris, build_s=time.perf_counter() - t0)
    return scene, meta


def psnr_vs_golden(img, meta):
    gold = np.load(GOLDEN)['img'].astype(np.float32)
    im = np.asarray(img)[..., :3].astype(np.float32)
    ds = im.reshape(128, meta.height // 128, 128, meta.width // 128,
                    3).mean((1, 3))
    mse = float(np.mean((ds - gold) ** 2))
    peak = max(float(gold.max()), 1e-9)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def render_phase(scene, meta):
    from hydracore3 import render as R
    t0 = time.perf_counter()
    img, timing = R.render(scene, meta, spp=SPP, integrator='mispt',
                           tile_size=TILE, return_timing=True)
    wall = time.perf_counter() - t0
    img = np.asarray(img)
    check(img.shape == (meta.height, meta.width, 4), f'shape {img.shape}')
    check(np.isfinite(img).all(), 'non-finite pixels')
    mean = float(img[..., :3].mean())
    check(mean > 0.0, 'black image')
    p = psnr_vs_golden(img, meta)
    phase('render', spp=SPP, wall_s=wall, compile_s=timing['compile_s'],
          mean=mean, psnr_vs_golden_db=p, psnr_min_db=PSNR_MIN)
    check(p >= PSNR_MIN, f'PSNR {p:.2f} dB below {PSNR_MIN} dB')
    return img


def ray_sets(scene, meta, n):
    """Camera rays, their cosine-weighted bounce rays and shadow rays to the
    overhead light, from the oracle's camera hits."""
    import jax
    import jax.numpy as jnp
    from hydracore3.models import integrator_pt as IPT
    from hydracore3.ops import rng as RNG
    from hydracore3.utils import lmath as LM
    pix = jnp.arange(n, dtype=jnp.int32) * 7 % (meta.width * meta.height)
    st, _ = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix), pix)
    tmin = jnp.zeros((n,), jnp.float32)
    tmax = jnp.full((n,), 3.0e38, jnp.float32)
    cam = (st.ray_pos, st.ray_dir, tmin, tmax)
    hit = jax.jit(lambda s: IPT.kernel_ray_trace(
        scene, dataclasses.replace(meta, use_kernel=False), s, 0))(st)
    live = ~IPT._is_dead(hit.flags)
    k1, k2 = jax.random.split(jax.random.key(0))
    n_ = hit.hit_norm
    org = hit.hit_pos + n_ * 1e-4
    bdir = LM.normalize(n_ + LM.normalize(jax.random.normal(k1, (n, 3))))
    bounce = (org, bdir, tmin, jnp.where(live, 3.0e38, 0.0))
    target = jnp.concatenate([
        jax.random.uniform(k2, (n, 1), minval=-40.0, maxval=40.0),
        jnp.full((n, 1), 60.0),
        jax.random.uniform(jax.random.fold_in(k2, 1), (n, 1), minval=-40.0,
                           maxval=40.0)], 1)
    to = target - org
    dist = jnp.sqrt(jnp.sum(to * to, -1))
    shadow = (org, to / dist[:, None], tmin,
              jnp.where(live, dist * 0.9995, 0.0))
    return dict(camera=cam, bounce=bounce, shadow=shadow)


def trace_phase(scene, meta, n=1 << 17):
    import jax
    from hydracore3.accel import traverse as ACC
    from hydracore3.accel import traverse_gpu as TG
    bvh = dict(bmin=scene.bvh_bmin, bmax=scene.bvh_bmax, skip=scene.bvh_skip,
               tri_offset=scene.bvh_tri_offset, tri_count=scene.bvh_tri_count)
    sets = ray_sets(scene, meta, n)
    for name, (o, d, t0, t1) in sets.items():
        any_hit = name == 'shadow'
        kern = jax.jit(lambda o, d, a, b: TG.intersect(
            scene.kn_nodes, scene.kn_tris, o, d, a, b, any_hit=any_hit,
            interpret=meta.kernel_interpret))
        orac = jax.jit(lambda o, d, a, b: ACC.intersect_bvh(
            bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_inst_id,
            scene.tri_geom_id, scene.tri_prim_id, o, d, a, b,
            any_hit=any_hit))
        kt, ktri, _, _ = (np.asarray(x) for x in kern(o, d, t0, t1))
        oh = orac(o, d, t0, t1)
        ot, otri = np.asarray(oh.t), np.asarray(oh.soup_id)
        traced = int((np.asarray(t1) > 0).sum())
        s_k = timed(kern, o, d, t0, t1)
        s_o = timed(orac, o, d, t0, t1)
        hit_agree = float(((ktri >= 0) == (otri >= 0)).mean())
        nums = dict(rays=n, traced=traced, hit_share=float((otri >= 0).mean()),
                    hit_agree=hit_agree, kernel_ms=s_k * 1e3,
                    oracle_ms=s_o * 1e3, kernel_mrays_s=traced / s_k / 1e6,
                    oracle_mrays_s=traced / s_o / 1e6)
        if not any_hit:
            both = (ktri >= 0) & (otri >= 0)
            same = both & (ktri == otri)
            tri_agree = float(same.sum() / max(both.sum(), 1))
            rel = np.abs(kt[same] - ot[same]) / np.maximum(ot[same], 1e-3)
            nums.update(tri_agree=tri_agree,
                        t_max_rel=float(rel.max(initial=0.0)))
        phase(f'trace_{name}', **nums)
        check(hit_agree >= HIT_AGREE_MIN,
              f'{name}: hit/miss agree {hit_agree} < {HIT_AGREE_MIN}')
        if not any_hit:
            check(tri_agree >= TRI_AGREE_MIN,
                  f'{name}: triangle agree {tri_agree} < {TRI_AGREE_MIN}')
            check(nums['t_max_rel'] <= T_RTOL,
                  f'{name}: t differs by {nums["t_max_rel"]} > {T_RTOL}')


def _ground_setup(scene):
    from hydracore3.models import dr as DR
    slot = int(scene.mat_texid[0, 0])      # material 0 is the ground
    setup = DR.put_diff_tex(scene, slot)
    params = scene.textures.texels[
        setup.texel_offset:setup.texel_offset + setup.size]
    return setup, params


def grad_phase(scene, meta, n=1 << 16):
    import jax.numpy as jnp
    from hydracore3.models import dr as DR
    from hydracore3.ops import rng as RNG
    setup, params = _ground_setup(scene)
    pix = jnp.arange(n, dtype=jnp.int32) * 16 % (meta.width * meta.height)
    ref = jnp.zeros((n, 3), jnp.float32)
    out = {}
    for route, m in (('kernel', meta),
                     ('oracle', dataclasses.replace(meta, use_kernel=False,
                                                    use_bvh=True))):
        t0 = time.perf_counter()
        loss, g, _, _ = DR.loss_and_grad(params, scene, m, setup,
                                         RNG.gen_init(pix), pix, ref)
        g = np.asarray(g)
        out[route] = (float(loss), g, time.perf_counter() - t0)
    (lk, gk, sk), (lo, go, so) = out['kernel'], out['oracle']
    rel = float(np.linalg.norm(gk - go) / max(np.linalg.norm(go), 1e-30))
    phase('gradient', pixels=n, texels=int(setup.size), loss=lk,
          loss_oracle=lo, grad_norm=float(np.linalg.norm(gk)), rel_err=rel,
          kernel_s=sk, oracle_s=so)
    check(np.isfinite(gk).all(), 'non-finite gradient')
    check(np.abs(gk).max() > 0.0, 'zero gradient')
    check(rel <= GRAD_RTOL, f'gradient differs by {rel} > {GRAD_RTOL}')


def four_card_phase(scene, meta, spp=1, n=1 << 16, grad_depth=2):
    import jax
    import jax.numpy as jnp
    from hydracore3 import render as R
    from hydracore3.models import dr as DR
    from hydracore3.ops import rng as RNG
    from hydracore3.parallel import mesh as M
    devs = jax.devices()
    mesh1, mesh4 = M.make_mesh(devs[:1]), M.make_mesh(devs[:4])
    imgs = {}
    for k, mesh in (('one', mesh1), ('four', mesh4)):
        M.render_sharded(mesh, scene, meta, spp)
        t0 = time.perf_counter()
        imgs[k] = M.render_sharded(mesh, scene, meta, spp)
        imgs[k + '_s'] = time.perf_counter() - t0
    diff = float(np.abs(imgs['one'] - imgs['four']).max())
    same = float((imgs['one'] == imgs['four']).mean())
    phase('four_card_render', spp=spp, one_card_s=imgs['one_s'],
          four_card_s=imgs['four_s'], max_abs_diff=diff, bitwise_same=same)
    check(np.isfinite(imgs['four']).all() and imgs['four'].mean() > 0,
          'four-card frame is not finite and non-black')
    check(diff <= SHARD_ATOL, f'four-card frame differs by {diff}')

    # the DR step at a shallower depth: the comparison is about the mesh
    # (sharded pixels, pmean'd gradients), and each depth level adds
    # compile time to both programs
    setup, params = _ground_setup(scene)
    gmeta = dataclasses.replace(meta, trace_depth=grad_depth)

    def loss_fn(p, scene_, rng, pix, ref):
        s2 = DR.scene_with_params(scene_, setup, p)
        c, _ = R._render_tile.__wrapped__(s2, gmeta, rng, pix, 2, 0, 4, 1)
        return jnp.mean((c[..., :3] - ref) ** 2)

    pix = jnp.arange(n, dtype=jnp.int32) * 16 % (meta.width * meta.height)
    ref = jnp.zeros((n, 3), jnp.float32)
    grads = {}
    for k, mesh in (('one', mesh1), ('four', mesh4)):
        step = M.sharded_train_step(mesh, scene, gmeta, loss_fn)
        loss, g = step(params, RNG.gen_init(pix), pix, ref)
        grads[k] = (float(loss), np.asarray(g))
    rel = float(np.linalg.norm(grads['one'][1] - grads['four'][1])
                / max(np.linalg.norm(grads['one'][1]), 1e-30))
    phase('four_card_grad', pixels=n, depth=grad_depth,
          loss_one=grads['one'][0],
          loss_four=grads['four'][0], rel_err=rel)
    check(np.abs(grads['four'][1]).max() > 0, 'zero four-card gradient')
    check(rel <= SHARD_GRAD_RTOL, f'four-card gradient differs by {rel}')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the four-card phase (needs 4 GPUs)')
    args = ap.parse_args()
    dev = device_phase(4 if args.four_cards else 1)
    scene, meta = load_city()
    if args.four_cards:
        four_card_phase(scene, meta)
    else:
        render_phase(scene, meta)
        trace_phase(scene, meta)
        grad_phase(scene, meta)
    import jax
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}))


if __name__ == '__main__':
    main()
