"""Benchmark: MIS path-tracer throughput — Cornell + the textured city.

Prints one JSON line per scene:

  1. Cornell test_035 (needs the reference scene library; skipped with a
     note when it is absent).
  2. The textured 215k-triangle synthetic city
     (hydracore3/scene/synth.py), the sponza-class scene the reference's
     perf ledger is defined on (testing/perf.txt:2-8), rendered through the
     per-ray BVH kernel (accel/traverse_gpu.py).

Baselines (BASELINE.md, RTX 4090): test_102 798 ms @ 1024^2x1024spp =
1344 Msamples/s; sponza 2282 ms = 470 Msamples/s.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_MSAMPLES = 1344.0
BASELINE_BIG_MSAMPLES = 470.0
CORNELL = '/root/reference/scenes/test_035/statex_00001.xml'


def _count_rays(scene, meta, n_px=1 << 16):
    import jax
    import jax.numpy as jnp
    from hydracore3.models import integrator_pt as IPT
    from hydracore3.ops import rng as RNG
    pix = jnp.arange(min(n_px, meta.width * meta.height), dtype=jnp.int32)
    cnt = jax.jit(lambda r: IPT.count_rays_pass(scene, meta, r, pix))(
        RNG.gen_init(pix))
    return float(cnt[0] + cnt[1]) / pix.shape[0]


def bench_cornell():
    from hydracore3.scene import build as SB
    from hydracore3 import render as R

    width, height = 1024, 768
    spp = int(os.environ.get('BENCH_SPP', '64'))
    scene, meta = SB.load_scene(CORNELL, width=width, height=height)

    tile = 1 << 15
    # warmup compiles the same executable as the timed run
    R.render(scene, meta, spp=16, integrator='mispt', tile_size=tile)

    t0 = time.time()
    out = R.render(scene, meta, spp=spp, integrator='mispt', tile_size=tile,
                   return_timing=True)
    dt = time.time() - t0
    img, timing = out if isinstance(out, tuple) else (out, {})
    samples = timing.get('samples', width * height * spp)
    msamples_s = samples / dt / 1e6
    rays_per_sample = _count_rays(scene, meta)
    print(json.dumps({
        'metric': 'mis_pt_cornell_throughput',
        'value': round(msamples_s, 2),
        'unit': 'Msamples/s',
        'vs_baseline': round(msamples_s / BASELINE_MSAMPLES, 4),
        'mrays_per_s': round(msamples_s * rays_per_sample, 2),
        'rays_per_sample': round(rays_per_sample, 3),
    }), flush=True)


def _city_scale_checks(scene, meta, img):
    """At-scale correctness riders on the city:

    1. ``trace_parity``: share of 131k camera rays on which the kernel and
       the XLA oracle (``intersect_bvh``) hit the same triangle, times the
       share of those whose t agrees (rtol 1e-4), over the full soup.
    2. ``psnr_vs_golden``: PSNR of the 8x-downsampled render vs the
       committed golden (tests/goldens/city_bench_128.npz, this pipeline's
       own spp=16 render).
    """
    import numpy as np
    import jax.numpy as jnp
    from hydracore3.accel import traverse as ACC
    from hydracore3.accel import traverse_gpu as TG
    from hydracore3.models import integrator_pt as IPT
    from hydracore3.ops import rng as RNG
    out = {}
    N = 1 << 17
    pix = jnp.arange(N, dtype=jnp.int32) * 7 % (meta.width * meta.height)
    st, _ = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix), pix)
    tmin = jnp.zeros((N,), jnp.float32)
    tmax = jnp.full((N,), 3.0e38, jnp.float32)
    kt, ktri, _, _ = TG.intersect(scene.kn_nodes, scene.kn_tris, st.ray_pos,
                                  st.ray_dir, tmin, tmax)
    bvh = dict(bmin=scene.bvh_bmin, bmax=scene.bvh_bmax, skip=scene.bvh_skip,
               tri_offset=scene.bvh_tri_offset, tri_count=scene.bvh_tri_count)
    oh = ACC.intersect_bvh(bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2,
                           scene.tri_inst_id, scene.tri_geom_id,
                           scene.tri_prim_id, st.ray_pos, st.ray_dir, tmin,
                           tmax)
    ktri, otri = np.asarray(ktri), np.asarray(oh.soup_id)
    same = ktri == otri
    both = same & (ktri >= 0)
    agree_t = np.isclose(np.asarray(kt)[both], np.asarray(oh.t)[both],
                         rtol=1e-4)
    out['trace_parity'] = float(same.mean() * agree_t.mean())

    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'tests', 'goldens', 'city_bench_128.npz'))
    gold = g['img'].astype(np.float32)
    im = np.asarray(img).reshape(meta.height, meta.width,
                                 -1)[..., :3].astype(np.float32)
    H, W = im.shape[0], im.shape[1]
    ds = im.reshape(128, H // 128, 128, W // 128, 3).mean((1, 3))
    mse = float(np.mean((ds - gold) ** 2))
    peak = max(float(gold.max()), 1e-9)
    out['psnr_vs_golden'] = 10.0 * np.log10(peak * peak / max(mse, 1e-20))
    return out


def bench_city():
    from hydracore3.scene import synth
    from hydracore3 import render as R

    spp = int(os.environ.get('BENCH_BIG_SPP', '4'))
    # textured=True: procedural facades + asphalt + env sky map, so the
    # bench carries sponza-class shading load (BASELINE.md rows 2-3 are
    # textured), not just sponza-class geometry
    scene, meta = synth.city_scene(width=1024, height=1024, depth=5,
                                   textured=True)
    assert meta.use_kernel, 'the city must route to the GPU kernel'

    # whole-image tiles: 1M rays in flight per dispatch
    tile = 1 << 20
    R.render(scene, meta, spp=1, integrator='mispt', tile_size=tile)

    t0 = time.time()
    img = R.render(scene, meta, spp=spp, integrator='mispt', tile_size=tile)
    dt = time.time() - t0
    samples = 1024 * 1024 * spp
    msamples_s = samples / dt / 1e6
    rays_per_sample = _count_rays(scene, meta)
    extra = _city_scale_checks(scene, meta, img)
    print(json.dumps({
        'metric': 'mis_pt_city215k_throughput',
        'value': round(msamples_s, 3),
        'unit': 'Msamples/s',
        'vs_baseline': round(msamples_s / BASELINE_BIG_MSAMPLES, 5),
        'mrays_per_s': round(msamples_s * rays_per_sample, 2),
        'rays_per_sample': round(rays_per_sample, 3),
        'tris': int(meta.num_tris),
        **extra,
    }), flush=True)


def main():
    if os.path.exists(CORNELL):
        bench_cornell()
    else:
        print(f'bench: Cornell scene {CORNELL} not found; skipped',
              file=sys.stderr)
    if os.environ.get('BENCH_BIG', '1') != '0':
        bench_city()


if __name__ == '__main__':
    main()
