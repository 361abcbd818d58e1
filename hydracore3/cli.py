"""CLI compatible with the reference's main.cpp flag surface (user_guide.md:24-77).

Usage:
    python -m hydracore3.cli -in scene.xml -out image.exr -integrator mispt -spp 256
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser('hydracore3', prefix_chars='-')
    p.add_argument('-in', dest='scene_in', required=True)
    p.add_argument('-out', dest='image_out', default='z_out.bmp')
    p.add_argument('-scn_dir', dest='scene_dir', default='')
    p.add_argument('-integrator', default='mispt',
                   choices=['naivept', 'shadowpt', 'mispt', 'all', 'raytracing',
                            'whitted_rt', 'prt', 'mlt'])
    p.add_argument('-spp', type=int, default=None)
    p.add_argument('-width', type=int, default=None)
    p.add_argument('-height', type=int, default=None)
    p.add_argument('-channels', type=int, default=4)
    p.add_argument('-gamma', type=float, default=2.2)
    p.add_argument('-fb_layer', default='color',
                   choices=['color', 'direct', 'indirect', 'direct_indirect'])
    p.add_argument('--spectral', action='store_true')
    p.add_argument('--qmc', action='store_true')
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--gpu', action='store_true')   # accepted for CLI parity
    p.add_argument('-gpu_id', type=int, default=0)
    p.add_argument('-cam_id', type=int, default=0)
    p.add_argument('-tile', type=int, default=1 << 17)
    p.add_argument('-look_at', nargs=16, type=float, default=None,
                   metavar='M', help='row-major 4x4 view matrix override')
    p.add_argument('-evalgbuffer', type=int, default=0,
                   help='render G-buffer layers instead of color')
    p.add_argument('-spp-naive-mul', dest='spp_naive_mul', type=int, default=1,
                   help='extra spp multiplier for the naive integrator')
    p.add_argument('-resource_dir', default='',
                   help='alias of -scn_dir (reference flag parity)')
    p.add_argument('-checkpoint', default='',
                   help='checkpoint path for pass-granular save/resume')
    p.add_argument('-checkpoint_every', type=int, default=8)
    p.add_argument('--resume', action='store_true',
                   help='resume an interrupted render from -checkpoint')
    p.add_argument('--debug-nojit', action='store_true', dest='debug_nojit',
                   help='run the whole render with jax.disable_jit(): every '
                        'op executes eagerly op-by-op (python-level stacks, '
                        'printable intermediates) — the sanitizer/debug-'
                        'build analog of the reference\'s CPU single-thread '
                        'path (SURVEY.md §5; pair with --cpu)')
    p.add_argument('-profile', default='',
                   help='write a jax.profiler trace of the render to this '
                        'directory (the GetExecutionTime analog at op level)')
    return p


def _eval_gbuffer(scene, meta, args):
    """-evalgbuffer: render G-buffer layers to <stem>_<layer>.<ext>
    (main.cpp gbuffer path + imageutils_gbuffer.cpp exports)."""
    import numpy as np
    import jax.numpy as jnp
    from .models import gbuffer as GB
    from .utils import imageio as IIO
    t0 = time.time()
    N = meta.width * meta.height
    gb = GB.eval_gbuffer(scene, meta, jnp.arange(N, dtype=jnp.int32))
    ms = (time.time() - t0) * 1000.0
    print(f'EvalGBuffer = {ms:.2f} ms')
    H, W = meta.height, meta.width
    stem, dot, ext = args.image_out.rpartition('.')
    if not dot:
        stem, ext = args.image_out, 'bmp'

    def save(name, img):
        out = f'{stem}_{name}.{ext}'
        img = np.asarray(img).reshape(H, W, -1)[::-1]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        if out.endswith('.exr'):
            IIO.save_exr(out, img, 1.0)
        else:
            IIO.save_ldr(out, np.clip(img, 0, 1), 1.0, args.gamma)
        print(f'[main]: saved {out}')

    depth = np.asarray(gb.depth)
    finite = np.isfinite(depth) & (depth < 1e30)
    dmax = depth[finite].max() if finite.any() else 1.0
    save('depth', np.where(finite, depth / max(dmax, 1e-9), 1.0)[:, None])
    save('normals', np.asarray(gb.norm) * 0.5 + 0.5)
    save('texcoord', np.concatenate([np.asarray(gb.texc),
                                     np.zeros((N, 1), np.float32)], -1))
    save('texcolor', np.asarray(gb.rgba))
    save('coverage', np.asarray(gb.coverage)[:, None])
    for name, ids in (('matid', gb.mat_id), ('objid', gb.obj_id),
                      ('instid', gb.inst_id)):
        ids = np.asarray(ids).astype(np.int64)
        # reference palette trick: hash ids to stable pseudo-colors
        r = ((ids * 2654435761) % 255) / 255.0
        g = ((ids * 805459861) % 255) / 255.0
        b = ((ids * 3674653429) % 255) / 255.0
        img = np.stack([r, g, b], -1)
        img[ids < 0] = 0.0
        save(name, img)
    return 0


def render_mlt_merged(scene, meta, spp, channels=4, progress=False):
    """`-integrator mlt`: split_direct_indirect (main.cpp:139-145, 480-491)
    — direct layer via QMC MIS-PT, indirect via Kelemen-MLT chains, summed."""
    import numpy as np
    from . import render as R
    from .models import kmlt, integrator_pt as IPT
    direct = R.render_qmc(scene, meta, spp=spp, integrator='mispt',
                          layer='direct', channels=channels,
                          progress=progress)
    indirect = kmlt.render_mlt(scene, meta, spp=spp,
                               render_layer=IPT.FB_INDIRECT,
                               channels=channels, progress=progress)
    return np.asarray(direct) + np.asarray(indirect)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')
    if args.debug_nojit:
        import jax
        # interpreter mode: trace nothing, run ops eagerly so assertion
        # failures / NaN origins carry python stack traces (the race-
        # sanitizer analog — functional purity means the only "races" to
        # find are ordering bugs, which eager mode surfaces).  Entered for
        # the process lifetime; process exit cleans up.
        jax.disable_jit().__enter__()

    from .scene import build as SB
    from . import render as R
    from .utils import imageio as IIO

    print(f'[main]: loading scene ... {args.scene_in}')
    if not os.path.exists(args.scene_in):
        print(f'[main]: ERROR, scene file not found: {args.scene_in}')
        return 1
    scene, meta = SB.load_scene(args.scene_in,
                                args.scene_dir or args.resource_dir,
                                spectral_mode=args.spectral,
                                width=args.width, height=args.height,
                                look_at_override=args.look_at,
                                cam_id=args.cam_id)
    spp = args.spp or meta.spp
    print(f'[main]: scene loaded: {meta.num_tris} tris, {meta.num_lights} lights, '
          f'{meta.num_materials} materials; {meta.width}x{meta.height} @ {spp} spp')

    if args.evalgbuffer:
        return _eval_gbuffer(scene, meta, args)

    integrators = ([args.integrator] if args.integrator != 'all'
                   else ['naivept', 'shadowpt', 'mispt'])
    for integ in integrators:
        name = {'naivept': 'NaivePathTrace', 'shadowpt': 'PathTrace',
                'mispt': 'PathTrace',
                'raytracing': 'RayTrace', 'whitted_rt': 'RayTrace'}.get(integ, 'PathTrace')
        layer = args.fb_layer if args.fb_layer != 'direct_indirect' else 'color'
        t0 = time.time()
        if integ == 'prt':
            # primary rays only (-integrator prt: CastSingleRay flat color)
            import jax.numpy as jnp
            import numpy as np
            from .models import integrator_rt as IRT
            N = meta.width * meta.height
            tw0 = time.time()
            img = np.asarray(IRT.cast_single_ray(
                scene, meta, jnp.arange(N, dtype=jnp.int32)))
            img = img.reshape(meta.height, meta.width, 4)[..., :args.channels]
            timing = {'total_s': time.time() - tw0, 'compile_s': 0.0}
        elif integ in ('raytracing', 'whitted_rt'):
            import jax.numpy as jnp
            import numpy as np
            from .models import integrator_rt as IRT
            N = meta.width * meta.height
            timing = {'total_s': 0.0, 'compile_s': 0.0}
            tw0 = time.time()
            img = np.asarray(IRT.ray_trace(scene, meta,
                                           jnp.arange(N, dtype=jnp.int32)))
            img = img.reshape(meta.height, meta.width, 4)[..., :args.channels]
            timing['total_s'] = time.time() - tw0
        elif integ == 'mlt':
            tw0 = time.time()
            img = render_mlt_merged(scene, meta, spp=spp,
                                    channels=args.channels, progress=True)
            timing = {'total_s': time.time() - tw0, 'compile_s': 0.0}
        elif args.qmc:
            img, timing = R.render_qmc(scene, meta, spp=spp, integrator=integ,
                                       layer=layer, channels=args.channels,
                                       tile_size=args.tile,
                                       progress=True, return_timing=True)
        else:
            ispp = spp * (args.spp_naive_mul if integ == 'naivept' else 1)
            import contextlib
            import jax as _jax
            prof = (_jax.profiler.trace(args.profile) if args.profile
                    else contextlib.nullcontext())
            with prof:
                img, timing = R.render(scene, meta, spp=ispp, integrator=integ,
                                       layer=layer,
                                       channels=args.channels, tile_size=args.tile,
                                       progress=True, return_timing=True,
                                       checkpoint_path=args.checkpoint or None,
                                       checkpoint_every=args.checkpoint_every,
                                       resume=args.resume)
            if args.profile:
                print(f'[main]: jax.profiler trace written to {args.profile}')
        ms = (timing['total_s'] - timing.get('compile_s', 0.0)) * 1000.0
        # keep the reference's timing line format so run_bench-style regexes work
        tag = {'naivept': 'naivept', 'shadowpt': 'shadowpt',
               'mispt': 'mispt'}.get(integ, integ)
        print(f'{name}Block({tag.upper() if integ=="mispt" else tag}) = {ms:.2f} ms')
        print(f'PathTraceBlock(exec) = {ms:.2f} ms')

        out = args.image_out
        if len(integrators) > 1:
            stem, dot, ext = out.rpartition('.')
            out = f'{stem}_{integ}.{ext}' if dot else f'{out}_{integ}'
        # flip to display orientation: the framebuffer row 0 is the scene's
        # bottom (the reference's BMP writer is bottom-up, displaying the
        # same way)
        img_disp = img[::-1]
        if out.endswith('.exr'):
            IIO.save_exr(out, img_disp, 1.0)
        else:
            IIO.save_ldr(out, img_disp, 1.0, args.gamma)
        print(f'[main]: saved {out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
