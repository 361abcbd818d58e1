#!/usr/bin/env python3
"""Render golden images with the reference CPU binary -> tests/goldens/.

The reference build lives in .refbuild/src (see tools/litemath_shim/); this
script runs its `hydra` binary over the in-repo scenes and stores each
result as a compressed .npz (float16 HDR pixels, display orientation —
the reference saves EXR with invertY=true, main.cpp:425, so we flip back).

Golden renders use high spp so the stored image is converged; the test
harness (tests/test_golden.py) then renders at lower spp and the PSNR is
noise-limited by OUR render only, mirroring the reference methodology
(testing/run_tests.py: PSNR >= 35 pass, < 30 fail).
"""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYDRA = os.path.join(REPO, '.refbuild/src/bin-release/hydra')
SCENES = '/root/reference/scenes'
OUT = os.path.join(REPO, 'tests/goldens')

sys.path.insert(0, REPO)
from hydracore3.utils import imageio as IIO  # noqa: E402

# (name, scene, extra args)  — 256x256, high spp
RUNS = [
    ('test_035_mispt',   f'{SCENES}/test_035/statex_00001.xml', ['-integrator', 'mispt',   '-spp', '2048']),
    ('test_035_shadowpt', f'{SCENES}/test_035/statex_00001.xml', ['-integrator', 'shadowpt', '-spp', '2048']),
    ('test_035_naivept', f'{SCENES}/test_035/statex_00001.xml', ['-integrator', 'naivept', '-spp', '4096', '-spp-naive-mul', '1']),
    ('test_035_prt',     f'{SCENES}/test_035/statex_00001.xml', ['-integrator', 'prt',     '-spp', '256']),
    ('test_035_raytracing', f'{SCENES}/test_035/statex_00001.xml', ['-integrator', 'raytracing', '-spp', '256']),
    ('test_228_mispt',   f'{SCENES}/test_228/statex_00001.xml', ['-integrator', 'mispt',   '-spp', '2048']),
    ('test_spectral_mispt', f'{SCENES}/test_spectral/spectral_cornell_conductor.xml',
     ['--spectral', '-integrator', 'mispt', '-spp', '2048', '-scn_dir', SCENES]),
    ('test_035_motion_mispt', f'{SCENES}/test_035/motion_test.xml', ['-integrator', 'mispt', '-spp', '2048']),
    ('test_035_gbuffer', f'{SCENES}/test_035/statex_00001.xml', ['-evalgbuffer', '1', '-spp', '256']),
    # r4 (VERDICT item 7): QMC and Kelemen-MLT golden validation
    ('test_035_qmc',  f'{SCENES}/test_035/statex_00001.xml', ['-integrator', 'mispt', '--qmc', '-spp', '2048']),
    ('test_035_mlt',  f'{SCENES}/test_035/statex_00001.xml', ['-integrator', 'mlt', '-spp', '2048']),
]


def main():
    os.makedirs(OUT, exist_ok=True)
    only = sys.argv[1:] or None
    for name, scene, args in RUNS:
        if only and name not in only:
            continue
        is_gbuffer = '-evalgbuffer' in args
        ext = 'exr'
        out_img = f'/tmp/golden_{name}.{ext}'
        cmd = [HYDRA, '-in', scene, '-out', out_img,
               '-width', '256', '-height', '256'] + args
        print('[make_goldens]', ' '.join(cmd), flush=True)
        r = subprocess.run(cmd, cwd=os.path.dirname(scene),
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-2000:])
            print(r.stderr[-2000:])
            raise SystemExit(f'{name}: hydra failed rc={r.returncode}')
        if not os.path.exists(out_img):
            # prt/raytracing save to <name>_rt.exr (main.cpp RT branch)
            alt = out_img.replace('.exr', '_rt.exr')
            if os.path.exists(alt):
                out_img = alt
        if is_gbuffer:
            # SaveGBufferImages writes LDR BMPs named <out>N.exr
            # (imageutils_gbuffer.cpp:33-141): 2=normals 3=texcolor 4=depth
            # 5=matid-palette 6=instid 7=objid
            import imageio.v3 as iio
            base, _ = os.path.splitext(out_img)
            arrs = {}
            for i, layer in [(2, 'normals'), (3, 'texcolor'), (4, 'depth'),
                             (5, 'matid'), (6, 'instid'), (7, 'objid')]:
                p = f'{base}{i}.{ext}'
                if os.path.exists(p):
                    img = np.asarray(iio.imread(p)).astype(np.float32) / 255.0
                    arrs[layer] = img.astype(np.float16)
            if arrs:
                np.savez_compressed(os.path.join(OUT, f'{name}.npz'), **arrs)
                print(f'  -> {name}.npz layers={list(arrs)}')
            continue
        img = IIO.load_exr(out_img)[::-1]  # undo the reference's invertY
        np.savez_compressed(os.path.join(OUT, f'{name}.npz'),
                            img=img.astype(np.float16))
        print(f'  -> {name}.npz {img.shape} max={img.max():.3f}')


if __name__ == '__main__':
    main()
