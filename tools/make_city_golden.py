#!/usr/bin/env python3
"""Render the bench city on the real chip at spp=16 and commit the
8x-downsampled golden (tests/goldens/city_bench_128.npz) that bench.py's
at-scale regression check compares against."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from hydracore3.scene import synth
from hydracore3 import render as R


def main():
    scene, meta = synth.city_scene(width=1024, height=1024, depth=5,
                                   textured=True)
    img = R.render(scene, meta, spp=16, integrator='mispt',
                   tile_size=1 << 20, progress=True)
    im = np.asarray(img).reshape(meta.height, meta.width, -1)[..., :3]
    ds = im.reshape(128, 8, 128, 8, 3).mean((1, 3)).astype(np.float32)
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tests', 'goldens',
        'city_bench_128.npz')
    np.savez_compressed(out, img=ds)
    print('saved', out, ds.shape, 'mean', float(ds.mean()))


if __name__ == '__main__':
    main()
