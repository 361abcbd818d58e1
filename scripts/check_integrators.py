"""Estimator consistency check: naive vs shadow vs MIS PT on Cornell."""
import numpy as np
from hydracore3.scene import build as SB
from hydracore3 import render as R
from hydracore3.utils.imageio import psnr, save_ldr

scene, meta = SB.load_scene('/root/reference/scenes/test_035/statex_00001.xml', width=64, height=48)
imgs = {}
for integ in ['mispt', 'shadowpt', 'naivept']:
    img, t = R.render(scene, meta, spp=192, integrator=integ, return_timing=True)
    imgs[integ] = np.asarray(img)
    print(integ, 'mean', img[..., :3].mean(), 'compile', round(t['compile_s'], 1),
          'total', round(t['total_s'], 1), flush=True)
    save_ldr(f'/tmp/c_{integ}.png', img[::-1], 1.0, 2.2)
for b in ['shadowpt', 'naivept']:
    la = np.clip(imgs['mispt'][..., :3], 0, 1) ** (1 / 2.2) * 255
    lb = np.clip(imgs[b][..., :3], 0, 1) ** (1 / 2.2) * 255
    print('mispt vs', b, 'PSNR', round(psnr(la, lb), 2), flush=True)
