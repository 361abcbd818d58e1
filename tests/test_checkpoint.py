"""Checkpoint/resume (SURVEY.md §5): a render interrupted mid-way and
resumed from its checkpoint must produce the exact image of an
uninterrupted render (same RNG stream, same accumulator)."""
import os

import numpy as np

from hydracore3 import render as R
from hydracore3.utils import checkpoint as CKPT


def test_pytree_roundtrip(tmp_path):
    tree = {'a': np.arange(6, dtype=np.float32).reshape(2, 3),
            'b': [np.uint32([1, 2]), np.float64([3.5])]}
    p = str(tmp_path / 'ck.npz')
    CKPT.save_checkpoint(p, tree, step=7, meta={'k': 'v'})
    out, step, meta = CKPT.load_checkpoint(p, like=tree)
    assert step == 7 and meta == {'k': 'v'}
    assert np.array_equal(out['a'], tree['a'])
    assert np.array_equal(out['b'][0], tree['b'][0])
    assert out['b'][1].dtype == np.float64


def test_render_resume_bit_exact(cornell_scene, tmp_path):
    scene, meta = cornell_scene
    ck = str(tmp_path / 'render.npz')
    spp = 4

    # uninterrupted reference
    full = R.render(scene, meta, spp=spp, integrator='mispt')

    # render only half (checkpoint every pass), then resume to the end
    R.render(scene, meta, spp=spp // 2, integrator='mispt',
             checkpoint_path=ck, checkpoint_every=1)
    assert os.path.exists(ck)
    resumed = R.render(scene, meta, spp=spp, integrator='mispt',
                       checkpoint_path=ck, checkpoint_every=1, resume=True)

    assert np.allclose(np.asarray(full), np.asarray(resumed), atol=1e-5), (
        'resumed render must be bit-compatible with the uninterrupted one')
