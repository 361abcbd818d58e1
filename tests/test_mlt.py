"""Kelemen-MLT tests: mutation kernel + estimator consistency with plain PT."""
import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`


def test_mutate_kelemen_range():
    from hydracore3.models.kmlt import mutate_kelemen
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.uniform(size=4096).astype(np.float32))
    r1 = jnp.asarray(rng.uniform(size=4096).astype(np.float32))
    r2 = jnp.asarray(rng.uniform(size=4096).astype(np.float32))
    out = np.asarray(mutate_kelemen(v, r1, r2, 64.0))
    assert (out >= 0).all() and (out <= 1.0).all()
    # mutations are local: median step is small
    d = np.abs(out - np.asarray(v))
    d = np.minimum(d, 1.0 - d)  # wrap-around distance
    assert np.median(d) < 0.05


def test_mlt_brightness_matches_pt(cornell_scene):
    """MLT is unbiased after brightness normalization: image mean must match
    the plain MIS PT mean (the reference prints avg brightness as its own
    sanity metric, integrator_kmlt.cpp:451-453)."""
    from hydracore3.models import kmlt, integrator_pt as IPT
    from hydracore3 import render as R
    scene, meta = cornell_scene
    img_mlt = kmlt.render_mlt(scene, meta, spp=32, n_chains=2048,
                              render_layer=IPT.FB_COLOR,
                              steps_per_dispatch=16, verbose=False)
    img_pt = np.asarray(R.render(scene, meta, spp=32, integrator='mispt'))
    m_mlt = img_mlt[..., :3].mean()
    m_pt = img_pt[..., :3].mean()
    assert abs(m_mlt - m_pt) / m_pt < 0.12, (m_mlt, m_pt)
