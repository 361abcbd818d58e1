"""Differentiable rendering: gradients vs finite differences (SURVEY.md §4
implication #3: grad-allclose validation; the Enzyme-parity analog)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.heavy  # full-render compile: run via `pytest -m heavy`


@pytest.fixture(scope='module')
def dr_setup():
    from hydracore3.scene import build as SB
    from hydracore3.models import dr as DR
    scene, meta = SB.load_scene('/root/reference/scenes/test_035/statex_00001.xml',
                                width=16, height=12)
    # texture slot 1 is the 256x256 cube texture (texture1.bmp chunk)
    setup = DR.put_diff_tex(scene, 1)
    return scene, meta, setup


def test_gradients_finite_and_nonzero(dr_setup):
    from hydracore3.models import dr as DR
    from hydracore3.ops import rng as RNG
    scene, meta, setup = dr_setup
    N = meta.width * meta.height
    pix = jnp.arange(N, dtype=jnp.int32)
    rng = RNG.gen_init(pix)
    ref = jnp.zeros((N, 3), jnp.float32)
    params = jnp.full((setup.size, 4), 0.5, jnp.float32)
    loss, grads, contrib, _ = DR.loss_and_grad(params, scene, meta, setup,
                                               rng, pix, ref)
    grads = np.asarray(grads)
    assert np.isfinite(float(loss))
    assert np.isfinite(grads).all(), 'NaN/inf in gradients'
    assert np.abs(grads).sum() > 0, 'gradients identically zero'


def test_gradient_matches_finite_difference(dr_setup):
    """Directional derivative vs central finite differences on the same
    sample sequence (deterministic RNG makes the comparison exact-ish)."""
    from hydracore3.models import dr as DR
    from hydracore3.ops import rng as RNG
    scene, meta, setup = dr_setup
    N = meta.width * meta.height
    pix = jnp.arange(N, dtype=jnp.int32)
    rng = RNG.gen_init(pix)
    ref = jnp.zeros((N, 3), jnp.float32)
    params = jnp.full((setup.size, 4), 0.5, jnp.float32)

    _, grads, _, _ = DR.loss_and_grad(params, scene, meta, setup, rng, pix, ref)

    # random but fixed direction
    rs = np.random.default_rng(0)
    direction = jnp.asarray(rs.normal(size=params.shape).astype(np.float32))
    analytic = float(jnp.vdot(grads, direction))

    def f(t):
        loss, _, _, _ = DR.loss_and_grad(params + t * direction, scene, meta,
                                         setup, rng, pix, ref)
        return float(loss)

    eps = 1e-3
    fd = (f(eps) - f(-eps)) / (2 * eps)
    assert abs(fd - analytic) <= 0.05 * max(abs(fd), abs(analytic), 1e-3), \
        (fd, analytic)


def test_optimization_reduces_loss(dr_setup):
    """A few Adam iterations must reduce the loss toward a reference render."""
    from hydracore3.models import dr as DR
    from hydracore3 import render as R
    scene, meta, setup = dr_setup
    ref_img = np.asarray(R.render(scene, meta, spp=16, integrator='mispt'))
    params, losses = DR.optimize_texture(scene, meta, setup, ref_img,
                                         iters=6, spp=2, lr=0.15,
                                         init_value=1.0, verbose=False)
    # only ~190 rays touch a 65k-texel texture at this resolution, so the
    # loss decreases steadily but not steeply in 6 iterations
    assert losses[-1] < losses[0] * 0.97, losses
    assert all(b <= a for a, b in zip(losses, losses[1:])), losses
    assert np.isfinite(np.asarray(params)).all()


def test_drmain_configuration_50_iters():
    """The reference's ACTUAL optimization configuration (diff_render/
    drmain.cpp:174-262, adam.h Adam step): texture slot 1 as a 256x256x4
    trainable parameter block, trace depth 6, init 1.0, 50 Adam
    iterations — only the render resolution is reduced (drmain renders
    512x512; CI uses 64x48) to keep CPU wall time sane.  Asserts the loss
    decreases overall and ends below a fixed bound (VERDICT r4 item 8a)."""
    from hydracore3.scene import build as SB
    from hydracore3.models import dr as DR
    from hydracore3 import render as R
    scene, meta = SB.load_scene(
        '/root/reference/scenes/test_035/statex_00001.xml',
        width=64, height=48)
    import dataclasses
    meta = dataclasses.replace(meta, trace_depth=6)  # SetMaxThreadsAndBounces(32, 6)
    setup = DR.put_diff_tex(scene, 1)         # PutDiffTex2D(1, 256,256,4)
    assert setup.size == 256 * 256
    ref_img = np.asarray(R.render(scene, meta, spp=16, integrator='mispt'))
    params, losses = DR.optimize_texture(scene, meta, setup, ref_img,
                                         iters=50, spp=1, lr=0.15,
                                         init_value=1.0, verbose=False)
    assert np.isfinite(np.asarray(params)).all()
    assert np.isfinite(losses).all()
    # init=1.0 (white texture) vs the true wooden cube: the optimization
    # must make clear progress.  At 64x48x1spp only ~2% of the 65k texels
    # are seen per pass, so 50 iters recovers ~20% of the error (measured
    # 0.975 -> 0.773 on this box); assert a margin below that, plus no
    # late divergence.  (drmain itself renders 512x512 — full coverage.)
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])
    assert min(losses) == min(losses[-10:]), 'loss diverged late'


def test_regularizers_match_definitions():
    import numpy as np
    import jax.numpy as jnp
    from hydracore3.models import dr as DR
    rng = np.random.default_rng(0)
    d = rng.normal(size=17).astype(np.float32)
    expect = sum((d[i] - d[i-1])**2 + (d[i] - d[i+1])**2
                 for i in range(1, 16)) / 17
    np.testing.assert_allclose(float(DR.reg_loss_image_1d(jnp.asarray(d))),
                               expect, rtol=1e-5)
    img = rng.normal(size=(8, 8, 4)).astype(np.float32)
    got = float(DR.reg_loss_image_2d4f(jnp.asarray(img.reshape(-1, 4)), 8, 8))
    exp = 0.0
    for y in range(1, 7):
        for x in range(1, 7):
            p0 = img[y, x, :3]
            s = (((p0 - img[y+1, x, :3])**2).sum()
                 + ((p0 - img[y-1, x, :3])**2).sum()
                 + ((p0 - img[y, x-1, :3])**2).sum()
                 + ((p0 - img[y, x+1, :3])**2).sum())
            exp += np.sqrt(s + 1e-20)
    np.testing.assert_allclose(got, exp, rtol=1e-4)
    # differentiable
    import jax
    g = jax.grad(lambda p: DR.reg_loss_image_2d4f(p, 8, 8))(
        jnp.asarray(img.reshape(-1, 4)))
    assert np.isfinite(np.asarray(g)).all() and float(jnp.abs(g).sum()) > 0


def test_material_param_grads(cornell_scene):
    """Material-scalar registry: gradient of the loss w.r.t. a diffuse
    color column is non-zero and matches finite differences."""
    import numpy as np
    import jax.numpy as jnp
    from hydracore3.models import dr as DR
    from hydracore3.ops import rng as RNG
    scene, meta = cornell_scene
    setup = DR.DiffMatSetup(mat_ids=(0,), cols=(0, 1, 2))
    n = meta.width * meta.height
    pix = jnp.arange(n, dtype=jnp.int32)
    rngs = RNG.gen_init(pix)
    ref = jnp.zeros((n, 3), jnp.float32)
    p0 = jnp.asarray(np.asarray(
        scene.mat_packed_f32[jnp.asarray(setup.mat_ids)][:, :3]))
    loss, grads, _ = DR.mat_loss_and_grad(p0, scene, meta, setup, rngs, pix, ref)
    assert float(jnp.abs(grads).sum()) > 0
    eps = 1e-3
    dp = jnp.zeros_like(p0).at[0, 0].set(eps)
    lp, _, _ = DR.mat_loss_and_grad(p0 + dp, scene, meta, setup, rngs, pix, ref)
    lm, _, _ = DR.mat_loss_and_grad(p0 - dp, scene, meta, setup, rngs, pix, ref)
    fd = (float(lp) - float(lm)) / (2 * eps)
    np.testing.assert_allclose(float(grads[0, 0]), fd, rtol=0.05, atol=1e-3)


def test_whitted_ad_grads(cornell_scene):
    import numpy as np
    import jax.numpy as jnp
    from hydracore3.models import dr as DR
    scene, meta = cornell_scene
    setup = DR.put_diff_tex(scene, 1 if scene.textures.offset.shape[0] > 1 else 0)
    n = meta.width * meta.height
    pix = jnp.arange(n, dtype=jnp.int32)
    ref = jnp.zeros((n, 3), jnp.float32)
    params = scene.textures.texels[
        setup.texel_offset:setup.texel_offset + setup.size]
    loss, grads = DR.whitted_loss_and_grad(params, scene, meta, setup, pix, ref)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(grads)).all()
    assert float(jnp.abs(grads).sum()) > 0


def test_optimize_texture_scan_loss_decreases(dr_setup):
    import numpy as np
    from hydracore3.models import dr as DR
    from hydracore3 import render as R
    scene, meta, setup = dr_setup
    ref = R.render(scene, meta, spp=16, integrator='mispt')
    params, losses = DR.optimize_texture_scan(
        scene, meta, setup, ref, iters=6, spp=2, reg_weight=1e-4,
        verbose=False)
    assert losses[-1] < losses[0] * 0.97, losses
