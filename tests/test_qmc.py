"""QMC sampler tests: Niederreiter table properties + QMC render consistency."""
import numpy as np
import jax.numpy as jnp


def test_dim0_van_der_corput():
    from hydracore3.ops import qmc
    t = jnp.asarray(qmc.nied_table())
    vals = np.array([float(qmc.rnd_float(t, jnp.uint32(i), 0)) for i in range(8)])
    np.testing.assert_allclose(vals, [0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875],
                               atol=1e-6)


def test_stratification():
    """First 2^k points of every dim must be a (0,1)-stratified set."""
    from hydracore3.ops import qmc
    t = jnp.asarray(qmc.nied_table())
    pos = jnp.arange(256, dtype=jnp.uint32)
    for d in range(qmc.QRNG_DIMENSIONS):
        v = np.asarray(qmc.rnd_float(t, pos, d))
        # Niederreiter is a (t,s)-sequence: at 16-bin granularity every bin
        # gets exactly 16 of the first 256 points, in every dimension
        bins = np.bincount(np.floor(v * 16).astype(int), minlength=16)
        assert bins.min() == 16 and bins.max() == 16, f'dim {d} not stratified'


def test_qmc_dim_assignment_table():
    """EnableQMC dim layout per feature combo (mlt/integrator_qmc.cpp:28-86).

    Dims 0/1 are always pixel position; 2/3 lens when DoF (thin lens OR
    optics sim) is on.  (spd_dim, mat_dim, lgt_dim) per (dof, spd, motion),
    zero meaning 'feature off / served by the pseudo RNG'."""
    from hydracore3 import render as R

    class M:  # minimal SceneMeta stand-in: _qmc_dims touches only these
        def __init__(self, dof, spd, motion, optics=False):
            self.cam_lens_radius = 0.1 if dof else 0.0
            self.lens_lines = ((0.0, 1.0, 1.0, 1.0),) if optics else ()
            self.spectral_mode = spd
            self.has_motion = motion

    expect = {  # (dof, spd, motion) -> (spd_dim, mat_dim, lgt_dim)
        (True, True, True): (4, 0, 0),
        (True, True, False): (4, 5, 7),
        (False, True, True): (3, 4, 6),
        (True, False, True): (0, 5, 7),
        (True, False, False): (0, 4, 6),
        (False, True, False): (4, 2, 5),
        (False, False, True): (0, 2, 5),
        (False, False, False): (0, 2, 4),
    }
    for (dof, spd, motion), dims in expect.items():
        assert R._qmc_dims(M(dof, spd, motion)) == dims, (dof, spd, motion)
    # the optics simulator also occupies the lens dims (EnableQMC:13)
    assert R._qmc_dims(M(False, False, False, optics=True)) == (0, 4, 6)
    assert R._qmc_dims(M(False, True, False, optics=True)) == (4, 5, 7)


def test_qmc_render_matches_pseudo(cornell_scene):
    """QMC and pseudo renders estimate the same image (PSNR)."""
    from hydracore3 import render as R
    from hydracore3.utils.imageio import psnr
    from conftest import box_downsample
    scene, meta = cornell_scene
    a = np.asarray(R.render(scene, meta, spp=16, integrator='mispt'))
    b = np.asarray(R.render_qmc(scene, meta, spp=16, integrator='mispt'))
    la = np.clip(box_downsample(a[..., :3]), 0, 1) ** (1 / 2.2) * 255
    lb = np.clip(box_downsample(b[..., :3]), 0, 1) ** (1 / 2.2) * 255
    val = psnr(la, lb)
    assert val > 25.0, val
