"""Unit tests for math helpers against closed forms."""
import numpy as np
import jax.numpy as jnp

from hydracore3.utils import lmath as LM


def test_normalize():
    v = jnp.array([[3.0, 0.0, 4.0], [0.0, 2.0, 0.0]])
    n = LM.normalize(v)
    np.testing.assert_allclose(np.asarray(LM.length(n)), 1.0, rtol=1e-6)


def test_coordinate_system_orthonormal():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(100, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    s, t = LM.coordinate_system_v2(jnp.asarray(n))
    s, t = np.asarray(s), np.asarray(t)
    np.testing.assert_allclose(np.abs(np.sum(s * n, -1)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.abs(np.sum(t * n, -1)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.abs(np.sum(s * t, -1)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(s, axis=-1), 1.0, atol=1e-5)


def test_map_samples_to_disc_radius():
    rng = np.random.default_rng(1)
    xy = rng.uniform(-1, 1, size=(1000, 2)).astype(np.float32)
    d = np.asarray(LM.map_samples_to_disc(jnp.asarray(xy)))
    r = np.linalg.norm(d, axis=-1)
    assert r.max() <= 1.0 + 1e-5


def test_cosine_sampling_distribution():
    """Lambert samples must integrate cos/pi to 1 and stay in hemisphere."""
    rng = np.random.default_rng(2)
    r1 = rng.uniform(size=20000).astype(np.float32)
    r2 = rng.uniform(size=20000).astype(np.float32)
    n = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], jnp.float32), (20000, 1))
    d = np.asarray(LM.map_sample_to_cosine_distribution(
        jnp.asarray(r1), jnp.asarray(r2), n, n, 1.0))
    assert (d[:, 2] >= -1e-6).all()
    # E[cos] for cosine-weighted sampling is 2/3
    np.testing.assert_allclose(d[:, 2].mean(), 2.0 / 3.0, atol=0.01)


def test_mis_weight():
    w = LM.mis_weight_heuristic(jnp.float32(1.0), jnp.float32(1.0))
    np.testing.assert_allclose(float(w), 0.5)
    w = LM.mis_weight_heuristic(jnp.float32(np.inf), jnp.float32(1.0))
    assert np.isfinite(float(w))


def test_sphere_map_roundtrip():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(100, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tc, _ = LM.sphere_map_to_2d_tex_coord(jnp.asarray(d))
    d2, _ = LM.tex_coord_2d_to_sphere_map(tc)
    np.testing.assert_allclose(np.asarray(d2), d, atol=1e-3)


def test_perspective_lookat_ray():
    """Center pixel of a lookAt camera must shoot toward the target."""
    proj = LM.perspective_matrix(45.0, 1.0, 0.01, 100.0)
    proj_inv = np.linalg.inv(proj)
    d = np.asarray(LM.eye_ray_dir_normalized(
        jnp.float32(0.5), jnp.float32(0.5), jnp.asarray(proj_inv)))
    np.testing.assert_allclose(d, [0, 0, -1], atol=1e-5)
