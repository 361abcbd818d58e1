"""Spectral rendering core: hero-wavelength sampling, SPD lookups, CIE curves.

Mirrors the reference's spectrum.h/.cpp: 4-wavelength hero packets sampled
stratified over [LAMBDA_MIN, LAMBDA_MAX] (spectrum.h:58-74), SPDs resampled
onto a uniform 1nm grid (spectrum.cpp:42-48) and lerped at sample time
(spectrum.h:106-126 SampleUniformSpectrum), CIE-1931 conversion
(spectrum.h:151-219).  The CIE tables ship as a binary asset
(``cie1931.npz``, public-domain CIE data).
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
SPECTRUM_SAMPLE_SZ = 4
CIE_Y_INTEGRAL = 106.856895
N_CIE_SAMPLES = 471

_CIE_CACHE = None


def cie_xyz_table() -> np.ndarray:
    """[471, 4] float32 (x, y, z, 0) indexed by round(lambda) - 360."""
    global _CIE_CACHE
    if _CIE_CACHE is None:
        path = os.path.join(os.path.dirname(__file__), 'cie1931.npz')
        d = np.load(path)
        _CIE_CACHE = np.stack(
            [d['x'], d['y'], d['z'], np.zeros_like(d['x'])], axis=-1
        ).astype(np.float32)
    return _CIE_CACHE


def sample_wavelengths(u, a=LAMBDA_MIN, b=LAMBDA_MAX):
    """Stratified hero wavelengths (spectrum.h:58-74). u: [...] -> [..., 4]."""
    l0 = a + (b - a) * u
    delta = (b - a) / SPECTRUM_SAMPLE_SZ
    waves = [l0]
    for i in range(1, SPECTRUM_SAMPLE_SZ):
        nxt = waves[-1] + delta
        nxt = jnp.where(nxt > b, a + (nxt - b), nxt)
        waves.append(nxt)
    return jnp.stack(waves, axis=-1)


def sample_uniform_spectrum(spec_values, offset, wavelengths):
    """spectrum.h:106-126: lerp on the 1nm uniform grid.

    spec_values: flat [..] table; offset: int32 [...]; wavelengths: [..., 4].
    """
    wavesn = int(LAMBDA_MAX - LAMBDA_MIN)
    idx1 = jnp.clip(wavelengths - LAMBDA_MIN, 0.0, wavesn - 1).astype(jnp.int32)
    idx2 = jnp.minimum(idx1 + 1, wavesn - 1)
    x1 = LAMBDA_MIN + idx1.astype(jnp.float32)
    off = offset[..., None]
    y1 = spec_values[off + idx1]
    y2 = spec_values[off + idx2]
    return y1 + (wavelengths - x1) * (y2 - y1)


def spectrum_to_xyz(spec, lam, cie_xyz, terminate_waves):
    """spectrum.h:151-208. spec/lam: [..., 4]; cie_xyz: [471, 4].

    terminate_waves: bool [...] — when waves diverged, only lane 0 carries
    energy and its pdf shrinks by 1/4.
    """
    pdf0 = 1.0 / (LAMBDA_MAX - LAMBDA_MIN)
    pdf = jnp.full(spec.shape, pdf0, spec.dtype)
    tw = terminate_waves[..., None]
    pdf = jnp.where(tw, jnp.concatenate([
        jnp.full_like(pdf[..., :1], pdf0 / SPECTRUM_SAMPLE_SZ),
        jnp.zeros_like(pdf[..., 1:])], axis=-1), pdf)
    specp = jnp.where(pdf != 0, spec / pdf, 0.0)

    offset = (jnp.floor(lam + 0.5) - LAMBDA_MIN).astype(jnp.int32)
    valid = (offset >= 0) & (offset < N_CIE_SAMPLES)
    offset_c = jnp.clip(offset, 0, N_CIE_SAMPLES - 1)
    xyz = cie_xyz[offset_c]  # [..., 4, 4]
    xyz = jnp.where(valid[..., None], xyz, 0.0)
    weighted = xyz[..., :3] * specp[..., None]
    return jnp.mean(weighted, axis=-2) / CIE_Y_INTEGRAL


def xyz_to_rgb(xyz):
    """spectrum.h:212-219 (sRGB primaries, linear)."""
    m = jnp.array([[3.240479, -1.537150, -0.498535],
                   [-0.969256, 1.875991, 0.041556],
                   [0.055648, -0.204043, 1.057311]], xyz.dtype)
    return jnp.sum(m * xyz[..., None, :], axis=-1)   # exact f32, no TF32
