"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests run on the CPU (deterministic) with 8 virtual devices, so the
multi-device sharding paths are exercised without cards (SURVEY.md §4).
This must run before jax is imported anywhere.  Tests that only a GPU can
run take the ``gpu_only`` fixture and skip here.
"""
import os

os.environ['JAX_PLATFORMS'] = 'cpu'
xla_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in xla_flags:
    os.environ['XLA_FLAGS'] = (
        xla_flags + ' --xla_force_host_platform_device_count=8').strip()

import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import jax

jax.config.update('jax_platforms', 'cpu')

# importing the package sets the persistent compilation cache: the
# directory in JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache
import hydracore3  # noqa: E402,F401

import pytest


def box_downsample(img, k=4):
    """Box-filter downsample for MC-noise-tolerant image comparisons."""
    import numpy as np
    h, w = img.shape[0] // k * k, img.shape[1] // k * k
    img = img[:h, :w]
    return np.asarray(img).reshape(h // k, k, w // k, k, -1).mean((1, 3))

REF_SCENES = pathlib.Path('/root/reference/scenes')


@pytest.fixture(scope='session')
def cornell_scene():
    from hydracore3.scene import build as SB
    return SB.load_scene(str(REF_SCENES / 'test_035/statex_00001.xml'),
                         width=64, height=48)


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default device is a GPU.  Decided at run time, so
    every test worker collects the same tests."""
    if jax.devices()[0].platform != 'gpu':
        pytest.skip('needs a GPU: the Triton kernel has no CPU lowering '
                    '(its interpret-mode twin runs here)')
