"""hydracore3: a differentiable spectral path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
Ray-Tracing-Systems/HydraCore3 (see SURVEY.md for the reference analysis).
"""
import os as _os

__version__ = '0.3.0'

CHECKOUT_DIR = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Where compiled programs persist across processes: the directory in
    ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself),
    else ``<checkout>/.jax_cache``."""
    return (_os.environ.get('JAX_COMPILATION_CACHE_DIR')
            or _os.path.join(CHECKOUT_DIR, '.jax_cache'))


def _enable_compile_cache():
    import jax
    if not _os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir', compile_cache_dir())
    # the whole-pass render programs are large: keep every entry that took
    # a second or more to compile
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)


_enable_compile_cache()
