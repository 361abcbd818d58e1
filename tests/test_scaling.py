"""Multi-device sharding: determinism across device counts + the scaling
harness (SURVEY §2.5 distributed backend; BASELINE scaling-efficiency
metric is measured by parallel.mesh.scaling_report on real hardware)."""
import jax
import numpy as np
import pytest

from hydracore3.scene import synth
from hydracore3.parallel import mesh as M


@pytest.fixture(scope='module')
def tiny_scene():
    """A small textured city (in-repo, deterministic)."""
    return synth.city_scene(n_blocks=2, subdiv=1, seed=3, width=32,
                            height=32, depth=2, ground_subdiv=2,
                            textured=True)


def test_image_invariant_to_device_count(tiny_scene):
    """The per-pixel counter-keyed RNG makes the image BITWISE identical
    for any sharding (P7: thread-id->RNG mapping is sharding-invariant)."""
    scene, meta = tiny_scene
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    img1 = M.render_sharded(M.make_mesh(jax.devices()[:1]), scene, meta, spp=2)
    img8 = M.render_sharded(M.make_mesh(jax.devices()[:8]), scene, meta, spp=2)
    np.testing.assert_array_equal(img1, img8)


def test_scaling_report_runs(tiny_scene):
    scene, meta = tiny_scene
    rows = M.scaling_report(scene, meta, spp=1,
                            device_counts=[1, min(8, len(jax.devices()))],
                            verbose=False)
    assert rows[0]['devices'] == 1
    assert all(r['msamples_s'] > 0 for r in rows)
    # weak scaling on a shared-core virtual mesh: total throughput should
    # hold roughly constant (sharding adds no overhead on fixed physical
    # compute); this is the CPU-mesh analog of the >=80% hardware target.
    # VERDICT r3 weak-point 4: tightened from 0.5 to 0.9
    assert rows[-1]['overhead_efficiency'] > 0.9


def test_two_process_distributed_init(tmp_path):
    """The jax.distributed DCN code path must at least initialize and run a
    cross-process psum in 2-process CPU mode (SURVEY §2.5 comm backend;
    VERDICT r3 weak-point 4: previously exercised by no test)."""
    import os
    import socket
    import subprocess
    import sys
    import textwrap

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]

    prog = textwrap.dedent('''
        import os, sys
        os.environ['JAX_PLATFORMS'] = 'cpu'
        sys.path.insert(0, os.environ['REPO'])
        import jax
        jax.config.update('jax_platforms', 'cpu')
        from hydracore3.parallel import mesh as M
        mesh = M.init_distributed()
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from jax import shard_map
        n = jax.device_count()
        assert n == 2, f'global devices {n}'
        f = jax.jit(shard_map(lambda x: jax.lax.psum(x, M.DATA_AXIS),
                              mesh=mesh, in_specs=P(M.DATA_AXIS),
                              out_specs=P(), check_vma=False))
        out = f(jnp.arange(2.0))
        assert float(out[0]) == 1.0, out
        print('DIST_OK', jax.process_index(), n)
    ''')
    env_base = dict(os.environ)
    env_base['REPO'] = str(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env_base['JAX_COORDINATOR_ADDRESS'] = f'127.0.0.1:{port}'
    env_base['JAX_NUM_PROCESSES'] = '2'
    # one virtual CPU device per process
    env_base['XLA_FLAGS'] = '--xla_force_host_platform_device_count=1'
    procs = []
    for pid in range(2):
        env = dict(env_base, JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, '-c', prog],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail('distributed smoke timed out')
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'proc {i} failed:\n{out[-2000:]}'
        assert 'DIST_OK' in out
