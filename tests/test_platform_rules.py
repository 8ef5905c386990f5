"""What the program decides from the platform: the fusion backend rule,
the compile-cache location, and per-process card selection."""

import os
import subprocess
import sys

import pytest

from image_stitcher_tpu import EngineOptions, StitchingParameters
from image_stitcher_tpu.utils.progress import ProgressReporter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("fusion_device", ["auto", "device", "host"])
def test_fusion_backend_rule(tmp_path, monkeypatch, platform, fusion_device):
    """'auto' is the device canvas on a GPU and the host canvas on the
    CPU backend, reported on the status line; an explicit choice is
    taken as given and not reported."""
    from image_stitcher_tpu.models import pipeline as pl
    monkeypatch.setattr(pl.jax, "default_backend", lambda: platform)
    status = []
    pipe = pl.StitchPipeline(
        StitchingParameters(input_folder=str(tmp_path)),
        EngineOptions(fusion_device=fusion_device),
        ProgressReporter(status=lambda msg, saving=False: status.append(msg)))
    expect = (fusion_device if fusion_device != 'auto'
              else 'device' if platform == 'gpu' else 'host')
    assert pipe._select_fusion_backend() == expect
    assert (f"fusion backend: {expect}" in status) == (fusion_device == 'auto')


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    if env_value is not None:
        env['JAX_COMPILATION_CACHE_DIR'] = env_value
    out = subprocess.run(
        [sys.executable, '-c',
         'import image_stitcher_tpu, jax; '
         'print(jax.config.jax_compilation_cache_dir)'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout():
    """Unset JAX_COMPILATION_CACHE_DIR: a fixed path inside the checkout
    (no temporary name, pid or time in it)."""
    assert _cache_dir_in_child(None) == os.path.join(REPO, '.jax_cache')


def test_compile_cache_honours_env(tmp_path):
    """Set: the program uses it and sets no other directory."""
    want = str(tmp_path / 'cc')
    assert _cache_dir_in_child(want) == want


def test_distributed_initialize_takes_own_cards(monkeypatch):
    """Processes sharing a host each claim only their own cards."""
    import jax

    from image_stitcher_tpu.parallel import distributed
    seen = {}
    monkeypatch.setattr(jax.distributed, 'initialize',
                        lambda *a, **k: seen.update(args=a, kwargs=k))
    distributed.initialize('localhost:1234', num_processes=4, process_id=2,
                           local_device_ids=[2])
    assert seen['args'] == ('localhost:1234',)
    assert seen['kwargs'] == {'num_processes': 4, 'process_id': 2,
                              'local_device_ids': [2]}
