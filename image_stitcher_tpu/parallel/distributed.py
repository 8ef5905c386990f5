"""Multi-process JAX wiring: one global mesh over several processes.

The reference scaled past one host with a multiprocessing Pool writing
disjoint zarr slices (zarr_stitcher.py:570-612). The accelerator
equivalent is multi-controller JAX: every process runs the same program,
``jax.distributed.initialize`` federates their devices, and one global
``Mesh`` spans them with the stitcher's two axes laid out so that

- 'canvas' (band fusion: replicated tile broadcast + banded writes)
  stays WITHIN each process's own devices, and
- 'data'   (independent batch work: registration pairs, flatfield
  stacks) crosses processes, where the only collectives are small
  reductions (shift medians, fit statistics).

Recipe (several GPUs of one host, one process per card)::

    from image_stitcher_tpu.parallel import distributed as dist
    dist.initialize('localhost:12345', num_processes=4, process_id=i,
                    local_device_ids=[i])
    mesh = dist.make_pod_mesh()       # (data=processes, canvas=local)
    # then run the ordinary pipeline with EngineOptions(mesh_shape=...)
    # in each process; each process writes its own bands (disjoint rows)

A single-process run returns the ordinary local mesh, so the same code
runs unchanged from one device to many processes.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .mesh import AXIS_CANVAS, AXIS_DATA


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               local_device_ids: Optional[Sequence[int]] = None,
               platform: Optional[str] = None) -> None:
    """Initialize multi-controller JAX.

    Nothing is discovered from the environment: pass the coordinator
    (``host:port``), the process count and this process's id.
    Processes that share one host each take only their own cards with
    ``local_device_ids`` (on a GPU host, otherwise every process would
    claim every card). ``platform='cpu'`` selects the CPU backend before
    any backend initializes (the localhost test harness).
    """
    import jax
    if platform:
        jax.config.update('jax_platforms', platform)
    jax.distributed.initialize(coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def make_pod_mesh(local_shape: Optional[Tuple[int, int]] = None):
    """Build the global (data, canvas) mesh over all federated devices.

    Rows of the device grid are processes, columns are each process's
    local devices: ``data`` maps to the process axis, ``canvas`` to the
    local axis, so the fusion hot loop (banded canvas updates) never
    crosses processes. ``local_shape=(d, c)`` optionally
    splits each process's devices between both axes (data = processes*d).
    """
    import jax
    from jax.sharding import Mesh
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_proc = jax.process_count()
    per_proc = len(devs) // n_proc
    grid = np.asarray(devs).reshape(n_proc, per_proc)
    if local_shape is not None:
        d, c = local_shape
        if d * c != per_proc:
            raise ValueError(f"local_shape {local_shape} != {per_proc} "
                             "devices per process")
        grid = grid.reshape(n_proc * d, c)
    return Mesh(grid, (AXIS_DATA, AXIS_CANVAS))


def replicate_to_mesh(mesh, *arrays):
    """Lift identical process-local host arrays to replicated global
    arrays on ``mesh`` (every process must pass the same values)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P())
    return tuple(jax.make_array_from_process_local_data(sh, np.asarray(a))
                 for a in arrays)


def stitch_distributed(params, options=None, reporter=None):
    """Run one stitching job cooperatively across every federated
    process: the multi-process successor of the reference's Pool fan-out
    (zarr_stitcher.py:570-612), lifted from FOVs to whole (timepoint,
    region) units across hosts.

    Call after :func:`initialize`. Each process stitches the units it
    owns (deterministic round-robin) into ONE shared output tree; all
    processes barrier, then process 0 runs the merge passes. Returns
    this process's StitchPipeline.
    """
    import dataclasses

    import jax

    from ..models.pipeline import StitchPipeline
    from ..params import EngineOptions

    opts = dataclasses.replace(options) if options is not None \
        else EngineOptions()
    if opts.output_folder is None:
        # deterministic (timestamps differ across processes)
        opts.output_folder = params.input_folder + "_stitched_distributed"
    opts.work_shard = (jax.process_index(), jax.process_count())
    pipe = StitchPipeline(params, opts, reporter)
    pipe.run()
    return pipe


# ---------------------------------------------------------------------------
# Localhost multi-process validation worker (used by tests and the
# driver dryrun): `python -m image_stitcher_tpu.parallel.distributed
# <process_id> <num_processes> <port>` — every process must see the
# federated device count, run a cross-process psum, and fuse one replicated
# tile batch through ShardedCanvas, matching the single-device kernel.
# ---------------------------------------------------------------------------

def _worker_main(process_id: int, num_processes: int, port: int) -> None:
    initialize(f"localhost:{port}", num_processes=num_processes,
               process_id=process_id, platform='cpu')
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == num_processes * n_local, (n_global, n_local)
    mesh = make_pod_mesh()

    # 1. Cross-process collective: psum over 'data' (one row per process).
    def allsum(x):
        return jax.lax.psum(x, AXIS_DATA)

    f = jax.jit(shard_map(allsum, mesh=mesh, in_specs=P(AXIS_DATA),
                          out_specs=P(AXIS_DATA)))
    from jax.sharding import NamedSharding
    local = np.full((1, 8), float(process_id + 1), np.float32)
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(AXIS_DATA)), local)
    out = f(garr)
    expect = sum(range(1, num_processes + 1))
    got = np.asarray(out.addressable_shards[0].data)
    assert np.all(got == expect), (got, expect)

    # 2. Banded canvas fusion over the global mesh vs the single-device
    # kernel on local inputs.
    from ..ops.fuse import fuse_overwrite, padded_canvas_shape
    from .sharded_fuse import ShardedCanvas
    rng = np.random.default_rng(0)
    H = W = 64
    th = tw = 16
    nb = 6
    tiles = rng.integers(0, 60000, (nb, th, tw), np.uint16)
    info = np.stack([np.zeros(nb, int), np.zeros(nb, int),
                     rng.integers(0, H - th, nb),
                     rng.integers(0, W - tw, nb)], 1).astype(np.int32)
    crops = np.zeros((nb, 4), np.int32)
    valid = np.ones((nb,), bool)

    canvas = ShardedCanvas(mesh, 1, 1, H, W, th, tw, jnp.uint16)
    gtiles, ginfo, gcrops, gvalid = replicate_to_mesh(
        mesh, tiles, info, crops, valid)
    canvas.fuse_batch(gtiles, ginfo, gcrops, gvalid)
    fused = canvas.finalize()
    from jax.experimental import multihost_utils
    fused_host = np.asarray(multihost_utils.process_allgather(fused,
                                                              tiled=True))

    ref = jnp.zeros(padded_canvas_shape(1, 1, H, W, th, tw), jnp.uint16)
    ref = np.asarray(fuse_overwrite(ref, jnp.asarray(tiles),
                                    jnp.asarray(info), jnp.asarray(crops),
                                    jnp.asarray(valid)))[:, :, :H, :W]
    np.testing.assert_array_equal(np.asarray(fused_host).reshape(ref.shape),
                                  ref)
    print(f"distributed worker {process_id}/{num_processes} OK "
          f"({n_global} global devices)", flush=True)


def run_localhost_validation(num_processes: int = 2, port: int = 0,
                             devices_per_process: int = 2,
                             timeout: float = 240.0) -> None:
    """Spawn ``num_processes`` local workers federated over localhost and
    assert the full multi-process story (init, cross-process psum, sharded fusion
    parity). Raises on any worker failure."""
    import socket
    import subprocess
    import sys
    if port == 0:
        s = socket.socket()
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
        s.close()
    env = {k: v for k, v in os.environ.items() if k != 'JAX_PLATFORMS'}
    env['JAX_PLATFORMS'] = 'cpu'
    env['XLA_FLAGS'] = (env.get('XLA_FLAGS', '') +
                        f' --xla_force_host_platform_device_count='
                        f'{devices_per_process}').strip()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'image_stitcher_tpu.parallel.distributed',
         str(i), str(num_processes), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        for i in range(num_processes)]
    failures = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failures.append(f"worker timed out:\n{out.decode()[-2000:]}")
            continue
        if p.returncode != 0:
            failures.append(f"worker rc={p.returncode}:\n"
                            f"{out.decode()[-2000:]}")
    if failures:
        raise RuntimeError("multi-process validation failed:\n"
                           + "\n---\n".join(failures))


if __name__ == '__main__':
    import sys
    _worker_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
