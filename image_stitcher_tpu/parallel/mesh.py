"""Device mesh construction and sharding specs.

The stitcher's two parallel axes (SURVEY.md §2b):
- 'data'   — batch parallelism: registration pairs, flatfield stacks,
  tile-batch preprocessing (the device counterpart of the reference's
  Pool.imap_unordered FOV fan-out, zarr_stitcher.py:580-597).
- 'canvas' — spatial parallelism: the fused canvas is sharded into Y
  bands across devices (the device counterpart of the reference's scale
  story, i.e. never materializing the canvas in one place, SURVEY.md §5).

The mesh shape follows the algorithm alone: NVLink joins every card of a
host to every other at the same rate, so no split is favoured by the
wiring.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_DATA = 'data'
AXIS_CANVAS = 'canvas'


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, canvas) mesh.

    ``shape`` is (n_data, n_canvas); default uses all devices on the
    canvas axis (fusion is the bandwidth-bound stage).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (1, n)
    needed = shape[0] * shape[1]
    if needed > n:
        raise ValueError(f"mesh shape {shape} needs {needed} devices, "
                         f"only {n} available")
    arr = np.asarray(devices[:needed]).reshape(shape)
    return Mesh(arr, (AXIS_DATA, AXIS_CANVAS))


def default_mesh_shape(n: int) -> Tuple[int, int]:
    """Split devices 2 x n/2 when possible so both axes are exercised
    (the multi-device dry run's choice; the pipeline takes
    ``EngineOptions.mesh_shape`` as given)."""
    if n % 2 == 0 and n > 1:
        return (2, n // 2)
    return (1, n)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading batch axis across the data axis."""
    return NamedSharding(mesh, P(AXIS_DATA))


def band_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading band axis of a banded canvas across 'canvas'."""
    return NamedSharding(mesh, P(AXIS_CANVAS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
