"""Device-mesh helpers.

Parity mapping (SURVEY.md section 2.3): flypylib's only parallelism was
single-node multi-GPU data parallelism (multi_gpu.make_parallel + volume
sharding across GPU threads).  The equivalents here run over a
``jax.sharding.Mesh``:

- ``data`` axis — batch-sharded training (replaces make_parallel),
- ``space`` axis — volume-sharded halo inference (replaces the per-GPU
  volume-block threads), collectives between devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh_2d(shape: tuple[int, int], axes=("data", "space")) -> Mesh:
    devs = np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    return Mesh(devs, axes)


def make_mesh_3d(
    shape: tuple[int, int, int], axes=("spacez", "spacey", "spacex")
) -> Mesh:
    devs = np.array(
        jax.devices()[: shape[0] * shape[1] * shape[2]]
    ).reshape(shape)
    return Mesh(devs, axes)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))
