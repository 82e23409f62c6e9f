"""Device mesh and topology management.

The JAX replacement for the reference's multi-device vocabulary:
one MPI rank per GPU with ``cudaSetDevice(MPIlocalrank)``
(GPUdrivers.cu:284-288) and the OpenMP lane round-robin
(GPUdrivers.cu:331-335) become one ``jax.sharding.Mesh`` over all devices,
with observation rays domain-decomposed over the ``"rays"`` axis and the
spectral channel axis optionally sharded over ``"chan"`` (legitimate
because the transmittance recursion carries no cross-channel state,
jr_common.h:271-280).

Tables are replicated over ``"rays"`` and sharded over ``"chan"``
(channel is the minor-most axis of every LUT array, mirroring
jurassic.h:408-411), so per-device LUT footprint shrinks with spectral
sharding -- the answer to the reference's multi-GB unified-memory
tables (GPUdrivers.cu:83-90).
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"
CHAN_AXIS = "chan"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host initialisation (the analogue of the upstream MPI harness;
    the reference only consumes rank ids for device selection,
    jurassic.h:336-338).  No-op when single-process env vars are absent."""
    if coordinator is None and "JAX_COORDINATOR_ADDRESS" not in os.environ \
            and "COORDINATOR_ADDRESS" not in os.environ:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes, process_id=process_id)


def make_mesh(n_rays: int | None = None, n_chan: int = 1,
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Build a ("rays", "chan") mesh over the given (default: all) devices.

    ``n_rays`` defaults to ``len(devices) // n_chan``.  Rays ride the
    outer axis so ray-batch data parallelism maps to whole hosts first
    (DCN) and chips within a host (ICI) second.
    """
    devs = list(devices) if devices is not None else list(jax.devices())
    if n_rays is None:
        n_rays = len(devs) // n_chan
    need = n_rays * n_chan
    if need > len(devs):
        raise ValueError(
            f"mesh {n_rays}x{n_chan} needs {need} devices, "
            f"have {len(devs)}")
    grid = np.asarray(devs[:need]).reshape(n_rays, n_chan)
    return Mesh(grid, (RAY_AXIS, CHAN_AXIS))


def ray_sharding(mesh: Mesh, extra_dims: int = 1) -> NamedSharding:
    """[R, ...] arrays: rays sharded, everything else replicated."""
    return NamedSharding(mesh, P(RAY_AXIS, *([None] * (extra_dims - 1))))


def chan_minor_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """LUT-style arrays with the channel as minor-most axis."""
    return NamedSharding(mesh, P(*([None] * (ndim - 1)), CHAN_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to(n: int, multiple: int) -> int:
    return int(math.ceil(n / max(multiple, 1)) * max(multiple, 1))
