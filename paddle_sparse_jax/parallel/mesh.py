"""Device-mesh helpers.

All distribution in this framework is expressed as JAX collectives over a
named ``Mesh`` (SURVEY.md §5: "no hand-rolled NCCL/MPI-equivalent") — XLA
hands them to NCCL, over NVLink between the cards of one host.  Every
card reaches every other at the same rate, so the mesh shape follows the
algorithm alone.
"""
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "x") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of the default
    backend.  Raises when the backend has fewer: a run that asked for
    cards does not quietly move to virtual CPU devices."""
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(
                f"need {n_devices} {jax.default_backend()} devices, have "
                f"{len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_rows(mesh: Mesh, array: jax.Array, axis_name: str = "x") -> jax.Array:
    """Place ``array`` row-sharded over the mesh axis."""
    spec = P(axis_name, *([None] * (array.ndim - 1)))
    return jax.device_put(array, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, array: jax.Array) -> jax.Array:
    return jax.device_put(array, NamedSharding(mesh, P()))
