"""Device mesh + sharding helpers.

The reference's distributed story is DDP scaffolding that was never enabled
(SURVEY.md §2.4). This design replaces it with GSPMD: one
``jax.sharding.Mesh`` with a ``data`` axis; batches are sharded over it,
parameters replicated, and XLA inserts the gradient all-reduces and the
discriminator minibatch-std reduction automatically (global-batch semantics
under jit — the reference's explicit all_reduce at custom_stylegan2/net.py:
665-667 falls out for free).

Two scaling axes are supported (SURVEY.md §5.7):
  * DP over images/poses — ``shard_batch`` on the leading axis;
  * ray sharding within an image for single-image inference —
    ``shard_rays`` splits the ray axis across the same mesh (rays are
    embarrassingly parallel; only the small tri-plane features replicate).

Multi-host: call ``jax.distributed.initialize()`` before ``make_mesh`` and
the same code runs over DCN+ICI.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0,
                  axis_name: str = "data") -> NamedSharding:
    spec = [None] * ndim
    spec[axis] = axis_name
    return NamedSharding(mesh, P(*spec))


def shard_batch(mesh: Mesh, batch, axis_name: str = "data"):
    """Place a pytree of host arrays on the mesh, sharded on axis 0."""
    def put(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(x, data_sharding(mesh, x.ndim, 0, axis_name))
    return jax.tree_util.tree_map(put, batch)


def shard_rays(mesh: Mesh, image_coord, axis_name: str = "data"):
    """Shard the ray axis of (B, 1, 3, n) homogeneous coords across the mesh."""
    return jax.device_put(
        image_coord, NamedSharding(mesh, P(None, None, None, axis_name)))


def replicate(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)
