"""Device-mesh helpers.

The reference has no multi-device story (SURVEY.md §2.3); its parallelism is
std::thread + SIMD. The device equivalents are:

- data parallelism over independent panoramas/pairs (the batch axis) —
  sharded over the ``data`` mesh axis, no cross-image communication;
- spatial parallelism over canvas rows for large-canvas kernels — sharded
  over the ``sp`` axis with ppermute halo exchanges.

The mesh is a plain reshape of the device list: the cards of one host reach
each other at the same rate (NVLink, all to all), so no layout is assumed.
Everything below works on any jax.sharding.Mesh, so a multi-host mesh
composes for free.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, sp: int = 1,
              devices=None) -> Mesh:
    """A (data, sp) mesh. sp divides n_devices; data = n_devices // sp."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices % sp != 0:
        raise ValueError(f"sp={sp} must divide n_devices={n_devices}")
    arr = np.array(devices).reshape(n_devices // sp, sp)
    return Mesh(arr, ("data", "sp"))
