"""Spatially-sharded image kernels (canvas/row parallelism across devices).

The reference's unbounded dimension is the growing canvas
(ImageProcess.cpp:215-219, SURVEY.md §5 "long-context analog"). For canvases
that outgrow one device's comfort zone, row-sharded kernels keep every
device working on its stripe and exchange only the filter halo with its
neighbors via ppermute — the classic halo-exchange pattern.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.gaussian import gauss_taps, _conv1d_axis, _conv1d_lastdim


def _halo_blur_local(block: jnp.ndarray, taps: jnp.ndarray, axis_name: str):
    """Blur a row-stripe with halo exchange along ``axis_name``.

    block: [H_local, W]. Neighbor stripes contribute r rows of halo on each
    side; ends replicate their own edge (VL_PAD_BY_CONTINUITY semantics).
    """
    r = (taps.shape[0] - 1) // 2
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)

    # rows along W first (no communication)
    out = _conv1d_lastdim(block, taps)

    # halo exchange for the H pass: send top r rows up, bottom r rows down
    top = out[:r]
    bot = out[-r:]
    from_above = jax.lax.ppermute(bot, axis_name,
                                  [(i, (i + 1) % n) for i in range(n)])
    from_below = jax.lax.ppermute(top, axis_name,
                                  [(i, (i - 1) % n) for i in range(n)])
    # edge stripes replicate their own border rows instead of the wrapped halo
    edge_top = jnp.repeat(out[:1], r, axis=0)
    edge_bot = jnp.repeat(out[-1:], r, axis=0)
    above = jnp.where(idx == 0, edge_top, from_above)
    below = jnp.where(idx == n - 1, edge_bot, from_below)

    ext = jnp.concatenate([above, out, below], axis=0)      # [H_local+2r, W]
    col = _conv1d_axis(ext, taps, 0)                         # blur along H
    return col[r:-r]


@partial(jax.jit, static_argnames=("sigma", "axis_name", "mesh"))
def _sharded_blur_impl(img, sigma: float, mesh: Mesh, axis_name: str):
    taps = jnp.asarray(gauss_taps(sigma))
    fn = jax.shard_map(
        lambda b: _halo_blur_local(b, taps, axis_name),
        mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=P(axis_name, None),
    )
    return fn(img)


def sharded_gaussian_blur(img: jnp.ndarray, sigma: float, mesh: Mesh,
                          axis_name: str = "sp") -> jnp.ndarray:
    """Gaussian blur of [H, W] with rows sharded over ``axis_name``.

    H must be divisible by the axis size and each stripe must be >= the
    filter radius. Produces the same result as ops.gaussian.gaussian_blur.
    """
    n = mesh.shape[axis_name]
    r = (gauss_taps(sigma).shape[0] - 1) // 2
    if img.shape[0] % n != 0 or img.shape[0] // n < r:
        raise ValueError(
            f"H={img.shape[0]} not shardable over {n} devices with radius {r}")
    sharding = NamedSharding(mesh, P(axis_name, None))
    img = jax.device_put(img, sharding)
    return _sharded_blur_impl(img, sigma, mesh, axis_name)
