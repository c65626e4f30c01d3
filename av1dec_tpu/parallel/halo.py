"""Halo exchange for spatially-sharded frame filtering.

Loop-filter stages read a bounded neighbourhood (deblock ±7 px across an
edge, CDEF ±2, Wiener/SGR ±3).  When a frame plane is sharded by columns
over the `space` mesh axis, each shard needs `halo` columns from its
neighbours; `ppermute` moves them between devices.
"""
import jax
import jax.numpy as jnp
from jax import lax


def exchange_halo_cols(block, halo, axis_name="space"):
    """block: [H, W_shard] local shard. Returns [H, W_shard + 2*halo]
    with neighbour columns attached (edge-replicated at mesh ends).
    Call inside shard_map over `axis_name`."""
    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    right_edge = block[:, -halo:]
    left_edge = block[:, :halo]
    # send my right edge to my right neighbour (it becomes their left halo)
    from_left = lax.ppermute(
        right_edge, axis_name, [(i, (i + 1) % n) for i in range(n)])
    from_right = lax.ppermute(
        left_edge, axis_name, [(i, (i - 1) % n) for i in range(n)])
    # replicate own edges at the frame boundary shards
    from_left = jnp.where(idx == 0, jnp.repeat(
        block[:, :1], halo, axis=1), from_left)
    from_right = jnp.where(idx == n - 1, jnp.repeat(
        block[:, -1:], halo, axis=1), from_right)
    return jnp.concatenate([from_left, block, from_right], axis=1)


def exchange_halo_cols_fill(block, halo, fill, axis_name="space"):
    """Like exchange_halo_cols but the frame-boundary shards receive a
    constant `fill` in their outer halo (CDEF's out-of-frame sentinel
    CDEF_VERY_LARGE) instead of replicated edge pixels."""
    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    from_left = lax.ppermute(
        block[:, -halo:], axis_name, [(i, (i + 1) % n) for i in range(n)])
    from_right = lax.ppermute(
        block[:, :halo], axis_name, [(i, (i - 1) % n) for i in range(n)])
    from_left = jnp.where(idx == 0, fill, from_left)
    from_right = jnp.where(idx == n - 1, fill, from_right)
    return jnp.concatenate([from_left, block, from_right], axis=1)
