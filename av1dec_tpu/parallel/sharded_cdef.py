"""Column-sharded CDEF over a device mesh. [SPEC §7.15, SURVEY §2.4]

The whole-frame CDEF formulation (ops/kernels/cdef.py) reads a bounded
+-2px neighbourhood, so a frame plane column-sharded over the `space`
mesh axis only needs 2 halo columns from each neighbour, moved with
`ppermute` (parallel/halo.py).  Direction search and the per-unit
strength maps are local to each shard (8x8-unit-aligned shards).

Bit-exactness vs the single-device path is asserted by
tests/test_sharded.py and __graft_entry__.dryrun_multichip on real
decoded frames: sharded == unsharded, byte-identical.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from av1dec_tpu.ops.kernels import cdef as C
from av1dec_tpu.ops.spec.cdef import CDEF_VERY_LARGE
from av1dec_tpu.parallel.halo import exchange_halo_cols_fill


def _mk_pad(plane):
    """Bordered [H+4, W+4] copy of a shard: left/right halo columns from
    the mesh neighbours (CDEF_VERY_LARGE at frame edges), VERY_LARGE top
    and bottom rows (row sharding not used)."""
    H = plane.shape[0]
    ext = exchange_halo_cols_fill(plane.astype(jnp.int32), 2,
                                  CDEF_VERY_LARGE)
    top = jnp.full((2, ext.shape[1]), CDEF_VERY_LARGE, jnp.int32)
    return jnp.concatenate([top, ext, top], axis=0)


def cdef_sharded(planes, gates, bd, mesh):
    """CDEF with plane columns sharded over the mesh's `space` axis.

    planes: tuple of [H, W] int32 arrays; every W must be divisible by
    8 * n_space and aligned with the 8x8-unit grid (uC * (8 >> subx)
    == W).  gates: compute_gates() output.  Returns filtered planes
    (fully replicated layout, identical bytes to _cdef_all)."""
    y_pri, y_sec, uv_pri, uv_sec, damping, subx, suby = gates
    n_planes = len(planes)

    def shard_fn(*args):
        pls = args[:n_planes]
        yp, ys, up, us = args[n_planes:]
        return C._cdef_core(pls, yp, ys, up, us, bd, damping,
                            subx, suby, mk_pad=_mk_pad)

    col = P(None, "space")
    in_specs = tuple([col] * n_planes + [col] * 4)
    out_specs = tuple([col] * n_planes)
    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs)
    args = tuple(jnp.asarray(p, jnp.int32) for p in planes) + (
        jnp.asarray(y_pri), jnp.asarray(y_sec),
        jnp.asarray(uv_pri), jnp.asarray(uv_sec))
    sharding = NamedSharding(mesh, col)
    args = tuple(jax.device_put(a, sharding) for a in args)
    return jax.jit(fn)(*args)
