"""Mesh construction for the decode pipeline.

Axes:
  data  — independent work batches (transform-block buckets, frames/GOPs)
  space — spatial frame shards (tile columns); neighbours exchange
          loop-filter halos with ppermute.  The cards of one host are
          joined all to all, so the mesh follows the algorithm only.
"""
import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices=None, data=None):
    """Factor n_devices into (data, space). Defaults: data = largest
    power-of-2 divisor <= sqrt(n), space = rest."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if data is None:
        data = 1
        while data * 2 <= int(np.sqrt(n)) and n % (data * 2) == 0:
            data *= 2
    space = n // data
    return Mesh(np.asarray(devs).reshape(data, space), ("data", "space"))
