"""XLA CDEF filter == the NumPy oracle, elementwise exact.

ops/kernels/cdef._filter_plane is the decoder's only CDEF filter (it
runs inside the fused postfilter); ops/spec/cdef_vec._filter_plane is
its NumPy twin, itself checked against the scalar spec model and
libaom by the stream batteries.
"""
import numpy as np
import pytest


@pytest.mark.parametrize("shape", [(64, 64), (40, 72), (24, 128)])
def test_xla_filter_matches_numpy_oracle(shape):
    import jax.numpy as jnp

    from av1dec_tpu.ops.kernels import cdef as C
    from av1dec_tpu.ops.spec import cdef_vec

    rng = np.random.default_rng(7)
    H, W = shape
    bd = 8
    plane = rng.integers(0, 256, (H, W)).astype(np.int32)
    uH, uW = (H + 7) // 8, (W + 7) // 8

    def expand(u):
        return np.repeat(np.repeat(u, 8, 0), 8, 1)[:H, :W].astype(np.int32)

    pri_u = rng.integers(0, 16, (uH, uW))
    sec_u = rng.choice([0, 1, 2, 4], (uH, uW))
    dir_u = rng.integers(0, 8, (uH, uW))
    damping = 5

    def shift_for(s, d):
        return np.maximum(0, d - np.int64(np.floor(np.log2(
            np.maximum(s, 1)))))

    pri = expand(pri_u)
    sec = expand(sec_u)
    dirs = expand(dir_u)
    psh = expand(shift_for(pri_u, damping))
    ssh = expand(shift_for(sec_u, damping))
    app = ((pri > 0) | (sec > 0)).astype(np.int32)

    ref = cdef_vec._filter_plane(plane, pri, sec, dirs, psh, ssh, bd, 0,
                                 app != 0)
    got = np.asarray(C._filter_plane(
        jnp.asarray(plane), jnp.asarray(pri), jnp.asarray(sec),
        jnp.asarray(dirs), jnp.asarray(psh), jnp.asarray(ssh),
        jnp.asarray(app), 0))
    assert (np.asarray(ref) == got).all(), np.argwhere(ref != got)[:5]
