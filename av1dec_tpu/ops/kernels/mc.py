"""Device motion compensation — batched translational MC lanes.
[SPEC §7.11.3.4]

Batched restructuring of ops.spec.inter.block_inter_pred for the
UNSCALED-reference case (x_scale == y_scale == 1<<14, the overwhelming
majority of inter prediction; scaled refs fall back to the host path):

- every prediction unit (block plane region, or sub-8x8 chroma piece)
  is a LANE with per-lane data: destination window, reference-buffer
  base/stride/clamp, integer tap origin, and the 8-tap filter row
  (bank*16 + subpel fraction) per axis — all precomputed on host from
  the plan grids (pipeline/device_inter.py);
- lanes are bucketed by (tile size T, compound?) with power-of-two
  capacities (monotonic per geometry, like the wavefront buckets) so
  the jit key is stable across frames;
- per bucket: one [N, T+7, T+7] window gather from the packed
  reference buffer, horizontal then vertical 8-tap passes as 8 static
  shifted slices x per-lane taps (elementwise), spec rounding r0/r1;
- compound lanes carry BOTH lists and blend in-lane with per-lane
  weights/shift (average and distance-weighted compound share one
  w0*p0 + w1*p1 >> shift form [SPEC §7.11.3.15]);
- one per-pixel scatter (.at[].set, masked pixels dropped) into the
  flat frame buffer.

All int32; bit-exact vs the host spec model (tests/test_device_inter.py
locks DeviceRecon output == FrameRecon == libaom oracle on inter
streams).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from av1dec_tpu.ops import inter_tables as T_

# lane schedule fields (host packs [N, len(MC_FIELDS)] int32 rows)
MC_FIELDS = [
    "x", "y", "base", "stride", "w", "h",
    "rb0", "rs0", "lx0", "ly0", "cx0", "cy0", "hf0", "vf0",
    "rb1", "rs1", "lx1", "ly1", "cx1", "cy1", "hf1", "vf1",
    "w0", "w1", "bshift",
]
_MF = {name: i for i, name in enumerate(MC_FIELDS)}

# all six filter banks as one [6*16, 8] table; lane hf/vf index rows
_FTAB = np.asarray(T_.SUBPEL_FILTERS, np.int32).reshape(-1, 8)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def _mc_list(ref_flat, sv, which, T, r0):
    """Vertical-tap sums (unshifted) for one reference list: [N, T, T].
    Window gather + separable 8-tap with spec horizontal rounding."""
    s = "01"[which]
    rb = sv["rb" + s]
    rs = sv["rs" + s]
    lx = sv["lx" + s]
    ly = sv["ly" + s]
    cx = sv["cx" + s]
    cy = sv["cy" + s]
    fh = jnp.asarray(_FTAB)[sv["hf" + s]]      # [N, 8]
    fv = jnp.asarray(_FTAB)[sv["vf" + s]]
    W = T + 7
    ri = jnp.arange(W, dtype=jnp.int32)
    rows = jnp.clip(cy[:, None] + ri, 0, ly[:, None])          # [N, W]
    cols = jnp.clip(cx[:, None] + ri, 0, lx[:, None])          # [N, W]
    idx = (rb[:, None, None] + rows[:, :, None] * rs[:, None, None] +
           cols[:, None, :])
    src = ref_flat[jnp.clip(idx, 0, ref_flat.shape[0] - 1)] \
        .astype(jnp.int32)                                     # [N, W, W]
    acc = jnp.zeros(src[:, :, :T].shape, jnp.int32)
    for k in range(8):
        acc = acc + src[:, :, k:k + T] * fh[:, k][:, None, None]
    interm = _round2(acc, r0)                                  # [N, W, T]
    acc2 = jnp.zeros(interm[:, :T, :].shape, jnp.int32)
    for k in range(8):
        acc2 = acc2 + interm[:, k:k + T, :] * fv[:, k][:, None, None]
    return acc2                                # unshifted vertical sums


def _mc_bucket(frame, ref_flat, rows, T, comp, bd):
    """Predict + scatter all lanes of one (T, comp) bucket."""
    sv = {f: rows[:, k] for f, k in _MF.items()}
    r0 = 5 if bd == 12 else 3
    r1s = 9 if bd == 12 else 11                # single-list round
    hi = (1 << bd) - 1
    v0 = _mc_list(ref_flat, sv, 0, T, r0)
    if comp:
        v1 = _mc_list(ref_flat, sv, 1, T, r0)
        p0 = _round2(v0, 7)                    # compound r1 = 7
        p1 = _round2(v1, 7)
        s = sv["w0"][:, None, None] * p0 + sv["w1"][:, None, None] * p1
        sh = sv["bshift"][:, None, None]
        out = jnp.clip((s + (1 << (sh - 1))) >> sh, 0, hi)
    else:
        out = jnp.clip(_round2(v0, r1s), 0, hi)
    ii = jnp.arange(T, dtype=jnp.int32)[None, :, None]
    jj = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    pixmask = (ii < sv["h"][:, None, None]) & (jj < sv["w"][:, None, None])
    fidx = (sv["base"][:, None, None] +
            (sv["y"][:, None, None] + ii) * sv["stride"][:, None, None] +
            sv["x"][:, None, None] + jj)
    fidx = jnp.where(pixmask, fidx, frame.shape[0])
    return frame.at[fidx.reshape(-1)].set(out.reshape(-1), mode="drop")


@functools.partial(jax.jit, static_argnames=("config",),
                   donate_argnames=("frame0",))
def run_mc(frame0, ref_flat, lanes, config):
    """All MC lanes of one frame into the flat frame buffer.

    frame0: flat int32 [flat_len + pad] (donated); ref_flat: packed
    reference planes (narrow dtype, cast after gather); lanes:
    {(T, comp): [Ncap, F] int32} (padded lanes carry w = h = 0 so they
    scatter nothing); config: (((T, comp, Ncap), ...), bd)."""
    buckets, bd = config
    frame = frame0
    for (T, comp, _n) in buckets:
        frame = _mc_bucket(frame, ref_flat, lanes[(T, comp)], T, comp, bd)
    return frame
