"""Device CDEF — whole-frame jitted formulation. [SPEC §7.15]

Whole-frame restructuring of ops.spec.cdef_vec (the NumPy oracle):

- direction search: one [B,64]x[64,120] int32 product with a one-hot
  projection matrix (all 8 projection axes at once);
- filtering: the 12 tap gathers use per-pixel offsets that take only 8
  values (one per direction), so each gather is a select over 8
  STATICALLY-shifted copies of the padded plane.  No dynamic gathers:
  shifts are static slices, selection is elementwise, so XLA fuses the
  filter into a few elementwise loop passes;
- the entire frame (direction search + variance gating + all three
  plane filters) is one jitted program; the decoder runs it inside
  the fused postfilter dispatch (pipeline/device_recon.py).

All int32; bit-exact vs the scalar spec model (tests/test_bitexact
battery covers CDEF streams in both modes).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from av1dec_tpu.ops.spec.cdef import CDEF_VERY_LARGE, DIRECTIONS, DIV_TABLE

# one-hot projection matrix, all 8 axes side by side: [64, 8*15]
_PROJ = np.zeros((8, 64, 15), np.int32)
for _i in range(8):
    for _j in range(8):
        for _d, _idx in enumerate([
                _i + _j, _i + (_j >> 1), _i, 3 + _i - (_j >> 1),
                7 + _i - _j, 3 - (_i >> 1) + _j, _j, (_i >> 1) + _j]):
            _PROJ[_d, _i * 8 + _j, _idx] = 1
_PROJ_FLAT = jnp.asarray(_PROJ.transpose(1, 0, 2).reshape(64, 120))

_DIR_DY = np.array([[d[k][0] for k in range(2)] for d in DIRECTIONS])
_DIR_DX = np.array([[d[k][1] for k in range(2)] for d in DIRECTIONS])
_DIV = jnp.asarray(np.asarray(DIV_TABLE, np.int64).astype(np.int32))
# 4:2:2 chroma direction remap [SPEC §7.15.3]
_UV_DIR_422 = jnp.asarray(np.array([7, 0, 2, 4, 5, 6, 6, 6], np.int32))


def _directions(luma, bd):
    """luma [H,W] int32 (H,W multiples of 8) -> (dir, var) [H/8, W/8]."""
    H, W = luma.shape
    x = (luma.astype(jnp.int32) >> (bd - 8)) - 128
    blocks = x.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 64)
    partial = jax.lax.dot(blocks, _PROJ_FLAT,
                          preferred_element_type=jnp.int32) \
        .reshape(-1, 8, 15)
    # int32 is safe: cost <= sum_k div[k]*p_k^2 <= 840*128^2*64 < 2^30
    p2 = partial ** 2
    cost = jnp.zeros((blocks.shape[0], 8), jnp.int32)
    cost = cost.at[:, 2].set(105 * p2[:, 2, :8].sum(1))
    cost = cost.at[:, 6].set(105 * p2[:, 6, :8].sum(1))
    for d in (0, 4):
        cost = cost.at[:, d].set(
            (p2[:, d, :7] + p2[:, d, 14:7:-1]) @ _DIV[:7]
            + p2[:, d, 7] * 105)
    for d in (1, 3, 5, 7):
        cost = cost.at[:, d].set(
            105 * p2[:, d, 3:8].sum(1)
            + (p2[:, d, :3] + p2[:, d, 10:7:-1]) @
            _DIV[jnp.array([1, 3, 5])])
    best = cost.argmax(1).astype(jnp.int32)
    b = jnp.arange(best.shape[0])
    var = (cost[b, best] - cost[b, (best + 4) & 7]) >> 10
    return (best.reshape(H // 8, W // 8),
            var.reshape(H // 8, W // 8).astype(jnp.int32))


def _ilog2(v):
    """floor(log2(max(v,1))) for 0 <= v < 2^13, exactly, in int32."""
    out = jnp.zeros_like(v)
    for k in range(1, 13):
        out = out + (v >= (1 << k)).astype(jnp.int32)
    return out


def _constrain(diff, strength, shift):
    ad = jnp.abs(diff)
    return jnp.sign(diff) * jnp.minimum(
        ad, jnp.maximum(0, strength - (ad >> shift)))


def _filter_plane(plane_arr, pri_px, sec_px, dir_px, pri_shift, sec_shift,
                  apply_px, coeff_shift, pad=None):
    """One plane, whole-frame.  All *_px are [H,W] int32.  `pad` may be
    a prebuilt [H+4, W+4] bordered copy (the column-sharded path builds
    it with neighbour halo columns instead of CDEF_VERY_LARGE)."""
    H, W = plane_arr.shape
    if pad is None:
        pad = jnp.full((H + 4, W + 4), CDEF_VERY_LARGE, jnp.int32)
        pad = pad.at[2:H + 2, 2:W + 2].set(plane_arr.astype(jnp.int32))
    x = plane_arr.astype(jnp.int32)
    total = jnp.zeros((H, W), jnp.int32)
    mx = x
    mn = x
    pri_tap0 = jnp.where(((pri_px >> coeff_shift) & 1) == 0, 4, 3)
    pri_tap1 = jnp.where(((pri_px >> coeff_shift) & 1) == 0, 2, 3)
    sec_taps = (2, 1)

    def gather(rot, k, sgn):
        """Select among the 8 direction-shifted images, elementwise."""
        out = jnp.zeros((H, W), jnp.int32)
        for d in range(8):
            dd = (d + rot) & 7
            sh = jax.lax.dynamic_slice(
                pad, (2 + sgn * int(_DIR_DY[dd, k]),
                      2 + sgn * int(_DIR_DX[dd, k])), (H, W))
            out = jnp.where(dir_px == d, sh, out)
        return out

    for k in range(2):
        tap_p = pri_tap0 if k == 0 else pri_tap1
        for sgn in (1, -1):
            p = gather(0, k, sgn)
            valid = (p != CDEF_VERY_LARGE) & (pri_px > 0)
            total = total + jnp.where(
                valid, tap_p * _constrain(p - x, pri_px, pri_shift), 0)
            mx = jnp.where(valid, jnp.maximum(mx, p), mx)
            mn = jnp.where(valid, jnp.minimum(mn, p), mn)
        for rot in (2, 6):
            for sgn in (1, -1):
                p = gather(rot, k, sgn)
                valid = (p != CDEF_VERY_LARGE) & (sec_px > 0)
                total = total + jnp.where(
                    valid,
                    sec_taps[k] * _constrain(p - x, sec_px, sec_shift), 0)
                mx = jnp.where(valid, jnp.maximum(mx, p), mx)
                mn = jnp.where(valid, jnp.minimum(mn, p), mn)
    y = x + ((8 + total - (total < 0).astype(jnp.int32)) >> 4)
    y = jnp.clip(y, mn, mx)
    return jnp.where(apply_px, y, plane_arr.astype(jnp.int32))


def _cdef_core(planes, y_pri_u, y_sec_u, uv_pri_u, uv_sec_u,
               bd, damping_y, subx, suby, mk_pad=None):
    """CDEF on device.  `planes`: tuple of [H,W] int32 plane arrays;
    *_u: per-8x8-luma-unit strengths (already gated by `active`, <=0
    where inactive).  `mk_pad(plane)` optionally supplies the bordered
    [H+4, W+4] copy (the column-sharded path exchanges halos there).
    Returns the filtered planes (same shapes)."""
    coeff_shift = bd - 8
    luma = planes[0]
    dirs, var = _directions(luma, bd)
    active_pri = y_pri_u > 0

    # luma primary strength: variance adjustment [SPEC §7.15.1]
    v6 = var >> 6
    i_adj = jnp.minimum(12, _ilog2(v6))
    pri_adj = jnp.where(var != 0, (y_pri_u * (4 + i_adj) + 8) >> 4, 0)
    pri_adj = jnp.where(active_pri, pri_adj, 0)

    def shift_for(strength, damp):
        return jnp.maximum(0, damp - _ilog2(jnp.maximum(strength, 1)))

    def expand(u, ry, rx, H, W):
        return jnp.repeat(jnp.repeat(u, ry, axis=0), rx, axis=1)[:H, :W]

    H, W = luma.shape
    apply_y = (pri_adj > 0) | (y_sec_u > 0)
    out = [_filter_plane(
        luma,
        expand(pri_adj, 8, 8, H, W),
        expand(y_sec_u, 8, 8, H, W),
        expand(jnp.where(active_pri, dirs, 0), 8, 8, H, W),
        expand(shift_for(pri_adj, damping_y), 8, 8, H, W),
        expand(shift_for(y_sec_u, damping_y), 8, 8, H, W),
        expand(apply_y, 8, 8, H, W), coeff_shift,
        pad=mk_pad(luma) if mk_pad else None)]

    if len(planes) > 1:
        uvdir = jnp.where(uv_pri_u > 0, dirs, 0)
        if subx != suby and subx:
            uvdir = jnp.where(uv_pri_u > 0, _UV_DIR_422[uvdir], 0)
        Hc, Wc = planes[1].shape
        ry, rx = 8 >> suby, 8 >> subx
        apply_uv = (uv_pri_u > 0) | (uv_sec_u > 0)
        args = (expand(uv_pri_u, ry, rx, Hc, Wc),
                expand(uv_sec_u, ry, rx, Hc, Wc),
                expand(uvdir, ry, rx, Hc, Wc),
                expand(shift_for(uv_pri_u, damping_y - 1), ry, rx, Hc, Wc),
                expand(shift_for(uv_sec_u, damping_y - 1), ry, rx, Hc, Wc),
                expand(apply_uv, ry, rx, Hc, Wc))
        for pl in (1, 2):
            out.append(_filter_plane(
                planes[pl], *args, coeff_shift,
                pad=mk_pad(planes[pl]) if mk_pad else None))
    return tuple(out)


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _cdef_all(planes, y_pri_u, y_sec_u, uv_pri_u, uv_sec_u,
              bd, damping_y, subx, suby):
    """Single-device whole-frame CDEF (jitted _cdef_core)."""
    return _cdef_core(planes, y_pri_u, y_sec_u, uv_pri_u, uv_sec_u,
                      bd, damping_y, subx, suby)


def compute_gates(seq, hdr, plans, n_planes, bd):
    """Host-side per-8x8-unit CDEF strength gating (mi-grid
    bookkeeping).  Returns (y_pri, y_sec, uv_pri, uv_sec, damping,
    subx, suby) host int32 arrays, or None when CDEF is disabled for
    this frame. [SPEC §7.15.1]"""
    c = hdr.get("cdef")
    if not c or hdr.get("coded_lossless") or hdr.get("allow_intrabc"):
        return None
    nstr = 1 << c["bits"]
    if all(c["y_pri"][i] == 0 and c["y_sec"][i] == 0 and
           c["uv_pri"][i] == 0 and c["uv_sec"][i] == 0
           for i in range(nstr)):
        return None
    coeff_shift = bd - 8
    mi_rows, mi_cols = plans.mi_rows, plans.mi_cols
    skip = plans.grid("skip").astype(np.int64)
    cdef_mi = plans.grid("cdef").astype(np.int64)
    subx = seq.get("subsampling_x", 1) if n_planes > 1 else 0
    suby = seq.get("subsampling_y", 1) if n_planes > 1 else 0

    uR, uC = (mi_rows + 1) // 2, (mi_cols + 1) // 2
    r1 = np.minimum(np.arange(uR) * 2 + 1, mi_rows - 1)
    c1 = np.minimum(np.arange(uC) * 2 + 1, mi_cols - 1)
    r0 = np.arange(uR) * 2
    c0 = np.arange(uC) * 2
    unit_skip = skip[np.ix_(r0, c0)] & skip[np.ix_(r0, c1)] & \
        skip[np.ix_(r1, c0)] & skip[np.ix_(r1, c1)]
    idx = cdef_mi[np.ix_(r0, c0)]
    active = (unit_skip == 0) & (idx >= 0)
    idxc = np.clip(idx, 0, nstr - 1)

    def gate(tbl):
        u = np.asarray(tbl, np.int32)[idxc] << coeff_shift
        return np.where(active, u, 0).astype(np.int32)

    return (gate(c["y_pri"]), gate(c["y_sec"]), gate(c["uv_pri"]),
            gate(c["uv_sec"]), c["damping"] + coeff_shift, subx, suby)


def cdef_frame(planes, seq, hdr, plans, bd):
    """Drop-in device replacement for ops.spec.cdef_vec.cdef_frame.

    Host computes only the tiny per-8x8-unit strength gating; everything
    per-pixel runs in ONE jitted dispatch.
    """
    gates = compute_gates(seq, hdr, plans, len(planes), bd)
    if gates is None:
        return planes
    y_pri_u, y_sec_u, uv_pri_u, uv_sec_u, damping, subx, suby = gates
    dev_planes = tuple(
        jnp.asarray(np.ascontiguousarray(p, np.int32)) for p in planes)
    outs = _cdef_all(dev_planes, jnp.asarray(y_pri_u),
                     jnp.asarray(y_sec_u), jnp.asarray(uv_pri_u),
                     jnp.asarray(uv_sec_u), bd, damping, subx, suby)
    fetched = jax.device_get(outs)
    for pl, out in enumerate(fetched):
        planes[pl][...] = out
    return planes
