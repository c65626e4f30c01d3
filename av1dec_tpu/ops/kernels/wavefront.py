"""Device wavefront intra reconstruction — one jitted scan per frame.

jnp mirror of `pipeline.wavefront`'s NumPy executor [SPEC §7.11.2,
SURVEY §7.1]: the host builds a level schedule with all control flow
precomputed as per-block int scalars; the device executes the whole
frame as ONE `lax.scan` over wavefront levels (no host round trips).

Design (round 4; fixes the per-frame recompile + per-step compute
pathologies of the per-(w,h)-class executor):

* Blocks are grouped into fixed shape buckets T in {16, 32, 64} by
  max(w, h); block dims (w, h, log2 w, log2 h) travel as per-lane
  DATA, not as static shapes.  Levels are split into fixed-lane-cap
  WINDOWS (make_windows), lockstep across buckets, and the scan runs
  in fixed CHUNK-step slices — so the jit key is (window caps, packed
  row caps, bit depth, subsampling, edge-filter enable): stable across
  the frames of a stream AND small enough to compile once (the
  persistent compilation cache then makes it free across runs).
* Each scan step applies each bucket under `lax.cond(count > 0, ...)`;
  empty windows and the rare expensive families (directional with its
  LUT machinery, filter-intra's serial patch recursion, palette, CfL)
  are skipped at RUNTIME, not traced away — so windows that only carry
  cheap DC/V/H lanes cost microseconds instead of the full predictor.
* Residuals arrive as ONE packed pixel buffer (int16 for 8-bit) with
  per-lane pixel offsets; multi-frame batches (run_device_batch) share
  one scan with per-frame base offsets.

All int32 (AV1 decode is integer-exact); bit-exactness is enforced by
tests/test_wavefront.py against the NumPy executor, which in turn is
checked against the serial spec model and the libaom oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from av1dec_tpu.ops.spec import intra
from av1dec_tpu.ops.tables_data import FILTER_INTRA_TAPS, SM_WEIGHTS
from av1dec_tpu.pipeline.wavefront import (MF_DC, MF_DIR, MF_FI, MF_H,
                                           MF_INTER, MF_PAETH, MF_PAL,
                                           MF_SMOOTH, MF_SMOOTH_H,
                                           MF_SMOOTH_V, MF_V,
                                           _SCALAR_FIELDS)

# device packing appends the per-lane block geometry to the shared
# scalar schedule fields
_DEV_FIELDS = list(_SCALAR_FIELDS) + ["w", "h", "lw", "lh", "lbase"]
_F = {name: i for i, name in enumerate(_DEV_FIELDS)}
_KERN = np.concatenate([np.zeros((1, 5), np.int64),
                        np.asarray(intra.INTRA_EDGE_KERNELS)],
                       axis=0).astype(np.int32)
_SM = np.asarray(SM_WEIGHTS, np.int32)


def _gather_edges(frame, sv, T, bd):
    """AboveRow/LeftCol for B lanes; static edge extent 2T (per-lane
    limits clamp the reads, extra lanes/pixels are masked later)."""
    size = 2 * T
    x, y = sv["x"], sv["y"]
    base, stride = sv["base"], sv["stride"]
    i = jnp.arange(size, dtype=jnp.int32)
    cols = jnp.minimum(x[:, None] + i[None, :], sv["above_lim"][:, None])
    idx_a = base[:, None] + (y[:, None] - 1) * stride[:, None] + cols
    idx_rep_a = base + y * stride + (x - 1)
    idx_a = jnp.where((sv["above_case"] == 1)[:, None],
                      idx_rep_a[:, None], idx_a)
    above_v = frame[jnp.maximum(idx_a, 0)]
    above_v = jnp.where((sv["above_case"] == 2)[:, None],
                        (1 << (bd - 1)) - 1, above_v)
    rows = jnp.minimum(y[:, None] + i[None, :], sv["left_lim"][:, None])
    idx_l = base[:, None] + rows * stride[:, None] + (x - 1)[:, None]
    idx_rep_l = base + (y - 1) * stride + x
    idx_l = jnp.where((sv["left_case"] == 1)[:, None],
                      idx_rep_l[:, None], idx_l)
    left_v = frame[jnp.maximum(idx_l, 0)]
    left_v = jnp.where((sv["left_case"] == 2)[:, None],
                       (1 << (bd - 1)) + 1, left_v)
    cc = sv["corner_case"]
    idx_c = jnp.where(cc == 0, base + (y - 1) * stride + (x - 1),
                      jnp.where(cc == 1, base + (y - 1) * stride + x,
                                base + y * stride + (x - 1)))
    corner = jnp.where(cc == 3, 1 << (bd - 1), frame[jnp.maximum(idx_c, 0)])
    above = jnp.concatenate([corner[:, None], above_v], axis=1)
    left = jnp.concatenate([corner[:, None], left_v], axis=1)
    return above, left


def _edge_filter(edge, npx, strength):
    B, n = edge.shape
    i = jnp.arange(n, dtype=jnp.int32)
    acc = jnp.zeros_like(edge)
    kv = jnp.asarray(_KERN)[jnp.clip(strength, 0, 3)]
    for j in range(5):
        k = jnp.clip(i[None, :] - 2 + j, 0,
                     jnp.maximum(npx, 1)[:, None] - 1)
        acc = acc + kv[:, j][:, None] * jnp.take_along_axis(edge, k, axis=1)
    sm = (acc + 8) >> 4
    upd = (strength > 0)[:, None] & (i[None, :] >= 1) & \
        (i[None, :] < npx[:, None])
    return jnp.where(upd, sm, edge)


def _upsample(edge, npx, bd):
    B, n = edge.shape
    size = n - 1
    i = jnp.arange(size + 3, dtype=jnp.int32)
    src = jnp.minimum(jnp.maximum(i[None, :] - 1, 0), npx[:, None])
    inb = jnp.take_along_axis(edge, src, axis=1)
    s = (-inb[:, :size] + 9 * inb[:, 1:size + 1] +
         9 * inb[:, 2:size + 2] - inb[:, 3:size + 3])
    s = jnp.clip((s + 8) >> 4, 0, (1 << bd) - 1)
    out = jnp.zeros((B, 2 * size + 2), jnp.int32)
    out = out.at[:, 0].set(inb[:, 0])
    ii = jnp.arange(size)
    out = out.at[:, 2 * ii + 1].set(s)
    out = out.at[:, 2 * ii + 2].set(inb[:, 2:size + 2])
    return out


def _dir_lut(edge, edge_up, up, npx_u):
    B, n = edge.shape
    size = n - 1
    lutlen = 2 * size + 3
    k = jnp.arange(lutlen, dtype=jnp.int32)
    idx_n = jnp.clip(k[None, :] - 1, 0, size)
    lut_n = jnp.take_along_axis(edge, jnp.broadcast_to(idx_n, (B, lutlen)),
                                axis=1)
    idx_u = jnp.minimum(k[None, :], 2 * size + 1)
    lut_u = jnp.take_along_axis(edge_up,
                                jnp.broadcast_to(idx_u, (B, lutlen)), axis=1)
    tail = jnp.take_along_axis(
        edge, jnp.minimum(size, npx_u + 1)[:, None], axis=1)
    lut_u = jnp.where(k[None, :] < (2 * npx_u + 2)[:, None], lut_u, tail)
    return jnp.where((up > 0)[:, None], lut_u, lut_n)


def _take3(lut, idx, B, T):
    """Gather [B, T, T] indices from per-lane LUT [B, n]."""
    return jnp.take_along_axis(lut, idx.reshape(B, -1),
                               axis=1).reshape(B, T, T)


def _predict_dir(above, left, sv, T, bd, enable_edge_filter):
    """Directional prediction; per-lane block dims (w, h) as data.
    Pixels beyond (h_l, w_l) compute garbage and are masked at the
    scatter. [SPEC §7.11.2.4]"""
    B = above.shape[0]
    w_l = sv["w"][:, None, None]
    h_l = sv["h"][:, None, None]
    size_l = w_l + h_l                      # per-lane w + h
    lutmax = 4 * T + 2                      # static lut upper index
    p_angle = sv["p_angle"]
    if enable_edge_filter:
        do_c = sv["corner_filt"] > 0
        cv = (left[:, 1] * 5 + above[:, 0] * 6 + above[:, 1] * 5 + 8) >> 4
        above = above.at[:, 0].set(jnp.where(do_c, cv, above[:, 0]))
        left = left.at[:, 0].set(jnp.where(do_c, cv, left[:, 0]))
        above = _edge_filter(above, sv["npx_above"], sv["str_above"])
        left = _edge_filter(left, sv["npx_left"], sv["str_left"])
    up_a, up_l = sv["up_above"], sv["up_left"]
    npx_a = sv["w"] + jnp.where(p_angle < 90, sv["h"], 0)
    npx_l = sv["h"] + jnp.where(p_angle > 180, sv["w"], 0)
    lutA = _dir_lut(above, _upsample(above, npx_a, bd), up_a, npx_a)
    lutL = _dir_lut(left, _upsample(left, npx_l, bd), up_l, npx_l)

    jj = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    ii = jnp.arange(T, dtype=jnp.int32)[None, :, None]
    dx = sv["dx"][:, None, None]
    dy = sv["dy"][:, None, None]
    ua = up_a[:, None, None]
    ul = up_l[:, None, None]
    pa = p_angle[:, None, None]

    idx1 = (ii + 1) * dx
    base1 = (idx1 >> (6 - ua)) + (jj << ua)
    max_base_x = (size_l - 1) << ua
    shift1 = ((idx1 << ua) >> 1) & 0x1F
    b1c = jnp.minimum(base1, max_base_x)
    v1 = _take3(lutA, b1c + 2, B, T) * (32 - shift1) + \
        _take3(lutA, jnp.minimum(b1c + 3, lutmax), B, T) * shift1
    mbx2 = jnp.minimum(max_base_x[:, 0, 0] + 2, lutmax)
    z1 = jnp.where(base1 < max_base_x, (v1 + 16) >> 5,
                   jnp.take_along_axis(
                       lutA, mbx2.reshape(B, 1), axis=1).reshape(B, 1, 1))

    idx2 = (jj << 6) - (ii + 1) * dx
    base2 = idx2 >> (6 - ua)
    shift2 = ((idx2 << ua) >> 1) & 0x1F
    b2c = jnp.clip(base2, -2, size_l * 2)
    va = _take3(lutA, b2c + 2, B, T) * (32 - shift2) + \
        _take3(lutA, jnp.minimum(b2c + 3, lutmax), B, T) * shift2
    idx2l = (ii << 6) - (jj + 1) * dy
    base2l = idx2l >> (6 - ul)
    shift2l = ((idx2l << ul) >> 1) & 0x1F
    b2lc = jnp.clip(base2l, -2, size_l * 2)
    vl = _take3(lutL, b2lc + 2, B, T) * (32 - shift2l) + \
        _take3(lutL, jnp.minimum(b2lc + 3, lutmax), B, T) * shift2l
    z2 = jnp.where(base2 >= -(1 << ua), (va + 16) >> 5, (vl + 16) >> 5)

    idx3 = (jj + 1) * dy
    base3 = (idx3 >> (6 - ul)) + (ii << ul)
    max_base_y = (size_l - 1) << ul
    shift3 = ((idx3 << ul) >> 1) & 0x1F
    b3c = jnp.minimum(base3, max_base_y)
    v3 = _take3(lutL, b3c + 2, B, T) * (32 - shift3) + \
        _take3(lutL, jnp.minimum(b3c + 3, lutmax), B, T) * shift3
    mby2 = jnp.minimum(max_base_y[:, 0, 0] + 2, lutmax)
    z3 = jnp.where(base3 < max_base_y, (v3 + 16) >> 5,
                   jnp.take_along_axis(
                       lutL, mby2.reshape(B, 1), axis=1).reshape(B, 1, 1))

    return jnp.where(pa < 90, z1, jnp.where(pa < 180, z2, z3))


def _predict_fi(above, left, sv, T, bd):
    """Filter-intra: serial 4x2 patch recursion [SPEC §7.11.2.3].
    Per-lane patch-grid dims; fori over patches in recursion order.
    Filter-intra blocks are <= 32x32 so T <= 32 here."""
    B = above.shape[0]
    w_l, h_l = sv["w"], sv["h"]
    lw = sv["lw"]
    taps = jnp.asarray(
        np.asarray(FILTER_INTRA_TAPS, np.int32)[:, :, :7])  # [5, 8, 7]
    tv = taps[jnp.clip(sv["fi_mode"], 0, 4)]                # [B, 8, 7]
    n_j = w_l >> 2
    n_patch = (h_l >> 1) * n_j
    W1 = w_l + 1
    buflen = (T + 1) * (T + 1)
    hi = (1 << bd) - 1
    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]

    # init: top row 0..w_l, left column rows 1..h_l (per-lane stride W1)
    buf = jnp.zeros((B, buflen + 1), jnp.int32)
    col = jnp.arange(T + 1, dtype=jnp.int32)[None, :]
    dst0 = jnp.where(col <= w_l[:, None], col, buflen)
    buf = buf.at[bidx, dst0].set(above[:, :T + 1], mode="drop")
    irow = jnp.arange(T, dtype=jnp.int32)[None, :]
    dstl = jnp.where(irow < h_l[:, None], (irow + 1) * W1[:, None], buflen)
    buf = buf.at[bidx, dstl].set(left[:, 1:T + 1], mode="drop")

    ok = jnp.arange(8, dtype=jnp.int32)[None, :]
    k5 = jnp.arange(5, dtype=jnp.int32)[None, :]

    def patch(p, buf):
        sj = p & (n_j - 1)
        si = p >> jnp.maximum(lw - 2, 0)
        i = 1 + 2 * si
        j = 1 + 4 * sj
        o = (i - 1) * W1 + (j - 1)
        g = jnp.concatenate([o[:, None] + k5, (o + W1)[:, None],
                             (o + 2 * W1)[:, None]], axis=1)      # [B, 7]
        g = jnp.clip(g, 0, buflen)   # invalid patches read garbage, masked
        pv = jnp.take_along_axis(buf, g, axis=1)                  # [B, 7]
        s = (tv * pv[:, None, :]).sum(-1)                         # [B, 8]
        v = jnp.where(s >= 0, (s + 8) >> 4, -((-s + 8) >> 4))
        v = jnp.clip(v, 0, hi)
        dst = (i * W1 + j)[:, None] + (ok & 3) + (ok >> 2) * W1[:, None]
        dst = jnp.where(p < n_patch[:, None], dst, buflen)
        return buf.at[bidx, dst].set(v, mode="drop")

    buf = jax.lax.fori_loop(0, (T // 2) * (T // 4), patch, buf)
    ii = jnp.arange(T, dtype=jnp.int32)[None, :, None]
    jj = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    gidx = (ii + 1) * W1[:, None, None] + (jj + 1)
    return jnp.take_along_axis(buf, gidx.reshape(B, -1),
                               axis=1).reshape(B, T, T)


def _smooth_all(above, left, sv, T):
    """All three smooth modes, per-lane dims. [SPEC §7.11.2.6]"""
    sm = jnp.asarray(_SM)
    w_l, h_l = sv["w"], sv["h"]
    jj = jnp.arange(T, dtype=jnp.int32)
    sw_w = sm[jnp.clip(w_l[:, None] + jj[None, :], 0, _SM.shape[0] - 1)]
    sw_h = sm[jnp.clip(h_l[:, None] + jj[None, :], 0, _SM.shape[0] - 1)]
    sw_w = sw_w[:, None, :]                                   # [B, 1, T]
    sw_h = sw_h[:, :, None]                                   # [B, T, 1]
    a = above[:, None, 1:1 + T]
    l = left[:, 1:1 + T, None]
    right = jnp.take_along_axis(above, w_l[:, None], axis=1)[:, :, None]
    bottom = jnp.take_along_axis(left, h_l[:, None], axis=1)[:, :, None]
    full = (sw_h * a + (256 - sw_h) * bottom +
            sw_w * l + (256 - sw_w) * right + 256) >> 9
    vert = (sw_h * a + (256 - sw_h) * bottom + 128) >> 8
    horz = (sw_w * l + (256 - sw_w) * right + 128) >> 8
    mf = sv["mode_family"][:, None, None]
    return jnp.where(mf == MF_SMOOTH, full,
                     jnp.where(mf == MF_SMOOTH_V, vert, horz))


def _paeth_b(above, left, T):
    B = above.shape[0]
    a = above[:, None, 1:1 + T]
    l = left[:, 1:1 + T, None]
    tl = above[:, 0][:, None, None]
    base = a + l - tl
    pa = jnp.abs(base - a)
    pl = jnp.abs(base - l)
    ptl = jnp.abs(base - tl)
    sh = (B, T, T)
    return jnp.where((pa <= pl) & (pa <= ptl), jnp.broadcast_to(a, sh),
                     jnp.where(pl <= ptl, jnp.broadcast_to(l, sh),
                               jnp.broadcast_to(tl, sh)))


def _cfl_adjust(frame, pred, sv, T, bd, sub_x, sub_y, pixmask):
    """CfL: subsample co-located luma, remove average, scale, add.
    [SPEC §7.11.5]"""
    B = pred.shape[0]
    lstride = sv["stride"] << sub_x
    lbase = sv["lbase"][:, None, None]  # luma plane base (batch offset)
    ii = jnp.arange(T, dtype=jnp.int32)[None, :, None]
    jj = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    ly = jnp.minimum((sv["y"][:, None, None] + ii) << sub_y,
                     sv["cfl_maxy"][:, None, None])
    lx = jnp.minimum((sv["x"][:, None, None] + jj) << sub_x,
                     sv["cfl_maxx"][:, None, None])
    b = jnp.maximum(lbase + ly * lstride[:, None, None] + lx, 0)
    if sub_x and sub_y:
        t = (frame[b] + frame[b + 1] + frame[b + lstride[:, None, None]] +
             frame[b + lstride[:, None, None] + 1]) << 1
    elif sub_x:
        t = (frame[b] + frame[b + 1]) << 2
    else:
        t = frame[b] << 3
    shift = sv["lw"] + sv["lh"]
    tot = jnp.where(pixmask, t, 0).reshape(B, -1).sum(1)
    avg = (tot + (1 << jnp.maximum(shift - 1, 0))) >> shift
    ac = t - avg[:, None, None]
    alpha = sv["cfl_alpha"][:, None, None]
    sc = alpha * ac
    scaled = jnp.where(sc >= 0, (sc + 32) >> 6, -((-sc + 32) >> 6))
    return jnp.clip(pred + scaled, 0, (1 << bd) - 1)


_ALL_FAMS = frozenset({"dir", "fi", "pal", "cfl"})


def _apply_bucket(frame, packed, start, count, res_flat, pal_t, *, T, bd,
                  Bmax, sub_x, sub_y, eef, fams=_ALL_FAMS):
    """One window of lanes: predict + residual + scatter, skipped
    entirely at runtime when the window is empty.  `res_flat` is the
    shared packed residual buffer (per-lane res_idx = pixel offset).
    `fams` statically gates the expensive families (ablation hook for
    perf experiments; the product always passes the full set)."""

    def body(frame):
        rows = jax.lax.dynamic_slice(packed, (start, 0),
                                     (Bmax, packed.shape[1]))
        sv = {f: rows[:, k] for f, k in _F.items()}
        lane = jnp.arange(Bmax, dtype=jnp.int32)
        valid = lane < count
        w_l, h_l = sv["w"], sv["h"]
        above, left = _gather_edges(frame, sv, T, bd)
        mf = sv["mode_family"]
        B = Bmax
        ii = jnp.arange(T, dtype=jnp.int32)[None, :, None]
        jj = jnp.arange(T, dtype=jnp.int32)[None, None, :]
        pixmask = (ii < h_l[:, None, None]) & (jj < w_l[:, None, None])

        fidx_raw = (sv["base"][:, None, None] +
                    (sv["y"][:, None, None] + ii) *
                    sv["stride"][:, None, None] +
                    sv["x"][:, None, None] + jj)

        # cheap families computed unconditionally, selected by mask
        out = _smooth_all(above, left, sv, T)
        out = jnp.where((mf == MF_V)[:, None, None],
                        jnp.broadcast_to(above[:, None, 1:1 + T],
                                         (B, T, T)), out)
        out = jnp.where((mf == MF_H)[:, None, None],
                        jnp.broadcast_to(left[:, 1:1 + T, None],
                                         (B, T, T)), out)
        out = jnp.where((mf == MF_PAETH)[:, None, None],
                        _paeth_b(above, left, T), out)
        # DC with per-lane masked sums
        jr = jnp.arange(T, dtype=jnp.int32)[None, :]
        s_a = jnp.where(jr < w_l[:, None], above[:, 1:1 + T], 0).sum(1)
        s_l = jnp.where(jr < h_l[:, None], left[:, 1:1 + T], 0).sum(1)
        size_l = w_l + h_l
        dc_case = sv["dc_case"]
        avg = jnp.where(
            dc_case == 0, (s_a + s_l + (size_l >> 1)) // size_l,
            jnp.where(dc_case == 1, (s_a + (w_l >> 1)) >> sv["lw"],
                      jnp.where(dc_case == 2,
                                (s_l + (h_l >> 1)) >> sv["lh"],
                                1 << (bd - 1))))
        dc = jnp.broadcast_to(avg[:, None, None], (B, T, T))
        if "cfl" in fams:
            has_cfl = valid & (sv["cfl_maxx"] > 0)
            dc = jax.lax.cond(
                has_cfl.any(),
                lambda d: jnp.where(has_cfl[:, None, None],
                                    _cfl_adjust(frame, d, sv, T, bd,
                                                sub_x, sub_y, pixmask), d),
                lambda d: d, dc)
        out = jnp.where((mf == MF_DC)[:, None, None], dc, out)

        # expensive / rare families behind runtime conds
        if "dir" in fams:
            m_dir = valid & (mf == MF_DIR)
            out = jax.lax.cond(
                m_dir.any(),
                lambda o: jnp.where(m_dir[:, None, None],
                                    _predict_dir(above, left, sv, T, bd,
                                                 eef),
                                    o),
                lambda o: o, out)
        if "pal" in fams:
            m_pal = valid & (mf == MF_PAL)
            out = jax.lax.cond(
                m_pal.any(),
                lambda o: jnp.where(m_pal[:, None, None],
                                    pal_t[jnp.maximum(sv["pal_idx"], 0)],
                                    o),
                lambda o: o, out)
        if "fi" in fams:  # filter-intra blocks are <= 32x32 (masked)
            m_fi = valid & (mf == MF_FI)
            out = jax.lax.cond(
                m_fi.any(),
                lambda o: jnp.where(m_fi[:, None, None],
                                    _predict_fi(above, left, sv, T, bd), o),
                lambda o: o, out)
        if "inter" in fams:
            # inter residual lane: the MC pass already wrote this
            # block's prediction into the frame — gather it back, the
            # shared residual-add below then clips and rewrites
            m_int = valid & (mf == MF_INTER)
            out = jax.lax.cond(
                m_int.any(),
                lambda o: jnp.where(
                    m_int[:, None, None],
                    frame[jnp.clip(fidx_raw, 0, frame.shape[0] - 1)], o),
                lambda o: o, out)

        # residual: per-lane pixel window of the packed flat buffer
        roff = sv["res_idx"]
        rpix = (roff[:, None, None] + ii * w_l[:, None, None] + jj)
        res = res_flat[jnp.clip(rpix, 0, res_flat.shape[0] - 1)] \
            .astype(jnp.int32)
        out = jnp.where((roff >= 0)[:, None, None],
                        jnp.clip(out + res, 0, (1 << bd) - 1), out)

        # scatter (masked pixels -> OOB index, dropped).  The
        # per-pixel form was chosen over windowed scatter variants on
        # an earlier accelerator; it is not yet measured on the GPU.
        # Multi-frame batching (run_device_batch) amortizes the
        # per-level step cost across frames.
        fidx = jnp.where(valid[:, None, None] & pixmask, fidx_raw,
                         frame.shape[0])
        return frame.at[fidx.reshape(-1)].set(out.reshape(-1), mode="drop")

    return jax.lax.cond(count > 0, body, lambda f: f, frame)


CHUNK = 128  # scan levels per jitted dispatch (fixed: not a jit key dim)


@functools.partial(jax.jit, static_argnames=("config",),
                   donate_argnames=("frame0",))
def run_wavefront_chunk(frame0, packed, starts, counts, res_flat,
                        pal_tensors, config):
    """One CHUNK-step slice of the wavefront window scan.

    frame0: flat int32 [flat_len + pad]; packed: {T: [Ncap, F] int32};
    starts/counts: [CHUNK, n_buckets] int32 WINDOWS (each level split
    into <= Bmax-lane windows, lockstep across buckets so no window of
    level L runs before every window of level < L); res_flat: packed
    residual pixels (int16 for 8-bit); pal_tensors: {T: [P, T, T]}.
    config: (((T, Bmax), ...), bd, sub_x, sub_y, eef[, has_inter]) —
    capacities quantized so the key is stable across the frames of a
    stream; the step count lives OUTSIDE the key (the host loops
    chunks).  The optional 6th element enables MF_INTER lanes (mixed
    frames); its absence keeps the all-intra jit key unchanged."""
    (buckets, bd, sub_x, sub_y, eef, *rest) = config
    fams = _ALL_FAMS | {"inter"} if (rest and rest[0]) else _ALL_FAMS

    def step(frame, sc):
        st, cn = sc
        for bi, (T, Bmax) in enumerate(buckets):
            frame = _apply_bucket(
                frame, packed[T], st[bi], cn[bi],
                res_flat, pal_tensors[T],
                T=T, bd=bd, Bmax=Bmax, sub_x=sub_x, sub_y=sub_y, eef=eef,
                fams=fams)
        return frame, ()

    frame, _ = jax.lax.scan(step, frame0, (starts, counts), length=CHUNK)
    return frame


def make_windows(starts_by_t, counts_by_t, bcaps, ts):
    """Split per-level lane runs into <= Bcap-lane windows, lockstep
    across buckets: level l contributes max_b(ceil(c_bl / Bcap_b)) steps
    and every bucket pads that level to the same step count, so no
    window of a later level ever precedes one of an earlier level.
    Returns (win_starts [S, nb], win_counts [S, nb]) int32."""
    import numpy as np
    L = len(counts_by_t[ts[0]])
    sub = np.zeros(L, np.int64)
    for t in ts:
        sub = np.maximum(sub, -(-counts_by_t[t].astype(np.int64)
                                // bcaps[t]))
    S = int(sub.sum())
    ws = np.zeros((S, len(ts)), np.int32)
    wc = np.zeros((S, len(ts)), np.int32)
    pos = np.concatenate([[0], np.cumsum(sub)[:-1]]).astype(np.int64)
    for bi, t in enumerate(ts):
        B = bcaps[t]
        st, cn = starts_by_t[t], counts_by_t[t]
        for lvl in range(L):
            c = int(cn[lvl])
            p = int(pos[lvl])
            k = 0
            while c > 0:
                ws[p + k, bi] = st[lvl] + k * B
                wc[p + k, bi] = min(B, c)
                c -= B
                k += 1
    return ws, wc


def run_wavefront(frame0, bucket_inputs, res_flat, pal_tensors, config):
    """Whole-frame wavefront: window-pack the level schedule, then host
    loop over CHUNK-step slices of one compiled scan.  bucket_inputs:
    {T: (packed dev array, starts [L] np, counts [L] np)}; config as
    for run_wavefront_chunk."""
    import numpy as np
    (buckets, *_rest) = config
    ts = [t for t, _ in buckets]
    bcaps = {t: b for t, b in buckets}
    ws, wc = make_windows({t: bucket_inputs[t][1] for t in ts},
                          {t: bucket_inputs[t][2] for t in ts}, bcaps, ts)
    packed = {t: bucket_inputs[t][0] for t in ts}
    S = ws.shape[0]
    n_chunks = max(1, -(-S // CHUNK))
    pad = n_chunks * CHUNK - S
    if pad:
        ws = np.pad(ws, ((0, pad), (0, 0)))
        wc = np.pad(wc, ((0, pad), (0, 0)))
    frame = frame0
    for k in range(n_chunks):
        sl = slice(k * CHUNK, (k + 1) * CHUNK)
        frame = run_wavefront_chunk(
            frame, packed, jnp.asarray(ws[sl]), jnp.asarray(wc[sl]),
            res_flat, pal_tensors, tuple(config))
    return frame
