"""Device deblocking loop filter — whole-frame jitted formulation.
[SPEC §7.14]

Whole-frame restructuring of ops.spec.deblock (the NumPy oracle).  The
spec walks edges sequentially, but within one pass (all vertical edges,
then all horizontal edges) the filters are provably independent: an
edge's taps never read pixels another same-pass edge writes, because
filter length is bounded by the adjacent transform dims that also bound
the distance to the neighboring edges (filter14 needs 16px transforms
on both sides, so the nearest other edge is >= 16px away and writes at
most 6px toward it; same argument down the size ladder).  So each pass
runs as ONE data-parallel whole-frame computation:

- the 14 edge-crossing taps p6..q6 are 14 STATIC strided slices of the
  (zero-padded) plane — no gathers;
- all masks/filters from ops.spec.deblock._filter_lines evaluate
  elementwise over an [H, W/4] edge lattice (XLA-fused);
- written pixels are recombined by static shifts + where() — each
  output position has at most one actual writer (the independence
  argument above), so combination order is immaterial;
- the horizontal pass reuses the same kernel on the transposed plane.

Edge decisions (filter length + level) come from the host as dense
per-4x4-cell maps (ops.spec.deblock.build_deblock_maps) — the SAME maps
the host filter consumes, so host/device differ only in execution
shape.  Thresholds derive from the level map on device (pure
elementwise).  All int32; bit-exact vs the host (tests/test_deblock_device.py).
"""
import functools

import jax
import jax.numpy as jnp


def _thresholds(lvl, sharpness):
    """(limit, blimit, thresh) from the edge filter level map.
    [SPEC §7.14.4]; twin of ops.spec.deblock._thresholds.  `sharpness`
    may be a Python int (per-frame jit) or a traced scalar (sharded
    multi-frame batch)."""
    if isinstance(sharpness, int):
        shift = (1 if sharpness > 0 else 0) + (1 if sharpness > 4 else 0)
        limit = lvl >> shift
        if sharpness > 0:
            limit = jnp.minimum(limit, 9 - sharpness)
    else:
        shift = (sharpness > 0).astype(jnp.int32) + \
            (sharpness > 4).astype(jnp.int32)
        limit = lvl >> shift
        limit = jnp.where(sharpness > 0,
                          jnp.minimum(limit, 9 - sharpness), limit)
    limit = jnp.maximum(limit, 1)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    return limit, blimit, thresh


def _filter_edges(p, q, length, limit, blimit, thresh, bd):
    """Vectorized twin of ops.spec.deblock._filter_lines over an edge
    lattice.  p, q: lists of 7 arrays (p[0]=p0 adjacent .. p[6]=p6),
    all [H, K] int32.  Returns (outp, outq, wrote_p, wrote_q): new
    values and per-tap written masks.  [SPEC §7.14.6]"""
    F = 1 << (bd - 8)
    limit = limit * F
    blimit = blimit * F
    thresh = thresh * F

    def ad(a, b):
        return jnp.abs(a - b)

    m = (ad(p[1], p[0]) <= limit) & (ad(q[1], q[0]) <= limit) & \
        (ad(p[0], q[0]) * 2 + ad(p[1], q[1]) // 2 <= blimit)
    m6 = m & (ad(p[2], p[1]) <= limit) & (ad(q[2], q[1]) <= limit)
    m8 = m6 & (ad(p[3], p[2]) <= limit) & (ad(q[3], q[2]) <= limit)
    mask = jnp.where(length == 4, m,
                     jnp.where(length == 6, m6, m8)) & (length > 0)

    flat6 = (ad(p[1], p[0]) <= F) & (ad(q[1], q[0]) <= F) & \
            (ad(p[2], p[0]) <= F) & (ad(q[2], q[0]) <= F)
    flat8 = flat6 & (ad(p[3], p[0]) <= F) & (ad(q[3], q[0]) <= F)
    flat2 = (ad(p[4], p[0]) <= F) & (ad(q[4], q[0]) <= F) & \
            (ad(p[5], p[0]) <= F) & (ad(q[5], q[0]) <= F) & \
            (ad(p[6], p[0]) <= F) & (ad(q[6], q[0]) <= F)

    def rnd(x, b):
        return (x + (1 << (b - 1))) >> b

    outp = list(p)
    outq = list(q)

    # wide 13-tap (length 14, luma) [SPEC §7.14.6.4]
    w14 = mask & (length == 14) & flat8 & flat2
    S = [p[6], p[5], p[4], p[3], p[2], p[1], p[0],
         q[0], q[1], q[2], q[3], q[4], q[5], q[6]]

    def wide(i):
        acc = S[min(max(i - 1, 0), 13)] + S[i] + S[min(max(i + 1, 0), 13)]
        for j in range(i - 6, i + 7):
            acc = acc + S[min(max(j, 0), 13)]
        return rnd(acc, 4)

    for i in range(6):
        outp[i] = jnp.where(w14, wide(6 - i), outp[i])
        outq[i] = jnp.where(w14, wide(7 + i), outq[i])

    # 7-tap (length 8)
    w8 = mask & (length >= 8) & flat8 & ~w14
    o2 = rnd(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0], 3)
    o1 = rnd(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1], 3)
    o0 = rnd(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2], 3)
    u0 = rnd(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3], 3)
    u1 = rnd(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2, 3)
    u2 = rnd(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3, 3)
    for i, v in enumerate((o0, o1, o2)):
        outp[i] = jnp.where(w8, v, outp[i])
    for i, v in enumerate((u0, u1, u2)):
        outq[i] = jnp.where(w8, v, outq[i])

    # 5-tap (length 6, chroma)
    w6 = mask & (length == 6) & flat6
    o1 = rnd(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0], 3)
    o0 = rnd(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1], 3)
    u0 = rnd(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2], 3)
    u1 = rnd(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3, 3)
    for i, v in enumerate((o0, o1)):
        outp[i] = jnp.where(w6, v, outp[i])
    for i, v in enumerate((u0, u1)):
        outq[i] = jnp.where(w6, v, outq[i])

    # narrow 4-tap with hev
    w4 = mask & ~w14 & ~w8 & ~w6
    half = 128 * F
    lo, hi = -half, half - 1

    def sc(x):
        return jnp.clip(x, lo, hi)

    hev = (ad(p[1], p[0]) > thresh) | (ad(q[1], q[0]) > thresh)
    ps1, ps0 = p[1] - half, p[0] - half
    qs0, qs1 = q[0] - half, q[1] - half
    a = sc(jnp.where(hev, sc(ps1 - qs1), 0) + 3 * (qs0 - ps0))
    f1 = sc(a + 4) >> 3
    f2 = sc(a + 3) >> 3
    top = (1 << bd) - 1
    n_q0 = jnp.clip(sc(qs0 - f1) + half, 0, top)
    n_p0 = jnp.clip(sc(ps0 + f2) + half, 0, top)
    f3 = jnp.where(hev, 0, (f1 + 1) >> 1)
    n_q1 = jnp.clip(sc(qs1 - f3) + half, 0, top)
    n_p1 = jnp.clip(sc(ps1 + f3) + half, 0, top)
    outp[0] = jnp.where(w4, n_p0, outp[0])
    outp[1] = jnp.where(w4, n_p1, outp[1])
    outq[0] = jnp.where(w4, n_q0, outq[0])
    outq[1] = jnp.where(w4, n_q1, outq[1])

    near = w14 | w8 | w6 | w4
    wrote_p = [near, near, w14 | w8, w14, w14, w14]
    wrote_q = [near, near, w14 | w8, w14, w14, w14]
    return outp, outq, wrote_p, wrote_q


def _pass_axis1(plane, flen_c, lvl_c, sharpness, bd):
    """Filter all axis-1 ("vertical", between-columns) edges of one
    plane [H, W] int32.  flen_c/lvl_c: [n4, K4] cell maps from
    build_deblock_maps (edge at column 4k, cell row a covers pixel
    rows 4a..4a+3); cells beyond the cropped frame carry flen 0."""
    H, W = plane.shape
    K = -(-W // 4)
    W4 = K * 4
    n4, k4 = flen_c.shape

    # cell maps -> per-pixel-row [H, K] (rows beyond the map: no filter)
    def ex(m):
        if k4 < K:
            m = jnp.pad(m, ((0, 0), (0, K - k4)))
        else:
            m = m[:, :K]
        r = jnp.repeat(m, 4, axis=0, total_repeat_length=n4 * 4)
        if n4 * 4 >= H:
            return r[:H]
        return jnp.pad(r, ((0, H - n4 * 4), (0, 0)))

    flen = ex(flen_c)
    limit, blimit, thresh = _thresholds(ex(lvl_c), sharpness)

    # the 14 edge-crossing taps as static strided slices; zero padding
    # mirrors the host's zero-filled out-of-bounds P/Q lanes
    Z = jnp.pad(plane.astype(jnp.int32), ((0, 0), (8, 8 + W4 - W)))
    S = [Z[:, 8 + d:: 4][:, :K] for d in range(-7, 7)]
    p = [S[6 - i] for i in range(7)]
    q = [S[7 + i] for i in range(7)]

    outp, outq, wrote_p, wrote_q = _filter_edges(
        p, q, flen, limit, blimit, thresh, bd)

    def shl(a, n):   # writer edge is n lattice steps to the right
        return jnp.pad(a, ((0, 0), (0, n)))[:, n:]

    def shr(a, n):   # writer edge is n lattice steps to the left
        return jnp.pad(a, ((0, 0), (n, 0)))[:, :K]

    # recombine: position 4k+j can be written by edge k (as q_j), edge
    # k+1 (as p_{3-j}), edge k-1 (as q_{j+4}, j<2) or edge k+2 (as
    # p_{7-j}, j>=2); at most one mask is true (pass independence)
    cols = []
    for j in range(4):
        out_j = jnp.where(wrote_q[j], outq[j], q[j])
        out_j = jnp.where(shl(wrote_p[3 - j], 1),
                          shl(outp[3 - j], 1), out_j)
        if j < 2:
            out_j = jnp.where(shr(wrote_q[4 + j], 1),
                              shr(outq[4 + j], 1), out_j)
        else:
            out_j = jnp.where(shl(wrote_p[7 - j], 2),
                              shl(outp[7 - j], 2), out_j)
        cols.append(out_j)
    out = jnp.stack(cols, axis=2).reshape(H, W4)
    return out[:, :W]


def deblock_planes(planes, maps, sharpness, bd):
    """Both deblock passes for all planes (traceable; called inside the
    device dispatch chain).  `planes`: tuple of [H, W] int32; `maps`:
    per plane ((flen_v, lvl_v), (flen_h, lvl_h)) device arrays."""
    outs = []
    for plane, ((fv, lv), (fh, lh)) in zip(planes, maps):
        x = _pass_axis1(plane.astype(jnp.int32), fv, lv, sharpness, bd)
        x = _pass_axis1(x.T, fh, lh, sharpness, bd).T
        outs.append(x)
    return tuple(outs)


@functools.partial(jax.jit, static_argnums=(2, 3))
def deblock_all(planes, maps, sharpness, bd):
    """Jitted standalone deblock (the per-frame device pass)."""
    return deblock_planes(planes, maps, sharpness, bd)
