"""Frame-batch decode sharded over the `data` mesh axis.

K same-geometry all-intra frames run the decoder's FULL device
back-half — the wavefront window scan (intra prediction + residual
add), deblocking, and CDEF — under `shard_map`: each device owns one
frame's lane schedule, packed residuals, palette tensors, and filter
parameters, and executes the same compiled program on its shard.  This
shards the decoder's main compute (SURVEY §2.4 "frame parallelism" /
"GOP sharding" rows mapped onto a JAX mesh), unlike the column-sharded
CDEF which shards only one filter.

Byte-exactness vs the single-device path is asserted by
tests/test_sharded.py and __graft_entry__.dryrun_multichip on real
decoded frames.
"""
from __future__ import annotations

import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from av1dec_tpu.ops.kernels.wavefront import _F, make_windows
from av1dec_tpu.pipeline.device_recon import (BUCKETS, BWIN, FLAT_PAD,
                                              _cap, _caps_for, _pad_rows,
                                              _pow2)


def _prep_frames(drs):
    """Per-frame host prep with cross-frame-uniform shapes (stacked on
    a leading K axis).  Returns (stacked numpy inputs dict, static
    config dict)."""
    from av1dec_tpu.ops.kernels import cdef as cdef_dev
    from av1dec_tpu.ops.spec.deblock import build_deblock_maps

    K = len(drs)
    sch0 = drs[0].sch
    caps = _caps_for(sch0, batch="data_shard")
    # converge capacities over all frames first so shapes are uniform
    for dr in drs:
        for t in BUCKETS:
            arr, _ = dr._bucket_rows(t)
            _cap(caps, "N", t, len(arr))
            _cap(caps, "P", t, dr._pal_tot[t])
        caps["RF"][0] = max(caps["RF"][0], _pow2(max(dr._res_px_tot, 1)))

    L = max(dr.sch.n_levels for dr in drs)
    rf = caps["RF"][0]
    flat = sch0.flat_len + FLAT_PAD

    packed_f = {t: [] for t in BUCKETS}
    pal_f = {t: [] for t in BUCKETS}
    ws_f, wc_f = [], []
    res_f = []
    dbl_f, sharp_f = [], []
    gates_f = []
    uR = (drs[0].plans.mi_rows + 1) // 2
    uC = (drs[0].plans.mi_cols + 1) // 2

    for dr in drs:
        sch = dr.sch
        starts_t, counts_t = {}, {}
        for t in BUCKETS:
            arr, lv = dr._bucket_rows(t)
            order = np.argsort(lv, kind="stable")
            arr, lv = arr[order], lv[order]
            starts = np.zeros(L, np.int32)
            counts = np.zeros(L, np.int32)
            if len(lv):
                uniq, s_idx, cnt = np.unique(lv, return_index=True,
                                             return_counts=True)
                starts[uniq - 1] = s_idx
                counts[uniq - 1] = cnt
            starts_t[t], counts_t[t] = starts, counts
            packed_f[t].append(_pad_rows(arr, caps["N"][t] + BWIN[t]))
            pal_f[t].append(dr._palette_tensor(t, caps["P"][t]))
        ws, wc = make_windows(starts_t, counts_t, dict(BWIN),
                              list(BUCKETS))
        ws_f.append(ws)
        wc_f.append(wc)
        buf = dr._residuals_flat_np()
        rbuf = np.zeros(rf, buf.dtype)
        rbuf[:len(buf)] = buf
        res_f.append(rbuf)

        maps = build_deblock_maps(dr.seq, dr.hdr, dr.plans,
                                  sch.num_planes)
        if maps is None:  # no deblock: zero maps are a no-op
            maps = []
            for pl in range(sch.num_planes):
                subx = sch.sub_x if pl else 0
                suby = sch.sub_y if pl else 0
                pw = (dr.hdr["frame_width"] + subx) >> subx
                ph = (dr.hdr["frame_height"] + suby) >> suby
                pw4, ph4 = (pw + 3) >> 2, (ph + 3) >> 2
                maps.append((
                    (np.zeros((ph4, pw4), np.int32),
                     np.zeros((ph4, pw4), np.int32)),
                    (np.zeros((pw4, ph4), np.int32),
                     np.zeros((pw4, ph4), np.int32))))
        dbl_f.append(maps)
        sharp_f.append((dr.hdr.get("lf") or {}).get("sharpness", 0))

        g = cdef_dev.compute_gates(dr.seq, dr.hdr, dr.plans,
                                   sch.num_planes, sch.bd)
        if g is None:  # zero strengths: filter is the identity
            z = np.zeros((uR, uC), np.int32)
            g = (z, z, z, z, 0,
                 sch.sub_x if sch.num_planes > 1 else 0,
                 sch.sub_y if sch.num_planes > 1 else 0)
        gates_f.append(g)

    stacked = {
        "packed": {t: np.stack(packed_f[t]) for t in BUCKETS},
        "pal": {t: np.stack(pal_f[t]) for t in BUCKETS},
        "ws": np.stack([_pad_rows_2d(w, max(x.shape[0] for x in ws_f))
                        for w in ws_f]),
        "wc": np.stack([_pad_rows_2d(w, max(x.shape[0] for x in wc_f))
                        for w in wc_f]),
        "res": np.stack(res_f),
        "sharp": np.asarray(sharp_f, np.int32),
        "damping": np.asarray([g[4] for g in gates_f], np.int32),
        "y_pri": np.stack([g[0] for g in gates_f]),
        "y_sec": np.stack([g[1] for g in gates_f]),
        "uv_pri": np.stack([g[2] for g in gates_f]),
        "uv_sec": np.stack([g[3] for g in gates_f]),
        # deblock maps: [plane][pass] -> [K, n4, k4]
        "dbl": [tuple((np.stack([dbl_f[f][pl][ps][0] for f in range(K)]),
                       np.stack([dbl_f[f][pl][ps][1] for f in range(K)]))
                      for ps in range(2))
                for pl in range(sch0.num_planes)],
    }
    config = {
        "buckets": tuple((t, BWIN[t]) for t in BUCKETS),
        "bd": sch0.bd, "sub_x": sch0.sub_x, "sub_y": sch0.sub_y,
        "eef": sch0.enable_edge_filter, "flat": flat,
        "plane_base": sch0.plane_base, "alloc": sch0.alloc_dims,
        "valid": sch0.valid_dims, "num_planes": sch0.num_planes,
        "subx_c": gates_f[0][5], "suby_c": gates_f[0][6],
    }
    return stacked, config


def _pad_rows_2d(a, n):
    return np.pad(a, ((0, n - a.shape[0]), (0, 0)))


def decode_frames_sharded(drs, mesh, axis="data"):
    """Decode K = mesh.shape[axis] same-geometry intra frames, one per
    device along `axis`, through the full device back-half under
    shard_map.  Returns a list (per frame) of host int64 plane lists,
    byte-identical to DeviceRecon.run() on each frame."""
    import jax
    import jax.numpy as jnp

    from av1dec_tpu.ops.kernels import cdef as cdef_dev
    from av1dec_tpu.ops.kernels.deblock import deblock_planes
    from av1dec_tpu.ops.kernels.wavefront import _apply_bucket

    stacked, cfg = _prep_frames(drs)
    K = len(drs)
    n_axis = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    assert K == n_axis, f"need one frame per '{axis}' device"

    buckets = cfg["buckets"]
    bd, sub_x, sub_y, eef = cfg["bd"], cfg["sub_x"], cfg["sub_y"], \
        cfg["eef"]
    ts = [t for t, _ in buckets]

    def body(packed, pal, ws, wc, res, sharp, damping,
             y_pri, y_sec, uv_pri, uv_sec, dbl):
        # each shard holds exactly one frame: strip the K axis
        packed = [p[0] for p in packed]
        pal = [p[0] for p in pal]
        ws, wc, res = ws[0], wc[0], res[0]
        sharp, damping = sharp[0], damping[0]
        y_pri, y_sec = y_pri[0], y_sec[0]
        uv_pri, uv_sec = uv_pri[0], uv_sec[0]
        dbl = tuple(tuple((fv[0], lv[0]) for fv, lv in pl) for pl in dbl)

        frame0 = jnp.zeros(cfg["flat"], jnp.int32)

        def step(frame, sc):
            st, cn = sc
            for bi, (T, Bmax) in enumerate(buckets):
                frame = _apply_bucket(
                    frame, packed[bi], st[bi], cn[bi], res, pal[bi],
                    T=T, bd=bd, Bmax=Bmax, sub_x=sub_x, sub_y=sub_y,
                    eef=eef)
            return frame, ()

        frame, _ = jax.lax.scan(step, frame0, (ws, wc))

        planes = []
        for p in range(cfg["num_planes"]):
            ha, wa = cfg["alloc"][p]
            vh, vw = cfg["valid"][p]
            b = cfg["plane_base"][p]
            planes.append(frame[b: b + ha * wa].reshape(ha, wa)[:vh, :vw])

        planes = deblock_planes(tuple(planes), dbl, sharp, bd)
        planes = cdef_dev._cdef_core(
            tuple(planes), y_pri, y_sec, uv_pri, uv_sec, bd, damping,
            cfg["subx_c"], cfg["suby_c"])
        return tuple(p[None] for p in planes)

    sh = P(axis)
    in_specs = (tuple(sh for _ in ts), tuple(sh for _ in ts),
                sh, sh, sh, sh, sh, sh, sh, sh, sh,
                tuple(tuple((sh, sh) for _ in pl)
                      for pl in stacked["dbl"]))
    out_specs = tuple(sh for _ in range(cfg["num_planes"]))

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False))
    outs = fn(tuple(jnp.asarray(stacked["packed"][t]) for t in ts),
              tuple(jnp.asarray(stacked["pal"][t]) for t in ts),
              jnp.asarray(stacked["ws"]), jnp.asarray(stacked["wc"]),
              jnp.asarray(stacked["res"]),
              jnp.asarray(stacked["sharp"]),
              jnp.asarray(stacked["damping"]),
              jnp.asarray(stacked["y_pri"]),
              jnp.asarray(stacked["y_sec"]),
              jnp.asarray(stacked["uv_pri"]),
              jnp.asarray(stacked["uv_sec"]),
              tuple(tuple((jnp.asarray(fv), jnp.asarray(lv))
                          for fv, lv in pl) for pl in stacked["dbl"]))
    # each frame's planes must come back from its own device
    assert outs[0].sharding.device_set == set(mesh.devices.flat), \
        outs[0].sharding
    host = [np.asarray(o) for o in jax.device_get(outs)]
    return [[host[p][f].astype(np.int64)
             for p in range(cfg["num_planes"])] for f in range(K)]
