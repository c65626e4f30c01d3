"""Device frame reconstruction driver.

Runs the pixel back-half of one ALL-INTRA frame on the JAX device:
residual buckets (dequant + inverse transform), the wavefront intra
scan (ops/kernels/wavefront.py), and CDEF — with ONE host->device
upload of the plan tensors and ONE device->host fetch of the final
planes.  Frames the device path can't take (inter until it lands on
device) fall back to the host pipeline.

Blocks are packed into two fixed shape buckets (T in {16, 64}) with
per-lane (w, h) data and power-of-two capacities, and the level scan
runs in fixed-size chunks, so the executor's jit key is stable across
the frames of a stream (and small enough to compile fast)
[SURVEY §7.1/§7.3: entropy/pixel split, wavefront batching].
"""

from __future__ import annotations

import numpy as np

from av1dec_tpu.ops.kernels.wavefront import _DEV_FIELDS
from av1dec_tpu.ops.spec import dequant, itx
from av1dec_tpu.pipeline import wavefront as wf

TX_DIMS = itx.TX_DIMS
BUCKETS = (16, 32, 64)
BWIN = {16: 128, 32: 64, 64: 16}  # window lane caps (fixed: stable key)
FLAT_PAD = 64  # tail pad so T-wide row windows never cross the end
_DEV_F = {name: i for i, name in enumerate(_DEV_FIELDS)}


def _pow2(n, lo=1):
    return max(lo, 1 << max(0, (int(n) - 1).bit_length()))


def _bucket_for(w, h):
    m = max(w, h)
    return 16 if m <= 16 else 32 if m <= 32 else 64


# Monotonic per-geometry capacity cache: all device array extents are
# rounded up to powers of two AND to the largest extent seen so far for
# this frame geometry, so the executor's jit key converges after the
# first frame (or two) of a stream instead of recompiling per frame.
# Bench/batch callers pre-warm it across a whole stream (warm_caps) so
# the key is stable from the first device dispatch.
_CAPS = {}


def _caps_for(sch, batch=1):
    key = (sch.flat_len, sch.bd, sch.sub_x, sch.sub_y,
           sch.enable_edge_filter, batch)
    return _CAPS.setdefault(key, {
        "N": dict.fromkeys(BUCKETS, 8),    # packed rows
        "P": dict.fromkeys(BUCKETS, 1),    # palette slots
        "RF": [64],                        # packed residual pixels
    })


def _cap(caps, field, t, needed):
    v = max(caps[field][t], _pow2(needed, caps[field][t]))
    caps[field][t] = v
    return v


def _pad_rows(arr, n_total):
    """Pad packed lane rows to n_total with inert lanes (OOB-safe)."""
    pad = np.zeros((max(0, n_total - len(arr)), len(_DEV_FIELDS)),
                   np.int32)
    pad[:, _DEV_F["res_idx"]] = -1
    pad[:, _DEV_F["pal_idx"]] = -1
    pad[:, _DEV_F["above_case"]] = 2
    pad[:, _DEV_F["left_case"]] = 2
    pad[:, _DEV_F["corner_case"]] = 3
    pad[:, _DEV_F["dc_case"]] = 3
    pad[:, _DEV_F["w"]] = pad[:, _DEV_F["h"]] = 4
    pad[:, _DEV_F["lw"]] = pad[:, _DEV_F["lh"]] = 2
    return np.concatenate([arr[:n_total], pad], axis=0)


import functools


def _superres_dev(planes, sr_args, bd):
    """Device superres [SPEC §7.16]: per plane, horizontal 64-phase
    8-tap upscale — one gather (precomputed clamped tap columns) + 8
    multiply-adds.  Twin of ops.spec.superres.upscale_plane_rows."""
    import jax.numpy as jnp
    outs = []
    for p, (cols, taps) in zip(planes, sr_args):
        src = p.astype(jnp.int32)
        g = src[:, cols.reshape(-1)].reshape(
            (src.shape[0],) + cols.shape)               # [H, dw, 8]
        acc = (g * taps[None, :, :]).sum(-1)
        outs.append(jnp.clip((acc + 64) >> 7, 0, (1 << bd) - 1))
    return outs


@functools.partial(__import__("jax").jit, static_argnames=("cfg",))
def _postfilter_chain(frame, base, dbl_maps, gates, sr_args, lr_args,
                      cfg):
    """Fused per-frame postfilter: plane slice -> deblock -> CDEF ->
    superres upscale -> Wiener LR -> narrow cast, ONE dispatch, so the
    intermediate planes never leave the device.  `base` is a traced
    frame offset so every frame of a batch shares this program.  cfg:
    (plane_geom, bd, sharp, damping, subx_c, suby_c, has_dbl, has_cdef,
    has_sr, has_lr, need_pre) — all small-int statics.  Returns (final
    planes, pre-CDEF planes or ()); with superres both are upscaled (LR
    consumes both)."""
    import jax
    import jax.numpy as jnp
    (geom, bd, sharp, damping, subx_c, suby_c,
     has_dbl, has_cdef, has_sr, has_lr, need_pre) = cfg
    planes = []
    for (pb, ha, wa, vh, vw) in geom:
        flat = jax.lax.dynamic_slice(frame, (base + pb,), (ha * wa,))
        planes.append(flat.reshape(ha, wa)[:vh, :vw])
    if has_dbl:
        from av1dec_tpu.ops.kernels.deblock import deblock_planes
        planes = list(deblock_planes(tuple(planes), dbl_maps, sharp, bd))
    odt = jnp.uint8 if bd == 8 else jnp.uint16
    pre = list(planes) if need_pre else None
    if has_cdef:
        from av1dec_tpu.ops.kernels import cdef as cdef_dev
        y_pri, y_sec, uv_pri, uv_sec = gates
        planes = list(cdef_dev._cdef_core(
            tuple(planes), y_pri, y_sec, uv_pri, uv_sec, bd, damping,
            subx_c, suby_c))
    if has_sr:
        planes = _superres_dev(planes, sr_args, bd)
        if pre is not None:
            pre = _superres_dev(pre, sr_args, bd)
    if has_lr:  # all-Wiener restoration on device [SPEC §7.17.4]
        from av1dec_tpu.ops.kernels.lr import lr_wiener_planes
        planes = lr_wiener_planes(planes, pre, lr_args, bd)
        pre = None  # consumed: host tail has nothing left to do
    pre_out = tuple(p.astype(odt) for p in pre) if pre is not None \
        else ()
    return tuple(p.astype(odt) for p in planes), pre_out


class DeviceRecon:
    """Device executor for one frame; `run()` returns host planes.

    Use `supported()` first; construction assumes an all-intra frame.
    """

    def __init__(self, seq, hdr, plans, config=None, refs=None):
        from av1dec_tpu.pipeline.recon import FrameRecon
        self.config = config
        self.refs = refs
        self._pre_cdef_dev = None
        self._sr_on_device = False
        self._lr_on_device = False
        self._fr = FrameRecon(seq, hdr, plans)
        self.sch = wf.build_schedule(seq, hdr, plans,
                                     self._fr._filter_type,
                                     allow_inter=refs is not None)
        self.seq, self.hdr, self.plans = seq, hdr, plans
        self._inter_plan = None
        if self.sch is not None and self.sch.has_inter:
            from av1dec_tpu.pipeline import device_inter as di
            if di.frame_eligible(hdr, plans, refs, self.sch.num_planes):
                self._inter_plan = di.InterPlan(seq, hdr, plans, refs,
                                                self.sch)
            else:
                self.sch = None  # exotic inter tools: host path
        if self.sch is not None:
            # deterministic per-(w, h) offsets: palette slots per bucket,
            # residual PIXEL offsets into the packed flat buffer
            self._pal_off = {}
            self._pal_tot = dict.fromkeys(BUCKETS, 0)
            self._res_px_base = {}
            self._res_px_tot = 0
            for key in sorted(self.sch.classes):
                t = _bucket_for(*key)
                self._res_px_base[key] = self._res_px_tot
                self._res_px_tot += self.sch.res_count.get(key, 0) * \
                    key[0] * key[1]
                self._pal_off[key] = self._pal_tot[t]
                self._pal_tot[t] += len(self.sch.pal_preds.get(key, []))

    def supported(self):
        # all-intra frames run fully on device: wavefront + deblock +
        # CDEF; superres/LR (rare) are finished on host post-fetch
        return self.sch is not None

    def _needs_pre_cdef(self):
        """Loop restoration reads the pre-CDEF (post-deblock) pixels;
        such frames fetch both buffers and finish LR on host."""
        lr_types = (self.hdr.get("lr") or {}).get(
            "frame_restoration_type", [0, 0, 0])
        return any(lr_types)

    # -- residuals ---------------------------------------------------------
    def _residuals_flat_np(self):
        """Packed residual pixels, computed with the vectorized NumPy
        path (ops/spec itx lanes) and uploaded once.  Packing exactly
        (no bucket-tile padding) keeps the upload ~bytes-of-residual-
        sized.  The device alternative is ops/kernels/itx.py; which
        placement wins on the GPU is not measured yet.  int16 for 8-bit
        (residuals fit [-32768, 32767] per the §7.13.3 clamps)."""
        res_np = wf.compute_residuals(self.sch)
        dt = np.int16 if self.sch.bd == 8 else np.int32
        buf = np.zeros(self._res_px_tot, dt)
        for key, tensor in res_np.items():
            if not len(tensor):
                continue
            b = self._res_px_base[key]
            flat = tensor.reshape(-1)
            if dt == np.int16:
                flat = np.clip(flat, -32768, 32767)
            buf[b: b + flat.size] = flat
        return buf

    # -- schedule packing --------------------------------------------------
    def _bucket_rows(self, t):
        """All of this frame's lanes for bucket t as (rows [N, F] int32,
        levels [N]) with bucket-global residual/palette slot indices."""
        sch = self.sch
        FD = len(_DEV_FIELDS)
        rows, lvls = [], []
        for key, bc in sorted(sch.classes.items()):
            w, h = key
            if _bucket_for(w, h) != t:
                continue
            N = len(bc.levels_sorted)
            arr = np.zeros((N, FD), np.int32)
            for f, a in bc.packed.items():
                arr[:, _DEV_F[f]] = a
            ridx = arr[:, _DEV_F["res_idx"]]
            arr[:, _DEV_F["res_idx"]] = np.where(
                ridx >= 0, self._res_px_base[key] + ridx * (w * h), -1)
            pidx = arr[:, _DEV_F["pal_idx"]]
            arr[:, _DEV_F["pal_idx"]] = np.where(
                pidx >= 0, pidx + self._pal_off[key], -1)
            arr[:, _DEV_F["w"]] = w
            arr[:, _DEV_F["h"]] = h
            arr[:, _DEV_F["lw"]] = int(np.log2(w))
            arr[:, _DEV_F["lh"]] = int(np.log2(h))
            rows.append(arr)
            lvls.append(bc.levels_sorted)
        if rows:
            return (np.concatenate(rows, axis=0),
                    np.concatenate(lvls).astype(np.int64))
        return np.zeros((0, FD), np.int32), np.zeros(0, np.int64)

    def _palette_tensor(self, t, P):
        sch = self.sch
        pt = np.zeros((P, t, t), np.int32)
        for key, preds in sch.pal_preds.items():
            if _bucket_for(*key) != t:
                continue
            off = self._pal_off[key]
            w, h = key
            for k, pr in enumerate(preds):
                pt[off + k, :h, :w] = pr
        return pt

    def _pack_buckets(self, jnp):
        """Regroup the per-(w, h) schedule classes into the fixed shape
        buckets (fixed window lane caps; run_wavefront splits levels
        into windows).  Returns (buckets config, inputs, pal tensors)."""
        caps = _caps_for(self.sch)
        buckets = []
        inputs = {}
        pal = {}
        for t in BUCKETS:
            arr, lv = self._bucket_rows(t)
            order = np.argsort(lv, kind="stable")
            arr, lv = arr[order], lv[order]
            L = self.sch.n_levels
            starts = np.zeros(L, np.int32)
            counts = np.zeros(L, np.int32)
            if len(lv):
                uniq, s_idx, cnt = np.unique(lv, return_index=True,
                                             return_counts=True)
                starts[uniq - 1] = s_idx
                counts[uniq - 1] = cnt
            Bmax = BWIN[t]
            n_cap = _cap(caps, "N", t, len(arr))
            packed = _pad_rows(arr, n_cap + Bmax)
            buckets.append((t, int(Bmax)))
            inputs[t] = (jnp.asarray(packed), starts, counts)
            P = _cap(caps, "P", t, self._pal_tot[t])
            pal[t] = jnp.asarray(self._palette_tensor(t, P))
        return tuple(buckets), inputs, pal

    def _res_flat_dev(self, jnp, caps, n_frames=1, which=0, buf=None):
        """Upload the packed residuals padded to the RF cap."""
        if buf is None:
            buf = self._residuals_flat_np()
        rf = caps["RF"]
        rf[0] = max(rf[0], _pow2(max(len(buf), 1)))
        out = np.zeros(rf[0], buf.dtype)
        out[:len(buf)] = buf
        return jnp.asarray(out)

    def run_device(self):
        """Returns the final planes as DEVICE arrays (async).  When the
        frame uses loop restoration, `self._pre_cdef_dev` additionally
        holds the post-deblock pre-CDEF planes (LR input, host tail)."""
        import jax.numpy as jnp
        from av1dec_tpu.ops.kernels.wavefront import run_wavefront
        sch = self.sch
        caps = _caps_for(sch)
        res = self._res_flat_dev(jnp, caps)
        buckets, inputs, pal = self._pack_buckets(jnp)
        config = (buckets, sch.bd, sch.sub_x, sch.sub_y,
                  sch.enable_edge_filter)
        frame0 = jnp.zeros(sch.flat_len + FLAT_PAD, jnp.int32)
        if self._inter_plan is not None:
            # MC pass first: all inter predictions land in the frame
            # buffer, then the scan adds residuals + runs intra lanes
            from av1dec_tpu.ops.kernels.mc import run_mc
            mc_cfg, mc_lanes = self._inter_plan.mc_config_and_lanes(jnp)
            frame0 = run_mc(frame0, self._inter_plan.ref_flat(jnp),
                            mc_lanes, mc_cfg)
            config = config + (True,)
        frame = run_wavefront(frame0, inputs, res, pal, config)
        # loop-filter chain on device, fused into one dispatch:
        # slice -> deblock -> CDEF -> narrow cast [SPEC §7.14, §7.15].
        # The result doubles as the device-resident ref copy (api ref
        # cache) so later inter frames don't re-upload ref pixels.
        final, pre = self._post_device(jnp, frame, 0)
        self._pre_cdef_dev = pre
        self._final_dev = final
        return self._final_dev

    def _post_device(self, jnp, frame, base, maps="build"):
        """Fused postfilter dispatch for the frame at `base` within the
        flat buffer.  Returns (final planes, pre-CDEF planes or None).
        Falls back to the unfused chain when column-sharded CDEF is
        configured."""
        from av1dec_tpu.ops.kernels import cdef as cdef_dev
        sch = self.sch
        if maps == "build":
            from av1dec_tpu.ops.spec.deblock import build_deblock_maps
            maps = build_deblock_maps(self.seq, self.hdr, self.plans,
                                      sch.num_planes)
        gates = cdef_dev.compute_gates(self.seq, self.hdr, self.plans,
                                       sch.num_planes, sch.bd)
        n_shards = getattr(self.config, "space_shards", 0) or 0
        odt = jnp.uint8 if sch.bd == 8 else jnp.uint16
        if gates is not None and n_shards > 1:
            # column-sharded CDEF path (unfused)
            planes = self._slice_planes(frame, base)
            if maps is not None:
                planes = self._deblock_device(jnp, planes, maps=maps)
            pre = [p.astype(odt) for p in planes] \
                if self._needs_pre_cdef() else None
            planes = self._cdef_device(jnp, planes)
            return [p.astype(odt) for p in planes], pre
        dbl_dev = ()
        sharp = 0
        if maps is not None:
            dbl_dev = tuple(
                ((jnp.asarray(fv), jnp.asarray(lv)),
                 (jnp.asarray(fh), jnp.asarray(lh)))
                for (fv, lv), (fh, lh) in maps)
            sharp = int(self.hdr["lf"]["sharpness"])
        gates_dev = ()
        damping = 0
        subx_c = suby_c = 0
        if gates is not None:
            y_pri, y_sec, uv_pri, uv_sec, damping, subx_c, suby_c = gates
            gates_dev = (jnp.asarray(y_pri), jnp.asarray(y_sec),
                         jnp.asarray(uv_pri), jnp.asarray(uv_sec))
        geom = tuple(
            (sch.plane_base[p],) + tuple(sch.alloc_dims[p]) +
            tuple(sch.valid_dims[p]) for p in range(sch.num_planes))
        sr_dev = ()
        has_sr = bool(self.hdr.get("use_superres"))
        if has_sr:
            sr_dev = tuple(
                (jnp.asarray(c), jnp.asarray(t))
                for c, t in self._superres_args())
            self._sr_on_device = True
        lr_dev = ()
        lr_args = self._lr_wiener_args() if self._needs_pre_cdef() \
            else None
        has_lr = lr_args is not None
        if has_lr:
            lr_dev = tuple(
                None if a is None else tuple(jnp.asarray(x) for x in a)
                for a in lr_args)
            self._lr_on_device = True
        cfg = (geom, sch.bd, sharp, int(damping), subx_c, suby_c,
               maps is not None, gates is not None, has_sr, has_lr,
               self._needs_pre_cdef())
        final, pre = _postfilter_chain(frame, base, dbl_dev, gates_dev,
                                       sr_dev, lr_dev, cfg)
        return list(final), (list(pre) if pre else None)

    def _lr_wiener_args(self):
        """Host-built per-plane args for the device Wiener LR pass, or
        None when any active unit is self-guided (host LR tail) or LR
        is off.  Mirrors ops.spec.lr.lr_frame's unit/stripe geometry."""
        from av1dec_tpu.ops.spec.lr import (RESTORE_NONE, RESTORE_WIENER,
                                            _count_units)
        hdr, sch, plans = self.hdr, self.sch, self.plans
        lr = hdr.get("lr") or {}
        frt = lr.get("frame_restoration_type", [0, 0, 0])
        if not any(frt):
            return None
        for rec in plans.lr:
            if int(rec[3]) not in (RESTORE_NONE, RESTORE_WIENER):
                return None  # SGR unit: host tail handles the frame
        units = {(int(r[0]), int(r[1]), int(r[2])): r for r in plans.lr}
        fw = hdr.get("upscaled_width", hdr["frame_width"])
        fh = hdr["frame_height"]
        out = []
        for plane in range(sch.num_planes):
            if frt[plane] == RESTORE_NONE:
                out.append(None)
                continue
            subx = sch.sub_x if plane else 0
            suby = sch.sub_y if plane else 0
            pw = (fw + subx) >> subx
            ph = (fh + suby) >> suby
            us = lr["loop_restoration_size"][plane]
            ucols = _count_units(us, pw)
            urows = _count_units(us, ph)
            H = sch.valid_dims[plane][0]
            W = ((hdr["upscaled_width"] + subx) >> subx) \
                if hdr.get("use_superres") else sch.valid_dims[plane][1]
            voff = 8 >> suby
            # unit index per pixel; sentinel row/col beyond the crop
            uy = np.full(H, urows, np.int32)
            for ur in range(urows):
                y0 = max(0, ur * us - voff)
                y1 = (ur + 1) * us - voff if ur + 1 < urows else ph
                uy[y0:min(y1, ph)] = ur
            ux = np.full(W, ucols, np.int32)
            for uc in range(ucols):
                x0 = uc * us
                x1 = (uc + 1) * us if uc + 1 < ucols else pw
                ux[x0:min(x1, pw)] = uc
            tv = np.zeros((urows + 1, ucols + 1, 7), np.int32)
            th = np.zeros((urows + 1, ucols + 1, 7), np.int32)
            act = np.zeros((urows + 1, ucols + 1), np.int32)
            for ur in range(urows):
                for uc in range(ucols):
                    rec = units.get((plane, ur, uc))
                    if rec is None or int(rec[3]) != RESTORE_WIENER:
                        continue
                    t_v = [int(rec[4]), int(rec[5]), int(rec[6])]
                    t_h = [int(rec[7]), int(rec[8]), int(rec[9])]
                    if plane:
                        t_v[0] = 0
                        t_h[0] = 0
                    tv[ur, uc] = [t_v[0], t_v[1], t_v[2],
                                  128 - 2 * sum(t_v), t_v[2], t_v[1],
                                  t_v[0]]
                    th[ur, uc] = [t_h[0], t_h[1], t_h[2],
                                  128 - 2 * sum(t_h), t_h[2], t_h[1],
                                  t_h[0]]
                    act[ur, uc] = 1
            # stripe-clamped vertical-tap source rows [SPEC §7.17.2]
            y = np.arange(H)
            yl = y << suby
            stripe = (yl + 8) // 64
            slo = (stripe * 64 - 8) >> suby
            shi = ((stripe + 1) * 64 - 8 >> suby) - 1
            vr = np.zeros((7, H), np.int32)
            inside = np.zeros((7, H), bool)
            for k in range(7):
                orig = y + k - 3
                ys = np.clip(np.clip(orig, slo - 2, shi + 2), 0, H - 1)
                vr[k] = ys
                inside[k] = ((orig >= slo) & (orig <= shi)) | \
                    ((ys >= slo) & (ys <= shi))
            out.append((uy, ux, tv, th, act, vr, inside))
        return out

    def _superres_args(self):
        """Per-plane (cols [dw, 8] int32, taps [dw, 8] int32) for the
        device superres gather; mirrors
        ops.spec.superres.upscale_plane_rows' index/phase math."""
        from av1dec_tpu.ops.spec import superres as S
        hdr, sch = self.hdr, self.sch
        fw, uw = hdr["frame_width"], hdr["upscaled_width"]
        out = []
        for p in range(sch.num_planes):
            subx = sch.sub_x if p else 0
            sw = (fw + subx) >> subx
            dw = (uw + subx) >> subx
            vw = sch.valid_dims[p][1]
            step = ((sw << S.SCALE_BITS) + (dw >> 1)) // dw
            err = step * dw - (sw << S.SCALE_BITS)
            num = -((dw - sw) << (S.SCALE_BITS - 1)) + (dw >> 1)
            x0 = -((-num) // dw) if num < 0 else num // dw
            e2 = err // 2 if err >= 0 else -((-err) // 2)
            x0 += (1 << (S.EXTRA_BITS - 1)) - e2
            xs = x0 + step * np.arange(dw)
            px = xs >> S.SCALE_BITS
            subpel = (xs & S.SCALE_MASK) >> S.EXTRA_BITS
            cols = np.clip(px[:, None] + np.arange(8)[None, :] - 3,
                           0, vw - 1).astype(np.int32)
            taps = np.asarray(S.FILTER, np.int32)[subpel]
            out.append((cols, taps))
        return out

    def _deblock_device(self, jnp, planes, maps=None):
        if maps is None:
            from av1dec_tpu.ops.spec.deblock import build_deblock_maps
            maps = build_deblock_maps(self.seq, self.hdr, self.plans,
                                      self.sch.num_planes)
        if maps is None:
            return planes
        from av1dec_tpu.ops.kernels.deblock import deblock_all
        dev_maps = tuple(
            ((jnp.asarray(fv), jnp.asarray(lv)),
             (jnp.asarray(fh), jnp.asarray(lh)))
            for (fv, lv), (fh, lh) in maps)
        return list(deblock_all(
            tuple(p.astype(jnp.int32) for p in planes), dev_maps,
            self.hdr["lf"]["sharpness"], self.sch.bd))

    def _slice_planes(self, frame, base):
        sch = self.sch
        planes = []
        for p in range(sch.num_planes):
            ha, wa = sch.alloc_dims[p]
            vh, vw = sch.valid_dims[p]
            b = base + sch.plane_base[p]
            planes.append(frame[b: b + ha * wa].reshape(ha, wa)[:vh, :vw])
        return planes

    def _cdef_device(self, jnp, planes):
        from av1dec_tpu.ops.kernels import cdef as cdef_dev
        gates = cdef_dev.compute_gates(self.seq, self.hdr, self.plans,
                                       len(planes), self.sch.bd)
        if gates is None:
            return planes
        n_shards = getattr(self.config, "space_shards", 0) or 0
        if n_shards > 1:
            if planes[0].shape[1] % (8 * n_shards) == 0:
                import jax
                from jax.sharding import Mesh

                from av1dec_tpu.parallel.sharded_cdef import cdef_sharded
                devs = jax.devices()
                if len(devs) < n_shards:
                    raise ValueError(
                        f"space_shards={n_shards} needs {n_shards} "
                        f"devices; JAX has {len(devs)}")
                mesh = Mesh(np.asarray(devs[:n_shards]), ("space",))
                return list(cdef_sharded(
                    tuple(p.astype(jnp.int32) for p in planes),
                    gates, self.sch.bd, mesh))
            else:
                import logging
                logging.getLogger("av1dec_tpu").warning(
                    "sharded CDEF: width %d not divisible by 8*%d "
                    "shards; falling back to single-device",
                    planes[0].shape[1], n_shards)
        y_pri, y_sec, uv_pri, uv_sec, damping, subx, suby = gates
        outs = cdef_dev._cdef_all(
            tuple(planes), jnp.asarray(y_pri), jnp.asarray(y_sec),
            jnp.asarray(uv_pri), jnp.asarray(uv_sec), self.sch.bd,
            damping, subx, suby)
        return list(outs)

    def run(self):
        """Full frame on device; returns host planes (int64, like
        FrameRecon.run).  Superres/LR (rare) finish on host."""
        import jax
        planes = self.run_device()
        fetched = jax.device_get(planes)
        out = [np.asarray(p).astype(np.int64) for p in fetched]
        pre = None
        if self._pre_cdef_dev is not None:
            pre = [np.asarray(p).astype(np.int64)
                   for p in jax.device_get(self._pre_cdef_dev)]
        return self.finish_host(out, pre)

    def finish_host(self, planes, pre_cdef):
        """Host tail of the filter chain: superres upscale + loop
        restoration [SPEC §7.16, §7.17] on fetched planes (no-op for
        the common case)."""
        hdr, seq, bd = self.hdr, self.seq, self.sch.bd
        if hdr.get("use_superres") and not self._sr_on_device:
            from av1dec_tpu.ops.spec import superres
            planes = superres.superres_frame(planes, seq, hdr, bd)
            if pre_cdef is not None:
                pre_cdef = superres.superres_frame(pre_cdef, seq, hdr,
                                                   bd)
        if self._needs_pre_cdef() and not self._lr_on_device:
            from av1dec_tpu.ops.spec import lr
            lr.lr_frame(planes, pre_cdef, seq, hdr, self.plans, bd)
        return planes


def prep_batch(drs):
    """Host-side half of the batched device decode: residual packing,
    lane assembly, palette tensors, and deblock edge maps — all NumPy,
    no device calls.  Runs on a worker thread in the pipelined decoder
    so it overlaps the device execution of the previous batch
    [SURVEY §7.3.5 "overlap entropy decode with device recon"].
    """
    K = len(drs)
    sch0 = drs[0].sch
    caps = _caps_for(sch0, batch=True)
    flat = sch0.flat_len + FLAT_PAD
    Pcap = {t: _cap(caps, "P", t, max(dr._pal_tot[t] for dr in drs))
            for t in BUCKETS}

    # packed residuals at a uniform per-frame stride (threaded: the
    # itx lanes are large numpy ops that release the GIL)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as ex:
        bufs = list(ex.map(lambda dr: dr._residuals_flat_np(), drs))
    rf = caps["RF"]
    rf[0] = max(rf[0], _pow2(max(max(len(b) for b in bufs), 1)))
    res_np = np.zeros(K * rf[0], bufs[0].dtype)
    for f, b in enumerate(bufs):
        res_np[f * rf[0]: f * rf[0] + len(b)] = b

    pal_np = {t: np.concatenate(
        [dr._palette_tensor(t, Pcap[t]) for dr in drs], axis=0)
        for t in BUCKETS}

    L = max(dr.sch.n_levels for dr in drs)
    buckets = []
    inputs_np = {}
    for t in BUCKETS:
        rows_all, lv_all = [], []
        for f, dr in enumerate(drs):
            arr, lv = dr._bucket_rows(t)
            arr = arr.copy()
            arr[:, _DEV_F["base"]] += f * flat
            arr[:, _DEV_F["lbase"]] += f * flat
            ridx = arr[:, _DEV_F["res_idx"]]
            arr[:, _DEV_F["res_idx"]] = np.where(
                ridx >= 0, ridx + f * rf[0], -1)
            pidx = arr[:, _DEV_F["pal_idx"]]
            arr[:, _DEV_F["pal_idx"]] = np.where(
                pidx >= 0, pidx + f * Pcap[t], -1)
            rows_all.append(arr)
            lv_all.append(lv)
        arr = np.concatenate(rows_all, axis=0)
        lv = np.concatenate(lv_all)
        order = np.argsort(lv, kind="stable")
        arr, lv = arr[order], lv[order]
        starts = np.zeros(L, np.int32)
        counts = np.zeros(L, np.int32)
        if len(lv):
            uniq, s_idx, cnt = np.unique(lv, return_index=True,
                                         return_counts=True)
            starts[uniq - 1] = s_idx
            counts[uniq - 1] = cnt
        n_cap = _cap(caps, "N", t, len(arr))
        packed = _pad_rows(arr, n_cap + BWIN[t])
        buckets.append((t, BWIN[t]))
        inputs_np[t] = (packed, starts, counts)

    from av1dec_tpu.ops.spec.deblock import build_deblock_maps
    dbl = [build_deblock_maps(dr.seq, dr.hdr, dr.plans,
                              dr.sch.num_planes) for dr in drs]
    return {
        "K": K, "flat": flat,
        "res_np": res_np, "pal_np": pal_np, "inputs_np": inputs_np,
        "buckets": tuple(buckets), "dbl": dbl,
        "config": (tuple(buckets), sch0.bd, sch0.sub_x, sch0.sub_y,
                   sch0.enable_edge_filter),
    }


def dispatch_batch(drs, prep):
    """Device half: upload the prepped tensors, run the batched
    wavefront scan + per-frame deblock/CDEF.  Returns a list (per
    frame) of device plane lists (async)."""
    import jax.numpy as jnp

    from av1dec_tpu.ops.kernels.wavefront import run_wavefront

    res = jnp.asarray(prep["res_np"])
    pal = {t: jnp.asarray(a) for t, a in prep["pal_np"].items()}
    inputs = {t: (jnp.asarray(p), s, c)
              for t, (p, s, c) in prep["inputs_np"].items()}
    frame0 = jnp.zeros(prep["K"] * prep["flat"], jnp.int32)
    frame = run_wavefront(frame0, inputs, res, pal, prep["config"])

    outs = []
    for f, dr in enumerate(drs):
        # fused postfilter: one dispatch per frame instead of ~8
        final, pre = dr._post_device(jnp, frame, f * prep["flat"],
                                     maps=prep["dbl"][f])
        dr._pre_cdef_dev = pre
        outs.append(final)
    return outs


def run_device_batch(drs):
    """Decode K same-geometry intra frames in ONE wavefront run.

    Frames are independent, so level i of every frame executes at the
    same scan position — the window packing then amortizes the
    per-window dispatch/compute across K frames' lanes.  Lanes carry
    per-frame base offsets into a [K * (flat_len + pad)] buffer;
    residuals are packed pixels at a uniform per-frame stride.

    Returns a list (per frame) of device plane lists (async).
    """
    return dispatch_batch(drs, prep_batch(drs))
