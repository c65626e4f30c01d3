"""Frame reconstruction from plan tensors — spec-model driver.

Walks the transform-block record stream in decode order (which is the
intra dependency order), performing predict -> dequant -> inverse
transform -> add -> clamp per block [SPEC §7.11-§7.13].  This is the
slow, obviously-correct reference; the Pallas path replaces the inner
kernels with batched device code.
"""

from __future__ import annotations

import os

import numpy as np

from av1dec_tpu.ops.spec import dequant, intra, itx

# mirror of native enums
TX_DIMS = itx.TX_DIMS
DC_PRED = 0
UV_CFL_PRED = 13

# device mode: run the residual batches and whole-frame filters as
# jitted JAX code on JAX's default device (CPU in tests).
# Opt-in because unit tests cross-check the NumPy spec model.
_DEVICE = os.environ.get("AV1DEC_DEVICE", "0") == "1"


def set_device_mode(on: bool) -> None:
    global _DEVICE
    _DEVICE = bool(on)


def device_mode() -> bool:
    return _DEVICE


def _alpha(joint_sign, alpha_idx, plane):
    # cfl_idx_to_alpha [SPEC §7.11.5]
    sign = (joint_sign + 1) // 3 if plane == 1 else (joint_sign + 1) % 3
    if sign == 0:
        return 0
    abs_alpha = (alpha_idx >> 4) & 15 if plane == 1 else alpha_idx & 15
    a = abs_alpha + 1
    return -a if sign == 1 else a


class FrameRecon:
    """Reconstructs one frame's planes from its FramePlans.

    `refs`: dict mapping spec ref-frame enums (1..7, LAST..ALTREF) to
    {"planes": [np arrays], "width": luma_w, "height": luma_h} for inter
    frames (the DPB view).
    """

    def __init__(self, seq: dict, hdr: dict, plans, refs=None) -> None:
        self.seq = seq
        self.hdr = hdr
        self.plans = plans
        self.refs = refs
        self.bd = seq["bit_depth"]
        self.sub_x = seq["subsampling_x"]
        self.sub_y = seq["subsampling_y"]
        self.num_planes = 1 if seq["mono_chrome"] else 3
        self.mi_rows = plans.mi_rows
        self.mi_cols = plans.mi_cols
        self._warp_map = None
        h, w = self.mi_rows * 4, self.mi_cols * 4
        # allocate to superblock multiples: blocks/transforms may overhang
        # the frame bottom/right [SPEC partition semantics]; the overhang
        # is reconstructed but cropped before the filter chain
        sb = 128 if seq.get("use_128x128_superblock") else 64
        ha = (h + sb - 1) // sb * sb
        wa = (w + sb - 1) // sb * sb
        self._alloc = [np.zeros((ha, wa), dtype=np.int64)]
        for _ in range(self.num_planes - 1):
            self._alloc.append(
                np.zeros((ha >> self.sub_y, wa >> self.sub_x),
                         dtype=np.int64))
        self.planes = [self._alloc[0][:h, :w]] + [
            a[:h >> self.sub_y, :w >> self.sub_x] for a in self._alloc[1:]]
        self.enable_edge_filter = bool(seq["enable_intra_edge_filter"])

    # -- helpers over the mi grid ----------------------------------------
    def g(self, name, mi_r, mi_c):
        return int(self.plans.grid(name)[mi_r, mi_c])

    def _alloc_view(self):
        """Current (partially reconstructed) planes — intra-bc source."""
        return self.planes

    def warp_for_block(self, by, bx):
        """Local warp params for a WARPED block, or None."""
        if self._warp_map is None:
            self._warp_map = {}
            for rec in self.plans.warps:
                self._warp_map[int(rec[0])] = {
                    "invalid": int(rec[1]),
                    "params": [int(v) for v in rec[2:8]],
                }
        return self._warp_map.get(by * self.mi_cols + bx)

    def _block_origin(self, mi_r, mi_c):
        return mi_r, mi_c  # records carry the block origin directly

    def _filter_type(self, mi_r, mi_c, plane, have_above, have_left):
        """get_filter_type [SPEC §7.11.2.8]: neighbors smooth?"""
        def is_smooth(r, c):
            if r < 0 or c < 0 or r >= self.mi_rows or c >= self.mi_cols:
                return 0
            if self.g("is_inter", r, c):
                return 0  # inter: uses y mode too; refine with inter
            mode = self.g("uv_mode" if plane else "mode", r, c)
            return int(mode in (9, 10, 11))  # SMOOTH family
        above_smooth = 0
        left_smooth = 0
        if have_above:
            if plane == 0:
                cand_r, cand_c = mi_r - 1, mi_c
            else:
                # mi above the CHROMA block, at its reference column
                cand_r = (mi_r & ~self.sub_y) - 1
                cand_c = mi_c | self.sub_x
            above_smooth = is_smooth(cand_r, cand_c)
        if have_left:
            if plane == 0:
                cand_r, cand_c = mi_r, mi_c - 1
            else:
                # mi left of the CHROMA block, at its reference row
                cand_r = mi_r | self.sub_y
                cand_c = (mi_c & ~self.sub_x) - 1
            left_smooth = is_smooth(cand_r, cand_c)
        return int(above_smooth or left_smooth)

    # -- main -------------------------------------------------------------
    def _precompute_residuals(self):
        """Batch dequant + inverse transform for all coded tx blocks,
        bucketed by (tx_size, tx_type): the residual path has no
        dependency on reconstruction order, so it vectorizes freely
        (mirrors the device-side batched kernel layout)."""
        plans = self.plans
        q = self.hdr["quant"]
        use_qm = bool(q.get("using_qmatrix"))
        qm_by_plane = (q.get("qm_y", 15), q.get("qm_u", 15),
                       q.get("qm_v", 15))
        buckets = {}
        for i, rec in enumerate(plans.tx):
            eob = int(rec[5])
            if eob <= 0:
                continue
            buckets.setdefault((int(rec[3]), int(rec[4])), []).append(i)
        res = {}
        pending = []
        for (tsz, tt), idxs in buckets.items():
            w, h = (4, 4) if tsz == 19 else TX_DIMS[tsz]
            aw, ah = (4, 4) if tsz == 19 else (min(w, 32), min(h, 32))
            n = aw * ah
            B = len(idxs)
            levels = np.zeros((B, n), np.int64)
            qidx = np.zeros(B, np.int64)
            dcd = np.zeros(B, np.int64)
            acd = np.zeros(B, np.int64)
            lossless = np.zeros(B, bool)
            qml = np.full(B, 15, np.int64)
            qmc = np.zeros(B, bool)
            qm_ok = use_qm and tt < 9  # qm only for 2-D transforms
            for b, i in enumerate(idxs):
                rec = plans.tx[i]
                off = int(rec[6])
                levels[b] = plans.coeffs[off: off + n]
                mi = int(rec[7])
                mi_r, mi_c = mi // self.mi_cols, mi % self.mi_cols
                qidx[b] = self.g("qindex", mi_r, mi_c)
                lossless[b] = bool(self.g("lossless", mi_r, mi_c))
                plane = int(rec[0])
                if plane == 0:
                    dcd[b], acd[b] = q["delta_q_y_dc"], 0
                elif plane == 1:
                    dcd[b], acd[b] = q["delta_q_u_dc"], q["delta_q_u_ac"]
                else:
                    dcd[b], acd[b] = q["delta_q_v_dc"], q["delta_q_v_ac"]
                if qm_ok and not lossless[b]:
                    qml[b] = qm_by_plane[plane]
                    qmc[b] = plane >= 1
            has_qm = (qml < 15).any()
            if tsz == 19 or lossless.any():
                # lossless WHT: scalar per block (rare path)
                from av1dec_tpu.ops.qm_data import qm_row
                w_t, h_t = (4, 4) if tsz == 19 else TX_DIMS[tsz]
                for b, i in enumerate(idxs):
                    qmv = qm_row(int(qml[b]), bool(qmc[b]), w_t, h_t)
                    dq = dequant.dequant_block(
                        levels[b], tsz, int(qidx[b]), self.bd,
                        int(dcd[b]), int(acd[b]), bool(lossless[b]),
                        qm=qmv)
                    res[i] = itx.inverse_transform(dq, tsz, tt, self.bd)
                continue
            if _DEVICE and not has_qm:
                pending.append((idxs, self._residuals_device(
                    levels, qidx, dcd, acd, tsz, tt, B), B))
            else:
                dq = dequant.dequant_batch(levels, tsz, qidx, self.bd,
                                           dcd, acd, qm_levels=qml,
                                           qm_chroma=qmc)
                out = itx.inverse_transform_lanes(dq, tsz, tt, self.bd)
                for b, i in enumerate(idxs):
                    res[i] = out[b]
        if pending:
            # ONE device->host transfer for all buckets: flatten each
            # bucket on device and concatenate — link round-trip latency
            # dominates at these sizes, so a single fetch wins big
            import jax
            import jax.numpy as jnp
            flat = jnp.concatenate([d.reshape(-1) for _, d, _ in pending])
            host = np.asarray(jax.device_get(flat))
            off = 0
            for (idxs, d, B) in pending:
                n = int(np.prod(d.shape))
                out = host[off: off + n].reshape(d.shape)[:B] \
                    .astype(np.int64)
                off += n
                for b, i in enumerate(idxs):
                    res[i] = out[b]
        return res

    def _residuals_device(self, levels, qidx, dcd, acd, tsz, tt, B):
        """Device residual bucket: dequant + inverse transform jitted
        (async — returns the un-fetched device array).  Batch is padded
        to the next power of two so each (tsz, tt, B') shape compiles
        once and is reused across frames."""
        import jax.numpy as jnp

        from av1dec_tpu.ops.kernels import itx as K
        from av1dec_tpu.ops.tables_data import AC_Q, DC_Q

        bi = {8: 0, 10: 1, 12: 2}[self.bd]
        dcq = DC_Q[bi, np.clip(qidx + dcd, 0, 255)].astype(np.int32)
        acq = AC_Q[bi, np.clip(qidx + acd, 0, 255)].astype(np.int32)
        Bp = 1 << max(0, (B - 1).bit_length())
        if Bp != B:
            levels = np.concatenate(
                [levels, np.zeros((Bp - B,) + levels.shape[1:],
                                  levels.dtype)])
            dcq = np.concatenate([dcq, np.ones(Bp - B, np.int32)])
            acq = np.concatenate([acq, np.ones(Bp - B, np.int32)])
        return K.residual_bucket(jnp.asarray(levels.astype(np.int32)),
                                 jnp.asarray(dcq), jnp.asarray(acq),
                                 tsz, tt, self.bd)

    def run(self):
        plans = self.plans
        mi_cols = self.mi_cols
        residuals = self._precompute_residuals()
        inter_pred = None
        last_block = None
        for rec_idx, rec in enumerate(plans.tx):
            (plane, x4, y4, tx_size, tx_type, eob, coef_off, mi, avail) = \
                [int(v) for v in rec]
            mi_r, mi_c = mi // mi_cols, mi % mi_cols
            w, h = (4, 4) if tx_size == 19 else TX_DIMS[tx_size]
            sub_x = self.sub_x if plane else 0
            sub_y = self.sub_y if plane else 0
            x, y = x4 * 4, y4 * 4
            frame = self._alloc[plane]
            plane_h = (self.mi_rows * 4) >> sub_y
            plane_w = (self.mi_cols * 4) >> sub_x
            # on-screen tx dims (blocks can overhang the mi area? no —
            # transform blocks are always inside the mi area)
            have_left = bool(avail & 1)
            have_above = bool(avail & 2)
            have_above_right = bool(avail & 4)
            have_below_left = bool(avail & 8)

            # ---- inter / intra-bc blocks: predict once per block, then
            # accumulate residuals into the frame buffer
            is_inter = self.g("is_inter", mi_r, mi_c)
            intrabc = self.g("intrabc", mi_r, mi_c)
            if is_inter or intrabc:
                block = (self.g("by", mi_r, mi_c), self.g("bx", mi_r, mi_c))
                if block != last_block:
                    if inter_pred is None:
                        from av1dec_tpu.pipeline.inter_pred import \
                            InterPredictor
                        inter_pred = InterPredictor(self)
                    inter_pred.predict_block(*block)
                    last_block = block
                res = residuals.get(rec_idx)
                if res is not None:
                    region = frame[y: y + h, x: x + w]
                    frame[y: y + h, x: x + w] = np.clip(
                        region + res, 0, (1 << self.bd) - 1)
                continue
            last_block = (self.g("by", mi_r, mi_c), self.g("bx", mi_r, mi_c))

            # ---- prediction
            use_palette = self.g("palette_y" if plane == 0 else "palette_uv",
                                 mi_r, mi_c) > 0
            if use_palette:
                pred = self._palette_pred(plane, mi_r, mi_c, x, y, w, h)
            else:
                mode = self.g("mode" if plane == 0 else "uv_mode", mi_r, mi_c)
                angle = self.g("angle_y" if plane == 0 else "angle_uv",
                               mi_r, mi_c)
                fi_mode = self.g("filter_intra", mi_r, mi_c) \
                    if plane == 0 else -1
                is_cfl = plane > 0 and mode == UV_CFL_PRED
                ftype = self._filter_type(mi_r, mi_c, plane, have_above,
                                          have_left)
                pred = intra.predict_intra(
                    frame, (plane_h, plane_w), x, y, w, h,
                    DC_PRED if is_cfl else mode, angle,
                    have_left, have_above, have_above_right,
                    have_below_left, self.bd, ftype,
                    self.enable_edge_filter, fi_mode)
                if is_cfl:
                    luma = self._alloc[0]
                    signs = self.g("cfl_signs", mi_r, mi_c)
                    alpha_idx = self.g("cfl_alpha_idx", mi_r, mi_c)
                    # luma extent for this block (clamped to plane dims)
                    max_l_x = min((x + w) << self.sub_x,
                                  self.mi_cols * 4) - (1 << self.sub_x)
                    max_l_y = min((y + h) << self.sub_y,
                                  self.mi_rows * 4) - (1 << self.sub_y)
                    ac = intra.cfl_luma_ac(luma, y, x, w, h, self.sub_x,
                                           self.sub_y, max_l_y, max_l_x)
                    alpha = _alpha(signs, alpha_idx, plane)
                    pred = intra.cfl_predict(pred, ac, alpha, self.bd)

            # ---- residual (precomputed, batched by tx bucket)
            res = residuals.get(rec_idx)
            if res is not None:
                out = np.clip(pred + res, 0, (1 << self.bd) - 1)
            else:
                out = pred
            frame[y: y + h, x: x + w] = out
        self._postfilter()
        return self.planes

    def _postfilter(self):
        """In-loop filter chain: deblock (-> cdef -> lr, when present).
        [SPEC §7.14-7.17]"""
        lf = self.hdr.get("lf") or {}
        levels = lf.get("level", [0, 0, 0, 0])
        if any(levels):
            from av1dec_tpu.ops.spec import deblock
            deblock.deblock_frame(self.planes, self.seq, self.hdr,
                                  self.plans, self.bd)
        lr_types = (self.hdr.get("lr") or {}).get(
            "frame_restoration_type", [0, 0, 0])
        pre_cdef = [p.copy() for p in self.planes] if any(lr_types) else None
        if _DEVICE:
            from av1dec_tpu.ops.kernels import cdef as cdef_dev
            cdef_dev.cdef_frame(self.planes, self.seq, self.hdr,
                                self.plans, self.bd)
        else:
            from av1dec_tpu.ops.spec import cdef_vec
            cdef_vec.cdef_frame(self.planes, self.seq, self.hdr,
                                self.plans, self.bd)
        if self.hdr.get("use_superres"):
            from av1dec_tpu.ops.spec import superres
            self.planes = superres.superres_frame(
                self.planes, self.seq, self.hdr, self.bd)
            if pre_cdef is not None:
                pre_cdef = superres.superres_frame(
                    pre_cdef, self.seq, self.hdr, self.bd)
        if any(lr_types):
            from av1dec_tpu.ops.spec import lr
            lr.lr_frame(self.planes, pre_cdef, self.seq, self.hdr,
                        self.plans, self.bd)

    def _palette_pred(self, plane, mi_r, mi_c, x, y, w, h):
        # find the palette record for this block
        plans = self.plans
        for pi in range(len(plans.palettes) - 1, -1, -1):
            rec = plans.palettes[pi]
            if rec[0] <= mi_r and rec[1] <= mi_c:
                bs_r, bs_c = int(rec[0]), int(rec[1])
                if self.g("bsize", bs_r, bs_c) >= 0:
                    break
        rec = plans.palettes[pi]
        size_y, size_uv = int(rec[2]), int(rec[3])
        colors = rec[4:].reshape(3, 8)
        pair = 0 if plane == 0 else 1
        off = int(plans.color_map_off[pi, pair])
        sub_x = self.sub_x if plane else 0
        sub_y = self.sub_y if plane else 0
        # block dims in this plane
        mi = self.plans
        bsize_w4 = None
        # map dims: full block (padded) dims as emitted
        from av1dec_tpu.bindings import MI_FIELDS  # noqa
        bw4 = {  # lookup via bsize grid
        }
        bsz = self.g("bsize", bs_r, bs_c)
        BLOCK_W4 = [1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32,
                    1, 4, 2, 8, 4, 16]
        BLOCK_H4 = [1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32,
                    4, 1, 8, 2, 16, 4]
        bw = (BLOCK_W4[bsz] * 4) >> sub_x
        bh = (BLOCK_H4[bsz] * 4) >> sub_y
        cmap = plans.color_map[off: off + bw * bh].reshape(bh, bw)
        ox = x - ((bs_c * 4) >> sub_x)
        oy = y - ((bs_r * 4) >> sub_y)
        idxs = cmap[oy: oy + h, ox: ox + w]
        comp = 0 if plane == 0 else plane  # 1 -> U colors, 2 -> V colors
        return colors[comp][idxs].astype(np.int64)
