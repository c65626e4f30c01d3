"""Wavefront-scheduled intra reconstruction. [SPEC §7.11.2, SURVEY §7.1]

The per-block spec model (`pipeline.recon.FrameRecon`) walks transform
blocks serially.  For the device path we restructure the same math as a
*schedule*: every transform block is assigned a wavefront level such
that all of its prediction inputs (reconstructed neighbor pixels) were
written at strictly earlier levels.  All blocks on one level are
independent and execute as one batch; the whole frame then runs as a
single `lax.scan` over levels on device (one dispatch, no host round
trips), or as a vectorized NumPy loop (the oracle for the device
executor, and itself checked against FrameRecon).

Key split (SURVEY §7.3 "entropy/pixel interface"): ALL control flow is
static given the plan tensors — availability, clamp limits, edge-filter
strength, upsample flags, CfL alphas, palette contents.  The host
precomputes those as per-block scalars; the device executes only pixel
gathers + integer arithmetic + scatters.
"""

from __future__ import annotations

import numpy as np

from av1dec_tpu.ops.spec import dequant, intra, itx
from av1dec_tpu.ops.tables_data import DR_INTRA_DERIVATIVE, SM_WEIGHTS

TX_DIMS = itx.TX_DIMS
UV_CFL_PRED = 13

# mode family tags for the executor; MF_INTER = "prediction already in
# the frame buffer" (the device MC pass runs before the scan): the lane
# just gathers its own block, adds the residual, clips, writes back
MF_DC, MF_V, MF_H, MF_DIR, MF_SMOOTH, MF_SMOOTH_V, MF_SMOOTH_H, \
    MF_PAETH, MF_PAL, MF_FI, MF_INTER = range(11)

_SCALAR_FIELDS = [
    "x", "y", "plane", "base", "stride", "mode_family", "p_angle",
    "above_case", "above_lim", "left_case", "left_lim", "corner_case",
    "str_above", "str_left", "up_above", "up_left",
    "npx_above", "npx_left", "corner_filt", "dx", "dy",
    "have_above", "have_left", "res_idx", "pal_idx", "fi_mode",
    "cfl_alpha", "cfl_maxx", "cfl_maxy", "dc_case",
]


class BlockClass:
    """All blocks of one (w, h) transform shape, grouped by level."""

    def __init__(self, w, h):
        self.w = w
        self.h = h
        self._levels = []
        self._rows = []       # list of per-block scalar tuples
        self.packed = None    # {field: [N]} sorted by level
        self.level_slices = None  # level -> (start, end)

    def add(self, level, scal):
        self._levels.append(level)
        self._rows.append(tuple(scal[f] for f in _SCALAR_FIELDS))

    def finalize(self):
        lv = np.asarray(self._levels, np.int64)
        rows = np.asarray(self._rows, np.int64)
        order = np.argsort(lv, kind="stable")
        lv = lv[order]
        rows = rows[order]
        self.packed = {f: np.ascontiguousarray(rows[:, k])
                       for k, f in enumerate(_SCALAR_FIELDS)}
        self.levels_sorted = lv
        # level -> slice bounds
        self.level_slices = {}
        if len(lv):
            uniq, starts = np.unique(lv, return_index=True)
            ends = np.append(starts[1:], len(lv))
            for u, s, e in zip(uniq, starts, ends):
                self.level_slices[int(u)] = (int(s), int(e))
        self._rows = self._levels = None

    def at_level(self, lvl):
        se = self.level_slices.get(lvl)
        if se is None:
            return None
        s, e = se
        return {f: a[s:e] for f, a in self.packed.items()}


class Schedule:
    def __init__(self, seq, hdr, plans):
        self.seq = seq
        self.hdr = hdr
        self.plans = plans
        self.bd = seq["bit_depth"]
        self.sub_x = seq["subsampling_x"]
        self.sub_y = seq["subsampling_y"]
        self.num_planes = 1 if seq["mono_chrome"] else 3
        self.enable_edge_filter = bool(seq["enable_intra_edge_filter"])
        self.classes = {}  # (w, h) -> BlockClass
        self.n_levels = 0
        self.has_inter = False
        self.pal_preds = {}   # (w, h) -> [np (h, w)] palette predictions
        self.res_count = {}   # (w, h) -> count of residual slots
        self.res_recs = {}    # (w, h) -> list of plans.tx record indices
        # frame layout: flat concatenation of the mi-padded plane allocs
        h4, w4 = plans.mi_rows * 4, plans.mi_cols * 4
        sb = 128 if seq.get("use_128x128_superblock") else 64
        ha = (h4 + sb - 1) // sb * sb
        wa = (w4 + sb - 1) // sb * sb
        self.alloc_dims = [(ha, wa)]
        self.valid_dims = [(h4, w4)]
        for _ in range(self.num_planes - 1):
            self.alloc_dims.append((ha >> self.sub_y, wa >> self.sub_x))
            self.valid_dims.append((h4 >> self.sub_y, w4 >> self.sub_x))
        self.plane_base = np.cumsum(
            [0] + [a * b for a, b in self.alloc_dims])[:3].tolist()
        self.flat_len = sum(a * b for a, b in self.alloc_dims)


def _level_for(g4, plane, x4, y4, w4, h4, ext_above, ext_left, cfl_dep,
               sub_x, sub_y):
    """ASAP wavefront level for one block.

    deps: the above row over the columns actually read (2w extension
    only for directional p_angle < 90), the left column over the rows
    read (2h only for p_angle > 180), and — for CfL chroma — the
    co-located reconstructed luma region."""
    G = g4[plane]
    dep = 0
    if y4 > 0:
        c0 = max(0, x4 - 1)
        c1 = min(G.shape[1], x4 + (2 * w4 if ext_above else w4) + 1)
        m = G[y4 - 1, c0:c1].max()
        if m > dep:
            dep = int(m)
    if x4 > 0:
        r0 = y4
        r1 = min(G.shape[0], y4 + (2 * h4 if ext_left else h4) + 1)
        m = G[r0:r1, x4 - 1].max()
        if m > dep:
            dep = int(m)
    if cfl_dep:
        ly0 = y4 << sub_y
        lx0 = x4 << sub_x
        ly1 = min(g4[0].shape[0], ly0 + (h4 << sub_y))
        lx1 = min(g4[0].shape[1], lx0 + (w4 << sub_x))
        m = g4[0][ly0:ly1, lx0:lx1].max()
        if m > dep:
            dep = int(m)
    L = dep + 1
    G[y4: y4 + h4, x4: x4 + w4] = L
    return L


def build_schedule_ref(seq, hdr, plans, filter_type_fn):
    """Build the wavefront schedule for an ALL-INTRA frame.

    `filter_type_fn(mi_r, mi_c, plane, have_above, have_left)` supplies
    the neighbor-smoothness filter type (static mi-grid logic, shared
    with FrameRecon).  Returns None if the frame has inter/intrabc
    blocks (caller falls back to the serial path).
    """
    if plans.grid("is_inter").any() or plans.grid("intrabc").any():
        return None
    sch = Schedule(seq, hdr, plans)
    mi_cols = plans.mi_cols
    uv_mode_grid = plans.grid("uv_mode")
    mi_rows = plans.mi_rows
    g4 = [np.zeros((mi_rows, mi_cols), np.int32)]
    for _ in range(sch.num_planes - 1):
        g4.append(np.zeros((((mi_rows * 4 >> sch.sub_y) + 3) // 4,
                            ((mi_cols * 4 >> sch.sub_x) + 3) // 4),
                           np.int32))
    sch.n_levels = 0

    mode_g = plans.grid("mode")
    angle_y_g = plans.grid("angle_y")
    angle_uv_g = plans.grid("angle_uv")
    fi_g = plans.grid("filter_intra")
    pal_y_g = plans.grid("palette_y")
    pal_uv_g = plans.grid("palette_uv")
    cfl_signs_g = plans.grid("cfl_signs")
    cfl_idx_g = plans.grid("cfl_alpha_idx")

    from av1dec_tpu.pipeline.recon import FrameRecon, _alpha
    # palette predictions need a FrameRecon helper; reuse a light one
    fr = FrameRecon(seq, hdr, plans)

    for i, rec in enumerate(plans.tx):
        (plane, x4, y4, tx_size, tx_type, eob, coef_off, mi, avail) = \
            [int(v) for v in rec]
        w, h = (4, 4) if tx_size == 19 else TX_DIMS[tx_size]
        mi_r, mi_c = mi // mi_cols, mi % mi_cols
        x, y = x4 * 4, y4 * 4
        sub_x = sch.sub_x if plane else 0
        sub_y = sch.sub_y if plane else 0
        ph, pw = sch.valid_dims[plane]
        max_x, max_y = pw - 1, ph - 1
        have_left = bool(avail & 1)
        have_above = bool(avail & 2)
        have_ar = bool(avail & 4)
        have_bl = bool(avail & 8)
        size = w + h
        bd = sch.bd

        s = dict.fromkeys(_SCALAR_FIELDS, 0)
        s["x"], s["y"], s["plane"] = x, y, plane
        s["base"] = sch.plane_base[plane]
        s["stride"] = sch.alloc_dims[plane][1]
        s["have_above"] = int(have_above)
        s["have_left"] = int(have_left)
        s["res_idx"] = -1
        s["pal_idx"] = -1
        s["fi_mode"] = -1

        # residual slot
        if eob > 0:
            key = (w, h)
            s["res_idx"] = sch.res_count.get(key, 0)
            sch.res_count[key] = s["res_idx"] + 1
            sch.res_recs.setdefault(key, []).append(i)

        # --- edge construction cases (mirror intra.predict_intra)
        if not have_above and have_left:
            s["above_case"] = 1           # replicate frame[y, x-1]
        elif not have_above and not have_left:
            s["above_case"] = 2           # constant (1<<(bd-1))-1
        else:
            s["above_case"] = 0
            s["above_lim"] = min(max_x, x + (2 * w if have_ar else w) - 1)
        if not have_left and have_above:
            s["left_case"] = 1            # replicate frame[y-1, x]
        elif not have_left and not have_above:
            s["left_case"] = 2            # constant (1<<(bd-1))+1
        else:
            s["left_case"] = 0
            s["left_lim"] = min(max_y, y + (2 * h if have_bl else h) - 1)
        if have_above and have_left:
            s["corner_case"] = 0
        elif have_above:
            s["corner_case"] = 1
        elif have_left:
            s["corner_case"] = 2
        else:
            s["corner_case"] = 3

        # --- mode classification
        use_palette = (pal_y_g if plane == 0 else pal_uv_g)[mi_r, mi_c] > 0
        fi_mode = int(fi_g[mi_r, mi_c]) if plane == 0 else -1
        mode = int((mode_g if plane == 0 else uv_mode_grid)[mi_r, mi_c])
        angle = int((angle_y_g if plane == 0 else angle_uv_g)[mi_r, mi_c])
        is_cfl = plane > 0 and mode == UV_CFL_PRED

        key = (w, h)
        if use_palette:
            pred = fr._palette_pred(plane, mi_r, mi_c, x, y, w, h)
            s["mode_family"] = MF_PAL
            s["pal_idx"] = len(sch.pal_preds.setdefault(key, []))
            sch.pal_preds[key].append(pred.astype(np.int32))
        elif fi_mode >= 0:
            s["mode_family"] = MF_FI
            s["fi_mode"] = fi_mode
        elif is_cfl or mode == intra.DC_PRED:
            s["mode_family"] = MF_DC
            s["dc_case"] = (0 if (have_above and have_left) else
                            1 if have_above else 2 if have_left else 3)
            if is_cfl:
                signs = int(cfl_signs_g[mi_r, mi_c])
                aidx = int(cfl_idx_g[mi_r, mi_c])
                s["cfl_alpha"] = _alpha(signs, aidx, plane)
                s["cfl_maxx"] = min((x + w) << sub_x,
                                    plans.mi_cols * 4) - (1 << sub_x)
                s["cfl_maxy"] = min((y + h) << sub_y,
                                    plans.mi_rows * 4) - (1 << sub_y)
        elif mode in (intra.SMOOTH_PRED, intra.SMOOTH_V_PRED,
                      intra.SMOOTH_H_PRED):
            s["mode_family"] = {intra.SMOOTH_PRED: MF_SMOOTH,
                                intra.SMOOTH_V_PRED: MF_SMOOTH_V,
                                intra.SMOOTH_H_PRED: MF_SMOOTH_H}[mode]
        elif mode == intra.PAETH_PRED:
            s["mode_family"] = MF_PAETH
        else:
            # directional (V/H with delta 0 included: p_angle 90/180)
            p_angle = intra.MODE_TO_ANGLE[mode] + angle * intra.ANGLE_STEP
            s["p_angle"] = p_angle
            ftype = filter_type_fn(mi_r, mi_c, plane, have_above, have_left)
            if p_angle == 90:
                s["mode_family"] = MF_V
            elif p_angle == 180:
                s["mode_family"] = MF_H
            else:
                s["mode_family"] = MF_DIR
                if sch.enable_edge_filter:
                    if 90 < p_angle < 180 and size >= 24:
                        s["corner_filt"] = 1
                    if have_above:
                        s["str_above"] = intra.intra_edge_filter_strength(
                            w, h, ftype, p_angle - 90)
                        s["npx_above"] = min(w, max_x - x + 1) + \
                            (h if p_angle < 90 else 0) + 1
                    if have_left:
                        s["str_left"] = intra.intra_edge_filter_strength(
                            w, h, ftype, p_angle - 180)
                        s["npx_left"] = min(h, max_y - y + 1) + \
                            (w if p_angle > 180 else 0) + 1
                    s["up_above"] = intra.use_intra_edge_upsample(
                        w, h, ftype, p_angle - 90)
                    s["up_left"] = intra.use_intra_edge_upsample(
                        w, h, ftype, p_angle - 180)
                if p_angle < 90:
                    s["dx"] = int(DR_INTRA_DERIVATIVE[p_angle])
                elif p_angle < 180:
                    s["dx"] = int(DR_INTRA_DERIVATIVE[180 - p_angle])
                    s["dy"] = int(DR_INTRA_DERIVATIVE[p_angle - 90])
                else:
                    s["dy"] = int(DR_INTRA_DERIVATIVE[270 - p_angle])

        ext_above = s["mode_family"] == MF_DIR and s["p_angle"] < 90
        ext_left = s["mode_family"] == MF_DIR and s["p_angle"] > 180
        cfl_dep = plane > 0 and mode == UV_CFL_PRED
        lvl = _level_for(g4, plane, x4, y4, w // 4, h // 4, ext_above,
                         ext_left, cfl_dep, sch.sub_x, sch.sub_y)
        if lvl > sch.n_levels:
            sch.n_levels = lvl
        sch.classes.setdefault(key, BlockClass(w, h)).add(lvl, s)
    for bc in sch.classes.values():
        bc.finalize()
    return sch


def compute_residuals(sch):
    """Per-(w, h) residual tensors [N, h, w] (NumPy, batched by tx
    bucket as in FrameRecon._precompute_residuals)."""
    plans, hdr, bd = sch.plans, sch.hdr, sch.bd
    q = hdr["quant"]
    use_qm = bool(q.get("using_qmatrix"))
    qm_by_plane = (q.get("qm_y", 15), q.get("qm_u", 15),
                   q.get("qm_v", 15))
    out = {key: np.zeros((n, key[1], key[0]), np.int32)
           for key, n in sch.res_count.items()}
    # bucket rows of each (w,h) tensor by (tsz, tt)
    buckets = {}
    for key, recs in sch.res_recs.items():
        for slot, i in enumerate(recs):
            rec = plans.tx[i]
            buckets.setdefault((int(rec[3]), int(rec[4])), []).append(
                (key, slot, i))
    g = plans.grid
    qindex_g = g("qindex")
    lossless_g = g("lossless")
    mi_cols = plans.mi_cols
    for (tsz, tt), items in buckets.items():
        w, h = (4, 4) if tsz == 19 else TX_DIMS[tsz]
        aw, ah = (4, 4) if tsz == 19 else (min(w, 32), min(h, 32))
        n = aw * ah
        B = len(items)
        qm_ok = use_qm and tt < 9  # qm only for 2-D transforms
        idxa = np.fromiter((i for _, _, i in items), np.int64, B)
        recs = np.asarray(plans.tx, np.int64)[idxa]
        offs = recs[:, 6]
        levels = np.asarray(plans.coeffs, np.int64)[
            offs[:, None] + np.arange(n)]
        mi_r, mi_c = recs[:, 7] // mi_cols, recs[:, 7] % mi_cols
        qidx = qindex_g[mi_r, mi_c].astype(np.int64)
        lossless = lossless_g[mi_r, mi_c].astype(bool)
        plane = recs[:, 0]
        dcd = np.choose(np.minimum(plane, 2),
                        [q["delta_q_y_dc"], q["delta_q_u_dc"],
                         q["delta_q_v_dc"]])
        acd = np.choose(np.minimum(plane, 2),
                        [0, q["delta_q_u_ac"], q["delta_q_v_ac"]])
        qml = np.where(qm_ok & ~lossless,
                       np.asarray(qm_by_plane)[np.minimum(plane, 2)], 15)
        qmc = (plane >= 1) & (qml < 15)
        if tsz == 19 or lossless.any():
            from av1dec_tpu.ops.qm_data import qm_row
            for b, (key, slot, i) in enumerate(items):
                dq = dequant.dequant_block(
                    levels[b], tsz, int(qidx[b]), bd,
                    int(dcd[b]), int(acd[b]), bool(lossless[b]),
                    qm=qm_row(int(qml[b]), bool(qmc[b]), w, h))
                out[key][slot] = itx.inverse_transform(dq, tsz, tt, bd)
            continue
        dq = dequant.dequant_batch(levels, tsz, qidx, bd, dcd, acd,
                                   qm_levels=qml, qm_chroma=qmc)
        res = itx.inverse_transform_lanes(dq, tsz, tt, bd)
        for b, (key, slot, i) in enumerate(items):
            out[key][slot] = res[b]
    return out


# ---------------------------------------------------------------------------
# NumPy executor (oracle for the device executor; shares its structure)
# ---------------------------------------------------------------------------

def _gather_edges(frame, sv, w, h, bd):
    """Vectorized AboveRow/LeftCol construction for B blocks.

    frame: flat int32 frame buffer.  sv: dict of [B] scalars.
    Returns (above [B, size+1], left [B, size+1]) with spec offset-1
    layout (index 0 = corner)."""
    B = len(sv["x"])
    size = w + h
    x, y = sv["x"], sv["y"]
    base, stride = sv["base"], sv["stride"]
    i = np.arange(size)
    # above
    cols = np.minimum(x[:, None] + i[None, :], sv["above_lim"][:, None])
    idx_a = base[:, None] + (y[:, None] - 1) * stride[:, None] + cols
    idx_rep_a = base + y * stride + (x - 1)            # frame[y, x-1]
    idx_a = np.where((sv["above_case"] == 1)[:, None],
                     idx_rep_a[:, None], idx_a)
    safe_a = np.where((sv["above_case"] == 2)[:, None], 0, idx_a)
    above_v = frame[safe_a]
    above_v = np.where((sv["above_case"] == 2)[:, None],
                       (1 << (bd - 1)) - 1, above_v)
    # left
    rows = np.minimum(y[:, None] + i[None, :], sv["left_lim"][:, None])
    idx_l = base[:, None] + rows * stride[:, None] + (x - 1)[:, None]
    idx_rep_l = base + (y - 1) * stride + x            # frame[y-1, x]
    idx_l = np.where((sv["left_case"] == 1)[:, None],
                     idx_rep_l[:, None], idx_l)
    safe_l = np.where((sv["left_case"] == 2)[:, None], 0, idx_l)
    left_v = frame[safe_l]
    left_v = np.where((sv["left_case"] == 2)[:, None],
                      (1 << (bd - 1)) + 1, left_v)
    # corner
    cc = sv["corner_case"]
    idx_c = np.where(cc == 0, base + (y - 1) * stride + (x - 1),
                     np.where(cc == 1, base + (y - 1) * stride + x,
                              base + y * stride + (x - 1)))
    corner = np.where(cc == 3, 1 << (bd - 1), frame[np.where(cc == 3, 0,
                                                             idx_c)])
    above = np.concatenate([corner[:, None], above_v], axis=1)
    left = np.concatenate([corner[:, None], left_v], axis=1)
    return above, left


def _edge_filter_batch(edge, npx, strength):
    """Vectorized intra_edge_filter: edge [B, n], per-lane npx/strength.
    Entries 1..npx-1 smoothed over the ORIGINAL edge (clamped window);
    strength 0 lanes unchanged."""
    B, n = edge.shape
    i = np.arange(n)
    out = edge.copy()
    acc = np.zeros_like(edge)
    # kernel selected per lane: row 0 of INTRA_EDGE_KERNELS is strength 1
    kern = np.concatenate([np.zeros((1, 5), np.int64),
                           intra.INTRA_EDGE_KERNELS], axis=0)
    kv = kern[np.clip(strength, 0, 3)]           # [B, 5]
    for j in range(5):
        k = np.clip(i[None, :] - 2 + j, 0, np.maximum(npx, 1)[:, None] - 1)
        acc += kv[:, j][:, None] * np.take_along_axis(edge, k, axis=1)
    sm = (acc + 8) >> 4
    upd = (strength > 0)[:, None] & (i[None, :] >= 1) & \
        (i[None, :] < npx[:, None])
    return np.where(upd, sm, out)


def _upsample_batch(edge, npx, bd):
    """Vectorized intra_edge_upsample: edge [B, size+1] (offset-1:
    edge[:,0] is p[-1]); per-lane sz=npx.  Returns [B, 2*size+2] where
    out[:, k] == upsampled p[k-2] (offset-2 layout)."""
    B, n = edge.shape
    size = n - 1
    # inb[i] for i in 0..sz+2: [edge0, edge0, edge1..edge_sz, edge_sz]
    i = np.arange(size + 3)
    src = np.minimum(np.maximum(i[None, :] - 1, 0), npx[:, None])
    inb = np.take_along_axis(edge, src, axis=1)
    out = np.zeros((B, 2 * size + 2), np.int64)
    out[:, 0] = inb[:, 0]
    ii = np.arange(size)
    s = (-inb[:, :size] + 9 * inb[:, 1:size + 1] +
         9 * inb[:, 2:size + 2] - inb[:, 3:size + 3])
    s = np.clip((s + 8) >> 4, 0, (1 << bd) - 1)
    out[:, 2 * ii + 1] = s
    out[:, 2 * ii + 2] = inb[:, 2:size + 2]
    return out


def _dir_lut(edge, edge_up, up, npx_u):
    """Unified directional lookup table: lut[:, k] == abv(k-2) for the
    spec abv()/lft() accessor (idx from -2).  edge [B, size+1] offset-1,
    edge_up [B, 2*size+2] offset-2."""
    B, n = edge.shape
    size = n - 1
    lutlen = 2 * size + 3
    k = np.arange(lutlen)
    # non-upsampled: abv(idx) = edge[idx+1] -> lut[k] = edge[k-1]
    idx_n = np.clip(k[None, :] - 1, 0, size)
    lut_n = np.take_along_axis(edge, idx_n, axis=1)
    # upsampled: abv(idx) = edge_up[idx+2] for idx+2 < 2*npx_u+2,
    # else edge[min(size, npx_u + 1)]
    idx_u = np.minimum(k[None, :], 2 * size + 1)
    lut_u = np.take_along_axis(edge_up, idx_u, axis=1)
    tail = np.take_along_axis(
        edge, np.minimum(size, npx_u + 1)[:, None], axis=1)
    lut_u = np.where(k[None, :] < (2 * npx_u + 2)[:, None], lut_u, tail)
    return np.where((up > 0)[:, None], lut_u, lut_n)


def _predict_dir(above, left, sv, w, h, bd, enable_edge_filter):
    """Vectorized _directional for a [B] batch (p_angle != 90/180)."""
    B = above.shape[0]
    size = w + h
    p_angle = sv["p_angle"]
    if enable_edge_filter:
        do_c = sv["corner_filt"] > 0
        cv = (left[:, 1] * 5 + above[:, 0] * 6 + above[:, 1] * 5 + 8) >> 4
        above[:, 0] = np.where(do_c, cv, above[:, 0])
        left[:, 0] = np.where(do_c, cv, left[:, 0])
        above = _edge_filter_batch(above, sv["npx_above"], sv["str_above"])
        left = _edge_filter_batch(left, sv["npx_left"], sv["str_left"])
    up_a, up_l = sv["up_above"], sv["up_left"]
    npx_a = w + np.where(p_angle < 90, h, 0)
    npx_l = h + np.where(p_angle > 180, w, 0)
    above_u = _upsample_batch(above, npx_a, bd)
    left_u = _upsample_batch(left, npx_l, bd)
    lutA = _dir_lut(above, above_u, up_a, npx_a)
    lutL = _dir_lut(left, left_u, up_l, npx_l)

    jj = np.arange(w)[None, None, :]
    ii = np.arange(h)[None, :, None]
    dx = sv["dx"][:, None, None]
    dy = sv["dy"][:, None, None]
    ua = up_a[:, None, None]
    ul = up_l[:, None, None]
    pa = p_angle[:, None, None]
    out = np.zeros((B, h, w), np.int64)

    # zone 1: p_angle < 90
    idx1 = (ii + 1) * dx
    base1 = (idx1 >> (6 - ua)) + (jj << ua)
    max_base_x = (size - 1) << ua
    shift1 = ((idx1 << ua) >> 1) & 0x1F
    b1c = np.minimum(base1, max_base_x)
    v1 = np.take_along_axis(lutA, (b1c + 2).reshape(B, -1), axis=1) \
        .reshape(B, h, w) * (32 - shift1) + \
        np.take_along_axis(lutA, np.minimum(b1c + 3, 2 * size + 2)
                           .reshape(B, -1), axis=1).reshape(B, h, w) * shift1
    z1 = np.where(base1 < max_base_x, (v1 + 16) >> 5,
                  np.take_along_axis(lutA, (max_base_x + 2).reshape(B, -1),
                                     axis=1).reshape(B, 1, 1))

    # zone 2: 90 < p_angle < 180 (two-sided)
    idx2 = (jj << 6) - (ii + 1) * dx
    base2 = idx2 >> (6 - ua)
    shift2 = ((idx2 << ua) >> 1) & 0x1F
    b2c = np.clip(base2, -2, size * 2)
    va = np.take_along_axis(lutA, (b2c + 2).reshape(B, -1), axis=1) \
        .reshape(B, h, w) * (32 - shift2) + \
        np.take_along_axis(lutA, np.minimum(b2c + 3, 2 * size + 2)
                           .reshape(B, -1), axis=1).reshape(B, h, w) * shift2
    idx2l = (ii << 6) - (jj + 1) * dy
    base2l = idx2l >> (6 - ul)
    shift2l = ((idx2l << ul) >> 1) & 0x1F
    b2lc = np.clip(base2l, -2, size * 2)
    vl = np.take_along_axis(lutL, (b2lc + 2).reshape(B, -1), axis=1) \
        .reshape(B, h, w) * (32 - shift2l) + \
        np.take_along_axis(lutL, np.minimum(b2lc + 3, 2 * size + 2)
                           .reshape(B, -1), axis=1).reshape(B, h, w) \
        * shift2l
    z2 = np.where(base2 >= -(1 << ua), (va + 16) >> 5, (vl + 16) >> 5)

    # zone 3: p_angle > 180
    idx3 = (jj + 1) * dy
    base3 = (idx3 >> (6 - ul)) + (ii << ul)
    max_base_y = (size - 1) << ul
    shift3 = ((idx3 << ul) >> 1) & 0x1F
    b3c = np.minimum(base3, max_base_y)
    v3 = np.take_along_axis(lutL, (b3c + 2).reshape(B, -1), axis=1) \
        .reshape(B, h, w) * (32 - shift3) + \
        np.take_along_axis(lutL, np.minimum(b3c + 3, 2 * size + 2)
                           .reshape(B, -1), axis=1).reshape(B, h, w) * shift3
    z3 = np.where(base3 < max_base_y, (v3 + 16) >> 5,
                  np.take_along_axis(lutL, (max_base_y + 2).reshape(B, -1),
                                     axis=1).reshape(B, 1, 1))

    out = np.where(pa < 90, z1, np.where(pa < 180, z2, z3))
    return out


def _predict_fi(above, left, sv, w, h, bd):
    """Filter-intra for a batch (serial patch recursion per block)."""
    B = above.shape[0]
    out = np.zeros((B, h, w), np.int64)
    for b in range(B):
        out[b] = intra._filter_intra(above[b], left[b], w, h,
                                     int(sv["fi_mode"][b]), bd)
    return out


def _predict_level(frame, sv, w, h, bd, enable_edge_filter, pal_preds,
                   sub_x, sub_y):
    """Compute predictions for one (level, class) batch. frame: flat."""
    above, left = _gather_edges(frame, sv, w, h, bd)
    mf = sv["mode_family"]
    B = above.shape[0]
    out = np.zeros((B, h, w), np.int64)

    m_dir = mf == MF_DIR
    if m_dir.any():
        idx = np.where(m_dir)[0]
        svd = {f: sv[f][idx] for f in _SCALAR_FIELDS}
        out[idx] = _predict_dir(above[idx].copy(), left[idx].copy(), svd,
                                w, h, bd, enable_edge_filter)
    m = mf == MF_V
    if m.any():
        out[m] = np.broadcast_to(above[m][:, None, 1:1 + w], (m.sum(), h, w))
    m = mf == MF_H
    if m.any():
        out[m] = np.broadcast_to(left[m][:, 1:1 + h, None], (m.sum(), h, w))
    m = mf == MF_DC
    if m.any():
        dc_case = sv["dc_case"][m]
        s_a = above[m][:, 1:1 + w].sum(1)
        s_l = left[m][:, 1:1 + h].sum(1)
        avg = np.where(
            dc_case == 0, (s_a + s_l + ((w + h) >> 1)) // (w + h),
            np.where(dc_case == 1, (s_a + (w >> 1)) >> int(np.log2(w)),
                     np.where(dc_case == 2,
                              (s_l + (h >> 1)) >> int(np.log2(h)),
                              1 << (bd - 1))))
        pred = np.broadcast_to(avg[:, None, None], (m.sum(), h, w)).copy()
        # CfL adjustment
        alpha = sv["cfl_alpha"][m]
        has_cfl = alpha != 0
        sv_cfl_any = (sv["cfl_maxx"][m] > 0)
        need = has_cfl | sv_cfl_any
        if need.any():
            pred[need] = _cfl_adjust(frame, pred[need],
                                     {f: sv[f][m][need]
                                      for f in _SCALAR_FIELDS},
                                     w, h, bd, sub_x, sub_y)
        out[m] = pred
    for fam, smode in ((MF_SMOOTH, intra.SMOOTH_PRED),
                       (MF_SMOOTH_V, intra.SMOOTH_V_PRED),
                       (MF_SMOOTH_H, intra.SMOOTH_H_PRED)):
        m = mf == fam
        if m.any():
            out[m] = _smooth_batch(above[m], left[m], w, h, smode)
    m = mf == MF_PAETH
    if m.any():
        out[m] = _paeth_batch(above[m], left[m], w, h)
    m = mf == MF_PAL
    if m.any():
        idxs = sv["pal_idx"][m]
        out[m] = np.stack([pal_preds[(w, h)][int(t)] for t in idxs])
    m = mf == MF_FI
    if m.any():
        out[m] = _predict_fi(above[m], left[m],
                             {f: sv[f][m] for f in _SCALAR_FIELDS},
                             w, h, bd)
    return out


def _cfl_adjust(frame, pred, sv, w, h, bd, sub_x, sub_y):
    """Batched CfL: subsample co-located recon luma, remove average,
    scale by alpha, add to the DC prediction. [SPEC §7.11.5]"""
    B = pred.shape[0]
    # luma plane is plane 0: base 0; its alloc stride equals the chroma
    # stride << sub_x
    lstride = sv["stride"] << sub_x
    ii = np.arange(h)[None, :, None]
    jj = np.arange(w)[None, None, :]
    ly = np.minimum((sv["y"][:, None, None] + ii) << sub_y,
                    sv["cfl_maxy"][:, None, None])
    lx = np.minimum((sv["x"][:, None, None] + jj) << sub_x,
                    sv["cfl_maxx"][:, None, None])
    b = ly * lstride[:, None, None] + lx
    if sub_x and sub_y:
        t = (frame[b] + frame[b + 1] + frame[b + lstride[:, None, None]] +
             frame[b + lstride[:, None, None] + 1]) << 1
    elif sub_x:
        t = (frame[b] + frame[b + 1]) << 2
    else:
        t = frame[b] << 3
    shift = int(np.log2(w)) + int(np.log2(h))
    avg = (t.reshape(B, -1).sum(1) + (1 << (shift - 1))) >> shift
    ac = t - avg[:, None, None]
    alpha = sv["cfl_alpha"][:, None, None]
    scaled = intra.round2_signed(alpha * ac, 6)
    return np.clip(pred + scaled, 0, (1 << bd) - 1)


def _smooth_batch(above, left, w, h, mode):
    sw_w = SM_WEIGHTS[w: w + w].astype(np.int64)[None, None, :]
    sw_h = SM_WEIGHTS[h: h + h].astype(np.int64)[None, :, None]
    a = above[:, None, 1:1 + w].astype(np.int64)
    l = left[:, 1:1 + h, None].astype(np.int64)
    right = above[:, w][:, None, None]
    bottom = left[:, h][:, None, None]
    if mode == intra.SMOOTH_PRED:
        sm = (sw_h * a + (256 - sw_h) * bottom +
              sw_w * l + (256 - sw_w) * right)
        return (sm + 256) >> 9
    if mode == intra.SMOOTH_V_PRED:
        return (sw_h * a + (256 - sw_h) * bottom + 128) >> 8
    return (sw_w * l + (256 - sw_w) * right + 128) >> 8


def _paeth_batch(above, left, w, h):
    a = above[:, None, 1:1 + w]
    l = left[:, 1:1 + h, None]
    tl = above[:, 0][:, None, None]
    base = a + l - tl
    pa = np.abs(base - a)
    pl = np.abs(base - l)
    ptl = np.abs(base - tl)
    sh = (a.shape[0], h, w)
    return np.where((pa <= pl) & (pa <= ptl), np.broadcast_to(a, sh),
                    np.where(pl <= ptl, np.broadcast_to(l, sh),
                             np.broadcast_to(tl, sh))).astype(np.int64)


class WavefrontRecon:
    """NumPy wavefront executor — same output as FrameRecon for
    all-intra frames, restructured level-batch-wise (the structural
    oracle for the device executor)."""

    def __init__(self, seq, hdr, plans):
        from av1dec_tpu.pipeline.recon import FrameRecon
        self._fr = FrameRecon(seq, hdr, plans)  # for postfilter + helpers
        self.sch = build_schedule(seq, hdr, plans, self._fr._filter_type)

    def run(self):
        sch = self.sch
        if sch is None:
            return self._fr.run()
        bd = sch.bd
        residuals = compute_residuals(sch)
        frame = np.zeros(sch.flat_len, np.int64)
        for lvl in range(1, sch.n_levels + 1):
            for key, bc in sch.classes.items():
                sv = bc.at_level(lvl)
                if sv is None:
                    continue
                w, h = key
                pred = _predict_level(frame, sv, w, h, bd,
                                      sch.enable_edge_filter,
                                      sch.pal_preds, sch.sub_x, sch.sub_y)
                ridx = sv["res_idx"]
                has_r = ridx >= 0
                if has_r.any():
                    res = residuals[key][np.maximum(ridx, 0)]
                    pred = np.where(has_r[:, None, None],
                                    np.clip(pred + res, 0,
                                            (1 << bd) - 1), pred)
                # scatter
                ii = np.arange(h)[None, :, None]
                jj = np.arange(w)[None, None, :]
                fidx = (sv["base"][:, None, None] +
                        (sv["y"][:, None, None] + ii) *
                        sv["stride"][:, None, None] +
                        sv["x"][:, None, None] + jj)
                frame[fidx.reshape(-1)] = pred.reshape(-1)
        # unpack planes into the FrameRecon alloc views, then postfilter
        fr = self._fr
        for p in range(sch.num_planes):
            ha, wa = sch.alloc_dims[p]
            b = sch.plane_base[p]
            fr._alloc[p][...] = frame[b: b + ha * wa].reshape(ha, wa)
        fr._postfilter()
        return fr.planes


# ---------------------------------------------------------------------------
# Vectorized schedule builder (numpy field assembly + native level DP)
# ---------------------------------------------------------------------------

_W_LUT = np.array([TX_DIMS[t][0] for t in range(19)] + [4], np.int32)
_H_LUT = np.array([TX_DIMS[t][1] for t in range(19)] + [4], np.int32)
_M2A = np.array(intra.MODE_TO_ANGLE + [0], np.int32)

# strength/upsample LUTs over (filter_type, blk_wh, |delta|)
_STR_LUT = None
_UP_LUT = None


def _edge_luts():
    global _STR_LUT, _UP_LUT
    if _STR_LUT is None:
        s = np.zeros((2, 129, 181), np.int8)
        u = np.zeros((2, 129, 181), np.int8)
        for ft in range(2):
            for wh in range(129):
                for d in range(181):
                    s[ft, wh, d] = intra.intra_edge_filter_strength(
                        wh // 2, wh - wh // 2, ft, d)
                    u[ft, wh, d] = intra.use_intra_edge_upsample(
                        wh // 2, wh - wh // 2, ft, d)
        _STR_LUT, _UP_LUT = s, u
    return _STR_LUT, _UP_LUT


def build_schedule_fast(seq, hdr, plans, filter_type_fn=None,
                        allow_inter=False):
    """Vectorized build_schedule: same Schedule, numpy field assembly
    over the whole tx-record array + native ASAP level DP
    (bindings.wavefront_levels).  `filter_type_fn` is unused (the
    neighbor-smoothness filter type is computed from the mi grids
    directly); kept for signature compatibility.

    With `allow_inter`, mixed frames build too: inter tx records become
    MF_INTER residual-add lanes at level 1 (their predictions are
    written by the MC pass before the scan; records with eob == 0 need
    no lane at all), and intra blocks schedule after them."""
    if plans is None or plans.grid("intrabc").any():
        return None
    if plans.grid("is_inter").any() and not allow_inter:
        return None
    from av1dec_tpu.bindings import wavefront_levels
    sch = Schedule(seq, hdr, plans)
    mi_cols, mi_rows = plans.mi_cols, plans.mi_rows
    tx = np.asarray(plans.tx, np.int64)
    if len(tx) == 0:
        return None
    inter_g = plans.grid("is_inter")
    mi_all = tx[:, 7]
    rec_inter_all = inter_g[(mi_all // mi_cols).astype(np.int64),
                            (mi_all % mi_cols).astype(np.int64)] != 0
    sch.has_inter = bool(rec_inter_all.any())
    # inter records without residual need no lane (MC already wrote
    # their final pixels); res_recs must keep ORIGINAL plans.tx indices
    keep = ~rec_inter_all | (tx[:, 5] > 0)
    orig_idx = np.nonzero(keep)[0]
    tx = tx[keep]
    N = len(tx)
    if N == 0:
        # every block is a skipped inter block: nothing to scan
        sch.n_levels = 0
        return sch
    plane = tx[:, 0].astype(np.int32)
    x4, y4 = tx[:, 1].astype(np.int32), tx[:, 2].astype(np.int32)
    tsz, tt, eob = tx[:, 3], tx[:, 4], tx[:, 5]
    mi, avail = tx[:, 7], tx[:, 8]
    w = _W_LUT[tsz]
    h = _H_LUT[tsz]
    mi_r, mi_c = (mi // mi_cols).astype(np.int64), \
        (mi % mi_cols).astype(np.int64)
    rec_inter = inter_g[mi_r, mi_c] != 0
    intra_rec = ~rec_inter
    x, y = x4 * 4, y4 * 4
    have_left = ((avail & 1) != 0) & intra_rec
    have_above = ((avail & 2) != 0) & intra_rec
    have_ar = ((avail & 4) != 0) & intra_rec
    have_bl = ((avail & 8) != 0) & intra_rec

    F = {f: np.zeros(N, np.int64) for f in _SCALAR_FIELDS}
    F["x"], F["y"], F["plane"] = x, y, plane
    pb = np.asarray(sch.plane_base + [0] * (3 - len(sch.plane_base)))
    st = np.asarray([a[1] for a in sch.alloc_dims] + [0] * 3)[:3]
    vw = np.asarray([a[1] for a in sch.valid_dims] + [0] * 3)[:3]
    vh = np.asarray([a[0] for a in sch.valid_dims] + [0] * 3)[:3]
    F["base"] = pb[plane]
    F["stride"] = st[plane]
    max_x, max_y = vw[plane] - 1, vh[plane] - 1
    F["have_above"] = have_above.astype(np.int64)
    F["have_left"] = have_left.astype(np.int64)
    F["res_idx"] = np.full(N, -1)
    F["pal_idx"] = np.full(N, -1)
    F["fi_mode"] = np.full(N, -1)

    F["above_case"] = np.where(have_above, 0, np.where(have_left, 1, 2))
    F["above_lim"] = np.where(
        have_above,
        np.minimum(max_x, x + np.where(have_ar, 2 * w, w) - 1), 0)
    F["left_case"] = np.where(have_left, 0, np.where(have_above, 1, 2))
    F["left_lim"] = np.where(
        have_left,
        np.minimum(max_y, y + np.where(have_bl, 2 * h, h) - 1), 0)
    F["corner_case"] = np.where(
        have_above & have_left, 0,
        np.where(have_above, 1, np.where(have_left, 2, 3)))

    # grids gathered at the block's mi cell
    g = plans.grid
    mode = np.where(plane == 0, g("mode")[mi_r, mi_c],
                    g("uv_mode")[mi_r, mi_c]).astype(np.int64)
    angle = np.where(plane == 0, g("angle_y")[mi_r, mi_c],
                     g("angle_uv")[mi_r, mi_c]).astype(np.int64)
    fi_mode = np.where(plane == 0, g("filter_intra")[mi_r, mi_c],
                       -1).astype(np.int64)
    use_pal = (np.where(plane == 0, g("palette_y")[mi_r, mi_c],
                        g("palette_uv")[mi_r, mi_c]) > 0) & intra_rec
    is_cfl = (plane > 0) & (mode == UV_CFL_PRED) & intra_rec

    mf_pal = use_pal
    mf_fi = ~mf_pal & (fi_mode >= 0) & intra_rec
    mf_dc = ~mf_pal & ~mf_fi & (is_cfl | (mode == intra.DC_PRED)) & \
        intra_rec
    mf_smooth = ~mf_pal & ~mf_fi & ~mf_dc & \
        (mode >= intra.SMOOTH_PRED) & (mode <= intra.SMOOTH_H_PRED) & \
        intra_rec
    mf_paeth = ~mf_pal & ~mf_fi & ~mf_dc & ~mf_smooth & \
        (mode == intra.PAETH_PRED) & intra_rec
    mf_dirish = ~(mf_pal | mf_fi | mf_dc | mf_smooth | mf_paeth) & \
        intra_rec

    p_angle = np.where(mf_dirish,
                       _M2A[np.minimum(mode, 12)] +
                       angle * intra.ANGLE_STEP, 0)
    mf_v = mf_dirish & (p_angle == 90)
    mf_h = mf_dirish & (p_angle == 180)
    mf_dir = mf_dirish & ~mf_v & ~mf_h

    fam = np.zeros(N, np.int64)
    fam[rec_inter] = MF_INTER
    fam[mf_pal] = MF_PAL
    fam[mf_fi] = MF_FI
    fam[mf_dc] = MF_DC
    fam[mf_smooth] = np.where(
        mode[mf_smooth] == intra.SMOOTH_PRED, MF_SMOOTH,
        np.where(mode[mf_smooth] == intra.SMOOTH_V_PRED, MF_SMOOTH_V,
                 MF_SMOOTH_H))
    fam[mf_paeth] = MF_PAETH
    fam[mf_v] = MF_V
    fam[mf_h] = MF_H
    fam[mf_dir] = MF_DIR
    F["mode_family"] = fam
    F["p_angle"] = p_angle
    F["fi_mode"] = np.where(mf_fi, fi_mode, -1)

    # DC case + CfL
    F["dc_case"] = np.where(
        ~mf_dc, 0,
        np.where(have_above & have_left, 0,
                 np.where(have_above, 1, np.where(have_left, 2, 3))))
    if is_cfl.any():
        from av1dec_tpu.pipeline.recon import _alpha
        signs = g("cfl_signs")[mi_r, mi_c].astype(np.int64)
        aidx = g("cfl_alpha_idx")[mi_r, mi_c].astype(np.int64)
        sgn = np.where(plane == 1, (signs + 1) // 3, (signs + 1) % 3)
        mag = np.where(plane == 1, (aidx >> 4) & 15, aidx & 15) + 1
        alpha = np.where(sgn == 0, 0, np.where(sgn == 1, -mag, mag))
        F["cfl_alpha"] = np.where(is_cfl & mf_dc, alpha, 0)
        F["cfl_maxx"] = np.where(
            is_cfl & mf_dc,
            np.minimum((x + w) << sch.sub_x, mi_cols * 4) -
            (1 << sch.sub_x), 0)
        F["cfl_maxy"] = np.where(
            is_cfl & mf_dc,
            np.minimum((y + h) << sch.sub_y, mi_rows * 4) -
            (1 << sch.sub_y), 0)

    # directional: edge filter params + gradients
    if mf_dir.any():
        size = w + h
        if sch.enable_edge_filter:
            F["corner_filt"] = (mf_dir & (p_angle > 90) &
                                (p_angle < 180) & (size >= 24)) \
                .astype(np.int64)
            # neighbor-smoothness filter type [SPEC §7.11.2.8]
            sm_y = np.isin(g("mode"), (9, 10, 11)) & \
                (g("is_inter") == 0)
            sm_uv = np.isin(g("uv_mode"), (9, 10, 11)) & \
                (g("is_inter") == 0)

            def smooth_at(r, c, chroma):
                ok = (r >= 0) & (c >= 0) & (r < mi_rows) & (c < mi_cols)
                rr = np.clip(r, 0, mi_rows - 1)
                cc = np.clip(c, 0, mi_cols - 1)
                v = np.where(chroma, sm_uv[rr, cc], sm_y[rr, cc])
                return np.where(ok, v, False)

            chroma = plane > 0
            a_r = np.where(chroma, (mi_r & ~sch.sub_y) - 1, mi_r - 1)
            a_c = np.where(chroma, mi_c | sch.sub_x, mi_c)
            l_r = np.where(chroma, mi_r | sch.sub_y, mi_r)
            l_c = np.where(chroma, (mi_c & ~sch.sub_x) - 1, mi_c - 1)
            ftype = ((have_above & smooth_at(a_r, a_c, chroma)) |
                     (have_left & smooth_at(l_r, l_c, chroma))) \
                .astype(np.int64)
            sLUT, uLUT = _edge_luts()
            d_a = np.abs(p_angle - 90)
            d_l = np.abs(p_angle - 180)
            whc = np.minimum(size, 128)
            F["str_above"] = np.where(
                mf_dir & have_above, sLUT[ftype, whc, d_a], 0)
            F["npx_above"] = np.where(
                mf_dir & have_above,
                np.minimum(w, max_x - x + 1) +
                np.where(p_angle < 90, h, 0) + 1, 0)
            F["str_left"] = np.where(
                mf_dir & have_left, sLUT[ftype, whc, d_l], 0)
            F["npx_left"] = np.where(
                mf_dir & have_left,
                np.minimum(h, max_y - y + 1) +
                np.where(p_angle > 180, w, 0) + 1, 0)
            F["up_above"] = np.where(mf_dir, uLUT[ftype, whc, d_a], 0)
            F["up_left"] = np.where(mf_dir, uLUT[ftype, whc, d_l], 0)
        dr = np.asarray(DR_INTRA_DERIVATIVE, np.int64)
        nd = len(dr) - 1
        pa = np.clip(p_angle, 0, 270)

        def drl(idx):
            return dr[np.clip(idx, 0, nd)]

        F["dx"] = np.where(
            mf_dir & (p_angle < 90), drl(pa),
            np.where(mf_dir & (p_angle < 180), drl(np.abs(180 - pa)), 0))
        F["dy"] = np.where(
            mf_dir & (p_angle > 90) & (p_angle < 180),
            drl(np.abs(pa - 90)),
            np.where(mf_dir & (p_angle > 180), drl(np.abs(270 - pa)), 0))

    # levels via the native DP (inter lanes: no deps, level 1)
    ext_above = mf_dir & (p_angle < 90)
    ext_left = mf_dir & (p_angle > 180)
    levels, n_levels = wavefront_levels(
        plane, x4, y4, w // 4, h // 4, ext_above, ext_left, is_cfl,
        mi_rows, mi_cols, sch.sub_x, sch.sub_y, sch.num_planes,
        skip_dep=rec_inter)
    sch.n_levels = n_levels
    levels = levels.astype(np.int64)

    # per-class slot assignment (tx order within class, like the scalar
    # builder) + class assembly
    class_key = (w.astype(np.int64) << 8) | h.astype(np.int64)
    for key_packed in np.unique(class_key):
        kw, kh = int(key_packed) >> 8, int(key_packed) & 0xFF
        key = (kw, kh)
        sel = np.where(class_key == key_packed)[0]
        # residual slots (res_recs carry ORIGINAL plans.tx indices)
        res_sel = sel[eob[sel] > 0]
        F["res_idx"][res_sel] = np.arange(len(res_sel))
        if len(res_sel):
            sch.res_count[key] = len(res_sel)
            sch.res_recs[key] = orig_idx[res_sel].tolist()
        # palette predictions (rare: scalar loop)
        pal_sel = sel[use_pal[sel]]
        if len(pal_sel):
            from av1dec_tpu.pipeline.recon import FrameRecon
            fr = FrameRecon(seq, hdr, plans)
            F["pal_idx"][pal_sel] = np.arange(len(pal_sel))
            preds = []
            for i in pal_sel:
                preds.append(fr._palette_pred(
                    int(plane[i]), int(mi_r[i]), int(mi_c[i]),
                    int(x[i]), int(y[i]), kw, kh).astype(np.int32))
            sch.pal_preds[key] = preds
        # packed class, sorted by level
        lv = levels[sel]
        order = np.argsort(lv, kind="stable")
        sidx = sel[order]
        bc = BlockClass(kw, kh)
        bc.packed = {f: np.ascontiguousarray(F[f][sidx])
                     for f in _SCALAR_FIELDS}
        bc.levels_sorted = lv[order]
        bc.level_slices = {}
        if len(sidx):
            uniq, starts = np.unique(bc.levels_sorted, return_index=True)
            ends = np.append(starts[1:], len(sidx))
            for u_, s_, e_ in zip(uniq, starts, ends):
                bc.level_slices[int(u_)] = (int(s_), int(e_))
        sch.classes[key] = bc
    return sch


# the vectorized builder is the production path; the scalar builder is
# kept as the structural reference (tests/test_schedule_fast.py asserts
# field-exact equivalence per stream)
build_schedule = build_schedule_fast
