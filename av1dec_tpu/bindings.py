"""ctypes binding to the native front-half (libav1dec_native.so).

The native library is the host C++ half of the decoder: OBU parsing,
header parsing, and (as it lands) the msac entropy decoder emitting plan
tensors.  Header-level data crosses the boundary as JSON; hot plan data as
packed numpy buffers.
"""

from __future__ import annotations

import ctypes as C
import fcntl
import json
import os
import subprocess
from typing import List, Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_LIB_PATH = os.environ.get(
    "AV1DEC_NATIVE_LIB",
    os.path.join(_NATIVE_DIR, "build", "libav1dec_native.so"))

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _make()
    lib = C.CDLL(_LIB_PATH)
    lib.av1n_create.restype = C.c_void_p
    lib.av1n_destroy.argtypes = [C.c_void_p]
    lib.av1n_parse_tu.restype = C.c_int
    lib.av1n_parse_tu.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
    lib.av1n_seq_json.restype = C.c_char_p
    lib.av1n_seq_json.argtypes = [C.c_void_p]
    lib.av1n_frame_json.restype = C.c_char_p
    lib.av1n_frame_json.argtypes = [C.c_void_p, C.c_int]
    lib.av1n_set_decode_tiles.argtypes = [C.c_void_p, C.c_int]
    lib.av1n_set_operating_point.argtypes = [C.c_void_p, C.c_int]
    lib.av1n_set_threads.argtypes = [C.c_void_p, C.c_int]
    lib.av1n_last_error.restype = C.c_char_p
    lib.av1n_last_error.argtypes = [C.c_void_p]
    lib.av1n_state_size.restype = C.c_int64
    lib.av1n_state_size.argtypes = [C.c_void_p]
    lib.av1n_state_save.restype = C.c_int
    lib.av1n_state_save.argtypes = [C.c_void_p, C.c_char_p, C.c_int64]
    lib.av1n_state_restore.restype = C.c_int
    lib.av1n_state_restore.argtypes = [C.c_void_p, C.c_char_p, C.c_int64]
    lib.av1n_plans_shape.restype = C.c_int
    lib.av1n_plans_shape.argtypes = [C.c_void_p, C.c_int,
                                     C.POINTER(C.c_int64)]
    lib.av1n_wavefront_levels.restype = C.c_int
    lib.av1n_wavefront_levels.argtypes = [
        C.c_int] + [C.POINTER(C.c_int32)] * 5 + \
        [C.POINTER(C.c_uint8)] * 3 + [C.c_int] * 5 + \
        [C.POINTER(C.c_int32)] + [C.POINTER(C.c_uint8)]
    for name, rt in [("av1n_plans_mi", C.POINTER(C.c_int16)),
                     ("av1n_plans_tx", C.POINTER(C.c_int32)),
                     ("av1n_plans_coeffs", C.POINTER(C.c_int32)),
                     ("av1n_plans_palettes", C.POINTER(C.c_int32)),
                     ("av1n_plans_color_map", C.POINTER(C.c_uint8)),
                     ("av1n_plans_color_map_off", C.POINTER(C.c_int32)),
                     ("av1n_plans_lr", C.POINTER(C.c_int32)),
                     ("av1n_plans_warps", C.POINTER(C.c_int32))]:
        fn = getattr(lib, name)
        fn.restype = rt
        fn.argtypes = [C.c_void_p, C.c_int]
    _lib = lib
    return lib


# mirrors native/include/plans.h
MI_FIELDS = [
    "bsize", "mode", "uv_mode", "angle_y", "angle_uv", "skip", "seg_id",
    "cfl_alpha_idx", "cfl_signs", "filter_intra", "palette_y", "palette_uv",
    "tx_size", "qindex", "delta_lf0", "delta_lf1", "delta_lf2", "delta_lf3",
    "cdef", "is_inter", "intrabc", "ref0", "ref1", "mv0x", "mv0y", "mv1x",
    "mv1y", "interp", "motion_mode", "compound_type", "wedge", "lossless",
    "bx", "by", "interintra", "ii_wedge", "skip_mode",
]
N_WARP_I32 = 8  # sizeof(WarpRecord)/4: mi, invalid, params[6]
TXR_FIELDS = ["plane", "x4", "y4", "tx_size", "tx_type", "eob", "coef_off",
              "mi", "avail"]
N_LR_I32 = 13  # sizeof(LrUnit)/4: plane,row,col,type,wiener[2][3],set,xqd[2]


class FramePlans:
    """Python view of one frame's plan tensors (numpy copies)."""

    def __init__(self, lib, h, idx: int):
        import numpy as np

        shape = (C.c_int64 * 9)()
        assert lib.av1n_plans_shape(h, idx, shape) == 0
        (self.mi_rows, self.mi_cols, n_tx, n_coef, n_pal, n_cmap, n_lr,
         n_fields, n_warp) = [int(x) for x in shape]
        n = self.mi_rows * self.mi_cols

        def arr(fn, count, dtype):
            ptr = fn(h, idx)
            if not ptr or count == 0:
                return np.zeros(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).copy()

        self.mi = arr(lib.av1n_plans_mi, n_fields * n, "int16").reshape(
            n_fields, self.mi_rows, self.mi_cols)
        self.tx = arr(lib.av1n_plans_tx, n_tx * len(TXR_FIELDS),
                      "int32").reshape(n_tx, len(TXR_FIELDS))
        self.coeffs = arr(lib.av1n_plans_coeffs, n_coef, "int32")
        self.palettes = arr(lib.av1n_plans_palettes, n_pal * 28,
                            "int32").reshape(n_pal, 28)
        self.color_map = arr(lib.av1n_plans_color_map, n_cmap, "uint8")
        self.color_map_off = arr(lib.av1n_plans_color_map_off, 2 * n_pal,
                                 "int32").reshape(n_pal, 2) if n_pal else None
        self.lr = arr(lib.av1n_plans_lr, n_lr * N_LR_I32, "int32").reshape(
            n_lr, N_LR_I32)
        self.warps = arr(lib.av1n_plans_warps, n_warp * N_WARP_I32,
                         "int32").reshape(n_warp, N_WARP_I32)

    def grid(self, name: str):
        return self.mi[MI_FIELDS.index(name)]


def _make() -> None:
    """`make` the native library, one process at a time: processes that
    start together (test workers) would otherwise rewrite the same
    object files under each other."""
    build = os.path.join(_NATIVE_DIR, "build")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, ".make.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-s"], cwd=_NATIVE_DIR, check=True)


def rebuild_native() -> None:
    """Bring the native library up to date with its sources."""
    _make()
    global _lib
    _lib = None


class NativeParser:
    """Header-level parser handle over the native library."""

    def __init__(self, threads: int = 1, operating_point: int = 0) -> None:
        self._lib = _load()
        self._h = self._lib.av1n_create()
        if threads > 1:
            self._lib.av1n_set_threads(self._h, int(threads))
        if operating_point:
            self._lib.av1n_set_operating_point(self._h,
                                               int(operating_point))

    def parse_tu(self, data: bytes, with_plans: bool = False):
        """Parse one temporal unit; returns the completed frames' headers
        (optionally with their plan tensors as (header, FramePlans))."""
        n = self._lib.av1n_parse_tu(self._h, data, len(data))
        if n < 0:
            err = self._lib.av1n_last_error(self._h)
            raise ValueError(f"native parse error rc={n}: {err}")
        out = []
        for i in range(n):
            hdr = json.loads(self._lib.av1n_frame_json(self._h, i))
            if with_plans:
                plans = (None if hdr.get("show_existing_frame")
                         else FramePlans(self._lib, self._h, i))
                out.append((hdr, plans))
            else:
                out.append(hdr)
        return out

    def save_state(self) -> bytes:
        """Serialize the header-level decode state (seq header + all
        8 ref slots incl. CDF contexts, seg maps, motion fields) at a
        temporal-unit boundary [SURVEY §5.4 mid-GOP checkpoint]."""
        n = self._lib.av1n_state_size(self._h)
        buf = C.create_string_buffer(n)
        if self._lib.av1n_state_save(self._h, buf, n) != 0:
            raise RuntimeError("state save failed")
        return buf.raw

    def load_state(self, blob: bytes) -> None:
        if self._lib.av1n_state_restore(self._h, blob, len(blob)) != 0:
            raise ValueError("state restore failed: bad or mismatched "
                             "checkpoint blob")

    def set_decode_tiles(self, v: bool) -> None:
        self._lib.av1n_set_decode_tiles(self._h, int(v))

    @property
    def seq(self) -> Optional[dict]:
        s = self._lib.av1n_seq_json(self._h)
        return json.loads(s) if s else None

    def close(self) -> None:
        if self._h:
            self._lib.av1n_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def wavefront_levels(plane, x4, y4, w4, h4, ext_above, ext_left, cfl_dep,
                     mi_rows, mi_cols, sub_x, sub_y, num_planes,
                     skip_dep=None):
    """Native ASAP wavefront level DP (see capi av1n_wavefront_levels).
    `skip_dep`: records with no recon-neighbor dependency (inter
    blocks) — level 1 unconditionally.  Returns (levels int32 [n],
    n_levels)."""
    import numpy as np
    lib = _load()
    n = len(plane)
    out = np.zeros(n, np.int32)
    i32 = [np.ascontiguousarray(a, np.int32)
           for a in (plane, x4, y4, w4, h4)]
    u8 = [np.ascontiguousarray(a, np.uint8)
          for a in (ext_above, ext_left, cfl_dep)]
    args = [C.c_int(n)]
    args += [a.ctypes.data_as(C.POINTER(C.c_int32)) for a in i32]
    args += [a.ctypes.data_as(C.POINTER(C.c_uint8)) for a in u8]
    args += [C.c_int(v) for v in (mi_rows, mi_cols, sub_x, sub_y,
                                  num_planes)]
    args.append(out.ctypes.data_as(C.POINTER(C.c_int32)))
    if skip_dep is not None:
        sd = np.ascontiguousarray(skip_dep, np.uint8)
        args.append(sd.ctypes.data_as(C.POINTER(C.c_uint8)))
    else:
        args.append(None)
    n_levels = lib.av1n_wavefront_levels(*args)
    return out, int(n_levels)
