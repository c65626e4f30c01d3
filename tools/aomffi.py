"""ctypes harness for the system libaom (3.6.0) — encoder + oracle decoder.

There are no libaom headers on this machine, so struct layouts are
discovered *empirically* instead of hard-coded:

- `aom_image_t` offsets are found by allocating an image with distinctive
  dimensions via `aom_img_alloc` and scanning the struct memory for the
  known values (fmt / w / h / bitdepth / plane pointers / strides).
- `aom_codec_enc_cfg_t` offsets are found by calling
  `aom_codec_enc_config_default` into a zeroed buffer and locating the
  documented default values (g_w=320, g_h=240, timebase 1/30,
  kf_max_dist=9999, rc_target_bitrate=256 ...).

Only the exported, ABI-stable C functions are used.  Encoder options that
would require fragile control IDs go through the string-based
`aom_codec_set_option` API instead.

Role in this repo (SURVEY.md §4): libaom's decoder is the bit-exact decode
oracle (AV1 decode is normative), and its encoder generates local test
streams, since no conformance vectors exist on disk and egress is blocked.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import json
import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

_LIB_PATH = "/usr/lib/x86_64-linux-gnu/libaom.so.3"
_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".aom_abi_cache.json")

AOM_CODEC_OK = 0

# aom_image.h: fmt flag bits (stable across libaom 3.x)
AOM_IMG_FMT_PLANAR = 0x100
AOM_IMG_FMT_HIGHBITDEPTH = 0x800
AOM_IMG_FMT_I420 = AOM_IMG_FMT_PLANAR | 2
AOM_IMG_FMT_I422 = AOM_IMG_FMT_PLANAR | 5
AOM_IMG_FMT_I444 = AOM_IMG_FMT_PLANAR | 6
AOM_IMG_FMT_I42016 = AOM_IMG_FMT_I420 | AOM_IMG_FMT_HIGHBITDEPTH
AOM_IMG_FMT_I42216 = AOM_IMG_FMT_I422 | AOM_IMG_FMT_HIGHBITDEPTH
AOM_IMG_FMT_I44416 = AOM_IMG_FMT_I444 | AOM_IMG_FMT_HIGHBITDEPTH

_lib = C.CDLL(_LIB_PATH)

_lib.aom_codec_av1_cx.restype = C.c_void_p
_lib.aom_codec_av1_dx.restype = C.c_void_p
_lib.aom_codec_version.restype = C.c_int
_lib.aom_codec_err_to_string.restype = C.c_char_p
_lib.aom_codec_err_to_string.argtypes = [C.c_int]
_lib.aom_img_alloc.restype = C.c_void_p
_lib.aom_img_alloc.argtypes = [C.c_void_p, C.c_int, C.c_uint, C.c_uint, C.c_uint]
_lib.aom_img_free.argtypes = [C.c_void_p]
_lib.aom_codec_enc_config_default.restype = C.c_int
_lib.aom_codec_enc_config_default.argtypes = [C.c_void_p, C.c_void_p, C.c_uint]
_lib.aom_codec_enc_init_ver.restype = C.c_int
_lib.aom_codec_enc_init_ver.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p, C.c_long, C.c_int]
_lib.aom_codec_dec_init_ver.restype = C.c_int
_lib.aom_codec_dec_init_ver.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p, C.c_long, C.c_int]
_lib.aom_codec_destroy.restype = C.c_int
_lib.aom_codec_destroy.argtypes = [C.c_void_p]
_lib.aom_codec_encode.restype = C.c_int
_lib.aom_codec_encode.argtypes = [C.c_void_p, C.c_void_p, C.c_longlong, C.c_ulong, C.c_long]
_lib.aom_codec_get_cx_data.restype = C.c_void_p
_lib.aom_codec_get_cx_data.argtypes = [C.c_void_p, C.c_void_p]
_lib.aom_codec_decode.restype = C.c_int
_lib.aom_codec_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t, C.c_void_p]
_lib.aom_codec_get_frame.restype = C.c_void_p
_lib.aom_codec_get_frame.argtypes = [C.c_void_p, C.c_void_p]
_lib.aom_codec_set_option.restype = C.c_int
_lib.aom_codec_set_option.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p]
_lib.aom_codec_error.restype = C.c_char_p
_lib.aom_codec_error.argtypes = [C.c_void_p]
_lib.aom_codec_error_detail.restype = C.c_char_p
_lib.aom_codec_error_detail.argtypes = [C.c_void_p]

# aom_codec_ctx_t is ~56 bytes on x86-64; over-allocate generously.
_CTX_SIZE = 256


def _read_mem(addr: int, n: int) -> bytes:
    return C.string_at(addr, n)


def _u32s(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf[: len(buf) // 4 * 4], dtype="<u4")


def _u64s(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf[: len(buf) // 8 * 8], dtype="<u8")


# ---------------------------------------------------------------------------
# ABI discovery
# ---------------------------------------------------------------------------

class AomABI:
    """Empirically discovered struct offsets, cached on disk."""

    def __init__(self) -> None:
        if os.path.exists(_CACHE):
            with open(_CACHE) as f:
                self.__dict__.update(json.load(f))
            return
        self._discover_image()
        self._discover_enc_cfg()
        self._discover_abi_versions()
        # write-then-rename: a process starting alongside this one must
        # never read a half-written cache
        tmp = f"{_CACHE}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({k: v for k, v in self.__dict__.items()}, f, indent=1)
        os.replace(tmp, _CACHE)

    # -- aom_image_t ------------------------------------------------------
    def _discover_image(self) -> None:
        w, h = 644, 486  # distinctive, even (4:2:0-legal)
        img = _lib.aom_img_alloc(None, AOM_IMG_FMT_I420, w, h, 32)
        assert img, "aom_img_alloc failed"
        raw = _read_mem(img, 512)
        u32 = _u32s(raw)
        u64 = _u64s(raw)

        assert u32[0] == AOM_IMG_FMT_I420, f"fmt@0 expected, got {u32[0]:#x}"
        self.img_fmt = 0

        # find the run [w, h, bit_depth=8, d_w, d_h, r_w, r_h, xcs=1, ycs=1]
        run = None
        for i in range(len(u32) - 9):
            if (
                u32[i] == w and u32[i + 1] == h and u32[i + 2] == 8
                and u32[i + 3] == w and u32[i + 4] == h
                and u32[i + 5] in (w, 0) and u32[i + 6] in (h, 0)
                and u32[i + 7] == 1 and u32[i + 8] == 1
            ):
                run = i
                break
        assert run is not None, "aom_image_t w/h run not found"
        self.img_w = 4 * run
        self.img_h = 4 * (run + 1)
        self.img_bit_depth = 4 * (run + 2)
        self.img_d_w = 4 * (run + 3)
        self.img_d_h = 4 * (run + 4)
        self.img_x_chroma_shift = 4 * (run + 7)
        self.img_y_chroma_shift = 4 * (run + 8)

        # find 3 consecutive plausible heap pointers (planes[3]), 8-aligned,
        # all within a few MB of each other, followed by 3 int strides
        planes_off = None
        for j in range(len(u64) - 3):
            p0, p1, p2 = int(u64[j]), int(u64[j + 1]), int(u64[j + 2])
            if all(0x10000 < p < 0x7FFFFFFFFFFF for p in (p0, p1, p2)):
                if 0 < p1 - p0 < 16 << 20 and 0 < p2 - p1 < 16 << 20:
                    planes_off = 8 * j
                    break
        assert planes_off is not None, "aom_image_t planes not found"
        self.img_planes = planes_off
        s = _u32s(raw[planes_off + 24: planes_off + 36])
        # luma stride >= w, chroma strides >= w//2
        assert s[0] >= w and s[1] >= w // 2 and s[2] == s[1], f"strides? {s}"
        self.img_stride = planes_off + 24
        _lib.aom_img_free(img)

    # -- aom_codec_enc_cfg_t ---------------------------------------------
    def _discover_enc_cfg(self) -> None:
        buf = C.create_string_buffer(16384)
        rc = _lib.aom_codec_enc_config_default(
            C.c_void_p(_lib.aom_codec_av1_cx()), buf, 0
        )
        assert rc == AOM_CODEC_OK, f"enc_config_default rc={rc}"
        u32 = _u32s(bytes(buf.raw))

        # run: [g_profile=0, g_w=320, g_h=240] then g_bit_depth=8,
        # g_input_bit_depth=8, timebase {num=1, den=30} further along
        start = None
        for i in range(64):
            if u32[i] == 320 and u32[i + 1] == 240:
                start = i
                break
        assert start is not None, "g_w/g_h defaults not found in enc cfg"
        self.cfg_g_w = 4 * start
        self.cfg_g_h = 4 * (start + 1)
        self.cfg_g_threads = 4  # g_usage@0, g_threads@4 (stable, documented)
        # locate timebase: first (1, 30) pair after g_h
        tb = None
        for i in range(start + 2, start + 16):
            if u32[i] == 1 and u32[i + 1] == 30:
                tb = i
                break
        assert tb is not None, "timebase default not found"
        self.cfg_timebase_num = 4 * tb
        self.cfg_timebase_den = 4 * (tb + 1)
        # g_bit_depth / g_input_bit_depth: two consecutive 8s in (g_h, tb)
        bd = None
        for i in range(start + 2, tb):
            if u32[i] == 8 and u32[i + 1] == 8:
                bd = i
                break
        assert bd is not None, "bit depth defaults not found"
        self.cfg_g_bit_depth = 4 * bd
        self.cfg_g_input_bit_depth = 4 * (bd + 1)
        # g_lag_in_frames: default 19/25/35 depending on build, shortly
        # after the timebase (g_error_resilient and g_pass sit between)
        lag = None
        for i in range(tb + 2, tb + 8):
            if u32[i] in (19, 25, 35):
                lag = i
                break
        self.cfg_g_lag_in_frames = 4 * lag if lag is not None else None
        # kf_max_dist: default 9999 (very distinctive)
        kf = int(np.nonzero(u32 == 9999)[0][0])
        self.cfg_kf_max_dist = 4 * kf
        self.cfg_kf_min_dist = 4 * (kf - 1)
        self.cfg_kf_mode = 4 * (kf - 2)  # AOM_KF_AUTO == 1
        assert u32[kf - 2] == 1, "kf_mode default != AUTO?"
        # rc_target_bitrate: default 256, between timebase and kf block
        rt = None
        for i in range(tb + 2, kf):
            if u32[i] == 256 and u32[i + 1] == 0 and u32[i + 2] == 63:
                # followed by rc_min_quantizer=0, rc_max_quantizer=63
                rt = i
                break
        assert rt is not None, "rc_target_bitrate/min_q/max_q not found"
        self.cfg_rc_target_bitrate = 4 * rt
        self.cfg_rc_min_quantizer = 4 * (rt + 1)
        self.cfg_rc_max_quantizer = 4 * (rt + 2)
        # rc_end_usage: default AOM_VBR(0) — cannot be located by value.
        # It sits before the two aom_fixed_buf_t members (ptr+size = 16B
        # each, 8-aligned => 4B padding after end_usage):
        # end_usage | pad | stats_in(16) | mb_stats_in(16) | target_bitrate
        self.cfg_rc_end_usage = 4 * rt - 40
        # fields after kf_max_dist (aom_encoder.h order): sframe_dist,
        # sframe_mode, large_scale_tile, monochrome, full_still_picture_hdr
        self.cfg_monochrome = 4 * (kf + 4)
        self.cfg_size = 16384

    def _discover_abi_versions(self) -> None:
        # Probe the ABI version expected by this build (mismatch => rc 3).
        self.dec_abi = None
        self.enc_abi = None
        for ver in range(1, 64):
            ctx = C.create_string_buffer(_CTX_SIZE)
            rc = _lib.aom_codec_dec_init_ver(
                ctx, C.c_void_p(_lib.aom_codec_av1_dx()), None, 0, ver
            )
            if rc == AOM_CODEC_OK:
                self.dec_abi = ver
                _lib.aom_codec_destroy(ctx)
                break
        assert self.dec_abi, "decoder ABI version not found"
        cfg = C.create_string_buffer(16384)
        _lib.aom_codec_enc_config_default(C.c_void_p(_lib.aom_codec_av1_cx()), cfg, 0)
        for ver in range(1, 64):
            ctx = C.create_string_buffer(_CTX_SIZE)
            rc = _lib.aom_codec_enc_init_ver(
                ctx, C.c_void_p(_lib.aom_codec_av1_cx()), cfg, 0, ver
            )
            if rc == AOM_CODEC_OK:
                self.enc_abi = ver
                _lib.aom_codec_destroy(ctx)
                break
        assert self.enc_abi, "encoder ABI version not found"


_abi: Optional[AomABI] = None


def abi() -> AomABI:
    global _abi
    if _abi is None:
        _abi = AomABI()
    return _abi


# ---------------------------------------------------------------------------
# Image helpers
# ---------------------------------------------------------------------------

@dataclass
class Frame:
    """One decoded frame: planes as numpy arrays (uint8 or uint16)."""

    y: np.ndarray
    u: Optional[np.ndarray]
    v: Optional[np.ndarray]
    bit_depth: int
    subsampling: Tuple[int, int]  # (x_shift, y_shift)

    def md5(self) -> str:
        h = hashlib.md5()
        for p in (self.y, self.u, self.v):
            if p is not None:
                h.update(np.ascontiguousarray(p).tobytes())
        return h.hexdigest()


def _image_to_frame(img_ptr: int) -> Frame:
    a = abi()
    raw = _read_mem(img_ptr, 512)
    u32 = _u32s(raw)
    fmt = int(u32[a.img_fmt // 4])
    d_w = int(u32[a.img_d_w // 4])
    d_h = int(u32[a.img_d_h // 4])
    bit_depth = int(u32[a.img_bit_depth // 4])
    xcs = int(u32[a.img_x_chroma_shift // 4])
    ycs = int(u32[a.img_y_chroma_shift // 4])
    planes = _u64s(raw[a.img_planes: a.img_planes + 24])
    strides = np.frombuffer(raw[a.img_stride: a.img_stride + 12], dtype="<i4")
    hbd = bool(fmt & AOM_IMG_FMT_HIGHBITDEPTH)
    dtype = np.uint16 if hbd else np.uint8
    bpp = 2 if hbd else 1

    def plane(idx: int, pw: int, ph: int) -> np.ndarray:
        buf = _read_mem(int(planes[idx]), int(strides[idx]) * ph)
        arr = np.frombuffer(buf, dtype=dtype).reshape(ph, int(strides[idx]) // bpp)
        return arr[:, :pw].copy()

    y = plane(0, d_w, d_h)
    cw = (d_w + xcs) >> xcs
    ch = (d_h + ycs) >> ycs
    monochrome = int(planes[1]) == 0
    u = None if monochrome else plane(1, cw, ch)
    v = None if monochrome else plane(2, cw, ch)
    return Frame(y, u, v, bit_depth, (xcs, ycs))


# ---------------------------------------------------------------------------
# Decoder (oracle)
# ---------------------------------------------------------------------------

class AomDecoder:
    """Oracle decoder over libaom — feed OBU temporal units, get Frames."""

    def __init__(self) -> None:
        a = abi()
        self._ctx = C.create_string_buffer(_CTX_SIZE)
        rc = _lib.aom_codec_dec_init_ver(
            self._ctx, C.c_void_p(_lib.aom_codec_av1_dx()), None, 0, a.dec_abi
        )
        assert rc == AOM_CODEC_OK, f"dec init rc={rc}"

    def decode(self, data: Optional[bytes]) -> List[Frame]:
        n = len(data) if data else 0
        rc = _lib.aom_codec_decode(self._ctx, data if data else None, n, None)
        if rc != AOM_CODEC_OK:
            err = _lib.aom_codec_error_detail(self._ctx)
            raise RuntimeError(f"aom decode rc={rc}: {err}")
        frames = []
        it = C.c_void_p(0)
        while True:
            img = _lib.aom_codec_get_frame(self._ctx, C.byref(it))
            if not img:
                break
            frames.append(_image_to_frame(img))
        return frames

    def close(self) -> None:
        if self._ctx is not None:
            _lib.aom_codec_destroy(self._ctx)
            self._ctx = None

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Encoder (test stream generation)
# ---------------------------------------------------------------------------

class AomEncoder:
    def __init__(
        self,
        w: int,
        h: int,
        bit_depth: int = 8,
        subsampling: Tuple[int, int] = (1, 1),
        cpu_used: int = 9,
        bitrate_kbps: int = 1000,
        kf_max_dist: int = 9999,
        lag: int = 0,
        threads: int = 2,
        options: Optional[List[Tuple[str, str]]] = None,
        monochrome: bool = False,
        end_usage: Optional[int] = None,  # 0=VBR 1=CBR 2=CQ 3=Q
        superres_denom: Optional[int] = None,  # 9..16 (8 = off)
        resize_denom: Optional[int] = None,    # 9..16 inter frames
    ) -> None:
        a = abi()
        self.w, self.h = w, h
        self.bit_depth = bit_depth
        self.subsampling = subsampling
        cfg = C.create_string_buffer(a.cfg_size)
        rc = _lib.aom_codec_enc_config_default(
            C.c_void_p(_lib.aom_codec_av1_cx()), cfg, 0
        )
        assert rc == AOM_CODEC_OK

        def set32(off: int, val: int) -> None:
            struct.pack_into("<I", cfg, off, val)

        set32(a.cfg_g_w, w)
        set32(a.cfg_g_h, h)
        set32(a.cfg_g_threads, threads)
        set32(a.cfg_timebase_num, 1)
        set32(a.cfg_timebase_den, 25)
        set32(a.cfg_rc_target_bitrate, bitrate_kbps)
        set32(a.cfg_kf_max_dist, kf_max_dist)
        if a.cfg_g_lag_in_frames is not None:
            set32(a.cfg_g_lag_in_frames, lag)
        if monochrome:
            set32(a.cfg_monochrome, 1)
        if end_usage is not None:
            set32(a.cfg_rc_end_usage, end_usage)
        if superres_denom is not None:
            # rc_superres_mode / _denominator / _kf_denominator sit just
            # before rc_end_usage (offsets validated by usage-diff probe)
            set32(a.cfg_rc_end_usage - 20, 1)   # SUPERRES_FIXED
            set32(a.cfg_rc_end_usage - 16, superres_denom)
            set32(a.cfg_rc_end_usage - 12, superres_denom)
        if resize_denom is not None:
            # rc_resize_mode/_denominator/_kf_denominator precede the
            # superres fields in aom_codec_enc_cfg (same struct block).
            # KF kept full-size (denom 8) so inter frames reference a
            # larger frame -> scaled-reference MC [SPEC §7.11.3.4].
            set32(a.cfg_rc_end_usage - 32, 1)   # RESIZE_FIXED
            set32(a.cfg_rc_end_usage - 28, resize_denom)
            set32(a.cfg_rc_end_usage - 24, 8)   # keyframes full size
        hbd = bit_depth > 8
        if hbd:
            set32(a.cfg_g_bit_depth, bit_depth)
            set32(a.cfg_g_input_bit_depth, bit_depth)
            # profile: 10/12-bit 4:2:0 -> profile 0 (10b) or 2 (12b)
            if bit_depth == 12:
                struct.pack_into("<I", cfg, a.cfg_g_w - 4, 2)
        if subsampling == (0, 0):  # 4:4:4 => profile 1
            struct.pack_into("<I", cfg, a.cfg_g_w - 4, 1)
        elif subsampling == (1, 0):  # 4:2:2 => profile 2
            struct.pack_into("<I", cfg, a.cfg_g_w - 4, 2)

        self._ctx = C.create_string_buffer(_CTX_SIZE)
        flags = 0x40000 if hbd else 0  # AOM_CODEC_USE_HIGHBITDEPTH
        rc = _lib.aom_codec_enc_init_ver(
            self._ctx, C.c_void_p(_lib.aom_codec_av1_cx()), cfg, flags, a.enc_abi
        )
        if rc != AOM_CODEC_OK:
            raise RuntimeError(
                f"enc init rc={rc}: {_lib.aom_codec_error_detail(self._ctx)}"
            )
        _lib.aom_codec_set_option(self._ctx, b"cpu-used", str(cpu_used).encode())
        _lib.aom_codec_set_option(self._ctx, b"row-mt", b"1")
        if monochrome:
            pass  # monochrome handled via cfg field
        for k, v in options or []:
            rc = _lib.aom_codec_set_option(self._ctx, k.encode(), v.encode())
            if rc != AOM_CODEC_OK:
                raise RuntimeError(f"set_option {k}={v} rc={rc}")

        if hbd:
            fmt = {(1, 1): AOM_IMG_FMT_I42016, (1, 0): AOM_IMG_FMT_I42216,
                   (0, 0): AOM_IMG_FMT_I44416}[subsampling]
        else:
            fmt = {(1, 1): AOM_IMG_FMT_I420, (1, 0): AOM_IMG_FMT_I422,
                   (0, 0): AOM_IMG_FMT_I444}[subsampling]
        self._img = _lib.aom_img_alloc(None, fmt, w, h, 32)
        assert self._img

    def _fill_image(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        a = abi()
        raw = _read_mem(self._img, 512)
        planes = _u64s(raw[a.img_planes: a.img_planes + 24])
        strides = np.frombuffer(raw[a.img_stride: a.img_stride + 12], dtype="<i4")
        hbd = self.bit_depth > 8
        dtype = np.uint16 if hbd else np.uint8
        bpp = 2 if hbd else 1
        for idx, p in enumerate((y, u, v)):
            if p is None:
                continue
            ph, pw = p.shape
            stride = int(strides[idx])
            row = np.zeros((ph, stride // bpp), dtype=dtype)
            row[:, :pw] = p
            C.memmove(int(planes[idx]), row.tobytes(), ph * stride)

    def encode(self, y, u, v, pts: int) -> List[Tuple[int, bytes]]:
        self._fill_image(y, u, v)
        rc = _lib.aom_codec_encode(self._ctx, C.c_void_p(self._img), pts, 1, 0)
        if rc != AOM_CODEC_OK:
            raise RuntimeError(
                f"encode rc={rc}: {_lib.aom_codec_error_detail(self._ctx)}"
            )
        return self._drain()

    def flush(self) -> List[Tuple[int, bytes]]:
        out: List[Tuple[int, bytes]] = []
        while True:
            rc = _lib.aom_codec_encode(self._ctx, None, -1, 1, 0)
            if rc != AOM_CODEC_OK:
                break
            pkts = self._drain()
            if not pkts:
                break
            out.extend(pkts)
        return out

    def _drain(self) -> List[Tuple[int, bytes]]:
        """Drain cx data packets -> [(pts, frame_bytes)].

        aom_codec_cx_pkt_t: kind(int)@0, union@8: {buf ptr@8, sz@16,
        pts@24, duration@32, ...} — standard x86-64 layout of the public
        struct; validated by sanity checks on every packet.
        """
        out = []
        it = C.c_void_p(0)
        while True:
            pkt = _lib.aom_codec_get_cx_data(self._ctx, C.byref(it))
            if not pkt:
                break
            raw = _read_mem(pkt, 48)
            kind = struct.unpack_from("<i", raw, 0)[0]
            if kind != 0:  # AOM_CODEC_CX_FRAME_PKT
                continue
            buf, sz, pts = struct.unpack_from("<QQq", raw, 8)
            assert 0 < sz < (64 << 20), f"implausible pkt size {sz}"
            out.append((pts, _read_mem(buf, sz)))
        return out

    def close(self) -> None:
        if getattr(self, "_ctx", None) is not None:
            _lib.aom_codec_destroy(self._ctx)
            self._ctx = None
        if getattr(self, "_img", None):
            _lib.aom_img_free(self._img)
            self._img = None

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# IVF container  [SURVEY.md L0; IVF is the de-facto AV1 test container]
# ---------------------------------------------------------------------------

def write_ivf(path: str, frames: List[Tuple[int, bytes]], w: int, h: int,
              tb_den: int = 25, tb_num: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<4sHH4sHHIII4x", b"DKIF", 0, 32, b"AV01",
                            w, h, tb_den, tb_num, len(frames)))
        for pts, data in frames:
            f.write(struct.pack("<IQ", len(data), pts))
            f.write(data)


def read_ivf(path: str) -> Iterator[Tuple[int, bytes]]:
    with open(path, "rb") as f:
        hdr = f.read(32)
        magic, _, hdrsz = struct.unpack_from("<4sHH", hdr, 0)
        assert magic == b"DKIF", "not an IVF file"
        f.seek(hdrsz)
        while True:
            fh = f.read(12)
            if len(fh) < 12:
                break
            sz, pts = struct.unpack("<IQ", fh)
            yield pts, f.read(sz)


def oracle_decode_ivf(path: str) -> List[Frame]:
    dec = AomDecoder()
    frames: List[Frame] = []
    for _, data in read_ivf(path):
        frames.extend(dec.decode(data))
    frames.extend(dec.decode(b""))  # flush
    dec.close()
    return frames


if __name__ == "__main__":
    a = abi()
    print("libaom version:", _lib.aom_codec_version())
    print(json.dumps(a.__dict__, indent=1))
