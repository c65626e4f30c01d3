"""Write the committed 1080p smoke streams and libaom's MD5s for them.

    python tools/make_smoke_streams.py [out_dir]     # default: streams/

Three 1080p 8-bit 4:2:0 streams, each encoded from a fixed seed by the
system libaom through tools/aomffi.py:

  intra_1080p.ivf       8 key frames, cq 40, 2x2 tiles, deblock + CDEF
  inter_1080p.ivf       1 KF + 7 low-delay inter frames with the simple
                        inter tools only (every inter frame is eligible
                        for device MC)
  postfilter_1080p.ivf  2 key frames with superres (denominator 12) and
                        loop restoration

and postfilter_384x192.ivf, the postfilter recipe at 384x192 (two LR
unit rows), small enough for the CPU tests.

`md5.json` beside them holds libaom's per-frame MD5 (Y, U, V bytes in
order, as `api.OutputFrame.md5`) and the whole-stream MD5 (all frames'
plane bytes, as `python -m av1dec_tpu <ivf> --md5` prints it).  The
decoder is normative, so these are the expected outputs bit for bit:
chip_smoke.py checks against them on machines that have no libaom.
"""
import hashlib
import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1920, 1080


def encode_intra(path, W=W, H=H, n_frames=8):
    """All-intra 1080p: cq 40, 2x2 tiles, libaom's default deblock and
    CDEF."""
    import aomffi
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:H, :W]
    enc = aomffi.AomEncoder(
        W, H, cpu_used=6, kf_max_dist=1, lag=0,
        options=[("cq-level", "40"), ("tile-columns", "1"),
                 ("tile-rows", "1")], end_usage=3)
    pkts = []
    for i in range(n_frames):
        y = (110 + 70 * np.sin(xx / 17.0 + i * 0.3) *
             np.cos(yy / 23.0 - i * 0.2) +
             rng.normal(0, 12, (H, W))).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin(xx[:H // 2, :W // 2] / 13.0 + i * 0.1) +
             rng.normal(0, 8, (H // 2, W // 2))).clip(0, 255) \
            .astype(np.uint8)
        v = (128 + 40 * np.cos(yy[:H // 2, :W // 2] / 15.0) +
             rng.normal(0, 8, (H // 2, W // 2))).clip(0, 255) \
            .astype(np.uint8)
        pkts += enc.encode(y, u, v, pts=i)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, W, H)


def encode_inter(path, W=W, H=H, n_frames=8):
    """1080p low-delay inter (1 KF + 7 inter) from a panning image.
    OBMC, warp, masked and inter-intra compound and global motion are
    off, so every inter frame qualifies for the device MC path."""
    import aomffi
    rng = np.random.default_rng(17)
    pad = 64
    yy, xx = np.mgrid[:H + pad, :W + pad]
    base_y = (110 + 70 * np.sin(xx / 17.0) * np.cos(yy / 23.0) +
              rng.normal(0, 10, (H + pad, W + pad))).clip(0, 255) \
        .astype(np.uint8)
    base_u = (128 + 40 * np.sin(xx[::2, ::2] / 13.0)).clip(0, 255) \
        .astype(np.uint8)
    base_v = (128 + 40 * np.cos(yy[::2, ::2] / 15.0)).clip(0, 255) \
        .astype(np.uint8)
    enc = aomffi.AomEncoder(
        W, H, cpu_used=6, kf_max_dist=9999, lag=0, end_usage=3,
        options=[("cq-level", "40"),
                 ("enable-obmc", "0"), ("enable-warped-motion", "0"),
                 ("enable-masked-comp", "0"),
                 ("enable-interintra-comp", "0"),
                 ("enable-global-motion", "0")])
    pkts = []
    for i in range(n_frames):
        dy, dx = 2 * i, 3 * i
        y = base_y[dy:dy + H, dx:dx + W]
        u = base_u[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2]
        v = base_v[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2]
        pkts += enc.encode(y, u, v, pts=i)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, W, H)


def encode_postfilter(path, W=W, H=H, n_frames=2):
    """All-intra with superres (at 1080p: coded 1280 wide, upscaled to
    1920) and loop restoration, so the fused postfilter runs its
    superres and Wiener passes at full width."""
    import aomffi
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[:H, :W]
    enc = aomffi.AomEncoder(
        W, H, cpu_used=3, kf_max_dist=1, lag=0, end_usage=3,
        superres_denom=12,
        options=[("cq-level", "45"), ("enable-cdef", "1"),
                 ("enable-restoration", "1")])
    pkts = []
    for i in range(n_frames):
        y = (128 + 64 * np.sin(xx / 9.0 + i) * np.cos(yy / 11.0) +
             rng.normal(0, 25, (H, W))).clip(0, 255).astype(np.uint8)
        u = (128 + rng.normal(0, 10, (H // 2, W // 2))).clip(0, 255) \
            .astype(np.uint8)
        v = (128 + rng.normal(0, 10, (H // 2, W // 2))).clip(0, 255) \
            .astype(np.uint8)
        pkts += enc.encode(y, u, v, pts=i)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, W, H)


STREAMS = (
    ("intra_1080p.ivf", encode_intra, W, H),
    ("inter_1080p.ivf", encode_inter, W, H),
    ("postfilter_1080p.ivf", encode_postfilter, W, H),
    ("postfilter_384x192.ivf", encode_postfilter, 384, 192),
)


def oracle_md5s(path):
    """libaom's (per-frame MD5s, whole-stream MD5) for one stream."""
    import aomffi
    frames = []
    whole = hashlib.md5()
    for fr in aomffi.oracle_decode_ivf(path):
        h = hashlib.md5()
        for p in (fr.y, fr.u, fr.v):
            if p is not None:
                b = np.ascontiguousarray(p).tobytes()
                h.update(b)
                whole.update(b)
        frames.append(h.hexdigest())
    return frames, whole.hexdigest()


def main(argv):
    out_dir = argv[1] if len(argv) > 1 else os.path.join(_REPO, "streams")
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    os.makedirs(out_dir, exist_ok=True)
    record = {}
    for name, enc, w, h in STREAMS:
        path = os.path.join(out_dir, name)
        enc(path, w, h)
        frames, whole = oracle_md5s(path)
        record[name] = {"width": w, "height": h, "frames": frames,
                        "stream_md5": whole}
        print(f"{name}: {os.path.getsize(path)} bytes, "
              f"{len(frames)} frames", flush=True)
    with open(os.path.join(out_dir, "md5.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main(sys.argv)
