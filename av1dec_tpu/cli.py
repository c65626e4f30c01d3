"""av1dec_tpu command-line decoder.

Usage:
    python -m av1dec_tpu <input.ivf> [-o out.yuv | --y4m out.y4m]
                         [--md5] [--frame-md5] [--limit N] [--summary]

Mirrors the reference decoder CLI surface (aomdec): raw/Y4M output,
MD5 checksums of the output planes, frame limits, and a decode-rate
summary.
"""
import argparse
import hashlib
import sys
import time

import numpy as np


def _plane_bytes(frame):
    """Output planes as raw bytes (8-bit: u8; >8-bit: little-endian u16)."""
    bd = frame.bit_depth
    out = b""
    for p in frame.planes:
        a = np.asarray(p)
        if bd > 8:
            out += a.astype("<u2").tobytes()
        else:
            out += a.astype(np.uint8).tobytes()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m av1dec_tpu",
        description="AV1 decoder with a JAX device pixel pipeline")
    ap.add_argument("input", help="input IVF file")
    ap.add_argument("-o", "--output", help="raw YUV output file")
    ap.add_argument("--y4m", help="Y4M output file")
    ap.add_argument("--md5", action="store_true",
                    help="print MD5 over all output frames")
    ap.add_argument("--frame-md5", action="store_true",
                    help="print per-frame MD5 checksums")
    ap.add_argument("--limit", type=int, default=0,
                    help="decode at most N frames")
    ap.add_argument("--summary", action="store_true",
                    help="print decode-rate summary")
    ap.add_argument("--threads", type=int, default=1,
                    help="entropy-decode worker threads (tile-parallel)")
    ap.add_argument("--gop-workers", type=int, default=0,
                    help="decode keyframe-delimited GOPs in N parallel "
                         "worker processes (with elastic recovery); "
                         "0 = serial")
    ap.add_argument("--device",
                    choices=["auto", "off", "cpu", "gpu"],
                    default="auto",
                    help="pixel-pipeline device path: auto (accelerator "
                         "if present and the frame is large enough), "
                         "off (NumPy spec model), or a specific JAX "
                         "platform (also selects the JAX backend)")
    ap.add_argument("--no-grain", action="store_true",
                    help="skip film-grain synthesis at output")
    ap.add_argument("--stats", action="store_true",
                    help="print per-frame decode records (JSON lines)")
    args = ap.parse_args(argv)

    # an explicit platform also selects JAX's backend (this must come
    # before the first jax import; when jax is already up in this
    # process, Decoder still checks that the platform exists).  The
    # device path places the persistent compile cache itself
    # (av1dec_tpu/compile_cache.py).
    import os
    if args.device in ("cpu", "gpu"):
        os.environ.setdefault("JAX_PLATFORMS", args.device)

    from av1dec_tpu.api import Decoder
    from av1dec_tpu.config import DecoderConfig

    config = DecoderConfig(
        threads=args.threads,
        platform=None if args.device == "auto" else args.device,
        apply_grain=not args.no_grain,
        max_frames=args.limit)

    t0 = time.monotonic()
    n = 0
    total_md5 = hashlib.md5()
    out_f = open(args.output, "wb") if args.output else None
    y4m_f = open(args.y4m, "wb") if args.y4m else None

    dec = Decoder(config)

    def frame_stream():
        if args.gop_workers > 1:
            # GOP-parallel decode across worker processes (elastic:
            # dead workers' GOPs are reassigned) [SURVEY §2.4, §5.3]
            from av1dec_tpu.container import decode_gops_parallel
            yield from decode_gops_parallel(
                args.input, workers=args.gop_workers, config=config)
            return
        from av1dec_tpu.container import read_temporal_units
        for _, tu in read_temporal_units(args.input):
            yield from dec.decode(tu)

    try:
        for frame in frame_stream():
            raw = _plane_bytes(frame)
            if args.frame_md5:
                print(f"frame {n}: {hashlib.md5(raw).hexdigest()}")
            if args.md5:
                total_md5.update(raw)
            if out_f:
                out_f.write(raw)
            if y4m_f:
                if n == 0:
                    h, w = np.asarray(frame.planes[0]).shape
                    cs = {(1, 1): "420jpeg", (1, 0): "422",
                          (0, 0): "444"}[frame.subsampling]
                    if len(frame.planes) == 1:
                        cs = "mono"
                    if frame.bit_depth > 8:
                        cs += f"p{frame.bit_depth}"
                    y4m_f.write(
                        f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 "
                        f"C{cs}\n".encode())
                y4m_f.write(b"FRAME\n")
                y4m_f.write(raw)
            n += 1
            if args.limit and n >= args.limit:
                break
    finally:
        dec.close()
        if out_f:
            out_f.close()
        if y4m_f:
            y4m_f.close()

    dt = time.monotonic() - t0
    if args.stats:
        import json as _json
        for rec in dec.stats:
            print(_json.dumps(rec), file=sys.stderr)
    if args.md5:
        print(total_md5.hexdigest())
    if args.summary:
        print(f"{n} frames in {dt:.3f}s ({n / dt:.2f} fps)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
