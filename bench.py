"""Benchmark: decode throughput on a 1080p intra stream.

Prints ONE JSON line:
  {"metric": "fps_1080p_intra", "value": N, "unit": "frames/s",
   "vs_baseline": N}
vs_baseline is the ratio against libaom's decoder on the same stream
(the local C-reference stand-in; BASELINE.md).  Decode output is
verified bit-exact against the oracle before timing counts.

Decode architecture measured here (SURVEY §7.1):
  host C++ entropy front-half (tile-threaded)  ->  plan tensors
  -> device wavefront scan (intra pred + residual) + deblock + CDEF in
     fixed-size frame sub-batches; host prep of sub-batch k+1
     (residual itx, lane packing, deblock maps) overlaps device
     execution of sub-batch k on a worker thread
Per-stage timings go to stderr; the JSON line to stdout.
"""
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))

# committed streams, written by tools/make_smoke_streams.py
STREAM = os.path.join(_REPO, "streams", "intra_1080p.ivf")
STREAM_INTER = os.path.join(_REPO, "streams", "inter_1080p.ivf")
THREADS = max(1, min(4, os.cpu_count() or 1))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_inter(log):
    """Decode the inter stream through the public API (device path for
    every qualifying frame, device-resident ref cache).  Returns
    (fps, n_device_inter_frames, bad_px) — fps 0 when not bit-exact."""
    import numpy as np

    import aomffi
    from av1dec_tpu.api import Decoder
    from av1dec_tpu.config import DecoderConfig
    from av1dec_tpu.container import read_ivf

    datas = [d for _, d in read_ivf(STREAM_INTER)]

    def run():
        dec = Decoder(DecoderConfig(threads=THREADS, apply_grain=False))
        out = []
        for tu in datas:
            out += dec.decode(tu)
        stats = dec.stats
        dec.close()
        return out, stats

    t0 = time.time()
    frames, stats = run()
    log(f"inter verify pass (incl compile): {time.time() - t0:.1f}s")
    n_dev = sum(1 for s in stats
                if not s["intra"] and s["recon_path"] == "device")
    log(f"inter frames on device: {n_dev}/{sum(1 for s in stats if not s['intra'])}")
    oracle = aomffi.oracle_decode_ivf(STREAM_INTER)
    bad = 0
    for fr, ora in zip(frames, oracle):
        refp = [np.asarray(x).astype(np.int64)
                for x in (ora.y, ora.u, ora.v) if x is not None]
        bad += sum(int((np.asarray(m)[:r.shape[0], :r.shape[1]] != r)
                       .sum()) for m, r in zip(fr.planes, refp))
    log(f"inter bit-exact gate: {'PASS' if bad == 0 else f'FAIL ({bad} px)'}")
    best = 0.0
    for it in range(2):
        t0 = time.time()
        frames, _ = run()
        fps = len(frames) / (time.time() - t0)
        log(f"inter timed iter {it}: {fps:.2f} fps")
        best = max(best, fps)
    return (0.0 if bad else round(best, 4)), n_dev, bad


KB = 4  # device sub-batch size (fixed so jit keys stay stable)


def decode_stream_pipelined(datas, fetch=True):
    """Decode all frames with host/device overlap: device-eligible
    frames run in fixed-size sub-batches through the batched wavefront
    (levels lockstep across frames — amortizes per-window dispatch);
    the HOST prep of sub-batch k+1 (residual itx lanes, lane packing,
    deblock maps) runs on a worker thread while the device executes
    sub-batch k.  Host-pipeline frames decode inline.  Returns list of
    per-frame plane lists (host int64 arrays)."""
    import jax
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from av1dec_tpu.bindings import NativeParser
    from av1dec_tpu.pipeline.device_recon import (DeviceRecon,
                                                  dispatch_batch,
                                                  prep_batch)
    from av1dec_tpu.pipeline.recon import FrameRecon

    parser = NativeParser(threads=THREADS)
    slots = []        # frame order: ("dev", batch_idx) | ("host", planes)
    dev_frames = []
    for d in datas:
        for hdr, plans in parser.parse_tu(d, with_plans=True):
            dr = DeviceRecon(parser.seq, hdr, plans)
            if dr.supported():
                slots.append(("dev", len(dev_frames)))
                dev_frames.append(dr)
            else:
                slots.append(
                    ("host", FrameRecon(parser.seq, hdr, plans).run()))
    # sub-batches, padded by repeating the last frame so every batch
    # has the same K (stable jit key); pad outputs are discarded
    chunks = []
    for i in range(0, len(dev_frames), KB):
        ch = dev_frames[i:i + KB]
        n_real = len(ch)
        while len(ch) < KB:
            ch = ch + [ch[-1]]
        chunks.append((ch, n_real))
    dev_out = []
    if chunks:
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(prep_batch, chunks[0][0])
            for i, (ch, n_real) in enumerate(chunks):
                prep = fut.result()
                if i + 1 < len(chunks):
                    fut = ex.submit(prep_batch, chunks[i + 1][0])
                dev_out += dispatch_batch(ch, prep)[:n_real]
    if not fetch:
        for planes in dev_out:
            for p in planes:
                p.block_until_ready()
        return None
    out = []
    for kind, v in slots:
        if kind == "dev":
            dr = dev_frames[v]
            planes = [np.asarray(p).astype(np.int64)
                      for p in jax.device_get(dev_out[v])]
            pre = None
            if dr._pre_cdef_dev is not None:
                pre = [np.asarray(p).astype(np.int64)
                       for p in jax.device_get(dr._pre_cdef_dev)]
            out.append(dr.finish_host(planes, pre))
        else:
            out.append([np.asarray(p) for p in v])
    return out


def main():
    import numpy as np

    import aomffi
    from av1dec_tpu.bindings import NativeParser

    datas = [d for _, d in aomffi.read_ivf(STREAM)]

    import jax

    from av1dec_tpu import compile_cache
    compile_cache.enable()
    log(f"bench: device={jax.devices()[0]}, entropy threads={THREADS}")

    # --- stage timer: entropy front-half alone (warm pass: the first
    # parse pays file-cache/allocator warmup that earlier rounds
    # misread as an entropy regression)
    n = 0
    for warm in range(2):
        t0 = time.time()
        p = NativeParser(threads=THREADS)
        n = 0
        for d in datas:
            for _ in p.parse_tu(d, with_plans=True):
                n += 1
    t_entropy = (time.time() - t0) / n
    log(f"stage entropy: {t_entropy * 1000:.1f} ms/frame "
        f"({THREADS} threads, warm)")

    # --- verification pass (untimed; also warms device compiles)
    oracle = aomffi.oracle_decode_ivf(STREAM)
    t0 = time.time()
    decoded = decode_stream_pipelined(datas)
    log(f"verify pass (incl compile): {time.time() - t0:.1f}s")
    bad = 0
    for fi, planes in enumerate(decoded):
        refp = [x.astype(np.int64) for x in
                (oracle[fi].y, oracle[fi].u, oracle[fi].v) if x is not None]
        bad += sum(int((m[:r.shape[0], :r.shape[1]] != r).sum())
                   for m, r in zip(planes, refp))
    log(f"bit-exact gate: {'PASS' if bad == 0 else f'FAIL ({bad} px)'}")

    # --- timed decode (pipelined, steady state).  AV1DEC_PROFILE=<dir>
    # wraps the timed loop in a jax.profiler trace (xplane dump for
    # tensorboard / xprof) [SURVEY §5.1 tracing].
    import contextlib
    prof_dir = os.environ.get("AV1DEC_PROFILE")
    prof = (jax.profiler.trace(prof_dir) if prof_dir
            else contextlib.nullcontext())
    best = 0.0
    with prof:
        for it in range(3):
            t0 = time.time()
            decode_stream_pipelined(datas, fetch=True)
            fps = n / (time.time() - t0)
            log(f"timed iter {it}: {fps:.2f} fps")
            best = max(best, fps)

    # --- inter stream through the public API (device MC path)
    fps_inter, n_dev_inter, bad_inter = bench_inter(log)

    # --- baseline: libaom decoder on the same stream
    dec = aomffi.AomDecoder()
    t0 = time.time()
    cnt = 0
    for d in datas:
        cnt += len(dec.decode(d))
    cnt += len(dec.decode(None))
    base = cnt / (time.time() - t0)
    log(f"libaom baseline: {base:.2f} fps")

    value = 0.0 if bad else round(best, 4)
    print(json.dumps({
        "metric": "fps_1080p_intra",
        "value": value,
        "unit": "frames/s",
        "vs_baseline": round(value / base, 4) if base else 0.0,
        "extra": {"fps_1080p_inter": fps_inter,
                  "inter_device_frames": n_dev_inter},
    }))


if __name__ == "__main__":
    main()
