"""Probe: device wavefront compile + warm times on the real backend.

Usage: python tools/probe_device.py [n_frames]
"""
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    import jax

    import aomffi
    from av1dec_tpu import compile_cache
    import bench
    from av1dec_tpu.bindings import NativeParser
    from av1dec_tpu.pipeline.device_recon import (DeviceRecon,
                                                  run_device_batch)

    compile_cache.enable()
    datas = [d for _, d in aomffi.read_ivf(bench.STREAM)][:n]
    print(f"device={jax.devices()[0]}", flush=True)
    parser = NativeParser(threads=2)
    t0 = time.time()
    drs = []
    for d in datas:
        for hdr, plans in parser.parse_tu(d, with_plans=True):
            dr = DeviceRecon(parser.seq, hdr, plans)
            assert dr.supported()
            drs.append(dr)
    print(f"entropy+sched: {(time.time() - t0) / len(drs) * 1000:.0f} "
          f"ms/frame", flush=True)

    for it in range(4):
        t0 = time.time()
        outs = run_device_batch(drs)
        for planes in outs:
            for p in planes:
                p.block_until_ready()
        dt = time.time() - t0
        print(f"iter {it}: batch {dt * 1000:.0f} ms "
              f"({dt / len(drs) * 1000:.0f} ms/frame, "
              f"{len(drs) / dt:.2f} fps)", flush=True)


if __name__ == "__main__":
    main()
