"""Stage-level timing of the batched device path on the real backend."""
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import aomffi
    import bench
    from av1dec_tpu import compile_cache
    from av1dec_tpu.bindings import NativeParser
    from av1dec_tpu.ops.kernels.wavefront import (CHUNK, make_windows,
                                                  run_wavefront_chunk)
    from av1dec_tpu.pipeline import device_recon as DR

    compile_cache.enable()
    datas = [d for _, d in aomffi.read_ivf(bench.STREAM)]
    print(f"device={jax.devices()[0]}", flush=True)
    parser = NativeParser(threads=2)
    drs = []
    t0 = time.time()
    for d in datas:
        for hdr, plans in parser.parse_tu(d, with_plans=True):
            drs.append(DR.DeviceRecon(parser.seq, hdr, plans))
    print(f"host parse+sched: {(time.time()-t0)/len(drs)*1000:.0f} "
          f"ms/frame", flush=True)

    for it in range(3):
        K = len(drs)
        sch0 = drs[0].sch
        caps = DR._caps_for(sch0, batch=True)
        flat = sch0.flat_len + DR.FLAT_PAD
        Pcap = {t: DR._cap(caps, "P", t,
                           max(dr._pal_tot[t] for dr in drs))
                for t in DR.BUCKETS}

        t0 = time.time()
        bufs = [dr._residuals_flat_np() for dr in drs]
        t_resc = time.time() - t0
        t0 = time.time()
        rf = caps["RF"]
        rf[0] = max(rf[0], DR._pow2(max(max(len(b) for b in bufs), 1)))
        res_np = np.zeros(K * rf[0], bufs[0].dtype)
        for f, b in enumerate(bufs):
            res_np[f * rf[0]: f * rf[0] + len(b)] = b
        res = jnp.asarray(res_np)
        res.block_until_ready()
        t_resu = time.time() - t0

        t0 = time.time()
        pal = {t: jnp.asarray(np.concatenate(
            [dr._palette_tensor(t, Pcap[t]) for dr in drs], axis=0))
            for t in DR.BUCKETS}
        L = max(dr.sch.n_levels for dr in drs)
        buckets = []
        inputs = {}
        for t in DR.BUCKETS:
            rows_all, lv_all = [], []
            for f, dr in enumerate(drs):
                arr, lv = dr._bucket_rows(t)
                arr = arr.copy()
                arr[:, DR._DEV_F["base"]] += f * flat
                arr[:, DR._DEV_F["lbase"]] += f * flat
                ridx = arr[:, DR._DEV_F["res_idx"]]
                arr[:, DR._DEV_F["res_idx"]] = np.where(
                    ridx >= 0, ridx + f * rf[0], -1)
                pidx = arr[:, DR._DEV_F["pal_idx"]]
                arr[:, DR._DEV_F["pal_idx"]] = np.where(
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
            n_cap = DR._cap(caps, "N", t, len(arr))
            packed = DR._pad_rows(arr, n_cap + DR.BWIN[t])
            buckets.append((t, DR.BWIN[t]))
            inputs[t] = (jnp.asarray(packed), starts, counts)
        for t in DR.BUCKETS:
            inputs[t][0].block_until_ready()
        t_pack = time.time() - t0

        ts = [t for t, _ in buckets]
        ws, wc = make_windows({t: inputs[t][1] for t in ts},
                              {t: inputs[t][2] for t in ts},
                              {t: b for t, b in buckets}, ts)
        S = ws.shape[0]
        n_chunks = max(1, -(-S // CHUNK))
        pad = n_chunks * CHUNK - S
        if pad:
            ws = np.pad(ws, ((0, pad), (0, 0)))
            wc = np.pad(wc, ((0, pad), (0, 0)))
        config = (tuple(buckets), sch0.bd, sch0.sub_x, sch0.sub_y,
                  sch0.enable_edge_filter)
        packed_d = {t: inputs[t][0] for t in ts}
        t0 = time.time()
        frame = jnp.zeros(K * flat, jnp.int32)
        for k in range(n_chunks):
            sl = slice(k * CHUNK, (k + 1) * CHUNK)
            frame = run_wavefront_chunk(
                frame, packed_d, jnp.asarray(ws[sl]),
                jnp.asarray(wc[sl]), res, pal, config)
        frame.block_until_ready()
        t_scan = time.time() - t0

        t0 = time.time()
        outs = []
        for f, dr in enumerate(drs):
            final, _pre = dr._post_device(jnp, frame, f * flat)
            outs.append(final)
        for planes in outs:
            for p in planes:
                p.block_until_ready()
        t_post = time.time() - t0

        t0 = time.time()
        jax.device_get(outs)
        t_fetch = time.time() - t0
        tot = t_resc + t_resu + t_pack + t_scan + t_post + t_fetch
        print(f"iter {it}: S={S} resC {t_resc:.2f} resU {t_resu:.2f} "
              f"pack {t_pack:.2f} scan({n_chunks}ch) {t_scan:.2f} "
              f"postfilter {t_post:.2f} fetch {t_fetch:.2f} "
              f"total {tot:.2f}s ({len(drs)/tot:.2f} fps)", flush=True)


if __name__ == "__main__":
    main()
