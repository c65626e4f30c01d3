"""Smoke run of the decoder on an NVIDIA GPU, end to end.

    python chip_smoke.py                # one GPU: phases 1-8 below
    python chip_smoke.py --four-cards   # four GPUs: the sharded paths only

Decodes the committed 1080p streams in streams/ through the entry points
users call and checks every output frame's MD5 against libaom's, which
tools/make_smoke_streams.py recorded in streams/md5.json.  AV1 decoding
is normative and every device stage is integer, so the tolerance is 0.

Phases (one GPU): 1 device check, 2 native build, 3 intra stream and
4 inter stream through api.Decoder, 5 superres + Wiener LR stream,
6 the CLI in this process, 7 the batched device path
(prep_batch + dispatch_batch), 8 XLA CDEF alone at 1080p.
With --four-cards: the device check, then frame sharding over a 4-card
`data` mesh and api.Decoder with space_shards=4, each compared with
one card.

Timings printed here are smoke timings of one cold and one warm pass,
labelled with the card's name and power limit; they are not a
benchmark.  Any failure raises (non-zero exit); the last line of
stdout is one JSON object, {"ok": true, "device": {...}}, printed only
when every phase passed.  There is no CPU fallback.
"""
import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
STREAMS = os.path.join(_REPO, "streams")


def say(msg):
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def device_check(n_cards=1):
    """JAX's devices must be at least `n_cards` GPUs.  Returns them."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX found {len(devs)} {devs[0].platform} device(s) "
            f"({devs[0].device_kind}); this smoke runs on an NVIDIA GPU "
            f"only")
    if len(devs) < n_cards:
        raise SmokeFailure(f"need {n_cards} GPUs, JAX found {len(devs)}")
    return devs[:n_cards]


def card_line():
    """`name, power.limit` of the first card, as nvidia-smi reports it
    (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class CompileLog:
    """Backend compile seconds per jitted function, and persistent
    cache hits/misses, from JAX's monitoring events."""

    def __init__(self):
        import jax
        self.secs = {}
        self.events = {}
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            name = kw.get("fun_name", "?")
            self.secs[name] = self.secs.get(name, 0.0) + duration

    def _event(self, event, **kw):
        if event.startswith("/jax/compilation_cache/"):
            key = event.rsplit("/", 1)[1]
            self.events[key] = self.events.get(key, 0) + 1

    def summary(self):
        top = sorted(self.secs.items(), key=lambda kv: -kv[1])[:6]
        return (f"{sum(self.secs.values()):.1f} s backend compile in all; "
                + ", ".join(f"{k} {v:.1f} s" for k, v in top)
                + f"; persistent cache {self.events}")


class Recorder:
    """Records the arguments of the last call of a module-level jitted
    function: abstractly (to lower it again for memory_analysis) and,
    with keep=True, the arrays themselves (to call it again)."""

    def __init__(self, module, name, keep=False):
        self.module, self.name, self.keep = module, name, keep
        self.fn = getattr(module, name)
        self.args = self.concrete = None

    def __enter__(self):
        import jax

        def spec(x):
            return (jax.ShapeDtypeStruct(x.shape, x.dtype)
                    if isinstance(x, jax.Array) else x)

        def wrapped(*args, **kw):
            self.args = (jax.tree.map(spec, args), kw)
            if self.keep:
                self.concrete = (args, kw)
            return self.fn(*args, **kw)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def memory(self):
        args, kw = self.args
        m = self.fn.lower(*args, **kw).compile().memory_analysis()
        return (f"args {m.argument_size_in_bytes} B, out "
                f"{m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B,"
                f" alias {m.alias_size_in_bytes} B, code "
                f"{m.generated_code_size_in_bytes} B")


def load_md5s():
    with open(os.path.join(STREAMS, "md5.json")) as f:
        return json.load(f)


def first_difference(path, index, got_planes):
    """Decode `path` with the NumPy spec pipeline (the plain reference)
    up to frame `index` and describe the first differing pixel."""
    import numpy as np

    from av1dec_tpu.api import Decoder
    from av1dec_tpu.config import DecoderConfig
    from av1dec_tpu.container import read_ivf
    dec = Decoder(DecoderConfig(platform="off", apply_grain=False))
    ref = []
    for _, tu in read_ivf(path):
        ref += dec.decode(tu)
        if len(ref) > index:
            break
    dec.close()
    for p, (g, r) in enumerate(zip(got_planes, ref[index].planes)):
        g, r = np.asarray(g), np.asarray(r)
        bad = np.argwhere(g != r)
        if len(bad):
            y, x = bad[0]
            return (f"plane {p} pixel (y={y}, x={x}): got {g[y, x]}, "
                    f"reference {r[y, x]}; {len(bad)} pixels differ")
    return "planes equal the host reference; MD5 record differs"


def check_frames(label, path, frames, want):
    """Every frame's MD5 must equal libaom's; on a mismatch name the
    first differing frame, plane and pixel, then fail."""
    got = [f.md5() for f in frames]
    if len(got) != len(want):
        raise SmokeFailure(f"{label}: {len(got)} frames, libaom has "
                           f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise SmokeFailure(
                f"{label}: frame {i} MD5 {g} != libaom {w}: "
                + first_difference(path, i, frames[i].planes))
    say(f"{label}: {len(got)}/{len(want)} frame MD5s equal libaom's")


def decode_api(path, platform, **cfg):
    """Whole stream through api.Decoder; returns (frames, stats, s)."""
    from av1dec_tpu.api import Decoder
    from av1dec_tpu.config import DecoderConfig
    from av1dec_tpu.container import read_ivf
    tus = [tu for _, tu in read_ivf(path)]
    t0 = time.perf_counter()
    dec = Decoder(DecoderConfig(platform=platform, apply_grain=False,
                                **cfg))
    frames = []
    for tu in tus:
        frames += dec.decode(tu)
    dt = time.perf_counter() - t0
    stats = dec.stats
    dec.close()
    return frames, stats, dt


def stream_phase(label, name, platform, card, md5s, check_stats):
    """Cold pass (compile included) and warm pass through api.Decoder,
    both checked against libaom's MD5s."""
    path = os.path.join(STREAMS, name)
    want = md5s[name]["frames"]
    runs = []
    for kind in ("cold", "warm"):
        frames, stats, dt = decode_api(path, platform)
        check_frames(f"{label} {kind}", path, frames, want)
        check_stats(stats)
        runs.append((kind, len(frames), dt))
    say(f"{label} smoke timing [{card}]: " + "; ".join(
        f"{k} {dt:.3f} s ({n / dt:.3f} frames/s)" for k, n, dt in runs))


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_native():
    from av1dec_tpu import bindings
    t0 = time.perf_counter()
    bindings.rebuild_native()
    bindings._load()
    say(f"native build (set-up): {time.perf_counter() - t0:.1f} s")


def phase_intra(platform, card, md5s):
    import jax

    from av1dec_tpu.ops.kernels import wavefront as wf_k
    from av1dec_tpu.pipeline import device_recon as dr_mod

    def check(stats):
        dev = sum(s["recon_path"] == "device" for s in stats)
        need(dev == len(stats), f"intra: {dev}/{len(stats)} frames on "
             f"the device")
        say(f"intra: {dev}/{len(stats)} frames with recon_path == device")

    with Recorder(wf_k, "run_wavefront_chunk") as wf_rec, \
            Recorder(dr_mod, "_postfilter_chain") as pf_rec:
        stream_phase("intra", "intra_1080p.ivf", platform, card, md5s,
                     check)
    say(f"memory_analysis run_wavefront_chunk: {wf_rec.memory()}")
    say(f"memory_analysis _postfilter_chain: {pf_rec.memory()}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def phase_inter(platform, card, md5s):
    def check(stats):
        inter = [s for s in stats if not s["intra"]]
        dev = sum(s["recon_path"] == "device" for s in inter)
        need(inter and dev == len(inter),
             f"inter: {dev}/{len(inter)} inter frames on the device")
        say(f"inter: {dev}/{len(inter)} inter frames with recon_path == "
            f"device")

    stream_phase("inter", "inter_1080p.ivf", platform, card, md5s, check)


def phase_postfilter(platform, card, md5s):
    def check(stats):
        n = len(stats)
        sr = sum(s["superres_device"] for s in stats)
        lr = sum(s["lr_device"] for s in stats)
        need(sr == n, f"postfilter: superres on the device in {sr}/{n} "
             f"frames")
        say(f"postfilter: superres on the device in {sr}/{n} frames, "
            f"Wiener LR on the device in {lr}/{n} frames")

    stream_phase("postfilter", "postfilter_1080p.ivf", platform, card,
                 md5s, check)


def phase_cli(platform, md5s):
    from av1dec_tpu import cli
    path = os.path.join(STREAMS, "intra_1080p.ivf")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([path, "--device", platform, "--md5"])
    got = buf.getvalue().strip().splitlines()[-1]
    want = md5s["intra_1080p.ivf"]["stream_md5"]
    need(rc == 0 and got == want,
         f"cli: rc {rc}, stream MD5 {got} != libaom {want}")
    say(f"cli --device {platform} --md5: {got} equals libaom's")


def parse_device_recons(path, n):
    from av1dec_tpu.bindings import NativeParser
    from av1dec_tpu.container import read_ivf
    from av1dec_tpu.pipeline.device_recon import DeviceRecon
    parser = NativeParser()
    drs = []
    for _, tu in read_ivf(path):
        for hdr, plans in parser.parse_tu(tu, with_plans=True):
            drs.append(DeviceRecon(parser.seq, hdr, plans))
        if len(drs) >= n:
            break
    need(all(dr.supported() for dr in drs[:n]),
         "device path refuses an intra frame")
    return drs[:n]


def planes_md5(planes):
    import numpy as np
    h = hashlib.md5()
    for p in planes:
        h.update(np.ascontiguousarray(np.asarray(p).astype(np.uint8))
                 .tobytes())
    return h.hexdigest()


def phase_batched(md5s):
    import jax

    from av1dec_tpu.pipeline.device_recon import dispatch_batch, prep_batch
    path = os.path.join(STREAMS, "intra_1080p.ivf")
    drs = parse_device_recons(path, 4)
    t0 = time.perf_counter()
    outs = dispatch_batch(drs, prep_batch(drs))
    host = jax.device_get(outs)
    dt = time.perf_counter() - t0
    want = md5s["intra_1080p.ivf"]["frames"][:4]
    got = [planes_md5(p) for p in host]
    for i, (g, w) in enumerate(zip(got, want)):
        need(g == w, f"batched: frame {i} MD5 {g} != libaom {w}")
    say(f"batched prep_batch + dispatch_batch: 4/4 frame MD5s equal "
        f"libaom's (cold, compile included: {dt:.3f} s)")


def phase_cdef(card):
    """XLA CDEF alone on a deblocked 1080p frame: exact against the
    NumPy oracle, and its warm time beside the fused postfilter's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from av1dec_tpu.ops.kernels import cdef as cdef_dev
    from av1dec_tpu.ops.kernels.wavefront import run_wavefront
    from av1dec_tpu.ops.spec import cdef_vec
    from av1dec_tpu.pipeline import device_recon as dr_mod

    dr = parse_device_recons(os.path.join(STREAMS, "intra_1080p.ivf"),
                             1)[0]
    sch = dr.sch
    res = dr._res_flat_dev(jnp, dr_mod._caps_for(sch))
    buckets, inputs, pal = dr._pack_buckets(jnp)
    config = (buckets, sch.bd, sch.sub_x, sch.sub_y, sch.enable_edge_filter)

    def scan():
        return run_wavefront(
            jnp.zeros(sch.flat_len + dr_mod.FLAT_PAD, jnp.int32),
            inputs, res, pal, config)

    frame = jax.block_until_ready(scan())
    with Recorder(dr_mod, "_postfilter_chain", keep=True) as pf_rec:
        dr._post_device(jnp, frame, 0)
    pf_args, pf_kw = pf_rec.concrete

    def post():  # the fused dispatch alone, host prep excluded
        return dr_mod._postfilter_chain(*pf_args, **pf_kw)

    planes = [p.astype(jnp.int32) for p in dr._deblock_device(
        jnp, dr._slice_planes(frame, 0))]
    gates = cdef_dev.compute_gates(dr.seq, dr.hdr, dr.plans, len(planes),
                                   sch.bd)
    need(gates is not None, "cdef: intra frame 0 has CDEF off")
    y_pri, y_sec, uv_pri, uv_sec, damping, subx, suby = gates
    g_dev = [jnp.asarray(g) for g in (y_pri, y_sec, uv_pri, uv_sec)]

    def cdef():
        return cdef_dev._cdef_all(tuple(planes), *g_dev, sch.bd, damping,
                                  subx, suby)

    got = [np.asarray(p) for p in jax.device_get(cdef())]
    ref = cdef_vec.cdef_frame([np.asarray(p).astype(np.int32) for p in
                               jax.device_get(planes)],
                              dr.seq, dr.hdr, dr.plans, sch.bd)
    for p, (g, r) in enumerate(zip(got, ref)):
        need((g == np.asarray(r)).all(),
             f"cdef: plane {p} differs from the NumPy oracle at "
             f"{np.argwhere(g != np.asarray(r))[:3].tolist()}")
    say(f"cdef: XLA _cdef_all equals the NumPy oracle on 3 planes at "
        f"{planes[0].shape[1]}x{planes[0].shape[0]}")

    def timed(fn, reps=20):
        jax.block_until_ready(fn())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    t_scan, t_post, t_cdef = timed(scan, 5), timed(post), timed(cdef)
    say(f"device timing [{card}], warm medians, intra frame 0 at "
        f"{planes[0].shape[1]}x{planes[0].shape[0]}: "
        f"run_wavefront {t_scan * 1e3:.3f} ms/frame; _postfilter_chain "
        f"dispatch {t_post * 1e3:.3f} ms; XLA _cdef_all alone "
        f"{t_cdef * 1e3:.3f} ms ({100 * t_cdef / t_post:.1f}% of the "
        f"postfilter dispatch)")


def phase_four_cards(devs, platform, md5s):
    """Frame sharding over a 4-card `data` mesh and api.Decoder with
    space_shards=4, each byte-compared with one card."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from av1dec_tpu.parallel.sharded_frames import decode_frames_sharded
    path = os.path.join(STREAMS, "intra_1080p.ivf")
    want = md5s["intra_1080p.ivf"]["frames"]
    drs = parse_device_recons(path, 4)
    mesh = Mesh(np.asarray(devs), ("data",))
    t0 = time.perf_counter()
    sharded = decode_frames_sharded(drs, mesh)
    say(f"frame-sharded decode of 4 frames on 4 cards: "
        f"{time.perf_counter() - t0:.3f} s cold")
    for i, (dr, got) in enumerate(zip(drs, sharded)):
        with jax.default_device(devs[0]):
            one = dr.run()
        for p, (a, b) in enumerate(zip(one, got)):
            need(np.array_equal(np.asarray(a), np.asarray(b)),
                 f"frame sharding: frame {i} plane {p} differs from one "
                 f"card")
        need(planes_md5(got) == want[i],
             f"frame sharding: frame {i} MD5 differs from libaom")
    say("frame sharding over data=4: 4/4 frames byte-identical to one "
        "card and equal to libaom's MD5s")
    frames, stats, dt = decode_api(path, platform, space_shards=4)
    check_frames("space_shards=4", path, frames, want)
    say(f"space_shards=4 decode: {len(frames)} frames, {dt:.3f} s cold")


def main(argv):
    four = "--four-cards" in argv
    n_cards = 4 if four else 1
    devs = device_check(n_cards)
    import jax

    from av1dec_tpu import compile_cache
    card = card_line()
    say(f"nvidia-smi: {card}")
    say(f"jax {jax.__version__}; devices {len(jax.devices())} x "
        f"{devs[0].device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}"
        f"; compile cache {compile_cache.enable()}")
    comp = CompileLog()
    t0 = time.perf_counter()
    phase_native()
    md5s = load_md5s()
    if four:
        phase_four_cards(devs, "gpu", md5s)
    else:
        phase_intra("gpu", card, md5s)
        phase_inter("gpu", card, md5s)
        phase_postfilter("gpu", card, md5s)
        phase_cli("gpu", md5s)
        phase_batched(md5s)
        phase_cdef(card)
    say(f"compile: {comp.summary()}")
    say(f"smoke total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
