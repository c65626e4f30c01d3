"""Test configuration.

All JAX tests run on the CPU backend with 8 virtual devices, so the
sharded/multi-device paths run without accelerator hardware (SURVEY.md
§4 "Distributed / multi-host" row).  Tests that need an NVIDIA GPU are
marked `gpu` and skip elsewhere through the `gpu_device` fixture;
`python chip_smoke.py` on a GPU machine runs what they cover.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (_REPO, os.path.join(_REPO, "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)

import hashlib
import subprocess

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere, from the "
        "gpu_device fixture)")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when JAX has none.  Decided here,
    at run time, so every worker collects the same tests."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError as e:
        pytest.skip(f"no GPU: {e}")


@pytest.fixture(scope="session")
def native_lib():
    from av1dec_tpu import bindings

    bindings.rebuild_native()
    return bindings._load()


def _synth_frame(w, h, t, rng, bit_depth=8):
    """Synthetic video frame with structure + noise (shared by stream gens)."""
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx + yy + 4 * t) % 256).astype(np.int64)
    y[(yy // 16 + t) % 8 == 0] = 200
    y += rng.integers(-8, 8, y.shape)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    u = ((xx[:ch, :cw] // 2 + 16 * t) % 256).astype(np.int64)
    v = ((yy[:ch, :cw] // 2 + 128) % 256).astype(np.int64)
    shift = bit_depth - 8
    dt = np.uint16 if bit_depth > 8 else np.uint8
    clip = (1 << 8) - 1
    y = np.clip(y, 0, clip).astype(dt) << shift
    u = np.clip(u, 0, clip).astype(dt) << shift
    v = np.clip(v, 0, clip).astype(dt) << shift
    return y, u, v


# ---------------------------------------------------------------------------
# Spec-feature stream matrix (SURVEY.md §4 conformance tier).  Defined here —
# not discovered from /tmp at collection time — so every test module that
# parametrizes over SPEC_CASES collects the full set on a fresh machine.
# ---------------------------------------------------------------------------

SPEC_CASES = {
    # name -> encoder spec
    "base":    dict(w=64, h=64, n=1, cq=8),
    "odd":     dict(w=67, h=45, n=1, cq=8),
    "hi_q":    dict(w=96, h=64, n=1, cq=55),       # deblock active
    "cdef":    dict(w=96, h=96, n=1, cq=55,
                    extra=[("enable-cdef", "1")]),
    "lr":      dict(w=128, h=96, n=1, cq=45, cpu=3, noise=25,
                    extra=[("enable-restoration", "1")]),
    "bd10":    dict(w=64, h=64, n=1, cq=30, bit_depth=10),
    "mono":    dict(w=64, h=64, n=1, cq=30, mono=True),
    "i444":    dict(w=64, h=64, n=1, cq=30, subsampling=(0, 0)),
    "lossless": dict(w=64, h=48, n=1, cq=0, extra=[("lossless", "1")]),
    "multi":   dict(w=96, h=64, n=2, cq=30),
    "tiles":   dict(w=256, h=192, n=1, cq=50,
                    extra=[("tile-columns", "1"), ("tile-rows", "1"),
                           ("enable-cdef", "1"),
                           ("enable-restoration", "1")]),
    "rect64":  dict(w=32, h=64, n=1, cq=50, noise=8),
    "qm":      dict(w=128, h=96, n=1, cq=40,
                    extra=[("enable-qm", "1"), ("qm-min", "0"),
                           ("qm-max", "4")]),
    "qm_444":  dict(w=96, h=96, n=1, cq=45, subsampling=(0, 0),
                    extra=[("enable-qm", "1"), ("qm-min", "2"),
                           ("qm-max", "6")]),
    "sres":    dict(w=192, h=128, n=2, cq=45, superres_denom=12),
    "sres_lr": dict(w=192, h=128, n=2, cq=45, cpu=3, noise=25,
                    superres_denom=12,
                    extra=[("enable-restoration", "1")]),
}


def gen_spec_stream(name):
    """Generate (once) the named spec-case stream under /tmp/pytest_streams."""
    import aomffi
    spec = SPEC_CASES[name]
    path = os.path.join("/tmp/pytest_streams", name + ".ivf")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(hash(name) % 2**32)
    w, h = spec["w"], spec["h"]
    bd = spec.get("bit_depth", 8)
    ss = spec.get("subsampling", (1, 1))
    mono = spec.get("mono", False)
    noise = spec.get("noise", 12)
    opts = [("enable-cdef", "0"), ("enable-restoration", "0"),
            ("cq-level", str(spec["cq"]))] + spec.get("extra", [])
    enc = aomffi.AomEncoder(w, h, bit_depth=bd, subsampling=ss,
                            cpu_used=spec.get("cpu", 6), kf_max_dist=1,
                            lag=0, options=opts, monochrome=mono,
                            end_usage=3,
                            superres_denom=spec.get("superres_denom"))
    hi = 1 << bd
    dt = np.uint16 if bd > 8 else np.uint8
    yy, xx = np.mgrid[:h, :w]
    pkts = []
    for i in range(spec["n"]):
        y = (hi // 2 + (hi // 4) * np.sin(xx / 9.0) * np.cos(yy / 11.0) +
             rng.normal(0, noise * hi / 256, (h, w))).clip(0, hi - 1) \
            .astype(dt)
        if mono:
            u = v = None
        else:
            sx, sy = ss
            cw, ch = (w + sx) >> sx, (h + sy) >> sy
            u = (hi // 2 + rng.normal(0, 10 * hi / 256, (ch, cw))) \
                .clip(0, hi - 1).astype(dt)
            v = (hi // 2 + rng.normal(0, 10 * hi / 256, (ch, cw))) \
                .clip(0, hi - 1).astype(dt)
        pkts += enc.encode(y, u, v, pts=i)
    pkts += enc.flush()
    enc.close()
    aomffi.write_ivf(path, pkts, w, h)
    return path


@pytest.fixture(scope="session")
def spec_stream():
    """Session fixture: name -> generated stream path."""
    return gen_spec_stream


@pytest.fixture(scope="session")
def stream_factory(tmp_path_factory):
    """Factory fixture: generate an IVF test stream with given params."""
    import aomffi

    base = tmp_path_factory.mktemp("streams")
    cache = {}

    def make(name="default", w=192, h=128, frames=10, bit_depth=8,
             kf_max_dist=9999, bitrate=400, options=(), monochrome=False,
             cpu_used=9):
        key = (name, w, h, frames, bit_depth, kf_max_dist, bitrate,
               tuple(options), monochrome)
        if key in cache:
            return cache[key]
        rng = np.random.default_rng(hash(name) & 0xFFFF)
        enc = aomffi.AomEncoder(
            w, h, bit_depth=bit_depth, cpu_used=cpu_used, bitrate_kbps=bitrate,
            kf_max_dist=kf_max_dist, lag=0, options=list(options),
            monochrome=monochrome)
        pkts = []
        for t in range(frames):
            pkts += enc.encode(*_synth_frame(w, h, t, rng, bit_depth), pts=t)
        pkts += enc.flush()
        enc.close()
        path = str(base / f"{name}.ivf")
        aomffi.write_ivf(path, pkts, w, h)
        cache[key] = path
        return path

    return make
