"""Native front-half tests: bit reader descriptors + OBU/header parsing.

The header parse is validated against streams generated locally with the
libaom encoder; field values are cross-checked against what the encoder
was configured to produce (SURVEY.md §4, M0 exit test).
"""

import os
import sys

import aomffi
import pytest

from av1dec_tpu.bindings import NativeParser


def test_bitreader_selftest(native_lib):
    # hand-built byte strings vs expected values [SPEC §4.10]
    assert native_lib.av1n_selftest() == 0


def _parse_all(path, tiles=False):
    p = NativeParser()
    p.set_decode_tiles(tiles)  # header-level tests; tile decode has its own
    headers = []
    for _, data in aomffi.read_ivf(path):
        headers.extend(p.parse_tu(data))
    return p.seq, headers


def test_intra_tile_decode(stream_factory):
    """Full entropy decode of intra frames must succeed without desync
    and produce plausible plan statistics (M1 exit test)."""
    path = stream_factory("intra_m1", w=192, h=128, frames=3, kf_max_dist=1)
    p = NativeParser()
    n_frames = 0
    for _, data in aomffi.read_ivf(path):
        for hdr, plans in p.parse_tu(data, with_plans=True):
            n_frames += 1
            assert plans.mi_rows == 32 and plans.mi_cols == 48
            assert len(plans.tx) > 100
            # all emitted modes are valid intra modes
            assert plans.grid("mode").min() >= 0
            assert plans.grid("mode").max() < 13
            assert plans.tx[:, 5].max() <= 1024  # eob within bounds
            # every mi cell was covered by some block
            assert (plans.grid("bsize") >= 0).all()
    assert n_frames == 3


def test_parse_8bit_stream(stream_factory):
    path = stream_factory("parse8", w=192, h=128, frames=10)
    seq, headers = _parse_all(path)
    assert seq["max_frame_width"] == 192
    assert seq["max_frame_height"] == 128
    assert seq["bit_depth"] == 8
    assert (seq["subsampling_x"], seq["subsampling_y"]) == (1, 1)
    assert len(headers) == 10
    assert headers[0]["frame_type"] == 0  # KEY_FRAME
    for h in headers:
        assert h["frame_width"] == 192
        assert h["frame_height"] == 128
        assert h["mi_cols"] == 48 and h["mi_rows"] == 32
        assert 0 <= h["quant"]["base_q_idx"] <= 255
        assert h["tiles"]["cols"] >= 1 and h["tiles"]["rows"] >= 1
        assert sum(h["tile_sizes"]) > 0
    for h in headers[1:]:
        assert h["frame_type"] == 1  # INTER_FRAME
        assert all(0 <= r < 8 for r in h["ref_frame_idx"])


def test_parse_10bit_stream(stream_factory):
    path = stream_factory("parse10", w=160, h=96, frames=3, bit_depth=10)
    seq, headers = _parse_all(path)
    assert seq["bit_depth"] == 10
    assert len(headers) == 3


def test_parse_keyframe_only(stream_factory):
    path = stream_factory("kf_only", w=128, h=64, frames=4, kf_max_dist=1)
    seq, headers = _parse_all(path)
    assert len(headers) == 4
    assert all(h["frame_type"] == 0 for h in headers)


def test_parse_multi_tile(stream_factory):
    path = stream_factory(
        "tiles4", w=512, h=256, frames=3,
        options=[("tile-columns", "1"), ("tile-rows", "1")])
    seq, headers = _parse_all(path)
    assert headers[0]["tiles"]["cols"] == 2
    assert headers[0]["tiles"]["rows"] == 2
    assert len(headers[0]["tile_sizes"]) == 4


def test_parse_monochrome(stream_factory):
    path = stream_factory("mono", w=128, h=64, frames=2, monochrome=True)
    seq, headers = _parse_all(path)
    assert seq["mono_chrome"] == 1
    assert len(headers) == 2


def test_oracle_md5_stability(stream_factory):
    # the oracle itself must be deterministic (foundation of all MD5 tests)
    path = stream_factory("parse8", w=192, h=128, frames=10)
    f1 = aomffi.oracle_decode_ivf(path)
    f2 = aomffi.oracle_decode_ivf(path)
    assert [f.md5() for f in f1] == [f.md5() for f in f2]
    assert len(f1) == 10


def _tile_parallel_stream(name, spec_stream):
    if name == "tiles":
        return spec_stream("tiles")
    # multi-tile INTER stream (shared FrameMotionContext, per-tile
    # neighbor grids, tile-clamped ref-MV scans under threads)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    import gen_inter_battery as gb
    outdir = "/tmp/inter_battery"
    os.makedirs(outdir, exist_ok=True)
    return gb.gen_case("tile0", gb.CASES["tile0"], outdir)


@pytest.mark.parametrize("name", ["tiles", "tile0"])
def test_tile_parallel_entropy_matches_serial(name, native_lib,
                                              spec_stream):
    """threads=N tile decode == serial, on multi-tile intra AND inter
    streams [SURVEY §2.4 tile parallelism]."""
    import numpy as np

    import aomffi
    from av1dec_tpu.bindings import NativeParser
    path = _tile_parallel_stream(name, spec_stream)
    ser, par = NativeParser(), NativeParser(threads=2)
    checked = 0
    for _, d in aomffi.read_ivf(path):
        for (h1, p1), (h2, p2) in zip(ser.parse_tu(d, with_plans=True),
                                      par.parse_tu(d, with_plans=True)):
            assert (p1 is None) == (p2 is None)
            if p1 is None:
                continue
            for attr in ("mi", "tx", "coeffs", "palettes", "color_map",
                         "lr", "warps"):
                a, b = getattr(p1, attr), getattr(p2, attr)
                assert a.shape == b.shape
                assert (np.asarray(a) == np.asarray(b)).all()
            checked += 1
    assert checked > 0


def test_sanitizer_builds_decode_clean(native_lib):
    """ASan/UBSan and TSan builds decode a multi-tile stream with no
    findings (SURVEY §5.2).  Builds are cached by make."""
    import subprocess
    nd = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "av1dec_tpu", "native")
    subprocess.run(["make", "-s", "asan-check", "tsan-check"], cwd=nd,
                   check=True)
    streams = ["/tmp/pytest_streams/tiles.ivf"]
    if os.path.exists("/tmp/inter_battery/tile0.ivf"):
        streams.append("/tmp/inter_battery/tile0.ivf")
    for build in ("build-asan", "build-tsan"):
        for stream in streams:
            r = subprocess.run(
                [os.path.join(nd, build, "av1dec_check"), stream, "2"],
                capture_output=True, text=True)
            assert r.returncode == 0, r.stderr
            assert "WARNING" not in r.stderr, r.stderr


def test_native_library_exports_only_c_api(native_lib):
    """The shared library exports its C API (av1n_*) and nothing else
    (native/exports.map), so none of its C++ symbols binds to another
    object in the process."""
    import shutil
    import subprocess

    from av1dec_tpu import bindings
    nm = shutil.which("nm")
    assert nm, "binutils nm is needed to list the exported symbols"
    out = subprocess.run([nm, "-D", "--defined-only", bindings._LIB_PATH],
                         capture_output=True, text=True, check=True).stdout
    names = [line.split()[-1] for line in out.splitlines() if line.strip()]
    assert "av1n_parse_tu" in names
    assert [n for n in names if not n.startswith("av1n_")] == []


_STATIC_PARSE = """
import json, sys
import jax  # loads the shared libstdc++.so.6 before the native library
import aomffi
from av1dec_tpu.bindings import NativeParser
p = NativeParser()
hdrs = [h for _, d in aomffi.read_ivf(sys.argv[1]) for h in p.parse_tu(d)]
print(json.dumps(hdrs, sort_keys=True))
"""


def test_static_libstdcxx_build_parses_after_jax(tmp_path):
    """A build that links libstdc++ statically keeps that copy to itself:
    exported, its locale statics (STB_GNU_UNIQUE) bound to the
    libstdc++.so.6 that `import jax` loads, and the frame JSON came out
    corrupt.  After `import jax` it must parse as the shared build does."""
    import json
    import shutil
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    nd = tmp_path / "native"
    shutil.copytree(os.path.join(repo, "av1dec_tpu", "native"), nd,
                    ignore=shutil.ignore_patterns("build*"))
    subprocess.run(["make", "-s", "-j4", "CXX=g++ -static-libstdc++"],
                   cwd=nd, check=True, capture_output=True)
    lib = nd / "build" / "libav1dec_native.so"
    stream = os.path.join(repo, "streams", "postfilter_384x192.ivf")
    env = dict(os.environ, AV1DEC_NATIVE_LIB=str(lib),
               PYTHONPATH=os.pathsep.join([repo, os.path.join(repo, "tools")]))
    r = subprocess.run([sys.executable, "-c", _STATIC_PARSE, stream],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    _, want = _parse_all(stream, tiles=True)
    assert json.loads(r.stdout) == json.loads(json.dumps(want,
                                                         sort_keys=True))
