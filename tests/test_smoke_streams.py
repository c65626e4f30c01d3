"""The committed smoke streams (streams/, written by
tools/make_smoke_streams.py) and their recorded libaom MD5s.

chip_smoke.py holds the GPU decoder to those MD5s on machines without
libaom, so here libaom itself must reproduce them.  The small
postfilter stream also runs the device path on the CPU backend: its
two loop-restoration unit rows make Wiener LR read across a unit-row
boundary.
"""
import json
import os

import pytest

_STREAMS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "streams")
_NAMES = ("intra_1080p.ivf", "inter_1080p.ivf", "postfilter_1080p.ivf",
          "postfilter_384x192.ivf")


def _record():
    with open(os.path.join(_STREAMS, "md5.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", _NAMES)
def test_committed_stream_md5s_match_libaom(name):
    import make_smoke_streams
    frames, whole = make_smoke_streams.oracle_md5s(
        os.path.join(_STREAMS, name))
    rec = _record()[name]
    assert frames == rec["frames"]
    assert whole == rec["stream_md5"]


def _decode(platform):
    from av1dec_tpu.api import Decoder
    from av1dec_tpu.config import DecoderConfig
    from av1dec_tpu.container import read_ivf
    dec = Decoder(DecoderConfig(platform=platform, apply_grain=False))
    frames = []
    for _, tu in read_ivf(os.path.join(_STREAMS,
                                       "postfilter_384x192.ivf")):
        frames += dec.decode(tu)
    dec.close()
    return frames, dec.stats


def test_device_postfilter_wiener_across_unit_rows():
    frames, stats = _decode("cpu")
    want = _record()["postfilter_384x192.ivf"]["frames"]
    assert [f.md5() for f in frames] == want
    assert all(s["recon_path"] == "device" and s["superres_device"] and
               s["lr_device"] for s in stats)


@pytest.mark.gpu
def test_gpu_postfilter_stream(gpu_device):
    frames, stats = _decode("gpu")
    want = _record()["postfilter_384x192.ivf"]["frames"]
    assert [f.md5() for f in frames] == want
    assert all(s["recon_path"] == "device" and s["lr_device"]
               for s in stats)
