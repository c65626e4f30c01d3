"""Container demux: IVF and Annex-B (length-delimited) byte sources.

IVF: 32-byte file header + 12-byte per-frame headers (de-facto format).
Annex B [SPEC Annex B]: leb128 temporal_unit_size > frame_unit_size >
obu_length framing, OBUs usually carried with obu_has_size_field == 0.
The decoder core consumes low-overhead temporal units (OBUs with size
fields), so Annex-B OBUs are re-wrapped: the has_size bit is set in the
header and a leb128 payload size inserted.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple


def leb128_read(buf: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    for i in range(8):
        if pos >= len(buf):
            raise ValueError("truncated stream: leb128 past end of buffer")
        b = buf[pos]
        v |= (b & 0x7F) << (7 * i)
        pos += 1
        if not (b & 0x80):
            break
    return v, pos


def leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_ivf(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield (pts, temporal_unit) from an IVF file."""
    with open(path, "rb") as f:
        head = f.read(32)
        if head[:4] != b"DKIF":
            raise ValueError("not an IVF file")
        while True:
            fh = f.read(12)
            if len(fh) < 12:
                return
            size, pts = struct.unpack("<IQ", fh)
            data = f.read(size)
            if len(data) < size:
                return
            yield pts, data


def _rewrap_obu(obu: bytes) -> bytes:
    """OBU (no size field) -> OBU with size field set."""
    if not obu:
        return obu
    b0 = obu[0]
    ext = (b0 >> 2) & 1
    hlen = 1 + ext
    if (b0 >> 1) & 1:  # already has a size field
        return obu
    payload = obu[hlen:]
    return bytes([b0 | 0x02]) + obu[1:hlen] + leb128(len(payload)) + payload


def _strip_obu_size(obu_stream: bytes) -> List[bytes]:
    """Split a low-overhead OBU stream into sizeless OBUs (for writing
    Annex-B)."""
    out = []
    pos = 0
    n = len(obu_stream)
    while pos < n:
        b0 = obu_stream[pos]
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        hdr_end = pos + 1 + ext
        if has_size:
            size, p2 = leb128_read(obu_stream, hdr_end)
            body = obu_stream[p2: p2 + size]
            out.append(bytes([b0 & ~0x02]) + obu_stream[pos + 1: hdr_end]
                       + body)
            pos = p2 + size
        else:
            out.append(obu_stream[pos:])
            pos = n
    return out


def read_annexb(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield (index, temporal_unit-as-low-overhead-OBUs) from an
    Annex-B file [SPEC Annex B].  Raises ValueError on truncated
    framing (fault-tolerance tier: file-level demux fails as cleanly
    as TU-level decode)."""
    data = open(path, "rb").read()
    pos = 0
    idx = 0
    while pos < len(data):
        tu_size, pos = leb128_read(data, pos)
        tu_end = pos + tu_size
        if tu_end > len(data):
            raise ValueError("truncated stream: temporal unit framing")
        out = bytearray()
        while pos < tu_end:
            fu_size, pos = leb128_read(data, pos)
            fu_end = pos + fu_size
            if fu_end > tu_end:
                raise ValueError("truncated stream: frame unit framing")
            while pos < fu_end:
                obu_len, pos = leb128_read(data, pos)
                if pos + obu_len > fu_end:
                    raise ValueError("truncated stream: OBU framing")
                out += _rewrap_obu(data[pos: pos + obu_len])
                pos += obu_len
            pos = fu_end
        pos = tu_end
        yield idx, bytes(out)
        idx += 1


def write_annexb(path: str, tus: List[bytes]) -> None:
    """Write temporal units (low-overhead OBU streams) as Annex B.
    Each TU becomes one frame unit holding its sizeless OBUs."""
    with open(path, "wb") as f:
        for tu in tus:
            obus = [bytes(o) for o in _strip_obu_size(tu)
                    if (o[0] >> 3) & 0xF != 2]  # drop temporal delimiters
            fu = b"".join(leb128(len(o)) + o for o in obus)
            fu_block = leb128(len(fu)) + fu
            f.write(leb128(len(fu_block)) + fu_block)


def _walks_as_obu_stream(data: bytes) -> bool:
    """True if `data` parses as a chain of size-bearing low-overhead
    OBUs covering the buffer exactly (the probe for raw OBU files)."""
    pos, n = 0, len(data)
    seen = 0
    while pos < n:
        b0 = data[pos]
        if b0 >> 7:          # forbidden bit
            return False
        typ = (b0 >> 3) & 0xF
        if typ == 0 or (9 <= typ <= 14):   # reserved types
            return False
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        if not has_size:     # raw streams carry size fields
            return False
        try:
            size, body = leb128_read(data, pos + 1 + ext)
        except ValueError:
            return False
        if body + size > n:
            return False
        pos = body + size
        seen += 1
    return seen > 0


def detect_format(path: str) -> str:
    """'ivf' | 'annexb' | 'obu' (raw low-overhead stream).

    A small leading leb128 in an Annex-B file can also parse as an OBU
    header byte, so the OBU probe verifies the whole buffer chains as
    size-bearing OBUs to EOF before classifying as 'obu'."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"DKIF":
        return "ivf"
    if data and (data[0] >> 7) == 0 and ((data[0] >> 3) & 0xF) in (1, 2) \
            and _walks_as_obu_stream(data):
        return "obu"
    return "annexb"


def read_temporal_units(path: str) -> Iterator[Tuple[int, bytes]]:
    """Demux any supported container into temporal units."""
    fmt = detect_format(path)
    if fmt == "ivf":
        yield from read_ivf(path)
    elif fmt == "annexb":
        yield from read_annexb(path)
    else:
        yield 0, open(path, "rb").read()


def index_keyframes(path: str) -> List[int]:
    """Stream indexer [SURVEY §2.4 GOP sharding]: temporal-unit indices
    that start a new keyframe-delimited GOP.

    Peeks each TU's first frame-header OBU: a shown KEY frame starts
    with show_existing_frame=0, frame_type=KEY (bits 0,00) in the
    uncompressed header [SPEC §5.9.2].  (Streams with
    reduced_still_picture_header are all-keyframe by construction.)
    """
    idx = []
    for i, (_, tu) in enumerate(read_temporal_units(path)):
        pos = 0
        is_key = False
        while pos < len(tu):
            b0 = tu[pos]
            typ = (b0 >> 3) & 0xF
            ext = (b0 >> 2) & 1
            has_size = (b0 >> 1) & 1
            hdr_end = pos + 1 + ext
            if has_size:
                size, body = leb128_read(tu, hdr_end)
            else:
                size, body = len(tu) - hdr_end, hdr_end
            # FRAME_HEADER (3) / FRAME (6) only — a repeated SEQUENCE
            # HEADER (1) would false-positive as a key frame.  Require
            # the show_frame bit too: a forward keyframe (KEY with
            # show_frame=0) is re-shown later via show_existing_frame
            # and is NOT a safe split point.
            if typ in (3, 6) and size > 0 and body < len(tu):
                first = tu[body]
                show_existing = first >> 7
                frame_type = (first >> 5) & 3
                show_frame = (first >> 4) & 1
                is_key = (show_existing == 0 and frame_type == 0 and
                          show_frame == 1)
                break
            pos = body + size
        if is_key or i == 0:
            idx.append(i)
    return idx


def _decode_gop(args):
    path, start, end, cfg_kw = args
    # fault-injection hook for the elastic-recovery test: a WORKER
    # process assigned this GOP dies hard (os._exit) exactly once
    import multiprocessing as _mp
    import os as _os
    kill = _os.environ.get("AV1DEC_TEST_KILL_GOP")
    if kill is not None and int(kill) == start and \
            _mp.current_process().name != "MainProcess":
        marker = f"/tmp/av1dec_killed_gop_{start}_{_os.getppid()}"
        if not _os.path.exists(marker):
            open(marker, "w").close()
            _os._exit(1)
    from av1dec_tpu.api import Decoder
    from av1dec_tpu.config import DecoderConfig
    dec = Decoder(DecoderConfig(**cfg_kw))
    out = []
    for i, (_, tu) in enumerate(read_temporal_units(path)):
        if i < start:
            continue
        if i >= end:
            break
        for fr in dec.decode(tu):
            out.append((fr.planes, fr.bit_depth, fr.subsampling,
                        fr.order_hint, fr.frame_type))
    dec.close()
    return out


def _run_jobs_elastic(jobs, workers, max_attempts=3):
    """Run GOP jobs across worker processes with elastic recovery
    [SURVEY §5.3]: GOPs are independent, so a dead worker's GOPs are
    simply reassigned — to a fresh pool, and as a last resort decoded
    inline.  Returns chunks in job order."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from concurrent.futures.process import BrokenProcessPool

    results = {}
    remaining = list(enumerate(jobs))
    ctx = mp.get_context("spawn")  # fork unsafe once JAX threads exist
    for _ in range(max_attempts):
        if not remaining:
            break
        try:
            with ProcessPoolExecutor(
                    max_workers=min(workers, len(remaining)),
                    mp_context=ctx) as ex:
                futs = {ex.submit(_decode_gop, j): i
                        for i, j in remaining}
                for fut, i in futs.items():
                    try:
                        results[i] = fut.result()
                    except (BrokenProcessPool, Exception):  # noqa: B014
                        pass  # worker died: GOP stays in `remaining`
        except BrokenProcessPool:
            pass
        remaining = [(i, j) for i, j in remaining if i not in results]
    for i, j in remaining:  # last resort: decode in-process
        results[i] = _decode_gop(j)
    return [results[i] for i in range(len(jobs))]


def decode_gops_parallel(path: str, workers: int = 2, config=None):
    """GOP-parallel decode: keyframe-delimited GOPs are fully
    independent [SPEC §7.20 KEY refresh], so they decode concurrently
    in worker processes [SURVEY §2.4 "GOP/keyframe sharding"].

    Workers decode on the host path, or on JAX's CPU backend with
    platform="cpu".  An accelerator platform with workers > 1 is
    refused before any worker starts: every JAX process that opens a
    card reserves most of its memory, so a second worker process on the
    same card fails.

    Returns frames in stream order (list of OutputFrame).
    """
    from av1dec_tpu.api import OutputFrame

    if (workers > 1 and config is not None and
            config.platform not in (None, "off", "cpu") and
            not config.use_spec_kernels):
        raise ValueError(
            f"GOP workers decode on the host path; platform="
            f"{config.platform!r} with {workers} worker processes would "
            f"open the device in each of them.  Use one process "
            f"(workers <= 1) for device decode.")
    keys = index_keyframes(path)
    n_tus = sum(1 for _ in read_temporal_units(path))
    bounds = keys + [n_tus]
    cfg_kw = {"use_spec_kernels": True}
    max_frames = 0
    if config is not None:
        import dataclasses
        cfg_kw = dataclasses.asdict(config)
        # max_frames is a whole-stream limit: applying it per GOP
        # worker would diverge from serial decode_file semantics, so
        # strip it here and apply once at the merge below
        max_frames = cfg_kw.pop("max_frames", 0) or 0
        # workers run the host path: in auto mode each worker process
        # would otherwise open the accelerator
        if cfg_kw.get("platform") is None:
            cfg_kw["platform"] = "off"
    jobs = [(path, bounds[i], bounds[i + 1], cfg_kw)
            for i in range(len(bounds) - 1)]
    if workers <= 1 or len(jobs) <= 1:
        chunks = [_decode_gop(j) for j in jobs]
    else:
        chunks = _run_jobs_elastic(jobs, workers)
    out = []
    for chunk in chunks:
        for planes, bd, ss, oh, ft in chunk:
            out.append(OutputFrame(planes=planes, bit_depth=bd,
                                   subsampling=ss, order_hint=oh,
                                   frame_type=ft))
    if max_frames:
        out = out[:max_frames]
    return out
