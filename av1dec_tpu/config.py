"""Decoder configuration.

One frozen dataclass, passed explicitly (JAX-idiomatic; no global flag
registry).  Mirrors the CLI surface of a standard AV1 decoder
(threads/output/md5) plus the device and mesh controls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    # Host-side entropy decode worker threads (tile-parallel).
    threads: int = 1

    # Column shards over a 1-D ("space",) device mesh for CDEF
    # (parallel/sharded_cdef.py); 0 = single device.  Needs that many
    # devices; a frame whose width isn't shard-aligned runs CDEF on one
    # device (logged).
    space_shards: int = 0

    # Apply film grain synthesis at output [SPEC §7.18.3].  References are
    # always grain-free; this only affects emitted frames.
    apply_grain: bool = True

    # Emit frames that have show_frame == 0 (debugging aid).
    output_invisible: bool = False

    # Operating point selection for scalable streams [SPEC §5.5.3, §6.4.1].
    operating_point: int = 0

    # Limit decode to the first N shown frames (0 = no limit).
    max_frames: int = 0

    # Force the NumPy spec pipeline for pixel work (same as
    # platform="off").
    use_spec_kernels: bool = False

    # Run pixel work on this JAX platform: "gpu" or "cpu" (must exist,
    # else decoding raises), "off" = NumPy spec pipeline, None = auto
    # (device path when JAX's default backend is an accelerator).
    platform: Optional[str] = None

    # In auto device mode, frames smaller than this (luma pixels) stay
    # on the host path, where per-geometry compile and dispatch cost
    # more than the pixel work.  The value was chosen for an earlier
    # accelerator and is not yet tuned on the GPU.  An explicit
    # `platform` bypasses the heuristic.
    min_device_pixels: int = 230_000
