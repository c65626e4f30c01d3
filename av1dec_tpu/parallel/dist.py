"""Multi-host distribution layer. [SURVEY §2.5]

The reference is single-process shared-memory; N-host scaling is a new
capability of this build: `jax.distributed` joins the processes of a
set of hosts into one global device namespace, a global Mesh lays
`data` (frames/GOPs) across hosts, and GOP assignment is pure data
parallelism (keyframe-delimited GOPs are
fully independent, container.index_keyframes).

Decode work split across hosts:
  host h decodes GOPs g where g % num_processes == process_id, with
  the in-host device path unchanged; outputs are re-ordered by the
  caller (or streamed to a sink per host).  No pixel data crosses hosts
  for GOP parallelism — only the stream bytes each host reads itself.

Tested by tests/test_distributed.py: two real processes join a
coordinator, build a global CPU mesh, run a cross-process psum, and decode
disjoint GOP shards of one stream whose union is byte-identical to a
serial decode.
"""
from __future__ import annotations

import os


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join this process into a multi-host JAX cluster.

    Pass the three arguments explicitly or via AV1DEC_COORDINATOR /
    AV1DEC_NUM_PROCS / AV1DEC_PROC_ID; JAX cannot detect them on a GPU
    or CPU cluster."""
    import jax
    coordinator = coordinator or os.environ.get("AV1DEC_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("AV1DEC_NUM_PROCS", "0")) or None
    if process_id is None:
        pid = os.environ.get("AV1DEC_PROC_ID")
        process_id = int(pid) if pid is not None else None
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "data"):
    """1-D mesh over ALL devices of the cluster (local + remote)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis,))


def my_gop_shard(path: str):
    """(gop_bounds, mine): keyframe-delimited GOP bounds of `path` and
    the subset owned by this process (round-robin by process index)."""
    import jax

    from av1dec_tpu.container import index_keyframes, read_temporal_units
    keys = index_keyframes(path)
    n_tus = sum(1 for _ in read_temporal_units(path))
    bounds = [(s, e) for s, e in zip(keys, keys[1:] + [n_tus])]
    pid = jax.process_index()
    n = jax.process_count()
    mine = [b for i, b in enumerate(bounds) if i % n == pid]
    return bounds, mine


def decode_my_gops(path: str, config=None):
    """Decode this process's GOP shard; returns a list of
    (gop_index, frames) pairs (frames are OutputFrame-tuples as in
    container._decode_gop)."""
    import dataclasses

    from av1dec_tpu.container import _decode_gop
    bounds, mine = my_gop_shard(path)
    cfg_kw = {"use_spec_kernels": True}
    if config is not None:
        cfg_kw = dataclasses.asdict(config)
        cfg_kw.pop("max_frames", None)
    out = []
    for s, e in mine:
        out.append((bounds.index((s, e)),
                    _decode_gop((path, s, e, cfg_kw))))
    return out
