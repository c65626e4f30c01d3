"""av1dec_tpu — an AV1 decoder with a JAX device pixel pipeline.

A from-scratch reimplementation of the capability surface of oddstone/av1dec
(a C++ AV1 decoder), redesigned for an accelerator behind JAX:

- Host C++ "front half": OBU parsing, header parsing, and the multi-symbol
  adaptive arithmetic (msac) entropy decoder run per-tile on the host,
  emitting dense fixed-shape "plan" tensors (mode info on the 4x4 grid,
  TX-size-bucketed coefficient tensors).  [AV1 spec §5, §8.2, §9]
- Device "back half": prediction, reconstruction and the loop-filter chain
  (deblock -> CDEF -> superres -> Wiener loop restoration) as batched
  integer JAX programs; residuals, self-guided restoration and film grain
  run on the host.  [AV1 spec §7.11-7.18]
- Parallel layer: frame sharding and column-sharded CDEF (with halo
  exchange) over a jax.sharding.Mesh, GOP sharding across hosts.  All
  integer math => bit-exact at any mesh shape.

The AV1 decode process is normative (AV1 Bitstream & Decoding Process
Specification); section numbers cited as [SPEC §x.y] throughout.
"""

__version__ = "0.1.0"

from av1dec_tpu.config import DecoderConfig  # noqa: F401
