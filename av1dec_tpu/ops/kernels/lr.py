"""Device loop restoration — Wiener filter, whole-frame. [SPEC §7.17.4]

Whole-plane restructuring of ops.spec.lr's per-unit/per-stripe walk:

- the 7-tap separable Wiener filter runs as whole-plane passes with
  PER-PIXEL taps gathered from the per-unit coefficient maps (units
  tile the plane, so two row/col index vectors expand the unit grid);
- LR's stripe-boundary read semantics (each 64-luma-row stripe reads
  at most 2 rows above/below itself, and those rows come from the
  deblocked PRE-CDEF frame) collapse into 7 per-output-row gathers:
  for each vertical tap, the stripe-clamped source row is gathered
  from the right source (indices and inside-stripe masks precomputed
  on host) and filtered horizontally with the OUTPUT pixel's unit
  taps — a source row across a unit-row boundary belongs to another
  unit but is filtered with this one's [SPEC §7.17.4];
- frames whose active units are all Wiener run this pass fused into
  the postfilter chain; frames with any self-guided unit keep the
  host LR tail (pipeline/device_recon.finish_host).

Bit-exact vs the host spec model on the lr/sres_lr battery streams
(tests/test_wavefront.py parity runs the full chain).
"""
import jax.numpy as jnp


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def wiener_plane(cdef_p, pre_p, args, bd):
    """One plane.  args (device arrays, host-built by
    DeviceRecon._lr_wiener_args):
      uy [H], ux [W]      — unit row/col index per pixel (sentinel row/
                            col beyond the crop points at inactive
                            padding entries)
      tv, th [UR, UC, 7]  — per-unit vertical/horizontal taps
      act [UR, UC]        — unit active (Wiener) flags
      vr [7, H]           — stripe-clamped source row per (tap, row)
      inside [7, H]       — True: row from cdef; False: from pre
    """
    uy, ux, tv, th, act, vr, inside = args
    H, W = cdef_p.shape
    r0 = 5 if bd == 12 else 3
    r1 = 9 if bd == 12 else 11
    off0 = 1 << (bd + 6)
    lim = (1 << (bd + 1 + 7 - r0)) - 1

    th_px = th[uy][:, ux]                      # [H, W, 7]
    tv_px = tv[uy][:, ux]

    def hpass(src):
        z = jnp.pad(src.astype(jnp.int32), ((0, 0), (3, 3)),
                    mode="edge")
        acc = jnp.full((H, W), off0, jnp.int32)
        for k in range(7):
            acc = acc + th_px[:, :, k] * z[:, k:k + W]
        return jnp.clip(_round2(acc, r0), 0, lim)

    acc = jnp.full((H, W), -(1 << (bd + r1 - 1)), jnp.int32)
    for k in range(7):
        src = jnp.where(inside[k][:, None], cdef_p[vr[k]], pre_p[vr[k]])
        acc = acc + tv_px[:, :, k] * hpass(src)
    out = jnp.clip(_round2(acc, r1), 0, (1 << bd) - 1)
    act_px = act[uy][:, ux] != 0
    return jnp.where(act_px, out, cdef_p.astype(jnp.int32))


def lr_wiener_planes(planes, pre_planes, lr_args, bd):
    """All planes; lr_args[p] is None for planes without restoration."""
    outs = []
    for p, (plane, pre) in enumerate(zip(planes, pre_planes)):
        a = lr_args[p]
        outs.append(plane if a is None
                    else wiener_plane(plane, pre, a, bd))
    return outs
