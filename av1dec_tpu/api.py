"""Public decoder API: create / decode / drain.  [SURVEY §2.3 rows 35-36]

Wraps the native entropy front-half (NativeParser) and the pixel
pipeline (FrameRecon) with the reference-frame pool (DPB, [SPEC §7.20])
so whole streams decode through one object:

    dec = Decoder()
    for _, tu in read_ivf(path):
        for frame in dec.decode(tu):
            frame.planes  # list of np arrays (Y, U, V)
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from av1dec_tpu.bindings import NativeParser
from av1dec_tpu.pipeline.recon import FrameRecon

log = logging.getLogger("av1dec_tpu")


@dataclass
class OutputFrame:
    planes: List[np.ndarray]
    bit_depth: int
    subsampling: tuple
    order_hint: int = 0
    frame_type: int = 0
    temporal_id: int = 0
    spatial_id: int = 0
    metadata: dict = field(default_factory=dict)  # HDR CLL/MDCV etc

    def md5(self) -> str:
        h = hashlib.md5()
        for p in self.planes:
            dt = np.uint16 if self.bit_depth > 8 else np.uint8
            h.update(np.ascontiguousarray(p.astype(dt)).tobytes())
        return h.hexdigest()


@dataclass
class _Slot:
    planes: List[np.ndarray]
    width: int       # luma upscaled width
    height: int      # luma height
    frame_type: int
    grain: dict = field(default_factory=dict)
    bit_depth: int = 8
    subsampling: tuple = (1, 1)
    # device-resident copy of the (grain-free) reference planes, kept
    # when the frame decoded on device with no host filter tail — the
    # device inter path reads refs from here instead of re-uploading
    dev_planes: Optional[list] = None


class Decoder:
    """AV1 decoder: temporal units in, display-order frames out.

    `config`: DecoderConfig (threads, device platform, grain, frame
    limits); None = defaults.  Pixel work runs on the JAX device path
    (wavefront + postfilter) when the frame qualifies and a device
    platform is configured, or in auto mode when JAX's default backend
    is an accelerator; otherwise the NumPy spec pipeline.  A configured
    platform that JAX does not have is an error, not a fallback.
    """

    def __init__(self, config=None) -> None:
        from av1dec_tpu.config import DecoderConfig
        self.config = config or DecoderConfig()
        self._parser = NativeParser(
            threads=self.config.threads,
            operating_point=self.config.operating_point)
        self._dpb: Dict[int, Optional[_Slot]] = {i: None for i in range(8)}
        self._shown = 0
        self._use_device = None  # resolved lazily (may import jax)
        self._device = None      # the configured platform's device
        self.stats: List[dict] = []  # per-frame decode records

    def _device_enabled(self) -> bool:
        if self._use_device is None:
            cfg = self.config
            if cfg.use_spec_kernels or cfg.platform == "off":
                self._use_device = False
            else:
                import jax

                from av1dec_tpu import compile_cache
                if cfg.platform is not None:
                    try:
                        self._device = jax.devices(cfg.platform)[0]
                    except RuntimeError as e:
                        raise RuntimeError(
                            f"DecoderConfig.platform={cfg.platform!r} "
                            f"but JAX has no such device: {e}") from e
                    self._use_device = True
                else:  # auto: device path only on an accelerator
                    backend = jax.default_backend()
                    self._use_device = backend != "cpu"
                    log.info("auto device mode: JAX backend %r, pixel "
                             "path %s", backend,
                             "device" if self._use_device else "host")
                if self._use_device:
                    compile_cache.enable()
        return self._use_device

    def _on_device(self):
        """Default-device scope for the configured platform (auto mode
        keeps JAX's default)."""
        if self._device is None:
            return contextlib.nullcontext()
        import jax
        return jax.default_device(self._device)

    @property
    def seq(self):
        return self._parser.seq

    def decode(self, tu: bytes) -> List[OutputFrame]:
        out: List[OutputFrame] = []
        for hdr, plans in self._parser.parse_tu(tu, with_plans=True):
            seq = self._parser.seq
            if hdr.get("show_existing_frame"):
                slot = self._dpb[hdr["frame_to_show_map_idx"]]
                if slot is None:
                    raise ValueError("show_existing_frame: empty slot")
                out.append(self._emit(slot.planes, slot, hdr))
                if slot.frame_type == 0:  # KEY re-show refreshes all slots
                    for i in range(8):
                        self._dpb[i] = slot
                continue
            refs = None
            if not hdr.get("frame_is_intra", 1):
                refs = {}
                for rf in range(1, 8):
                    idx = hdr["ref_frame_idx"][rf - 1]
                    slot = self._dpb[idx]
                    if slot is not None:
                        refs[rf] = {"planes": slot.planes,
                                    "width": slot.width,
                                    "height": slot.height,
                                    "dev_planes": slot.dev_planes}
            import time as _time
            t0 = _time.monotonic()
            planes = None
            path = "host"
            sr_dev = lr_dev = False
            # auto mode: small frames stay on host — device dispatch
            # (and a possible cold compile) dwarfs their pixel work
            big_enough = (self.config.platform is not None or
                          hdr["frame_width"] * hdr["frame_height"] >=
                          self.config.min_device_pixels)
            dev_keep = None
            if big_enough and self._device_enabled():
                from av1dec_tpu.pipeline.device_recon import DeviceRecon
                dr = DeviceRecon(seq, hdr, plans, config=self.config,
                                 refs=refs)
                if dr.supported():
                    with self._on_device():
                        planes = dr.run()
                    path = "device"
                    sr_dev, lr_dev = dr._sr_on_device, dr._lr_on_device
                    # retain the device planes as a future ref unless a
                    # host tail (SGR restoration, or host-side
                    # superres) changed them post-fetch
                    if (not dr._needs_pre_cdef() or
                            dr._lr_on_device) and \
                            (not hdr.get("use_superres") or
                             dr._sr_on_device):
                        dev_keep = dr._final_dev
            if planes is None:
                planes = FrameRecon(seq, hdr, plans, refs=refs).run()
            self.stats.append({
                "frame_type": hdr["frame_type"],
                "show": int(bool(hdr.get("show_frame"))),
                "qindex": hdr["quant"]["base_q_idx"],
                "width": hdr["frame_width"],
                "height": hdr["frame_height"],
                "intra": int(bool(hdr.get("frame_is_intra", 1))),
                "cdef": int(bool((hdr.get("cdef") or {}).get("bits", 0) or
                                 any((hdr.get("cdef") or {})
                                     .get("y_pri", [0])))),
                "superres": int(bool(hdr.get("use_superres"))),
                "lr": int(any((hdr.get("lr") or {})
                              .get("frame_restoration_type", [0, 0, 0]))),
                "recon_path": path,
                # superres / loop restoration ran inside the device
                # postfilter (not in a host tail)
                "superres_device": int(sr_dev),
                "lr_device": int(lr_dev),
                "ms": round((_time.monotonic() - t0) * 1000, 2),
            })
            slot = _Slot(planes=planes,
                         width=hdr["upscaled_width"],
                         height=hdr["frame_height"],
                         frame_type=hdr["frame_type"],
                         grain=hdr.get("grain") or {},
                         bit_depth=seq["bit_depth"],
                         subsampling=(seq["subsampling_x"],
                                      seq["subsampling_y"]),
                         dev_planes=dev_keep)
            for i in range(8):
                if (hdr["refresh_frame_flags"] >> i) & 1:
                    self._dpb[i] = slot
            if hdr.get("show_frame") or self.config.output_invisible:
                out.append(self._emit(planes, slot, hdr))
        if self.config.max_frames:
            room = self.config.max_frames - self._shown
            out = out[:max(0, room)]
        self._shown += len(out)
        return out

    def _emit(self, planes, slot, hdr) -> OutputFrame:
        grain = slot.grain if hdr.get("show_existing_frame") \
            else (hdr.get("grain") or {})
        out_planes = planes
        if grain.get("apply_grain") and self.config.apply_grain:
            from av1dec_tpu.ops.spec import film_grain
            out_planes = film_grain.apply_grain(
                planes, grain, slot.bit_depth, slot.subsampling[0],
                slot.subsampling[1])
        return OutputFrame(planes=out_planes, bit_depth=slot.bit_depth,
                           subsampling=slot.subsampling,
                           order_hint=hdr.get("order_hint", 0),
                           frame_type=slot.frame_type,
                           temporal_id=hdr.get("temporal_id", 0),
                           spatial_id=hdr.get("spatial_id", 0),
                           metadata=hdr.get("metadata") or {})

    def save_state(self) -> bytes:
        """Mid-GOP checkpoint [SURVEY §5.4]: the FULL decode state at a
        temporal-unit boundary — the native header-level state (seq
        header, per-slot CDF contexts, segment maps, temporal-MVP
        motion fields, order hints) plus the pixel DPB.  Restoring into
        a fresh Decoder resumes decode at the next TU with output
        byte-identical to an uninterrupted decode."""
        import pickle
        dpb = {}
        for i, slot in self._dpb.items():
            if slot is None:
                continue
            dpb[i] = {
                "planes": [np.asarray(p) for p in slot.planes],
                "width": slot.width, "height": slot.height,
                "frame_type": slot.frame_type, "grain": slot.grain,
                "bit_depth": slot.bit_depth,
                "subsampling": slot.subsampling,
            }
        return pickle.dumps({
            "native": self._parser.save_state(),
            "dpb": dpb,
            "shown": self._shown,
        }, protocol=4)

    def load_state(self, blob: bytes) -> None:
        import pickle
        st = pickle.loads(blob)
        self._parser.load_state(st["native"])
        self._dpb = {i: None for i in range(8)}
        # slots sharing one frame must share one _Slot (KEY re-show
        # identity is not observable post-restore; values are)
        for i, ent in st["dpb"].items():
            self._dpb[i] = _Slot(
                planes=ent["planes"], width=ent["width"],
                height=ent["height"], frame_type=ent["frame_type"],
                grain=ent["grain"], bit_depth=ent["bit_depth"],
                subsampling=ent["subsampling"])
        self._shown = st["shown"]

    def close(self) -> None:
        self._parser.close()


def decode_file(path: str, config=None) -> List[OutputFrame]:
    """Decode a whole file (IVF, Annex-B, or raw OBU stream)."""
    from av1dec_tpu.container import read_temporal_units

    frames: List[OutputFrame] = []
    dec = Decoder(config)
    limit = dec.config.max_frames
    for _, tu in read_temporal_units(path):
        frames += dec.decode(tu)
        if limit and len(frames) >= limit:
            break
    dec.close()
    return frames


def decode_ivf(path: str, config=None) -> List[OutputFrame]:
    """Back-compat alias for decode_file."""
    return decode_file(path, config)
