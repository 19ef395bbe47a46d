"""Single-device-program fused sensorfusion stage.

The separate-stage fused demo moves data across the host/device boundary
~6 times per displayed frame across five stage threads (heatmap batch
upload + power download, tracker upload + detection download, composite
upload + composite download).  This stage folds the whole per-batch
display cycle into ONE jitted program with ONE packed uint8 upload and ONE
packed uint8 download per K-frame batch:

    mic frames ─┐                                 ┌─> composites (u8)
    camera u8  ─┼─ packed u8 ──> [ steered power  ├─> detections
    track boxes┘    (1 H2D)       + YOLO detect   ├─> gating meta
                                  + composite ]   ┘   (1 packed D2H)

* steered power: the production backend policy
  (``pipeline._power_program_parts`` — same path as the full-rate
  imaging stage, so the display cannot drift from production).
* detection: ``YoloDetector._forward_batch`` (preprocess resize ON
  DEVICE, backbone + decode + vmapped NMS), one launch for the batch.
* composite: :class:`~..fusion.composite.DeviceCompositor` semantics
  (log-norm, jet LUT, resizes, power box, EMA, decider gating/blends).

Host keeps only O(tracks) work per frame: SORT/hysteresis stepping on
the downloaded detection table, and the decider's ``focus_beam``
steering callback.  Track boxes drawn into the composite are ONE BATCH
STALE (the tracker consumes batch *i*'s detections while batch *i+1*
composites) — same magnitude as the reference's multi-process queue
latency (``main.pyx:669-736``).

Display pairing keeps the reference's latest-frame semantics
(``get_data``, ``api.c:830-859``): each displayed camera frame pairs
with one mic frame from the newest contiguous ring batch; the full-rate
every-frame imaging contract lives in ``BatchedHeatmapProducer``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..fusion.composite import DeviceCompositor, _axis_tables
from ..fusion.decider import SensorFusionDecider
from ..ops import beamform
from ..utils.metrics import PipelineMetrics
from .pipeline import (
    AudioLeg,
    Stage,
    _pad_full,
    _power_program_parts,
    _rect_conf,
)


def _bitcast_to_f32(x_u8: jax.Array, shape) -> jax.Array:
    """uint8 bytes (little-endian, the numpy ``.view`` layout) -> f32."""
    return jax.lax.bitcast_convert_type(
        x_u8.reshape(shape + (4,)), jnp.float32)


def _bitcast_to_u8(x: jax.Array) -> jax.Array:
    """f32/i32 -> flat uint8 bytes (little-endian)."""
    return jax.lax.bitcast_convert_type(x, jnp.uint8).reshape(-1)


# BT.601 STUDIO-range pair used for the yuv420 display transport —
# cv2's own I420 convention, probed empirically (impulse responses:
# Y = 16 + 0.257R + 0.504G + 0.098B; U/V offset 128 with 0.439 swing;
# chroma from the TOP-LEFT pixel of each 2x2, not the average).  The
# device forward matches cv2.COLOR_BGR2YUV_I420 so the host can invert
# with ONE cv2.cvtColor per frame (C/SIMD, far cheaper than the numpy
# float inverse).  Roundtrip error is chroma
# subsampling + uint8 rounding only — the same loss class as the 4:2:0
# mp4 every demo recording already goes through.
def _bgr_to_i420(comps: jax.Array) -> jax.Array:
    """(K, H, W, 3) BGR u8 -> (K, H*W + 2*(H//2)*(W//2)) u8 planes in
    cv2's I420 byte order (Y plane, packed U quarter-plane, packed V)."""
    f = comps.astype(jnp.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + (25.064 * b + 129.057 * g + 65.738 * r) / 256.0
    bs, gs, rs = b[:, ::2, ::2], g[:, ::2, ::2], r[:, ::2, ::2]
    u = 128.0 + (112.439 * bs - 74.494 * gs - 37.945 * rs) / 256.0
    v = 128.0 + (-18.285 * bs - 94.154 * gs + 112.439 * rs) / 256.0

    def q(c):
        return jnp.clip(jnp.round(c), 0, 255).astype(jnp.uint8)

    K = comps.shape[0]
    return jnp.concatenate(
        [q(y).reshape(K, -1), q(u).reshape(K, -1), q(v).reshape(K, -1)],
        axis=1)


def _host_bgr_to_i420(frames: np.ndarray) -> np.ndarray:
    """(K, H, W, 3) BGR u8 -> (K, H*3//2, W) u8 I420 on HOST (camera
    upload leg): one cv2.cvtColor per frame, numpy fallback."""
    K, h, w, _ = frames.shape
    try:
        import cv2
        return np.stack([
            cv2.cvtColor(frames[i], cv2.COLOR_BGR2YUV_I420)
            for i in range(K)])
    except ImportError:                            # pragma: no cover
        f = frames.astype(np.float32)
        b, g, r = f[..., 0], f[..., 1], f[..., 2]
        y = 16.0 + (25.064 * b + 129.057 * g + 65.738 * r) / 256.0
        bs, gs, rs = b[:, ::2, ::2], g[:, ::2, ::2], r[:, ::2, ::2]
        u = 128.0 + (112.439 * bs - 74.494 * gs - 37.945 * rs) / 256.0
        v = 128.0 + (-18.285 * bs - 94.154 * gs + 112.439 * rs) / 256.0

        def q(c):
            return np.clip(np.round(c), 0, 255).astype(np.uint8)

        return np.concatenate(
            [q(y).reshape(K, -1), q(u).reshape(K, -1),
             q(v).reshape(K, -1)], axis=1).reshape(K, h * 3 // 2, w)


def _dev_i420_to_bgr(planes: jax.Array, h: int, w: int) -> jax.Array:
    """(K, H*3//2, W) u8 I420 -> (K, H, W, 3) BGR f32 on DEVICE (the
    studio-range inverse of cv2's forward; nearest chroma upsample)."""
    K = planes.shape[0]
    flat = planes.reshape(K, -1)
    n = h * w
    m = (h // 2) * (w // 2)
    y = flat[:, :n].reshape(K, h, w).astype(jnp.float32)
    u = flat[:, n:n + m].reshape(K, h // 2, w // 2).astype(jnp.float32)
    v = flat[:, n + m:].reshape(K, h // 2, w // 2).astype(jnp.float32)
    u = jnp.repeat(jnp.repeat(u, 2, axis=1), 2, axis=2) - 128.0
    v = jnp.repeat(jnp.repeat(v, 2, axis=1), 2, axis=2) - 128.0
    yl = 1.164 * (y - 16.0)
    b = yl + 2.017 * u
    g = yl - 0.392 * u - 0.813 * v
    r = yl + 1.596 * v
    return jnp.clip(jnp.round(jnp.stack([b, g, r], axis=-1)), 0, 255)


def _i420_to_bgr(planes: np.ndarray, h: int, w: int) -> np.ndarray:
    """(K, H*W + 2*(H//2)*(W//2)) u8 -> (K, H, W, 3) BGR u8 (host).

    The plane byte order IS cv2's I420 layout, so each frame converts
    with one ``cv2.cvtColor`` (nearest-chroma upsample); the numpy
    fallback applies the exact float inverse (bilinear-free repeat)."""
    K = planes.shape[0]
    try:
        import cv2
        return np.stack([
            cv2.cvtColor(planes[i].reshape(h * 3 // 2, w),
                         cv2.COLOR_YUV2BGR_I420) for i in range(K)])
    except ImportError:                            # pragma: no cover
        n = h * w
        m = (h // 2) * (w // 2)
        y = planes[:, :n].reshape(K, h, w).astype(np.float32)
        u = planes[:, n:n + m].reshape(K, h // 2, w // 2) \
            .astype(np.float32)
        v = planes[:, n + m:].reshape(K, h // 2, w // 2) \
            .astype(np.float32)
        u = np.repeat(np.repeat(u, 2, axis=1), 2, axis=2) - 128.0
        v = np.repeat(np.repeat(v, 2, axis=1), 2, axis=2) - 128.0
        yl = 1.164 * (y - 16.0)                    # studio-range inverse
        b = yl + 2.017 * u
        g = yl - 0.392 * u - 0.813 * v
        r = yl + 1.596 * v
        out = np.stack([b, g, r], axis=-1)
        return np.clip(np.round(out), 0, 255).astype(np.uint8)


class FusedSensorStage(Stage):
    """The fused demo as ONE device program per K-frame batch.

    ``consume`` work per batch (host): unpack, SORT/hysteresis step per
    frame, display composites, update the track boxes for the next
    batch, ``focus_beam`` steering.  Double-buffered: batch *i+1* is
    collected/uploaded/dispatched while batch *i* downloads.

    Accounting: ``processed`` displayed frames, ``skipped`` ring frames
    the display pass skipped (NOT an imaging drop — latest-frame display
    semantics), ``latency_ms`` camera-capture -> display per frame,
    ``light``/``conf`` the decider gating scalars of the newest frame.
    """

    def __init__(self, receiver, tables, compositor: DeviceCompositor,
                 detector, q_cam: queue.Queue, display,
                 metrics: PipelineMetrics, batch: int = 16,
                 channels: int = 0, steer_cb=None,
                 transfer: str = "f32", display_transport: str = "rgb",
                 tracker_kwargs: Optional[dict] = None,
                 listen: Optional[str] = None, audio_sink=None,
                 mic_batch: int = 0, alpha: float = 0.9):
        super().__init__("fused", metrics)
        if not compositor.max_tracks:
            raise ValueError("FusedSensorStage needs a boxes-mode "
                             "compositor (max_tracks > 0)")
        if transfer not in ("f32", "f16"):
            raise ValueError(f"unknown transfer {transfer!r}")
        # "f16" halves the mic upload (~1e-3 relative error on the
        # 24-bit-normalized samples — display-grade, same opt-in
        # contract as BatchedStage(transfer=))
        self.transfer = transfer
        self._mic_bytes = 2 if transfer == "f16" else 4
        if display_transport not in ("rgb", "yuv420"):
            raise ValueError(f"unknown display_transport "
                             f"{display_transport!r}")
        # "yuv420" moves BOTH video legs (camera upload, composite
        # download) as I420 planes (1.5 B/px vs 3): chroma is
        # 2x2-subsampled exactly like the 4:2:0 mp4 the demo writes
        # (every consumer-video codec is 4:2:0), so the RECORDED output
        # loses nothing; live display is video-grade.  "rgb" keeps the
        # byte-exact pixels (the parity-test contract).
        self.display_transport = display_transport
        if display_transport == "yuv420":
            Wd, Hd = compositor.window
            Hc_, Wc_ = compositor.cam_shape
            if Wd % 2 or Hd % 2 or Hc_ % 2 or Wc_ % 2:
                raise ValueError("yuv420 transport needs even "
                                 "window/camera dimensions")
        self.receiver = receiver
        self.comp = compositor
        self.detector = detector
        self.q_cam = q_cam
        self.display = display
        self.batch = int(batch)
        self.channels = int(channels)
        self.steer_cb = steer_cb
        self.processed = 0
        self.skipped = 0
        self.frames = 0
        self.latency_ms: list = []
        self.light: Optional[float] = None
        self.conf: Optional[float] = None
        # per-phase wall costs (seconds per batch) — report() summarizes
        # p50s so a slow run says WHICH leg is the bottleneck
        self.phase_s: dict = {k: [] for k in
                              ("collect", "pack", "put", "dispatch",
                               "fetch", "unpack", "track")}

        from ..models.tracking import SmoothedTracker
        self.tracker = SmoothedTracker(detector, **(tracker_kwargs or {}))
        Hc, Wc = compositor.cam_shape
        self.decider = SensorFusionDecider(display_size=(Wc, Hc))
        self._rect_conf = [[0, 0], [0, 0], 0.0]

        # -- embedded listening: the whole product in the same packed
        # upload and download.  The mic batch is already uploaded for the display
        # powers; `listen` additionally emits the steered listening beam
        # in the packed download (K·N floats — noise next to the
        # composites).  The loop driver flips from camera-paced
        # latest-batch display reads to COUNTER-CONTIGUOUS mic batches of
        # ``mic_batch`` (display still pairs cameras with the newest K
        # frames), so the audio stream is gapless at line rate exactly
        # like BatchedMisoProducer (ring overwrites zero-filled + counted
        # as underruns).  "time" = delay-and-sum through this stage's
        # tables + the reference gain chain (api.c:517-522); "mvdr" = the
        # adaptive distortionless beam, state/refresh cadence SHARED with
        # every other MVDR site via make_mvdr_stream's state machine.
        # Ref: main.pyx:279-380 (the combined mimo+miso loops).
        if listen not in (None, "time", "mvdr"):
            raise ValueError(f"unknown listen backend {listen!r}")
        self.listen = listen
        self.alpha = alpha

        # geometry (all static)
        self.n_full = receiver.cfg.n_microphones
        self.n_samples = receiver.cfg.n_samples
        self.mc = self.channels or self.n_full
        # mic frames per cycle: with listening the cycle must drain the
        # ring at line rate (~190.7/s) while display cycles run at
        # camera pace — default 4x the display batch
        self.Km = int(mic_batch) or (4 * self.batch if listen
                                     else self.batch)
        if not listen:
            self.Km = self.batch        # display-only: one frame per cam
        K, Mc, N = self.batch, self.mc, self.n_samples
        Km = self.Km
        T = compositor.max_tracks
        cam_bytes = (K * Hc * Wc * 3 if display_transport == "rgb"
                     else K * (Hc * 3 // 2) * Wc)
        self._sizes = dict(
            mic=Km * Mc * N * self._mic_bytes, cams=cam_bytes,
            boxes=T * 5 * 4)

        self.audio = None
        self._mvdr = None
        self._miso_tables = None
        if listen:
            from ..utils import audio as audio_mod
            cfg = receiver.cfg
            if audio_sink is None:
                audio_sink = audio_mod.NullSink()
            if listen == "time":
                self._miso_tables = tables
                n_mics = tables.n_mics
                post_fn = lambda b: audio_mod.miso_gain(   # noqa: E731
                    b, n_mics, cfg.mic_gain, cfg.norm_factor_sound)
            else:
                from .pipeline import make_mvdr_stream
                # the shared MVDR state machine: we run the device step
                # inside our packed program but the state dict, refresh
                # cadence and reset/precompile are make_mvdr_stream's
                self._mvdr = make_mvdr_stream(cfg, "beams", alpha=alpha)
                post_fn = lambda b: b                      # noqa: E731
            self.audio = AudioLeg(audio_sink, post_fn, self.n_samples)
        S = detector.cfg.input_size
        # detector preprocess resize moved ON DEVICE (the host path
        # resizes with cv2 INTER_LINEAR / the align-corners fallback —
        # same convention switch as the compositor tables)
        from ..utils import imaging
        dy0, dy1, dfy = _axis_tables(Hc, S, imaging._HAS_CV2)
        dx0, dx1, dfx = _axis_tables(Wc, S, imaging._HAS_CV2)
        self._det_tables = tuple(jnp.asarray(a) for a in
                                 (dy0, dy1, dfy, dx0, dx1, dfx))
        self._det_scale = (Wc / S, Hc / S)

        self._tr, self._power_extra = _power_program_parts(tables)
        # the display EMA state (and the carried MVDR precision state)
        # are updated in place; the packed input has no same-shape output
        donate: tuple = (1,) if jax.default_backend() != "cpu" else ()
        if donate and self._mvdr is not None:
            donate = (1, 2)
        self._jit = jax.jit(self._run, donate_argnums=donate)
        self._prev = None
        self._boxes = np.full((T, 5), -100.0, np.float32)
        self._direction = 0
        self._dir_lock = threading.Lock()
        self._last_cams = np.zeros((K, Hc, Wc, 3), np.uint8)
        # output layout
        Ww, Hw = compositor.window
        md = detector.max_det
        comp_bytes = (K * Hw * Ww * 3 if display_transport == "rgb"
                      else K * (Hw * Ww + 2 * (Hw // 2) * (Ww // 2)))
        self._out_sizes = dict(
            comps=comp_bytes, dets=K * md * 5 * 4, mask=K * md,
            cls=K * md * 4, meta=K * len(DeviceCompositor.META_FIELDS) * 4)
        if listen:
            self._out_sizes["beams"] = Km * N * 4

    # -- device program -------------------------------------------------------

    def _run(self, packed, prev, lst, mt, d, count, ct, det_t, variables,
             *extra):
        K, Mc, N = self.batch, self.mc, self.n_samples
        Km = self.Km
        Hc, Wc = self.comp.cam_shape
        T = self.comp.max_tracks
        sz = self._sizes
        o = 0
        if self._mic_bytes == 2:
            mic = jax.lax.bitcast_convert_type(
                packed[o:o + sz["mic"]].reshape(Km, Mc, N, 2),
                jnp.float16).astype(jnp.float32)
        else:
            mic = _bitcast_to_f32(packed[o:o + sz["mic"]], (Km, Mc, N))
        o += sz["mic"]
        if self.display_transport == "yuv420":
            cams = _dev_i420_to_bgr(
                packed[o:o + sz["cams"]].reshape(K, Hc * 3 // 2, Wc),
                Hc, Wc)
        else:
            cams = packed[o:o + sz["cams"]].reshape(K, Hc, Wc, 3)
        o += sz["cams"]
        boxes = _bitcast_to_f32(packed[o:o + sz["boxes"]], (T, 5))

        mic_p = _pad_full(mic, self.n_full)
        # display pairs camera frames with the NEWEST K mic frames of the
        # (possibly larger, counter-contiguous) listening batch
        powers = self._tr(mic_p[-K:] if Km != K else mic_p, *extra)
        beams, lst2 = None, lst
        if self.listen == "time":
            beams = beamform.miso_beam(mic_p, mt, d)
        elif self.listen == "mvdr":
            from ..ops import freq
            beams, lst2 = freq.mvdr_listen_step(lst, mic_p, mt, d,
                                                alpha=self.alpha)

        # detector: device resize (bilinear, host-convention tables) then
        # the batched forward — detections come back in SxS input pixels
        dy0, dy1, dfy, dx0, dx1, dfx = det_t
        f = cams.astype(jnp.float32)
        fy = dfy[None, :, None, None]
        fx = dfx[None, None, :, None]
        rows = f[:, dy0] * (1.0 - fy) + f[:, dy1] * fy
        imgs = rows[:, :, dx0] * (1.0 - fx) + rows[:, :, dx1] * fx
        imgs_u8 = jnp.clip(jnp.round(imgs), 0, 255).astype(jnp.uint8)
        dets, mask, cls_ids = self.detector._forward_batch(
            variables, imgs_u8)

        # composite: identical tracks overlay for every frame of the
        # batch (one-batch-stale boxes change slower than the batch)
        yolos = jnp.broadcast_to(boxes, (K, T, 5))
        comps, prev2, metas = self.comp._run(powers, cams, yolos, prev,
                                             count, ct)
        if self.display_transport == "yuv420":
            comps = _bgr_to_i420(comps)
        parts = [
            comps.reshape(-1),
            _bitcast_to_u8(dets.astype(jnp.float32)),
            mask.astype(jnp.uint8).reshape(-1),
            _bitcast_to_u8(cls_ids.astype(jnp.int32)),
            _bitcast_to_u8(metas.astype(jnp.float32)),
        ]
        if beams is not None:
            parts.append(_bitcast_to_u8(beams.astype(jnp.float32)))
        return jnp.concatenate(parts), prev2, lst2

    def steer(self, direction: int):
        """Steer the embedded listening beam (``api.c:576-581``): a
        traced argument of the next packed launch — live, no recompile."""
        with self._dir_lock:
            self._direction = int(direction)

    def _launch(self, mic, cams, n):
        t0 = time.perf_counter()
        if self._mic_bytes == 2:
            mic = mic.astype(np.float16)
        if self.display_transport == "yuv420":
            cams = _host_bgr_to_i420(cams)
        packed = np.concatenate([
            np.ascontiguousarray(mic).view(np.uint8).reshape(-1),
            np.ascontiguousarray(cams).view(np.uint8).reshape(-1),
            np.ascontiguousarray(self._boxes).view(np.uint8).reshape(-1)])
        if self._prev is None:
            self._prev = self.comp.init_prev()
        with self._dir_lock:
            d = self._direction
        if self._mvdr is not None:
            lst, mt = self._mvdr.state["p"], self._mvdr.tables
        else:
            lst, mt = None, self._miso_tables
        t1 = time.perf_counter()
        packed_dev = jax.device_put(packed)
        t2 = time.perf_counter()
        out, self._prev, lst2 = self._jit(
            packed_dev, self._prev, lst, mt, jnp.int32(d), jnp.int32(n),
            self.comp.tables, self._det_tables, self.detector.variables,
            *self._power_extra)
        if self._mvdr is not None:
            # the shared MVDR state machine: commit the post-batch state,
            # then advance its alpha-aware exact-refresh cadence
            self._mvdr.state["p"] = lst2
            self._mvdr.tick(self.Km)
        t3 = time.perf_counter()
        self.phase_s["pack"].append(t1 - t0)
        self.phase_s["put"].append(t2 - t1)
        self.phase_s["dispatch"].append(t3 - t2)
        return out

    def warmup(self):
        K, Mc, N = self.batch, self.mc, self.n_samples
        Hc, Wc = self.comp.cam_shape
        mic = np.zeros((self.Km, Mc, N), np.float32)
        cams = np.zeros((K, Hc, Wc, 3), np.uint8)
        np.asarray(self._launch(mic, cams, 1))
        if self._mvdr is not None:
            self._mvdr.reset()     # drop warmup pollution + precompile

    # -- host side ------------------------------------------------------------

    def _unpack(self, host_u8):
        K = self.batch
        md = self.detector.max_det
        Ww, Hw = self.comp.window
        sz = self._out_sizes
        o = 0
        if self.display_transport == "yuv420":
            planes = host_u8[o:o + sz["comps"]].reshape(K, -1)
            comps = _i420_to_bgr(planes, Hw, Ww)
        else:
            comps = host_u8[o:o + sz["comps"]].reshape(K, Hw, Ww, 3)
        o += sz["comps"]
        dets = host_u8[o:o + sz["dets"]].view(np.float32) \
            .reshape(K, md, 5)
        o += sz["dets"]
        mask = host_u8[o:o + sz["mask"]].reshape(K, md).astype(bool)
        o += sz["mask"]
        cls_ids = host_u8[o:o + sz["cls"]].view(np.int32).reshape(K, md)
        o += sz["cls"]
        metas = host_u8[o:o + sz["meta"]].view(np.float32) \
            .reshape(K, len(DeviceCompositor.META_FIELDS))
        o += sz["meta"]
        beams = None
        if self.listen:
            beams = host_u8[o:o + sz["beams"]].view(np.float32) \
                .reshape(self.Km, self.n_samples)
        return comps, dets, mask, cls_ids, metas, beams

    def _finish(self, pending):
        out_dev, n, cam_frames, t_ready, t0, skipped, stamps = pending
        tf0 = time.perf_counter()
        host = np.asarray(out_dev)          # ONE packed D2H per batch
        tf1 = time.perf_counter()
        self.metric.tick(tf1 - t0)
        comps, dets, mask, cls_ids, metas, beams = self._unpack(host)
        if self.audio is not None:
            # gapless contract first: audio must not wait on display work
            self.audio.write(beams, skipped, stamps)
        self.phase_s["fetch"].append(tf1 - tf0)
        self.phase_s["unpack"].append(time.perf_counter() - tf1)
        if n == 0:                  # listening cycle with no camera frame
            return
        sx, sy = self._det_scale
        now = time.perf_counter()
        tracks = None
        tt0 = time.perf_counter()
        show_batch = getattr(self.display, "show_batch", None)
        if show_batch is not None:
            show_batch(comps[:n])          # one bulk handover, no copies
        for i in range(n):
            rows = []
            for row, ok in zip(dets[i], mask[i]):
                if ok and row[4] >= self.tracker.confl:
                    rows.append([float(row[0] * sx), float(row[1] * sy),
                                 float(row[2] * sx), float(row[3] * sy),
                                 float(row[4])])
            tracks, kept = self.tracker.step_with_detections(
                cam_frames[i], rows)
            self._rect_conf = _rect_conf(tracks, kept, self._rect_conf)
            if show_batch is None:
                self.display.show(comps[i])
            self.latency_ms.append((now - t_ready[i]) * 1e3)
        self.phase_s["track"].append(time.perf_counter() - tt0)
        # boxes for the NEXT batch's composite (one-batch staleness)
        boxes = np.full_like(self._boxes, -100.0)
        if tracks is not None and len(tracks):
            b = np.asarray(tracks, np.float32)[:len(boxes)]
            boxes[:len(b), :b.shape[1]] = b[:, :5]
        self._boxes = boxes
        self.processed += n
        self.frames += n
        self.light = float(metas[n - 1, 0])
        self.conf = float(metas[n - 1, 1])
        if self.steer_cb is not None:
            (p1, p2), c = self._rect_conf[:2], self._rect_conf[2]
            self.decider.focus_beam(
                self.steer_cb, [p1[0], p1[1], p2[0], p2[1], c])

    def _collect(self, timeout: float = 0.5):
        """Up to K queued camera frames (blocks for the first)."""
        items = []
        try:
            items.append(self.q_cam.get(timeout=timeout))
        except queue.Empty:
            return items
        while len(items) < self.batch:
            try:
                items.append(self.q_cam.get_nowait())
            except queue.Empty:
                break
        return items

    def run(self):
        # downloads run on their own thread (in order, bounded queue):
        # the D2H fetch of batch i releases the GIL during the transfer,
        # so it overlaps batch i+1's collect/pack/upload.  Consequence: the track boxes composited
        # into a batch can be up to TWO batches stale (i+1 may upload
        # before i's tracker step lands) — display overlay only.
        import threading
        q_pend: queue.Queue = queue.Queue(maxsize=2)

        def _drain():
            while True:
                pend = q_pend.get()
                if pend is None:
                    return
                try:
                    self._finish(pend)
                except Exception:                # pragma: no cover
                    import logging
                    logging.getLogger(__name__).exception(
                        "fused finisher died")
                    return

        finisher = threading.Thread(target=_drain, daemon=True)
        finisher.start()
        # stream-start anchor: consume everything the ring still holds
        # (the gapless contract loses NOTHING that is still available —
        # the consumer outpaces line rate, so a ring-deep backlog clears
        # in under a second), but frames published between connect() and
        # this loop BEYOND the ring (e.g. during a minutes-long remote
        # compile in warmup) predate the stream and must not be
        # zero-filled in as underruns.
        next_seq = self.receiver.stream_anchor_seq
        try:
            while not self.stop_event.is_set():
                tc0 = time.perf_counter()
                if self.listen:
                    # mic-driven cycle (gapless listening): block for the
                    # next counter-contiguous Km frames, then composite
                    # however many camera frames are queued (0..K)
                    try:
                        res = self.receiver.read_batch(
                            self.Km, next_seq, timeout=0.5,
                            channels=self.channels, with_stamps=True)
                    except TimeoutError:
                        continue
                    mic, first, skipped, stamps = res
                    if mic is None:
                        continue
                    next_seq = first + self.Km
                    items = []
                    while len(items) < self.batch:
                        try:
                            items.append(self.q_cam.get_nowait())
                        except queue.Empty:
                            break
                else:
                    items = self._collect()
                    if not items:
                        continue
                self.phase_s["collect"].append(
                    time.perf_counter() - tc0)
                t_ready = [time.perf_counter()] * len(items)
                cam_frames = []
                for _no, fr in items:
                    if fr.ndim == 2:
                        fr = np.repeat(fr[..., None], 3, -1)
                    cam_frames.append(fr.astype(np.uint8, copy=False))
                n = len(cam_frames)
                if n:
                    cams = np.stack(cam_frames)
                    if n < self.batch:
                        cams = np.concatenate(
                            [cams,
                             np.repeat(cams[-1:], self.batch - n, 0)])
                    self._last_cams = cams
                else:           # listening cycle with no camera frame
                    cams = self._last_cams
                if not self.listen:
                    try:
                        mic, first, skipped = self.receiver.read_batch(
                            self.batch, next_seq, timeout=1.0,
                            channels=self.channels)
                    except TimeoutError:
                        # native backend raises where the python twin
                        # returns None (frame source paused/finished)
                        continue
                    if mic is None:
                        continue
                    next_seq = first + self.batch
                    stamps = None
                if skipped:
                    self.skipped += skipped
                t0 = time.perf_counter()
                out = self._launch(mic, cams, n)
                q_pend.put((out, n, cam_frames, t_ready, t0, skipped,
                            stamps))
        finally:
            q_pend.put(None)
            finisher.join(timeout=30.0)

    def report(self):
        lat = np.asarray(self.latency_ms, np.float64)
        rep = {
            "frames": self.frames,
            "latency_p50_ms": round(float(np.percentile(lat, 50)), 2)
            if lat.size else None,
            "latency_p95_ms": round(float(np.percentile(lat, 95)), 2)
            if lat.size else None,
            "light": self.light, "conf": self.conf,
            # p50 seconds per batch per leg — which leg is the bottleneck
            "phase_p50_ms": {
                k: round(float(np.percentile(v, 50)) * 1e3, 1)
                for k, v in self.phase_s.items() if v},
        }
        if self.audio is not None:
            rep.update(self.audio.latency())
            rep["audio_frames"] = self.audio.samples // self.n_samples
            rep["underrun_frames"] = self.audio.underrun_frames
        return rep
