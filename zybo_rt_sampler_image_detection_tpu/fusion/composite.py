"""On-device display compositing — the fused demo's per-frame pixel
chain as ONE batched jitted program.

The display chain — log-norm, jet-LUT colorize (the reference's own hot
loop, reference ``PC/src/visual.py:254-261``), resize-to-window, EMA
smoothing, and the decider's three ``add_weighted`` blends and flips
(reference ``PC/sensorfusion/decider.py:26-51``) — runs per frame on
host NumPy/cv2 in the reference.  Here that chain is one ``lax.scan`` over
a batch of K heatmaps: LUT gathers, bilinear-resize gathers and
elementwise blends, emitting display-ready uint8 composites.  The host
only uploads the tiny power maps plus camera/overlay frames and
downloads finished frames; the modality-gating *decisions* (light
level, entropy confidence) are computed on device and returned as
per-frame scalars for the host decider logic (steering callbacks stay
host-side).

Parity: emulates cv2's exact arithmetic, probed empirically —
half-pixel-center bilinear resize, round-half-to-even saturating
``addWeighted``, thick rectangle outlines rasterized as the L1 ball of
radius ``thickness - 1`` around the perimeter, filled circles as
``d^2 <= r^2``, ``BORDER_REFLECT_101`` Gaussian blur, fixed-point BGR
-> gray rounding — so the device composite matches the host
``Viewer``/``SensorFusionDecider`` chain within uint8 rounding
(``tests/test_composite.py`` gates it).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import imaging
from ..utils.viz import POWER_EXPONENT, jet_lut


class CompositeTables(NamedTuple):
    """Gather/weight tables for the jitted program.  Passed as jit
    ARGUMENTS, never closure constants (CLAUDE.md: constants bloat the
    compile request)."""

    lut: jax.Array       # (256, 3) f32 — reversed jet LUT (visual.py:43-44)
    gauss: jax.Array     # (5,) f32 — cv2.getGaussianKernel(5, 1.0)
    heat_y0: jax.Array   # small (Yg, Xg) -> window rows
    heat_y1: jax.Array
    heat_fy: jax.Array
    heat_x0: jax.Array
    heat_x1: jax.Array
    heat_fx: jax.Array
    cam_y0: jax.Array    # camera (Hc, Wc) -> window
    cam_y1: jax.Array
    cam_fy: jax.Array
    cam_x0: jax.Array
    cam_x1: jax.Array
    cam_fx: jax.Array
    yolo_y0: jax.Array   # tracker overlay (Hy, Wy) -> window
    yolo_y1: jax.Array
    yolo_fy: jax.Array
    yolo_x0: jax.Array
    yolo_x1: jax.Array
    yolo_fx: jax.Array


def _axis_tables(src: int, dst: int, cv2_convention: bool):
    """Bilinear gather indices + fractions for one axis.

    cv2 INTER_LINEAR maps dst pixel i to source coordinate
    ``(i + 0.5) * src/dst - 0.5`` (half-pixel centers, clipped at the
    border); the cv2-less ``imaging.resize`` fallback uses
    align-corners ``linspace``.  The compositor mirrors whichever
    convention the host path is running so parity holds either way."""
    if cv2_convention:
        xs = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
        xs = np.clip(xs, 0.0, src - 1)
    else:
        xs = np.linspace(0.0, src - 1, dst)
    i0 = np.floor(xs).astype(np.int32)
    f = (xs - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, src - 1).astype(np.int32)
    return i0, i1, f


def _gauss_kernel5(sigma: float = 1.0) -> np.ndarray:
    """cv2.getGaussianKernel(5, sigma) (find_power_center's blur,
    visual.py:295-322; same formula as the imaging fallback)."""
    x = np.arange(-2, 3, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _bilinear(img, y0, y1, fy, x0, x1, fx):
    """(H, W, C) f32 -> (h, w, C) f32 via two gather passes."""
    fy = fy[:, None, None]
    fx = fx[None, :, None]
    rows = img[y0] * (1.0 - fy) + img[y1] * fy
    return rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx


def _round_u8(x):
    """cv2 saturate_cast: round half to even, clip to [0, 255]."""
    return jnp.clip(jnp.round(x), 0.0, 255.0)


class DeviceCompositor:
    """Builds and owns the jitted batched compositing program.

    ``__call__(powers (K, Xg, Yg) f32, cams (K, Hc, Wc, 3) u8,
    yolos (K, Hy, Wy, 3) u8, prev (Hw, Ww, 3) u8 device) ->
    (composites (K, Hw, Ww, 3) u8, prev', meta)`` — all device arrays,
    non-blocking (callers double-buffer and ``np.asarray`` at the sync
    point).  ``meta`` carries the per-frame gating scalars: light
    level, entropy confidence ``1/(1+H)``, should_overlay, and the
    power-center pixel (sx, sy).

    Semantics transcribed from the host chain it replaces:
    ``utils.viz.Viewer.loop`` + ``calculate_heatmap_with_detection``
    (``visual.py:227-293,405-484``) and
    ``fusion.decider.SensorFusionDecider.create_image``
    (``decider.py:26-51``).
    """

    META_FIELDS = ("light", "conf", "should", "sx", "sy")

    def __init__(self, grid_shape: Tuple[int, int],
                 cam_shape: Tuple[int, int],
                 window: Tuple[int, int] = (640, 360),
                 yolo_shape: Optional[Tuple[int, int]] = None,
                 threshold: float = 1e-7, amount: float = 0.5,
                 exponent: int = POWER_EXPONENT,
                 box_size_ratio: float = 0.1, light_gate: float = 0.2,
                 heatmap_color: bool = False, ema: float = 0.5,
                 cv2_convention: Optional[bool] = None,
                 max_tracks: int = 0):
        """``max_tracks > 0`` switches the YOLO input from a drawn
        overlay image to per-frame track boxes ``(K, max_tracks, 5)``
        f32 (x1, y1, x2, y2, id in camera-pixel coords, padded with
        -100 rows): the green thickness-2 ID rectangles the host
        tracker draws (``pipeline._draw_tracks``) are rasterized ON
        DEVICE, so the per-frame host->device transfer drops from a
        full canvas (~225 KB) to 20 floats."""
        if cv2_convention is None:
            cv2_convention = imaging._HAS_CV2
        Xg, Yg = grid_shape
        Ww, Hw = window
        Hc, Wc = cam_shape
        Hy, Wy = yolo_shape if yolo_shape is not None else cam_shape
        self.grid_shape = (Xg, Yg)
        self.window = (Ww, Hw)
        self.cam_shape = (Hc, Wc)
        self.yolo_shape = (Hy, Wy)
        self.threshold = float(threshold)
        self.amount = float(amount)
        self.exponent = int(exponent)
        # the power box is a fixed-size rectangle centered on the power
        # center (visual.py:227-293)
        self.bw = int(Ww * box_size_ratio)
        self.bh = int(Hw * box_size_ratio)
        self.light_gate = float(light_gate)
        self.heatmap_color = bool(heatmap_color)
        self.ema = float(ema)
        self.max_tracks = int(max_tracks)

        def ax(src, dst):
            return _axis_tables(src, dst, cv2_convention)

        hy0, hy1, hfy = ax(Yg, Hw)   # colorized small is (Yg, Xg, 3)
        hx0, hx1, hfx = ax(Xg, Ww)
        cy0, cy1, cfy = ax(Hc, Hw)
        cx0, cx1, cfx = ax(Wc, Ww)
        ty0, ty1, tfy = ax(Hy, Hw)
        tx0, tx1, tfx = ax(Wy, Ww)
        self.tables = CompositeTables(
            lut=jnp.asarray(jet_lut(), jnp.float32),
            gauss=jnp.asarray(_gauss_kernel5(), jnp.float32),
            heat_y0=jnp.asarray(hy0), heat_y1=jnp.asarray(hy1),
            heat_fy=jnp.asarray(hfy),
            heat_x0=jnp.asarray(hx0), heat_x1=jnp.asarray(hx1),
            heat_fx=jnp.asarray(hfx),
            cam_y0=jnp.asarray(cy0), cam_y1=jnp.asarray(cy1),
            cam_fy=jnp.asarray(cfy),
            cam_x0=jnp.asarray(cx0), cam_x1=jnp.asarray(cx1),
            cam_fx=jnp.asarray(cfx),
            yolo_y0=jnp.asarray(ty0), yolo_y1=jnp.asarray(ty1),
            yolo_fy=jnp.asarray(tfy),
            yolo_x0=jnp.asarray(tx0), yolo_x1=jnp.asarray(tx1),
            yolo_fx=jnp.asarray(tfx))
        donate = (3,) if jax.default_backend() != "cpu" else ()
        self._jit = jax.jit(self._run, donate_argnums=donate)

    # -- device program -----------------------------------------------------

    def init_prev(self):
        Ww, Hw = self.window
        return jnp.zeros((Hw, Ww, 3), jnp.uint8)

    def __call__(self, powers, cams, yolos, prev, count=None):
        """``count`` (host int) marks how many leading frames are real
        when the batch was padded to a static K (repeats of the last
        triple): outputs past ``count`` are discarded by the caller and
        the returned EMA carry is the one AFTER frame ``count-1``, so
        padding never pollutes the display state.  Traced as an
        argument — no recompile per partial size."""
        if count is None:
            count = len(powers)
        comps, prev2, meta = self._jit(powers, cams, yolos, prev,
                                       jnp.int32(count), self.tables)
        return comps, prev2, meta

    def empty_yolo(self, k: int = 1) -> np.ndarray:
        """A no-op YOLO input batch for this compositor's mode: an empty
        canvas, or an all-padding boxes array (rows at -100 raster
        nothing)."""
        if self.max_tracks:
            return np.full((k, self.max_tracks, 5), -100.0, np.float32)
        Hy, Wy = self.yolo_shape
        return np.zeros((k, Hy, Wy, 3), np.uint8)

    def warmup(self, k: int = 1):
        Xg, Yg = self.grid_shape
        Hc, Wc = self.cam_shape
        p = np.zeros((k, Xg, Yg), np.float32)
        c = np.zeros((k, Hc, Wc, 3), np.uint8)
        out = self(p, c, self.empty_yolo(k), self.init_prev(), count=1)
        jax.tree.map(np.asarray, out)

    @classmethod
    def meta_dict(cls, meta) -> dict:
        """Unpack the (K, 5) packed gating scalars (one device-to-host
        copy instead of five)."""
        m = np.asarray(meta)
        return {k: m[:, i] for i, k in enumerate(cls.META_FIELDS)}

    def _raster_tracks(self, boxes):
        """The tracker's green thickness-2 ID rectangles
        (``pipeline._draw_tracks`` -> ``imaging.rectangle(..., 2)``)
        rasterized on device: cv2's thick outline is the L1 ball of
        radius thickness-1 around the perimeter (probed empirically).
        ``boxes`` (T, 5) f32; padding rows at -100 touch no pixel."""
        f32 = jnp.float32
        Hy, Wy = self.yolo_shape
        xs = jax.lax.broadcasted_iota(f32, (Hy, Wy), 1)
        ys = jax.lax.broadcasted_iota(f32, (Hy, Wy), 0)

        def one(box):
            x1, y1, x2, y2 = box[0], box[1], box[2], box[3]
            dx_in = jnp.maximum(0.0, jnp.maximum(x1 - xs, xs - x2))
            dy_in = jnp.maximum(0.0, jnp.maximum(y1 - ys, ys - y2))
            d = jnp.minimum(
                jnp.minimum(jnp.abs(ys - y1) + dx_in,
                            jnp.abs(ys - y2) + dx_in),
                jnp.minimum(jnp.abs(xs - x1) + dy_in,
                            jnp.abs(xs - x2) + dy_in))
            return d <= 1.0                       # thickness 2
        mask = jax.vmap(one)(boxes).any(0)
        green = jnp.asarray([0.0, 255.0, 0.0], f32)
        return jnp.where(mask[..., None], green, f32(0))

    def _run(self, powers, cams, yolos, prev, count, t: CompositeTables):
        powers = powers.astype(jnp.float32)
        cams = cams.astype(jnp.float32)
        yolos = yolos.astype(jnp.float32)

        def body(prev_u8, xs):
            power, cam, yolo = xs
            comp, res_u8, meta = self._one(power, cam, yolo,
                                           prev_u8.astype(jnp.float32), t)
            return res_u8, (comp, res_u8, meta)

        _, (comps, res_stack, metas) = jax.lax.scan(
            body, prev, (powers, cams, yolos))
        # the EMA carry after the last REAL frame (padded repeats past
        # `count` must not advance the display state)
        prev2 = jax.lax.dynamic_index_in_dim(res_stack, count - 1, 0,
                                             keepdims=False)
        return comps, prev2, metas

    def _one(self, power, cam, yolo, prev, t: CompositeTables):
        f32 = jnp.float32
        Xg, Yg = self.grid_shape
        Ww, Hw = self.window

        # ---- calculate_heatmap_with_detection (visual.py:227-293) ----
        should = power.max() > f32(self.threshold)
        safe = jnp.clip(power, f32(1e-12), None)
        # log_normalize (visual.py:164-166)
        img = jnp.log10(safe)
        img = img - jnp.log10(safe.min())
        imx = img.max()
        img01 = jnp.where(imx > 0, img / jnp.where(imx > 0, imx, f32(1)),
                          img)
        # colorize_power (the reference paint loop, visual.py:170-184)
        p = jnp.clip((img01 - f32(self.amount)) / f32(self.amount),
                     f32(0), None)
        cval = jnp.clip(jnp.floor(f32(255) * p ** self.exponent),
                        0, 255).astype(jnp.int32)
        src = t.lut[cval]                                  # (Xg, Yg, 3)
        painted = (img01 >= f32(self.amount)) & should
        small = jnp.where(painted[..., None], src, f32(0))
        # double flip: small[Yg-1-y, Xg-1-x] = src[x, y]
        small = small.transpose(1, 0, 2)[::-1, ::-1]
        res1 = _round_u8(_bilinear(small, t.heat_y0, t.heat_y1, t.heat_fy,
                                   t.heat_x0, t.heat_x1, t.heat_fx))
        # EMA smoothing (visual.py:455: addWeighted(prev, .5, res1, .5))
        res = _round_u8(f32(self.ema) * prev + f32(1 - self.ema) * res1)

        # ---- find_power_center (visual.py:295-322) ----
        sm = self._gauss5(safe, t.gauss)
        mask = sm >= f32(0.95) * sm.max()
        w = (sm ** 3) * mask
        tw = w.sum()
        rows = jax.lax.broadcasted_iota(f32, (Xg, Yg), 0)
        cols = jax.lax.broadcasted_iota(f32, (Xg, Yg), 1)
        am = jnp.argmax(sm)
        am_r = (am // Yg).astype(f32)
        am_c = (am % Yg).astype(f32)
        safe_tw = jnp.where(tw > 0, tw, f32(1))
        peak_x = jnp.where(tw > 0, (rows * w).sum() / safe_tw, am_r)
        peak_y = jnp.where(tw > 0, (cols * w).sum() / safe_tw, am_c)
        sx = Ww - 1 - jnp.floor(peak_x / max(Xg - 1, 1) * Ww) \
            .astype(jnp.int32)
        sy = Hw - 1 - jnp.floor(peak_y / max(Yg - 1, 1) * Hw) \
            .astype(jnp.int32)

        # power box overlay: cv2 thick rect = L1 ball of radius t-1
        # around the perimeter; filled circle = d^2 <= r^2 (both probed)
        x1 = jnp.maximum(0, sx - self.bw // 2)
        y1 = jnp.maximum(0, sy - self.bh // 2)
        x2 = jnp.minimum(Ww, sx + self.bw // 2)
        y2 = jnp.minimum(Hw, sy + self.bh // 2)
        xs_w = jax.lax.broadcasted_iota(jnp.int32, (Hw, Ww), 1)
        ys_w = jax.lax.broadcasted_iota(jnp.int32, (Hw, Ww), 0)
        dx_in = jnp.maximum(0, jnp.maximum(x1 - xs_w, xs_w - x2))
        dy_in = jnp.maximum(0, jnp.maximum(y1 - ys_w, ys_w - y2))
        d_edges = jnp.minimum(
            jnp.minimum(jnp.abs(ys_w - y1) + dx_in,
                        jnp.abs(ys_w - y2) + dx_in),
            jnp.minimum(jnp.abs(xs_w - x1) + dy_in,
                        jnp.abs(xs_w - x2) + dy_in))
        rect = (d_edges <= 2) & should                     # thickness 3
        circ = ((xs_w - sx) ** 2 + (ys_w - sy) ** 2 <= 25) & should
        magenta = jnp.asarray([255.0, 0.0, 255.0], f32)
        red = jnp.asarray([0.0, 0.0, 255.0], f32)
        power_img = jnp.where(circ[..., None], red,
                              jnp.where(rect[..., None], magenta, f32(0)))

        # ---- Viewer.loop camera path (visual.py:449-452) ----
        frame = _round_u8(_bilinear(cam[:, ::-1], t.cam_y0, t.cam_y1,
                                    t.cam_fy, t.cam_x0, t.cam_x1,
                                    t.cam_fx))
        image = _round_u8(f32(0.9) * frame + f32(0.9) * res) \
            if self.heatmap_color else frame
        canvas = self._raster_tracks(yolo) if self.max_tracks else yolo
        yolo_img = _round_u8(_bilinear(canvas, t.yolo_y0, t.yolo_y1,
                                       t.yolo_fy, t.yolo_x0, t.yolo_x1,
                                       t.yolo_fx))

        # ---- decider (decider.py:26-68) ----
        # light level: cv2 BGR->gray rounds per pixel before the mean
        gray = jnp.round(image @ jnp.asarray([0.114, 0.587, 0.299], f32))
        light = gray.mean() / f32(255)
        yolo_img = yolo_img * (light >= f32(self.light_gate))
        # entropy of the (uint8-valued) EMA heatmap -> confidence
        s = res.sum()
        pv = res / jnp.where(s > 0, s, f32(1))
        ent = -jnp.sum(jnp.where(res > 0,
                                 pv * jnp.log(jnp.where(res > 0, pv,
                                                        f32(1))), f32(0)))
        conf = jnp.where(s > 0, f32(1) / (f32(1) + ent), f32(1))
        # gate, blend, flip (decider.py:26-51) — sequential saturating
        # uint8 addWeighted steps, like the host
        c1 = _round_u8(image + f32(0.7) * yolo_img[:, ::-1])
        c2 = _round_u8(c1 + f32(0.7) * power_img)
        c3 = _round_u8(c2 + f32(0.7) * res)
        comp = c3[:, ::-1].astype(jnp.uint8)

        # META_FIELDS order; packed so the caller syncs ONE small array
        meta = jnp.stack([light, conf, should.astype(f32),
                          sx.astype(f32), sy.astype(f32)])
        return comp, res.astype(jnp.uint8), meta

    @staticmethod
    def _gauss5(x, g):
        """5x5 separable Gaussian with BORDER_REFLECT_101 (= jnp.pad
        'reflect', matching cv2's default and the imaging fallback)."""
        X, Y = x.shape
        pz = jnp.pad(x, ((2, 2), (2, 2)), mode="reflect")
        tmp = sum(g[k] * pz[:, k:k + Y] for k in range(5))   # axis 1
        return sum(g[k] * tmp[k:k + X, :] for k in range(5))  # axis 0


class DeviceViewer:
    """Drop-in replacement for ``utils.viz.Viewer.loop`` running the
    display chain on device in K-frame batches.

    Same queue semantics as the host viewer (``visual.py:405-484``):
    per displayed frame one (power, camera, yolo-overlay) triple, items
    already dequeued carried across timeouts.  Triples are collected up
    to ``batch`` (padding partial batches with repeats of the last
    triple — static shapes, no recompile; padded outputs discarded via
    ``count``), composited in ONE device program, and the pipeline is
    double-buffered: batch *i+1* is collected and dispatched while batch
    *i*'s composites download.

    Accounting: ``frames`` composited, ``latency_ms`` per frame from
    triple-complete to display (the compositing end-to-end the host path
    never measured), ``light``/``conf`` mirror the host decider's
    ``last_light_level``/``last_entropy_confidence``.
    """

    def __init__(self, compositor: DeviceCompositor, display,
                 batch: int = 8):
        self.comp = compositor
        self.display = display
        self.batch = int(batch)
        self.frames = 0
        self.latency_ms: list = []
        self.light: Optional[float] = None
        self.conf: Optional[float] = None

    def warmup(self):
        self.comp.warmup(self.batch)

    def _as_yolo(self, yolo):
        """Normalize a q_inference payload to this compositor's YOLO
        input: (T, 5) track boxes padded/truncated to max_tracks, or a
        3-channel canvas image."""
        if self.comp.max_tracks:
            boxes = np.full((self.comp.max_tracks, 5), -100.0, np.float32)
            if yolo is not None and len(yolo):
                b = np.asarray(yolo, np.float32)[:self.comp.max_tracks]
                boxes[:len(b)] = b
            return boxes
        if yolo is None:
            return np.zeros(self.comp.yolo_shape + (3,), np.uint8)
        if yolo.ndim == 2:
            yolo = np.repeat(yolo[..., None], 3, -1)
        return yolo.astype(np.uint8, copy=False)

    def _collect(self, q_power, q_viewer, q_inference, pend, deadline,
                 running, remaining):
        """Gather up to min(batch, remaining) triples; returns
        (powers, cams, yolos, t_ready list).  Blocks until at least one
        triple or the deadline/running flag stops it."""
        import queue as _q
        triples = []
        want = min(self.batch, remaining)
        while len(triples) < want:
            timeout = 0.5 if not triples else 0.0
            try:
                if pend["y"] is None and q_inference is not None:
                    pend["y"] = q_inference.get(timeout=timeout)
                if pend["p"] is None:
                    pend["p"] = q_power.get(timeout=timeout)
                if pend["f"] is None and q_viewer is not None:
                    pend["f"] = q_viewer.get(timeout=timeout)
            except _q.Empty:
                if triples:
                    break               # flush a partial batch
                if not _running(running) or time.time() > deadline:
                    break
                continue
            power, _seq = pend["p"]
            frame = pend["f"][1] if pend["f"] is not None else None
            yolo = pend["y"][1] if pend["y"] is not None else None
            pend["p"] = pend["f"] = pend["y"] = None
            Hc, Wc = self.comp.cam_shape
            if frame is None:
                frame = np.zeros((Hc, Wc, 3), np.uint8)
            elif frame.ndim == 2:
                frame = np.repeat(frame[..., None], 3, -1)
            triples.append((np.asarray(power, np.float32),
                            frame.astype(np.uint8, copy=False),
                            self._as_yolo(yolo),
                            time.perf_counter()))
        return triples

    def loop(self, q_power, running, q_viewer=None, q_inference=None,
             max_frames: Optional[int] = None):
        prev = self.comp.init_prev()
        pend = {"p": None, "f": None, "y": None}
        deadline = time.time() + 3600.0
        pending = None                      # (comps, meta, t_ready, n)
        while _running(running) and (max_frames is None
                                     or self.frames < max_frames):
            remaining = (self.batch if max_frames is None
                         else max_frames - self.frames
                         - (pending[3] if pending else 0))
            if remaining <= 0:
                break
            triples = self._collect(q_power, q_viewer, q_inference, pend,
                                    deadline, running, remaining)
            if not triples:
                if pending is not None:
                    self._finish(pending)
                    pending = None
                if not _running(running):
                    break
                continue
            n = len(triples)
            powers = np.stack([t[0] for t in triples])
            cams = np.stack([t[1] for t in triples])
            yolos = np.stack([t[2] for t in triples])
            if n < self.batch:              # pad, static shapes
                rep = self.batch - n
                powers = np.concatenate(
                    [powers, np.repeat(powers[-1:], rep, 0)])
                cams = np.concatenate([cams, np.repeat(cams[-1:], rep, 0)])
                yolos = np.concatenate(
                    [yolos, np.repeat(yolos[-1:], rep, 0)])
            comps, prev, meta = self.comp(powers, cams, yolos, prev,
                                          count=n)
            if pending is not None:
                self._finish(pending)       # sync batch i-1, in order
            pending = (comps, meta, [t[3] for t in triples], n)
        if pending is not None:
            self._finish(pending)

    def _finish(self, pending):
        comps, meta, t_ready, n = pending
        host = np.asarray(comps)            # ONE sync per batch
        m = np.asarray(meta)                # (K, 5) packed, one transfer
        now = time.perf_counter()
        for i in range(n):
            self.display.show(host[i])
            self.latency_ms.append((now - t_ready[i]) * 1e3)
        self.frames += n
        self.light = float(m[n - 1, 0])
        self.conf = float(m[n - 1, 1])

    def report(self):
        lat = np.asarray(self.latency_ms, np.float64)
        return {
            "frames": self.frames,
            "latency_p50_ms": round(float(np.percentile(lat, 50)), 2)
            if lat.size else None,
            "latency_p95_ms": round(float(np.percentile(lat, 95)), 2)
            if lat.size else None,
            "light": self.light, "conf": self.conf,
        }


def _running(running):
    return bool(getattr(running, "value", running))
