"""Synthetic detection dataset for training/evaluating the tiny-YOLO.

The reference trained its detector offline with Ultralytics on private
data whose weights blob is missing upstream
(``image-detection/model/.MISSING_LARGE_BLOBS``), so exact weight parity
is impossible; this generator provides a reproducible task with exact
ground truth instead, used both by the training demo and by the AP gate
in ``tests/test_vision.py``.

Images are textured-noise backgrounds with 1..max_objects bright filled
rectangles (one class, like the reference's person-centric deployment);
boxes are exact, so AP measures the detector, not the labels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _paint_object(img: np.ndarray, x1: int, y1: int, w: int, h: int,
                  cls_id: int, color: np.ndarray) -> None:
    """Class-distinct shapes: 0 = filled rectangle, 1 = filled ellipse,
    2 = hollow rectangle (ring).  Shape (not just color) separates the
    classes so a multi-class detector must actually learn appearance."""
    patch = img[y1:y1 + h, x1:x1 + w]
    if cls_id == 0:
        mask = np.ones((h, w), bool)
    elif cls_id == 1:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        mask = (((yy - cy) / max(cy, 1)) ** 2
                + ((xx - cx) / max(cx, 1)) ** 2) <= 1.0
    else:
        mask = np.zeros((h, w), bool)
        t = max(2, min(h, w) // 4)
        mask[:t, :] = mask[-t:, :] = True
        mask[:, :t] = mask[:, -t:] = True
    patch[mask] = 0.2 * patch[mask] + 0.8 * color


def synthetic_detection_batch(
    rng: np.random.Generator, n: int, size: int = 64,
    max_objects: int = 2, min_frac: float = 0.25, max_frac: float = 0.6,
    num_classes: int = 1,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(images (n, size, size, 3) float32 in [0,1], boxes per image
    (k, 5) [x1, y1, x2, y2, class]).

    ``num_classes`` > 1 draws class-distinct shapes (the reference
    deployed Ultralytics-grade multi-class detection,
    ``image-detection/src/yolo_smooth_tracking.py:9-23``; its weights
    blob is missing upstream, so quality is gated on this exact-label
    synthetic task instead)."""
    images = np.empty((n, size, size, 3), np.float32)
    boxes: List[np.ndarray] = []
    for i in range(n):
        # smooth noise background: low-res noise upsampled
        low = rng.random((8, 8, 3)).astype(np.float32) * 0.4
        img = np.kron(low, np.ones((size // 8, size // 8, 1),
                                   np.float32))
        img += rng.random((size, size, 3)).astype(np.float32) * 0.1
        k = int(rng.integers(1, max_objects + 1))
        bs = []
        for _ in range(k):
            w = int(rng.uniform(min_frac, max_frac) * size)
            h = int(rng.uniform(min_frac, max_frac) * size)
            x1 = int(rng.integers(0, size - w))
            y1 = int(rng.integers(0, size - h))
            cls_id = int(rng.integers(0, num_classes))
            color = rng.uniform(0.7, 1.0, 3).astype(np.float32)
            _paint_object(img, x1, y1, w, h, cls_id, color)
            bs.append([x1, y1, x1 + w, y1 + h, float(cls_id)])
        images[i] = np.clip(img, 0.0, 1.0)
        boxes.append(np.asarray(bs, np.float64))
    return images, boxes


def synthetic_dataset(seed: int, n_batches: int, batch_size: int = 8,
                      size: int = 64, **kw):
    """Iterable of (images, boxes) batches for ``Trainer.fit``."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield synthetic_detection_batch(rng, batch_size, size, **kw)


class SceneCamera:
    """Headless camera stand-in whose frames a trained detector can
    actually detect: one object (same shape/color/background family as
    the training task above) moving on a Lissajous path.

    The gradient ``apps.web.SyntheticCamera`` gives the fused demo
    pixels but nothing to find — with this camera plus
    ``train.pretrained_demo_detector`` the whole sensor-fusion chain
    (detect -> SORT -> decider -> ``focus_beam`` steering) runs live on
    real detections.  ``last_box`` exposes the ground-truth
    ``[x1, y1, x2, y2]`` of the most recent frame for tests.

    ``prerender`` > 0 renders that many frames up front and serves them
    cyclically: ``read()`` becomes a list index — the paint cost (~3 ms
    of numpy per 240x320 frame) stops competing for the GIL with the
    realtime pipeline threads.  That is also the
    reference-faithful cost model: a webcam read is a V4L2 buffer
    memcpy, not a per-frame software paint.  (1260 = lcm of the two
    Lissajous periods, so the cycle is seamless.)"""

    def __init__(self, size: Tuple[int, int] = (240, 320),
                 cls_id: int = 0, obj_frac: float = 0.35, seed: int = 5,
                 prerender: int = 0):
        h, w = size
        rng = np.random.default_rng(seed)
        low = rng.random((8, 8, 3)).astype(np.float32) * 0.4
        bg = np.kron(low, np.ones((-(-h // 8), -(-w // 8), 1), np.float32))
        bg = bg[:h, :w] + rng.random((h, w, 3)).astype(np.float32) * 0.1
        self._bg = np.clip(bg, 0.0, 1.0)
        self._color = rng.uniform(0.8, 1.0, 3).astype(np.float32)
        self.size = size
        self.cls_id = cls_id
        self._ow = int(obj_frac * min(h, w))
        self.i = 0
        self.last_box = [0, 0, 0, 0]
        self._frames = self._boxes = None
        if prerender:
            self._frames, self._boxes = [], []
            for _ in range(prerender):
                _, f = self._render()
                self._frames.append(f)
                self._boxes.append(list(self.last_box))
            self.i = 0

    def _render(self):
        h, w = self.size
        img = self._bg.copy()
        t = self.i
        self.i += 1
        ow = self._ow
        cx = w / 2 + 0.32 * w * np.sin(2 * np.pi * t / 180.0)
        cy = h / 2 + 0.30 * h * np.sin(2 * np.pi * t / 140.0 + 1.0)
        x1 = int(np.clip(cx - ow / 2, 0, w - ow))
        y1 = int(np.clip(cy - ow / 2, 0, h - ow))
        _paint_object(img, x1, y1, ow, ow, self.cls_id, self._color)
        self.last_box = [x1, y1, x1 + ow, y1 + ow]
        return True, (img * 255).astype(np.uint8)

    def read(self):
        if self._frames is not None:
            j = self.i % len(self._frames)
            self.i += 1
            self.last_box = self._boxes[j]
            return True, self._frames[j]
        return self._render()
