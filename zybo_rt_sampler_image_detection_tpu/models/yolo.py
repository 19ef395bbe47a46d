"""Tiny-YOLO detector in plain JAX — the replacement for the reference's
Ultralytics dependency (``image-detection/src/yolo_smooth_tracking.py:9-23``
wraps ``YOLO(model.pt)``; the custom weights blob is absent from the repo,
``.MISSING_LARGE_BLOBS``).

Architecture: a YOLOv3-tiny-shaped anchor-based single-stage detector —
conv/BN/leaky backbone to /32 with a /16 skip, two detection heads with 3
anchors each.  Everything (backbone, box decode, NMS) runs on device in one
jit; the host only sees the final (max_det, 6) table.

The network is a pure function of a variables pytree
``{"params": ..., "batch_stats": ...}`` (:class:`TinyYolo`'s ``init`` /
``apply``): convolutions are ``lax.conv_general_dilated``, batch norm keeps
running statistics in ``batch_stats`` and updates them only in train mode.
Convs run in ``YoloConfig.dtype``; batch norm, losses and decodes in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# (w, h) anchor priors in pixels of the input resolution, per head
# (coarse /32 head first), COCO-ish tiny-yolo priors.
DEFAULT_ANCHORS = (
    ((81, 82), (135, 169), (344, 319)),     # stride 32
    ((10, 14), (23, 27), (37, 58)),         # stride 16
)

BN_MOMENTUM = 0.97
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 1                    # the reference tracks one class
    input_size: int = 416                   # square input
    width_mult: float = 1.0
    anchors: Tuple[Tuple[Tuple[int, int], ...], ...] = DEFAULT_ANCHORS
    dtype: Any = jnp.float32

    @property
    def strides(self) -> Tuple[int, ...]:
        return (32, 16)

    @property
    def out_per_anchor(self) -> int:
        return 5 + self.num_classes


def _conv(x, kernel, dtype):
    return jax.lax.conv_general_dilated(
        x.astype(dtype), kernel.astype(dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _max_pool2(x):
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


def _upsample2(x):
    return jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)


class TinyYolo:
    """Backbone + 2-scale detection heads.

    ``apply`` returns raw head outputs: list of (B, H, W, A*(5+C)).
    """

    def __init__(self, cfg: YoloConfig):
        self.cfg = cfg
        w = lambda f: max(8, int(f * cfg.width_mult))      # noqa: E731
        # conv/BN/leaky blocks: name -> (in channels, out channels, kernel)
        self.blocks = {
            "block0": (3, w(16), 3),
            "block1": (w(16), w(32), 3),
            "block2": (w(32), w(64), 3),
            "block3": (w(64), w(128), 3),
            "block4": (w(128), w(256), 3),      # /16 skip
            "block5": (w(256), w(512), 3),
            "block6": (w(512), w(256), 1),
            "block7": (w(256), w(512), 3),      # /32 head trunk
            "block8": (w(256), w(128), 1),      # upsample branch
            "block9": (w(128) + w(256), w(256), 3),   # /16 head trunk
        }
        n_out = len(cfg.anchors[0]) * cfg.out_per_anchor
        # 1x1 detection convs with bias: name -> (in channels, out channels)
        self.heads = {"head32": (w(512), n_out), "head16": (w(256), n_out)}

    def init(self, rng: jax.Array) -> dict:
        """Fresh variables: LeCun-normal conv kernels, zero biases, unit
        BN scale, running mean 0 and variance 1."""
        params, stats = {}, {}
        keys = jax.random.split(rng, len(self.blocks) + len(self.heads))
        for key, (name, (cin, cout, k)) in zip(keys, self.blocks.items()):
            params[name] = {
                "kernel": _lecun_normal(key, (k, k, cin, cout)),
                "scale": jnp.ones((cout,), jnp.float32),
                "bias": jnp.zeros((cout,), jnp.float32),
            }
            stats[name] = {"mean": jnp.zeros((cout,), jnp.float32),
                           "var": jnp.ones((cout,), jnp.float32)}
        for key, (name, (cin, cout)) in zip(keys[len(self.blocks):],
                                            self.heads.items()):
            params[name] = {"kernel": _lecun_normal(key, (1, 1, cin, cout)),
                            "bias": jnp.zeros((cout,), jnp.float32)}
        return {"params": params, "batch_stats": stats}

    def apply(self, variables: dict, x, train: bool = False,
              mutable: Sequence[str] = ()):
        """Forward pass.  With ``train=True`` batch norm normalises by the
        batch statistics and folds them into the running ones; pass
        ``mutable=["batch_stats"]`` to get ``(heads, {"batch_stats": new})``
        back, as the training step does."""
        p, s = variables["params"], variables["batch_stats"]
        dt = self.cfg.dtype
        new_stats = {}

        def block(name, x):
            y = _conv(x, p[name]["kernel"], dt).astype(jnp.float32)
            if train:
                mean = jnp.mean(y, axis=(0, 1, 2))
                var = jnp.maximum(
                    jnp.mean(y * y, axis=(0, 1, 2)) - mean * mean, 0.0)
                new_stats[name] = {
                    "mean": BN_MOMENTUM * s[name]["mean"]
                    + (1.0 - BN_MOMENTUM) * mean,
                    "var": BN_MOMENTUM * s[name]["var"]
                    + (1.0 - BN_MOMENTUM) * var,
                }
            else:
                mean, var = s[name]["mean"], s[name]["var"]
            y = (y - mean) * jax.lax.rsqrt(var + BN_EPS)
            y = y * p[name]["scale"] + p[name]["bias"]
            return jax.nn.leaky_relu(y, 0.1)

        def head(name, x):
            y = _conv(x, p[name]["kernel"], dt)
            return y + p[name]["bias"].astype(y.dtype)

        x = _max_pool2(block("block0", x))                          # /2
        x = _max_pool2(block("block1", x))                          # /4
        x = _max_pool2(block("block2", x))                          # /8
        x = _max_pool2(block("block3", x))                          # /16
        x16 = block("block4", x)
        x = block("block6", block("block5", _max_pool2(x16)))       # /32
        out32 = head("head32", block("block7", x))
        up = _upsample2(block("block8", x))
        out16 = head("head16",
                     block("block9", jnp.concatenate([up, x16], axis=-1)))
        heads = [out32, out16]
        if "batch_stats" in mutable:
            if not train:
                new_stats = s
            return heads, {"batch_stats": new_stats}
        return heads


def _lecun_normal(key, shape):
    """Truncated normal with variance 1/fan_in (fan_in = kh*kw*cin)."""
    fan_in = int(np.prod(shape[:-1]))
    # 0.8796... is the std of a unit normal truncated to [-2, 2]
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    return std * jax.random.truncated_normal(key, -2.0, 2.0, shape,
                                             jnp.float32)


def decode_head(raw: jax.Array, anchors, stride: int,
                num_classes: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Raw head (B, H, W, A*(5+C)) -> (boxes_xyxy (B, HWA, 4),
    obj (B, HWA), cls (B, HWA, C)), in input-image pixels."""
    B, H, W, _ = raw.shape
    A = len(anchors)
    raw = raw.reshape(B, H, W, A, 5 + num_classes).astype(jnp.float32)
    gy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    gx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    xy = jax.nn.sigmoid(raw[..., 0:2])
    cx = (xy[..., 0] + gx[None, :, :, None]) * stride
    cy = (xy[..., 1] + gy[None, :, :, None]) * stride
    anchor_w = jnp.asarray([a[0] for a in anchors], jnp.float32)
    anchor_h = jnp.asarray([a[1] for a in anchors], jnp.float32)
    bw = jnp.exp(jnp.clip(raw[..., 2], -8, 8)) * anchor_w
    bh = jnp.exp(jnp.clip(raw[..., 3], -8, 8)) * anchor_h
    boxes = jnp.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                      axis=-1)
    obj = jax.nn.sigmoid(raw[..., 4])
    cls = jax.nn.sigmoid(raw[..., 5:])
    return (boxes.reshape(B, -1, 4), obj.reshape(B, -1),
            cls.reshape(B, -1, num_classes))


def decode_all(cfg: YoloConfig, heads: Sequence[jax.Array]):
    """All heads concatenated: (B, N, 4), (B, N), (B, N, C)."""
    bs, os_, cs = [], [], []
    for raw, anchors, stride in zip(heads, cfg.anchors, cfg.strides):
        b, o, c = decode_head(raw, anchors, stride, cfg.num_classes)
        bs.append(b)
        os_.append(o)
        cs.append(c)
    return (jnp.concatenate(bs, 1), jnp.concatenate(os_, 1),
            jnp.concatenate(cs, 1))


def init_params(cfg: YoloConfig, rng: jax.Array):
    model = TinyYolo(cfg)
    return model, model.init(rng)
