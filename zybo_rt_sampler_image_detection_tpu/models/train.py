"""YOLO detector training (optax), data-parallel over the device mesh.

Replaces the reference's Ultralytics ``model.train`` wrapper
(``image-detection/src/run_object_oriented.py:13-19``) with an explicit
JAX training loop: anchor/cell target assignment on the host, a jitted
loss/step on device, and DP sharding over the ``data`` mesh axis — the
SPMD partitioner turns the batch-mean loss into a gradient all-reduce, no
hand-written collectives.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .yolo import TinyYolo, YoloConfig, init_params


@dataclasses.dataclass
class TrainState:
    variables: dict
    opt_state: optax.OptState
    step: int = 0


def build_targets(cfg: YoloConfig, boxes: Sequence[np.ndarray]):
    """Host-side target assignment: each gt box -> (head, cell, best anchor
    by wh-IoU).  boxes: per-image (n, 5) [x1,y1,x2,y2,cls] in input pixels.
    Returns per-head (target (B,H,W,A,5+C), mask (B,H,W,A))."""
    B = len(boxes)
    out = []
    for anchors, stride in zip(cfg.anchors, cfg.strides):
        g = cfg.input_size // stride
        A = len(anchors)
        t = np.zeros((B, g, g, A, 5 + cfg.num_classes), np.float32)
        m = np.zeros((B, g, g, A), np.float32)
        out.append((t, m))
    aw = [np.array([a[0] for a in h], np.float64) for h in cfg.anchors]
    ah = [np.array([a[1] for a in h], np.float64) for h in cfg.anchors]

    for b, bx in enumerate(boxes):
        for row in np.asarray(bx, np.float64).reshape(-1, 5):
            x1, y1, x2, y2, cls_id = row
            w, h = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
            cx, cy = x1 + w / 2, y1 + h / 2
            # best (head, anchor) by wh IoU
            best = (-1.0, 0, 0)
            for hi in range(len(cfg.anchors)):
                inter = np.minimum(w, aw[hi]) * np.minimum(h, ah[hi])
                union = w * h + aw[hi] * ah[hi] - inter
                iou = inter / union
                ai = int(iou.argmax())
                if iou[ai] > best[0]:
                    best = (float(iou[ai]), hi, ai)
            _, hi, ai = best
            stride = cfg.strides[hi]
            g = cfg.input_size // stride
            gx, gy = min(int(cx / stride), g - 1), min(int(cy / stride), g - 1)
            t, m = out[hi]
            t[b, gy, gx, ai, 0] = cx / stride - gx              # tx target
            t[b, gy, gx, ai, 1] = cy / stride - gy              # ty target
            t[b, gy, gx, ai, 2] = np.log(max(w / aw[hi][ai], 1e-6))
            t[b, gy, gx, ai, 3] = np.log(max(h / ah[hi][ai], 1e-6))
            t[b, gy, gx, ai, 4] = 1.0                           # objectness
            t[b, gy, gx, ai, 5 + int(cls_id)] = 1.0
            m[b, gy, gx, ai] = 1.0
    return out


def yolo_loss(cfg: YoloConfig, heads, targets, masks,
              box_w: float = 5.0, obj_w: float = 1.0, cls_w: float = 1.0):
    """Per-head BCE(objectness) + masked MSE(box params) + BCE(class)."""
    total = 0.0
    for raw, tgt, msk in zip(heads, targets, masks):
        B, H, W, _ = raw.shape
        A = len(cfg.anchors[0])
        raw = raw.reshape(B, H, W, A, 5 + cfg.num_classes).astype(jnp.float32)
        pxy = jax.nn.sigmoid(raw[..., 0:2])
        pwh = raw[..., 2:4]
        pobj = raw[..., 4]
        pcls = raw[..., 5:]
        m = msk
        npos = jnp.maximum(m.sum(), 1.0)
        nneg = jnp.maximum((1.0 - m).sum(), 1.0)
        box_loss = (jnp.sum(m[..., None] * (pxy - tgt[..., 0:2]) ** 2)
                    + jnp.sum(m[..., None] * (pwh - tgt[..., 2:4]) ** 2)) / npos
        # Objectness is ~60:1 imbalanced (one assigned anchor per target):
        # normalize positives and negatives separately, else the optimum is
        # "predict the base rate" and nothing ever clears the conf threshold.
        obj_bce = optax.sigmoid_binary_cross_entropy(raw[..., 4], tgt[..., 4])
        obj_loss = (jnp.sum(m * obj_bce) / npos
                    + 0.5 * jnp.sum((1.0 - m) * obj_bce) / nneg)
        cls_loss = jnp.sum(m[..., None] * optax.sigmoid_binary_cross_entropy(
            raw[..., 5:], tgt[..., 5:])) / npos
        total = total + box_w * box_loss + obj_w * obj_loss + cls_w * cls_loss
    return total


class Trainer:
    def __init__(self, cfg: Optional[YoloConfig] = None,
                 learning_rate: float = 1e-3, seed: int = 0,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg or YoloConfig()
        self.model = TinyYolo(self.cfg)
        _, variables = init_params(self.cfg, jax.random.PRNGKey(seed))
        self.tx = optax.adamw(learning_rate)
        params = variables["params"]
        self.state = TrainState(variables=variables,
                                opt_state=self.tx.init(params))
        self.mesh = mesh
        self._step = self._make_step()

    def _make_step(self):
        model, cfg, tx = self.model, self.cfg, self.tx

        def loss_fn(params, batch_stats, images, targets, masks):
            variables = {"params": params, "batch_stats": batch_stats}
            heads, updates = model.apply(
                variables, images, train=True, mutable=["batch_stats"])
            return (yolo_loss(cfg, heads, targets, masks),
                    updates["batch_stats"])

        def step(state_vars, opt_state, images, targets, masks):
            params = state_vars["params"]
            bs = state_vars.get("batch_stats", {})
            (loss, new_bs), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, bs, images, targets, masks)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return {"params": params, "batch_stats": new_bs}, opt_state, loss

        self._step_fn = step          # unjitted core (reused by the
        #                               scan-chunk recipe runner below)
        if self.mesh is not None:
            dp = NamedSharding(self.mesh, P("data"))
            rep = NamedSharding(self.mesh, P())
            n_heads = len(self.cfg.anchors)
            return jax.jit(step, in_shardings=(
                rep, rep, NamedSharding(self.mesh, P("data", None, None, None)),
                (dp,) * n_heads, (dp,) * n_heads),
                out_shardings=(rep, rep, rep))
        return jax.jit(step)

    def train_step(self, images: np.ndarray, boxes: Sequence[np.ndarray]):
        """images: (B, S, S, 3) float32 in [0,1]; boxes: per-image (n, 5)."""
        tm = build_targets(self.cfg, boxes)
        targets = tuple(jnp.asarray(t) for t, _ in tm)
        masks = tuple(jnp.asarray(m) for _, m in tm)
        self.state.variables, self.state.opt_state, loss = self._step(
            self.state.variables, self.state.opt_state,
            jnp.asarray(images), targets, masks)
        self.state.step += 1
        return float(loss)

    def fit(self, dataset, epochs: int = 1, log_every: int = 10):
        """dataset: iterable of (images, boxes) batches."""
        losses = []
        for _ in range(epochs):
            for i, (images, boxes) in enumerate(dataset):
                loss = self.train_step(images, boxes)
                losses.append(loss)
                if log_every and i % log_every == 0:
                    print(f"step {self.state.step}: loss {loss:.4f}")
        return losses


def _checkpoint_tree(trainer: "Trainer") -> dict:
    return {
        "variables": jax.tree.map(np.asarray, trainer.state.variables),
        "opt_state": jax.tree.map(np.asarray, trainer.state.opt_state),
        "step": trainer.state.step,
    }


def save_checkpoint(path: str, trainer: "Trainer") -> None:
    """Pickle of params/batch-stats/optimizer/step as NumPy arrays — the
    checkpoint/resume capability the reference lacks entirely (SURVEY §5:
    coefficients and weights were recomputed or reloaded ad hoc)."""
    import pickle

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_checkpoint_tree(trainer), f)
    os.replace(tmp, path)


def restore_checkpoint(path: str, trainer: "Trainer") -> "Trainer":
    """Load a :func:`save_checkpoint` file into ``trainer``; a checkpoint
    whose pytree differs from the trainer's (another model width or
    layout) raises ``ValueError``."""
    import pickle

    with open(path, "rb") as f:
        restored = pickle.load(f)
    want = jax.tree.structure(_checkpoint_tree(trainer))
    if jax.tree.structure(restored) != want:
        raise ValueError(f"checkpoint {path} does not match this trainer's "
                         f"variables/optimizer layout")
    trainer.state = TrainState(
        variables=restored["variables"],
        opt_state=restored["opt_state"],
        step=int(restored["step"]))
    return trainer


def pretrained_demo_detector(cache_path: Optional[str] = None,
                             steps: int = 700, size: int = 64,
                             width: float = 0.25, num_classes: int = 1,
                             seed: int = 0):
    """A tiny-YOLO that actually detects the synthetic task — for the
    live demos (the reference's deployed weights blob is missing
    upstream, ``image-detection/model/.MISSING_LARGE_BLOBS``, so the
    demos train their own and cache the pickle).

    Returns a ready ``detect.YoloDetector``.  ``steps=700`` is the CI
    recipe; delete the cache to retrain.  A cached pickle whose pytree
    differs from this model's variables (another width, or an older
    variables layout) is retrained, not loaded."""
    import pickle

    from .. import paths
    from . import data
    from .detect import YoloDetector, load_weights

    cache = cache_path or os.path.join(paths.cache_dir("models"),
                                       "demo_detector.pkl")
    cfg = YoloConfig(input_size=size, width_mult=width,
                     num_classes=num_classes)
    det = YoloDetector(cfg=cfg)
    if os.path.exists(cache):
        try:
            cached = load_weights(cache)
        except (OSError, EOFError, pickle.UnpicklingError):
            cached = None                 # corrupt cache: retrain
        if (cached is not None and jax.tree.structure(cached)
                == jax.tree.structure(det.variables)):
            det.variables = cached
            return det
    trainer = Trainer(cfg, learning_rate=3e-3)
    trainer.fit(data.synthetic_dataset(seed, steps, batch_size=8,
                                       size=size,
                                       num_classes=num_classes),
                log_every=0)
    det.variables = trainer.state.variables
    cache_dir = os.path.dirname(cache)
    if cache_dir:                 # a bare filename has no dir to create
        os.makedirs(cache_dir, exist_ok=True)
    tmp = cache + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, det.variables), f)
    os.replace(tmp, cache)
    return det


def train_reference_recipe(steps: int = 3000, batch_size: int = 16,
                           size: int = 416, width: float = 1.0,
                           num_classes: int = 3,
                           learning_rate: float = 1e-3, seed: int = 0,
                           pool_batches: int = 96,
                           chunk_steps: int = 250,
                           eval_images: int = 192,
                           map_gate: float = 0.9,
                           conf_threshold: float = 0.05,
                           weights_out: Optional[str] = None,
                           progress=print) -> dict:
    """Train at the REFERENCE operating point: 416 px, full width,
    multi-class (the reference deployed full Ultralytics at this input
    size, ``image-detection/src/yolo_smooth_tracking.py:9-23``; its
    weights blob is missing upstream so quality is gated on the
    exact-label synthetic task instead — mAP@0.5 >= ``map_gate`` on a
    held-out set).

    The data pool lives ON DEVICE as uint8 (one upload, ``pool_batches``
    batches) with pre-built targets, and training advances in
    ``lax.scan`` chunks of ``chunk_steps`` — ONE dispatch per chunk
    instead of one per step.  Each scan step gathers its batch from
    the pool by a host-shuffled index (with replacement), normalizes
    u8 -> f32 on device, and runs the same ``Trainer`` step core the
    per-step API jits, so the two paths cannot drift (gated by
    ``tests/test_vision.py::test_scan_chunk_matches_per_step``).

    Returns a report dict: device step throughput (steps/s and img/s,
    measured over a timed chunk AFTER warmup), final loss, per-class
    AP@0.5 and mAP on the held-out set, and the gate verdict.
    """
    import time

    from . import data, eval as eval_mod
    from .detect import YoloDetector, save_weights

    cfg = YoloConfig(input_size=size, width_mult=width,
                     num_classes=num_classes)
    trainer = Trainer(cfg, learning_rate=learning_rate, seed=seed)
    rng = np.random.default_rng(seed + 1)

    # -- device-resident pool (uint8 images + prebuilt per-head targets)
    t0 = time.perf_counter()
    imgs_np = np.empty((pool_batches, batch_size, size, size, 3),
                       np.uint8)
    n_heads = len(cfg.anchors)
    tgts_np, msks_np = None, None
    for p in range(pool_batches):
        images, boxes = data.synthetic_detection_batch(
            rng, batch_size, size, num_classes=num_classes)
        imgs_np[p] = (images * 255.0).astype(np.uint8)
        tm = build_targets(cfg, boxes)
        if tgts_np is None:
            tgts_np = [np.empty((pool_batches,) + t.shape, np.float32)
                       for t, _ in tm]
            msks_np = [np.empty((pool_batches,) + m.shape, np.float32)
                       for _, m in tm]
        for hi, (t, m) in enumerate(tm):
            tgts_np[hi][p] = t
            msks_np[hi][p] = m
    gen_s = time.perf_counter() - t0
    progress(f"pool: {pool_batches}x{batch_size} images at {size}px "
             f"generated in {gen_s:.1f}s "
             f"({imgs_np.nbytes / 1e6:.0f} MB)")
    pool = jnp.asarray(imgs_np)
    targets = tuple(jnp.asarray(t) for t in tgts_np)
    masks = tuple(jnp.asarray(m) for m in msks_np)

    step_core = trainer._step_fn

    def chunk(state_vars, opt_state, pool, targets, masks, idxs):
        def body(carry, i):
            sv, os_ = carry
            imgs = pool[i].astype(jnp.float32) / 255.0
            tgt = tuple(t[i] for t in targets)
            msk = tuple(m[i] for m in masks)
            sv, os_, loss = step_core(sv, os_, imgs, tgt, msk)
            return (sv, os_), loss
        (state_vars, opt_state), losses = jax.lax.scan(
            body, (state_vars, opt_state), idxs)
        return state_vars, opt_state, losses

    donate = (0, 1) if jax.default_backend() != "cpu" else ()
    chunk_jit = jax.jit(chunk, donate_argnums=donate)

    sv, os_ = trainer.state.variables, trainer.state.opt_state
    done = 0
    losses_tail = None
    throughput = None
    t_train0 = time.perf_counter()
    while done < steps:
        n = min(chunk_steps, steps - done)
        idxs = jnp.asarray(rng.integers(0, pool_batches, n), jnp.int32)
        t0 = time.perf_counter()
        sv, os_, losses = chunk_jit(sv, os_, pool, targets, masks, idxs)
        losses_tail = np.asarray(losses)       # sync
        dt = time.perf_counter() - t0
        done += n
        # the timed-throughput chunk: first full-size chunk AFTER the
        # compile+warmup chunk (its dt includes tracing/compile)
        if throughput is None and done > chunk_steps and n == chunk_steps:
            throughput = n / dt
        progress(f"step {done}/{steps}: loss {losses_tail[-1]:.4f} "
                 f"({n / dt:.1f} steps/s)")
    train_s = time.perf_counter() - t_train0
    trainer.state = TrainState(variables=sv, opt_state=os_, step=done)

    det = YoloDetector(cfg=cfg)
    det.variables = jax.tree.map(np.asarray, sv)
    if weights_out:
        save_weights(weights_out, det.variables)

    # -- held-out eval (fresh seed), batched device inference
    rng_eval = np.random.default_rng(seed + 10_007)
    aps_dets, aps_gts = [], []
    eb = min(32, eval_images)
    for _ in range(-(-eval_images // eb)):
        images, boxes = data.synthetic_detection_batch(
            rng_eval, eb, size, num_classes=num_classes)
        frames = [(im * 255).astype(np.uint8) for im in images]
        dets = det.get_detections_batch(frames, conf_threshold,
                                        include_class=True)
        aps_dets += [np.asarray(d, np.float64).reshape(-1, 6)
                     for d in dets]
        aps_gts += [np.asarray(b, np.float64).reshape(-1, 5)
                    for b in boxes]
    aps, map50 = eval_mod.per_class_average_precision(
        aps_dets, aps_gts, num_classes)
    report = {
        "size": size, "width": width, "num_classes": num_classes,
        "steps": steps, "batch_size": batch_size,
        "train_s": round(train_s, 1),
        "steps_per_s": round(throughput, 2) if throughput else None,
        "imgs_per_s": round(throughput * batch_size, 1)
        if throughput else None,
        "final_loss": round(float(losses_tail[-1]), 4),
        "aps": [round(a, 4) for a in aps],
        "map50": round(map50, 4),
        "map_gate": map_gate,
        "gate_ok": bool(map50 >= map_gate),
        "backend": jax.default_backend(),
    }
    progress(f"held-out mAP@0.5 = {map50:.4f} (per-class "
             f"{[f'{a:.3f}' for a in aps]}) gate >= {map_gate}: "
             f"{'OK' if report['gate_ok'] else 'FAIL'}")
    return report


def main(argv=None):
    """CLI for the reference-operating-point recipe:
    ``python -m zybo_rt_sampler_image_detection_tpu.models.train``.
    Exits nonzero if the held-out mAP gate fails."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=train_reference_recipe.__doc__)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool", type=int, default=96,
                    help="device-resident pool size (batches)")
    ap.add_argument("--chunk", type=int, default=250,
                    help="lax.scan steps per dispatch")
    ap.add_argument("--eval-images", type=int, default=192)
    ap.add_argument("--gate", type=float, default=0.9)
    ap.add_argument("--out", default="",
                    help="weights .pkl output path")
    args = ap.parse_args(argv)
    report = train_reference_recipe(
        steps=args.steps, batch_size=args.batch, size=args.size,
        width=args.width, num_classes=args.classes,
        learning_rate=args.lr, seed=args.seed, pool_batches=args.pool,
        chunk_steps=args.chunk, eval_images=args.eval_images,
        map_gate=args.gate, weights_out=args.out or None)
    print(json.dumps(report))
    sys.exit(0 if report["gate_ok"] else 1)


def dryrun_train_step(mesh: Mesh) -> float:
    """One DP-sharded training step on tiny shapes (used by
    ``__graft_entry__.dryrun_multichip``)."""
    cfg = YoloConfig(input_size=64, width_mult=0.25)
    trainer = Trainer(cfg, mesh=mesh)
    B = max(2, mesh.shape["data"]) * 2
    rng = np.random.default_rng(0)
    images = rng.random((B, 64, 64, 3), np.float32)
    boxes = [np.array([[8.0, 8.0, 40.0, 40.0, 0.0]]) for _ in range(B)]
    loss = trainer.train_step(images, boxes)
    assert np.isfinite(loss)
    return loss


if __name__ == "__main__":
    main()
