"""FusedSensorStage program parity: the single packed device program
must produce byte-identical composites/detections/meta to the separate
paths it fuses (the production power program, the batched detector on
device-resized inputs, and the DeviceCompositor), and the uint8
pack/bitcast transport must be lossless."""

import numpy as np
import pytest

import zybo_rt_sampler_image_detection_tpu as zrt
from zybo_rt_sampler_image_detection_tpu.apps import fused as fused_mod
from zybo_rt_sampler_image_detection_tpu.apps.pipeline import (
    _batched_power_program,
)
from zybo_rt_sampler_image_detection_tpu.fusion.composite import (
    DeviceCompositor,
)
from zybo_rt_sampler_image_detection_tpu.ingest.receiver import Receiver
from zybo_rt_sampler_image_detection_tpu.models.detect import YoloDetector
from zybo_rt_sampler_image_detection_tpu.models.yolo import YoloConfig
from zybo_rt_sampler_image_detection_tpu.ops import beamform
from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
    PipelineMetrics,
)


class _NullDisplay:
    def show(self, img):
        pass


@pytest.fixture(scope="module")
def stage_and_inputs():
    import queue

    cfg = zrt.Config.tiny()
    rx = Receiver(cfg, replay_mode=True)      # never connected: cfg only
    tables = beamform.make_tables(cfg, "lerp", cache=False)
    cam_hw = (48, 64)
    comp = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), cam_hw,
                            window=(80, 48), yolo_shape=cam_hw,
                            max_tracks=4)
    det = YoloDetector(cfg=YoloConfig(input_size=64, width_mult=0.25))
    s = fused_mod.FusedSensorStage(
        rx, tables, comp, det, queue.Queue(), _NullDisplay(),
        PipelineMetrics(), batch=3)
    rng = np.random.default_rng(7)
    K = s.batch
    mic = rng.standard_normal(
        (K, cfg.n_microphones, cfg.n_samples)).astype(np.float32) * 0.1
    cams = rng.integers(0, 255, (K,) + cam_hw + (3,)).astype(np.uint8)
    boxes = np.full((comp.max_tracks, 5), -100.0, np.float32)
    boxes[0] = [5.0, 5.0, 30.0, 30.0, 1.0]
    return s, cfg, tables, comp, det, mic, cams, boxes


def test_fused_program_parity(stage_and_inputs):
    import jax
    import jax.numpy as jnp

    s, cfg, tables, comp, det, mic, cams, boxes = stage_and_inputs
    s._boxes = boxes
    out = s._launch(mic.copy(), cams, s.batch)
    comps, dets, mask, cls_ids, metas, _ = s._unpack(np.asarray(out))

    # 1) composite parity: DeviceCompositor on the separately computed
    # powers must produce byte-identical frames
    power_fn = _batched_power_program(tables, cfg.n_microphones)
    powers = np.asarray(power_fn(mic.copy()))
    K = s.batch
    yolos = np.broadcast_to(boxes, (K,) + boxes.shape)
    ref_comps, _prev, ref_meta = comp(powers, cams, np.asarray(yolos),
                                      comp.init_prev(), count=K)
    np.testing.assert_array_equal(comps, np.asarray(ref_comps))
    np.testing.assert_allclose(metas, np.asarray(ref_meta),
                               rtol=0, atol=1e-6)

    # 2) detector parity: the in-program device resize + forward must
    # match the same resize fed through the standalone batched forward
    dy0, dy1, dfy, dx0, dx1, dfx = (np.asarray(a) for a in s._det_tables)
    f = cams.astype(np.float32)
    fy = dfy[None, :, None, None]
    fx = dfx[None, None, :, None]
    rows = f[:, dy0] * (1.0 - fy) + f[:, dy1] * fy
    imgs = rows[:, :, dx0] * (1.0 - fx) + rows[:, :, dx1] * fx
    imgs_u8 = np.clip(np.round(imgs), 0, 255).astype(np.uint8)
    ref_dets, ref_mask, ref_cls = jax.tree.map(
        np.asarray, det._infer_batch(det.variables, jnp.asarray(imgs_u8)))
    np.testing.assert_allclose(dets, ref_dets, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(cls_ids, ref_cls)


def test_yuv420_display_transport(stage_and_inputs):
    """yuv420 halves the composite download; the roundtrip must equal
    cv2's own 4:2:0 conversion loss class — the device forward uses
    cv2's I420 coefficients and the host inverts with cv2.cvtColor."""
    import jax.numpy as jnp

    s, *_ = stage_and_inputs
    rng = np.random.default_rng(11)
    h, w = 48, 80
    img = rng.integers(0, 255, (1, h, w, 3)).astype(np.uint8)
    planes = np.asarray(fused_mod._bgr_to_i420(jnp.asarray(img)))

    cv2 = pytest.importorskip("cv2")
    # the device forward must match cv2's OWN conversion (probed
    # studio-range constants, top-left 2x2 chroma) within rounding
    ref = cv2.cvtColor(img[0], cv2.COLOR_BGR2YUV_I420).reshape(-1)
    diff = np.abs(planes[0].astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()

    # ... so the roundtrip equals cv2's own 4:2:0 loss class
    back = fused_mod._i420_to_bgr(planes, h, w)
    cv2_rt = cv2.cvtColor(ref.reshape(h * 3 // 2, w),
                          cv2.COLOR_YUV2BGR_I420)
    # +-1 plane rounding amplifies by the 2.017 chroma gain on inversion
    assert np.abs(back[0].astype(int) - cv2_rt.astype(int)).max() <= 6
    # smooth image: near-lossless end to end
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sm = np.clip(np.stack([100 + 50 * np.sin(yy / 9),
                           80 + 60 * np.cos(xx / 11),
                           120 + 40 * np.sin((xx + yy) / 13)], axis=-1),
                 0, 255).astype(np.uint8)[None]
    back2 = fused_mod._i420_to_bgr(
        np.asarray(fused_mod._bgr_to_i420(jnp.asarray(sm))), h, w)
    err = np.abs(back2.astype(int) - sm.astype(int))
    assert err.mean() < 2.5 and err.max() <= 12, (err.mean(), err.max())


def test_fused_yuv420_end_to_end(stage_and_inputs):
    """The yuv420 stage runs end to end and its composites match the rgb
    stage's within the 4:2:0 loss class (luma within rounding)."""
    import queue

    s, cfg, tables, comp, det, mic, cams, boxes = stage_and_inputs
    from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
        PipelineMetrics,
    )
    sy = fused_mod.FusedSensorStage(
        s.receiver, tables, comp, det, queue.Queue(), _NullDisplay(),
        PipelineMetrics(), batch=s.batch, display_transport="yuv420",
        transfer="f16")
    sy._boxes = boxes.copy()
    s._boxes = boxes.copy()
    s._prev = None
    out_y = sy._launch(mic.copy(), cams, sy.batch)
    comps_y, dets_y, mask_y, *_ = sy._unpack(np.asarray(out_y))
    # feed the rgb stage the SAME 4:2:0-roundtripped camera the yuv
    # stage's upload leg produces (random-noise cameras lose ~30 mean
    # to chroma subsampling — that's the transport's documented loss
    # class, not a stage bug; composites must agree given equal input)
    h, w = cams.shape[1:3]
    cams_rt = fused_mod._i420_to_bgr(
        fused_mod._host_bgr_to_i420(cams).reshape(len(cams), -1), h, w)
    out_r = s._launch(mic.copy(), cams_rt, s.batch)
    comps_r, dets_r, mask_r, *_ = s._unpack(np.asarray(out_r))
    # isolate the output-leg transport loss: push the rgb stage's
    # composites through the SAME host 4:2:0 roundtrip — the yuv stage
    # must sit in that loss class (residual = mic-f16 map differences
    # + the device inverse's +-1 rounding vs cv2, both small)
    import jax.numpy as jnp
    rt = fused_mod._i420_to_bgr(
        np.asarray(fused_mod._bgr_to_i420(jnp.asarray(comps_r)))
        .reshape(len(comps_r), -1),
        comps_r.shape[1], comps_r.shape[2])
    diff = np.abs(comps_y.astype(int) - rt.astype(int))
    assert diff.mean() < 3.0, diff.mean()
    # detections still flow (camera went through the 4:2:0 roundtrip)
    assert mask_y.shape == mask_r.shape


def test_fused_ema_carry_advances(stage_and_inputs):
    """Two launches: the EMA carry must evolve (prev2 of batch 1 feeds
    batch 2) exactly as two sequential DeviceCompositor calls."""
    s, cfg, tables, comp, det, mic, cams, boxes = stage_and_inputs
    s._boxes = np.full_like(boxes, -100.0)
    s._prev = None
    out1 = s._launch(mic.copy(), cams, s.batch)
    c1, *_ = s._unpack(np.asarray(out1))
    out2 = s._launch(mic.copy(), cams, s.batch)
    c2, *_ = s._unpack(np.asarray(out2))

    power_fn = _batched_power_program(tables, cfg.n_microphones)
    powers = np.asarray(power_fn(mic.copy()))
    K = s.batch
    yolos = np.broadcast_to(s._boxes, (K,) + s._boxes.shape)
    prev = comp.init_prev()
    r1, prev, _ = comp(powers, cams, np.asarray(yolos), prev, count=K)
    r2, prev, _ = comp(powers, cams, np.asarray(yolos), prev, count=K)
    np.testing.assert_array_equal(c1, np.asarray(r1))
    np.testing.assert_array_equal(c2, np.asarray(r2))
