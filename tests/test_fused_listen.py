"""Embedded listening in the fused display stage: the whole combined
product — steered power + YOLO + composite + gapless steered listening —
in ONE packed device program per cycle.

Contracts gated here:
* beam parity with :class:`BatchedMisoProducer`'s output (the
  standalone full-rate listening stage) for both beam backends:
  ``time`` (delay-and-sum + the reference gain chain) and ``mvdr`` (the
  adaptive distortionless beam through the shared
  ``make_mvdr_stream`` state machine);
* the gapless contract: counter-contiguous mic batches, sample-count
  exact stream, underruns counted;
* the audio e2e latency contract (ring publish stamps -> sink write);
* the display legs keep working when listening is folded in.

Ref: ``/root/reference/PC/src/main.pyx:279-380`` (the reference's
combined mimo+miso producer loops), ``api.c:491-543`` (miso_loop).
"""

import queue
import time

import numpy as np
import pytest

import zybo_rt_sampler_image_detection_tpu as zrt
from zybo_rt_sampler_image_detection_tpu.apps import fused as fused_mod
from zybo_rt_sampler_image_detection_tpu.apps.pipeline import Pipeline
from zybo_rt_sampler_image_detection_tpu.fusion.composite import (
    DeviceCompositor,
)
from zybo_rt_sampler_image_detection_tpu.ingest import streamer
from zybo_rt_sampler_image_detection_tpu.models.detect import YoloDetector
from zybo_rt_sampler_image_detection_tpu.models.yolo import YoloConfig
from zybo_rt_sampler_image_detection_tpu.ops import beamform
from zybo_rt_sampler_image_detection_tpu.utils import audio as audio_mod
from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
    PipelineMetrics,
)


class _CaptureSink(audio_mod.AudioSink):
    def __init__(self):
        self.chunks = []

    def write(self, samples):
        self.chunks.append(np.asarray(samples, np.float32).copy())

    @property
    def stream(self):
        return (np.concatenate(self.chunks)
                if self.chunks else np.zeros(0, np.float32))


class _NullDisplay:
    def show(self, img):
        pass


def _make_stage(p, cfg, listen, sink, batch=2, mic_batch=4):
    cam_hw = (48, 64)
    comp = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), cam_hw,
                            window=(80, 48), yolo_shape=cam_hw,
                            max_tracks=4)
    det = YoloDetector(cfg=YoloConfig(input_size=64, width_mult=0.25))
    q_cam = queue.Queue(maxsize=64)
    stage = fused_mod.FusedSensorStage(
        p.receiver, p.tables, comp, det, q_cam, _NullDisplay(),
        p.metrics, batch=batch, listen=listen, audio_sink=sink,
        mic_batch=mic_batch)
    return stage, q_cam, cam_hw


@pytest.mark.parametrize("listen", ["time", "mvdr"])
def test_fused_listen_gapless_and_parity(listen):
    """Every frame beamed exactly once through the packed program; the
    sink stream equals the standalone full-rate listening oracle on the
    quantized wire frames, in counter order."""
    from zybo_rt_sampler_image_detection_tpu.ops import freq

    # ports of its own: test_demo_sensorfusion binds 21951/21952 and may
    # run at the same time under xdist
    port = 21955 if listen == "time" else 21956
    cfg = zrt.Config.tiny().replace(udp_port=port)
    n_frames, Km = 16, 4
    rng = np.random.default_rng(7)
    base = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]

    p = Pipeline(cfg, algorithm="lerp", replay_mode=True,
                 backend="python")
    p.receiver.exact_reference = False
    sink = _CaptureSink()
    stage, q_cam, cam_hw = _make_stage(p, cfg, listen, sink,
                                       batch=2, mic_batch=Km)
    # the demo wires the fused stage as the steer target; p.stop() must
    # close the sink through the stage's AudioLeg (regression: it
    # assumed a .sink attribute and crashed the demo at teardown)
    p._miso = stage
    # a couple of camera frames so display cycles composit something;
    # later listening cycles run with an empty camera queue (n=0 path)
    for i in range(3):
        q_cam.put((i + 1, np.full(cam_hw + (3,), 40 * i, np.uint8)))
    stage.warmup()

    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    p.run_stage(stage)
    deadline = time.time() + 20.0
    while (stage.audio.samples < n_frames * cfg.n_samples
           and time.time() < deadline):
        time.sleep(0.05)
    p.stop()

    assert stage.audio.underrun_frames == 0, "gapless contract"
    beamed = stage.audio.samples // cfg.n_samples
    assert beamed >= n_frames
    assert sink.stream.size == stage.audio.samples

    # e2e latency contract: stamps flowed through the packed program path
    lat = stage.audio.latency()
    assert lat and lat["audio_e2e_p50_ms"] > 0.0

    # parity with the standalone oracle on the quantized wire signal
    wires = [(np.round(f.astype(np.float64) * cfg.norm_factor)
              / cfg.norm_factor).astype(np.float32) for f in frames]
    if listen == "time":
        expect = np.concatenate([
            audio_mod.miso_gain(
                np.asarray(beamform.miso_beam(w, p.tables, 0)),
                p.tables.n_mics, cfg.mic_gain, cfg.norm_factor_sound)
            for w in wires])
    else:
        ft = freq.make_freq_tables(cfg, 100.0)
        st = freq.init_precision(ft)
        chunks = []
        for i in range(0, n_frames, Km):
            blk = np.stack(wires[i:i + Km])
            beams, st = freq.mvdr_listen_step(st, blk, ft, 0)
            chunks.append(np.asarray(beams).reshape(-1))
        expect = np.concatenate(chunks)
    got = sink.stream[:expect.size]
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-7)

    # the display legs kept working: composited frames flowed
    assert stage.frames >= 2
    rep = stage.report()
    assert rep["underrun_frames"] == 0
    assert rep["audio_frames"] == beamed


def test_fused_listen_steer_is_traced():
    """Re-steering the embedded beam must not retrace/recompile the
    packed program (direction is a traced argument, api.c:576-581)."""
    cfg = zrt.Config.tiny()
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True,
                 backend="python")
    sink = _CaptureSink()
    stage, q_cam, cam_hw = _make_stage(p, cfg, "time", sink,
                                       batch=2, mic_batch=4)
    rng = np.random.default_rng(3)
    mic = (rng.standard_normal(
        (4, cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    cams = np.zeros((2,) + cam_hw + (3,), np.uint8)
    out0 = np.asarray(stage._launch(mic, cams, 2))
    traces0 = stage._jit._cache_size()
    stage.steer(5)
    out1 = np.asarray(stage._launch(mic, cams, 2))
    assert stage._jit._cache_size() == traces0, "steer retraced"
    *_, beams0 = stage._unpack(out0)
    *_, beams1 = stage._unpack(out1)
    expect = np.stack([np.asarray(beamform.miso_beam(m, p.tables, 5))
                       for m in mic])
    np.testing.assert_allclose(beams1, expect, rtol=1e-4, atol=1e-7)
    assert not np.allclose(beams0, beams1)
    p.stop()
