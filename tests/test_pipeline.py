"""End-to-end pipeline tests: emulator -> receiver -> heatmap/miso/tracker
stages, steering, web server routes — all over real sockets, headless."""

import queue
import threading
import time
import urllib.request

import numpy as np
import pytest

import zybo_rt_sampler_image_detection_tpu as zrt
from zybo_rt_sampler_image_detection_tpu.apps.pipeline import (
    CameraProducer, Pipeline, put_drop_oldest,
)
from zybo_rt_sampler_image_detection_tpu.ingest import streamer
from zybo_rt_sampler_image_detection_tpu.ops import geometry
from zybo_rt_sampler_image_detection_tpu.utils.viz import (
    ArrayCapture, ArrayDisplay, Viewer,
)


def _source_frames(cfg, tx, ty, n=30, seed=3):
    delays = geometry.calculate_delays(cfg)
    active, _ = geometry.active_microphones(cfg)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(cfg.n_samples * 3).astype(np.float32) * 0.05
    lag = (delays[tx, ty].max() - delays[tx, ty]).round().astype(int)
    fr = np.zeros((cfg.n_microphones, cfg.n_samples), np.float32)
    for i, m in enumerate(active):
        s = cfg.n_samples - lag[i]
        fr[m] = base[s:s + cfg.n_samples]
    return [fr] * n


def test_put_drop_oldest():
    q = queue.Queue(maxsize=2)
    for i in range(5):
        put_drop_oldest(q, i)
    assert q.get() == 3 and q.get() == 4


def _backend_kinds(t):
    """One instance of every kind _select_power_backend can return."""
    from zybo_rt_sampler_image_detection_tpu.ops import freq_equiv
    return [
        ("freq_equiv", freq_equiv.make_equiv_tables(t)),
        ("xla", None),
    ]


def test_default_power_fn_single_frame_every_backend(tiny_cfg, rng,
                                                     monkeypatch):
    """The production policy may hand ANY backend kind to the
    single-frame live loop (HeatmapProducer warms up on a 2-D zeros
    frame), so every kind must accept (M, N) frames and (B, M, N)
    batches."""
    from conftest import synth_frame

    from zybo_rt_sampler_image_detection_tpu.apps import pipeline
    from zybo_rt_sampler_image_detection_tpu.ops import beamform

    t = beamform.make_tables(tiny_cfg.replace(matmul_precision="high"),
                             "lerp", cache=False)
    frame = synth_frame(tiny_cfg, rng)
    ref = np.asarray(beamform.steered_power(frame, t), np.float64)
    for kind, obj in _backend_kinds(t):
        monkeypatch.setattr(pipeline, "_select_power_backend",
                            lambda tables, _k=kind, _o=obj: (_k, _o))
        fn = pipeline.default_power_fn(t)
        out = np.asarray(fn(frame), np.float64)
        assert out.shape == ref.shape, kind
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-12,
                                   err_msg=kind)
        out3 = np.asarray(fn(frame[None]), np.float64)
        np.testing.assert_allclose(out3[0], ref, rtol=1e-4, atol=1e-12,
                                   err_msg=kind)


def test_batched_power_program_every_backend(tiny_cfg, rng, monkeypatch):
    """The shared full-rate device program must pad channel-sliced
    f16-transfer batches back to the full mic axis for every backend
    kind (previously only some kinds were reachable here)."""
    from conftest import synth_frame

    from zybo_rt_sampler_image_detection_tpu.apps import pipeline
    from zybo_rt_sampler_image_detection_tpu.ops import beamform

    cfg = tiny_cfg.replace(matmul_precision="high")
    t = beamform.make_tables(cfg, "lerp", cache=False)
    n_full = cfg.n_microphones
    full = np.stack([synth_frame(cfg, rng) for _ in range(3)])
    sliced = full[:, : n_full - 2].astype(np.float16)
    padded = np.zeros_like(full)
    padded[:, : n_full - 2] = sliced.astype(np.float32)
    ref = np.asarray(beamform.steered_power(padded, t), np.float64)
    for kind, obj in _backend_kinds(t):
        monkeypatch.setattr(pipeline, "_select_power_backend",
                            lambda tables, _k=kind, _o=obj: (_k, _o))
        prog = pipeline._batched_power_program(t, n_full)
        out = np.asarray(prog(sliced), np.float64)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-12,
                                   err_msg=kind)


def test_mimo_miso_batched_honors_power_backend():
    """Round-3 review regression: enabling audio must not silently switch
    the imaging semantics — the combined stage consults the pipeline's
    configured power_fn (mvdr/fft/equiv opt-ins) for the heatmap half."""
    cfg = zrt.Config.tiny().replace(udp_port=21927)
    calls = []

    def custom_power(frames):
        frames = np.asarray(frames)
        calls.append(frames.shape)
        return np.full((frames.shape[0], cfg.max_res_x, cfg.max_res_y),
                       7.0, np.float32)

    p = Pipeline(cfg, algorithm="lerp", replay_mode=True,
                 backend="python", power_fn=custom_power)
    try:
        stage = p.make_mimo_miso_batched(batch=4, beam="time")
        frames = np.stack([np.ones((cfg.n_microphones, cfg.n_samples),
                                   np.float32)] * 4)
        maps, beams = stage.process_fn(frames, 0)
        assert calls and calls[0] == frames.shape
        assert np.asarray(maps)[0, 0, 0] == 7.0
        assert np.asarray(beams).shape == (4, cfg.n_samples)
    finally:
        p.stop()


def test_pipeline_heatmap_and_steering(tmp_path):
    cfg = zrt.Config.tiny().replace(udp_port=21920)
    tx, ty = 6, 2
    frames = _source_frames(cfg, tx, ty)
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend="python",
                 audio_sink="wav", audio_path=str(tmp_path / "beam.wav"))
    p.receiver.exact_reference = False
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    p.start_heatmap()
    p.start_miso()
    d = p.steer_cartesian_degree(10.0, -5.0)
    assert 0 <= d < cfg.n_directions

    power, seq = p.q_power.get(timeout=10.0)
    x, y = np.unravel_index(power.argmax(), power.shape)
    time.sleep(0.5)                    # let miso write some audio
    rep = p.report()
    p.stop()
    assert abs(x - tx) <= 1 and abs(y - ty) <= 1
    assert rep["heatmap"]["count"] >= 1
    assert rep["miso"]["count"] >= 1
    assert rep["ingest"]["frames"] >= 2
    import wave
    with wave.open(str(tmp_path / "beam.wav")) as w:
        assert w.getnframes() >= cfg.n_samples


def test_viewer_loop_headless():
    """Viewer consumes (power, camera, yolo) queues and renders fused
    frames through the decider, fully headless."""
    cfg = zrt.Config.tiny()
    q_power, q_viewer, q_inf = (queue.Queue() for _ in range(3))
    rng = np.random.default_rng(0)
    for i in range(3):
        power = rng.random((cfg.max_res_x, cfg.max_res_y)) * 1e-4
        q_power.put((power, i))
        q_viewer.put((i, (rng.random((60, 80, 3)) * 255).astype(np.uint8)))
        q_inf.put((i, np.zeros((60, 80, 3), np.uint8), [[0, 0], [0, 0], 0]))
    disp = ArrayDisplay()
    clicks = []
    v = Viewer(cb=lambda h, vv: clicks.append((h, vv)), window=(160, 90),
               display=disp)

    class Running:
        value = 1

    v.loop(q_power, Running(), q_viewer=q_viewer, q_inference=q_inf,
           max_frames=3)
    assert len(disp.frames) == 3
    assert disp.frames[0].shape[2] == 3
    v._mouse(80, 45)
    assert len(clicks) == 1


def test_camera_producer_with_array_capture():
    from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
        PipelineMetrics,
    )
    frames = [(np.full((8, 8, 3), i, np.uint8)) for i in range(5)]
    qv, qy = queue.Queue(maxsize=2), queue.Queue(maxsize=2)
    cp = CameraProducer(ArrayCapture(frames), qv, qy, PipelineMetrics(),
                        fps_limit=200.0)
    cp.start()
    time.sleep(0.2)
    cp.stop()
    cp.join(timeout=2.0)
    assert not qv.empty() and not qy.empty()


def test_web_server_routes():
    cfg = zrt.Config.tiny().replace(udp_port=21921)
    frames = _source_frames(cfg, 4, 3, n=200)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    server = make_server(cfg, replay=True, port=0, headless_camera=True)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=5).read().decode()
        assert "enableBackend1" in html and "/monitor" in html

        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/enableBackend1?threshold=0.1"
            "&amount=0.4", timeout=15).read().decode()
        assert server.camera.threshold == pytest.approx(0.1)
        assert server.camera.amount == pytest.approx(0.4)
        assert server.camera.pipeline is not None

        # MJPEG stream delivers at least one JPEG frame
        req = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/monitor", timeout=15)
        data = req.read(40000)
        assert b"\xff\xd8" in data           # JPEG SOI marker
        req.close()

        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/disconnect", timeout=10).read()
        assert server.camera.pipeline is None
    finally:
        server.shutdown()
        server.camera.stop()


def test_web_sound_route():
    """/sound starts the pad backend plus the MISO audio stage."""
    cfg = zrt.Config.tiny().replace(udp_port=21922)
    frames = _source_frames(cfg, 4, 3, n=300)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    server = make_server(cfg, replay=True, port=0, headless_camera=True)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/sound", timeout=20).read()
        assert server.camera.pipeline is not None
        assert server.camera.pipeline._miso is not None
        time.sleep(0.5)
        assert server.camera.pipeline._miso.sink.frames > 0
    finally:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/disconnect", timeout=10).read()
        server.shutdown()
        server.camera.stop()


def test_web_adaptive_sound_route():
    """/sound?beam=mvdr (the UI's "adaptive sound" link, ``web.py:59``)
    starts the gapless batched MVDR listening stage: the audio stage must
    be the full-rate BatchedMisoProducer driven by the streaming-MVDR
    beam closure (not the time-domain default), audio must flow, and
    /metrics must report the stage."""
    import json

    cfg = zrt.Config.tiny().replace(udp_port=21932)
    # wide replay window — MVDR bring-up (freq tables + warmup compiles)
    # can take seconds on a loaded host
    frames = _source_frames(cfg, 4, 3, n=3000)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import (
        BatchedMisoProducer)
    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    server = make_server(cfg, replay=True, port=0, headless_camera=True)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/sound?beam=mvdr", timeout=60).read()
        p = server.camera.pipeline
        assert p is not None
        miso = p._miso
        assert isinstance(miso, BatchedMisoProducer)
        # the adaptive path: beam_fn is the stateful streaming-MVDR
        # closure (it exposes reset), not the plain delay-and-sum lambda
        assert getattr(miso.beam_fn, "reset", None) is not None
        deadline = time.time() + 15
        while time.time() < deadline and miso.sink.frames == 0:
            time.sleep(0.2)
        assert miso.sink.frames > 0
        rep = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read())
        assert rep["backend"] == "pad"          # imaging half stays pad
        assert rep["running"] is True
        stage = rep["pipeline"]["miso_batched"]
        assert stage["processed"] > 0
        assert "audio_e2e_p50_ms" in stage        # the latency contract
    finally:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/disconnect", timeout=10).read()
        server.shutdown()
        server.camera.stop()


def test_web_fullrate_optin():
    """?fullrate=1 on an imaging backend swaps in the batched full-rate
    heatmap stage (every frame beamformed) and /metrics gains its
    processed/skipped accounting."""
    import json

    cfg = zrt.Config.tiny().replace(udp_port=21933)
    frames = _source_frames(cfg, 4, 3, n=3000)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    server = make_server(cfg, replay=True, port=0, headless_camera=True)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/enableBackend1?fullrate=1",
            timeout=60).read()
        deadline = time.time() + 15
        stage = {}
        while time.time() < deadline:
            rep = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5).read())
            stage = rep.get("pipeline", {}).get("heatmap_batched", {})
            if stage.get("processed", 0) > 0:
                break
            time.sleep(0.3)
        assert stage.get("processed", 0) > 0
    finally:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/disconnect", timeout=10).read()
        server.shutdown()
        server.camera.stop()


def test_web_fused_optin():
    """?fused=1 backs the MJPEG stream with FusedSensorStage composites
    (one packed device program per batch) and /metrics exposes the
    cycle's phase breakdown (VERDICT r4 #8)."""
    import json

    cfg = zrt.Config.tiny().replace(udp_port=21934)
    frames = _source_frames(cfg, 4, 3, n=3000)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    from zybo_rt_sampler_image_detection_tpu.models.detect import (
        YoloDetector,
    )
    from zybo_rt_sampler_image_detection_tpu.models.yolo import YoloConfig
    server = make_server(cfg, replay=True, port=0, headless_camera=True)
    # hermetic: a tiny untrained detector instead of the cached
    # quick-pretrained one (the route only needs the program to run)
    server.camera.detector_factory = lambda: YoloDetector(
        cfg=YoloConfig(input_size=64, width_mult=0.25))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/enableBackend1?fused=1",
            timeout=120).read()
        assert server.camera._fused_stage is not None
        deadline = time.time() + 20
        rep = {}
        while time.time() < deadline:
            rep = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5).read())
            if rep.get("fused", {}).get("frames", 0) > 0:
                break
            time.sleep(0.3)
        assert rep.get("fused", {}).get("frames", 0) > 0
        assert "phase_p50_ms" in rep["fused"]
        # the MJPEG stream serves the device composites
        req = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/monitor", timeout=15)
        data = req.read(40000)
        assert b"\xff\xd8" in data           # JPEG SOI marker
        req.close()
    finally:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/disconnect", timeout=10).read()
        server.shutdown()
        server.camera.stop()


def test_record_udp_to_pcap(tmp_path):
    """UDP wire capture -> pcap + timestamp CSV (record_udp parity)."""
    import csv

    from zybo_rt_sampler_image_detection_tpu.ingest import protocol
    from zybo_rt_sampler_image_detection_tpu.utils import recording

    cfg = zrt.Config.tiny().replace(udp_port=21923)
    frames = _source_frames(cfg, 2, 2, n=3)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=4 * cfg.sample_rate)
    pcap = str(tmp_path / "c.pcap")
    csvp = str(tmp_path / "c.csv")
    n = recording.record_udp_to_pcap(cfg, seconds=1.2, path=pcap,
                                     timestamps_csv=csvp)
    assert n > 0
    payloads = [p for _, p in protocol.read_pcap(pcap)]
    assert len(payloads) == n
    with open(csvp) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["index", "timestamp", "counter"]
    assert len(rows) == n + 1


def test_web_replay_selection(tmp_path):
    """/replay lists captures and streaming one feeds the live pipeline."""
    cfg = zrt.Config.tiny().replace(udp_port=21924)
    frames = _source_frames(cfg, 5, 4, n=1)
    sig = np.concatenate([frames[0]] * 60, axis=1)
    np.save(tmp_path / "cap.npy", sig)

    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    server = make_server(cfg, replay=True, port=0, headless_camera=True,
                         capture_dir=str(tmp_path))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/replay", timeout=5).read().decode()
        assert "cap.npy" in html
        # kick off the replay, then connect the pad backend to consume it
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/replay?file=cap.npy",
            timeout=10).read().decode()
        assert "replaying cap.npy" in html
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/enableBackend1", timeout=30).read()
        deadline = time.time() + 10
        while time.time() < deadline:
            p = server.camera.pipeline
            if p is not None and p.receiver.native_stats.frames > 0:
                break
            time.sleep(0.2)
        assert server.camera.pipeline.receiver.native_stats.frames > 0
    finally:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/disconnect", timeout=10).read()
        server.shutdown()
        server.camera.stop()


def test_web_rejects_malformed_slider():
    """A malformed threshold/amount GET param must produce an HTTP 400
    (and not start the backend) — an unhandled float('abc') used to kill
    the request with no response and could leave the camera state
    half-updated (review finding, round 3)."""
    cfg = zrt.Config.tiny().replace(udp_port=21929)
    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    server = make_server(cfg, replay=True, port=0, headless_camera=True)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        import urllib.error
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/enableBackend1?threshold=abc",
                timeout=10)
        assert exc.value.code == 400
        assert server.camera.pipeline is None      # backend never started
        assert server.camera.threshold == 0.0      # state untouched
        # second param malformed -> neither applies (no half-update)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}"
                "/enableBackend1?threshold=0.7&amount=xyz", timeout=10)
        assert server.camera.threshold == 0.0
    finally:
        server.shutdown()
        server.camera.stop()


def test_web_mvdr_backend():
    """Backend 4 (beyond reference): real-time MVDR over the web app —
    the route starts a pipeline whose power_fn is the streaming Capon map,
    and /metrics reports it."""
    import json
    import urllib.request

    cfg = zrt.Config.tiny().replace(udp_port=21926)
    # wide replay window: the route's bring-up (pipeline + freq tables +
    # first-jax-touch + native engine load) can take ~1 s on a loaded
    # host, and the receiver only connects once packets overlap it
    frames = _source_frames(cfg, 4, 3, n=3000)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    server = make_server(cfg, replay=True, port=0, headless_camera=True)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/enableBackend4", timeout=30).read()
        rep = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read())
        assert rep["backend"] == "mvdr"
        assert rep["running"] is True
        # the injected power_fn is the MVDR closure, not the default
        assert server.camera.pipeline._power_fn is not None
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/disconnect", timeout=30).read()
    finally:
        server.shutdown()
        server.camera.stop()


def test_web_metrics_and_hardened_routes():
    """/metrics returns a JSON health snapshot; malformed backend paths get
    404 (not a handler-thread stack trace); /replay escapes untrusted file
    names (reflected-XSS fix, round-1 advisor)."""
    import json
    import urllib.error
    import urllib.parse

    cfg = zrt.Config.tiny().replace(udp_port=21925)
    from zybo_rt_sampler_image_detection_tpu.apps.web import make_server
    server = make_server(cfg, replay=True, port=0, headless_camera=True)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read()
        rep = json.loads(body)
        assert rep["running"] is False
        assert rep["backend"] in ("pad", "none")
        assert "overlay_errors" in rep

        for bad in ("/enableBackendFoo", "/enableBackend9"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{bad}", timeout=5)
            assert ei.value.code == 404

        evil = "<script>alert(1)</script>.npy"
        html_body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/replay?file="
            + urllib.parse.quote(evil), timeout=5).read().decode()
        assert "<script>" not in html_body
        assert "&lt;script&gt;" in html_body
    finally:
        server.shutdown()
        server.camera.stop()


def test_batched_stage_anchors_at_stream_start():
    """A batched consumer whose loop starts long after connect (a long
    compile can hold warmup() while packets flow) must anchor its counter-contiguous stream at the CURRENT
    published counter: frames published pre-start predate the stream
    and must not be zero-filled in as "underruns" (regression: the
    fused listen demo recorded ~31k fake underruns after a 129 s
    warmup because the loop anchored at counter 1)."""
    cfg = zrt.Config.tiny().replace(udp_port=21962)
    frames = _source_frames(cfg, 4, 3, n=3000)
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True,
                 backend="python")
    p.receiver.exact_reference = False
    # paced well below line rate: the anchor consumes the ring-resident
    # backlog first, and the consumer must catch up to live before the
    # ring wraps past it (a 2x-line-rate stream would make that a race)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.2,
                                  exact_reference=False,
                                  rate=cfg.sample_rate / 4)
    p.connect(timeout=5.0)
    # a meaningful pre-start backlog (the "warmup window"): more than
    # the ring holds, so an anchor-at-1 loop would be forced to skip
    deadline = time.time() + 20
    while (p.receiver.published_seq < p.receiver.ring_frames + 16
           and time.time() < deadline):
        time.sleep(0.05)
    assert p.receiver.published_seq > p.receiver.ring_frames
    from zybo_rt_sampler_image_detection_tpu.utils import audio as audio_mod
    stage = p.make_miso_batched(batch=4, sink=audio_mod.NullSink())
    stage.warmup()
    p.run_stage(stage)
    deadline = time.time() + 20
    while stage.processed < 40 and time.time() < deadline:
        time.sleep(0.05)
    p.stop()
    assert stage.processed >= 40
    assert stage.underrun_frames == 0, \
        "pre-start frames counted as underruns (anchor regression)"
