"""CLI entry point — parity with ``PC/demo.py`` (mimo / miso / record /
record_sensorfusion) plus the emulator and web server.

Examples::

    python -m zybo_rt_sampler_image_detection_tpu.apps.demo emulate --synthetic &
    python -m zybo_rt_sampler_image_detection_tpu.apps.demo mimo --replay --headless --frames 20
    python -m zybo_rt_sampler_image_detection_tpu.apps.demo miso --replay --audio wav --seconds 2
    python -m zybo_rt_sampler_image_detection_tpu.apps.demo record --replay --seconds 1 --out cap.npy
    python -m zybo_rt_sampler_image_detection_tpu.apps.demo web --replay --port 8080
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..config import Config
from .pipeline import Pipeline, make_mvdr_stream


def _add_common(p):
    p.add_argument("--replay", action="store_true",
                   help="bind loopback (replay/emulator mode)")
    p.add_argument("--algorithm", default="lerp",
                   choices=["pad", "lerp", "convolve", "hybrid",
                            "truncated", "fft", "mvdr"])
    p.add_argument("--backend", default="auto",
                   choices=["auto", "python", "native"])
    p.add_argument("--headless", action="store_true",
                   help="no cv2 windows; print stats instead")
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N heatmaps (0 = run until ^C)")
    p.add_argument("--port", type=int, default=None, help="UDP port override")
    p.add_argument("--preset", default="default",
                   choices=["default", "reference", "fft", "tiny"],
                   help="config preset: default (config.json parity), "
                        "reference (+ dead-mic list), fft (the web "
                        "backend-3 profile: 13x13, c=343, 4 arrays, "
                        "0-18 kHz, camera offset), tiny (16ch 9x7 — "
                        "hermetic CPU drives)")
    p.add_argument("--equiv", action="store_true",
                   help="exact frequency-domain reformulation of the "
                        "selected time-domain algorithm (~15x fewer MACs "
                        "at the reference shape, same output)")


def _resolve_arrays(args, cfg) -> int:
    """--arrays default = the config's active_arrays; explicit values are
    validated against capacity (a 3-array stream at the 1-array tiny
    config used to overflow the ingest frame buffer — heap corruption)."""
    cap = cfg.n_microphones // (cfg.rows * cfg.columns)
    n = args.arrays if args.arrays else min(cfg.active_arrays, cap)
    if not 1 <= n <= cap:
        raise SystemExit(
            f"--arrays {n} exceeds this config's capacity ({cap} array(s) "
            f"of {cfg.rows}x{cfg.columns} in {cfg.n_microphones} mics)")
    return n


def _make_pipeline(args, audio_sink="null", audio_path=None,
                   ring_frames: int = 64) -> Pipeline:
    cfg = {"default": Config, "reference": Config.reference,
           "fft": Config.fft_reference,
           "tiny": Config.tiny}[getattr(args, "preset", "default")]()
    if args.port:
        cfg = cfg.replace(udp_port=args.port)
    power_fn = None
    algorithm = args.algorithm
    if algorithm in ("fft", "mvdr") and getattr(args, "equiv", False):
        raise SystemExit(
            f"--equiv reformulates the TIME-domain "
            f"algorithms (pad/lerp/convolve/hybrid/truncated); "
            f"--algorithm {algorithm} computes power its own way and "
            f"the flag would be ignored")
    if algorithm == "fft":
        from ..ops import freq
        tables = freq.make_freq_tables(cfg)
        power_fn = lambda f: freq.fft_steered_power(f, tables)
        algorithm = "lerp"          # miso still needs time-domain tables
    elif algorithm == "mvdr":
        # streaming-inverse (RLS) MVDR.  Batched calls (the full-rate
        # stage) use the subspace-recursive scan: EXACT per-frame Capon
        # maps + one rank-B Woodbury state update per batch; single-frame
        # calls (the live loop) use the per-frame recursion.  The shared
        # state machine (pipeline.make_mvdr_stream) owns the d0 carry
        # and the alpha-aware refresh cadence; BENCHMARKS.md "Frequency
        # domain" has the current rates.
        power_fn = make_mvdr_stream(cfg, "maps")
        algorithm = "lerp"
    return Pipeline(cfg, algorithm=algorithm, replay_mode=args.replay,
                    backend=args.backend, audio_sink=audio_sink,
                    audio_path=audio_path, power_fn=power_fn,
                    ring_frames=ring_frames,
                    power_backend=("freq_equiv"
                                   if getattr(args, "equiv", False)
                                   else "auto"))


def cmd_mimo(args):
    """Heatmap demo (``main.pyx:669-736``): heatmaps + optional camera/YOLO
    overlay in a viewer window, or stats when headless."""
    p = _make_pipeline(args)
    p.connect()
    p.start_heatmap()
    try:
        if args.headless:
            n = 0
            while not args.frames or n < args.frames:
                power, seq = p.q_power.get(timeout=10.0)
                n += 1
                if n % 10 == 1:
                    x, y = np.unravel_index(power.argmax(), power.shape)
                    print(f"heatmap #{n} seq={seq} peak=({x},{y}) "
                          f"max={power.max():.3e}")
            print("metrics:", p.report())
        else:
            _viewer_loop(p, args)
    finally:
        p.stop()


def _viewer_loop(p: Pipeline, args):
    import cv2

    from ..utils import viz, imaging
    win = "zybo-rt-tpu mimo"
    prev = None
    n = 0
    mouse_set = False
    while not args.frames or n < args.frames:
        power, seq = p.q_power.get(timeout=10.0)
        heat, should = viz.calculate_heatmap(power, threshold=0,
                                             window=(720, 480))
        if prev is not None:
            heat = imaging.add_weighted(prev, 0.5, heat, 0.5)
        prev = heat
        cv2.imshow(win, heat)
        if not mouse_set:
            # click-to-steer, mirroring visual.py:375-386 (vertical,
            # 1-horizontal inversion included)
            def on_mouse(event, x, y, flags, params):
                if event == cv2.EVENT_LBUTTONDOWN:
                    d = p.steer_click(y / 480.0, 1.0 - x / 720.0)
                    print(f"steer -> grid cell {d}")
            cv2.setMouseCallback(win, on_mouse)
            mouse_set = True
        if cv2.waitKey(1) == 27:
            break
        n += 1


def cmd_miso(args):
    """Steered-listening demo (``main.pyx:824-864``): beam -> audio sink,
    steerable from the CLI.  ``--fullrate`` switches from the reference's
    latest-frame sampling to the gapless batched stage (every frame
    beamed, sample-count-exact output); ``--beam mvdr`` makes it
    adaptive (streaming-MVDR distortionless weights)."""
    sink = args.audio or ("auto" if not args.headless else "wav")
    p = _make_pipeline(args, audio_sink=sink, audio_path=args.out,
                       ring_frames=max(64, 4 * args.batch))
    stage = None
    try:
        # inside the try: a connect/bring-up failure must still tear the
        # pipeline down (leaked receiver/stage threads keep the process
        # alive after the traceback)
        if args.fullrate or args.beam == "mvdr":
            stage = p.make_miso_batched(batch=args.batch, beam=args.beam)
            stage.warmup()
            if getattr(stage.beam_fn, "reset", None):
                stage.beam_fn.reset()
            p.connect()
            p.run_stage(stage)
        else:
            p.connect()
            p.start_miso()
        p.steer_cartesian_degree(args.azimuth, args.elevation)
        t0 = time.time()
        while time.time() - t0 < args.seconds:
            time.sleep(0.2)
        print("metrics:", p.report())
    finally:
        p.stop()
    if stage is not None:
        line = p.cfg.sample_rate
        elapsed = time.time() - t0
        print(f"beamed {stage.processed} frames -> {stage.samples} samples "
              f"({stage.samples / elapsed:.0f}/s vs line {line:.0f}/s); "
              f"underrun frames = {stage.underrun_frames}")
        print("GAPLESS" if stage.underrun_frames == 0 else "UNDERRUNS")
        lat = stage.audio_latency()
        if lat:
            print(f"audio e2e latency (ring->sink) p50 = "
                  f"{lat['audio_e2e_p50_ms']} ms  p95 = "
                  f"{lat['audio_e2e_p95_ms']} ms at K={args.batch}")
        if hasattr(stage.sink, "underflow_samples"):
            print(f"mock playback underflow: "
                  f"{stage.sink.underflow_samples} samples "
                  f"({stage.sink.underflow_ms:.1f} ms)")
    if sink == "wav":
        print(f"beam audio written to {args.out}")


def cmd_record(args):
    """.npy capture (``PC/record.py``)."""
    from ..utils import recording
    p = _make_pipeline(args)
    p.connect()
    try:
        path = recording.record_npy(p.receiver, args.seconds, args.out)
        data = np.load(path)
        print(f"recorded {data.shape} float32 -> {path}")
    finally:
        p.stop()


def cmd_emulate(args):
    """Software FPGA (``udp/streamer.c`` parity): stream synthetic signal
    or an .npy capture to loopback forever.

    Default engine is the NATIVE chunk-paced streamer
    (``ingest/native/ingest.cpp``): a few percent of a core at the true
    48,828 pkt/s line rate, where the Python packet loop takes most of
    one and starves the realtime pipeline threads it feeds.  ``--python``
    keeps the loop-for-loop reference-parity generator.

    The emulator is numpy + ctypes only: it pins JAX to the CPU first so
    it never opens the accelerator the consumer process owns."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    cfg = Config()
    if args.port:
        cfg = cfg.replace(udp_port=args.port)
    n_arrays = _resolve_arrays(args, cfg)
    rate = None if args.fast else cfg.sample_rate
    if args.npy:
        sig = np.load(args.npy).astype(np.float32)
    else:
        t = np.arange(cfg.n_samples * 64) / cfg.sample_rate
        sig = np.tile(np.sin(2 * np.pi * args.freq * t).astype(np.float32),
                      (cfg.n_microphones, 1)) * 0.1
    use_python = args.python or args.once   # native streams cyclically
    engine = "python" if use_python else "native"
    print(f"emulating {n_arrays} array(s) on "
          f"{cfg.udp_replay_ip}:{cfg.udp_port} "
          f"({'max rate' if args.fast else 'real-time'}, {engine})")
    if not use_python:
        from ..ingest.streamer import NativeStreamer
        emu = NativeStreamer(cfg, n_arrays=n_arrays)
        emu.start(sig, rate=0.0 if args.fast else cfg.sample_rate)
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            print(f"sent {emu.stop()} packets")
        return
    from ..ingest.streamer import Streamer
    s = Streamer(cfg, n_arrays=n_arrays)
    s.send_header()
    try:
        while True:
            s.send_signal(sig, rate)
            if args.once:
                break
    except KeyboardInterrupt:
        pass
    finally:
        s.close()


def cmd_fullrate(args):
    """Full-line-rate proof: emulator at the true packet rate (48,828
    pkt/s for the reference config) -> native ingest -> batched device
    beamforming of EVERY frame; prints per-stage accounting.  The pass
    criterion is skipped == 0 (no frame overwritten unread) and ingest
    gaps == 0 for the whole run — the SURVEY §7 hard part (b)
    done-condition.

    Order matters: the jit compile happens BEFORE the first packet flows;
    the emulator is the native C++ streamer (a few %% of a core); and only
    the connected channel rows cross to the device (the tail rows are
    never written).
    """
    from ..ingest.streamer import NativeStreamer

    p = _make_pipeline(args, ring_frames=max(64, 4 * args.batch))
    # the emulator MUST use the pipeline's config (it honors --preset /
    # --port): a mismatched packet layout would make every datagram
    # invalid for the receiver
    cfg = p.cfg
    n_arrays = _resolve_arrays(args, cfg)
    n_ch = n_arrays * cfg.rows * cfg.columns
    stats = {"batches": 0}

    def sink(powers, first_seq):
        stats["batches"] += 1

    line_rate = cfg.sample_rate / cfg.n_samples
    print(f"line rate {line_rate:.1f} frames/s "
          f"({cfg.sample_rate:.0f} pkt/s); batch={args.batch}; "
          f"channels={n_ch}; running {args.seconds:.0f}s ...")
    audio_stage = None
    if args.audio and args.audio_only:
        # pure listening proof: every frame beamed, gapless stream
        from ..utils import audio as audio_mod
        a_sink = audio_mod.make_sink(args.audio, cfg.sample_rate,
                                     args.audio_out)
        stage = p.make_miso_batched(batch=args.batch, beam=args.beam,
                                    channels=n_ch, sink=a_sink,
                                    transfer=args.transfer)
        audio_stage = stage
    elif args.audio:
        # imaging + listening from ONE transfer / one fused program per
        # batch (two separate stages would 2x the H2D traffic)
        from ..utils import audio as audio_mod
        a_sink = audio_mod.make_sink(args.audio, cfg.sample_rate,
                                     args.audio_out)
        stage = p.make_mimo_miso_batched(batch=args.batch, beam=args.beam,
                                         channels=n_ch, sink=a_sink,
                                         power_sink=sink,
                                         transfer=args.transfer)
        audio_stage = stage
    else:
        stage = p.make_heatmap_batched(batch=args.batch, sink=sink,
                                       channels=n_ch,
                                       transfer=args.transfer)
    t0 = time.time()
    stage.warmup()                          # compile before packets flow
    for fn in (p._power_fn, getattr(stage, "process_fn", None),
               getattr(stage, "beam_fn", None)):
        if getattr(fn, "reset", None):
            fn.reset()                      # stateful (MVDR) backends
    print(f"  device program ready in {time.time()-t0:.1f}s; "
          "starting native line-rate emulator")
    t = np.arange(cfg.n_samples * 64) / cfg.sample_rate
    sig = np.tile(np.sin(2 * np.pi * 8000.0 * t).astype(np.float32),
                  (n_ch, 1)) * 0.1
    emu = NativeStreamer(cfg, n_arrays=n_arrays)
    emu.start(sig, rate=cfg.sample_rate)
    try:
        p.connect()                        # first packet = header
        p.run_stage(stage)
        t0 = time.time()
        while time.time() - t0 < args.seconds:
            time.sleep(1.0)
            rate = stage.processed / (time.time() - t0)
            audio = ("" if audio_stage is None else
                     f" audio_frames={audio_stage.processed} "
                     f"underruns={audio_stage.underrun_frames}")
            print(f"  t={time.time()-t0:5.1f}s processed={stage.processed} "
                  f"({rate:.1f}/s) skipped={stage.skipped} "
                  f"ingest_gaps={p.receiver.native_stats.gaps}{audio}")
    finally:
        sent = emu.stop()
        elapsed = time.time() - t0
        p.stop()
    rep = p.report()
    ok = stage.skipped == 0 and p.receiver.native_stats.gaps == 0
    if audio_stage is not None:
        ok = ok and audio_stage.underrun_frames == 0
        print(f"\naudio: beamed {audio_stage.processed} frames -> "
              f"{audio_stage.samples} samples "
              f"({audio_stage.samples / elapsed:.0f}/s vs "
              f"{cfg.sample_rate:.0f}/s), underrun frames = "
              f"{audio_stage.underrun_frames} "
              f"({'GAPLESS' if audio_stage.underrun_frames == 0 else 'UNDERRUNS'})")
    print(f"\nemulator sent {sent} packets "
          f"({sent / elapsed:.0f}/s vs line {cfg.sample_rate:.0f}/s)")
    print(f"processed {stage.processed} frames in {elapsed:.1f}s "
          f"({stage.processed / elapsed:.1f}/s vs line rate "
          f"{line_rate:.1f}/s)")
    print(f"skipped (ring overwrites) = {stage.skipped}; "
          f"ingest packet gaps = {p.receiver.native_stats.gaps}")
    key = stage.metric.name
    print("batch latency p50 =",
          rep[key]["latency_p50_ms"], "ms  p95 =",
          rep[key]["latency_p95_ms"], "ms")
    print("metrics:", rep)
    print("FULL RATE SUSTAINED" if ok else "DROPS DETECTED")
    return 0 if ok else 1


def cmd_sensorfusion(args):
    """Fused live demo (``main.pyx:669-736`` mimo + ``record_sensorfusion``):
    camera -> YOLO tracker, receiver -> heatmap, fused by the decider; the
    composited frames go to an mp4 (and a window unless --headless).

    ``--composite fused`` (the default) folds the WHOLE display cycle —
    steered power, YOLO forward, and the display chain (log-norm,
    jet-LUT colorize, resizes, power box, EMA, decider gating/blends) —
    into ONE packed device program per K-frame batch (one packed upload
    and one packed download, ``apps.fused.FusedSensorStage``); ``--listen time|mvdr``
    additionally emits the gapless steered-listening beam in the same
    packed download.  ``--composite device`` runs just the display
    chain as one batched device program
    (``fusion.composite.DeviceCompositor``) with separate heatmap /
    tracker stages; ``--composite host`` keeps the reference-shaped
    host chain (``utils.viz.Viewer`` + ``SensorFusionDecider``) for
    comparison."""
    from ..models.detect import YoloDetector
    from ..models.yolo import YoloConfig
    from ..utils.viz import ArrayDisplay, Viewer
    from .web import SyntheticCamera

    device_comp = args.composite == "device"
    fused_comp = args.composite == "fused"
    # embedded listening reads counter-contiguous mic batches of
    # mic_batch (default 4x the composite batch): the ring must hold a
    # few cycles' worth or read_batch rejects the batch size outright
    mic_batch = (args.mic_batch or 4 * args.composite_batch) \
        if (fused_comp and args.listen != "off") else 0
    p = _make_pipeline(args, ring_frames=max(64, 4 * mic_batch))
    p.connect()
    if fused_comp:
        # the fused stage owns the heatmap path.  The default q_yolo
        # holds 2 frames (drop-oldest backpressure for the single-frame
        # loops); the fused stage batches K camera frames per cycle, so
        # deepen it BEFORE start_camera captures the reference.
        import queue as _queue
        p.q_yolo = _queue.Queue(maxsize=2 * args.composite_batch)
    elif args.heatmap_batch > 1:
        # full-rate heatmap stage publishing EVERY map to the display
        # queue (drop-oldest keeps the viewer fed at its own pace) —
        # the single-frame stage caps the fused rate at one dispatch
        # round trip per map
        def all_maps_sink(powers, first_seq, _p=p):
            from .pipeline import put_drop_oldest
            for j, pw in enumerate(powers):
                put_drop_oldest(_p.q_power, (pw, first_seq + j))

        p.start_heatmap_batched(batch=args.heatmap_batch,
                                sink=all_maps_sink,
                                max_rate=args.heatmap_rate)
    else:
        p.start_heatmap()
    if args.camera == -2:
        # detectable scene: moving synthetic-task object — with the
        # pretrained detector the fused chain runs on REAL detections
        # (YOLO -> SORT -> decider -> focus_beam steering)
        from ..models.data import SceneCamera
        # one full Lissajous cycle pre-rendered: read() is a list index,
        # so the camera thread stops painting frames on the host
        cam = SceneCamera((240, 320), prerender=1260)
    elif args.camera < 0:
        cam = SyntheticCamera((240, 320))
    else:
        from ..utils.viz import _CvCapture
        cam = _CvCapture(args.camera)
    p.start_camera(cam, fps_limit=args.camera_fps)
    if args.pretrain or (args.camera == -2 and not args.weights):
        from ..models.train import pretrained_demo_detector
        det = pretrained_demo_detector(steps=args.pretrain or 700)
    else:
        det = YoloDetector(model_path=args.weights,
                           cfg=YoloConfig(input_size=args.detector_size,
                                          width_mult=args.detector_width,
                                          num_classes=args.detector_classes))
    tkw = (dict(max_age=args.track_coast, report_coasted=True)
           if getattr(args, "track_coast", 0) else {})
    if not fused_comp:            # the fused stage owns detect + track
        tkw["emit_boxes"] = device_comp
        if args.tracker_batch > 1:
            # one YOLO device launch per K camera frames (the
            # single-frame loop pays a dispatch round trip per frame)
            p.start_tracker_batched(det, batch=args.tracker_batch, **tkw)
        else:
            p.start_tracker(det, **tkw)

    frames_wanted = args.frames or 30
    disp = ArrayDisplay(keep=frames_wanted)
    cam_hw = getattr(cam, "size", None)
    if cam_hw is None:            # real capture: probe one frame
        ok, probe = cam.read()
        cam_hw = probe.shape[:2] if ok else (240, 320)
    grid = (p.cfg.max_res_x, p.cfg.max_res_y)
    if fused_comp:
        from ..fusion.composite import DeviceCompositor
        from .fused import FusedSensorStage
        compositor = DeviceCompositor(
            grid, cam_hw, window=(args.width, args.height),
            yolo_shape=cam_hw, max_tracks=8)
        # only the connected channel rows cross to the device (the tail
        # rows are never written) — same policy as demo fullrate
        n_ch = (p.receiver.n_arrays
                or p.cfg.active_arrays) * p.cfg.rows * p.cfg.columns
        listen = None if args.listen == "off" else args.listen
        a_sink = None
        if listen:
            from ..utils import audio as audio_mod
            a_sink = audio_mod.make_sink(args.audio or "mock",
                                         p.cfg.sample_rate,
                                         args.audio_out)
        stage = FusedSensorStage(
            p.receiver, p.tables, compositor, det, p.q_yolo, disp,
            p.metrics, batch=args.composite_batch,
            channels=min(n_ch, p.cfg.n_microphones),
            transfer=args.transfer,
            display_transport=args.display_transport,
            steer_cb=lambda h, v: p.steer_cartesian_degree(h, v),
            tracker_kwargs=tkw or None,
            listen=listen, audio_sink=a_sink,
            mic_batch=args.mic_batch)
        if listen:
            # click/focus_beam steering reaches the embedded beam
            p._miso = stage
        print("compiling fused sensor stage ...")
        t0 = time.time()
        stage.warmup()
        print(f"  ready in {time.time()-t0:.1f}s")
        t0 = time.time()
        p.run_stage(stage)
        deadline = time.time() + max(60.0, frames_wanted * 5.0)
        while stage.frames < frames_wanted and time.time() < deadline:
            time.sleep(0.1)
        fused_elapsed = time.time() - t0
        p.stop()
        print(f"fused rate: {stage.frames / fused_elapsed:.1f} fps over "
              f"{stage.frames} composited frames ({fused_elapsed:.1f}s)")
        print("composite:", stage.report())
        if args.out:
            import cv2
            h, w = disp.frames[0].shape[:2]
            vw = cv2.VideoWriter(args.out,
                                 cv2.VideoWriter_fourcc(*"mp4v"),
                                 15, (w, h))
            for f in disp.frames:
                vw.write(f)
            vw.release()
            print(f"wrote {len(disp.frames)} fused frames -> {args.out}")
        print("metrics:", p.report())
        return
    if device_comp:
        from ..fusion.composite import DeviceCompositor, DeviceViewer
        compositor = DeviceCompositor(
            grid, cam_hw, window=(args.width, args.height),
            yolo_shape=cam_hw, max_tracks=8)
        viewer = DeviceViewer(compositor, disp,
                              batch=args.composite_batch)
        print("compiling device compositor ...")
        t0 = time.time()
        viewer.warmup()
        print(f"  ready in {time.time()-t0:.1f}s")
    else:
        viewer = Viewer(cb=lambda h, v: p.steer_cartesian_degree(h, v),
                        window=(args.width, args.height), display=disp)

    class Running:
        # wall-clock deadline, not a constant: if a producer thread dies
        # (detector exception, receiver timeout) the queues stop filling
        # and a constant-1 flag would hang the demo forever instead of
        # stopping and reporting what it composited
        deadline = time.time() + max(60.0, frames_wanted * 5.0)

        @property
        def value(self):
            return time.time() < self.deadline

    t0 = time.time()
    viewer.loop(p.q_power, Running(), q_viewer=p.q_viewer,
                q_inference=p.q_inference, max_frames=frames_wanted)
    fused_elapsed = time.time() - t0
    p.stop()
    print(f"fused rate: {len(disp.frames) and frames_wanted / fused_elapsed:.1f} "
          f"fps over {frames_wanted} composited frames "
          f"({fused_elapsed:.1f}s)")
    if device_comp:
        print("composite:", viewer.report())
    if args.out:
        import cv2
        h, w = disp.frames[0].shape[:2]
        vw = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"),
                             15, (w, h))
        for f in disp.frames:
            vw.write(f)
        vw.release()
        print(f"wrote {len(disp.frames)} fused frames -> {args.out}")
    print("metrics:", p.report())


def cmd_web(args):
    from .web import serve
    serve(replay=args.replay, port=args.http_port, udp_port=args.port,
          headless_camera=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zybo-rt-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mimo", help="steered-power heatmap demo")
    _add_common(p)
    p.set_defaults(fn=cmd_mimo)

    p = sub.add_parser("miso", help="steered listening demo")
    _add_common(p)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--audio", default=None,
                   choices=["wav", "null", "sounddevice", "auto", "mock"],
                   help="audio sink (default: auto = live playback when "
                        "interactive, wav when --headless; mock = "
                        "deadline-accounting PortAudio stand-in)")
    p.add_argument("--out", default="miso.wav")
    p.add_argument("--fullrate", action="store_true",
                   help="gapless batched listening: every frame beamed, "
                        "sample-count-exact stream (vs the reference's "
                        "latest-frame sampling)")
    p.add_argument("--beam", default="time", choices=["time", "mvdr"],
                   help="beam backend: delay-and-sum or adaptive MVDR "
                        "(implies --fullrate)")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per device launch in --fullrate mode")
    p.set_defaults(fn=cmd_miso)

    p = sub.add_parser("record", help="raw .npy capture")
    _add_common(p)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="recording.npy")
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("emulate", help="software FPGA packet streamer")
    p.add_argument("--npy", default=None)
    p.add_argument("--freq", type=float, default=8000.0)
    p.add_argument("--arrays", type=int, default=None,
                   help="default: the config's active_arrays")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--once", action="store_true")
    p.add_argument("--python", action="store_true",
                   help="the loop-for-loop Python generator (reference "
                        "parity; most of a core at line rate — the "
                        "native default is a few %%)")
    p.add_argument("--port", type=int, default=None)
    p.set_defaults(fn=cmd_emulate)

    p = sub.add_parser("fullrate",
                       help="line-rate emulator -> batched beamforming of "
                            "every frame; pass = zero drops")
    _add_common(p)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--arrays", type=int, default=None,
                   help="default: the config's active_arrays")
    p.add_argument("--audio", default=None,
                   choices=["null", "wav", "mock"],
                   help="also run the gapless listening stage into this "
                        "sink (pass now requires 0 audio underruns; mock "
                        "= deadline-accounting PortAudio stand-in)")
    p.add_argument("--audio-only", action="store_true",
                   help="with --audio: listening only, no heatmaps (the "
                        "pure gapless-WAV proof)")
    p.add_argument("--audio-out", default="fullrate_miso.wav")
    p.add_argument("--beam", default="time", choices=["time", "mvdr"],
                   help="audio beam backend (delay-and-sum or adaptive "
                        "MVDR)")
    p.add_argument("--transfer", default="f32", choices=["f32", "f16"],
                   help="host->device sample dtype: f16 halves the "
                        "traffic at ~1e-3 relative error (display-grade "
                        "opt-in for bandwidth-bound hosts)")
    p.set_defaults(fn=cmd_fullrate, replay=True)

    p = sub.add_parser("sensorfusion",
                       help="fused camera+YOLO+heatmap demo -> mp4")
    _add_common(p)
    p.add_argument("--camera", type=int, default=-1,
                   help="camera index (-1 = synthetic gradients, -2 = "
                        "detectable moving-object scene)")
    p.add_argument("--pretrain", type=int, default=0,
                   help="train the demo detector N steps on the "
                        "synthetic task first (cached; implied 700 for "
                        "--camera -2 without --weights)")
    p.add_argument("--tracker-batch", type=int, default=4,
                   help="camera frames per YOLO device launch (1 = the "
                        "single-frame reference-parity loop)")
    p.add_argument("--track-coast", type=int, default=0,
                   help="report Kalman-predicted boxes for tracks missed "
                        "up to N frames (0 = reference matched-only "
                        "reporting; 3 measured MOTA 0.688 -> 0.975 at "
                        "15%% hard detector dropouts)")
    p.add_argument("--heatmap-batch", type=int, default=16,
                   help="frames per heatmap device launch, all maps "
                        "published (1 = single-frame reference loop)")
    p.add_argument("--composite", default="fused",
                   choices=["fused", "device", "host"],
                   help="display-chain backend: 'fused' (default) = the "
                        "whole cycle (steered power + YOLO + composite) "
                        "as ONE device program with one packed upload + "
                        "one packed download per batch; "
                        "'device' = separate batched stages with the "
                        "compositor on the device; 'host' = the "
                        "reference-shaped cv2 chain (Viewer + "
                        "SensorFusionDecider)")
    p.add_argument("--composite-batch", type=int, default=16,
                   help="frames per device composite launch")
    p.add_argument("--listen", default="off",
                   choices=["off", "time", "mvdr"],
                   help="--composite fused: fold gapless steered "
                        "LISTENING into the same packed program — the "
                        "beam rides the packed download, the loop flips "
                        "to counter-contiguous mic batches (the whole "
                        "combined product in one packed program)")
    p.add_argument("--audio", default=None,
                   help="audio sink for --listen (null|wav|sounddevice|"
                        "mock; default mock = deadline-counting playback "
                        "device)")
    p.add_argument("--audio-out", default="sensorfusion_miso.wav")
    p.add_argument("--mic-batch", type=int, default=0,
                   help="mic frames per fused cycle for --listen "
                        "(0 = 4x composite batch)")
    p.add_argument("--heatmap-rate", type=float, default=100.0,
                   help="cap the batched heatmap stage at N maps/s (0 = "
                        "line rate); display needs ~2x viewer fps and an "
                        "uncapped stage starves the shared device link")
    p.add_argument("--camera-fps", type=float, default=60.0,
                   help="camera frame-rate cap (lower frees host CPU on "
                        "contended machines)")
    p.add_argument("--weights", default=None, help="detector weights (.pkl)")
    p.add_argument("--detector-classes", type=int, default=1,
                   help="detector class count (--weights from "
                        "train_reference_recipe are 3-class)")
    p.add_argument("--detector-size", type=int, default=224,
                   help="detector input size (px)")
    p.add_argument("--detector-width", type=float, default=0.5,
                   help="detector width multiplier")
    p.add_argument("--transfer", default="f32", choices=["f32", "f16"],
                   help="mic-sample upload dtype for --composite fused: "
                        "f16 halves that leg of the traffic at "
                        "~1e-3 relative error (display-grade opt-in)")
    p.add_argument("--display-transport", default="yuv420",
                   choices=["yuv420", "rgb"],
                   help="video transport for --composite fused (camera "
                        "upload AND composite download): yuv420 "
                        "(default) halves both legs — chroma is "
                        "2x2-subsampled exactly like the 4:2:0 mp4 the "
                        "demo writes, so the recorded output loses "
                        "nothing; rgb keeps byte-exact pixels")
    p.add_argument("--out", default="sensorfusion.mp4")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.set_defaults(fn=cmd_sensorfusion)

    p = sub.add_parser("web", help="MJPEG web app")
    _add_common(p)
    p.add_argument("--http-port", type=int, default=8000)
    p.set_defaults(fn=cmd_web)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
