#!/usr/bin/env python
"""Benchmark ladder: steered-power heatmaps/second and the rungs around it.

The headline is the ``high``-tier production heatmap program at the
64 ch x 65x65 shape (lerp delay-and-sum — the reference's default
quality/speed point) with device-resident frame batches, i.e. the
steady state the double-buffered ingest feeds.  Every rung is timed with
``block_until_ready``.  Refuses to run without an accelerator unless
``--smoke``.

Prints the device and card on stderr, and exactly one JSON line on stdout:
    {"metric": ..., "value": N, "unit": ..., "device": {...}, "ladder": ...}
"""

import json
import sys
import time

import numpy as np


def main(smoke: bool = False) -> None:
    """``smoke=True`` (CLI ``--smoke``): run every rung once on tiny
    shapes on the CPU backend — validates the script end-to-end (API
    drift, name errors) without an accelerator; the numbers are
    meaningless."""
    import jax

    if smoke:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if not smoke and dev.platform == "cpu":
        sys.exit("bench.py: no accelerator found (use --smoke for a CPU "
                 "dry run)")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    import zybo_rt_sampler_image_detection_tpu as zrt
    from zybo_rt_sampler_image_detection_tpu.utils.profiling import card

    print(f"# device {device}; card: {card() if not smoke else 'n/a'}",
          file=sys.stderr, flush=True)
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import (
        default_power_fn,
    )
    from zybo_rt_sampler_image_detection_tpu.ops import beamform

    B = 8 if smoke else 512
    R = 1 if smoke else 3
    cfg0 = zrt.Config.tiny() if smoke else zrt.Config.northstar()
    rng = np.random.default_rng(0)
    frames_dev = jax.device_put(rng.standard_normal(
        (B, cfg0.n_microphones, cfg0.n_samples)).astype(np.float32))

    spreads = {}

    def _steal_ticks():
        try:
            with open("/proc/stat") as f:
                return int(f.readline().split()[8])
        except (OSError, IndexError, ValueError):
            return 0

    # a rung whose repeats spread more than this is re-measured once and
    # the better-spread set kept (a contended window otherwise publishes
    # a noisy median)
    SPREAD_BAR = 0.05

    def _pick_rates(measure, key):
        """``measure() -> sorted rates``; re-run once if the spread
        exceeds SPREAD_BAR (contended window), keep the tighter set."""
        rates = measure()
        med = rates[len(rates) // 2]
        spread = (rates[-1] - rates[0]) / med if med else 0.0
        if spread > SPREAD_BAR and not smoke:
            r2 = measure()
            m2 = r2[len(r2) // 2]
            s2 = (r2[-1] - r2[0]) / m2 if m2 else 0.0
            if s2 < spread:
                rates, med, spread = r2, m2, s2
        if key is not None:
            spreads[key] = round(spread, 3)
        return med

    def timed_batched(fn, frames, nb, n_iter, key=None, repeats=None):
        """Median rate over ``repeats`` runs (+ relative spread recorded in
        ``spreads`` — a wide spread flags host contention, which a
        single-shot number cannot distinguish from a regression; rungs
        spreading > SPREAD_BAR re-run once, tighter set kept)."""
        repeats = R if repeats is None else repeats
        jax.block_until_ready(fn(frames))            # compile + warm

        def measure():
            rates = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                out = None
                for _ in range(n_iter):
                    out = fn(frames)
                jax.block_until_ready(out)
                rates.append((nb * n_iter) / (time.perf_counter() - t0))
            rates.sort()
            return rates

        return _pick_rates(measure, key)

    def timed(fn, n_iter=12, key=None):
        return timed_batched(fn, frames_dev, B, 1 if smoke else n_iter,
                             key=key)

    steal0 = _steal_ticks()

    class _Ladder(dict):
        """Streams each rung to stderr as it completes, so a run cut
        short still leaves partial evidence."""

        def __setitem__(self, k, v):
            super().__setitem__(k, v)
            print(f"# rung {k}: {v:.1f}", file=sys.stderr, flush=True)

    ladder = _Ladder()
    # Per-map FLOP models (2 FLOP/MAC, dominant contractions only).
    # Time-domain: the (D, T*M) @ (T*M, B*N) beam matmul.  Equiv:
    # DFT-by-matmul (4*M*N*F) + the stacked K=2M plane contraction
    # (8*D*M*F); head/tail corrections are <1% and omitted.
    flops_per_map = {}

    def _td_flops(tables, n_samples):
        D, T, M = tables.W.shape
        return 2.0 * D * T * M * n_samples

    def _equiv_flops(et, n_samples):
        D, M2, F = et.Hs1.shape
        return 2.0 * M2 * n_samples * F + 4.0 * D * M2 * F

    from zybo_rt_sampler_image_detection_tpu.ops import freq_equiv

    # per precision tier (config.TIERS): the time-domain path, the
    # frequency-domain path, and — unsuffixed — the production program
    # (apps.pipeline.default_power_fn) at that tier.
    from zybo_rt_sampler_image_detection_tpu.config import TIERS

    for name, kw in TIERS.items():
        cfg = cfg0.replace(**kw)
        tables = beamform.make_tables(cfg, "lerp", cache=False)
        # NO jit(lambda ... t=tables) wrapper: a default argument lowers
        # as a baked constant; steered_power is already jitted with the
        # tables as pytree ARGUMENTS.
        ladder[f"{name}_xla"] = timed(
            lambda f: beamform.steered_power(f, tables), key=f"{name}_xla")
        flops_per_map[f"{name}_xla"] = _td_flops(tables, cfg.n_samples)
        if name != "highest":
            et = freq_equiv.make_equiv_tables(tables)
            ladder[f"{name}_equiv_exact"] = timed(
                lambda f: freq_equiv.equiv_steered_power(f, et),
                key=f"{name}_equiv_exact")
            flops_per_map[f"{name}_equiv_exact"] = _equiv_flops(
                et, cfg.n_samples)
            del et
        ladder[name] = timed(default_power_fn(tables), key=name)

    # -- per-algorithm rows: every beamformer's production program at
    # "high", the reference shape, the FFT backend, and real-time (RLS)
    # MVDR ----------------------------------------------------------------
    cfg_hi = cfg0.replace(matmul_precision="high")
    for algo in ("pad", "truncated", "convolve", "hybrid"):
        tables = beamform.make_tables(cfg_hi, algo, cache=True)
        ladder[algo] = timed(default_power_fn(tables))

    # the reference config shape: 57x32 grid, 256 channels, 3 arrays
    ref_cfg = (zrt.Config.tiny() if smoke else zrt.Config()).replace(
        matmul_precision="high")
    B_ref = 8 if smoke else 256
    frames_ref = jax.device_put(rng.standard_normal(
        (B_ref, ref_cfg.n_microphones, ref_cfg.n_samples)).astype(np.float32))
    t_ref = beamform.make_tables(ref_cfg, "lerp", cache=True)

    def timed_ref(fn, n_iter=8, key=None):
        return timed_batched(fn, frames_ref, B_ref, 1 if smoke else n_iter,
                             key=key)

    # NOTE: steered_power/fft_steered_power are already jitted with the
    # tables as pytree ARGUMENTS — wrapping them in another jit(lambda)
    # would bake the ~100 MB reference tables into the program.
    flops_per_map["lerp_reference_shape_57x32_256ch"] = \
        _td_flops(t_ref, ref_cfg.n_samples)
    ladder["lerp_reference_shape_57x32_256ch"] = timed_ref(
        lambda f: beamform.steered_power(f, t_ref),
        key="lerp_reference_shape_57x32_256ch")

    # EXACT frequency-domain reformulation (ops/freq_equiv): same output
    # as the time-domain lerp to f32 rounding, no T axis in the per-frame
    # contraction
    et_ref = freq_equiv.make_equiv_tables(t_ref)
    flops_per_map["lerp_reference_shape_equiv_exact"] = \
        _equiv_flops(et_ref, ref_cfg.n_samples)
    ladder["lerp_reference_shape_equiv_exact"] = timed_ref(
        lambda f: freq_equiv.equiv_steered_power(f, et_ref),
        key="lerp_reference_shape_equiv_exact")

    from zybo_rt_sampler_image_detection_tpu.ops import freq
    ft = freq.make_freq_tables(ref_cfg, 100.0)
    ladder["fft_bartlett_reference_shape"] = timed_ref(
        lambda f: freq.fft_steered_power(f, ft))

    # real-time MVDR: per-frame Sherman-Morrison update + Capon map at the
    # reference shape (127 bins x 256 mics x 1824 directions)
    from functools import partial as _partial

    @_partial(jax.jit, static_argnames=())
    def mvdr_scan(st, frames, t):
        def step(s, fr):
            s2 = freq.update_precision(s, fr[None], t)
            return s2, freq.mvdr_power_precision(s2, t)
        return jax.lax.scan(step, st, frames)

    def timed_stateful(step_fn, st0, n_frames, iters=4, key=None,
                       repeats=None):
        repeats = R if repeats is None else repeats
        iters = 1 if smoke else iters
        st0, maps = step_fn(st0)                     # compile + warm
        jax.block_until_ready(maps)

        def measure():
            st = st0
            rates = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                for _ in range(iters):
                    st, maps = step_fn(st)
                jax.block_until_ready(maps)
                rates.append(
                    (n_frames * iters) / (time.perf_counter() - t0))
            rates.sort()
            return rates

        return _pick_rates(measure, key)

    # device-rate proxy for the LIVE (unbatched) loops: 64 sequential
    # B=1 heatmaps inside one device program (lax.scan) — the per-frame
    # device latency without the per-call dispatch.
    @jax.jit
    def _live_proxy(frames64, t):
        def step(c, fr):
            return c, beamform.steered_power(fr[None], t)[0]
        return jax.lax.scan(step, 0.0, frames64)[1]

    t_ns_hi = beamform.make_tables(cfg_hi, "lerp", cache=False)
    n64 = min(64, B)
    fr64 = jax.device_put(np.asarray(frames_dev[:n64]))
    ladder["live_loop_device_proxy_fps"] = timed_batched(
        lambda f: _live_proxy(f, t_ns_hi), fr64, n64, 1 if smoke else 4,
        key="live_loop_device_proxy_fps")

    K = 8
    fr_small = jax.device_put(np.asarray(frames_ref[:K]))
    ladder["mvdr_rls_per_frame_reference_shape"] = timed_stateful(
        lambda s: mvdr_scan(s, fr_small, ft), freq.init_precision(ft), K,
        key="mvdr_rls_per_frame_reference_shape")

    # subspace-recursive scan, PRODUCTION steady state: 16-frame blocks
    # with the a^H P a quadratic form carried between calls (re-measured
    # every d0_carry_interval frames) and the exact Cholesky refresh at
    # the alpha-aware cadence — one full 64-frame refresh epoch per
    # step_fn call, exactly the process_fn sequence in apps/pipeline.py
    Kb = 2 if smoke else 16
    fr_blks = [jax.device_put(np.asarray(frames_ref[i * Kb:(i + 1) * Kb]))
               for i in range(4)]
    carry_max = freq.d0_carry_interval()       # ~31 at alpha=0.9
    if not smoke:
        assert 16 <= carry_max < 4 * Kb        # d0 re-measured mid-epoch

    def mvdr_epoch(st):
        # the make_mvdr_stream production cadence (separate exact
        # refresh after the 4 blocks)
        maps = None
        dq, dqc = None, 0
        for blk in fr_blks:
            if dq is None or dqc >= carry_max:
                dq, dqc = freq.mvdr_d0(st, ft), 0
            maps, st, dq = freq.mvdr_maps_scan(st, blk, ft, d0=dq,
                                               return_d=True)
            dqc += Kb
        return freq.refresh_precision(st, ft), maps

    ladder["mvdr_exact_per_frame_maps_reference_shape"] = timed_stateful(
        mvdr_epoch, freq.init_precision(ft), 4 * Kb,
        key="mvdr_exact_per_frame_maps_reference_shape")

    # -- fused display cycle (apps/fused.py): steered power + YOLO detect
    # + composite as ONE packed device program.  Device-proxy rate (packed
    # input resident, non-donated jit twin, no host legs).
    ladder["fused_display_cycle_fps_device_proxy"] = \
        _fused_cycle_rung(ref_cfg, t_ref, smoke, timed_batched)

    # -- audio end-to-end: the full in-process listening
    # path — native line-rate emulator -> ingest ring -> BatchedMiso
    # (one fused device program per K-frame batch) -> deadline-counting
    # mock playback sink.  Reports the measured packet->sink p50/p95 and
    # the sustained full-rate frames/s.
    audio_stats = {}
    if not smoke:
        audio_stats = _audio_rung(zrt)
        for k, v in audio_stats.items():
            if isinstance(v, (int, float)):
                ladder[f"audio_{k}"] = float(v)

    value = ladder["high"]
    steal = _steal_ticks() - steal0
    print(f"# ladder: { {k: round(v, 1) for k, v in ladder.items()} } "
          f"(headline = production program at the high tier)",
          file=sys.stderr)
    print(f"# medians of {R} repeat(s); rel spreads: {spreads}; "
          f"host steal ticks during run: {steal}", file=sys.stderr)
    # maps/s -> achieved model TFLOP/s per rung (dominant-contraction
    # MACs x2 — see flops_per_map)
    tf = {k: round(ladder[k] * fl / 1e12, 2)
          for k, fl in flops_per_map.items() if k in ladder}
    print(f"# tflops (model): {tf}", file=sys.stderr)
    sys.stderr.flush()
    # The JSON prints LAST and carries the full ladder + per-rung spreads
    # + steal ticks machine-readably.
    print(json.dumps({
        "metric": "steered_power_heatmaps_per_sec_64ch_65x65",
        "value": round(value, 1),
        "unit": "heatmaps/s",
        "device": device,
        "ladder": {k: round(v, 1) for k, v in ladder.items()},
        "spreads": spreads,
        "steal_ticks": steal,
        "audio": audio_stats,
    }), flush=True)


def _fused_cycle_rung(ref_cfg, tables, smoke, timed_batched):
    """Device-proxy rate of the fused display cycle: the
    FusedSensorStage packed program (apps/fused.py — steered power +
    device-resize YOLO forward + DeviceCompositor) at the demo's
    operating point (240x320 camera, 640x360 window, 224 px detector,
    K=16, 3-array channel slice)."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from zybo_rt_sampler_image_detection_tpu.apps.fused import (
        FusedSensorStage,
    )
    from zybo_rt_sampler_image_detection_tpu.fusion.composite import (
        DeviceCompositor,
    )
    from zybo_rt_sampler_image_detection_tpu.models.detect import (
        YoloDetector,
    )
    from zybo_rt_sampler_image_detection_tpu.models.yolo import YoloConfig
    from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
        PipelineMetrics,
    )

    if smoke:
        K, cam_hw, window, det_size, det_width, channels = \
            2, (48, 64), (64, 48), 64, 0.25, 0
    else:
        K, cam_hw, window, det_size, det_width, channels = \
            16, (240, 320), (640, 360), 224, 0.5, 192
    grid = (ref_cfg.max_res_x, ref_cfg.max_res_y)
    det = YoloDetector(cfg=YoloConfig(input_size=det_size,
                                      width_mult=det_width))
    comp = DeviceCompositor(grid, cam_hw, window=window,
                            yolo_shape=cam_hw, max_tracks=8)
    stage = FusedSensorStage(
        SimpleNamespace(cfg=ref_cfg), tables, comp, det,
        q_cam=None, display=None, metrics=PipelineMetrics(), batch=K,
        channels=channels)
    # non-donated twin of the stage's program: the rung re-feeds the
    # same device-resident packed input every iteration
    fn = jax.jit(stage._run)
    rng = np.random.default_rng(7)
    mic = (rng.standard_normal(
        (K, stage.mc, stage.n_samples)) * 0.05).astype(np.float32)
    cams = rng.integers(0, 256, (K,) + cam_hw + (3,), dtype=np.uint8)
    packed = np.concatenate([
        mic.view(np.uint8).reshape(-1),
        cams.reshape(-1),
        stage._boxes.view(np.uint8).reshape(-1)])
    packed_dev = jax.device_put(packed)
    prev = comp.init_prev()

    def cycle(p):
        out, _, _ = fn(p, prev, None, None, jnp.int32(0), jnp.int32(1),
                       comp.tables, stage._det_tables, det.variables,
                       *stage._power_extra)
        return out

    return timed_batched(cycle, packed_dev, K, 1 if smoke else 8,
                         key="fused_display_cycle", repeats=3)


def _audio_rung(zrt, seconds: float = 8.0, batch: int = 64,
                port: int = 21899) -> dict:
    """Measured end-to-end audio latency: native line-rate emulator ->
    ingest ring (publish stamps) -> full-rate BatchedMisoProducer (one
    fused device program per batch) -> MockCallbackSink (deadline
    accounting).  Reference contract: the PortAudio callback chain of
    ``api.c:268-282,491-543``."""
    import time as _time

    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import Pipeline
    from zybo_rt_sampler_image_detection_tpu.ingest.streamer import (
        NativeStreamer,
    )
    from zybo_rt_sampler_image_detection_tpu.utils.audio import (
        MockCallbackSink,
    )

    cfg = zrt.Config().replace(udp_port=port)
    n_arrays = cfg.active_arrays
    n_ch = n_arrays * cfg.rows * cfg.columns
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend="auto",
                 audio_sink="null", ring_frames=max(64, 4 * batch))
    sink = MockCallbackSink(cfg.sample_rate)
    stage = p.make_miso_batched(batch=batch, beam="time", channels=n_ch,
                                sink=sink)
    stage.warmup()                       # compile before packets flow
    t = np.arange(cfg.n_samples * 64) / cfg.sample_rate
    sig = np.tile(np.sin(2 * np.pi * 800.0 * t).astype(np.float32),
                  (cfg.n_microphones, 1)) * 0.1
    emu = NativeStreamer(cfg, n_arrays=n_arrays)
    try:
        emu.start(sig, rate=cfg.sample_rate)
        p.connect(timeout=10.0)
        t0 = _time.time()
        p.run_stage(stage)
        _time.sleep(seconds)
        p.stop()
        elapsed = _time.time() - t0
    finally:
        emu.stop()
    stats = stage.audio_latency()
    stats["fullrate_frames_per_s"] = round(stage.processed / elapsed, 1)
    stats["underrun_frames"] = stage.underrun_frames
    stats["sink_underflow_ms"] = round(sink.underflow_ms, 1)
    return stats


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv[1:])
