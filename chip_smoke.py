#!/usr/bin/env python
"""Smoke test of the acoustic camera's main path on one GPU.

Drives the product through the entry points a user calls, at the
reference deployment (``Config()``: 256-mic array, 57x32 grid, 190.7
frames/s, lerp delay-and-sum, the FFT/MVDR band from 100 Hz), with
random data made from ``--seed``, and checks every result against the
repository's references (the float64 oracle ``ops/oracle.py`` and NumPy
complex128 models of the frequency-domain math):

1. line rate: native emulator at 48,828 pkt/s over loopback -> native
   ingest -> the full-rate ``BatchedHeatmapProducer`` ``demo fullrate``
   builds, for ``--seconds``; prints the emulator's, the ingest's and the
   stage's frames/s over one window, the ring backlog at its start and
   end, skips, ingest gaps and compile seconds, and checks captured maps
   against the oracle;
2. tiers: the production power program (``default_power_fn``) at each
   precision tier at the 64-ch/65x65 and 256-ch/57x32 shapes, at the
   line-rate stage's batch of 64 frames;
3. listening: ``BatchedMisoProducer`` with the delay-and-sum and MVDR
   beams on a point source built from the array geometry;
4. frequency domain: FFT Bartlett, the covariance update + ``mvdr_power``,
   and one production MVDR epoch (four 16-frame blocks + refresh);
5. one fused display cycle: ``FusedSensorStage`` at K=16 with the
   reference recipe detector (416 px, width 1.0, 3 classes) and embedded
   MVDR listening.

What each tier lowers to on an H100: "highest" runs full f32 products
(cuBLAS SGEMM); "high" runs the f32 operands as TF32 on the tensor cores;
"bf16" keeps bf16 steering tables — bf16 products on the time-domain
path, TF32 planes built from the bf16 taps on the frequency-domain path.

The frequency-domain references take their steering vectors from the mic
geometry (``steering``), not from the program's tables, so a wrong sign,
phase reference or grid layout in the tables fails them.

Refuses to run (exit 2, no result) unless JAX's first device is a GPU.
Every phase runs; any failure exits 1.  The last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

    python chip_smoke.py [--seed 0] [--seconds 30]
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import time
import traceback

import numpy as np

# max |got - ref| / max |ref| per heatmap tier, against the float64 oracle
# (H100 measurements in PERF.md; the exact tier keeps the f32 bound)
TIER_TOL = {"highest": 1e-5, "high": 1e-3, "bf16": 1e-2}
BEAM_TOL = 1e-5          # delay-and-sum beam: exact f32 products
BARTLETT_TOL = 1e-5      # f32 DFT + steering at HIGHEST vs complex128
# MVDR beams and maps: f32 streaming inverse (Woodbury updates, unrolled
# refresh) and, in the production epoch, TF32 quadratic forms
MVDR_TOL = 1e-3
# least correlation of the MVDR listening beam with the oracle's
# delay-and-sum beam on a point source at the steered cell, per covariance
# memory alpha (phase_listening says why the default memory reads low)
MVDR_DAS_CORR = {0.9: 0.45, 0.99: 0.95}
BAND_LOW = 100.0         # the production MVDR band's lower edge, Hz
SOURCE_F_MAX = 8000.0    # listening source bandwidth, Hz
# device composite vs the host Viewer chain (tests/test_composite.py):
# cv2/NumPy fixed-point rounding accumulates a few counts over 3 layers
COMP_MAX_ABS, COMP_MEAN_ABS, COMP_FRAC_GT2 = 5, 0.6, 0.02


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    check(got.shape == ref.shape, f"shape {got.shape} != {ref.shape}")
    check(bool(np.isfinite(got).all()), "non-finite output")
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def wire(x: np.ndarray, cfg) -> np.ndarray:
    """The 24-bit wire quantization the emulator applies."""
    return (np.round(x.astype(np.float64) * cfg.norm_factor)
            / cfg.norm_factor).astype(np.float32)


def oracle_maps(cfg, frames) -> np.ndarray:
    """float64 lerp delay-and-sum heatmaps, one C-loop transcription per
    frame (``ops.oracle.mimo_lerp``)."""
    from zybo_rt_sampler_image_detection_tpu.ops import geometry, oracle

    active, _ = geometry.active_microphones(cfg)
    whole, frac = geometry.lerp_coefficients(cfg)
    return np.stack([oracle.mimo_lerp(np.asarray(f, np.float64), whole,
                                      frac, active) for f in frames])


def band(cfg, ft=None) -> tuple:
    """rfft bins [lo, hi) of the MVDR band: ``BAND_LOW`` up to (not
    including) Nyquist; checks the program's tables agree."""
    lo = int(round(BAND_LOW * cfg.n_samples / cfg.sample_rate))
    hi = cfg.n_samples // 2
    if ft is not None:
        check((ft.lo, ft.hi) == (lo, hi),
              f"tables band {(ft.lo, ft.hi)} != {(lo, hi)}")
    return lo, hi


def spectra(cfg, frames, lo: int, hi: int) -> np.ndarray:
    """complex128 band spectra (B, F, M) of the active mics."""
    from zybo_rt_sampler_image_detection_tpu.ops import geometry

    active, _ = geometry.active_microphones(cfg)
    x = np.asarray(frames, np.float64)[:, active]
    return np.fft.rfft(x, axis=-1)[..., lo:hi].transpose(0, 2, 1)


def arrival(cfg) -> np.ndarray:
    """(M, D) samples by which a plane wavefront from each grid cell of
    the scanning window reaches each active mic before the array centre:
    ``fs (x xm + y ym) / (c r)``, cells flattened as ``x * res_y + y``."""
    from zybo_rt_sampler_image_detection_tpu.ops import geometry

    rp = geometry.r_prime(cfg)
    xm = cfg.z_scan * np.tan(np.deg2rad(cfg.view_angle / 2))
    ym = xm / cfg.aspect_ratio
    x = np.linspace(-xm, xm, cfg.max_res_x)[:, None, None]
    y = np.linspace(-ym, ym, cfg.max_res_y)[None, :, None]
    r = np.sqrt(x ** 2 + y ** 2 + cfg.z_scan ** 2)
    tau = cfg.sample_rate * (x * rp[0] + y * rp[1]) / (
        cfg.propagation_speed * r)
    return tau.reshape(-1, rp.shape[1]).T


def steering(cfg, lo: int, hi: int, cells=None) -> np.ndarray:
    """complex128 array response a (F, M, D) for rfft bins [lo, hi): mic m
    hears the cell's wavefront ``arrival`` samples early, so its spectrum
    is the centre's times ``exp(+2j pi k tau / N)``."""
    tau = arrival(cfg)
    if cells is not None:
        tau = tau[:, cells]
    k = np.arange(lo, hi)[:, None, None]
    return np.exp(2j * np.pi * k * tau[None] / cfg.n_samples)


def capon_map(P, a) -> np.ndarray:
    """sum_f 1 / Re(a^H P a) for every direction, (D,)."""
    d = np.einsum("fmd,fmd->fd", a.conj(), P @ a).real
    return np.sum(1.0 / np.maximum(d, 1e-12), axis=0)


def loaded_inverse(R, load) -> np.ndarray:
    M = R.shape[-1]
    tr = np.einsum("fmm->f", R).real / M
    return np.linalg.inv(R + (load * tr + 1e-12)[:, None, None]
                         * np.eye(M))


def rank_update(A, S, alpha, first: bool) -> np.ndarray:
    """B per-frame EMA steps of A as one update; ``first`` reproduces the
    covariance's first-ever-frame replacement."""
    B = S.shape[0]
    w = (1 - alpha) * alpha ** (B - 1.0 - np.arange(B))
    if first:
        w[0] = alpha ** (B - 1)
    Sw = (S * w[:, None, None]).transpose(1, 2, 0)          # (F, M, B)
    U = Sw @ S.conj().transpose(1, 0, 2)                     # (F, M, M)
    return U if first else alpha ** B * A + U


class CaptureSink:
    """Audio sink that keeps the stream."""

    def __init__(self):
        self.parts = []

    def write(self, samples):
        self.parts.append(np.asarray(samples, np.float32).copy())

    def close(self):
        pass

    @property
    def stream(self):
        return np.concatenate(self.parts) if self.parts else np.zeros(0)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_line_rate(cfg, seed: int, seconds: float = 30.0, batch: int = 64,
                    n_cycle: int = 8, n_check: int = 16,
                    ring: int = 256) -> dict:
    """Emulator -> native ingest -> full-rate heatmap stage, as ``demo
    fullrate`` builds it (only the connected channel rows cross to the
    device).  The emulator streams ``n_cycle`` distinct frames cyclically;
    ``n_check`` maps after the first batch (whose oldest frame the
    receiver may have joined mid-frame) must each equal the oracle map of
    one cycle frame, in cycle order.  Both ends run the clean serpentine
    map (``exact_reference=False``) so the wire frames are the signal.

    Rates are read over one window of ``seconds``, opened once the stage
    has finished two batches: packets sent, frames published to the ring
    and frames the stage has delivered, each differenced across the same
    window.  The backlog (published minus delivered) is read at both ends
    and every 0.25 s between; a stage slower than the emulator grows it,
    and over 30 s a 10 frames/s deficit overruns the ``ring``-frame ring
    (counted in ``skipped``)."""
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import Pipeline
    from zybo_rt_sampler_image_detection_tpu.ingest.streamer import (
        NativeStreamer,
    )

    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend="native",
                 ring_frames=ring)
    p.receiver.exact_reference = False
    n_arrays = cfg.active_arrays
    n_ch = n_arrays * cfg.rows * cfg.columns
    captured, done = {}, []
    delivered = [0]                  # newest frame counter the sink got

    def sink(powers, first_seq):
        done.append(len(powers))
        delivered[0] = first_seq + len(powers) - 1
        for j, pw in enumerate(powers):
            if len(done) > 1 and len(captured) < n_check:
                captured[first_seq + j] = pw

    stage = p.make_heatmap_batched(batch=batch, sink=sink, channels=n_ch)
    t0 = time.perf_counter()
    stage.warmup()
    compile_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal((n_ch, n_cycle * cfg.n_samples)) * 0.05
           ).astype(np.float32)
    emu = NativeStreamer(cfg, n_arrays=n_arrays, exact_reference=False)
    emu.start(sig, rate=cfg.sample_rate)
    try:
        p.connect(timeout=10.0)
        p.run_stage(stage)
        t_end = time.perf_counter() + 30.0
        while len(done) < 2:
            check(time.perf_counter() < t_end, "stage did not start")
            time.sleep(0.01)

        def snap():
            return (time.perf_counter(), emu.sent,
                    p.receiver.published_seq, delivered[0])

        s0 = snap()
        backlog_max = s0[2] - s0[3]
        while time.perf_counter() - s0[0] < seconds:
            time.sleep(0.25)
            backlog_max = max(backlog_max,
                              p.receiver.published_seq - delivered[0])
        s1 = snap()
    finally:
        emu.stop()
        p.stop()
    gaps = int(p.receiver.native_stats.gaps)
    check(len(captured) == n_check, f"captured {len(captured)} maps")
    dt = s1[0] - s0[0]

    frames = np.zeros((n_cycle, cfg.n_microphones, cfg.n_samples),
                      np.float32)
    for k in range(n_cycle):
        frames[k, :n_ch] = wire(
            sig[:, k * cfg.n_samples:(k + 1) * cfg.n_samples], cfg)
    ref = oracle_maps(cfg, frames)
    errs, order = [], []
    for seq in sorted(captured):
        e = [rel_err(captured[seq], r) for r in ref]
        order.append(int(np.argmin(e)))
        errs.append(min(e))
    steps = {(b - a) % n_cycle for a, b in zip(order, order[1:])}
    check(steps <= {1}, f"captured maps out of cycle order: {order}")
    err = max(errs)
    check(err <= TIER_TOL["highest"],
          f"line-rate map error {err:.2e} > {TIER_TOL['highest']:.0e}")
    # one packet carries one sample of every channel
    return {"line_rate_frames_per_s": cfg.sample_rate / cfg.n_samples,
            "emulator_frames_per_s": (s1[1] - s0[1]) / cfg.n_samples / dt,
            "ingest_frames_per_s": (s1[2] - s0[2]) / dt,
            "stage_frames_per_s": (s1[3] - s0[3]) / dt, "window_s": dt,
            "backlog_start": s0[2] - s0[3], "backlog_end": s1[2] - s1[3],
            "backlog_max": backlog_max, "ring_frames": ring,
            "processed": stage.processed, "skipped": int(stage.skipped),
            "ingest_gaps": gaps, "compile_s": compile_s,
            "maps_checked": len(errs), "max_err_rel": err}


def phase_tiers(shapes, seed: int, batch: int = 64, n_check: int = 4) -> dict:
    """``default_power_fn`` at every tier and shape vs the oracle, on a
    batch of the line-rate stage's size (the lowering, and with it the
    product precision, may depend on the batch); ``n_check`` frames spread
    over the batch are compared."""
    from zybo_rt_sampler_image_detection_tpu.apps import pipeline
    from zybo_rt_sampler_image_detection_tpu.config import TIERS
    from zybo_rt_sampler_image_detection_tpu.ops import beamform

    rng = np.random.default_rng(seed + 1)
    out = {}
    for name, cfg in shapes:
        frames = (rng.standard_normal(
            (batch, cfg.n_microphones, cfg.n_samples)) * 0.05
        ).astype(np.float32)
        pick = np.linspace(0, batch - 1, n_check).astype(int)
        ref = oracle_maps(cfg, frames[pick])
        for tier, kw in TIERS.items():
            t = beamform.make_tables(cfg.replace(**kw), "lerp")
            kind, _ = pipeline._select_power_backend(t)
            got = np.asarray(pipeline.default_power_fn(t)(frames))
            err = rel_err(got[pick], ref)
            out[f"{name}/{tier}"] = {"path": kind, "max_err_rel": err}
            check(err <= TIER_TOL[tier],
                  f"{name} {tier} ({kind}) error {err:.2e} > "
                  f"{TIER_TOL[tier]:.0e}")
    return out


def _source_frames(cfg, direction: int, n: int, rng, noise: float = 0.02):
    """``n`` frames of a point source at grid cell ``direction`` plus weak
    white noise on every mic.  Each frame's source is a random signal g
    with rfft bins from ``BAND_LOW`` to ``SOURCE_F_MAX`` (lerp's
    interpolation loses the band near Nyquist, so the delay-and-sum beam
    is compared only below it); mic m gets g advanced by the cell's
    ``arrival`` delay, applied per frame in the frequency domain.
    Returns (frames (n, n_mics, N) float32, g (n, N))."""
    from zybo_rt_sampler_image_detection_tpu.ops import geometry

    N = cfg.n_samples
    k = np.arange(N // 2 + 1)
    lo, _ = band(cfg)
    keep = (k >= lo) & (k * cfg.sample_rate / N < SOURCE_F_MAX)
    a = steering(cfg, 0, N // 2 + 1, [direction])[..., 0]      # (K, M)
    G = (rng.standard_normal((n, k.size))
         + 1j * rng.standard_normal((n, k.size))) * keep
    g = np.fft.irfft(G, N, axis=-1)
    G *= 0.05 / g.std()
    g *= 0.05 / g.std()
    x = np.fft.irfft(G[:, :, None] * a[None], N, axis=1)      # (n, N, M)
    active, _ = geometry.active_microphones(cfg)
    frames = (rng.standard_normal((n, cfg.n_microphones, N)) * noise
              ).astype(np.float32)
    frames[:, active] += x.transpose(0, 2, 1).astype(np.float32)
    return frames, g


def mvdr_beams(cfg, frames, a, alpha: float, batch: int, lo: int,
               hi: int) -> np.ndarray:
    """complex128 model of the streaming MVDR listening beam (B, N): per
    batch, the EMA covariance A (from (1 + 1e-3) I) absorbs the batch,
    then every frame is beamed with ``w = A^-1 a / (a^H A^-1 a)`` and the
    band's inverse rfft."""
    N = cfg.n_samples
    A = np.broadcast_to(np.eye(a.shape[1]) * (1.0 + 1e-3),
                        (a.shape[0],) + (a.shape[1],) * 2)
    f = np.arange(lo, hi)
    c = np.where((f == 0) | (f == N // 2), 1.0, 2.0)
    basis = np.exp(2j * np.pi * np.outer(f, np.arange(N)) / N)
    out = []
    for i in range(0, frames.shape[0], batch):
        S = spectra(cfg, frames[i:i + batch], lo, hi)
        A = rank_update(A, S, alpha, first=False)
        x = np.linalg.solve(A, a[..., None])[..., 0]          # P a
        w = x / np.einsum("fm,fm->f", a.conj(), x).real[:, None]
        bf = np.einsum("fm,bfm->bf", w.conj(), S)
        out.append(((c * bf) @ basis).real / N)
    return np.concatenate(out)


def phase_listening(cfg, seed: int, batch: int = 16,
                    n_batches: int = 4) -> dict:
    """``BatchedMisoProducer`` (delay-and-sum and MVDR beams) on frames
    from its own ring: every batch beamed and written to the sink in
    order.  Delay-and-sum vs the oracle's steered beam + gain chain.

    MVDR, at the default memory (alpha 0.9) and a long one (0.99), vs a
    complex128 model of the same streaming inverse steered from the
    geometry, and vs the oracle's steered beam.  The MVDR's phase
    reference is the array centre, the delay-and-sum's the last mic the
    wavefront reaches, so the MVDR beam is advanced by that offset (a
    fractional shift, exact on the band-limited beam) and the two are
    correlated where every mic contributes to the oracle's output (from
    the largest whole delay on).  At alpha 0.9 the covariance holds about
    19 snapshots per bin, far fewer than mics, so the beam cancels part
    of its own steered source; ``MVDR_DAS_CORR`` holds each memory to
    what the model reaches, well above a wrong sign or a missing shift."""
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import Pipeline
    from zybo_rt_sampler_image_detection_tpu.ops import (
        beamform, geometry, oracle,
    )
    from zybo_rt_sampler_image_detection_tpu.utils import audio as audio_mod

    rng = np.random.default_rng(seed + 2)
    direction = beamform.steer_index(cfg, 10.0, -5.0)
    frames, _ = _source_frames(cfg, direction, batch * n_batches, rng)
    active, n = geometry.active_microphones(cfg)
    whole, frac = geometry.lerp_coefficients(cfg)
    das = np.stack([oracle.miso_lerp(
        f.astype(np.float64), active, whole.reshape(-1), frac.reshape(-1),
        n, direction * n) for f in frames])                  # (B, N)
    N = cfg.n_samples
    lo, hi = band(cfg)
    a = steering(cfg, lo, hi, [direction])[..., 0]           # (F, M)
    c0 = arrival(cfg)[:, direction].min()
    t0 = int(whole.reshape(-1)[direction * n:(direction + 1) * n].max()) + 1
    k = np.arange(N // 2 + 1)

    def corr_das(beams):
        y = np.fft.irfft(np.fft.rfft(beams.reshape(-1, N), axis=-1)
                         * np.exp(2j * np.pi * k * c0 / N), N, axis=-1)
        return float(np.corrcoef(y[:, t0:].ravel(),
                                 das[:, t0:].ravel())[0, 1])

    out = {}
    for beam, alpha in (("time", 0.9), ("mvdr", 0.9), ("mvdr", 0.99)):
        p = Pipeline(cfg, algorithm="lerp", replay_mode=True,
                     backend="python", ring_frames=max(64, 4 * batch))
        sink = CaptureSink()
        stage = p.make_miso_batched(batch=batch, beam=beam, alpha=alpha,
                                    sink=sink)
        stage.steer(direction)
        for i in range(n_batches):
            blk = frames[i * batch:(i + 1) * batch]
            stage._finish((stage.launch(stage._to_device(blk)),
                           1 + i * batch, 0, time.perf_counter(), None))
        got = sink.stream
        check(got.size == frames.shape[0] * N,
              f"{beam}: {got.size} samples for {frames.shape[0]} frames")
        if beam == "time":
            expect = audio_mod.miso_gain(das.reshape(-1), n, cfg.mic_gain,
                                         cfg.norm_factor_sound)
            err = rel_err(got, expect)
            check(err <= BEAM_TOL, f"time beam error {err:.2e}")
            out["time"] = {"max_err_rel": err}
            continue
        band(cfg, stage.beam_fn.tables)
        model = mvdr_beams(cfg, frames, a, alpha, batch, lo, hi)
        err = rel_err(got, model.reshape(-1))
        check(err <= MVDR_TOL, f"mvdr {alpha} beam error {err:.2e}")
        corr, corr_model = corr_das(got), corr_das(model)
        check(corr >= MVDR_DAS_CORR[alpha],
              f"mvdr {alpha} beam vs oracle delay-and-sum: corr "
              f"{corr:.4f} < {MVDR_DAS_CORR[alpha]}")
        out[f"mvdr_alpha{alpha}"] = {
            "max_err_rel": err, "corr_with_oracle_das": corr,
            "model_corr_with_oracle_das": corr_model}
    out["oracle_offset_samples"] = float(c0)
    return out


def phase_freq(cfg, seed: int, block: int = 16, n_blocks: int = 4) -> dict:
    """FFT Bartlett, covariance update + ``mvdr_power``, and one
    production MVDR epoch (``make_mvdr_stream``: ``n_blocks`` blocks with
    the carried quadratic form, then the exact refresh) vs complex128
    references steered from the geometry."""
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import (
        make_mvdr_stream,
    )
    from zybo_rt_sampler_image_detection_tpu.ops import freq

    rng = np.random.default_rng(seed + 3)
    B = block * n_blocks
    frames = (rng.standard_normal((B, cfg.n_microphones, cfg.n_samples))
              * 0.05).astype(np.float32)
    fn = make_mvdr_stream(cfg, "maps", band_low=BAND_LOW)
    ft = fn.tables
    lo, hi = band(cfg, ft)
    a = steering(cfg, lo, hi)
    S = spectra(cfg, frames, lo, hi)
    shape = (-1, cfg.max_res_x, cfg.max_res_y)
    out = {}

    ref = np.sum(np.abs(np.einsum("bfm,fmd->bfd", S[:8],
                                  np.conj(a))) ** 2, axis=1).reshape(shape)
    err = rel_err(freq.fft_steered_power(frames[:8], ft), ref)
    check(err <= BARTLETT_TOL, f"Bartlett error {err:.2e}")
    out["bartlett_max_err_rel"] = err

    cov = freq.update_covariance(freq.init_covariance(ft), frames[:block],
                                 ft)
    R = np.einsum("bfm,bfn->fmn", S[:block], S[:block].conj()) / block
    err = rel_err(freq.mvdr_power(cov, ft),
                  capon_map(loaded_inverse(R, 1e-3), a).reshape(shape[1:]))
    check(err <= MVDR_TOL, f"mvdr_power error {err:.2e}")
    out["mvdr_power_max_err_rel"] = err

    # the epoch: per-frame maps follow the streaming inverse P_t =
    # inv(A_t), A_t = alpha A_{t-1} + (1 - alpha) s_t s_t^H, A_0 = (1+load) I
    fn.reset()
    A = np.broadcast_to(np.eye(a.shape[1]) * (1.0 + 1e-3),
                        (a.shape[0],) + (a.shape[1],) * 2)
    errs = []
    for i in range(n_blocks):
        sl = slice(i * block, (i + 1) * block)
        maps = np.asarray(fn(frames[sl]))
        check(bool(np.isfinite(maps).all()), f"epoch block {i} not finite")
        A = rank_update(A, S[sl], fn.alpha, first=False)
        errs.append(rel_err(maps[-1], capon_map(np.linalg.inv(A), a)
                            .reshape(shape[1:])))
    err = max(errs)
    check(err <= MVDR_TOL, f"epoch map error {err:.2e}")
    check(fn.state["r"] == B, f"refresh did not run (r={fn.state['r']})")
    out["epoch_block_end_max_err_rel"] = err
    R = rank_update(None, S, fn.alpha, first=True)
    err = rel_err(freq.mvdr_power_precision(fn.state["p"], ft, "highest"),
                  capon_map(loaded_inverse(R, 1e-3), a).reshape(shape[1:]))
    check(err <= MVDR_TOL, f"refreshed map error {err:.2e}")
    out["refreshed_max_err_rel"] = err
    return out


def _raster_mask(sx, sy, window, box_ratio=0.1):
    """Pixels the power box + centre circle can touch at (sx, sy), dilated
    by 1 and mirrored like the display: host and device may floor the
    power centre to adjacent pixels, which moves the whole box."""
    Ww, Hw = window
    bw, bh = int(Ww * box_ratio), int(Hw * box_ratio)
    x1, y1 = max(0, sx - bw // 2), max(0, sy - bh // 2)
    x2, y2 = min(Ww, sx + bw // 2), min(Hw, sy + bh // 2)
    m = np.zeros((Hw, Ww), bool)
    for ax1, ay1, ax2, ay2 in [(x1, y1, x2, y1), (x1, y2, x2, y2),
                               (x1, y1, x1, y2), (x2, y1, x2, y2)]:
        m[max(0, ay1 - 4):ay2 + 5, max(0, ax1 - 4):ax2 + 5] = True
    m[max(0, sy - 7):sy + 8, max(0, sx - 7):sx + 8] = True
    return m[:, ::-1]


def phase_fused(cfg, seed: int, K: int = 16, det_size: int = 416,
                det_width: float = 1.0, classes: int = 3,
                cam_hw=(240, 320), window=(640, 360),
                n_oracle: int = 4) -> dict:
    """One ``FusedSensorStage`` display cycle with embedded MVDR
    listening: heatmap vs the oracle, detections table shape/finiteness,
    and the device composite vs the host ``Viewer`` chain fed the same
    heatmaps and camera frames."""
    import jax

    from zybo_rt_sampler_image_detection_tpu.apps.fused import (
        FusedSensorStage,
    )
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import _pad_full
    from zybo_rt_sampler_image_detection_tpu.fusion.composite import (
        DeviceCompositor,
    )
    from zybo_rt_sampler_image_detection_tpu.fusion.decider import (
        SensorFusionDecider,
    )
    from zybo_rt_sampler_image_detection_tpu.ingest.receiver import Receiver
    from zybo_rt_sampler_image_detection_tpu.models.detect import (
        YoloDetector,
    )
    from zybo_rt_sampler_image_detection_tpu.models.yolo import YoloConfig
    from zybo_rt_sampler_image_detection_tpu.ops import beamform
    from zybo_rt_sampler_image_detection_tpu.utils import viz
    from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
        PipelineMetrics,
    )

    n_ch = cfg.active_arrays * cfg.rows * cfg.columns
    tables = beamform.make_tables(cfg, "lerp")
    comp = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), cam_hw,
                            window=window, yolo_shape=cam_hw, max_tracks=8)
    det = YoloDetector(cfg=YoloConfig(input_size=det_size,
                                      width_mult=det_width,
                                      num_classes=classes), seed=seed)
    stage = FusedSensorStage(
        Receiver(cfg, replay_mode=True, backend="python"), tables, comp,
        det, queue.Queue(), viz.ArrayDisplay(keep=K), PipelineMetrics(),
        batch=K, channels=min(n_ch, cfg.n_microphones), listen="mvdr")
    t0 = time.perf_counter()
    stage.warmup()
    compile_s = time.perf_counter() - t0
    stage._prev = None                # start the display EMA afresh
    rng = np.random.default_rng(seed + 4)
    mic = (rng.standard_normal((stage.Km, stage.mc, stage.n_samples))
           * 0.05).astype(np.float32)
    cams = rng.integers(30, 225, (K,) + tuple(cam_hw) + (3,),
                        dtype=np.uint8)
    t0 = time.perf_counter()
    packed = np.asarray(stage._launch(mic, cams, K))
    cycle_s = time.perf_counter() - t0
    comps, dets, mask, cls_ids, metas, beams = stage._unpack(packed)

    full = np.asarray(_pad_full(jax.numpy.asarray(mic[-K:]),
                                cfg.n_microphones))
    powers = np.asarray(stage._tr(full, *stage._power_extra))
    pick = np.linspace(0, K - 1, n_oracle).astype(int)
    err = rel_err(powers[pick], oracle_maps(cfg, full[pick]))
    check(err <= TIER_TOL["highest"], f"fused heatmap error {err:.2e}")

    md = det.max_det
    check(dets.shape == (K, md, 5) and mask.shape == (K, md)
          and cls_ids.shape == (K, md), f"detections {dets.shape}")
    check(bool(np.isfinite(dets).all()), "non-finite detections")
    check(bool(((cls_ids >= 0) & (cls_ids < classes)).all()),
          "class ids out of range")
    check(beams.shape == (stage.Km, stage.n_samples)
          and bool(np.isfinite(beams).all()), "listening beams")

    qp, qv, qi = queue.Queue(), queue.Queue(), queue.Queue()
    blank = np.zeros(tuple(cam_hw) + (3,), np.uint8)
    for i in range(K):
        qp.put((powers[i], i))
        qv.put((i, cams[i]))
        qi.put((i, blank, 0.0))
    disp = viz.ArrayDisplay(keep=K)
    viz.Viewer(window=window, display=disp,
               heatmap_color=comp.heatmap_color).loop(
        qp, True, q_viewer=qv, q_inference=qi,
        decider=SensorFusionDecider(window), max_frames=K)
    host = np.stack(disp.frames)
    meta = DeviceCompositor.meta_dict(metas)
    worst = 0
    Xg, Yg = cfg.max_res_x, cfg.max_res_y
    for i in range(K):
        px, py = viz.find_power_center(np.clip(powers[i], 1e-12, None))
        hx = window[0] - 1 - int(py / max(Xg - 1, 1) * window[0])
        hy = window[1] - 1 - int(px / max(Yg - 1, 1) * window[1])
        dx, dy = int(meta["sx"][i]), int(meta["sy"][i])
        check(abs(hx - dx) <= 1 and abs(hy - dy) <= 1,
              f"frame {i}: power centre ({dx},{dy}) vs host ({hx},{hy})")
        diff = np.abs(host[i].astype(np.int32) - comps[i].astype(np.int32))
        if (hx, hy) != (dx, dy) and meta["should"][i]:
            keep = ~(_raster_mask(hx, hy, window)
                     | _raster_mask(dx, dy, window))
            diff = diff[keep]
        check(diff.max() <= COMP_MAX_ABS
              and diff.mean() <= COMP_MEAN_ABS
              and (diff > 2).mean() <= COMP_FRAC_GT2,
              f"frame {i}: composite differs from host (max {diff.max()}, "
              f"mean {diff.mean():.3f}, >2 {(diff > 2).mean():.4f})")
        worst = max(worst, int(diff.max()))
    return {"compile_s": compile_s, "cycle_s": cycle_s,
            "heatmap_max_err_rel": err, "composite_max_abs_diff": worst,
            "detections": list(dets.shape),
            "detections_kept": int(mask.sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="line-rate measurement window")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{dev.platform}", file=sys.stderr)
        return 2
    import zybo_rt_sampler_image_detection_tpu as zrt
    from zybo_rt_sampler_image_detection_tpu.utils.profiling import card

    print(f"card: {card()}", flush=True)
    print(f"jax {jax.__version__}; device {dev.device_kind}; "
          f"seed {args.seed}", flush=True)
    cfg = zrt.Config()
    phases = [
        ("line_rate", lambda: phase_line_rate(cfg, args.seed,
                                              args.seconds)),
        ("tiers", lambda: phase_tiers(
            [("64ch_65x65", zrt.Config.northstar()), ("256ch_57x32", cfg)],
            args.seed)),
        ("listening", lambda: phase_listening(cfg, args.seed)),
        ("freq", lambda: phase_freq(cfg, args.seed)),
        ("fused", lambda: phase_fused(cfg, args.seed)),
    ]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            res = run()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
            continue
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f}s) "
              f"{json.dumps(res)}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
