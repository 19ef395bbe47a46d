"""Full-line-rate batched ingest -> device path (SURVEY §7 hard part b):
every frame the receiver writes is beamformed exactly once, in
counter-contiguous K-frame device batches, with zero drops at the hermetic
rate.  The reference only ever snapshots the newest frame
(``PC/src/api.c:830-859``) even though the receiver writes all of them
(``PC/src/receiver.c:94-151``)."""

import time

import numpy as np
import pytest

import zybo_rt_sampler_image_detection_tpu as zrt
from zybo_rt_sampler_image_detection_tpu.apps.pipeline import Pipeline
from zybo_rt_sampler_image_detection_tpu.ingest import streamer
from zybo_rt_sampler_image_detection_tpu.ingest.receiver import FrameRing
from zybo_rt_sampler_image_detection_tpu.ops import beamform


def test_frame_ring_batch_semantics():
    ring = FrameRing(2, 4, capacity=8)
    for s in range(1, 21):                       # publish seqs 1..20
        ring.publish(np.full((2, 4), float(s), np.float32))

    # reader far behind: oldest surviving frame is seq 13 (20 - 8 + 1)
    batch, first, skipped = ring.read_batch(4, next_seq=1, timeout=0.0)
    assert first == 13 and skipped == 12
    assert [b[0, 0] for b in batch] == [13.0, 14.0, 15.0, 16.0]

    # contiguous follow-up read: no skips
    batch, first, skipped = ring.read_batch(4, next_seq=17, timeout=0.0)
    assert first == 17 and skipped == 0
    assert [b[0, 0] for b in batch] == [17.0, 18.0, 19.0, 20.0]

    # not enough frames yet -> timeout signalled as (None, next_seq, 0)
    batch, first, skipped = ring.read_batch(4, next_seq=21, timeout=0.05)
    assert batch is None and first == 21

    with pytest.raises(ValueError):
        ring.read_batch(9, next_seq=1)           # k > capacity


@pytest.mark.parametrize("backend", ["python", "native"])
def test_batched_pipeline_beamforms_every_frame(backend):
    """Emulator streams N distinct frames; the batched producer must
    process all N (drop count == 0) and each heatmap must equal the
    single-frame XLA path on the quantized signal."""
    port = 21931 if backend == "python" else 21932
    cfg = zrt.Config.tiny().replace(udp_port=port)
    n_frames, K = 24, 4
    rng = np.random.default_rng(21)
    base = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]

    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend=backend)
    p.receiver.exact_reference = False
    got = {}

    def sink(powers, first_seq):
        for j, pw in enumerate(powers):
            got[first_seq + j] = pw

    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    stage = p.start_heatmap_batched(batch=K, sink=sink)
    deadline = time.time() + 20.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.05)
    p.stop()

    assert stage.skipped == 0, "full-rate contract: zero drops"
    assert stage.processed >= n_frames
    assert set(range(1, n_frames + 1)) <= set(got), \
        "every frame must be beamformed exactly once, in order"

    # heatmap correctness: batched device output == single-frame reference
    # on the int32-quantized wire signal
    for s in (1, n_frames // 2, n_frames):
        wire = (np.round(frames[s - 1].astype(np.float64) * cfg.norm_factor)
                / cfg.norm_factor).astype(np.float32)
        expect = np.asarray(beamform.steered_power(wire, p.tables))
        np.testing.assert_allclose(got[s], expect, rtol=1e-4, atol=1e-10)

    rep = p.report()
    assert rep["heatmap_batched"]["dropped"] == 0
    assert rep["heatmap_batched"]["latency_p50_ms"] > 0


def test_mvdr_power_fn_batch_aware():
    """The demo's MVDR power_fn handles both single frames (live loop) and
    batches (full-rate stage): batched calls run the subspace-recursive
    scan — EXACT per-frame maps + one rank-B state update — and must
    match the sequential per-frame loop."""
    import argparse

    from zybo_rt_sampler_image_detection_tpu.apps.demo import _make_pipeline

    args = argparse.Namespace(algorithm="mvdr", replay=True, backend="python",
                              port=21939, preset="tiny", headless=True,
                              frames=0)
    p = _make_pipeline(args)
    cfg = p.cfg
    rng = np.random.default_rng(3)
    single = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.1).astype(np.float32)
    m1 = np.asarray(p._power_fn(jnp_asarray(single)))
    assert m1.shape == (cfg.max_res_x, cfg.max_res_y)
    batch = np.stack([single * (1 + 0.1 * i) for i in range(4)])
    mb = np.asarray(p._power_fn(jnp_asarray(batch)))
    assert mb.shape == (4, cfg.max_res_x, cfg.max_res_y)
    # per-frame EXACT maps: each frame's map reflects the state after
    # absorbing that frame (equivalence to the sequential loop is gated
    # in test_freq::test_mvdr_maps_scan_matches_sequential); here check
    # the maps evolve across the block and stay finite/positive
    assert np.isfinite(mb).all() and (mb > 0).all()
    assert not np.array_equal(mb[0], mb[-1])


def jnp_asarray(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


class _CaptureSink:
    """Audio sink that keeps every written chunk (test double)."""

    def __init__(self):
        self.chunks = []

    def write(self, samples):
        self.chunks.append(np.asarray(samples, np.float32).copy())

    def close(self):
        pass

    @property
    def stream(self):
        return (np.concatenate(self.chunks)
                if self.chunks else np.zeros(0, np.float32))


@pytest.mark.parametrize("beam", ["time", "mvdr"])
def test_batched_miso_gapless_and_parity(beam):
    """Full-rate listening contract (VERDICT round-2 #1): every frame
    beamed exactly once, the sink receives a sample-count-exact
    contiguous stream, and the stream equals the per-frame offline
    oracle (miso_beam + gain chain for delay-and-sum; the fused
    update+beam step for MVDR) applied to the quantized wire frames in
    counter order."""
    from zybo_rt_sampler_image_detection_tpu.ops import freq

    port = 21944 if beam == "time" else 21945
    cfg = zrt.Config.tiny().replace(udp_port=port)
    n_frames, K = 16, 4
    rng = np.random.default_rng(7)
    base = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]

    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend="python")
    p.receiver.exact_reference = False
    sink = _CaptureSink()
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    stage = p.start_miso_batched(batch=K, beam=beam, sink=sink)
    deadline = time.time() + 20.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.05)
    p.stop()

    assert stage.underrun_frames == 0, "gapless contract: zero underruns"
    assert stage.processed >= n_frames
    # sample-count exact: the stream is processed * N contiguous samples
    assert stage.samples == stage.processed * cfg.n_samples
    assert sink.stream.size == stage.samples

    # parity with the per-frame offline oracle on the quantized wire signal
    wires = [(np.round(f.astype(np.float64) * cfg.norm_factor)
              / cfg.norm_factor).astype(np.float32) for f in frames]
    if beam == "time":
        from zybo_rt_sampler_image_detection_tpu.utils import audio as am
        expect = np.concatenate([
            am.miso_gain(np.asarray(beamform.miso_beam(w, p.tables, 0)),
                         p.tables.n_mics, cfg.mic_gain,
                         cfg.norm_factor_sound)
            for w in wires])
    else:
        ft = freq.make_freq_tables(cfg, 100.0)
        st = freq.init_precision(ft)
        chunks = []
        for i in range(0, n_frames, K):
            blk = np.stack(wires[i:i + K])
            beams, st = freq.mvdr_listen_step(st, blk, ft, 0)
            chunks.append(np.asarray(beams).reshape(-1))
        expect = np.concatenate(chunks)
    got = sink.stream[:expect.size]
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-7)


def test_combined_mimo_miso_stage():
    """The combined stage serves BOTH outputs from one transfer/program:
    every frame's heatmap matches the single-frame XLA path and the
    audio stream matches the per-frame beam oracle, with zero drops."""
    from zybo_rt_sampler_image_detection_tpu.utils import audio as am

    port = 21947
    cfg = zrt.Config.tiny().replace(udp_port=port)
    n_frames, K = 16, 4
    rng = np.random.default_rng(9)
    base = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]

    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend="python")
    p.receiver.exact_reference = False
    a_sink = _CaptureSink()
    got = {}

    def power_sink(powers, first_seq):
        for j, pw in enumerate(powers):
            got[first_seq + j] = pw

    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    stage = p.make_mimo_miso_batched(batch=K, sink=a_sink,
                                     power_sink=power_sink)
    stage.warmup()
    p.run_stage(stage)
    deadline = time.time() + 20.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.05)
    p.stop()

    assert stage.skipped == 0 and stage.underrun_frames == 0
    assert stage.processed >= n_frames
    assert a_sink.stream.size == stage.samples == \
        stage.processed * cfg.n_samples
    wires = [(np.round(f.astype(np.float64) * cfg.norm_factor)
              / cfg.norm_factor).astype(np.float32) for f in frames]
    for s in (1, n_frames // 2, n_frames):
        expect = np.asarray(beamform.steered_power(wires[s - 1], p.tables))
        np.testing.assert_allclose(got[s], expect, rtol=1e-4, atol=1e-10)
    expect_audio = np.concatenate([
        am.miso_gain(np.asarray(beamform.miso_beam(w, p.tables, 0)),
                     p.tables.n_mics, cfg.mic_gain, cfg.norm_factor_sound)
        for w in wires])
    np.testing.assert_allclose(a_sink.stream[:expect_audio.size],
                               expect_audio, rtol=1e-4, atol=1e-7)


def test_batched_miso_underrun_zero_fill():
    """Frames lost to ring overwrites are zero-filled and counted, so the
    output stream stays time-aligned (sample-count exact)."""
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import (
        BatchedMisoProducer,
    )
    from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
        PipelineMetrics,
    )

    cfg = zrt.Config.tiny()
    N = cfg.n_samples

    class _FakeReceiver:
        ring_frames = 8

    _FakeReceiver.cfg = cfg

    sink = _CaptureSink()
    beams = np.arange(2 * N, dtype=np.float32).reshape(2, N)
    stage = BatchedMisoProducer(
        _FakeReceiver(), sink, PipelineMetrics(), batch=2,
        beam_fn=lambda f, d: f, post_fn=lambda b: b, n_samples=N)
    stage._finish((beams, 1, 3, time.perf_counter(), None))
    assert stage.underrun_frames == 3
    assert stage.processed == 2
    assert stage.samples == 5 * N
    assert sink.stream.size == 5 * N
    np.testing.assert_array_equal(sink.stream[:3 * N], 0.0)
    np.testing.assert_array_equal(sink.stream[3 * N:], beams.reshape(-1))


def test_sharded_fullrate_pipeline(tiny_cfg):
    """SURVEY §2.4 ingest fan-in (VERDICT r3 #4): emulator -> native-or-
    python ingest -> BatchedHeatmapProducer with a mesh — every batch is
    ``device_put`` with a batch-over-"data" NamedSharding and launched
    through the sharded production program on the 8-device virtual mesh.
    Full-rate contract (zero drops) AND parity with the single-device
    path must both hold."""
    from zybo_rt_sampler_image_detection_tpu.parallel import mesh as pmesh

    port = 21954
    cfg = zrt.Config.tiny().replace(udp_port=port)
    n_frames, K = 24, 8                    # K divides the 4-wide data axis
    rng = np.random.default_rng(33)
    base = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]

    p = Pipeline(cfg, algorithm="lerp", replay_mode=True)
    p.receiver.exact_reference = False
    got = {}

    def sink(powers, first_seq):
        for j, pw in enumerate(powers):
            got[first_seq + j] = pw

    m = pmesh.make_mesh(4, 2)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    stage = p.start_heatmap_batched(batch=K, sink=sink, mesh=m)
    assert stage.sharding is not None      # batches transfer SHARDED
    deadline = time.time() + 30.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.05)
    p.stop()

    assert stage.skipped == 0, "full-rate contract: zero drops"
    assert set(range(1, n_frames + 1)) <= set(got)
    for s in (1, n_frames // 2, n_frames):
        wire = (np.round(frames[s - 1].astype(np.float64) * cfg.norm_factor)
                / cfg.norm_factor).astype(np.float32)
        expect = np.asarray(beamform.steered_power(wire, p.tables))
        np.testing.assert_allclose(got[s], expect, rtol=1e-4, atol=1e-10)


def test_sharded_stage_rejects_bad_config(tiny_cfg):
    """Mesh transfers need full-width f32 batches and a divisible batch."""
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import (
        BatchedHeatmapProducer,
    )
    from zybo_rt_sampler_image_detection_tpu.parallel import mesh as pmesh
    from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
        PipelineMetrics,
    )

    cfg = zrt.Config.tiny()
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True)
    m = pmesh.make_mesh(4, 2)
    with pytest.raises(ValueError, match="divide"):
        BatchedHeatmapProducer(p.receiver, p.tables, p.q_power,
                               PipelineMetrics(), batch=6, mesh=m)
    with pytest.raises(ValueError, match="full-width"):
        BatchedHeatmapProducer(p.receiver, p.tables, p.q_power,
                               PipelineMetrics(), batch=8, mesh=m,
                               channels=8)
