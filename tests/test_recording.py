"""Recording (.npy capture) through the live replay loop, and metrics."""

import numpy as np
import pytest

import zybo_rt_sampler_image_detection_tpu as zrt
from zybo_rt_sampler_image_detection_tpu.ingest import receiver, streamer
from zybo_rt_sampler_image_detection_tpu.utils import metrics, recording


def test_npy_recording(tmp_path):
    cfg = zrt.Config.tiny().replace(udp_port=21906)
    rng = np.random.default_rng(7)
    # 12 distinct frames cycled for a long window: a 0.2-0.3 s host stall
    # on a loaded host must not let the stream end
    # before the recorder has read its 3 frames
    frames = [(rng.standard_normal((cfg.n_microphones, cfg.n_samples)) * 0.1
               ).astype(np.float32) for _ in range(12)] * 40
    r = receiver.Receiver(cfg, replay_mode=True, backend="python",
                          exact_reference=False)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=4 * cfg.sample_rate)
    r.connect(timeout=5.0)
    seconds = 3 * cfg.n_samples / cfg.sample_rate
    path = recording.record_npy(r, seconds, str(tmp_path / "cap.npy"))
    r.disconnect()
    rec = np.load(path)
    assert rec.shape[0] == cfg.n_microphones
    assert rec.shape[1] >= 3 * cfg.n_samples
    assert rec.dtype == np.float32
    # every recorded frame equals one of the streamed frames, OR is an
    # all-zero skip marker (get_recording keeps the timeline contiguous by
    # zero-filling frames the consumer missed under load)
    matched = 0
    for i in range(rec.shape[1] // cfg.n_samples):
        chunk = rec[:, i * cfg.n_samples:(i + 1) * cfg.n_samples]
        if not chunk.any():
            continue
        errs = [np.abs(chunk - f).max() for f in frames]
        assert min(errs) < 2.0 / cfg.norm_factor
        matched += 1
    assert matched >= 1


def test_metrics_report():
    m = metrics.PipelineMetrics()
    st = m.stage("heatmap")
    for _ in range(10):
        with metrics.timed(st):
            pass
    rep = m.report()
    assert rep["heatmap"]["count"] == 10
    assert rep["heatmap"]["rate_hz"] > 0


def test_get_recording_skip_policies():
    """Missed frames are detected from the sequence counter; 'zero' inserts
    zero frames (warning), 'raise' raises (round-1 advisor finding)."""
    import warnings

    class FakeReceiver:
        """Publishes seq 1, 2, then jumps to 5 (frames 3-4 missed)."""
        cfg = zrt.Config.tiny()

        def __init__(self):
            self.seqs = iter([1, 2, 5, 6, 7, 8])

        def read_frame(self, fresh=True, last_seq=0, timeout=None):
            seq = next(self.seqs)
            f = np.full((self.cfg.n_microphones, self.cfg.n_samples),
                        float(seq), np.float32)
            return f, seq

    T = FakeReceiver.cfg.n_samples
    seconds = 5 * T / FakeReceiver.cfg.sample_rate
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rec = recording.get_recording(FakeReceiver(), seconds, on_skip="zero")
    assert any("missed" in str(x.message) for x in w)
    got = [rec[0, i * T] for i in range(5)]
    assert got == [1.0, 2.0, 0.0, 0.0, 5.0]

    with pytest.raises(RuntimeError, match="not contiguous"):
        recording.get_recording(FakeReceiver(), seconds, on_skip="raise")

    rec = recording.get_recording(FakeReceiver(), seconds, on_skip="ignore")
    assert [rec[0, i * T] for i in range(5)] == [1.0, 2.0, 5.0, 6.0, 7.0]
