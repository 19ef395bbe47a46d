"""The exact frequency-domain reformulation (ops/freq_equiv) must equal
the time-domain family bit-comparably for EVERY algorithm — it is a
reformulation, not an approximation: same output, no T axis in the
per-frame contraction (~20x fewer MACs at the reference shape)."""

import numpy as np
import pytest

from zybo_rt_sampler_image_detection_tpu.ops import beamform, freq_equiv

from conftest import synth_frame


ALGORITHMS = ("pad", "lerp", "convolve", "hybrid", "truncated")


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_equiv_power_matches_time_domain(tiny_cfg, rng, algorithm):
    frames = np.stack([synth_frame(tiny_cfg, rng) for _ in range(3)])
    t = beamform.make_tables(tiny_cfg, algorithm, cache=False)
    ref = np.asarray(beamform.steered_power(frames, t), np.float64)
    et = freq_equiv.make_equiv_tables(t)
    got = np.asarray(freq_equiv.equiv_steered_power(frames, et), np.float64)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-14)


def test_equiv_power_single_frame_squeeze(tiny_cfg, rng):
    frame = synth_frame(tiny_cfg, rng)
    t = beamform.make_tables(tiny_cfg, "lerp", cache=False)
    et = freq_equiv.make_equiv_tables(t)
    got = np.asarray(freq_equiv.equiv_steered_power(frame, et))
    assert got.shape == (tiny_cfg.max_res_x, tiny_cfg.max_res_y)
    ref = np.asarray(beamform.steered_power(frame, t))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-14)


def test_equiv_pipeline_backend(tiny_cfg):
    """Pipeline(power_backend='freq_equiv') builds the equivalent path."""
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import Pipeline

    p = Pipeline(tiny_cfg, algorithm="lerp", replay_mode=True,
                 power_backend="freq_equiv")
    frame = np.zeros((tiny_cfg.n_microphones, tiny_cfg.n_samples),
                     np.float32)
    out = np.asarray(p._power_fn(frame[None]))
    assert out.shape == (1, tiny_cfg.max_res_x, tiny_cfg.max_res_y)
    for bad in ("nope", "equiv_kernel"):
        with pytest.raises(ValueError):
            Pipeline(tiny_cfg, power_backend=bad)


def test_equiv_auto_select_decision(tiny_cfg, monkeypatch):
    """The pipeline selects freq_equiv when the MAC-ratio bar is cleared
    and the stacked response planes fit the memory cap; the 'highest'
    tier never selects it (bit-level time-domain contract)."""
    from zybo_rt_sampler_image_detection_tpu.apps import pipeline

    sentinel = object()
    monkeypatch.setattr(
        "zybo_rt_sampler_image_detection_tpu.ops.freq_equiv"
        ".make_equiv_tables", lambda t: sentinel)

    def pick(D, T, M, N, precision="high"):
        kind, obj = pipeline._select_power_backend(
            FakeTables(D, T, M, N, precision=precision))
        assert (obj is sentinel) == (kind == "freq_equiv")
        return kind

    # reference-like: T=49, N=256 -> ratio ~20x, 862 MB planes
    assert pick(1824, 49, 256, 256) == "freq_equiv"
    assert pick(1824, 49, 256, 256, "default") == "freq_equiv"
    # 64-ch/65x65 spread (T=19): ratio ~8.7x stays on the time path
    assert pick(4225, 19, 64, 256) == "xla"
    assert pick(4225, 19, 64, 256, "default") == "xla"
    # bit-level exactness mode
    assert pick(1824, 49, 256, 256, "highest") == "xla"
    # degenerate single-tap spread: ratio below the bar
    assert pick(4225, 1, 64, 256) == "xla"
    # decisive ratio but stacked planes exceed the memory cap
    assert pick(40000, 49, 512, 256) == "xla"


class FakeTables:
    """Shape-only stand-in for ``beamform.SteeringTables``."""

    def __init__(self, D, T, M, N, tau_min=0, precision="high"):
        self.W = np.zeros((D, T, M), np.float32)
        self.n_samples = N
        self.tau_min = tau_min
        self.precision = precision


@pytest.mark.slow
def test_equiv_power_reference_shape():
    """Exactness holds at the true reference shape (57x32, 256 mics,
    T=49, 154 padded bins — measured 8.6e-7 max cellwise rel err)."""
    import zybo_rt_sampler_image_detection_tpu as zrt

    cfg = zrt.Config()
    t = beamform.make_tables(cfg, "lerp", cache=True)
    et = freq_equiv.make_equiv_tables(t)
    rng = np.random.default_rng(5)
    frames = (rng.standard_normal(
        (2, cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    ref = np.asarray(beamform.steered_power(frames, t), np.float64)
    got = np.asarray(freq_equiv.equiv_steered_power(frames, et), np.float64)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-16)
