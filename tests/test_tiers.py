"""Both heatmap paths (the time-domain delay-line contraction and the
exact frequency-domain reformulation) at every precision tier, for every
algorithm, against the float64 C-loop oracle; their batch/squeeze and
dead-mic handling; and the one backend policy that picks between them.

Tolerances are max |got - ref| / max |ref|.  On the CPU every precision
runs full f32 products, so "highest" and "high" share the f32 bound; the
"bf16" tier rounds the steering taps (and, on the time-domain path, the
samples) to bf16, ~3 significant digits."""

import numpy as np
import pytest

from zybo_rt_sampler_image_detection_tpu.apps import pipeline
from zybo_rt_sampler_image_detection_tpu.config import TIERS
from zybo_rt_sampler_image_detection_tpu.ops import beamform, freq_equiv

from conftest import synth_frame
from test_beamform import oracle_heatmap

TOL = {"highest": 1e-6, "high": 1e-6, "bf16": 1e-2}
ALGOS = ("pad", "lerp", "convolve", "hybrid", "truncated")


def _power(path, frames, t):
    if path == "time":
        return beamform.steered_power(frames, t)
    return freq_equiv.equiv_steered_power(frames,
                                          freq_equiv.make_equiv_tables(t))


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("algorithm", ALGOS)
@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("path", ["time", "freq_equiv"])
def test_tier_matches_oracle(tiny_cfg, path, tier, algorithm):
    cfg = tiny_cfg.replace(**TIERS[tier])
    local = np.random.default_rng(31)
    frames = np.stack([synth_frame(cfg, local) for _ in range(2)])
    ref = np.stack([oracle_heatmap(cfg, f.astype(np.float64), algorithm)
                    for f in frames])
    t = beamform.make_tables(cfg, algorithm, cache=False)
    assert _rel_err(_power(path, frames, t), ref) <= TOL[tier]


@pytest.mark.parametrize("case", ["squeeze", "odd_batch", "dead_mics"])
@pytest.mark.parametrize("path", ["time", "freq_equiv"])
def test_batch_squeeze_and_dead_mics(tiny_cfg, path, case):
    """A single (M, N) frame comes back (X, Y); an odd batch keeps its
    size and per-frame results; a dead-mic list (non-identity active
    gather) still matches the oracle."""
    cfg = tiny_cfg.replace(unused_mics=(1, 5)) if case == "dead_mics" \
        else tiny_cfg
    local = np.random.default_rng(37)
    frames = np.stack([synth_frame(cfg, local) for _ in range(5)])
    t = beamform.make_tables(cfg, "lerp", cache=False)
    if case == "squeeze":
        got = np.asarray(_power(path, frames[0], t))
        assert got.shape == (cfg.max_res_x, cfg.max_res_y)
        frames = frames[:1]
        got = got[None]
    else:
        got = np.asarray(_power(path, frames, t))
        assert got.shape == (5, cfg.max_res_x, cfg.max_res_y)
    if case == "dead_mics":
        assert len(np.asarray(t.adaptive)) == cfg.n_microphones - 2
    ref = np.stack([oracle_heatmap(cfg, f.astype(np.float64), "lerp")
                    for f in frames])
    assert _rel_err(got, ref) <= TOL["highest"]


class _ShapeTables:
    """Shape-only stand-in for ``beamform.SteeringTables``."""

    def __init__(self, D, T, M, N, precision):
        self.W = np.zeros((D, T, M), np.float32)
        self.n_samples = N
        self.tau_min = 0
        self.precision = precision


# (D, T, M, N) of the 64-ch/65x65 and the 256-ch/57x32 lerp tables
SHAPES = {"64ch_65x65": (4225, 19, 64, 256),
          "256ch_57x32": (1824, 49, 256, 256)}
EXPECT = {
    ("highest", "64ch_65x65"): "xla", ("highest", "256ch_57x32"): "xla",
    ("high", "64ch_65x65"): "xla",
    ("high", "256ch_57x32"): "freq_equiv",
    ("bf16", "64ch_65x65"): "xla", ("bf16", "256ch_57x32"): "freq_equiv",
}


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("tier", list(TIERS))
def test_select_power_backend(monkeypatch, tier, shape, backend):
    """Per tier and shape the policy returns what the H100 timings chose,
    and the platform never enters the decision."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(freq_equiv, "make_equiv_tables", lambda t: "et")
    t = _ShapeTables(*SHAPES[shape], TIERS[tier]["matmul_precision"])
    kind, obj = pipeline._select_power_backend(t)
    assert kind == EXPECT[(tier, shape)]
    assert obj == ("et" if kind == "freq_equiv" else None)
