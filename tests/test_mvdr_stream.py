"""Unit tests for ``pipeline.make_mvdr_stream`` — the shared streaming-MVDR
state machine (round 3 deduplicated it out of demo/web/pipeline; these
gates pin the factory's semantics so the four production sites stay in
lockstep).  Ref: ``api.c:576-581`` (live steer), ``api.c:491-543``
(miso_loop)."""

import numpy as np

from zybo_rt_sampler_image_detection_tpu.apps.pipeline import make_mvdr_stream
from zybo_rt_sampler_image_detection_tpu.ops import freq

from conftest import synth_frame


def _batches(cfg, rng, n_batches, b=8):
    out = []
    for i in range(n_batches):
        f = synth_frame(cfg, rng, kind="mixed")
        batch = np.stack([f] * b) + 0.05 * rng.standard_normal(
            (b, cfg.n_microphones, cfg.n_samples)).astype(np.float32)
        out.append(batch.astype(np.float32))
    return out


def _direction(cfg):
    return (cfg.max_res_x // 2) * cfg.max_res_y + cfg.max_res_y // 2


def test_kinds_agree(tiny_cfg, rng):
    """The three fused per-call programs share one state trajectory: maps
    from 'maps' and 'maps_beams' are the same scan; beams from 'beams'
    (rank-B Woodbury block update) match 'maps_beams' (chunked scan) up
    to the f32 reassociation the freq-level tests gate at 1e-4."""
    cfg = tiny_cfg
    d = _direction(cfg)
    batches = _batches(cfg, np.random.default_rng(7), 4)

    fm = make_mvdr_stream(cfg, "maps")
    fb = make_mvdr_stream(cfg, "beams")
    fmb = make_mvdr_stream(cfg, "maps_beams")
    for f in (fm, fb, fmb):
        f.reset()
    for batch in batches:
        maps = np.asarray(fm(batch), np.float64)
        beams = np.asarray(fb(batch, d), np.float64)
        maps2, beams2 = fmb(batch, d)
        maps2 = np.asarray(maps2, np.float64)
        beams2 = np.asarray(beams2, np.float64)
        assert maps.shape == (batch.shape[0], cfg.max_res_x, cfg.max_res_y)
        assert beams.shape == (batch.shape[0], cfg.n_samples)
        assert np.isfinite(maps).all() and np.isfinite(beams).all()
        np.testing.assert_allclose(maps2, maps, rtol=1e-4, atol=1e-9)
        scale = np.abs(beams).max()
        np.testing.assert_allclose(beams2 / scale, beams / scale,
                                   rtol=5e-3, atol=5e-4)


def test_refresh_and_carry_cadence(tiny_cfg, rng):
    """The alpha-aware cadence actually fires: streaming past
    ``refresh_interval`` frames triggers the exact Cholesky refresh
    (state['r'] advances) and the carried a^H P a quadratic form is
    re-measured every ``d0_carry_interval`` frames (state['dqc'] wraps)."""
    cfg = tiny_cfg
    fn = make_mvdr_stream(cfg, "maps")
    fn.reset()
    refresh_every = freq.refresh_interval(0.9)
    carry_max = freq.d0_carry_interval(0.9)
    b = 8
    n_batches = refresh_every // b + 2
    seen_dqc = []
    for batch in _batches(cfg, np.random.default_rng(3), n_batches, b=b):
        fn(batch)
        seen_dqc.append(fn.state["dqc"])
    assert fn.state["n"] == n_batches * b
    # the refresh fired at least once and re-anchored the epoch
    assert fn.state["r"] >= refresh_every
    assert fn.state["n"] - fn.state["r"] < refresh_every
    # the d0 carry never exceeded its budget before a re-measure
    assert max(seen_dqc) <= carry_max + b
    assert min(seen_dqc) == b        # at least one re-measure happened


def test_reset_determinism(tiny_cfg, rng):
    """fn.reset() restores the exact initial state: replaying the same
    stream reproduces bit-identical outputs (the replay-determinism
    contract the recording subsystem relies on)."""
    cfg = tiny_cfg
    batches = _batches(cfg, np.random.default_rng(11), 3)
    fn = make_mvdr_stream(cfg, "maps")
    fn.reset()
    first = [np.asarray(fn(b)) for b in batches]
    fn.reset()
    second = [np.asarray(fn(b)) for b in batches]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_stream_declares_in_program_padding(tiny_cfg):
    """The batched stages must not prepend their own pad prologue (an
    extra dispatch per batch) — the stream pads inside its
    fused program and says so."""
    fn = make_mvdr_stream(tiny_cfg, "maps")
    assert fn.pads_in_program is True


def test_heatmap_warmup_resets_stateful_backend(tiny_cfg):
    """start_heatmap's zero-frame warmup must not pollute a stateful
    power_fn: a zeros frame scales P by alpha^-1 and consumes the
    covariance first-frame replacement, skewing early Capon maps until
    the first refresh (review finding, round 3)."""
    from zybo_rt_sampler_image_detection_tpu.apps.pipeline import Pipeline
    import zybo_rt_sampler_image_detection_tpu as zrt

    cfg = zrt.Config.tiny().replace(udp_port=21931)
    fn = make_mvdr_stream(cfg, "maps")
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True,
                 backend="python", power_fn=fn)
    try:
        s = p.start_heatmap(warmup=True)
        assert s.power_fn is fn
        assert fn.state["n"] == 0          # warmup pollution dropped
    finally:
        p.stop()


def test_single_frame_live_path(tiny_cfg, rng):
    """kind='maps' also serves the live single-frame loop: an (M, N)
    frame takes the per-frame recursion, returns an (X, Y) map, and
    invalidates the carried quadratic form (P moved outside the carried
    recursion)."""
    cfg = tiny_cfg
    fn = make_mvdr_stream(cfg, "maps")
    fn.reset()
    batch = _batches(cfg, np.random.default_rng(5), 1)[0]
    fn(batch)                               # seed a carried dq
    assert fn.state["dq"] is not None
    m = np.asarray(fn(batch[0]))
    assert m.shape == (cfg.max_res_x, cfg.max_res_y)
    assert np.isfinite(m).all()
    assert fn.state["dq"] is None
    assert fn.state["n"] == batch.shape[0] + 1
    # and the next batched call recovers (re-measures dq)
    m2 = np.asarray(fn(batch))
    assert np.isfinite(m2).all() and fn.state["dq"] is not None
