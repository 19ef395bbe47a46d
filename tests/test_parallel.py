"""Sharded beamforming on the virtual 8-device CPU mesh: numerics must be
identical to single-device, for pure-DP, pure-model, and mixed meshes."""

import numpy as np
import pytest

from zybo_rt_sampler_image_detection_tpu.ops import beamform
from zybo_rt_sampler_image_detection_tpu.parallel import mesh as pmesh

from conftest import synth_frame

import jax


@pytest.mark.parametrize("shape", [(8, 1), (1, 8), (4, 2)])
def test_sharded_matches_single(tiny_cfg, rng, shape):
    n_data, n_model = shape
    frames = np.stack([synth_frame(tiny_cfg, rng) for _ in range(8)])
    tables = beamform.make_lerp_tables(tiny_cfg)
    ref = np.asarray(beamform.steered_power(frames, tables))

    m = pmesh.make_mesh(n_data, n_model)
    st = pmesh.shard_tables(tables, m)
    fn = pmesh.sharded_steered_power(m, st)
    got = np.asarray(fn(frames))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)


def test_mesh_uses_all_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    m = pmesh.make_mesh()
    assert m.devices.size == 8


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_sharded_equiv_matches_single(tiny_cfg, rng, shape):
    """The exact frequency-domain reformulation (the production ``high``
    path) sharded data x model — direction-padded stacked planes, sliced
    before the reshape — must equal the single-device time-domain exact
    path."""
    from zybo_rt_sampler_image_detection_tpu.ops import freq_equiv

    n_data, n_model = shape
    frames = np.stack([synth_frame(tiny_cfg, rng) for _ in range(8)])
    tables = beamform.make_lerp_tables(tiny_cfg)
    ref = np.asarray(beamform.steered_power(frames, tables))

    et = freq_equiv.make_equiv_tables(tables)
    m = pmesh.make_mesh(n_data, n_model)
    # tiny grid D is not a multiple of 4 -> the zero-pad path engages
    set_ = pmesh.shard_equiv_tables(et, m)
    assert set_.Hs1.shape[0] % n_model == 0
    fn = pmesh.sharded_equiv_power(m, set_)
    got = np.asarray(fn(frames))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-8)
    # and matches the single-device equiv path up to reassociation
    single = np.asarray(freq_equiv.equiv_steered_power(frames, et))
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-9)


def test_sharded_fft_power_matches_single(tiny_cfg, rng):
    """Frequency bins sharded over ``model`` (with repeat-padding + zero
    weights masking the duplicates) must reproduce the single-device
    Bartlett map exactly."""
    from zybo_rt_sampler_image_detection_tpu.ops import freq

    frames = np.stack([synth_frame(tiny_cfg, rng) for _ in range(8)])
    t = freq.make_freq_tables(tiny_cfg, 100.0)
    ref = np.asarray(freq.fft_steered_power(frames, t))

    m = pmesh.make_mesh(2, 4)
    fn = pmesh.sharded_fft_power(m, t)
    np.testing.assert_allclose(np.asarray(fn(frames)), ref,
                               rtol=1e-6, atol=1e-12)


def test_sharded_mvdr_matches_single(tiny_cfg, rng):
    """Streaming-MVDR state sharded by bins over the whole mesh: the RLS
    update + Capon map must match single-device numerics, with padded
    (duplicated) bins masked out of the map."""
    from zybo_rt_sampler_image_detection_tpu.ops import freq

    frames = np.stack([synth_frame(tiny_cfg, rng) for _ in range(4)])
    t = freq.make_freq_tables(tiny_cfg, 100.0)
    st0 = freq.init_precision(t)
    st0 = freq.update_precision(st0, frames, t)
    ref = np.asarray(freq.mvdr_power_precision(st0, t))

    m = pmesh.make_mesh(4, 2)
    tp, w = pmesh.shard_freq_tables(t, m, axes=("data", "model"))
    sp = pmesh.shard_precision_state(freq.init_precision(tp), m)
    sp = freq.update_precision(sp, frames, tp)
    got = np.asarray(freq.mvdr_power_precision(sp, tp, "high", w))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-10)

    # the rank-B Woodbury block update shards the same way (all per-bin
    # ops + a per-bin (B, B) solve)
    st_b = freq.init_precision(t)
    st_b = freq.update_precision_block(st_b, frames, t)
    ref_b = np.asarray(freq.mvdr_power_precision(st_b, t))
    sp_b = pmesh.shard_precision_state(freq.init_precision(tp), m)
    sp_b = freq.update_precision_block(sp_b, frames, tp)
    got_b = np.asarray(freq.mvdr_power_precision(sp_b, tp, "high", w))
    np.testing.assert_allclose(got_b, ref_b, rtol=1e-5, atol=1e-10)

    # the subspace-recursive per-frame map scan too (padded bins masked
    # out of each frame's map by the bin weights)
    maps_ref, _ = freq.mvdr_maps_scan(freq.init_precision(t), frames, t)
    maps_sh, _ = freq.mvdr_maps_scan(
        pmesh.shard_precision_state(freq.init_precision(tp), m), frames,
        tp, bin_weights=w)
    np.testing.assert_allclose(np.asarray(maps_sh), np.asarray(maps_ref),
                               rtol=1e-4, atol=1e-9)


def test_sharded_matches_single_hybrid(tiny_cfg, rng):
    """Model-sharding with the hybrid algorithm exercises the 4-D
    correction tensor partitioning."""
    frames = np.stack([synth_frame(tiny_cfg, rng) for _ in range(4)])
    tables = beamform.make_tables(tiny_cfg, "hybrid", cache=False)
    ref = np.asarray(beamform.steered_power(frames, tables))
    m = pmesh.make_mesh(2, 4)
    st = pmesh.shard_tables(tables, m)
    got = np.asarray(pmesh.sharded_steered_power(m, st)(frames))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# Reference-shape multi-device validation: the tiny config cannot stress
# the direction-axis padding or the odd (127) bin count's padded-bin
# masking — these run the real shapes.
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sharded_reference_shape_parity(rng):
    """Data x model sharding at the TRUE reference shape (57x32 grid, 256
    mics, lerp T=49): numerics equal to single-device."""
    import zybo_rt_sampler_image_detection_tpu as zrt

    cfg = zrt.Config()
    tables = beamform.make_tables(cfg, "lerp", cache=True)
    frames = np.stack([
        (rng.standard_normal((cfg.n_microphones, cfg.n_samples)) * 0.05
         ).astype(np.float32) for _ in range(2)])
    ref = np.asarray(beamform.steered_power(frames, tables))

    m = pmesh.make_mesh(2, 4)
    st = pmesh.shard_tables(tables, m)
    fn = pmesh.sharded_steered_power(m, st)
    got = np.asarray(fn(frames))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)


@pytest.mark.slow
def test_sharded_mvdr_real_127_bins(tiny_cfg, rng):
    """mvdr_maps_scan sharded at the REAL reference bin count: N=256 full
    band gives 127 bins (odd), so sharding over 8 devices pads to 128 with
    a repeated bin — the bin-weight masking must keep the per-frame maps
    equal to single-device."""
    from zybo_rt_sampler_image_detection_tpu.ops import freq

    cfg = tiny_cfg.replace(n_samples=256)
    t = freq.make_freq_tables(cfg, 100.0)
    F = t.hi - t.lo
    assert F == 127, F                       # the reference bin count
    frames = np.stack([
        (rng.standard_normal((cfg.n_microphones, cfg.n_samples)) * 0.1
         ).astype(np.float32) for _ in range(4)])

    maps_ref, st_ref = freq.mvdr_maps_scan(freq.init_precision(t), frames, t)

    m = pmesh.make_mesh(2, 4)
    tp, w = pmesh.shard_freq_tables(t, m, axes=("data", "model"))
    assert tp.phase_re.shape[0] == 128       # odd F really padded
    sp = pmesh.shard_precision_state(freq.init_precision(tp), m)
    maps_sh, sp2 = freq.mvdr_maps_scan(sp, frames, tp, bin_weights=w)
    np.testing.assert_allclose(np.asarray(maps_sh), np.asarray(maps_ref),
                               rtol=1e-4, atol=1e-9)
    # the updated sharded state keeps matching on a second batch
    frames2 = frames * 1.1
    maps_ref2, _ = freq.mvdr_maps_scan(st_ref, frames2, t)
    maps_sh2, _ = freq.mvdr_maps_scan(sp2, frames2, tp, bin_weights=w)
    np.testing.assert_allclose(np.asarray(maps_sh2), np.asarray(maps_ref2),
                               rtol=1e-4, atol=1e-9)
