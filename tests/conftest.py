"""Test harness: everything runs on a virtual 8-device CPU mesh.

Unit tests validate numerics and sharding on the host CPU so they are fast
and hermetic; x64 lets the exactness gates compare against float64
references.  The card is checked by ``python chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# must run before any device is touched
jax.config.update("jax_platforms", "cpu")

# x64 lets exactness gates compare the device path against a float64 oracle
# with ~1e-12 tolerance; production code casts to float32 explicitly.
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

import zybo_rt_sampler_image_detection_tpu as zrt


@pytest.fixture(scope="session")
def tiny_cfg():
    return zrt.Config.tiny()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def synth_frame(cfg, rng, freq=8000.0, kind="mixed"):
    """Synthetic mic frame (n_microphones, n_samples) float32.

    ``kind='replicated'`` mirrors the reference's golden harness
    (``PC/plot.py:8-39``): the same sinusoid on every mic => the heatmap
    must peak at broadside.  ``kind='mixed'`` adds per-mic noise so the
    delay structure is exercised.
    """
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    sig = np.sin(2 * np.pi * freq * t).astype(np.float32)
    frame = np.tile(sig, (cfg.n_microphones, 1))
    if kind == "mixed":
        frame = frame + 0.3 * rng.standard_normal(
            (cfg.n_microphones, cfg.n_samples)
        ).astype(np.float32)
    return frame.astype(np.float32)


@pytest.fixture()
def frame(tiny_cfg, rng):
    return synth_frame(tiny_cfg, rng)
