"""zybo_rt_sampler_image_detection_tpu — an acoustic camera in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``acoustic-warfare/zybo-rt-sampler-image-detection``: real-time delay-and-sum
/ FFT-domain / MVDR beamforming over a microphone-array UDP stream, steered
audio playback, YOLO detection + SORT tracking, sensor fusion, and live
heatmap/web visualization — with the per-frame compute expressed as a small
number of jit-compiled device programs instead of forked C processes.

Quick start::

    import zybo_rt_sampler_image_detection_tpu as zrt
    cfg = zrt.Config()
    tables = zrt.ops.beamform.make_lerp_tables(cfg)
    heatmap = zrt.ops.beamform.steered_power(frame, tables)   # (X, Y)
"""

import os as _os

import jax as _jax

from . import paths as _paths

# Persistent XLA compilation cache: every CLI invocation is a fresh process
# and the reference-shape programs take seconds to compile.  JAX itself
# reads JAX_COMPILATION_CACHE_DIR when it is set; otherwise the cache sits
# at one fixed path inside the checkout (a moving path never hits).  CPU
# runs (the unit tests) keep it off.  Opt out with ZRT_NO_COMPILE_CACHE=1.
if (not _os.environ.get("JAX_COMPILATION_CACHE_DIR")
        and not _os.environ.get("ZRT_NO_COMPILE_CACHE")
        and (_jax.config.jax_platforms or "").lower() != "cpu"):
    _jax.config.update("jax_compilation_cache_dir",
                       _paths.cache_dir("jax_compile"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

from . import config as _config
from .config import Config, REFERENCE_DEAD_MICS
from . import ops
from . import ingest
from . import parallel
from . import utils
from . import models

__version__ = "0.1.0"
__all__ = ["Config", "REFERENCE_DEAD_MICS", "ops", "ingest", "parallel",
           "utils"]
