"""bench.py must run unattended on the accelerator — a NameError / API
drift in a late rung would surface only there, after the expensive rungs
had already burned their time.  ``--smoke`` runs every rung once at tiny
shapes on the forced-CPU backend; this gates it in CI (subprocess:
bench.py sets its own jax platform config)."""

import json
import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_bench_smoke_runs_every_rung():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # no virtual-device fan-out needed
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py"), "--smoke"],
        capture_output=True, text=True, cwd=repo, timeout=540, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    assert rec["metric"] == "steered_power_heatmaps_per_sec_64ch_65x65"
    assert rec["value"] > 0
    # every ladder rung must have produced a number
    assert rec["device"]["platform"] == "cpu"
    for rung in ("highest", "high", "bf16", "highest_xla", "high_xla",
                 "bf16_xla", "high_equiv_exact", "bf16_equiv_exact", "pad",
                 "convolve", "hybrid", "truncated",
                 "lerp_reference_shape_57x32_256ch",
                 "lerp_reference_shape_equiv_exact",
                 "fft_bartlett_reference_shape",
                 "live_loop_device_proxy_fps",
                 "mvdr_rls_per_frame_reference_shape",
                 "mvdr_exact_per_frame_maps_reference_shape",
                 "fused_display_cycle_fps_device_proxy"):
        assert f"# rung {rung}:" in out.stderr, f"missing rung {rung}"
