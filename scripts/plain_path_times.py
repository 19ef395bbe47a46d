#!/usr/bin/env python
"""Time the plain-XLA heatmap paths on the accelerator, per tier and shape.

For the 64-ch/65x65 and 256-ch/57x32 (reference) shapes at B=512 frames,
times ``beamform.steered_power`` at the ``highest``/``high``/``bf16`` tiers
and ``freq_equiv.equiv_steered_power`` at ``high``/``bf16`` with
``block_until_ready``, then traces one call of each and reduces the trace
to the device ops that take the time.  Each result carries its model
FLOPs and bytes, and — for a device kind in ``PEAKS`` — the roofline
share of the call.  Refuses to run without an accelerator.

    python scripts/plain_path_times.py [--out chiprun_out/plain_path_times.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published dense peaks (NVIDIA H100 SXM data sheet): FLOP/s per matmul
# input type and device-memory bytes/s.  f32 outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32": 67e12, "tf32": 495e12,
                              "bf16": 989e12, "hbm": 3.35e12},
}

# the matmul input type each tier runs as on the GPU (f32 operands under
# HIGH/DEFAULT precision run as TF32; bf16 tables run bf16 operands);
# the equiv path keeps f32 planes, so its bf16 tier also runs TF32
TD_RATE = {"highest": "f32", "high": "tf32", "bf16": "bf16"}
EQ_RATE = {"high": "tf32", "bf16": "tf32"}


def trace_ops(fn, arg, top: int = 6) -> dict:
    """Run ``fn(arg)`` once under the profiler; return device busy time
    and the top device ops by summed duration (ns)."""
    import jax

    d = tempfile.mkdtemp(prefix="trace_")
    with jax.profiler.trace(d):
        jax.block_until_ready(fn(arg))
    path = sorted(glob.glob(f"{d}/**/*.xplane.pb", recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    by_op: dict = {}
    busy = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # XLA Modules / XLA Ops lines summarise the stream lines
            if line.name in ("XLA Modules", "XLA Ops", "XLA TraceMe",
                             "Source", "Steps"):
                continue
            for ev in line.events:
                by_op[ev.name] = by_op.get(ev.name, 0) + ev.duration_ns
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy.sort()
    total, end = 0.0, -1.0
    for s, e in busy:
        if e > end:
            total += e - max(s, end)
            end = e
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_ns": total,
            "top_ops_ns": [[name[:120], ns] for name, ns in ops]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/plain_path_times.json")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 2
    import zybo_rt_sampler_image_detection_tpu as zrt
    from zybo_rt_sampler_image_detection_tpu.config import TIERS
    from zybo_rt_sampler_image_detection_tpu.ops import beamform, freq_equiv
    from zybo_rt_sampler_image_detection_tpu.utils.profiling import card

    print(f"card: {card()}; jax {jax.__version__}; {dev.device_kind}",
          flush=True)
    peaks = PEAKS.get(dev.device_kind)
    B = args.batch
    rng = np.random.default_rng(0)
    results = []

    def timed(fn, x):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        compile_s = time.perf_counter() - t0
        per = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = fn(x)
            jax.block_until_ready(out)
            per.append((time.perf_counter() - t0) / args.iters)
        per.sort()
        return compile_s, per

    for shape, cfg0 in (("64ch_65x65", zrt.Config.northstar()),
                        ("256ch_57x32", zrt.Config())):
        frames = jax.device_put((rng.standard_normal(
            (B, cfg0.n_microphones, cfg0.n_samples)) * 0.05
        ).astype(np.float32))
        ref = None
        for tier, kw in TIERS.items():
            t = beamform.make_tables(cfg0.replace(**kw), "lerp")
            D, T, M = t.W.shape
            N = cfg0.n_samples
            paths = [("time", lambda f, t=t: beamform.steered_power(f, t),
                      2.0 * D * T * M * N * B,
                      # delay lines written + read, W, frames, maps
                      (2 * T * M * B * N + D * T * M) * t.W.dtype.itemsize
                      + 4 * (B * M * N + B * D), TD_RATE[tier])]
            if tier != "highest":
                et = freq_equiv.make_equiv_tables(t)
                _, M2, F = et.Hs1.shape
                paths.append((
                    "freq_equiv",
                    lambda f, et=et: freq_equiv.equiv_steered_power(f, et),
                    2.0 * 2 * M2 * N * F * B + 4.0 * D * M2 * F * B,
                    # spectra Br/Bi written + read twice, planes, frames
                    4 * (2 * 3 * B * D * F + 2 * D * M2 * F + B * M * N),
                    EQ_RATE[tier]))
            for path, fn, flops, nbytes, rate in paths:
                compile_s, per = timed(fn, frames)
                out = np.asarray(fn(frames), np.float64)
                if ref is None:
                    ref = out            # time-domain highest comes first
                err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
                med = per[len(per) // 2]
                rec = {
                    "shape": shape, "tier": tier, "path": path, "B": B,
                    "compile_s": compile_s, "batch_s_median": med,
                    "batch_s_all": per, "maps_per_s": B / med,
                    "model_flop": flops, "model_bytes": nbytes,
                    "matmul_type": rate,
                    "max_err_rel_to_highest_time": err,
                }
                if peaks:
                    bound = max(flops / peaks[rate], nbytes / peaks["hbm"])
                    rec["roofline_share"] = bound / med
                    rec["roofline_bound"] = ("compute"
                                             if flops / peaks[rate]
                                             >= nbytes / peaks["hbm"]
                                             else "memory")
                rec.update(trace_ops(fn, frames))
                results.append(rec)
                print(json.dumps({k: v for k, v in rec.items()
                                  if k != "batch_s_all"}), flush=True)
            del t
        del frames

    # what this card reaches on a large bf16 product and a large copy
    import jax.numpy as jnp
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda a: a @ a)
    _, per = timed(mm, a)
    bf16_rate = 2 * 8192 ** 3 / per[len(per) // 2]
    x = jnp.ones((256 * 2 ** 20,), jnp.float32)
    cp = jax.jit(lambda x: x * 1.0001)
    _, per = timed(cp, x)
    copy_bw = 2 * x.nbytes / per[len(per) // 2]
    ceil = {"bf16_matmul_flop_s": bf16_rate, "copy_bytes_s": copy_bw}
    print(json.dumps(ceil), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card(), "device_kind": dev.device_kind,
                   "jax": jax.__version__, "results": results,
                   "ceilings": ceil}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
