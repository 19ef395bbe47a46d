"""Device tracing — upgrade of the reference's ``clock()``-behind-#if-DEBUG
profiling (``api.c:500-536``).

``trace("...")`` wraps a region in a ``jax.profiler`` trace (viewable in
TensorBoard / Perfetto); ``annotate`` marks named sub-regions on the device
timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def trace(logdir: str = "/tmp/zrt_trace",
          create_perfetto_link: bool = False) -> Iterator[str]:
    """Capture a jax.profiler trace around the with-block."""
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region on the device timeline (TraceAnnotation)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class Stopwatch:
    """Cheap wall-clock section timer for host-side stages."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections.setdefault(name, []).append(
                time.perf_counter() - t0)

    def report(self):
        return {k: {"n": len(v), "total_s": round(sum(v), 4),
                    "mean_ms": round(1e3 * sum(v) / len(v), 3)}
                for k, v in self.sections.items()}


def card() -> str:
    """``name, power.limit`` of the GPU as nvidia-smi reports them — the
    line every measurement is recorded beside (a card below its power
    limit maximum runs slower under load)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out or "nvidia-smi: no output"
