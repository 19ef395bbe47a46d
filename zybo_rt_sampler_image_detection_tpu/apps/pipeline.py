"""Single-process real-time pipeline.

The reference spreads one dataflow across five+ processes (fork'd C
receiver, fork'd MISO child, multiprocessing producers, YOLO process,
viewer — ``main.pyx:669-736``, SURVEY.md §3.2).  Here each stage is a
thread around a jitted device program, sharing queues with the reference's
drop-oldest backpressure (``main.pyx:639-650``); XLA's async dispatch gives
the pipeline overlap the process pool was simulating.

Stages:
* :class:`HeatmapProducer` — fresh frame -> steered-power map -> q_power
  (the ``_loop_mimo_*`` producers, ``main.pyx:172-380``);
* :class:`MisoProducer`    — fresh frame -> steered beam -> gain -> audio
  sink, steerable live (``api.c:491-543`` miso_loop);
* :class:`CameraProducer`  — camera frames -> q_viewer + q_yolo
  (``main.pyx:614-661`` camera_reader);
* :class:`TrackerStage`    — q_yolo -> YOLO+SORT overlay -> q_inference.

Steering: :meth:`Pipeline.steer_cartesian_degree` /
:meth:`Pipeline.steer_click` mirror ``main.pyx:498-528`` without the
recompile (the direction index is a traced argument).
"""

from __future__ import annotations

import queue
import threading
import time
from functools import partial
from typing import Optional

import jax
import numpy as np

from ..config import Config
from ..ingest.receiver import Receiver
from ..ops import beamform
from ..utils import audio as audio_mod
from ..utils.metrics import PipelineMetrics


def put_drop_oldest(q: queue.Queue, item) -> bool:
    """The reference's backpressure: full queue -> drop the oldest
    (``main.pyx:639-650``).  Returns False if the item was dropped instead."""
    try:
        q.put_nowait(item)
        return True
    except queue.Full:
        try:
            q.get_nowait()
        except queue.Empty:
            pass
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            return False


# Smallest time-domain/frequency-domain MAC ratio T*N/(4F) at which the
# exact frequency-domain path (``ops.freq_equiv``) is chosen for the
# ``high`` and ``bf16`` tiers (``highest`` keeps the time-domain path for
# its bit-level contract).  Set from H100 timings of both paths at B=512
# (PERF.md): at the 64-ch/65x65 shape (ratio 8.7) the time path is as
# fast or faster — high 5.61 vs 5.86 ms, bf16 3.61 vs 5.58 ms on a 700 W
# card — and at 256-ch/57x32 (ratio 20.4) the frequency path wins 5.1 vs
# 23.6 ms (high) and 5.1 vs 15.0 ms (bf16).  No shape between the two was
# measured; 13 splits them.
_EQUIV_MIN_MAC_RATIO = 13.0

# The stacked (D, 2M, F) response planes cost ~12x the time-domain W in
# device memory (862 MB at the reference shape); above this the tables
# would crowd the batch buffers, so the time-domain path serves instead.
_EQUIV_MAX_PLANE_BYTES = 2.4e9


def _select_power_backend(tables):
    """The one backend policy for every heatmap stage.

    Returns ``(kind, obj)``: ``("freq_equiv", EquivFreqTables)`` — the
    exact frequency-domain reformulation — or ``("xla", None)`` — the
    time-domain delay-line contraction (``beamform.steered_power``).

    Per direction the time path costs ~T*M*N MACs and the frequency path
    ~4*M*F (F = padded rfft bins), so their ratio T*N/(4F) grows with the
    delay spread T.  The frequency path is taken below the ``highest``
    tier when the ratio clears ``_EQUIV_MIN_MAC_RATIO`` and the response
    planes fit ``_EQUIV_MAX_PLANE_BYTES``.  The choice depends only on the
    tables, never on the platform.
    """
    from ..ops import freq_equiv

    if tables.precision == "highest":
        return "xla", None
    D, T, M = tables.W.shape
    _, F = freq_equiv.equiv_dims(tables)
    if (T * tables.n_samples < _EQUIV_MIN_MAC_RATIO * 4 * F
            or 16 * D * M * F > _EQUIV_MAX_PLANE_BYTES):
        return "xla", None
    return "freq_equiv", freq_equiv.make_equiv_tables(tables)


def default_power_fn(tables):
    """Production heatmap program for ``tables`` under the backend policy
    (:func:`_select_power_backend`).  The returned callable accepts single
    ``(M, N)`` frames AND ``(B, M, N)`` batches (the live loop warms up on
    a 2-D zeros frame)."""
    kind, obj = _select_power_backend(tables)
    if kind == "freq_equiv":
        from ..ops import freq_equiv

        return lambda f: freq_equiv.equiv_steered_power(f, obj)
    return lambda f: beamform.steered_power(f, tables)


def _pad_full(frames, n_full):
    """Device-program prologue shared by the full-rate stages: upcast
    f16-transfer batches and pad channel-sliced transfers back to the
    full mic axis (the tail rows are always zero)."""
    frames = frames.astype(jax.numpy.float32)
    pad = n_full - frames.shape[1]
    if pad > 0:
        frames = jax.numpy.pad(frames, ((0, 0), (0, pad), (0, 0)))
    return frames


def _power_program_parts(tables):
    """The production backend policy (:func:`_select_power_backend`) as a
    jit-safe ``(trace_fn, extra_args)`` pair: ``trace_fn(frames_padded,
    *extra_args) -> (B, X, Y)``.  All tables travel through
    ``extra_args`` so every caller passes them to its jit as ARGUMENTS
    (tables baked in as constants bloat the compile).  Shared by
    :class:`BatchedHeatmapProducer` and the combined imaging+listening
    stage so the two full-rate paths cannot drift."""
    kind, obj = _select_power_backend(tables)
    if kind == "freq_equiv":
        from ..ops import freq_equiv

        return freq_equiv.equiv_steered_power, (obj,)
    return beamform.steered_power, (tables,)


def _batched_power_program(tables, n_full):
    """ONE jitted ``(B, Mc, N) -> (B, X, Y)`` device program running the
    production backend policy, with the :func:`_pad_full` prologue."""
    tr, extra = _power_program_parts(tables)

    @jax.jit
    def _power(frames, *args):
        return tr(_pad_full(frames, n_full), *args)

    return lambda frames: _power(frames, *extra)


def _sharded_power_program(mesh, tables):
    """Multi-device twin of :func:`_batched_power_program`: the same
    production backend policy, XLA SPMD over the mesh — frames arrive
    committed to a (data, None, None) NamedSharding (the stage's
    ``_to_device`` places them), the direction axis shards over
    ``model``.  Full-width f32 frames only (channel slicing would pad
    before the shard boundary)."""
    from ..parallel import mesh as mesh_mod
    kind, obj = _select_power_backend(tables)
    if kind == "freq_equiv":
        return mesh_mod.sharded_equiv_power(
            mesh, mesh_mod.shard_equiv_tables(obj, mesh))
    return mesh_mod.sharded_steered_power(
        mesh, mesh_mod.shard_tables(tables, mesh))


def make_mvdr_stream(cfg: Config, kind: str = "maps", alpha: float = 0.9,
                     band_low: float = 100.0):
    """The streaming-MVDR state machine shared by every production site
    (``demo --algorithm mvdr``, web backend 4, the full-rate listening
    stage, and the combined imaging+listening stage) — ONE
    implementation of the drift-critical cadence logic:

    * **alpha-aware exact refresh**: every Sherman–Morrison/Woodbury
      step divides P by alpha, so f32 drift amplifies ~1/alpha per
      frame; an exact Cholesky refresh runs every
      ``freq.refresh_interval(alpha)`` frames (a fixed 256-frame
      interval NaN'd out around frame 110 at alpha=0.9).
    * **carried quadratic form**: the ``a^H P a`` evaluation (~84% of a
      16-frame block's FLOPs at the reference shape) is carried across
      batched calls and re-measured every
      ``freq.d0_carry_interval(alpha)`` frames — the carried
      correction's error also amplifies 1/alpha per frame.
    * **reset/warmup** (``fn.reset()``): drop warmup pollution (a zero
      block scales P by alpha^-B) and compile the periodic programs
      upfront — a mid-run first compile stalls the full-rate stage for
      seconds.

    ``kind`` selects the fused per-call device program (pad/upcast +
    state update + outputs run as ONE program, one dispatch per call):

    * ``"maps"``: ``fn(frames (B, M, N)) -> (B, X, Y)`` exact per-frame
      Capon maps (``freq.mvdr_maps_scan``); also accepts a single
      ``(M, N)`` frame -> ``(X, Y)`` via the per-frame recursion (the
      live loop).
    * ``"beams"``: ``fn(frames, direction) -> (B, N)`` adaptive
      distortionless listening beams (``freq.mvdr_listen_step``).
    * ``"maps_beams"``: ``fn(frames, direction) -> (maps, beams)`` —
      one streaming-inverse update shared between the Capon maps and
      the beam weights (one host->device transfer serves both).

    Channel-sliced / f16 batches are padded back to the full mic axis
    in-program.  Returns ``fn`` with ``fn.reset()`` and ``fn.tables``.
    Ref: ``api.c:576-581`` (live steer), ``api.c:491-543`` (miso_loop).
    """
    from ..ops import freq

    ft = freq.make_freq_tables(cfg, band_low)
    n_full = cfg.n_microphones
    state = {"p": freq.init_precision(ft), "n": 0, "r": 0,
             "dq": None, "dqc": 0, "bshape": None}
    refresh_every = freq.refresh_interval(alpha)
    carry_max = freq.d0_carry_interval(alpha)
    uses_d0 = kind in ("maps", "maps_beams")

    if kind == "maps_beams":
        @partial(jax.jit, static_argnames=("alpha",))
        def _core(st, dq, frames, t, d, alpha):
            frames = _pad_full(frames, n_full)
            maps, st2, dq2 = freq.mvdr_maps_scan(
                st, frames, t, alpha=alpha, d0=dq, return_d=True)
            beams = freq.mvdr_beam_precision(st2, t, frames, d)
            return (maps, beams), st2, dq2

    elif kind == "maps":
        @partial(jax.jit, static_argnames=("alpha",))
        def _core(st, dq, frames, t, alpha):
            maps, st2, dq2 = freq.mvdr_maps_scan(
                st, _pad_full(frames, n_full), t, alpha=alpha, d0=dq,
                return_d=True)
            return maps, st2, dq2
    elif kind == "beams":
        @partial(jax.jit, static_argnames=("alpha",))
        def _core(st, frames, t, d, alpha):
            return freq.mvdr_listen_step(st, _pad_full(frames, n_full),
                                         t, d, alpha=alpha)
    else:
        raise ValueError(f"unknown mvdr stream kind {kind!r}")

    def _carried_dq():
        if state["dq"] is None or state["dqc"] >= carry_max:
            state["dq"] = freq.mvdr_d0(state["p"], ft)
            state["dqc"] = 0
        return state["dq"]

    def _tick(k: int):
        state["n"] += k
        state["dqc"] += k
        if state["n"] - state["r"] >= refresh_every:
            state["p"] = freq.refresh_precision(state["p"], ft)
            state["dq"] = None         # re-measure from the refreshed P
            state["r"] = state["n"]

    if kind == "beams":
        def fn(frames, direction):
            beams, state["p"] = _core(state["p"], frames, ft, direction,
                                      alpha=alpha)
            _tick(frames.shape[0])
            return beams
    elif kind == "maps_beams":
        def fn(frames, direction):
            out, state["p"], state["dq"] = _core(
                state["p"], _carried_dq(), frames, ft, direction,
                alpha=alpha)
            _tick(frames.shape[0])
            return out
    else:
        def fn(frames):
            if frames.ndim == 3:
                maps, state["p"], state["dq"] = _core(
                    state["p"], _carried_dq(), frames, ft, alpha=alpha)
                _tick(frames.shape[0])
            else:
                state["p"] = freq.update_precision(state["p"], frames,
                                                   ft, alpha=alpha)
                state["dq"] = None  # P moved outside the carried recursion
                maps = freq.mvdr_power_precision(state["p"], ft)
                _tick(1)
            return maps

    def reset():
        state["p"] = freq.init_precision(ft)
        freq.refresh_precision(state["p"], ft).P_re.block_until_ready()
        if uses_d0:
            freq.mvdr_d0(state["p"], ft).block_until_ready()
        state["dq"] = None
        state["n"] = state["r"] = state["dqc"] = 0

    fn.reset = reset
    fn.tables = ft
    fn.state = state
    # embedded-state consumers (FusedSensorStage's in-program listening)
    # run the per-call device step themselves but MUST share this exact
    # cadence: set state["p"] to the post-batch state, then tick(k)
    fn.tick = _tick
    fn.alpha = alpha
    # batched calls pad/upcast channel-sliced or f16 transfers inside the
    # fused device program — the batched stages must NOT prepend their
    # own pad prologue (an extra dispatch per batch)
    fn.pads_in_program = True
    return fn


class Stage(threading.Thread):
    def __init__(self, name: str, metrics: PipelineMetrics):
        super().__init__(name=name, daemon=True)
        self.stop_event = threading.Event()
        self.metric = metrics.stage(name)

    def stop(self):
        self.stop_event.set()


class HeatmapProducer(Stage):
    def __init__(self, receiver: Receiver, tables, q_power: queue.Queue,
                 metrics: PipelineMetrics, power_fn=None):
        super().__init__("heatmap", metrics)
        self.receiver = receiver
        self.tables = tables
        self.q_power = q_power
        self.power_fn = power_fn or default_power_fn(tables)

    def run(self):
        seq = 0
        while not self.stop_event.is_set():
            try:
                frame, seq = self.receiver.read_frame(fresh=True,
                                                      last_seq=seq,
                                                      timeout=1.0)
            except TimeoutError:
                continue
            t0 = time.perf_counter()
            power = np.asarray(self.power_fn(frame))
            self.metric.tick(time.perf_counter() - t0)
            if not put_drop_oldest(self.q_power, (power, seq)):
                self.metric.drop()


class BatchedStage(Stage):
    """Shared machinery for the full-rate stages: drain the receiver's
    frame ring in counter-contiguous K-frame batches, double-buffer the
    device pipeline (batch *i+1* is transferred — ``jax.device_put``,
    async — and dispatched while batch *i*'s result synchronizes), and
    hand each completed batch to :meth:`consume`.

    Subclasses implement ``launch(frames_dev) -> device output (pytree)``
    (must not block) and ``consume(host_output, first_seq, skipped)``.
    Accounting: ``processed`` frames through the device, ``skipped``
    frames the ring overwrote unread (0 = full rate sustained),
    ``metric`` per-batch latency.
    """

    def __init__(self, name: str, receiver: Receiver,
                 metrics: PipelineMetrics, batch: int, channels: int = 0,
                 transfer: str = "f32", max_rate: float = 0.0,
                 mesh=None):
        super().__init__(name, metrics)
        # multi-chip ingest fan-in (SURVEY §2.4): batches transfer with a
        # batch-over-"data" NamedSharding so the launch runs SPMD over
        # the mesh with no gather before the device program
        self.sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            n_data = mesh.shape["data"]
            if batch % n_data:
                raise ValueError(
                    f"batch ({batch}) must divide the data axis "
                    f"({n_data}) for sharded transfers")
            self.sharding = NamedSharding(
                mesh, PartitionSpec("data", None, None))
        if batch > receiver.ring_frames:
            # fail fast: read_batch would raise inside the stage thread,
            # killing it silently while the pipeline runs output-less
            raise ValueError(
                f"batch ({batch}) exceeds the receiver ring capacity "
                f"({receiver.ring_frames}); raise Pipeline(ring_frames=)")
        self.receiver = receiver
        self.batch = batch
        self.channels = channels
        self.processed = 0
        self.skipped = 0
        # "f16" halves host->device traffic (~1e-3 relative error on the
        # 24-bit-normalized samples) — an explicit display-grade opt-in
        # for bandwidth-bound hosts; device programs upcast to f32 on
        # arrival.  Default stays exact f32.
        self.transfer_dtype = {"f32": np.float32,
                               "f16": np.float16}[transfer]
        # max_rate (frames/s, 0 = line rate): throttle the stage so it
        # deliberately lets the ring overwrite frames it skips (counted
        # in `skipped`).  Display consumers need ~2x the viewer fps, not
        # line rate, and an uncapped stage competes for the host<->device
        # link with the camera uploads and composite downloads.
        self.max_rate = float(max_rate)
        self._rate_t0 = None
        # subclasses that need per-frame ring publish times (the audio
        # e2e latency contract) set this before start()
        self.want_stamps = False

    def _to_device(self, batch: np.ndarray):
        if self.transfer_dtype is not np.float32:
            batch = batch.astype(self.transfer_dtype)
        if self.sharding is not None:
            return jax.device_put(batch, self.sharding)
        return jax.device_put(batch)

    def launch(self, frames_dev):
        raise NotImplementedError

    def consume(self, out, first_seq: int, skipped: int,
                stamps=None) -> None:
        raise NotImplementedError

    def warmup(self):
        """Compile the device program(s) before any packets flow (a
        mid-run first compile stalls the stage and drops frames)."""
        n_ch = self.channels or self.receiver.cfg.n_microphones
        zeros = np.zeros((self.batch, n_ch, self.receiver.cfg.n_samples),
                         np.float32)
        jax.tree.map(np.asarray, self.launch(self._to_device(zeros)))

    def _finish(self, pending):
        out, first, skipped, t0, stamps = pending
        host = jax.tree.map(np.asarray, out)           # sync batch i-1
        self.metric.tick(time.perf_counter() - t0)
        if skipped:
            self.skipped += skipped
            self.metric.drop(skipped)
        self.processed += self.batch
        self.consume(host, first, skipped, stamps)

    def run(self):
        # stream-start anchor: consume everything the ring still holds,
        # but a pre-start backlog beyond the ring (connect -> warmup can
        # span a long compile) must not count as skips
        next_seq = self.receiver.stream_anchor_seq
        pending = None
        while not self.stop_event.is_set():
            if self.max_rate and self._rate_t0 is not None:
                ahead = (self.processed / self.max_rate
                         - (time.perf_counter() - self._rate_t0))
                if ahead > 0.0:
                    if pending is not None:
                        self._finish(pending)   # sync while throttled
                        pending = None
                    time.sleep(min(ahead, 0.5))
            try:
                res = self.receiver.read_batch(
                    self.batch, next_seq, timeout=0.5,
                    channels=self.channels, with_stamps=self.want_stamps)
            except TimeoutError:
                if pending is not None:
                    self._finish(pending)
                    pending = None
                continue
            batch, first, skipped = res[:3]
            stamps = res[3] if self.want_stamps else None
            next_seq = first + self.batch
            if self._rate_t0 is None:
                self._rate_t0 = time.perf_counter()
            t0 = time.perf_counter()
            dev = self._to_device(batch)       # async H2D, double-buffered
            out = self.launch(dev)             # async dispatch
            if pending is not None:
                self._finish(pending)          # sync batch i-1, in order
            pending = (out, first, skipped, t0, stamps)
        if pending is not None:
            self._finish(pending)


class BatchedHeatmapProducer(BatchedStage):
    """Full-line-rate heatmap stage: EVERY frame beamformed, not
    latest-frame sampling.

    The reference's consumer snapshots whichever frame is newest
    (``get_data``, ``api.c:830-859``) and silently discards the rest even
    though the receiver writes all of them (``receiver.c:94-151``).  This
    stage drains the receiver's frame ring in counter-contiguous batches
    of K, runs ONE batched ``(K, M, N) -> (K, X, Y)`` device launch, and
    delivers every heatmap.  The device pipeline is double-buffered: batch
    *i+1* is transferred (``jax.device_put``, async) and dispatched while
    batch *i*'s result is synchronized.

    ``sink(powers (K, X, Y) float32, first_seq)`` receives every batch in
    order; the default sink publishes the newest heatmap of each batch to
    ``q_power`` (display semantics) — pass your own to consume all of them.
    Accounting: ``processed`` counts beamformed frames, ``skipped`` counts
    frames the ring overwrote unread (the drop metric; 0 = full rate
    sustained), ``metric`` records per-batch latency.
    """

    def __init__(self, receiver: Receiver, tables, q_power: queue.Queue,
                 metrics: PipelineMetrics, batch: int = 16,
                 power_fn=None, sink=None, channels: int = 0,
                 transfer: str = "f32", max_rate: float = 0.0,
                 mesh=None):
        super().__init__("heatmap_batched", receiver, metrics, batch,
                         channels, transfer, max_rate=max_rate, mesh=mesh)
        self.tables = tables
        self.q_power = q_power
        self.sink = sink or self._default_sink
        if mesh is not None:
            if power_fn is not None:
                raise ValueError("mesh and power_fn are exclusive")
            if channels or transfer != "f32":
                raise ValueError("sharded transfers need full-width f32 "
                                 "batches (channels=0, transfer='f32')")
            power_fn = _sharded_power_program(mesh, tables)
        elif power_fn is None:
            power_fn = _batched_power_program(tables,
                                              receiver.cfg.n_microphones)
        elif ((channels and channels < receiver.cfg.n_microphones)
              or transfer != "f32") \
                and not getattr(power_fn, "pads_in_program", False):
            # custom power_fn (fft backend) with channel-sliced or
            # f16 transfers: restore the full-width f32 (B, M, N)
            # contract before calling it — without the pad the
            # freq-domain channel gather would silently clamp
            # out-of-range indices to the last sliced row.  The prologue
            # is its own jitted program (the base_fn is an opaque
            # callable we can't fuse into), not 1-2 eager dispatches.
            # Backends that pad inside their own fused program (the mvdr
            # stream) declare pads_in_program and skip this extra
            # dispatch.
            base_fn = power_fn
            n_full = receiver.cfg.n_microphones
            pad_prog = jax.jit(lambda f: _pad_full(f, n_full))
            power_fn = lambda frames: base_fn(pad_prog(frames))  # noqa: E731
        self.power_fn = power_fn

    def _default_sink(self, powers: np.ndarray, first_seq: int):
        if not put_drop_oldest(self.q_power,
                               (powers[-1], first_seq + len(powers) - 1)):
            pass  # display drop only; processing already counted

    def launch(self, frames_dev):
        return self.power_fn(frames_dev)

    def consume(self, powers, first_seq: int, skipped: int, stamps=None):
        self.sink(powers, first_seq)


class MisoProducer(Stage):
    def __init__(self, receiver: Receiver, tables, cfg: Config,
                 sink: audio_mod.AudioSink, metrics: PipelineMetrics):
        super().__init__("miso", metrics)
        self.receiver = receiver
        self.tables = tables
        self.cfg = cfg
        self.sink = sink
        self._direction = 0
        self._lock = threading.Lock()

    def steer(self, direction: int):
        """``api.c:576-581``: mutate the steer offset live."""
        with self._lock:
            self._direction = int(direction)

    def run(self):
        seq = 0
        n = self.tables.n_mics
        while not self.stop_event.is_set():
            try:
                frame, seq = self.receiver.read_frame(fresh=True,
                                                      last_seq=seq,
                                                      timeout=1.0)
            except TimeoutError:
                continue
            with self._lock:
                d = self._direction
            t0 = time.perf_counter()
            beam = np.asarray(beamform.miso_beam(frame, self.tables, d))
            out = audio_mod.miso_gain(beam, n, self.cfg.mic_gain,
                                      self.cfg.norm_factor_sound)
            self.sink.write(out.astype(np.float32))
            self.metric.tick(time.perf_counter() - t0)


class AudioLeg:
    """Gapless-audio accounting shared by the listening stages
    (:class:`BatchedMisoProducer` and the fused display stage's embedded
    listening, ``apps/fused.py``): zero-fills frames lost to ring
    overwrites so the stream stays sample-count exact, counts
    samples/underruns, and measures the packet->sink e2e latency
    contract from the ring publish stamps (the reference's PortAudio
    callback ran at ms scale, ``api.c:268-282``)."""

    def __init__(self, sink: audio_mod.AudioSink, post_fn,
                 n_samples: int):
        self.sink = sink
        self.post_fn = post_fn
        self.n_samples = n_samples
        self.underrun_frames = 0
        self.samples = 0
        self.lat_oldest_ms: list = []
        self.lat_newest_ms: list = []

    def write(self, beams: np.ndarray, skipped: int, stamps=None):
        if skipped:
            # keep the stream time-aligned: silence for the lost frames
            self.underrun_frames += skipped
            gap = np.zeros(skipped * self.n_samples, np.float32)
            self.sink.write(gap)
            self.samples += gap.size
        audio = self.post_fn(beams).reshape(-1).astype(np.float32)
        self.sink.write(audio)
        self.samples += audio.size
        if stamps is not None:
            s = stamps[stamps > 0]
            if s.size:
                now = time.perf_counter()
                self.lat_oldest_ms.append((now - float(s.min())) * 1e3)
                self.lat_newest_ms.append((now - float(s.max())) * 1e3)

    def latency(self) -> dict:
        """p50/p95 of the per-batch oldest-frame age at sink write — the
        measured end-to-end playback lag (packet ring -> audio sink)."""
        if not self.lat_oldest_ms:
            return {}
        old = np.asarray(self.lat_oldest_ms)
        new = np.asarray(self.lat_newest_ms)
        return {
            "audio_e2e_p50_ms": round(float(np.percentile(old, 50)), 2),
            "audio_e2e_p95_ms": round(float(np.percentile(old, 95)), 2),
            "audio_e2e_newest_p50_ms":
                round(float(np.percentile(new, 50)), 2),
        }


class BatchedMisoProducer(BatchedStage):
    """Full-rate (gapless) steered LISTENING: every frame beamed, in
    counter-contiguous batches.

    The reference's whole point of MISO is *continuous* playback — its
    miso_loop feeds a PortAudio ring at line rate (``api.c:491-543``).
    :class:`MisoProducer` keeps the reference's get_data semantics
    (latest-frame snapshots, ``api.c:830-859``) which can skip/duplicate
    frames in the audio stream; this stage instead drains the frame ring
    in counter-contiguous K-frame batches, runs ONE batched
    ``(K, M, N) -> (K, N)`` beam launch, and writes the concatenated
    samples to the sink — a gapless 48,828 samples/s stream.  Frames the
    ring overwrote unread are zero-filled (and counted in
    ``underrun_frames``) so the output stays sample-count exact.

    ``beam_fn(frames_dev (K, M, N), direction int) -> (K, N)``: the
    delay-and-sum default comes from :meth:`Pipeline.make_miso_batched`;
    pass ``beam='mvdr'`` there for the adaptive (streaming-MVDR
    distortionless) beam, whose weights refresh from the streaming
    precision state every batch.  Steering (:meth:`steer`) is a traced
    argument — live, no recompile (``api.c:576-581``).

    Accounting: ``processed`` frames beamed, ``underrun_frames`` frames
    lost to ring overwrites (0 = gapless), ``samples`` written to the
    sink, ``metric`` per-batch latency.
    """

    def __init__(self, receiver: Receiver, sink: audio_mod.AudioSink,
                 metrics: PipelineMetrics, batch: int, beam_fn, post_fn,
                 n_samples: int, channels: int = 0,
                 name: str = "miso_batched", transfer: str = "f32"):
        super().__init__(name, receiver, metrics, batch, channels, transfer)
        self.sink = sink
        self.beam_fn = beam_fn
        self.post_fn = post_fn
        self.n_samples = n_samples
        self._direction = 0
        self._lock = threading.Lock()
        # audio e2e latency contract: per-batch age (at sink.write) of
        # the batch's OLDEST and NEWEST frames, measured from their ring
        # publish stamps (AudioLeg).  The oldest-frame age is the
        # stream's playback lag — what a listener actually experiences.
        self.want_stamps = True
        self._audio = AudioLeg(sink, post_fn, n_samples)

    @property
    def underrun_frames(self) -> int:
        return self._audio.underrun_frames

    @property
    def samples(self) -> int:
        return self._audio.samples

    @property
    def lat_oldest_ms(self) -> list:
        return self._audio.lat_oldest_ms

    @property
    def lat_newest_ms(self) -> list:
        return self._audio.lat_newest_ms

    def steer(self, direction: int):
        with self._lock:
            self._direction = int(direction)

    def launch(self, frames_dev):
        with self._lock:
            d = self._direction
        return self.beam_fn(frames_dev, d)

    def _write_audio(self, beams: np.ndarray, skipped: int, stamps=None):
        self._audio.write(beams, skipped, stamps)

    def audio_latency(self) -> dict:
        return self._audio.latency()

    def consume(self, beams, first_seq: int, skipped: int, stamps=None):
        self._write_audio(beams, skipped, stamps)


class BatchedMimoMisoProducer(BatchedMisoProducer):
    """Combined full-rate MIMO + MISO: ONE host->device transfer per batch
    serves BOTH the heatmap and the listening output.

    The reference runs imaging and listening off the same shared-memory
    frames (``_loop_mimo_and_miso_*``, ``main.pyx:279-380``); here the
    shared resource is the host->device link — two separate batched
    stages would each transfer the same frames (2x H2D), while this
    stage transfers once and runs one fused program:
    ``process_fn(frames_dev, direction) -> (powers (K, X, Y),
    beams (K, N))``.  For the MVDR backend that program shares the
    streaming-inverse state update between the Capon maps and the beam
    weights.  Heatmaps go to ``power_sink`` (default: newest-of-batch to
    ``q_power``); audio follows the gapless zero-fill contract of
    :class:`BatchedMisoProducer`.
    """

    def __init__(self, receiver: Receiver, sink: audio_mod.AudioSink,
                 metrics: PipelineMetrics, batch: int, process_fn, post_fn,
                 n_samples: int, q_power: queue.Queue, power_sink=None,
                 channels: int = 0, transfer: str = "f32"):
        super().__init__(receiver, sink, metrics, batch, beam_fn=None,
                         post_fn=post_fn, n_samples=n_samples,
                         channels=channels, name="mimo_miso_batched",
                         transfer=transfer)
        self.process_fn = process_fn
        self.q_power = q_power
        self.power_sink = power_sink or self._default_power_sink

    def _default_power_sink(self, powers: np.ndarray, first_seq: int):
        put_drop_oldest(self.q_power,
                        (powers[-1], first_seq + len(powers) - 1))

    def launch(self, frames_dev):
        with self._lock:
            d = self._direction
        return self.process_fn(frames_dev, d)

    def consume(self, out, first_seq: int, skipped: int, stamps=None):
        powers, beams = out
        self.power_sink(powers, first_seq)
        self._write_audio(beams, skipped, stamps)


class CameraProducer(Stage):
    def __init__(self, capture, q_viewer: queue.Queue, q_yolo: queue.Queue,
                 metrics: PipelineMetrics, fps_limit: float = 60.0):
        super().__init__("camera", metrics)
        self.capture = capture
        self.q_viewer = q_viewer
        self.q_yolo = q_yolo
        self.interval = 1.0 / fps_limit

    def run(self):
        n = 0
        while not self.stop_event.is_set():
            ok, frame = self.capture.read()
            if not ok:
                break
            n += 1
            self.metric.tick()
            put_drop_oldest(self.q_viewer, (n, frame))
            put_drop_oldest(self.q_yolo, (n, frame))
            time.sleep(self.interval)


def _rect_conf(tracks, dets, prev_rect_conf):
    """The newest [[x1,y1],[x2,y2],conf] (the ``rect_conf`` contract of
    ``process_video_track_boxes_only``, ``yolo_smooth_tracking.py:
    275-348``) without drawing."""
    from ..models.tracking import compute_iou
    rect_conf = prev_rect_conf
    for tr in tracks:
        x1, y1, x2, y2, tid = tr.astype(int)
        conf = 0.0
        for det in dets:
            if compute_iou([x1, y1, x2, y2], det[:4]) > 0.5:
                conf = float(det[4])
                break
        rect_conf = [[int(x1), int(y1)], [int(x2), int(y2)], conf]
    return rect_conf


def _draw_tracks(imaging, blank, tracks, dets, prev_rect_conf):
    """Draw ID boxes on the blank overlay and return the newest
    rect_conf (see :func:`_rect_conf`)."""
    for tr in tracks:
        x1, y1, x2, y2, tid = tr.astype(int)
        imaging.rectangle(blank, (x1, y1), (x2, y2), (0, 255, 0), 2)
    return _rect_conf(tracks, dets, prev_rect_conf)


def _tracks_payload(tracks) -> np.ndarray:
    """The int-cast (T, 5) boxes the host would draw, as the
    emit_boxes q_inference payload (the on-device rasterizer
    reproduces cv2's thickness-2 rectangles from these exact
    coordinates — ``fusion.composite.DeviceCompositor._raster_tracks``)."""
    if len(tracks) == 0:
        return np.zeros((0, 5), np.float32)
    return np.asarray(tracks).astype(int).astype(np.float32)


class TrackerStage(Stage):
    """``emit_boxes=True`` publishes the raw track boxes instead of a
    drawn canvas — the device-composite viewer rasterizes them on
    device, cutting the per-frame transfer from a full canvas to 20
    floats AND skipping the host-side drawing entirely."""

    def __init__(self, detector, q_yolo: queue.Queue,
                 q_inference: queue.Queue, metrics: PipelineMetrics,
                 emit_boxes: bool = False, **tracker_kwargs):
        super().__init__("tracker", metrics)
        self.q_yolo = q_yolo
        self.q_inference = q_inference
        self.emit_boxes = emit_boxes
        from ..models.tracking import SmoothedTracker
        from ..utils import imaging
        self._imaging = imaging
        self.tracker = SmoothedTracker(detector, **tracker_kwargs)

    def run(self):
        rect_conf = [[0, 0], [0, 0], 0]
        while not self.stop_event.is_set():
            try:
                frame_no, frame = self.q_yolo.get(timeout=0.5)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            if frame.ndim == 2:
                frame = np.repeat(frame[..., None], 3, -1)
            tracks, dets = self.tracker.step(frame)
            if self.emit_boxes:
                rect_conf = _rect_conf(tracks, dets, rect_conf)
                payload = _tracks_payload(tracks)
            else:
                payload = np.zeros_like(frame)
                rect_conf = _draw_tracks(self._imaging, payload, tracks,
                                         dets, rect_conf)
            self.metric.tick(time.perf_counter() - t0)
            put_drop_oldest(self.q_inference,
                            (frame_no, payload, rect_conf))


class BatchedTrackerStage(Stage):
    """Batched detector stage (the vision twin of the batched heatmap
    stage, VERDICT round-2 #2): accumulate up to K queued camera frames,
    run ONE batched YOLO device launch (preprocess + backbone + decode +
    vmapped NMS — ``YoloDetector.get_detections_batch``), then step the
    host-side SORT/hysteresis tracker per frame (O(tracks), cheap) and
    emit every frame's overlay in order.

    The single-frame :class:`TrackerStage` pays one dispatch round-trip
    per camera frame; this stage amortizes it K ways.  Partial batches are padded on-device (static shapes — no
    recompile) and padded outputs discarded.  ``processed`` counts frames
    through the detector; every queued frame is processed exactly once.
    """

    def __init__(self, detector, q_yolo: queue.Queue,
                 q_inference: queue.Queue, metrics: PipelineMetrics,
                 batch: int = 4, emit_boxes: bool = False,
                 **tracker_kwargs):
        super().__init__("tracker_batched", metrics)
        self.q_yolo = q_yolo
        self.q_inference = q_inference
        self.batch = batch
        self.detector = detector
        self.processed = 0
        self.emit_boxes = emit_boxes
        from ..models.tracking import SmoothedTracker
        from ..utils import imaging
        self._imaging = imaging
        self.tracker = SmoothedTracker(detector, **tracker_kwargs)

    def warmup(self):
        c = self.detector.cfg
        zeros = [np.zeros((c.input_size, c.input_size, 3), np.uint8)]
        self.detector.get_detections_batch(zeros, pad_to=self.batch)

    def run(self):
        rect_conf = [[0, 0], [0, 0], 0]
        while not self.stop_event.is_set():
            items = []
            try:
                items.append(self.q_yolo.get(timeout=0.5))
            except queue.Empty:
                continue
            while len(items) < self.batch:
                try:
                    items.append(self.q_yolo.get_nowait())
                except queue.Empty:
                    break
            t0 = time.perf_counter()
            frames = []
            for no, f in items:
                if f.ndim == 2:
                    f = np.repeat(f[..., None], 3, -1)
                frames.append(f)
            dets_per_frame = self.detector.get_detections_batch(
                frames, conf_threshold=self.tracker.confl,
                pad_to=self.batch)
            self.metric.tick(time.perf_counter() - t0)
            for (no, _), frame, dets in zip(items, frames, dets_per_frame):
                tracks, kept = self.tracker.step_with_detections(frame,
                                                                 dets)
                if self.emit_boxes:
                    rect_conf = _rect_conf(tracks, kept, rect_conf)
                    payload = _tracks_payload(tracks)
                else:
                    payload = np.zeros_like(frame)
                    rect_conf = _draw_tracks(self._imaging, payload,
                                             tracks, kept, rect_conf)
                self.processed += 1
                put_drop_oldest(self.q_inference, (no, payload, rect_conf))


class Pipeline:
    """Owns the receiver + stages; the ``mimo()``/``miso()`` orchestration
    layer (``main.pyx:669-736,824-864``) as one object."""

    def __init__(self, cfg: Optional[Config] = None, algorithm: str = "lerp",
                 replay_mode: bool = False, backend: str = "auto",
                 audio_sink: str = "null", audio_path: Optional[str] = None,
                 power_fn=None, ring_frames: int = 64,
                 power_backend: str = "auto"):
        self.cfg = cfg or Config()
        self.metrics = PipelineMetrics()
        self.tables = beamform.make_tables(self.cfg, algorithm)
        if power_backend not in ("auto", "freq_equiv"):
            raise ValueError(f"unknown power backend {power_backend!r}")
        if power_fn is not None and power_backend != "auto":
            # a custom power_fn (the fft/mvdr closures) computes its own
            # power — silently dropping the explicit backend request
            # would leave the user believing the equiv path is running
            raise ValueError(
                f"power_backend={power_backend!r} conflicts with a custom "
                f"power_fn: the backend flag selects how the time-domain "
                f"steered power is computed, which a custom power_fn "
                f"replaces entirely — pass one or the other")
        if power_fn is None and power_backend == "freq_equiv":
            # explicit EXACT frequency-domain reformulation of the
            # selected time-domain algorithm (ops/freq_equiv) at any tier
            # and shape: same output to f32 rounding, no T axis in the
            # per-frame contraction
            from ..ops import freq_equiv

            et = freq_equiv.make_equiv_tables(self.tables)
            power_fn = lambda f: freq_equiv.equiv_steered_power(f, et)  # noqa: E731
        self.receiver = Receiver(self.cfg, replay_mode=replay_mode,
                                 backend=backend, ring_frames=ring_frames)
        self.q_power: queue.Queue = queue.Queue(maxsize=2)
        self.q_viewer: queue.Queue = queue.Queue(maxsize=2)
        self.q_yolo: queue.Queue = queue.Queue(maxsize=2)
        self.q_inference: queue.Queue = queue.Queue(maxsize=2)
        self.stages = []
        self._audio_sink_kind = audio_sink
        self._audio_path = audio_path
        self._miso: Optional[MisoProducer] = None
        self._power_fn = power_fn

    # -- bring-up -------------------------------------------------------------

    def connect(self, timeout: float = 30.0) -> int:
        return self.receiver.connect(timeout=timeout)

    def start_heatmap(self, warmup: bool = True):
        s = HeatmapProducer(self.receiver, self.tables, self.q_power,
                            self.metrics, power_fn=self._power_fn)
        if warmup:
            # jit-compile before the thread starts so the first live frame
            # is not delayed by the compile.
            zeros = np.zeros((self.cfg.n_microphones, self.cfg.n_samples),
                             np.float32)
            np.asarray(s.power_fn(zeros))
            if getattr(s.power_fn, "reset", None):
                # stateful backends (mvdr): drop the zero-frame warmup
                # pollution AND precompile the periodic programs (reset
                # is what compiles refresh/d0 — a mid-run first compile
                # stalls the live loop for seconds)
                s.power_fn.reset()
        self.stages.append(s)
        s.start()
        return s

    def make_heatmap_batched(self, batch: int = 16, sink=None,
                             channels: int = 0, transfer: str = "f32",
                             max_rate: float = 0.0, mesh=None):
        """Build (but don't start) the full-line-rate stage — lets callers
        :meth:`BatchedHeatmapProducer.warmup` (compile) before any packets
        flow, then :meth:`run_stage` it after :meth:`connect`.
        ``max_rate`` (frames/s) throttles for display consumers sharing
        the device link (see :class:`BatchedStage`).  ``mesh``: transfer
        every batch with a batch-over-"data" NamedSharding and launch the
        sharded production program (SURVEY §2.4 ingest fan-in)."""
        if mesh is not None and self._power_fn is not None:
            raise ValueError("mesh is exclusive with a configured "
                             "power_fn/power_backend")
        return BatchedHeatmapProducer(self.receiver, self.tables,
                                      self.q_power, self.metrics,
                                      batch=batch,
                                      power_fn=self._power_fn,
                                      sink=sink, channels=channels,
                                      transfer=transfer, max_rate=max_rate,
                                      mesh=mesh)

    def run_stage(self, s):
        self.stages.append(s)
        s.start()
        return s

    def start_heatmap_batched(self, batch: int = 16, sink=None,
                              warmup: bool = True, max_rate: float = 0.0,
                              mesh=None):
        """Full-line-rate variant of :meth:`start_heatmap` — every frame
        beamformed in K-frame device batches (SURVEY §7 hard part b)."""
        s = self.make_heatmap_batched(batch=batch, sink=sink,
                                      max_rate=max_rate, mesh=mesh)
        if warmup:
            s.warmup()
            if getattr(self._power_fn, "reset", None):
                # the stage may wrap the power_fn (pad prologue), so
                # reset through the pipeline's handle — mirrors
                # start_miso_batched: drop warmup pollution + precompile
                # the periodic programs
                self._power_fn.reset()
        return self.run_stage(s)

    def start_miso(self, warmup: bool = True):
        sink = audio_mod.make_sink(self._audio_sink_kind,
                                   self.cfg.sample_rate, self._audio_path)
        s = MisoProducer(self.receiver, self.tables, self.cfg, sink,
                         self.metrics)
        if warmup:
            zeros = np.zeros((self.cfg.n_microphones, self.cfg.n_samples),
                             np.float32)
            np.asarray(beamform.miso_beam(zeros, self.tables, 0))
        self._miso = s
        self.stages.append(s)
        s.start()
        return s

    def make_miso_batched(self, batch: int = 16, beam: str = "time",
                          channels: int = 0, alpha: float = 0.9,
                          sink: Optional[audio_mod.AudioSink] = None,
                          transfer: str = "f32"):
        """Build (don't start) the full-rate listening stage.

        ``beam='time'``: batched delay-and-sum (``beamform.miso_beam``)
        through this pipeline's algorithm tables, with the reference's
        gain chain (``api.c:517-522``).  ``beam='mvdr'``: the adaptive
        distortionless beam — one fused device program per batch absorbs
        the frames into the streaming inverse covariance and beams them
        with the refreshed MVDR weights (``freq.mvdr_listen_step``).
        """
        cfg = self.cfg
        n_full = cfg.n_microphones
        if beam == "time":
            tables = self.tables

            @jax.jit
            def _beam(frames, t, d):
                return beamform.miso_beam(_pad_full(frames, n_full), t, d)

            beam_fn = lambda frames, d: _beam(frames, tables, d)  # noqa: E731
            n = tables.n_mics
            post_fn = lambda b: audio_mod.miso_gain(       # noqa: E731
                b, n, cfg.mic_gain, cfg.norm_factor_sound)
        elif beam == "mvdr":
            # the shared streaming-MVDR state machine (state, alpha-aware
            # refresh cadence, reset/precompile) — see make_mvdr_stream
            beam_fn = make_mvdr_stream(cfg, "beams", alpha=alpha)
            # the MVDR beam is distortionless (unit gain toward the steer
            # direction) — no 1/n·MIC_GAIN rescale
            post_fn = lambda b: b                          # noqa: E731
        else:
            raise ValueError(f"unknown beam backend {beam!r}")
        if sink is None:
            sink = audio_mod.make_sink(self._audio_sink_kind,
                                       cfg.sample_rate, self._audio_path)
        s = BatchedMisoProducer(self.receiver, sink, self.metrics,
                                batch, beam_fn, post_fn,
                                cfg.n_samples, channels=channels,
                                transfer=transfer)
        self._miso = s
        return s

    def make_mimo_miso_batched(self, batch: int = 16, beam: str = "time",
                               channels: int = 0, alpha: float = 0.9,
                               sink: Optional[audio_mod.AudioSink] = None,
                               power_sink=None, transfer: str = "f32"):
        """Build (don't start) the combined full-rate imaging+listening
        stage: one transfer, one fused device program per batch producing
        heatmaps AND the steered beam (the MVDR backend shares its
        streaming-inverse update between the Capon maps and the beam
        weights)."""
        cfg = self.cfg
        n_full = cfg.n_microphones
        if beam == "time":
            tables = self.tables
            if self._power_fn is not None:
                # honor the pipeline's configured power backend (the
                # mvdr/fft/freq_equiv opt-ins): enabling audio must not
                # silently switch the imaging semantics.  The (possibly
                # stateful) power_fn runs on the already-transferred
                # batch; the beam is its own jitted program over the
                # SAME device array — still one host->device transfer.
                base_fn = self._power_fn
                pad_prog = jax.jit(lambda f: _pad_full(f, n_full))

                @jax.jit
                def _beam(frames, t, d):
                    return beamform.miso_beam(frames, t, d)

                def process_fn(frames, d, _b=base_fn, _t=tables):
                    # pad/upcast ONCE, in-program (f16/channel-sliced
                    # transfers only), and share the padded batch
                    if frames.dtype != np.float32 \
                            or frames.shape[1] != n_full:
                        frames = pad_prog(frames)
                    return _b(frames), _beam(frames, _t, d)
            else:
                tr, extra = _power_program_parts(tables)

                @jax.jit
                def _both(frames, t, d, *args):
                    frames = _pad_full(frames, n_full)
                    return tr(frames, *args), \
                        beamform.miso_beam(frames, t, d)

                process_fn = lambda f, d: _both(  # noqa: E731
                    f, tables, d, *extra)

            n = tables.n_mics
            post_fn = lambda b: audio_mod.miso_gain(       # noqa: E731
                b, n, cfg.mic_gain, cfg.norm_factor_sound)
        elif beam == "mvdr":
            # ONE streaming-inverse update shared between the Capon maps
            # and the beam weights, in one fused device program — the
            # shared state machine handles the d0 carry and the
            # alpha-aware refresh cadence (see make_mvdr_stream)
            process_fn = make_mvdr_stream(cfg, "maps_beams", alpha=alpha)
            post_fn = lambda b: b                          # noqa: E731
        else:
            raise ValueError(f"unknown beam backend {beam!r}")
        if sink is None:
            sink = audio_mod.make_sink(self._audio_sink_kind,
                                       cfg.sample_rate, self._audio_path)
        s = BatchedMimoMisoProducer(self.receiver, sink, self.metrics,
                                    batch, process_fn, post_fn,
                                    cfg.n_samples, self.q_power,
                                    power_sink=power_sink,
                                    channels=channels, transfer=transfer)
        self._miso = s
        return s

    def start_miso_batched(self, batch: int = 16, beam: str = "time",
                           warmup: bool = True, channels: int = 0,
                           sink: Optional[audio_mod.AudioSink] = None):
        """Full-rate variant of :meth:`start_miso` — gapless line-rate
        listening (VERDICT: the one reference capability the latest-frame
        sampler could not meet)."""
        s = self.make_miso_batched(batch=batch, beam=beam,
                                   channels=channels, sink=sink)
        if warmup:
            s.warmup()
            if getattr(s.beam_fn, "reset", None):
                s.beam_fn.reset()          # drop warmup pollution
        return self.run_stage(s)

    def start_camera(self, capture, fps_limit: float = 60.0):
        s = CameraProducer(capture, self.q_viewer, self.q_yolo,
                           self.metrics, fps_limit=fps_limit)
        self.stages.append(s)
        s.start()
        return s

    def start_tracker(self, detector, **tracker_kwargs):
        s = TrackerStage(detector, self.q_yolo, self.q_inference,
                         self.metrics, **tracker_kwargs)
        self.stages.append(s)
        s.start()
        return s

    def start_tracker_batched(self, detector, batch: int = 4,
                              warmup: bool = True, **tracker_kwargs):
        """Batched variant of :meth:`start_tracker` — one YOLO device
        launch per K queued camera frames."""
        s = BatchedTrackerStage(detector, self.q_yolo, self.q_inference,
                                self.metrics, batch=batch,
                                **tracker_kwargs)
        if warmup:
            s.warmup()
        self.stages.append(s)
        s.start()
        return s

    # -- steering (main.pyx:498-528 semantics) ---------------------------------

    def steer_cartesian_degree(self, azimuth: float, elevation: float):
        assert -90 <= azimuth <= 90 and -90 <= elevation <= 90, \
            "Invalid range"
        d = beamform.steer_index(self.cfg, azimuth, elevation)
        if self._miso is not None:
            self._miso.steer(d)
        return d

    def steer_click(self, horizontal01: float, vertical01: float):
        """Normalized click coords -> grid cell (``stear_miso_beam``)."""
        az = int(np.clip(horizontal01 * self.cfg.max_res_x, 0,
                         self.cfg.max_res_x - 1))
        el = int(np.clip(vertical01 * self.cfg.max_res_y, 0,
                         self.cfg.max_res_y - 1))
        d = az * self.cfg.max_res_y + el
        if self._miso is not None:
            self._miso.steer(d)
        return d

    # -- teardown --------------------------------------------------------------

    def stop(self):
        for s in self.stages:
            s.stop()
        for s in self.stages:
            s.join(timeout=2.0)
        self.receiver.disconnect()
        if self._miso is not None:
            # _miso is either a listening stage (owns .sink) or a fused
            # display stage with embedded listening (sink lives on its
            # AudioLeg) — close whichever is present
            leg = getattr(self._miso, "audio", None) or self._miso
            sink = getattr(leg, "sink", None)
            if sink is not None:
                sink.close()

    def report(self):
        rep = self.metrics.report()
        rep["ingest"] = {
            "packets": self.receiver.native_stats.packets,
            "frames": self.receiver.native_stats.frames,
            "gaps": self.receiver.native_stats.gaps,
        }
        # full-rate stage accounting (processed/skipped/underruns) + the
        # audio sink's late-write drop counter — the observability the
        # reference's stdout prints never had (VERDICT round-2 weak #1)
        for s in self.stages:
            counts = {k: getattr(s, k) for k in
                      ("processed", "skipped", "underrun_frames")
                      if hasattr(s, k)}
            if hasattr(s, "audio_latency"):
                counts.update(s.audio_latency())
            sink = getattr(s, "sink", None)
            if sink is not None and hasattr(sink, "_dropped"):
                counts["sink_dropped_writes"] = sink._dropped
            if sink is not None and hasattr(sink, "underflow_samples"):
                counts["sink_underflow_samples"] = sink.underflow_samples
            if counts:
                rep.setdefault(s.name, {}).update(counts)
        return rep
