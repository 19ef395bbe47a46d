"""Host-side UDP ingest: receiver thread, latest-frame buffer, gap stats.

Replaces the reference's fork()'d C child + SysV shared-memory ring +
semaphores (``api.c:679-737,874-939``) with a single-process design: one
receiver thread (native C++ engine when built, Python loop otherwise)
assembles frames into a seqlock-style latest-frame buffer; consumers
snapshot the newest complete frame without ever blocking the producer.
No cross-process shm => none of the documented cleanup failure modes
(``PC/README.md:142-150``).

Improvements over the reference kept deliberately:
* the packet-header ``counter`` field (present but unused in the C,
  ``receiver.h:56``) drives gap detection and drop accounting;
* dead-microphone zeroing is a config field applied on read
  (replacing the hard-coded 122-index list in ``api.c:830-859``).

Top-level :func:`connect` / :func:`disconnect` / :func:`receive` mirror the
``lib.beamformer`` API (``main.pyx:95-159``).
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import Config
from . import protocol


@dataclass
class IngestStats:
    packets: int = 0
    frames: int = 0
    gaps: int = 0                 # missing packets inferred from counters
    bad_protocol: int = 0
    last_counter: int = -1


class FrameRing:
    """Single-producer / multi-consumer frame ring.

    The producer publishes complete (n_mics, n_samples) frames into a ring
    of ``capacity`` slots; readers either snapshot the newest one (the
    semaphore-guarded ``get_data`` semantics, ``api.c:830-859``, without
    shared mutable state across processes) or drain *every* frame in
    counter-contiguous batches via :meth:`read_batch` — the full-line-rate
    path the reference's latest-frame snapshot could never offer
    (``receiver.c:94-151`` writes every frame; ``get_data`` samples them).
    """

    def __init__(self, n_mics: int, n_samples: int, capacity: int = 64):
        self._buf = np.zeros((capacity, n_mics, n_samples), dtype=np.float32)
        self._stamps = np.zeros(capacity, dtype=np.float64)
        self._cap = capacity
        self._seq = 0
        self._cond = threading.Condition()

    @property
    def capacity(self) -> int:
        return self._cap

    def publish(self, frame: np.ndarray) -> None:
        with self._cond:
            slot = (self._seq + 1) % self._cap
            self._buf[slot] = frame
            # publish stamp (time.perf_counter == CLOCK_MONOTONIC, same
            # clock the native engine records): the packet-side anchor
            # of the audio-latency contract
            self._stamps[slot] = time.perf_counter()
            self._seq += 1
            self._cond.notify_all()

    def snapshot(self, out: Optional[np.ndarray] = None):
        with self._cond:
            seq = self._seq
            src = self._buf[seq % self._cap]
            if out is None:
                return src.copy(), seq
            out[...] = src
            return out, seq

    def wait_fresh(self, last_seq: int, timeout: Optional[float] = None):
        with self._cond:
            ok = self._cond.wait_for(lambda: self._seq > last_seq, timeout)
            if not ok:
                return None, last_seq
            src = self._buf[self._seq % self._cap]
            return src.copy(), self._seq

    def read_batch(self, k: int, next_seq: int,
                   timeout: Optional[float] = None, channels: int = 0,
                   with_stamps: bool = False):
        """k counter-contiguous frames starting at max(next_seq, oldest
        still in the ring), oldest first.

        Returns ``(batch (k, M, N) float32, first_seq, skipped)`` where
        ``skipped`` counts frames overwritten before the reader got to them
        (0 when the reader keeps up).  ``channels`` > 0 returns only the
        leading connected rows.  ``with_stamps`` appends the per-frame
        publish times (``time.perf_counter`` seconds) to the tuple.
        Returns ``(None, next_seq, 0[, None])`` on timeout.
        """
        if not 1 <= k <= self._cap:
            raise ValueError("batch size exceeds the ring capacity")
        next_seq = max(int(next_seq), 1)
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._seq >= next_seq + k - 1, timeout)
            if not ok:
                return (None, next_seq, 0, None) if with_stamps \
                    else (None, next_seq, 0)
            first = max(next_seq, self._seq - self._cap + 1)
            idx = np.arange(first, first + k) % self._cap
            src = self._buf[idx]            # fancy index = fresh copy
            if 0 < channels < src.shape[1]:
                src = np.ascontiguousarray(src[:, :channels])
            if with_stamps:
                return src, first, first - next_seq, self._stamps[idx].copy()
            return src, first, first - next_seq


# Backwards-compatible alias (the round-1 name for the latest-frame case).
LatestFrameBuffer = FrameRing


class Receiver:
    """Protocol-v2 UDP receiver.

    ``backend='auto'`` prefers the native C++ engine (``ingest/native``) and
    falls back to the Python loop; ``'python'``/``'native'`` force one.
    """

    def __init__(self, cfg: Config, replay_mode: bool = False,
                 backend: str = "auto", exact_reference: bool = True,
                 ring_frames: int = 64):
        self.cfg = cfg
        self.replay_mode = replay_mode
        self.exact_reference = exact_reference
        self.ring_frames = ring_frames
        self.stats = IngestStats()
        self.buffer = FrameRing(cfg.n_microphones, cfg.n_samples,
                                capacity=ring_frames)
        self.n_arrays: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None
        self._native = None
        if backend in ("auto", "native"):
            try:
                from . import native_build
                self._native = native_build.load()
            except Exception:
                if backend == "native":
                    raise
                self._native = None
        self._dead_rows = np.asarray(cfg.disabled_mics, dtype=np.int64)

    # -- lifecycle ----------------------------------------------------------

    def connect(self, timeout: float = 30.0) -> int:
        """Bind, read the header packet, validate the protocol version, and
        start the receive loop.  Returns n_arrays (like ``receive_header_data``,
        ``receiver.c:224-239``); raises on protocol mismatch, mirroring the
        reference's disconnect-on-mismatch (``main.pyx:114-116``)."""
        if self._native is not None:
            return self._connect_native(timeout)
        cfg = self.cfg
        ip = cfg.udp_replay_ip if self.replay_mode else cfg.udp_ip
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        self._sock.bind((ip, cfg.udp_port))
        self._sock.settimeout(timeout)
        data = self._sock.recv(protocol.packet_size(cfg))
        freq, n_arrays, ver, counter = protocol.unpack_header(data)
        if ver != cfg.fpga_protocol_version:
            self._sock.close()
            raise ConnectionError(
                f"wrong FPGA protocol version {ver} != "
                f"{cfg.fpga_protocol_version}")
        self.n_arrays = int(n_arrays)
        cap = cfg.n_microphones // (cfg.rows * cfg.columns)
        if not 1 <= self.n_arrays <= cap:
            self._sock.close()
            raise ConnectionError(
                f"header declares {self.n_arrays} array(s); this config "
                f"fits {cap} ({cfg.n_microphones} mics / "
                f"{cfg.rows}x{cfg.columns}) — a mismatched stream would "
                f"overflow the frame buffer")
        self.stats.last_counter = counter
        self._sock.settimeout(0.5)
        self._stop.clear()
        self._thread = threading.Thread(target=self._py_loop, daemon=True)
        self._thread.start()
        return self.n_arrays

    def disconnect(self) -> None:
        self._stop.set()
        if self._native is not None:
            self._native.disconnect()
            return
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    # -- consumption ---------------------------------------------------------

    def read_frame(self, out: Optional[np.ndarray] = None,
                   fresh: bool = False, last_seq: int = -1,
                   timeout: Optional[float] = 5.0):
        """Latest complete frame (n_mics, n_samples) float32 with the
        dead-mic mask applied (``get_data`` semantics, ``api.c:830-859``).
        Returns (frame, seq)."""
        if self._native is not None:
            frame, seq = self._native.read_frame(fresh, last_seq, timeout)
        elif fresh:
            frame, seq = self.buffer.wait_fresh(last_seq, timeout)
            if frame is None:
                raise TimeoutError("no fresh frame within timeout")
        else:
            frame, seq = self.buffer.snapshot(out)
        if self._dead_rows.size:
            frame[self._dead_rows] = 0.0
        return frame, seq

    def read_batch(self, k: int, next_seq: int = 1,
                   timeout: Optional[float] = 5.0, channels: int = 0,
                   with_stamps: bool = False):
        """``k`` counter-contiguous frames, oldest first, each delivered
        exactly once — the full-line-rate consumer API.

        Returns ``(batch (k, M, N) float32, first_seq, skipped)``; pass
        ``first_seq + k`` as the next call's ``next_seq``.  ``skipped`` > 0
        means the consumer fell more than ``ring_frames`` behind and that
        many frames were overwritten unread.  ``channels`` > 0 returns only
        the leading connected rows (``n_arrays * rows * cols``; the tail
        rows are never written and shrink host->device transfers for
        nothing).  ``with_stamps`` appends per-frame publish times
        (``time.perf_counter`` seconds; both backends stamp
        CLOCK_MONOTONIC at ring publish) — the packet-side anchor of the
        audio end-to-end latency contract.  Dead-mic mask applied.
        Raises :class:`TimeoutError` when k frames don't arrive in time.
        """
        if self._native is not None:
            out = self._native.read_batch(
                k, next_seq, timeout, channels=channels,
                with_stamps=with_stamps)
        else:
            out = self.buffer.read_batch(
                k, next_seq, timeout, channels=channels,
                with_stamps=with_stamps)
            if out[0] is None:
                raise TimeoutError("no frame batch within timeout")
        batch = out[0]
        dead = self._dead_rows
        if dead.size:
            if channels:
                dead = dead[dead < batch.shape[1]]
            batch[:, dead] = 0.0
        return out

    # -- python receive loop --------------------------------------------------

    def _py_loop(self) -> None:
        cfg = self.cfg
        n_arrays = self.n_arrays
        perm = protocol.serpentine_permutation(cfg, n_arrays,
                                               self.exact_reference)
        n_ch = perm.shape[0]
        inv_norm = 1.0 / cfg.norm_factor
        frame = np.zeros((cfg.n_microphones, cfg.n_samples), np.float32)
        psize = protocol.packet_size(cfg)
        asm_base = -1          # counter base of the frame being assembled
        asm_dirty = False      # buffer holds samples not yet published
        while not self._stop.is_set():
            try:
                data = self._sock.recv(psize)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) < psize:
                continue
            freq, na, ver, counter = protocol.unpack_header(data)
            if ver != cfg.fpga_protocol_version:
                self.stats.bad_protocol += 1
                continue
            if self.stats.last_counter >= 0:
                gap = (counter - self.stats.last_counter - 1) & 0xFFFFFFFF
                if 0 < gap < 1 << 16:
                    self.stats.gaps += gap
            self.stats.last_counter = counter
            self.stats.packets += 1
            stream = protocol.unpack_stream(cfg, data)
            # Frame slot from the packet counter (unused by the reference,
            # receiver.h:56): keeps frame assembly aligned across startup
            # offsets and packet loss instead of counting received packets.
            step = counter % cfg.n_samples
            base = counter - step
            if base != asm_base:
                # a new frame began without the previous one publishing
                # (its FINAL packet was lost): discard the partial
                # assembly so its samples cannot leak into this frame's
                # lost-packet columns (the documented zeros contract)
                if asm_dirty:
                    frame[:] = 0.0
                asm_base = base
            frame[:n_ch, step] = stream[perm] * inv_norm
            asm_dirty = True
            if step == cfg.n_samples - 1:
                self.buffer.publish(frame)
                self.stats.frames += 1
                # Zero the assembly buffer so packets lost in *any* frame
                # leave zeros (the documented contract), not stale samples
                # from the previous frame.
                frame[:] = 0.0
                asm_dirty = False

    # -- native engine -------------------------------------------------------

    def _connect_native(self, timeout: float) -> int:
        cfg = self.cfg
        ip = cfg.udp_replay_ip if self.replay_mode else cfg.udp_ip
        self.n_arrays = self._native.connect(
            cfg, ip, timeout, self.exact_reference,
            ring_frames=self.ring_frames)
        return self.n_arrays

    @property
    def native_stats(self):
        if self._native is not None:
            return self._native.stats()
        return self.stats

    @property
    def published_seq(self) -> int:
        """Newest published ring counter (0 before the first frame).

        Stream-start anchor for batched consumers: a stage whose loop
        begins long after :meth:`connect` (``warmup()`` compiles while
        packets flow) must start
        its counter-contiguous stream HERE, not at counter 1 —
        otherwise every frame published during compile is zero-filled
        into the audio stream as a fake "underrun"."""
        if self._native is not None:
            # the native ring counter and the frames stat are written
            # by the same publish step (ingest.cpp publish path)
            return int(self._native.stats().frames)
        return int(self.buffer._seq)

    @property
    def stream_anchor_seq(self) -> int:
        """Oldest counter still resident in the ring (1 before wrap).

        Stream-start anchor for FULL-RATE batched consumers: start the
        counter-contiguous stream at the oldest frame the ring still
        holds — everything available is consumed (the hermetic tests
        publish a finite stream before the loop starts and expect every
        frame), while a long pre-start backlog (e.g. frames published
        during a long compile in ``warmup()``) beyond the
        ring is NOT zero-filled in as fake "underruns".  A low-latency
        consumer that prefers to drop the resident backlog too can
        anchor at ``published_seq + 1`` instead (none do today: the
        batched consumers outpace line rate, so the ring-deep backlog
        clears in under a second)."""
        return max(1, self.published_seq - self.ring_frames + 1)


# ---------------------------------------------------------------------------
# module-level API with main.pyx ergonomics
# ---------------------------------------------------------------------------

_GLOBAL: Optional[Receiver] = None


def connect(replay_mode: bool = False, cfg: Optional[Config] = None,
            verbose: bool = True, backend: str = "auto") -> Receiver:
    """``lib.beamformer.connect`` (``main.pyx:95-119``)."""
    global _GLOBAL
    assert isinstance(replay_mode, bool), \
        "Replay mode must be either True or False"
    cfg = cfg or Config()
    r = Receiver(cfg, replay_mode=replay_mode, backend=backend)
    r.connect()
    _GLOBAL = r
    if verbose:
        print("Receiver thread started. Continue your program!")
    return r


def disconnect() -> None:
    """``main.pyx:122-130``."""
    global _GLOBAL
    if _GLOBAL is not None:
        _GLOBAL.disconnect()
        _GLOBAL = None


def receive(signals: np.ndarray) -> None:
    """Fill ``signals`` (n_mics, n_samples) float32 with the latest frame
    (``main.pyx:133-159``)."""
    assert _GLOBAL is not None, "connect() first"
    cfg = _GLOBAL.cfg
    assert signals.shape == (cfg.n_microphones, cfg.n_samples), \
        "Arrays do not match shape"
    assert signals.dtype == np.float32, "Arrays dtype do not match"
    _GLOBAL.read_frame(out=signals)
