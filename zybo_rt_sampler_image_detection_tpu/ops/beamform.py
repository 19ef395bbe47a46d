"""Time-domain beamformers (JAX/XLA).

Design
------
The reference computes each of its four delay-and-sum variants with nested
C loops over (direction, mic, sample) — e.g. ``pad_and_sum.c:100-143`` runs
1824 directions serially, and the AVX2 path (``convolve_and_sum.c:92-128``)
vectorizes only the innermost 8 floats.  Here the whole family is
restructured as **one dense matmul**:

Every variant writes, for direction *d* and mic *m*, a few tap weights
``w`` at integer output shifts ``sigma``::

    beam[d, n] = sum_{m,k} w[d,m,k] * s[m, n - sigma[d,m,k]]

Group the shifts: build a *delay-line* tensor ``Sdel[t, m, n] =
s[m, n - (tau_min + t)]`` (zero-filled, tails truncated — exactly the C
``pad_delay`` edge semantics), scatter the weights into a dense
``W[d, t, m]``, and the beam is a single contraction::

    beams = einsum('dtm,tmn->dn', W, Sdel)      # (D, T*M) @ (T*M, N) matmul

All four algorithms — pad (1 tap), lerp (2 taps), convolve (n_taps),
hybrid (n_taps) — are the *same kernel* with different W.  The only
deviations from a pure shift are boundary terms at the start of the frame
(the C loops run ``i in [0, N-pad-1)``, cutting a handful of products that
involve ``s[m, 0..2]``); those are applied exactly, *before* squaring, as a
second dense one-hot einsum into the first few output columns (scatter-free
— see ``_build_corrections``).

Cost: for the reference config the contraction is ~(1824 x 9408) @
(9408 x 256) ≈ 9 GFLOP/frame, and the 1824-direction axis the C executed
serially becomes the matmul M-dimension.  ``ops/freq_equiv.py`` computes
the same power without the delay axis; ``apps.pipeline`` picks between
the two per precision tier and shape.

Reference parity: ``pad_and_sum.c``, ``lerp_and_sum.c``,
``convolve_and_sum.c``, ``hybrid_convolve_and_sum.c``, driven as in
``PC/src/benchmark.pyx:74-196``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from . import geometry


# ---------------------------------------------------------------------------
# Steering tables (device-resident, built once per config+algorithm)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SteeringTables:
    """Dense delay-line weights + correction scatter for one algorithm."""

    # (D, T, M) float32 — tap weight for direction d, shift tau_min+t, mic m.
    W: jax.Array
    # (J, D, Tc, M) float32 — boundary-correction weights: correction group
    # j multiplies s[m, corr_js[j]] and subtracts at output column t < Tc.
    # Dense one-hot layout so the correction is an einsum + static slice
    # update (a runtime scatter of ~3e5 indices takes the compiler tens
    # of minutes).
    Wc: Optional[jax.Array]
    # (M,) int32 — active mic indices into the full channel axis.
    adaptive: jax.Array

    # static metadata (hashable; part of jit specialization)
    tau_min: int = dataclasses.field(metadata=dict(static=True))
    corr_js: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    precision: str = dataclasses.field(metadata=dict(static=True))
    n_samples: int = dataclasses.field(metadata=dict(static=True))
    res_x: int = dataclasses.field(metadata=dict(static=True))
    res_y: int = dataclasses.field(metadata=dict(static=True))
    algorithm: str = dataclasses.field(metadata=dict(static=True))

    @property
    def lax_precision(self):
        return {"highest": jax.lax.Precision.HIGHEST,
                "high": jax.lax.Precision.HIGH,
                "default": jax.lax.Precision.DEFAULT}[self.precision]

    @property
    def n_mics(self) -> int:
        return self.W.shape[2]

    @property
    def n_taps_line(self) -> int:
        return self.W.shape[1]

    @property
    def n_directions(self) -> int:
        return self.W.shape[0]


def _scatter_w(delays_shift: np.ndarray, weights: np.ndarray,
               tau_min: int, T: int) -> np.ndarray:
    """Scatter per-(d, m, k) weights at integer shifts into dense (D, T, M)."""
    D, M, K = delays_shift.shape
    W = np.zeros((D, T, M), dtype=np.float32)
    d_idx = np.repeat(np.arange(D), M * K)
    m_idx = np.tile(np.repeat(np.arange(M), K), D)
    t_idx = (delays_shift - tau_min).reshape(-1)
    np.add.at(W, (d_idx, t_idx, m_idx), weights.reshape(-1).astype(np.float32))
    return W


def _tables(cfg: Config, W: np.ndarray, algorithm: str, tau_min: int,
            Wc: Optional[np.ndarray] = None,
            corr_js: Tuple[int, ...] = ()) -> SteeringTables:
    active, _ = geometry.active_microphones(cfg)
    dt = jnp.dtype(cfg.matmul_dtype)
    return SteeringTables(
        W=jnp.asarray(W, dtype=dt),
        Wc=None if Wc is None else jnp.asarray(Wc, jnp.float32),
        adaptive=jnp.asarray(active, jnp.int32),
        tau_min=tau_min,
        corr_js=corr_js,
        precision=cfg.matmul_precision,
        n_samples=cfg.n_samples,
        res_x=cfg.max_res_x,
        res_y=cfg.max_res_y,
        algorithm=algorithm,
    )


def make_pad_tables(cfg: Config, whole: Optional[np.ndarray] = None) -> SteeringTables:
    """Pad-and-sum: one unit tap at shift ``whole`` (``pad_and_sum.c:41-47``:
    ``out[pad+i] += s[i]`` — a pure zero-fill shift, no boundary terms)."""
    if whole is None:
        whole, _ = geometry.calculate_coefficients(cfg)
    D = cfg.n_directions
    wh = whole.reshape(D, -1)[..., None].astype(np.int64)          # (D, M, 1)
    T = int(wh.max()) + 1
    W = _scatter_w(wh, np.ones_like(wh, np.float32), 0, T)
    return _tables(cfg, W, "pad", 0)


def make_truncated_tables(cfg: Config) -> SteeringTables:
    """Trunc-and-sum (``api.c:1015-1056``): identical inner math to pad but
    loaded from the angle-grid delay model (``directions.pyx:126-157``)."""
    delays = geometry.calculate_delays_angles(cfg)
    active, _ = geometry.active_microphones(cfg)
    whole = delays[:, :, active].astype(int)
    t = make_pad_tables(cfg, whole)
    return dataclasses.replace(t, algorithm="truncated")


def make_lerp_tables(cfg: Config) -> SteeringTables:
    """Lerp-and-sum (``lerp_and_sum.c:50-56``):

    ``out[pad+i+1] += s[i] + h*(s[i+1]-s[i])`` with ``h = 1-frac`` expands to
    weight ``(1-h)`` at shift ``pad+1`` (exact zero-fill shift) plus weight
    ``h`` at shift ``pad`` *excluding its first sample* — so one correction
    per (d, m): subtract ``h * s[m, 0]`` at output position ``pad``.
    """
    whole, h = geometry.lerp_coefficients(cfg)
    D = cfg.n_directions
    wh = whole.reshape(D, -1).astype(np.int64)
    hh = h.reshape(D, -1).astype(np.float32)
    shifts = np.stack([wh, wh + 1], axis=-1)                        # (D, M, 2)
    weights = np.stack([hh, 1.0 - hh], axis=-1)
    T = int(shifts.max()) + 1
    W = _scatter_w(shifts, weights, 0, T)
    Wc, corr_js = _build_corrections(
        [(0, hh, wh)], D, hh.shape[1])
    return _tables(cfg, W, "lerp", 0, Wc, corr_js)


def make_convolve_tables(cfg: Config) -> SteeringTables:
    """Convolve-and-sum (``convolve_and_sum.c:73-87``):

    ``out[i] += h[k] * padded[i+k]`` with ``padded`` = signal zero-padded by
    ``off = n_taps//2`` — i.e. weight ``h[k]`` at shift ``off - k`` for every
    k; ``i`` spans the whole frame so there are no boundary corrections
    (negative shifts advance the signal with head truncation — exactly what
    the zero-padding does).
    """
    taps = geometry.convolve_coefficients(cfg)                      # (X,Y,M,K)
    D = cfg.n_directions
    K = cfg.n_taps
    off = K // 2
    hh = taps.reshape(D, -1, K).astype(np.float32)
    k = np.arange(K)
    shifts = np.broadcast_to(off - k, hh.shape).astype(np.int64)
    tau_min = off - K + 1
    T = K
    W = _scatter_w(shifts, hh, tau_min, T)
    return _tables(cfg, W, "convolve", tau_min)


def make_hybrid_tables(cfg: Config) -> SteeringTables:
    """Hybrid convolve-and-sum (``hybrid_convolve_and_sum.c:51-64``):

    ``out[pad+i+1] += h[k] * padded[i+k]`` for ``i in [0, N-pad-1)`` — weight
    ``h[k]`` at shift ``pad + 1 + off - k``.  The ``i >= 0`` bound cuts, for
    taps ``k > off``, the products with ``s[m, j]`` for ``j < k-off``; those
    are subtracted as corrections at position ``j + pad + 1 + off - k``
    (positions < 0 never existed in the C output and are masked out).
    """
    whole, taps = geometry.hybrid_coefficients(cfg)
    D = cfg.n_directions
    K = cfg.n_taps
    off = K // 2
    wh = whole.reshape(D, -1).astype(np.int64)                      # (D, M)
    hh = taps.reshape(D, -1, K).astype(np.float32)                  # (D, M, K)
    k = np.arange(K)
    shifts = wh[..., None] + 1 + off - k                            # (D, M, K)
    tau_min = int(shifts.min())
    T = int(shifts.max()) - tau_min + 1
    W = _scatter_w(shifts, hh, tau_min, T)

    entries = []
    for kk in range(off + 1, K):
        for j in range(kk - off):
            entries.append((j, hh[:, :, kk], j + wh + 1 + off - kk))
    Wc, corr_js = _build_corrections(entries, D, hh.shape[1])
    return _tables(cfg, W, "hybrid", tau_min, Wc, corr_js)


def _build_corrections(entries, D: int, M: int):
    """entries: list of (signal_index_j, weight (D, M), out_pos (D, M)).

    Packs them into the dense one-hot tensor ``Wc[j_group, d, t, m]`` with
    positions past the max kept column or below 0 dropped (those products
    never existed in the C output)."""
    if not entries:
        return None, ()
    tc = max(int(pos.max()) for _, _, pos in entries) + 1
    groups = {}
    for j, w, pos in entries:
        groups.setdefault(j, []).append((w, pos))
    corr_js = tuple(sorted(groups))
    Wc = np.zeros((len(corr_js), D, tc, M), np.float32)
    d_idx = np.repeat(np.arange(D), M)
    m_idx = np.tile(np.arange(M), D)
    for gi, j in enumerate(corr_js):
        for w, pos in groups[j]:
            p = pos.reshape(-1)
            ok = p >= 0
            np.add.at(Wc[gi], (d_idx[ok], p[ok], m_idx[ok]),
                      w.reshape(-1)[ok].astype(np.float32))
    return Wc, corr_js


# bump when any table builder's output changes for the same config (the
# on-disk cache would otherwise serve tables built by the old code)
_TABLE_GEOMETRY_VERSION = 2


def make_tables(cfg: Config, algorithm: str,
                cache: bool = True) -> SteeringTables:
    """Build (or load from the on-disk table cache) the steering tables.

    The reference recomputes every coefficient table at process start
    (``main.pyx:177-181``); table design for the full config costs a few
    seconds of host FIR math, so built tables are cached under
    ``<checkout>/.cache/tables`` (override with ``ZRT_TABLE_CACHE_DIR``)
    keyed by the geometry-relevant config fields.
    """
    builder = {
        "pad": make_pad_tables,
        "lerp": make_lerp_tables,
        "convolve": make_convolve_tables,
        "hybrid": make_hybrid_tables,
        "truncated": make_truncated_tables,
    }[algorithm]
    if not cache:
        return builder(cfg)

    import hashlib
    import os

    # _TABLE_GEOMETRY_VERSION must be bumped whenever a geometry/table
    # builder's OUTPUT changes for the same config — otherwise the cache
    # silently serves tables built by the old code (v2: round-3
    # multi-slot quirk parity fix changed the truncated tables)
    key_fields = (algorithm, _TABLE_GEOMETRY_VERSION,
                  cfg.n_microphones, cfg.n_samples, cfg.n_taps,
                  cfg.columns, cfg.rows, cfg.max_res_x, cfg.max_res_y,
                  cfg.z_scan, cfg.max_angle, cfg.view_angle, cfg.sample_rate,
                  cfg.element_distance, cfg.array_slots, cfg.skip_n_mics,
                  cfg.propagation_speed, cfg.aspect_ratio, cfg.unused_mics,
                  cfg.matmul_dtype)
    key = hashlib.sha1(repr(key_fields).encode()).hexdigest()[:16]
    from .. import paths

    cdir = os.environ.get("ZRT_TABLE_CACHE_DIR") or paths.cache_dir("tables")
    path = os.path.join(cdir, f"{algorithm}-{key}.npz")
    if os.path.exists(path):
        # cache entries are always f32 on disk (npz cannot round-trip
        # ml_dtypes bf16 — it loads back as an uncastable void dtype);
        # the table dtype is re-applied on load.  A corrupt/stale entry
        # falls through to a rebuild.
        try:
            z = np.load(path, allow_pickle=False)
            W = jnp.asarray(np.asarray(z["W"], np.float32),
                            jnp.dtype(cfg.matmul_dtype))
            Wc = (jnp.asarray(np.asarray(z["Wc"], np.float32))
                  if "Wc" in z else None)
            tau_min, corr_js = int(z["tau_min"]), tuple(
                int(j) for j in z["corr_js"])
        except (OSError, ValueError, KeyError, TypeError):
            pass
        else:
            active, _ = geometry.active_microphones(cfg)
            return SteeringTables(
                W=W, Wc=Wc,
                adaptive=jnp.asarray(active, jnp.int32),
                tau_min=tau_min, corr_js=corr_js,
                precision=cfg.matmul_precision,
                n_samples=cfg.n_samples, res_x=cfg.max_res_x,
                res_y=cfg.max_res_y, algorithm=algorithm)
    t = builder(cfg)
    try:
        os.makedirs(cdir, exist_ok=True)
        arrays = dict(W=np.asarray(t.W, dtype=np.float32),
                      tau_min=np.int64(t.tau_min),
                      corr_js=np.asarray(t.corr_js, np.int64))
        if t.Wc is not None:
            arrays["Wc"] = np.asarray(t.Wc, dtype=np.float32)
        np.savez(path, **arrays)
    except OSError:
        pass
    return t


# ---------------------------------------------------------------------------
# Runtime (jit)
# ---------------------------------------------------------------------------

def delay_lines(s: jax.Array, tau_min: int, T: int,
                stack_axis: int = -3) -> jax.Array:
    """(..., M, N) -> shifted copies stacked at ``stack_axis``
    (default: (..., T, M, N)).

    ``out[t]`` holds ``s[..., m, n - (tau_min+t)]`` with zeros outside —
    the C ``pad_delay`` semantics (``pad_and_sum.c:41-47``) for positive
    shifts and head-truncation for negative ones.
    """
    N = s.shape[-1]
    batch_pad = [(0, 0)] * (s.ndim - 1)
    rows = []
    for t in range(T):
        tau = tau_min + t
        if tau >= N or tau <= -N:
            rows.append(jnp.zeros_like(s))
        elif tau >= 0:
            rows.append(jnp.pad(s[..., : N - tau], batch_pad + [(tau, 0)]))
        else:
            rows.append(jnp.pad(s[..., -tau:], batch_pad + [(0, -tau)]))
    return jnp.stack(rows, axis=stack_axis)


def _apply_corrections(beams: jax.Array, s: jax.Array,
                       t: SteeringTables) -> jax.Array:
    """Subtract the exact boundary terms.  beams: (B, D, N); s: (B, M, N).

    ``corr[b, d, t'] = sum_j sum_m Wc[j, d, t', m] * s[b, m, corr_js[j]]``
    applied to the first Tc output columns — an einsum plus a static slice
    update, no runtime scatter.
    """
    if t.Wc is None:
        return beams
    dt = beams.dtype
    sj = jnp.stack([s[:, :, j] for j in t.corr_js], axis=1)        # (B, J, M)
    corr = jnp.einsum("jdtm,bjm->bdt", t.Wc.astype(dt), sj.astype(dt),
                      precision=t.lax_precision)
    tc = corr.shape[-1]
    return beams.at[:, :, :tc].add(-corr)


def _apply_corrections_dbn(beams: jax.Array, s: jax.Array,
                           t: SteeringTables) -> jax.Array:
    """Same boundary terms in (D, B, N) layout (no beam transpose)."""
    if t.Wc is None:
        return beams
    dt = beams.dtype
    sj = jnp.stack([s[:, :, j] for j in t.corr_js], axis=1)        # (B, J, M)
    corr = jnp.einsum("jdtm,bjm->dbt", t.Wc.astype(dt), sj.astype(dt),
                      precision=t.lax_precision)
    tc = corr.shape[-1]
    return beams.at[:, :, :tc].add(-corr)


@partial(jax.jit, static_argnames=("mean_power",))
def steered_beams(signals: jax.Array, t: SteeringTables,
                  mean_power: bool = False) -> jax.Array:
    """All-direction beams (B, D, N) — or mean power (B, X, Y).

    ``signals``: (B, n_channels, N) or (n_channels, N) float32, full channel
    axis (active-mic gather happens here, mirroring the ``adaptive_array``
    argument of ``mimo_*``).
    """
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    B = signals.shape[0]
    N = t.n_samples
    D = t.n_directions
    M = t.n_mics
    acc_dtype = jnp.promote_types(t.W.dtype, jnp.float32)
    # Build the delay lines in (T, M, B, N) layout so the contraction is one
    # plain (D, T*M) @ (T*M, B*N) matmul — the shape XLA tiles best — with
    # no large transposes on either side.
    s_mbn = signals[:, t.adaptive, :].astype(t.W.dtype).transpose(1, 0, 2)
    sdel = delay_lines(s_mbn, t.tau_min, t.n_taps_line,
                       stack_axis=0)                                # (T,M,B,N)
    T = sdel.shape[0]
    # The default matmul precision silently truncates operands to bf16;
    # tables carry an explicit precision ("highest" for the exactness
    # gates, "high"/"default" as faster quality points — see Config).
    beams = jax.lax.dot_general(
        t.W.reshape(D, T * M), sdel.reshape(T * M, B * N),
        ((( 1,), (0,)), ((), ())),
        preferred_element_type=acc_dtype,
        precision=t.lax_precision,
    ).reshape(D, B, N)
    beams = _apply_corrections_dbn(
        beams, signals[:, t.adaptive, :].astype(acc_dtype), t)
    if mean_power:
        beams = beams / jnp.asarray(M, acc_dtype)
        power = jnp.mean(beams * beams, axis=-1)                    # (D, B)
        power = power.T.reshape(B, t.res_x, t.res_y)
        return power[0] if squeeze else power
    beams = beams.transpose(1, 0, 2)                                # (B, D, N)
    return beams[0] if squeeze else beams


def steered_power(signals: jax.Array, t: SteeringTables) -> jax.Array:
    """The MIMO heatmap: ``image[x, y] = sum((beam/n)**2)/N`` exactly as
    ``pad_and_sum.c:122-131``.  (B, X, Y) or (X, Y)."""
    return steered_beams(signals, t, mean_power=True)


@jax.jit
def miso_beam(signals: jax.Array, t: SteeringTables,
              direction: jax.Array) -> jax.Array:
    """Single-direction beam (the MISO path, ``pad_and_sum.c:54-70`` /
    ``lerp_and_sum.c:67-92``): raw mic sum, NOT divided by n (the caller
    applies gain/normalization, as ``api.c:517-522`` does).

    ``direction``: flat grid index d = x * res_y + y (traced — steering
    changes do not retrigger compilation, unlike the reference's
    recompile-on-config model).
    """
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    s = signals[:, t.adaptive, :]                                   # (B, M, N)
    Wd = jax.lax.dynamic_index_in_dim(t.W, direction, 0, keepdims=False)
    G = jnp.einsum("tm,bmn->btn", Wd.astype(jnp.float32),
                   s.astype(jnp.float32),
                   precision=t.lax_precision)                       # (B, T, N)
    N = t.n_samples
    beam = jnp.zeros((signals.shape[0], N), jnp.float32)
    for ti in range(t.n_taps_line):
        tau = t.tau_min + ti
        if tau >= 0:
            beam = beam + jnp.pad(G[:, ti, : N - tau], ((0, 0), (tau, 0)))
        else:
            beam = beam + jnp.pad(G[:, ti, -tau:], ((0, 0), (0, -tau)))
    if t.Wc is not None:
        Wcd = jax.lax.dynamic_index_in_dim(t.Wc, direction, 1,
                                           keepdims=False)          # (J,Tc,M)
        sj = jnp.stack([s[:, :, j] for j in t.corr_js], axis=1)     # (B,J,M)
        corr = jnp.einsum("jtm,bjm->bt", Wcd.astype(jnp.float32),
                          sj.astype(jnp.float32),
                          precision=jax.lax.Precision.HIGHEST)
        tc = corr.shape[-1]
        beam = beam.at[:, :tc].add(-corr)
    return beam[0] if squeeze else beam


def make_miso_tables(cfg: Config, azimuth_deg: float,
                     elevation_deg: float) -> SteeringTables:
    """Single-direction pad tables from the angle delay model — parity with
    ``load_coefficients_pad2``/``miso_pad2`` (``pad_and_sum.c:77-92,153``),
    which steers with a dedicated per-mic whole-sample table computed by
    ``calculate_delay_miso`` (``directions.pyx:159-187``).  Use with
    ``miso_beam(signals, tables, 0)``."""
    delays = geometry.calculate_delay_miso(cfg, azimuth_deg, elevation_deg)
    active, _ = geometry.active_microphones(cfg)
    whole = delays[active].reshape(1, 1, -1)
    one = dataclasses.replace(
        cfg.replace(max_res_x=1, max_res_y=1))
    return make_pad_tables(one, whole)


def miso_beams_multi(signals: jax.Array, t: SteeringTables,
                     directions: jax.Array) -> jax.Array:
    """Beams for several steering directions at once, (B, K, N) — the
    batched form (one device program instead of K dispatches)."""
    fn = lambda d: miso_beam(signals, t, d)
    out = jax.vmap(fn)(jnp.asarray(directions))
    # batched input: vmap produced (K, B, N) -> (B, K, N).  (moveaxis
    # destination must be -2: with a 3-D array, destination -3 IS axis 0
    # and the old code silently returned direction-major data.)
    return jnp.moveaxis(out, 0, -2) if out.ndim > 2 else out


def steer_index(cfg: Config, azimuth_deg: float, elevation_deg: float) -> int:
    """Map (azimuth, elevation) degrees in [-90, 90] to a flat grid index.

    Follows ``main.pyx:498-515`` (``steer_cartesian_degree``) for the
    degree->cell quantization; the cell->flat-offset mapping here is the
    geometrically consistent ``x * res_y + y`` (the reference computes a
    byte offset that disagrees with its own table layout — a known quirk we
    do not reproduce; see SURVEY.md §3.3).
    """
    az = int((azimuth_deg + 90.0) / 180.0 * cfg.max_res_x)
    el = int((elevation_deg + 90.0) / 180.0 * cfg.max_res_y)
    az = min(max(az, 0), cfg.max_res_x - 1)
    el = min(max(el, 0), cfg.max_res_y - 1)
    return az * cfg.max_res_y + el
