"""Frequency-domain beamformers: phase-shift (Bartlett) and MVDR (Capon).

The phase-shift path reproduces the reference web app's third backend
(``PC/application/realtime_scripts/beam_forming_algorithm.py:30-70``):
rfft each mic, keep a frequency band, multiply by the precomputed steering
tensor, and sum ``|sum_mics|^2`` over frequencies.

Formulation: a DFT of a 256-sample frame is a small matmul, and every
operation here is expressed over explicit (re, im) float32 planes:

* rfft        -> two real matmuls against precomputed DFT bases;
* steering    -> four real einsums (complex multiply expanded);
* covariance  -> real/imag outer products;
* MVDR solve  -> the Hermitian system lifted to its real 2Mx2M block form
                 ``[[Re, -Im], [Im, Re]]``.

MVDR is the adaptive extension named in the project north star: streaming
per-bin spatial covariance (EMA), trace-scaled diagonal loading, Capon
spectrum ``P(d) = 1 / (a^H R^{-1} a)``, and a distortionless
single-direction beam returned to the time domain by an inverse-DFT matmul.
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

_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FreqTables:
    """Steering tensor + DFT bases for the selected rfft band."""

    phase_re: jax.Array         # (F, M, D) float32
    phase_im: jax.Array         # (F, M, D) float32
    dft_re: jax.Array           # (N, F) float32 — rfft basis, selected bins
    dft_im: jax.Array           # (N, F) float32
    idft_re: jax.Array          # (F, N) float32 — band-limited irfft basis
    idft_im: jax.Array          # (F, N) float32
    adaptive: jax.Array         # (M,) int32
    lo: int = dataclasses.field(metadata=dict(static=True))
    hi: int = dataclasses.field(metadata=dict(static=True))
    res_x: int = dataclasses.field(metadata=dict(static=True))
    res_y: int = dataclasses.field(metadata=dict(static=True))
    n_samples: int = dataclasses.field(metadata=dict(static=True))


def make_freq_tables(cfg: Config, freq_low: Optional[float] = None,
                     freq_high: Optional[float] = None) -> FreqTables:
    """Band limits default to the config's ``freq_band_low/high``
    (``realtime_scripts/config.py:47-48`` threshold_freq_lower/upper);
    the mic model follows ``cfg.fft_mic_model``."""
    if freq_low is None:
        freq_low = cfg.freq_band_low
    if freq_high is None and cfg.freq_band_high > 0:
        freq_high = cfg.freq_band_high
    phase, (lo, hi) = geometry.phase_shift_tensor(cfg, freq_low, freq_high)
    F, M, X, Y = phase.shape
    # the channel gather must use the SAME mic selection the phase tensor
    # was built over (the fft model spans active_arrays boards, the main
    # model spans array_slots — they differ off the shipped profiles)
    if cfg.fft_mic_model == "fft":
        active, _ = geometry.active_microphones_fft(cfg)
    else:
        active, _ = geometry.active_microphones(cfg)
    assert len(active) == M, (len(active), M)

    N = cfg.n_samples
    n = np.arange(N)[:, None]
    f = np.arange(lo, hi)[None, :]
    ang = -2.0 * np.pi * n * f / N
    dft_re = np.cos(ang)
    dft_im = np.sin(ang)
    # irfft of a band-limited spectrum: x[n] = (1/N) sum_f c_f (re cos + im·(-sin))
    # with c_f = 1 for the DC and Nyquist bins, else 2.
    c = np.where((f == 0) | (f == N // 2), 1.0, 2.0)
    iang = 2.0 * np.pi * f.T * np.arange(N)[None, :] / N
    idft_re = (c.T * np.cos(iang)) / N
    idft_im = (-c.T * np.sin(iang)) / N

    return FreqTables(
        phase_re=jnp.asarray(phase.real.reshape(F, M, X * Y), jnp.float32),
        phase_im=jnp.asarray(phase.imag.reshape(F, M, X * Y), jnp.float32),
        dft_re=jnp.asarray(dft_re, jnp.float32),
        dft_im=jnp.asarray(dft_im, jnp.float32),
        idft_re=jnp.asarray(idft_re, jnp.float32),
        idft_im=jnp.asarray(idft_im, jnp.float32),
        adaptive=jnp.asarray(active, jnp.int32),
        lo=lo, hi=hi, res_x=X, res_y=Y, n_samples=cfg.n_samples,
    )


def _frame_fft(signals: jax.Array, t: FreqTables) -> Tuple[jax.Array, jax.Array]:
    """(B, channels, N) -> band-limited spectra (re, im), each (B, F, M)."""
    s = signals[:, t.adaptive, :].astype(jnp.float32)
    re = jnp.einsum("bmn,nf->bfm", s, t.dft_re, precision=_HI)
    im = jnp.einsum("bmn,nf->bfm", s, t.dft_im, precision=_HI)
    return re, im


@jax.jit
def fft_steered_power(signals: jax.Array, t: FreqTables,
                      bin_weights: Optional[jax.Array] = None) -> jax.Array:
    """Bartlett steered power (B, X, Y): ``sum_f |sum_m S[f,m] P[f,m,d]|^2``.

    Matches ``beam_forming_algorithm.main`` before its normalize/threshold
    step (display logic; see :func:`normalize_heatmap`).

    ``bin_weights`` (F,) scales each bin's contribution to the sum — used
    by the sharded path (``parallel.mesh.shard_freq_tables``) to mask the
    bins that pad F to a device-count multiple.
    """
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    sr, si = _frame_fft(signals, t)                   # (B, F, M)
    rr = jnp.einsum("bfm,fmd->bfd", sr, t.phase_re, precision=_HI)
    ii = jnp.einsum("bfm,fmd->bfd", si, t.phase_im, precision=_HI)
    ri = jnp.einsum("bfm,fmd->bfd", sr, t.phase_im, precision=_HI)
    ir = jnp.einsum("bfm,fmd->bfd", si, t.phase_re, precision=_HI)
    re_d = rr - ii
    im_d = ri + ir
    per_bin = re_d * re_d + im_d * im_d
    if bin_weights is not None:
        per_bin = per_bin * bin_weights[None, :, None]
    power = jnp.sum(per_bin, axis=1)                  # (B, D)
    power = power.reshape(-1, t.res_x, t.res_y)
    return power[0] if squeeze else power


def normalize_heatmap(power: jax.Array, threshold: float = 0.2) -> jax.Array:
    """The reference's display normalization (``beam_forming_algorithm.py:
    57-63``): zero the map unless its max exceeds ``threshold``, else divide
    by the max."""
    mx = jnp.max(power)
    return jnp.where(mx < threshold, jnp.zeros_like(power), power / mx)


@jax.jit
def fft_power_spectrum(signals: jax.Array, t: FreqTables) -> jax.Array:
    """Per-frequency-bin steered power (B, F, X, Y) — the ``FFT_power``
    intermediate of ``beam_forming_algorithm.main`` (line 53) before the
    sum over frequencies; input to :func:`peak_detection`."""
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    sr, si = _frame_fft(signals, t)
    rr = jnp.einsum("bfm,fmd->bfd", sr, t.phase_re, precision=_HI)
    ii = jnp.einsum("bfm,fmd->bfd", si, t.phase_im, precision=_HI)
    ri = jnp.einsum("bfm,fmd->bfd", sr, t.phase_im, precision=_HI)
    ir = jnp.einsum("bfm,fmd->bfd", si, t.phase_re, precision=_HI)
    re_d = rr - ii
    im_d = ri + ir
    power = (re_d * re_d + im_d * im_d).reshape(
        signals.shape[0], -1, t.res_x, t.res_y)
    return power[0] if squeeze else power


@jax.jit
def peak_detection(power_f: jax.Array, t: FreqTables,
                   threshold_upper: float = 0.8,
                   threshold_lower: float = 0.1) -> jax.Array:
    """Per-frequency-bin peak map (X, Y) — ``beam_forming_algorithm.py:
    37-48`` (present upstream but disabled in its ``main()``).

    For every bin whose grid maximum exceeds both ``threshold_upper *
    global_max`` and ``threshold_lower``, the bin's peak value is written at
    its argmax cell, keeping the largest across bins.  Reference quirk kept:
    the function slices ``power_in[threshold_freq_lower_idx:]`` even though
    its input already starts at that band index (line 39) — a double cut
    whenever the lower band edge is above bin 0.
    """
    power = power_f[t.lo:]                       # the double-slice quirk
    F = power.shape[0]
    flat = power.reshape(F, -1)                  # (F, X*Y)
    pmax = jnp.max(flat, axis=1)                 # (F,)
    amax = jnp.argmax(flat, axis=1)              # first occurrence, like C
    qual = (pmax > threshold_upper * jnp.max(pmax)) & (pmax > threshold_lower)
    contrib = jnp.where(qual, pmax, 0.0)
    onehot = jax.nn.one_hot(amax, flat.shape[1], dtype=power.dtype)
    heat = jnp.max(onehot * contrib[:, None], axis=0)
    return heat.reshape(t.res_x, t.res_y)


# ---------------------------------------------------------------------------
# MVDR (Capon)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CovarianceState:
    """Streaming per-bin spatial covariance R[f] (EMA over frames)."""

    R_re: jax.Array             # (F, M, M) float32
    R_im: jax.Array             # (F, M, M) float32
    count: jax.Array            # () int32 — update steps absorbed


def init_covariance(t: FreqTables) -> CovarianceState:
    F = t.hi - t.lo
    M = t.phase_re.shape[1]
    eye = jnp.broadcast_to(jnp.eye(M, dtype=jnp.float32), (F, M, M))
    return CovarianceState(R_re=eye, R_im=jnp.zeros((F, M, M), jnp.float32),
                           count=jnp.zeros((), jnp.int32))


@jax.jit
def update_covariance(state: CovarianceState, signals: jax.Array,
                      t: FreqTables, alpha: float = 0.9) -> CovarianceState:
    """EMA update ``R <- alpha R + (1-alpha) mean_b(S S^H)`` per bin.

    ``S S^H`` expanded: Re = sr sr^T + si si^T; Im = si sr^T - sr si^T.
    """
    if signals.ndim == 2:
        signals = signals[None]
    sr, si = _frame_fft(signals, t)                    # (B, F, M)
    B = signals.shape[0]
    o_re = (jnp.einsum("bfm,bfn->fmn", sr, sr, precision=_HI)
            + jnp.einsum("bfm,bfn->fmn", si, si, precision=_HI)) / B
    o_im = (jnp.einsum("bfm,bfn->fmn", si, sr, precision=_HI)
            - jnp.einsum("bfm,bfn->fmn", sr, si, precision=_HI)) / B
    is_first = state.count == 0
    R_re = jnp.where(is_first, o_re, alpha * state.R_re + (1 - alpha) * o_re)
    R_im = jnp.where(is_first, o_im, alpha * state.R_im + (1 - alpha) * o_im)
    return CovarianceState(R_re=R_re, R_im=R_im, count=state.count + 1)


def _loaded(state: CovarianceState, diagonal_loading: float):
    F, M, _ = state.R_re.shape
    tr = jnp.einsum("fmm->f", state.R_re) / M
    load = diagonal_loading * tr + 1e-12
    R_re = state.R_re + load[:, None, None] * jnp.eye(M, dtype=jnp.float32)
    return R_re, state.R_im


def _solve_hermitian(R_re, R_im, b_re, b_im):
    """Solve the complex Hermitian-PD system R x = b.

    R is carried as (re, im) planes and the solve runs on the real 2Mx2M
    block isomorphism
    ``[[Re, -Im], [Im, Re]]`` — symmetric positive definite whenever R is
    Hermitian PD (the trace-scaled diagonal loading guarantees that), so a
    **Cholesky** factorization + two triangular solves: half the flops of
    an LU, no pivoting, and the block form costs the same real flops as a
    native complex Cholesky would.

    R: (F, M, M) hermitian (R_re symmetric, R_im antisymmetric);
    b: (F, M, K).  Returns (x_re, x_im) each (F, M, K).
    """
    F, M, _ = R_re.shape
    top = jnp.concatenate([R_re, -R_im], axis=2)
    bot = jnp.concatenate([R_im, R_re], axis=2)
    big = jnp.concatenate([top, bot], axis=1)          # (F, 2M, 2M) sym PD
    rhs = jnp.concatenate([b_re, b_im], axis=1)        # (F, 2M, K)
    L = jnp.linalg.cholesky(big)
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    x = jax.scipy.linalg.solve_triangular(L, y, lower=True, trans=1)
    return x[:, :M, :], x[:, M:, :]


def _trtri_blocked(L: jax.Array, base: int = 64) -> jax.Array:
    """Invert batched lower-triangular ``(F, n, n)`` matrices bottom-up:
    ONE batched ``solve_triangular`` over all n/base diagonal leaf blocks,
    then log2(n/base) levels of batched matmul merges via::

        inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]]

    The XLA triangular-solve lowers to a panel loop whose serial depth
    scales with n; restructuring as leaf-batch + matmul merges turns the
    work into batched matmuls instead (the merge work is exactly the
    solve's flops, reassociated).  This is LAPACK ``trtri``'s blocked recursion with the
    independent diagonal subproblems batched into single dispatches.
    """
    F, n, _ = L.shape
    nb = n // base
    if n <= base or n % base or (nb & (nb - 1)):
        eye = jnp.broadcast_to(jnp.eye(n, dtype=L.dtype), L.shape)
        return jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    # all nb diagonal leaf blocks in one batched triangular solve
    Lb = L.reshape(F, nb, base, nb, base)
    ii = jnp.arange(nb)
    diag = jnp.moveaxis(Lb[:, ii, :, ii, :], 0, 1)     # (F, nb, base, base)
    eye = jnp.broadcast_to(jnp.eye(base, dtype=L.dtype), diag.shape)
    inv = jax.scipy.linalg.solve_triangular(
        diag.reshape(F * nb, base, base),
        eye.reshape(F * nb, base, base), lower=True).reshape(diag.shape)
    m, k = base, nb
    while k > 1:
        k2 = k // 2
        Ai, Ci = inv[:, 0::2], inv[:, 1::2]            # (F, k2, m, m)
        Lv = L.reshape(F, k, m, k, m)
        rows, cols = 2 * jnp.arange(k2) + 1, 2 * jnp.arange(k2)
        B = jnp.moveaxis(Lv[:, rows, :, cols, :], 0, 1)   # (F, k2, m, m)
        off = -jnp.einsum("fkab,fkbc,fkcd->fkad", Ci, B, Ai, precision=_HI)
        top = jnp.concatenate([Ai, jnp.zeros_like(Ai)], axis=-1)
        bot = jnp.concatenate([off, Ci], axis=-1)
        inv = jnp.concatenate([top, bot], axis=-2)     # (F, k2, 2m, 2m)
        m, k = 2 * m, k2
    return inv[:, 0]


def invert_hermitian(R_re: jax.Array, R_im: jax.Array,
                     base: int = 32) -> Tuple[jax.Array, jax.Array]:
    """Invert batched Hermitian-PD ``R`` given as (re, im) planes.

    LAPACK ``potri`` on the real 2Mx2M block embedding — Cholesky, then
    blocked triangular inversion (:func:`_trtri_blocked`), then one
    K=M syrk (the embedding inverse is ``[[P_re, -P_im], [P_im, P_re]]``
    so only its first M columns are needed).  Same cond(R)*eps error
    class as a factor+solve; the solve's panel-serial triangular sweeps
    become one batched leaf solve + matmul merges.  Rejected
    alternatives:

    * complex-structure Schur reduction ``P_re = (X + Y X^-1 Y)^-1``
      (two M-size SPD inversions): forms ``X^-1`` explicitly, squaring
      the effective condition number — fails the coherent near-rank-1
      gate (test_mvdr_ill_conditioned_single_source) at resid 0.24 vs
      the factorization path's 9e-4;
    * Newton-Schulz from the drifted P: diverges — the refresh
      re-anchors the diagonal loading, so ``norm(I - R P_drift) ~ 1``.
    """
    F, M, _ = R_re.shape
    top = jnp.concatenate([R_re, -R_im], axis=2)
    bot = jnp.concatenate([R_im, R_re], axis=2)
    big = jnp.concatenate([top, bot], axis=1)          # (F, 2M, 2M) sym PD
    # the embedding is symmetric by construction (up to the estimator's
    # own einsum rounding) — skip cholesky's (A + A^T)/2 pre-pass, an
    # extra pass over the 133 MB batch
    L = jax.lax.linalg.cholesky(big, symmetrize_input=False)
    Li = _trtri_blocked(L, base)
    # Rinv[:, :M] = Li^T @ Li[:, :, :M].  NO Hermitian re-projection: the
    # f32 embedding factorization breaks the [[re,-im],[im,re]] structure
    # by ~cond*eps in directions where R is small, but those errors
    # CANCEL in R @ P; projecting onto exact (sym, antisym) planes was
    # measured to move P by half the violation in non-cancelling
    # directions (R@P residual 9e-4 -> 0.24 on the rank-4 refresh gate).
    # The factor+solve path this replaces had the same un-projected
    # structure violation and every Woodbury consumer tolerates it.
    cols = jnp.einsum("fkm,fkn->fmn", Li, Li[:, :, :M], precision=_HI)
    return cols[:, :M, :], cols[:, M:, :]


# -- unrolled complex potri -------------------------------------------------
#
# A recursive blocked Cholesky + triangular inverse whose leaves are
# STATICALLY UNROLLED rank-1 / forward-substitution steps (ordinary fused
# elementwise ops) and whose merges are matmuls: no XLA While loop and no
# factorization custom call.  It works directly on the complex (re, im)
# planes — half the sequential depth (M steps, not 2M) and the same real
# FLOPs as the 2Mx2M embedding.


def _cmm(ar, ai, br, bi, prec=_HI):
    """Complex matmul on (re, im) planes: (..., m, k) @ (..., k, n)."""
    rr = (jnp.einsum("...mk,...kn->...mn", ar, br, precision=prec)
          - jnp.einsum("...mk,...kn->...mn", ai, bi, precision=prec))
    ri = (jnp.einsum("...mk,...kn->...mn", ar, bi, precision=prec)
          + jnp.einsum("...mk,...kn->...mn", ai, br, precision=prec))
    return rr, ri


def _ct(ar, ai):
    """Conjugate transpose on planes."""
    return jnp.swapaxes(ar, -1, -2), -jnp.swapaxes(ai, -1, -2)


def _chol_unrolled_c(Ar, Ai):
    """Batched complex Hermitian-PD Cholesky leaf: b statically unrolled
    right-looking rank-1 steps (b = static trailing dim, keep <= 32)."""
    b = Ar.shape[-1]
    idx = jnp.arange(b)
    cols_r, cols_i = [], []
    for j in range(b):
        d = jnp.sqrt(jnp.maximum(Ar[..., j, j], 1e-30))[..., None]
        keep = idx >= j
        cr = jnp.where(keep, Ar[..., :, j] / d, 0.0)
        ci = jnp.where(keep, Ai[..., :, j] / d, 0.0)
        cols_r.append(cr)
        cols_i.append(ci)
        # trailing update A -= c c^H (outer products; rows < j are
        # masked to zero in c so the update only touches [j:, j:])
        Ar = Ar - (cr[..., :, None] * cr[..., None, :]
                   + ci[..., :, None] * ci[..., None, :])
        Ai = Ai - (ci[..., :, None] * cr[..., None, :]
                   - cr[..., :, None] * ci[..., None, :])
    return jnp.stack(cols_r, -1), jnp.stack(cols_i, -1)


def _trtri_unrolled_c(Lr, Li):
    """Batched complex lower-triangular inverse leaf: b statically
    unrolled forward-substitution steps (right-looking rank-1 updates of
    the identity).  Assumes a REAL diagonal (true for Cholesky factors;
    the complex rank-1 step divides by the real sqrt)."""
    b = Lr.shape[-1]
    idx = jnp.arange(b)
    Br = jnp.broadcast_to(jnp.eye(b, dtype=Lr.dtype), Lr.shape)
    Bi = jnp.zeros_like(Br)
    rows_r, rows_i = [], []
    for j in range(b):
        d = Lr[..., j, j][..., None]
        yr = Br[..., j, :] / d
        yi = Bi[..., j, :] / d
        rows_r.append(yr)
        rows_i.append(yi)
        below = (idx > j)[:, None]
        lr = Lr[..., :, j][..., :, None]
        li = Li[..., :, j][..., :, None]
        Br = Br - jnp.where(below, lr * yr[..., None, :]
                            - li * yi[..., None, :], 0.0)
        Bi = Bi - jnp.where(below, lr * yi[..., None, :]
                            + li * yr[..., None, :], 0.0)
    return jnp.stack(rows_r, -2), jnp.stack(rows_i, -2)


def _chol_inv_blocked_c(Ar, Ai, leaf: int = 32):
    """Recursive blocked complex Cholesky WITH its triangular inverse:
    returns ``(Lr, Li, Tr, Ti)`` where ``A = L L^H`` and ``T = L^{-1}``.

    Halving recursion (LAPACK potrf+trtri fused so the panel's leaf
    inverse is computed once)::

        L11, T11 = rec(A11);  L21 = A21 T11^H
        L22, T22 = rec(A22 - L21 L21^H)
        T = [[T11, 0], [-T22 L21 T11, T22]]

    Leaves are unrolled (no XLA While); merges are matmuls at HIGHEST
    precision.  Same cond*eps class as the embedding potri path
    (gated by the rank-refresh and ill-conditioned tests).
    """
    n = Ar.shape[-1]
    if n <= leaf or n % 2:
        Lr, Li = _chol_unrolled_c(Ar, Ai)
        Tr, Ti = _trtri_unrolled_c(Lr, Li)
        return Lr, Li, Tr, Ti
    h = n // 2
    L11r, L11i, T11r, T11i = _chol_inv_blocked_c(
        Ar[..., :h, :h], Ai[..., :h, :h], leaf)
    t11hr, t11hi = _ct(T11r, T11i)
    L21r, L21i = _cmm(Ar[..., h:, :h], Ai[..., h:, :h], t11hr, t11hi)
    l21hr, l21hi = _ct(L21r, L21i)
    S21r, S21i = _cmm(L21r, L21i, l21hr, l21hi)
    L22r, L22i, T22r, T22i = _chol_inv_blocked_c(
        Ar[..., h:, h:] - S21r, Ai[..., h:, h:] - S21i, leaf)
    # off-diagonal of the inverse: -T22 L21 T11
    m1r, m1i = _cmm(L21r, L21i, T11r, T11i)
    offr, offi = _cmm(T22r, T22i, m1r, m1i)
    z = jnp.zeros_like(L21r)
    zT = jnp.swapaxes(z, -1, -2)
    Lr = jnp.concatenate([
        jnp.concatenate([L11r, zT], -1),
        jnp.concatenate([L21r, L22r], -1)], -2)
    Li = jnp.concatenate([
        jnp.concatenate([L11i, zT], -1),
        jnp.concatenate([L21i, L22i], -1)], -2)
    Tr = jnp.concatenate([
        jnp.concatenate([T11r, zT], -1),
        jnp.concatenate([-offr, T22r], -1)], -2)
    Ti = jnp.concatenate([
        jnp.concatenate([T11i, zT], -1),
        jnp.concatenate([-offi, T22i], -1)], -2)
    return Lr, Li, Tr, Ti


def invert_hermitian_unrolled(R_re: jax.Array, R_im: jax.Array,
                              leaf: int = 32
                              ) -> Tuple[jax.Array, jax.Array]:
    """Hermitian-PD inverse with NO XLA While loop anywhere: blocked
    complex potri with statically-unrolled leaves (see
    :func:`_chol_inv_blocked_c`), then ``P = T^H T``.

    The production refresh path; :func:`invert_hermitian` (the 2Mx2M
    embedding through ``jax.lax.linalg.cholesky``) remains as the
    reference implementation.
    """
    _, _, Tr, Ti = _chol_inv_blocked_c(R_re, R_im, leaf)
    thr, thi = _ct(Tr, Ti)
    return _cmm(thr, thi, Tr, Ti)


@partial(jax.jit, static_argnames=("grid_precision",))
def mvdr_power(state: CovarianceState, t: FreqTables,
               diagonal_loading: float = 1e-3,
               grid_precision: str = "highest") -> jax.Array:
    """Capon spectrum (X, Y): ``P(d) = sum_f 1 / (a_d^H R_f^{-1} a_d)``.

    The Bartlett path computes ``|sum_m P_m S_m|^2`` so its implied steering
    vector is ``a = conj(P)``.  Diagonal loading scales with tr(R)/M per
    bin — the standard robustifier for a streaming estimate.

    The direction axis (D = 1824 at the reference grid) is huge, so
    instead of solving ``R x = a_d`` per direction each bin's R is
    inverted once (O(M^3), small) and ``a^H R^{-1} a`` is evaluated for
    ALL directions as two dense matmuls.

    ``grid_precision`` controls those two grid matmuls only (the Cholesky/
    inverse stays f32): "highest" for the exactness gates, "high" as the
    production point (TF32 on a GPU), "default" when the map feeds
    display/detection only.
    """
    prec = {"highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT}[grid_precision]
    R_re, R_im = _loaded(state, diagonal_loading)
    # R^{-1} via the potri-style inversion (see invert_hermitian)
    Pr, Pi = invert_hermitian(R_re, R_im)
    top = jnp.concatenate([Pr, -Pi], axis=2)
    bot = jnp.concatenate([Pi, Pr], axis=2)
    Rinv = jnp.concatenate([top, bot], axis=1)         # (F, 2M, 2M)
    # block-real steering vectors: a = conj(P)  =>  [a_re; a_im]
    a = jnp.concatenate([t.phase_re, -t.phase_im], axis=1)   # (F, 2M, D)
    # denom_d = a_d^T Rinv a_d  — batched matmul + reduce
    Ra = jnp.einsum("fmn,fnd->fmd", Rinv, a, precision=prec)
    denom = jnp.einsum("fmd,fmd->fd", a, Ra, precision=prec)
    denom = jnp.maximum(denom, 1e-12)
    power = jnp.sum(1.0 / denom, axis=0)
    return power.reshape(t.res_x, t.res_y)


# ---------------------------------------------------------------------------
# Real-time MVDR: streaming inverse covariance (RLS / Sherman-Morrison)
# ---------------------------------------------------------------------------
#
# The EMA update R <- alpha R + (1-alpha) s s^H is rank-1, so the INVERSE
# admits a closed-form Sherman-Morrison update costing O(F M^2) per frame —
# no per-frame O(F M^3) factorization.  This is the classic RLS recursion with forgetting factor
# alpha; f32 drift is bounded by a periodic exact refresh (refresh_precision)
# from the co-tracked covariance.

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PrecisionState:
    """Streaming inverse covariance P[f] ~= (R[f] + load*I)^-1, plus the
    covariance itself (used only for the periodic exact refresh)."""

    P_re: jax.Array             # (F, M, M) float32
    P_im: jax.Array             # (F, M, M) float32
    cov: CovarianceState
    load: float = dataclasses.field(metadata=dict(static=True))


def init_precision(t: FreqTables, load: float = 1e-3) -> PrecisionState:
    F = t.hi - t.lo
    M = t.phase_re.shape[1]
    eye = jnp.broadcast_to(jnp.eye(M, dtype=jnp.float32), (F, M, M))
    # cov starts at I (init_covariance), so P = (1+load)^-1 I
    return PrecisionState(P_re=eye / (1.0 + load),
                          P_im=jnp.zeros((F, M, M), jnp.float32),
                          cov=init_covariance(t), load=load)


def _cov_rank_update(cov: CovarianceState, sr: jax.Array, si: jax.Array,
                     alpha: float) -> CovarianceState:
    """Covariance after B sequential per-frame EMA steps, as ONE exact
    rank-B update: ``R_B = a^B R_0 + sum_i (1-a) a^{B-1-i} s_i s_i^H``
    (the sequential recursion's first-ever-frame REPLACEMENT gives the
    first column weight ``a^{B-1}`` and drops the prior).  Shared by
    :func:`update_precision` and :func:`update_precision_block` so the
    precision and its covariance co-estimate always track the SAME
    per-frame-discounted history, whatever the batch size."""
    B = sr.shape[0]
    aB = alpha ** B
    w = jnp.sqrt((1.0 - alpha)
                 * alpha ** (B - 1.0 - jnp.arange(B, dtype=jnp.float32)))
    is_first = cov.count == 0
    w_first = w.at[0].set(jnp.sqrt(jnp.float32(alpha) ** (B - 1)))
    w0 = jnp.where(is_first, w_first, w)
    Cr = jnp.einsum("b,bfm->fmb", w0, sr, precision=_HI)
    Ci = jnp.einsum("b,bfm->fmb", w0, si, precision=_HI)
    keep = jnp.where(is_first, 0.0, aB)
    R_re = (keep * cov.R_re
            + jnp.einsum("fmb,fnb->fmn", Cr, Cr, precision=_HI)
            + jnp.einsum("fmb,fnb->fmn", Ci, Ci, precision=_HI))
    R_im = (keep * cov.R_im
            + jnp.einsum("fmb,fnb->fmn", Ci, Cr, precision=_HI)
            - jnp.einsum("fmb,fnb->fmn", Cr, Ci, precision=_HI))
    return CovarianceState(R_re=R_re, R_im=R_im, count=cov.count + B)


@partial(jax.jit, static_argnames=("alpha",))
def update_precision(state: PrecisionState, signals: jax.Array,
                     t: FreqTables, alpha: float = 0.9) -> PrecisionState:
    """Per-frame Sherman-Morrison update of P (scanned over the batch):

    ``R_t = a R + (1-a) s s^H``  =>
    ``P_t = (1/a) [P - ((1-a)/a) (P s)(P s)^H / (1 + (1-a)/a s^H P s)]``

    Complex arithmetic expanded over (re, im) planes; ``s^H P s`` is real
    because P is Hermitian.  Cost: two matvecs + one outer product per bin.
    """
    if signals.ndim == 2:
        signals = signals[None]
    sr_all, si_all = _frame_fft(signals, t)            # (B, F, M)
    beta = (1.0 - alpha) / alpha

    def step(carry, s):
        P_re, P_im = carry
        sr, si = s                                     # (F, M)
        # u = P s (complex matvec)
        u_re = (jnp.einsum("fmn,fn->fm", P_re, sr, precision=_HI)
                - jnp.einsum("fmn,fn->fm", P_im, si, precision=_HI))
        u_im = (jnp.einsum("fmn,fn->fm", P_re, si, precision=_HI)
                + jnp.einsum("fmn,fn->fm", P_im, sr, precision=_HI))
        g = jnp.einsum("fm,fm->f", sr, u_re, precision=_HI) \
            + jnp.einsum("fm,fm->f", si, u_im, precision=_HI)   # s^H P s
        scale = (beta / (1.0 + beta * g))[:, None, None]
        # P <- (P - scale * u u^H) / alpha
        uu_re = (jnp.einsum("fm,fn->fmn", u_re, u_re, precision=_HI)
                 + jnp.einsum("fm,fn->fmn", u_im, u_im, precision=_HI))
        uu_im = (jnp.einsum("fm,fn->fmn", u_im, u_re, precision=_HI)
                 - jnp.einsum("fm,fn->fmn", u_re, u_im, precision=_HI))
        P_re = (P_re - scale * uu_re) / alpha
        P_im = (P_im - scale * uu_im) / alpha
        return (P_re, P_im), None

    (P_re, P_im), _ = jax.lax.scan(
        step, (state.P_re, state.P_im), (sr_all, si_all))
    # co-tracked covariance uses the SAME per-frame discounting as the
    # precision scan (a batch-mean EMA step here would make the periodic
    # refresh snap P onto a different estimate for B > 1)
    cov = _cov_rank_update(state.cov, sr_all, si_all, alpha)
    return PrecisionState(P_re=P_re, P_im=P_im, cov=cov, load=state.load)


@partial(jax.jit, static_argnames=("alpha",))
def update_precision_block(state: PrecisionState, signals: jax.Array,
                           t: FreqTables,
                           alpha: float = 0.9) -> PrecisionState:
    """Exact rank-B (Woodbury) equivalent of scanning
    :func:`update_precision` over a B-frame batch.

    The per-frame Sherman-Morrison recursion is memory-bound: every frame
    reads+writes the whole (F, M, M) precision (and covariance) state for
    only ~30 MFLOP of math at the reference shape.  B sequential rank-1
    updates equal ONE rank-B update::

        R_B = a^B R_0 + U U^H,   U[f] = [sqrt((1-a) a^{B-1-i}) s_i]
        P_B = (P_0 - V (a^B I + U^H V)^{-1} V^H) / a^B,   V = P_0 U

    so the state streams once per B frames and the extra math is batched
    (F, M, B)/(F, B, B) matmuls.  Bit-for-bit this matches the
    scan up to f32 reassociation (gated in tests at 1e-4); the covariance
    co-estimate uses the same U (with the sequential recursion's
    first-ever-frame replacement reproduced exactly).
    """
    if signals.ndim == 2:
        signals = signals[None]
    sr, si = _frame_fft(signals, t)                    # (B, F, M)
    return _update_precision_block_sp(state, sr, si, alpha)


def _update_precision_block_sp(state: PrecisionState, sr: jax.Array,
                               si: jax.Array, alpha: float
                               ) -> PrecisionState:
    """:func:`update_precision_block` on precomputed spectra (B, F, M)."""
    B = sr.shape[0]
    aB = alpha ** B
    w = jnp.sqrt((1.0 - alpha)
                 * alpha ** (B - 1.0 - jnp.arange(B, dtype=jnp.float32)))
    Ur = jnp.einsum("b,bfm->fmb", w, sr, precision=_HI)
    Ui = jnp.einsum("b,bfm->fmb", w, si, precision=_HI)

    # V = P U (complex; P hermitian)
    Vr = (jnp.einsum("fmn,fnb->fmb", state.P_re, Ur, precision=_HI)
          - jnp.einsum("fmn,fnb->fmb", state.P_im, Ui, precision=_HI))
    Vi = (jnp.einsum("fmn,fnb->fmb", state.P_re, Ui, precision=_HI)
          + jnp.einsum("fmn,fnb->fmb", state.P_im, Ur, precision=_HI))
    # G = U^H V (hermitian PSD)
    Gr = (jnp.einsum("fmb,fmc->fbc", Ur, Vr, precision=_HI)
          + jnp.einsum("fmb,fmc->fbc", Ui, Vi, precision=_HI))
    Gi = (jnp.einsum("fmb,fmc->fbc", Ur, Vi, precision=_HI)
          - jnp.einsum("fmb,fmc->fbc", Ui, Vr, precision=_HI))
    eye = jnp.broadcast_to(jnp.eye(B, dtype=jnp.float32), Gr.shape)
    Kr = aB * eye + Gr
    # X = K^{-1} V^H  (V^H = U^H P since P is hermitian)
    VhR = jnp.swapaxes(Vr, 1, 2)
    VhI = -jnp.swapaxes(Vi, 1, 2)
    Xr, Xi = _solve_hermitian(Kr, Gi, VhR, VhI)
    # P <- (P - V X)/a^B
    VXr = (jnp.einsum("fmb,fbn->fmn", Vr, Xr, precision=_HI)
           - jnp.einsum("fmb,fbn->fmn", Vi, Xi, precision=_HI))
    VXi = (jnp.einsum("fmb,fbn->fmn", Vr, Xi, precision=_HI)
           + jnp.einsum("fmb,fbn->fmn", Vi, Xr, precision=_HI))
    P_re = (state.P_re - VXr) / aB
    P_im = (state.P_im - VXi) / aB

    cov = _cov_rank_update(state.cov, sr, si, alpha)
    return PrecisionState(P_re=P_re, P_im=P_im, cov=cov, load=state.load)


@partial(jax.jit, static_argnames=("grid_precision",))
def mvdr_d0(state: PrecisionState, t: FreqTables,
            grid_precision: str = "high") -> jax.Array:
    """The full Capon quadratic form ``d = a^H P a`` (F, D) — the
    expensive O(F M^2 D) evaluation :func:`mvdr_maps_scan` needs once
    per streaming epoch.  Callers that process consecutive blocks carry
    the returned ``d`` between calls (``d0=``/``return_d=``) and only
    re-evaluate here after :func:`refresh_precision`: at the reference
    shape this evaluation is ~84%% of a 16-frame block's FLOPs."""
    prec = {"highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT}[grid_precision]
    a_re, a_im = t.phase_re, -t.phase_im               # (F, M, D)
    Pa_re = (jnp.einsum("fmn,fnd->fmd", state.P_re, a_re, precision=prec)
             - jnp.einsum("fmn,fnd->fmd", state.P_im, a_im, precision=prec))
    Pa_im = (jnp.einsum("fmn,fnd->fmd", state.P_re, a_im, precision=prec)
             + jnp.einsum("fmn,fnd->fmd", state.P_im, a_re, precision=prec))
    return (jnp.einsum("fmd,fmd->fd", a_re, Pa_re, precision=prec)
            + jnp.einsum("fmd,fmd->fd", a_im, Pa_im, precision=prec))


@partial(jax.jit,
         static_argnames=("alpha", "grid_precision", "return_d"))
def mvdr_maps_scan(state: PrecisionState, signals: jax.Array,
                   t: FreqTables, alpha: float = 0.9,
                   grid_precision: str = "high",
                   bin_weights: Optional[jax.Array] = None,
                   d0: Optional[jax.Array] = None,
                   return_d: bool = False):
    """EXACT per-frame Capon maps for a B-frame batch at ~the cost of one.

    The sequential path (``update_precision`` + ``mvdr_power_precision``
    per frame) re-evaluates the full ``a^H P a`` quadratic form — an
    O(F M^2 D) einsum — after every rank-1 state update.  But the
    Sherman–Morrison step only moves P inside the span of the new
    snapshot, so the denominators obey a closed recursion in the
    B-snapshot SUBSPACE::

        d_t(a) = (d_{t-1}(a) - kappa_t |a^H P_{t-1} s_t|^2) / alpha

    with ``a^H P_t s_j`` and ``s_j^H P_t s_k`` themselves rank-1
    recursions on (F, D, B) / (F, B, B) projection tensors.  One full
    map evaluation (d_0) + two projection matmuls + a B-step scan
    replaces B full evaluations: ~60x fewer FLOPs at the reference shape
    for B=64, matching the sequential loop up to f32 reassociation (the
    recursion reorders ops; gated at 1e-3 in tests).

    The (F, D, B) tensor ``Y_t = a^H P_t S`` never
    enters the scan at all.  Each step's update is rank-1 —
    ``Y_t = (Y_{t-1} - kappa_t m_t r_t)/alpha`` with ``m_t`` a COLUMN of
    ``Y_{t-1}`` — so ``Y_t = Y_0 A_t`` for a small per-bin coefficient
    matrix with the closed recursion ``A_t = (A_{t-1} - kappa_t
    A_{t-1}e_t r_t)/alpha`` living entirely in (F, B, B).  The scan
    carries only A and the snapshot Gram tensor y (~KB-scale at the
    reference shape vs ~250 MB with Y in the carry), then ONE batched
    matmul ``M = Y_0 A`` recovers every frame's
    ``m_t``, and the d-recursion unrolls to a weighted running sum
    ``d_t = (d_0 - sum_{s<=t} alpha^s kappa_s |m_s|^2) / alpha^{t+1}``
    computed as a triangular matmul (single pass over memory).

    Coefficient depth is CHUNKED at 16 frames: A's entries grow like
    ``alpha^-t`` and frame t's ``m_t`` is a depth-t signed combination of
    the chunk-start columns, so deep blocks cancel catastrophically
    (0.8% relative at depth 24 vs 3e-5 at depth 6).  Every 16 frames the
    precision state advances by the exact rank-16 Woodbury update and
    the projections (Y_0, y) are re-measured from the REAL P — bounding
    the mixing depth while ``d`` carries across chunks exactly (its
    recursion is per-(f, d) scalar, representation-free).  Total matmul
    FLOPs are unchanged (projections are per-frame-linear); only the
    (F, M, M) state streams once per chunk instead of once per block.

    STREAMING CALLERS: the final anchored ``d`` is itself next block's
    ``d_0``.  Pass ``return_d=True`` to get it back and feed it as
    ``d0=`` on the next call — the O(F M^2 D) quadratic form (84%% of a
    16-frame block's FLOPs at the reference shape) then runs only once
    per refresh epoch (:func:`mvdr_d0` after :func:`refresh_precision`;
    :func:`refresh_interval` bounds the carry depth so f32 drift stays
    at the level the long-run test gates).

    Returns ``(maps (B, X, Y), new_state)`` — frame t's map reflects the
    state AFTER absorbing frames 0..t, exactly like the sequential loop;
    ``new_state`` comes from composing the per-chunk rank-16 Woodbury
    block updates (the same posterior).  With ``return_d=True`` the
    return is ``(maps, new_state, d)``.
    """
    prec = {"highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT}[grid_precision]
    if signals.ndim == 2:
        signals = signals[None]
    B = signals.shape[0]
    sr, si = _frame_fft(signals, t)                    # (B, F, M)
    a_re, a_im = t.phase_re, -t.phase_im               # (F, M, D)
    beta = (1.0 - alpha) / alpha
    F = sr.shape[1]

    # d_0 = a^H P_0 a (the one full quadratic form), unless carried in
    d = mvdr_d0(state, t, grid_precision) if d0 is None else d0

    def step(carry, tt):
        Ar, Ai, yr, yi = carry
        g = jnp.take(jnp.einsum("fbb->fb", yr), tt, axis=1)   # (F,) real
        kappa = (beta / (1.0 + beta * g))                     # (F,)
        # m_t = Y_{t-1} e_t = Y_0 (A_{t-1} e_t): emit the coefficient
        # column instead of touching the (F, D, Bc) tensor
        ar = jax.lax.dynamic_index_in_dim(Ar, tt, 2, keepdims=False)
        ai = jax.lax.dynamic_index_in_dim(Ai, tt, 2, keepdims=False)
        # row r_j = u^H s_j = s_t^H P_{t-1} s_j = y[t, j]  (P hermitian;
        # NOT conj(y[t, j]) — u^H s_j = conj(s_j^H u) = conj(y[j, t]),
        # and y is hermitian in (j, k))
        rr = jax.lax.dynamic_index_in_dim(yr, tt, 1, keepdims=False)
        ri = jax.lax.dynamic_index_in_dim(yi, tt, 1, keepdims=False)
        k3 = kappa[:, None, None]
        Ar2 = (Ar - k3 * (ar[:, :, None] * rr[:, None, :]
                          - ai[:, :, None] * ri[:, None, :])) / alpha
        Ai2 = (Ai - k3 * (ar[:, :, None] * ri[:, None, :]
                          + ai[:, :, None] * rr[:, None, :])) / alpha
        # y[j, k] <- (y[j, k] - kappa * y[j, t] * conj(y[t, k])) / alpha
        cr = jax.lax.dynamic_index_in_dim(yr, tt, 2, keepdims=False)
        ci = jax.lax.dynamic_index_in_dim(yi, tt, 2, keepdims=False)
        yr2 = (yr - k3 * (cr[:, :, None] * rr[:, None, :]
                          - ci[:, :, None] * ri[:, None, :])) / alpha
        yi2 = (yi - k3 * (cr[:, :, None] * ri[:, None, :]
                          + ci[:, :, None] * rr[:, None, :])) / alpha
        return (Ar2, Ai2, yr2, yi2), (ar, ai, kappa)

    CHUNK = 16

    def chunk_body(carry, inputs, anchor=True):
        st, d = carry
        sr_c, si_c = inputs                            # (Bc, F, M)
        Bc = sr_c.shape[0]
        Sr = jnp.moveaxis(sr_c, 0, 2)                  # (F, M, Bc)
        Si = jnp.moveaxis(si_c, 0, 2)
        # chunk-start projections from the REAL P: Ps = P S;
        # Y_0 = a^H Ps (F, D, Bc); y_0 = S^H Ps (F, Bc, Bc)
        Ps_re = (jnp.einsum("fmn,fnb->fmb", st.P_re, Sr, precision=_HI)
                 - jnp.einsum("fmn,fnb->fmb", st.P_im, Si, precision=_HI))
        Ps_im = (jnp.einsum("fmn,fnb->fmb", st.P_re, Si, precision=_HI)
                 + jnp.einsum("fmn,fnb->fmb", st.P_im, Sr, precision=_HI))
        Y_re = (jnp.einsum("fmd,fmb->fdb", a_re, Ps_re, precision=prec)
                + jnp.einsum("fmd,fmb->fdb", a_im, Ps_im, precision=prec))
        Y_im = (jnp.einsum("fmd,fmb->fdb", a_re, Ps_im, precision=prec)
                - jnp.einsum("fmd,fmb->fdb", a_im, Ps_re, precision=prec))
        y_re = (jnp.einsum("fmj,fmb->fjb", Sr, Ps_re, precision=_HI)
                + jnp.einsum("fmj,fmb->fjb", Si, Ps_im, precision=_HI))
        y_im = (jnp.einsum("fmj,fmb->fjb", Sr, Ps_im, precision=_HI)
                - jnp.einsum("fmj,fmb->fjb", Si, Ps_re, precision=_HI))

        A0_re = jnp.broadcast_to(jnp.eye(Bc, dtype=jnp.float32),
                                 (F, Bc, Bc))
        (_, _, _, _), (ar_all, ai_all, kap_all) = jax.lax.scan(
            step, (A0_re + 0.0, jnp.zeros((F, Bc, Bc), jnp.float32),
                   y_re, y_im), jnp.arange(Bc))
        Ac_re = jnp.moveaxis(ar_all, 0, 2)             # (F, Bc, step)
        Ac_im = jnp.moveaxis(ai_all, 0, 2)
        kap = jnp.moveaxis(kap_all, 0, 1)              # (F, Bc)

        # every frame's m_t in one batched matmul against the projections
        Mr = (jnp.einsum("fdb,fbt->fdt", Y_re, Ac_re, precision=_HI)
              - jnp.einsum("fdb,fbt->fdt", Y_im, Ac_im, precision=_HI))
        Mi = (jnp.einsum("fdb,fbt->fdt", Y_re, Ac_im, precision=_HI)
              + jnp.einsum("fdb,fbt->fdt", Y_im, Ac_re, precision=_HI))
        steps = jnp.arange(Bc, dtype=jnp.float32)
        qw = (Mr * Mr + Mi * Mi) * (kap * alpha ** steps)[:, None, :]
        # running sum_{s<=t} as a triangular matmul: one memory pass
        # (cumsum lowers to log-depth passes over the (F, D, Bc) tensor)
        tril = jnp.tril(jnp.ones((Bc, Bc), jnp.float32)).T  # (s,t): s<=t
        cum = jnp.einsum("fds,st->fdt", qw, tril, precision=_HI)
        d_all = (d[:, :, None] - cum) * alpha ** -(steps + 1.0)
        per_bin = 1.0 / jnp.maximum(d_all, 1e-12)      # (F, D, Bc)
        if bin_weights is not None:     # sharded path: mask padded bins
            per_bin = per_bin * bin_weights[:, None, None]
        maps_c = jnp.moveaxis(jnp.sum(per_bin, axis=0), 1, 0)  # (Bc, D)
        if anchor:
            # Re-ANCHOR d across the chunk boundary instead of carrying
            # the recursion (whose relative error compounds at
            # ~alpha^-1/frame): with P' = (P - V K^{-1} V^H)/a^Bc,
            #   a^H P' a = (d_cs - (a^H V) K^{-1} (V^H a)) / a^Bc
            # and a^H V = Y_0 diag(w), U^H V = diag(w) y_0 diag(w) —
            # both already measured, so the anchor costs one (F, Bc, Bc)
            # hermitian solve + two thin contractions.
            w = jnp.sqrt((1.0 - alpha)
                         * alpha ** (Bc - 1.0
                                     - jnp.arange(Bc, dtype=jnp.float32)))
            aBc = alpha ** Bc
            AVr = Y_re * w[None, None, :]              # (F, D, Bc)
            AVi = Y_im * w[None, None, :]
            Gr = y_re * (w[:, None] * w[None, :])
            Gi = y_im * (w[:, None] * w[None, :])
            Kr = aBc * jnp.broadcast_to(jnp.eye(Bc, dtype=jnp.float32),
                                        Gr.shape) + Gr
            # RHS: V^H a = (a^H V)^H  -> (F, Bc, D)
            Zr, Zi = _solve_hermitian(Kr, Gi, jnp.swapaxes(AVr, 1, 2),
                                      -jnp.swapaxes(AVi, 1, 2))
            quad = (jnp.einsum("fdb,fbd->fd", AVr, Zr, precision=_HI)
                    - jnp.einsum("fdb,fbd->fd", AVi, Zi, precision=_HI))
            d = (d - quad) / aBc
        # P advances by the exact rank-Bc Woodbury update so the next
        # chunk's projections are measured, not mixed
        st = _update_precision_block_sp(st, sr_c, si_c, alpha)
        return (st, d), maps_c

    nc, rem = divmod(B, CHUNK)
    if nc >= 2 and rem == 0:
        # uniform chunks: ONE chunk body in the HLO via lax.scan — a
        # B=64 call otherwise unrolls 4 copies of ~25 reference-shape
        # einsums + an inner scan (compile time).  The final chunk's
        # anchor is computed inside the scan either way (needed when
        # return_d).
        sr_ch = sr.reshape(nc, CHUNK, F, -1)
        si_ch = si.reshape(nc, CHUNK, F, -1)
        (st, d), maps_all = jax.lax.scan(chunk_body, (state, d),
                                         (sr_ch, si_ch))
        maps = maps_all.reshape(B, -1)
    else:
        st = state
        map_parts = []
        for c0 in range(0, B, CHUNK):
            last = c0 + CHUNK >= B
            (st, d), maps_c = chunk_body(
                (st, d), (sr[c0:c0 + CHUNK], si[c0:c0 + CHUNK]),
                anchor=(not last) or return_d)
            map_parts.append(maps_c)
        maps = jnp.concatenate(map_parts, axis=0) if len(map_parts) > 1 \
            else map_parts[0]
    maps = maps.reshape(B, t.res_x, t.res_y)
    if return_d:
        return maps, st, d
    return maps, st


@partial(jax.jit, static_argnames=("alpha", "grid_precision"))
def mvdr_maps_scan_refresh(state: PrecisionState, signals: jax.Array,
                           t: FreqTables, alpha: float = 0.9,
                           grid_precision: str = "high",
                           d0: Optional[jax.Array] = None):
    """Epoch-closing block scan with the exact refresh FOLDED INTO the
    same device program.  Production uses the separate-refresh cadence
    (``apps.pipeline.make_mvdr_stream``): correcting the pre-block
    refresh for the block costs an EXTRA rank-B Woodbury update of P on
    top of the scan's own chunk advance.

    Semantics: the refresh inverts the PRE-block covariance (no data
    dependence on the scan) and the fresh P advances by the block's
    exact rank-B Woodbury correction — i.e.
    ``inv(R_post + alpha^B * load_pre * I)``: the loading re-anchors
    one block EARLIER than the standalone refresh and decays by
    ``alpha^B`` across the block, exactly as the recursion decays it
    between any two refreshes (gated against the float64 model in
    tests).  Returns ``(maps, refreshed_state, d)``; maps are
    bit-identical to ``mvdr_maps_scan``.
    """
    maps, st2, d = mvdr_maps_scan(state, signals, t, alpha=alpha,
                                  grid_precision=grid_precision, d0=d0,
                                  return_d=True)
    # refresh from the PRE-block covariance (independent of the scan)
    R_re, R_im = _loaded(state.cov, state.load)
    P_re, P_im = invert_hermitian_unrolled(R_re, R_im)
    fresh = PrecisionState(P_re=P_re, P_im=P_im, cov=state.cov,
                           load=state.load)
    # advance the refreshed P by this block (exact rank-B Woodbury);
    # the covariance advance duplicates st2.cov's subgraph bit-exactly,
    # so XLA CSEs it — one cov update in the compiled program
    sr, si = _frame_fft(signals, t)
    st3 = _update_precision_block_sp(fresh, sr, si, alpha)
    return maps, st3, d


def refresh_interval(alpha: float = 0.9) -> int:
    """Max frames between :func:`refresh_precision` calls before f32
    recursion drift becomes visible.

    Every Sherman-Morrison / Woodbury step divides P by ``alpha``, so
    rounding error in directions the data does not strongly re-excite is
    AMPLIFIED by ``alpha^-1`` per frame: after T frames the drift is
    ~``eps * alpha^-T``.  Demanding that stay under ~1e-4 gives
    ``T <= log(1e-4 / eps) / log(1/alpha)`` — about 64 frames at the
    production ``alpha=0.9`` (f32 eps ~1.2e-7), NOT the few hundred a
    fixed cadence assumes.  Measured: at alpha=0.9 a 256-frame cadence
    let the recursion overflow to NaN maps by frame ~110 (the 1e-12
    denominator clamp then sprays 1e12 spikes); the 64-frame cadence
    holds worst-direction map error to ~2e-2 at interval end (exact
    argmax on every frame) indefinitely
    (tests/test_freq.py::test_refresh_interval_bounds_long_run_drift).
    """
    eps = 1.2e-7                      # f32 unit roundoff, one guard bit
    budget = float(np.log(1e-4 / eps))
    rate = max(float(np.log(1.0 / alpha)), 1e-9)
    return int(max(16, min(512, budget / rate)))


def d0_carry_interval(alpha: float = 0.9) -> int:
    """Max frames to carry :func:`mvdr_maps_scan`'s ``d`` between calls
    before re-measuring with :func:`mvdr_d0` — HALF the refresh
    interval.  The carried d's per-step correction errors amplify by
    ``alpha^-1`` per frame exactly like the state drift, but from a
    ~1e-5 seed (einsum rounding) instead of eps, so it tolerates half
    the exponent budget.  Measured at alpha=0.9 vs a float64
    same-trajectory oracle: carry 32 = per-block accuracy (1.8e-2 worst
    direction at epoch end), carry 48 = 6e-2, carry 64 overflows the
    denominator clamp (tests/test_freq.py long-run gate)."""
    return max(16, refresh_interval(alpha) // 2)


@jax.jit
def refresh_precision(state: PrecisionState, t: FreqTables) -> PrecisionState:
    """Exact re-factorization of P from the co-tracked covariance — run
    every :func:`refresh_interval` frames to bound f32 recursion drift.

    Uses :func:`invert_hermitian_unrolled` (unrolled complex potri, no
    XLA While loop); :func:`invert_hermitian` is the embedding-based
    reference it is gated against."""
    R_re, R_im = _loaded(state.cov, state.load)
    P_re, P_im = invert_hermitian_unrolled(R_re, R_im)
    return PrecisionState(P_re=P_re, P_im=P_im, cov=state.cov,
                          load=state.load)


@partial(jax.jit, static_argnames=("grid_precision",))
def mvdr_power_precision(state: PrecisionState, t: FreqTables,
                         grid_precision: str = "high",
                         bin_weights: Optional[jax.Array] = None
                         ) -> jax.Array:
    """Capon spectrum directly from the streaming inverse — matmuls only,
    no factorization: the real-time MVDR map (every frame, full rate).

    ``bin_weights`` (F,) masks padded bins on the sharded path."""
    prec = {"highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT}[grid_precision]
    a_re, a_im = t.phase_re, -t.phase_im               # (F, M, D)
    # denom = Re(a^H P a); block-real expansion with P hermitian
    Pa_re = (jnp.einsum("fmn,fnd->fmd", state.P_re, a_re, precision=prec)
             - jnp.einsum("fmn,fnd->fmd", state.P_im, a_im, precision=prec))
    Pa_im = (jnp.einsum("fmn,fnd->fmd", state.P_re, a_im, precision=prec)
             + jnp.einsum("fmn,fnd->fmd", state.P_im, a_re, precision=prec))
    denom = (jnp.einsum("fmd,fmd->fd", a_re, Pa_re, precision=prec)
             + jnp.einsum("fmd,fmd->fd", a_im, Pa_im, precision=prec))
    denom = jnp.maximum(denom, 1e-12)
    per_bin = 1.0 / denom
    if bin_weights is not None:
        per_bin = per_bin * bin_weights[:, None]
    power = jnp.sum(per_bin, axis=0)
    return power.reshape(t.res_x, t.res_y)


def _apply_beam_weights(signals: jax.Array, t: FreqTables,
                        w_re: jax.Array, w_im: jax.Array) -> jax.Array:
    """Apply per-bin beam weights w (F, M) to frames (B, M_ch, N) and
    return the time-domain beam (B, N): ``beam_f = w^H S`` per bin,
    inverse DFT by matmul (band-limited irfft)."""
    sr, si = _frame_fft(signals, t)                    # (B, F, M)
    # beam_f = w^H S = conj(w).S
    b_re = jnp.einsum("bfm,fm->bf", sr, w_re, precision=_HI) \
         + jnp.einsum("bfm,fm->bf", si, w_im, precision=_HI)
    b_im = jnp.einsum("bfm,fm->bf", si, w_re, precision=_HI) \
         - jnp.einsum("bfm,fm->bf", sr, w_im, precision=_HI)
    return (jnp.einsum("bf,fn->bn", b_re, t.idft_re, precision=_HI)
            + jnp.einsum("bf,fn->bn", b_im, t.idft_im, precision=_HI))


@jax.jit
def mvdr_beam(state: CovarianceState, t: FreqTables, signals: jax.Array,
              direction: jax.Array,
              diagonal_loading: float = 1e-3) -> jax.Array:
    """MVDR-weighted single-direction beam in the time domain (B, N):
    ``w_f = R^{-1} a / (a^H R^{-1} a)`` per bin, inverse DFT by matmul."""
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    R_re, R_im = _loaded(state, diagonal_loading)
    a_re = jax.lax.dynamic_index_in_dim(t.phase_re, direction, 2, False)
    a_im = -jax.lax.dynamic_index_in_dim(t.phase_im, direction, 2, False)
    x_re, x_im = _solve_hermitian(R_re, R_im, a_re[..., None], a_im[..., None])
    x_re, x_im = x_re[..., 0], x_im[..., 0]            # (F, M)
    denom = jnp.maximum(
        jnp.sum(a_re * x_re + a_im * x_im, axis=1), 1e-12
    )[:, None]
    beam = _apply_beam_weights(signals, t, x_re / denom, x_im / denom)
    return beam[0] if squeeze else beam


@jax.jit
def mvdr_beam_precision(state: PrecisionState, t: FreqTables,
                        signals: jax.Array,
                        direction: jax.Array) -> jax.Array:
    """Distortionless single-direction beam with weights straight from the
    streaming inverse: ``w = P a / (a^H P a)`` — matmuls only, no
    factorization.  This is the LIVE adaptive-listening path (the
    reference steers its delay-and-sum beam live via ``steer``,
    ``api.c:576-581``; the north star upgrades it to MVDR); the
    covariance-based :func:`mvdr_beam` is the offline/exact variant.

    ``direction`` is a traced flat grid index — steering never triggers a
    recompile.  Returns (B, N) (or (N,) for a single frame).
    """
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    a_re = jax.lax.dynamic_index_in_dim(t.phase_re, direction, 2, False)
    a_im = -jax.lax.dynamic_index_in_dim(t.phase_im, direction, 2, False)
    # x = P a (complex matvec over (re, im) planes; P hermitian)
    x_re = (jnp.einsum("fmn,fn->fm", state.P_re, a_re, precision=_HI)
            - jnp.einsum("fmn,fn->fm", state.P_im, a_im, precision=_HI))
    x_im = (jnp.einsum("fmn,fn->fm", state.P_re, a_im, precision=_HI)
            + jnp.einsum("fmn,fn->fm", state.P_im, a_re, precision=_HI))
    denom = jnp.maximum(
        jnp.sum(a_re * x_re + a_im * x_im, axis=1), 1e-12
    )[:, None]
    beam = _apply_beam_weights(signals, t, x_re / denom, x_im / denom)
    return beam[0] if squeeze else beam


@partial(jax.jit, static_argnames=("alpha",))
def mvdr_listen_step(state: PrecisionState, signals: jax.Array,
                     t: FreqTables, direction: jax.Array,
                     alpha: float = 0.9):
    """One full-rate adaptive-listening step, fused into a single device
    program: absorb a B-frame batch into the streaming inverse (exact
    rank-B Woodbury, :func:`update_precision_block`), then beam EVERY
    frame of the batch with the refreshed MVDR weights.

    Returns ``(beams (B, N), new_state)``.  Weights refresh once per
    batch (B frames = B·N/fs seconds of signal — fast enough for the
    spatial statistics an acoustic scene evolves at, and it keeps the
    per-batch cost one dispatch).  Ref: the reference's whole point of
    MISO is *continuous* playback at line rate (``api.c:491-543``).
    """
    if signals.ndim == 2:
        signals = signals[None]
    new_state = update_precision_block(state, signals, t, alpha=alpha)
    beams = mvdr_beam_precision(new_state, t, signals, direction)
    return beams, new_state
