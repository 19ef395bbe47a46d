"""Exact frequency-domain reformulation of the time-domain beamformers.

The time-domain family computes, per direction d and mic m, a short FIR
``w[d, m, :]`` at integer shifts (``beamform.SteeringTables``) and then a
(D, T*M) x (T*M, B*N) contraction — ~9 GFLOP/frame at the reference shape
(``pad_and_sum.c:114-142`` semantics).  But a delay-as-phase-multiply
needs no T axis (cf. the reference's own FFT backend,
``PC/application/realtime_scripts/beam_forming_algorithm.py:50-70``):
with the per-(d, m) frequency response

    H[d, m, f] = sum_t W[d, t, m] * exp(-j w_f (tau_min + t))

the steered spectrum is ``B[d, f] = sum_m H[d, m, f] S[m, f]`` — a
(D, M) x (M, F) contraction per bin, ~20x fewer MACs at the reference
shape.  Three correction terms make the power EXACTLY the C output
(not an approximation):

* the DFT runs on a zero-padded window L = N + T so circular = linear
  convolution (no wrap);
* Parseval gives the beam's power over ALL L linear-convolution outputs;
  the C keeps only the first N, so the power of the **tail** samples
  (n in [N, L), reconstructed by a small band-limited inverse-DFT
  matmul) is subtracted;
* the C loops cut a handful of head products (the boundary corrections
  the time path subtracts from its first Tc columns,
  ``beamform._build_corrections``): with correction values
  ``v[d, b, p]`` (the same Wc einsum) and head beam samples
  ``beam[d, b, p]`` (another small inverse-DFT matmul),
  ``||beam - v||^2 = ||beam||^2 - 2<beam, v> + ||v||^2`` restores the
  corrected power without ever materializing the (D, N) beams.

Exactness is gated in tests against ``beamform.steered_power`` for every
algorithm (pad / lerp / convolve / hybrid / truncated).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .beamform import SteeringTables

_PREC = {"highest": jax.lax.Precision.HIGHEST,
         "high": jax.lax.Precision.HIGH,
         "default": jax.lax.Precision.DEFAULT}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EquivFreqTables:
    """Frequency responses + DFT bases for the exact freq-domain power.

    The complex response is stored STACKED along the mic axis —
    ``Hs1 = [H_re | -H_im]`` and ``Hs2 = [H_im | H_re]``, both
    (D, 2M, F) — so the steered spectrum is two real einsums over the
    concatenated ``[sr; si]`` spectra instead of four over M (the
    complex multiply's four products collapse into two contractions of
    K=2M).  The tail/head inverse-DFT bases are fused into one
    (F, Ttail+Tc) basis pair for the same reason."""

    Hs1: jax.Array              # (D, 2M, F) = [H_re | -H_im]
    Hs2: jax.Array              # (D, 2M, F) = [H_im |  H_re]
    dft_re: jax.Array           # (N, F) — rfft basis over the L-padded window
    dft_im: jax.Array           # (N, F)   (only the N signal rows; rest 0)
    ib_re: jax.Array            # (F, Ttail[+Tc]) — inverse-DFT basis for the
    ib_im: jax.Array            #   tail samples n in [N, L) and (if boundary
                                #   corrections exist) head samples n in [0, Tc)
    cf: jax.Array               # (F,) Parseval weights (c_f / L)
    Wc: Optional[jax.Array]     # boundary-correction tensor (from tables)
    adaptive: jax.Array         # (M,) int32
    corr_js: tuple = dataclasses.field(metadata=dict(static=True))
    n_tail: int = dataclasses.field(metadata=dict(static=True))
    precision: str = dataclasses.field(metadata=dict(static=True))
    n_samples: int = dataclasses.field(metadata=dict(static=True))
    res_x: int = dataclasses.field(metadata=dict(static=True))
    res_y: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_mics(self) -> int:
        return self.Hs1.shape[1] // 2


@partial(jax.jit, static_argnames=("tau_min", "L"))
def _build_H(W: jax.Array, tau_min: int, L: int):
    """(D, T, M) taps -> stacked (D, 2M, F) frequency-response planes
    ``[H_re | -H_im]`` / ``[H_im | H_re]`` over the L-window.

    Built on device (the reference-shape planes are ~2 x 431 MB; einsum
    once at table build, W enters as an argument)."""
    D, T, M = W.shape
    F = L // 2 + 1
    w = 2.0 * np.pi * np.arange(F) / L
    t = tau_min + np.arange(T)
    ang = -np.outer(t, w)                              # (T, F)
    basis_re = jnp.asarray(np.cos(ang), jnp.float32)
    basis_im = jnp.asarray(np.sin(ang), jnp.float32)
    Wf = W.astype(jnp.float32)
    H_re = jnp.einsum("dtm,tf->dmf", Wf, basis_re,
                      precision=jax.lax.Precision.HIGHEST)
    H_im = jnp.einsum("dtm,tf->dmf", Wf, basis_im,
                      precision=jax.lax.Precision.HIGHEST)
    Hs1 = jnp.concatenate([H_re, -H_im], axis=1)
    Hs2 = jnp.concatenate([H_im, H_re], axis=1)
    return Hs1, Hs2


def equiv_dims(t: SteeringTables) -> tuple:
    """``(L, F)`` — the padded-window length and rfft bin count
    :func:`make_equiv_tables` will use.  The pipeline's backend-selection
    bars (MAC ratio, response-plane memory cap) predict table sizes from
    these, so they must come from the same derivation."""
    D, T, M = t.W.shape
    # L covers every positive shift's spill AND wraps negative shifts'
    # spill into the same tail window without collision
    L = t.n_samples + T + max(0, -t.tau_min) + 1
    return L, L // 2 + 1


def make_equiv_tables(t: SteeringTables) -> EquivFreqTables:
    """Build the exact frequency-domain twin of time-domain tables."""
    D, T, M = t.W.shape
    N = t.n_samples
    L, F = equiv_dims(t)
    f = np.arange(F)
    w = 2.0 * np.pi * f / L

    n = np.arange(N)[:, None]
    ang = -n * w[None, :]
    dft_re = np.cos(ang).astype(np.float32)
    dft_im = np.sin(ang).astype(np.float32)

    cf = np.where((f == 0) | ((L % 2 == 0) & (f == L // 2)), 1.0, 2.0) / L

    def inv_basis(positions):
        # x[n] = sum_f c_f (re cos(wn) - im sin(wn)) / L for rfft halves
        iang = np.outer(w, positions)                  # (F, P)
        ire = (cf[:, None] * np.cos(iang)).astype(np.float32)
        iim = (-cf[:, None] * np.sin(iang)).astype(np.float32)
        return ire, iim

    # fused inverse-DFT basis: tail columns first, then (if boundary
    # corrections exist) the head columns — one matmul pair at runtime
    tail_pos = np.arange(N, L)
    if t.Wc is not None:
        Tc = t.Wc.shape[2]
        ib_re, ib_im = inv_basis(np.concatenate([tail_pos, np.arange(Tc)]))
        Wc = jnp.asarray(t.Wc, jnp.float32)
    else:
        ib_re, ib_im = inv_basis(tail_pos)
        Wc = None

    Hs1, Hs2 = _build_H(jnp.asarray(t.W), t.tau_min, L)
    return EquivFreqTables(
        Hs1=Hs1, Hs2=Hs2,
        dft_re=jnp.asarray(dft_re), dft_im=jnp.asarray(dft_im),
        ib_re=jnp.asarray(ib_re), ib_im=jnp.asarray(ib_im),
        cf=jnp.asarray(cf, jnp.float32), Wc=Wc,
        adaptive=t.adaptive,
        corr_js=t.corr_js, n_tail=len(tail_pos), precision=t.precision,
        n_samples=N, res_x=t.res_x, res_y=t.res_y)


@jax.jit
def equiv_power_flat(signals: jax.Array, t: EquivFreqTables) -> jax.Array:
    """Un-reshaped steered power, (B, D) with D = ``Hs1.shape[0]``.

    The direction axis stays flat so a model-sharded caller
    (``parallel.mesh.sharded_equiv_power``) can slice padding off before
    the (X, Y) reshape; :func:`equiv_steered_power` is the single-device
    wrapper."""
    prec = _PREC[t.precision]
    M = t.n_mics
    N = t.n_samples
    s = signals[:, t.adaptive, :].astype(jnp.float32)   # (B, M, N)
    # rfft over the L-padded window (zero rows carry no terms)
    sr = jnp.einsum("bmn,nf->bmf", s, t.dft_re, precision=_PREC["highest"])
    si = jnp.einsum("bmn,nf->bmf", s, t.dft_im, precision=_PREC["highest"])
    # steered spectra B[d, f] = sum_m H S — the complex multiply's four
    # real products as TWO stacked contractions over [sr; si] (K=2M)
    S = jnp.concatenate([sr, si], axis=1)                # (B, 2M, F)
    Br = jnp.einsum("dmf,bmf->bdf", t.Hs1, S, precision=prec)
    Bi = jnp.einsum("dmf,bmf->bdf", t.Hs2, S, precision=prec)
    # Parseval: sum_{n<L} beam^2 = sum_f c_f |B_f|^2 / L
    total = jnp.einsum("bdf,f->bd", Br * Br + Bi * Bi, t.cf,
                       precision=_PREC["highest"])
    # tail samples the C output never had + (if corrections) head beam
    # samples, from ONE fused inverse-DFT matmul pair
    TH = (jnp.einsum("bdf,ft->bdt", Br, t.ib_re, precision=prec)
          + jnp.einsum("bdf,ft->bdt", Bi, t.ib_im, precision=prec))
    tail = TH[:, :, :t.n_tail]
    total = total - jnp.sum(tail * tail, axis=-1)
    if t.Wc is not None:
        # boundary corrections: ||beam - v||^2 over the first Tc columns
        head = TH[:, :, t.n_tail:]
        sj = jnp.stack([s[:, :, j] for j in t.corr_js], axis=1)  # (B, J, M)
        v = jnp.einsum("jdtm,bjm->bdt", t.Wc, sj,
                       precision=_PREC["highest"])
        total = total + jnp.sum(v * v - 2.0 * head * v, axis=-1)
    inv = 1.0 / (np.float32(N) * np.float32(M) * np.float32(M))
    return total * inv


@jax.jit
def equiv_steered_power(signals: jax.Array, t: EquivFreqTables) -> jax.Array:
    """EXACT time-domain-equivalent steered power, (B, X, Y) or (X, Y):
    matches ``beamform.steered_power`` bit-comparably (f32 reassociation
    tolerance) at ~20x fewer MACs at the reference shape."""
    squeeze = signals.ndim == 2
    if squeeze:
        signals = signals[None]
    power = equiv_power_flat(signals, t).reshape(-1, t.res_x, t.res_y)
    return power[0] if squeeze else power
