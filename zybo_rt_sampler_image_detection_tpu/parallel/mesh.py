"""Device-mesh scaling for the acoustic pipeline.

The reference's only parallelism is process-level (fork'd receiver, AVX2
lanes, serial 1824-direction loop — SURVEY.md §2.4).  Here the two natural
compute axes shard over a ``jax.sharding.Mesh``:

* ``data``  — the frame batch (pure DP; frames are independent);
* ``model`` — the steering-direction axis of the delay-line weight matrix
  (the tensor-parallel analog: W's D rows split across devices, each one
  produces its slice of the heatmap, and XLA inserts the all-gather that
  assembles the full image at the output sharding boundary).

Both shardings ride collectives the SPMD partitioner inserts.  The same
mesh carries the YOLO training step (DP over images + grad psum) in
``models/train.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import beamform
from ..ops.beamform import SteeringTables


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """A (data, model) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    dev = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(dev, axis_names=("data", "model"))


def shard_tables(t: SteeringTables, mesh: Mesh) -> SteeringTables:
    """Lay out steering tables for the mesh: the direction axis of W (and
    of the correction tensors) splits over ``model`` (zero-padded to a
    multiple); small per-mic arrays replicate."""
    d_model = mesh.shape["model"]
    D = t.W.shape[0]
    if D % d_model:
        pad = d_model - D % d_model
        Wc = t.Wc
        if Wc is not None:
            Wc = jnp.concatenate(
                [Wc, jnp.zeros((Wc.shape[0], pad) + Wc.shape[2:],
                               Wc.dtype)], axis=1)
        t = dataclasses.replace(
            t,
            W=jnp.concatenate(
                [t.W, jnp.zeros((pad,) + t.W.shape[1:], t.W.dtype)], axis=0),
            Wc=Wc)

    def put(x, spec):
        return None if x is None else jax.device_put(
            x, NamedSharding(mesh, spec))

    return dataclasses.replace(
        t,
        W=put(t.W, P("model", None, None)),
        Wc=put(t.Wc, P(None, "model", None, None)),
        adaptive=put(t.adaptive, P()),
    )


def sharded_steered_power(mesh: Mesh, t: SteeringTables):
    """pjit'd heatmap: frames shard over ``data``, the direction axis of
    the contraction over ``model`` (driven by W's committed sharding).

    Returns ``fn(frames (B, channels, N)) -> (B, X, Y)``; B must divide by
    the data-axis size.  Corrections are position-local per direction, so
    the scatter partitions with W and no cross-shard traffic occurs before
    the output all-gather.
    """
    D = t.res_x * t.res_y      # true direction count (W may be padded)
    n_mics = t.n_mics
    res_x, res_y = t.res_x, t.res_y
    data = NamedSharding(mesh, P("data", None, None))

    # tables enter the jit as ARGUMENTS (their committed shardings drive
    # the SPMD partitioning); closing over them would bake the ~70 MB
    # reference-shape W into the program as a constant
    @jax.jit
    def run(frames, t):
        beams = beamform.steered_beams(frames, t)          # (B, Dp, N)
        beams = beams / jnp.asarray(n_mics, beams.dtype)
        p = jnp.mean(beams * beams, axis=-1)[:, :D]
        return p.reshape(frames.shape[0], res_x, res_y)

    return lambda frames: run(jax.device_put(frames, data), t)


def shard_equiv_tables(et, mesh: Mesh):
    """Lay :class:`~..ops.freq_equiv.EquivFreqTables` out for the mesh:
    the direction axis of the stacked response planes (and of the
    boundary-correction tensor) splits over ``model``, zero-padded to a
    device multiple (padded directions produce zero power and are sliced
    off before the reshape); the small DFT bases replicate.

    The production policy (``apps.pipeline._select_power_backend``)
    serves ``high`` and ``bf16`` tables on this path, so it gets the same
    multi-device treatment as the time-domain tables."""
    n_model = mesh.shape["model"]
    D = et.Hs1.shape[0]
    if D % n_model:
        pad = n_model - D % n_model

        def padd(x, axis):
            shape = list(x.shape)
            shape[axis] = pad
            return jnp.concatenate(
                [x, jnp.zeros(shape, x.dtype)], axis=axis)

        et = dataclasses.replace(
            et,
            Hs1=padd(et.Hs1, 0), Hs2=padd(et.Hs2, 0),
            Wc=None if et.Wc is None else padd(et.Wc, 1))

    def put(x, spec):
        return None if x is None else jax.device_put(
            x, NamedSharding(mesh, spec))

    return dataclasses.replace(
        et,
        Hs1=put(et.Hs1, P("model", None, None)),
        Hs2=put(et.Hs2, P("model", None, None)),
        Wc=put(et.Wc, P(None, "model", None, None)),
        dft_re=put(et.dft_re, P()), dft_im=put(et.dft_im, P()),
        ib_re=put(et.ib_re, P()), ib_im=put(et.ib_im, P()),
        cf=put(et.cf, P()), adaptive=put(et.adaptive, P()))


def sharded_equiv_power(mesh: Mesh, et):
    """pjit'd EXACT frequency-domain heatmap: frames shard over ``data``, the direction axis of the stacked
    response planes over ``model`` (driven by the tables' committed
    shardings from :func:`shard_equiv_tables`); XLA inserts the output
    all-gather when the padded flat map is sliced and reshaped.

    Returns ``fn(frames (B, channels, N)) -> (B, X, Y)``."""
    from ..ops import freq_equiv

    D_true = et.res_x * et.res_y
    res_x, res_y = et.res_x, et.res_y
    data = NamedSharding(mesh, P("data", None, None))

    # tables enter the jit as ARGUMENTS (committed shardings drive SPMD;
    # reference-shape planes are ~860 MB — never closure constants)
    @jax.jit
    def run(frames, et):
        flat = freq_equiv.equiv_power_flat(frames, et)     # (B, Dp)
        return flat[:, :D_true].reshape(frames.shape[0], res_x, res_y)

    return lambda frames: run(jax.device_put(frames, data), et)


# ---------------------------------------------------------------------------
# Frequency-domain sharding: the bin axis is embarrassingly parallel
# ---------------------------------------------------------------------------

def shard_freq_tables(t, mesh: Mesh, axes: Sequence[str] = ("model",)):
    """Lay a :class:`~..ops.freq.FreqTables` out with the frequency-bin
    axis sharded over the given mesh axes.

    Every frequency-domain op (Bartlett, covariance/precision updates,
    Capon map) is per-bin with one final sum over bins, so sharding F
    makes XLA run each device's bins independently and insert a single
    psum at the output.  F is padded to a device-count multiple by
    REPEATING the last bin (zero-padding would make padded Capon
    denominators blow up); the returned ``bin_weights`` (1 real / 0
    padded) mask the duplicates out of the final sums — pass them to
    ``fft_steered_power`` / ``mvdr_power_precision``.

    Returns ``(tables, bin_weights)``.
    """
    from ..ops import freq as _freq  # noqa: F401  (type of t)

    ax = tuple(axes)
    ndev = int(np.prod([mesh.shape[a] for a in ax]))
    F = t.phase_re.shape[0]
    FP = -(-F // ndev) * ndev
    pad = FP - F

    def padf(x, axis):
        if pad == 0:
            return jnp.asarray(x)
        last = jnp.take(x, jnp.full((pad,), x.shape[axis] - 1), axis=axis)
        return jnp.concatenate([jnp.asarray(x), last], axis=axis)

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    bins = P(ax)
    t2 = dataclasses.replace(
        t,
        phase_re=put(padf(t.phase_re, 0), P(ax, None, None)),
        phase_im=put(padf(t.phase_im, 0), P(ax, None, None)),
        dft_re=put(padf(t.dft_re, 1), P(None, ax)),
        dft_im=put(padf(t.dft_im, 1), P(None, ax)),
        idft_re=put(padf(t.idft_re, 0), P(ax, None)),
        idft_im=put(padf(t.idft_im, 0), P(ax, None)),
        adaptive=put(t.adaptive, P()),
        hi=t.lo + FP,
    )
    w = put(jnp.concatenate([jnp.ones(F, jnp.float32),
                             jnp.zeros(pad, jnp.float32)]), bins)
    return t2, w


def sharded_fft_power(mesh: Mesh, t):
    """pjit'd FFT-domain Bartlett heatmap: frames shard over ``data``,
    frequency bins over ``model``; XLA inserts the bin-sum psum at the
    output boundary.  Returns ``fn(frames (B, ch, N)) -> (B, X, Y)``."""
    from ..ops import freq

    tp, w = shard_freq_tables(t, mesh, axes=("model",))
    data = NamedSharding(mesh, P("data", None, None))

    @jax.jit
    def run(frames, tp, w):
        return freq.fft_steered_power(frames, tp, w)

    return lambda frames: run(jax.device_put(frames, data), tp, w)


def shard_precision_state(st, mesh: Mesh,
                          axes: Sequence[str] = ("data", "model")):
    """Lay a streaming-MVDR :class:`~..ops.freq.PrecisionState` out with
    its per-bin matrices sharded over the given mesh axes (the RLS stream
    has no frame batch, so bins shard over the WHOLE mesh by default).
    Build the state from tables already padded by
    :func:`shard_freq_tables` with the same axes."""
    from ..ops import freq

    ax = tuple(axes)
    spec3 = NamedSharding(mesh, P(ax, None, None))
    rep = NamedSharding(mesh, P())
    return freq.PrecisionState(
        P_re=jax.device_put(st.P_re, spec3),
        P_im=jax.device_put(st.P_im, spec3),
        cov=freq.CovarianceState(
            R_re=jax.device_put(st.cov.R_re, spec3),
            R_im=jax.device_put(st.cov.R_im, spec3),
            count=jax.device_put(st.cov.count, rep)),
        load=st.load)
