"""Batched JAX Temporal Noise Shaping (profile 2's tensor domain).

The reference (src/libfrad/fourier/tools/p2tools.py) runs per-channel
scalar loops through scipy.signal.lfilter; this module is the batched
formulation over [..., N] spectra used by the fused profile-2 cores
(tests/test_ops.py compares it lane-by-lane against the reference
implementation itself on tonal/noise/gate-edge spectra):

* autocorrelation lags 0..12 as 13 static shifted reductions
* Levinson-Durbin unrolled to 12 masked vector steps (the recursion is
  order-12 regardless of batch, so unrolling beats lax.scan here)
* analysis FIR as 13 shifted multiply-adds
* synthesis IIR as a lax.scan over time carrying the last 12 outputs
  (inherently sequential; the scan vectorises over batch x channel)
* every reference bypass gate (spectral flatness, energy, tiny
  coefficients, blow-up, prediction gain — p2tools.py:57-111) applied as
  elementwise masks selecting passthrough per (batch, channel) lane.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

MAX_ORDER = 12
COEF_RES = 4
MIN_PRED = 0.030102999566398118  # log10(2)/10, p2tools.py:6


def _autocorr(x: jax.Array) -> jax.Array:
    """[..., N] -> [..., 13] windowed, normalised autocorrelation
    (p2tools.py:8-15)."""
    n = x.shape[-1]
    sig = x - jnp.mean(x, axis=-1, keepdims=True)
    norm = jnp.sqrt(jnp.sum(sig * sig, axis=-1, keepdims=True))
    sig = jnp.where(norm > 1e-6, sig / jnp.where(norm == 0, 1.0, norm), sig)
    lags = [jnp.sum(sig[..., : n - l] * sig[..., l:], axis=-1)
            for l in range(MAX_ORDER + 1)]
    ac = jnp.stack(lags, axis=-1)
    window = jnp.exp(-0.5 * (jnp.arange(MAX_ORDER + 1, dtype=x.dtype) * 0.01) ** 2)
    return ac * window


def _levinson(ac: jax.Array) -> jax.Array:
    """[..., 13] autocorr -> [..., 13] LPC (p2tools.py:17-34), with the
    reference's early-exit emulated by freezing converged lanes."""
    shape = ac.shape[:-1]
    dt = ac.dtype
    lpc = jnp.zeros(shape + (MAX_ORDER + 1,), dt).at[..., 0].set(1.0)
    error = ac[..., 0]
    dead = error <= 1e-10                      # never started
    frozen = dead

    for i in range(1, MAX_ORDER + 1):
        acc = jnp.zeros(shape, dt)
        for j in range(i):
            acc = acc + lpc[..., j] * ac[..., i - j]
        safe_err = jnp.where(error == 0, 1.0, error)
        refl = -acc / safe_err
        refl = jnp.where(jnp.abs(refl) >= 0.96, 0.96 * jnp.sign(refl), refl)

        prev = lpc
        upd = lpc.at[..., i].set(refl)
        for j in range(1, i):
            upd = upd.at[..., j].add(refl * prev[..., i - j])
        lpc = jnp.where(frozen[..., None], lpc, upd)
        new_err = error * (1.0 - refl * refl)
        error = jnp.where(frozen, error, new_err)
        frozen = frozen | (error <= 1e-12)
    return jnp.where(dead[..., None],
                     jnp.zeros_like(lpc).at[..., 0].set(1.0), lpc)


def _quantise(lpc: jax.Array) -> jax.Array:
    scale = (1 << COEF_RES) - 1
    q = jnp.rint(jnp.clip(lpc[..., 1:] * scale, -scale, scale - 1))
    return jnp.concatenate([jnp.zeros_like(lpc[..., :1]), q], axis=-1)


def _dequantise(lpc_q: jax.Array) -> jax.Array:
    scale = (1 << COEF_RES) - 1
    deq = lpc_q / scale
    return deq.at[..., 0].set(1.0)


def _fir(x: jax.Array, coeffs: jax.Array) -> jax.Array:
    """Causal FIR: y[t] = sum_j c[..., j] * x[..., t-j] (13 taps)."""
    y = coeffs[..., 0:1] * x
    for j in range(1, MAX_ORDER + 1):
        shifted = jnp.pad(x[..., : -j or None], [(0, 0)] * (x.ndim - 1) + [(j, 0)])
        y = y + coeffs[..., j:j + 1] * shifted
    return y


def _iir(x: jax.Array, coeffs: jax.Array) -> jax.Array:
    """All-pole IIR: y[t] = x[t] - sum_{j>=1} c[..., j] * y[t-j].

    Sequential over time (lax.scan), vectorised over leading dims.
    """
    lead = x.shape[:-1]
    a = coeffs[..., 1:]                               # [..., 12]

    def step(hist, xt):
        # hist: [..., 12] most-recent-first
        yt = xt - jnp.sum(a * hist, axis=-1)
        hist = jnp.concatenate([yt[..., None], hist[..., :-1]], axis=-1)
        return hist, yt

    hist0 = jnp.zeros(lead + (MAX_ORDER,), x.dtype)
    _, y = jax.lax.scan(step, hist0, jnp.moveaxis(x, -1, 0))
    return jnp.moveaxis(y, 0, -1)


def _flatness_gate(freqs: jax.Array) -> jax.Array:
    """Spectral-flatness gate (p2tools.py:108-111): True = run TNS."""
    geo = jnp.exp(jnp.mean(jnp.log(jnp.abs(freqs) + 1e-10), axis=-1))
    ari = jnp.mean(jnp.abs(freqs), axis=-1)
    return geo / (ari + 1e-10) < 0.5


def _predgain(orig: jax.Array, resid: jax.Array) -> jax.Array:
    oc = orig - jnp.mean(orig, axis=-1, keepdims=True)
    rc = resid - jnp.mean(resid, axis=-1, keepdims=True)
    oe = jnp.sum(oc * oc, axis=-1)
    re = jnp.sum(rc * rc, axis=-1)
    gain = 20.0 * jnp.log10(jnp.where(re == 0, 1.0, oe / jnp.where(re == 0, 1.0, re)))
    return jnp.where((oe < 1e-10) | (re < 1e-10) | (re >= oe), 0.0, gain)


def tns_analysis(freqs: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched tns_analysis (p2tools.py:72-96): [..., N] -> (residual,
    quantised LPC [..., 13]); bypassed lanes return (freqs, zeros)."""
    freqs = jnp.asarray(freqs)
    n = freqs.shape[-1]
    run = _flatness_gate(freqs) if n >= MAX_ORDER * 2 else jnp.zeros(freqs.shape[:-1], bool)
    run = run & (jnp.sum(freqs * freqs, axis=-1) >= 1e-10)

    lpc = _levinson(_autocorr(freqs))
    run = run & (jnp.sum(jnp.abs(lpc[..., 1:]), axis=-1) >= 0.01)
    lpc_q = _quantise(lpc)
    run = run & jnp.any(lpc_q[..., 1:] != 0, axis=-1)
    lpc_deq = _dequantise(lpc_q)

    resid = _fir(freqs, lpc_deq)
    finite = jnp.all(jnp.isfinite(resid), axis=-1) & (jnp.max(jnp.abs(resid), axis=-1) <= 1e6)
    run = run & finite
    run = run & (_predgain(freqs, resid) >= MIN_PRED)

    out = jnp.where(run[..., None], resid, freqs)
    lpc_out = jnp.where(run[..., None], lpc_q, jnp.zeros_like(lpc_q))
    return out, lpc_out


def tns_synthesis(tns_freqs: jax.Array, lpc_q: jax.Array) -> jax.Array:
    """Batched tns_synthesis (p2tools.py:98-105)."""
    tns_freqs = jnp.asarray(tns_freqs)
    lpc_q = jnp.asarray(lpc_q)
    run = jnp.any(lpc_q != 0, axis=-1)
    lpc_deq = _dequantise(lpc_q)
    filtered = _iir(tns_freqs, jnp.where(run[..., None], lpc_deq,
                                         jnp.zeros_like(lpc_deq).at[..., 0].set(1.0)))
    good = jnp.all(jnp.isfinite(filtered), axis=-1) & \
        (jnp.max(jnp.abs(filtered), axis=-1) <= 1e6)
    return jnp.where((run & good)[..., None], filtered, tns_freqs)
