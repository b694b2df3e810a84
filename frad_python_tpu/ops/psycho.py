"""Psychoacoustic masking for the compact (lossy) profiles.

Parity with reference p1tools.py:4-44:

* 27 modified-Opus subband edges (p1tools.py:4-9)
* per-subband masking threshold: RMS(|X|)^alpha vs the Terhardt-style
  absolute hearing threshold, scaled by loss_level (p1tools.py:18-31);
  computation stops at the first empty subband (the reference `break`),
  leaving higher bands at 0.
* threshold -> per-bin divisor via per-band linear interpolation with
  `endpoint=False` linspace semantics (p1tools.py:35-41)
* alpha=0.75 power-law companding quant/dequant (p1tools.py:43-44)

All functions are vectorised over bins (reduceat over band segments
instead of the reference's per-band Python loop) and accept [..., N]
batches of channels; rounding of band edges uses round-half-even exactly
like Python's round() in the reference.
"""

from __future__ import annotations

import functools

import numpy as np

MODIFIED_OPUS_SUBBANDS = (
    0, 200, 400, 600, 800, 1000, 1200, 1400,
    1600, 2000, 2400, 2800, 3200, 4000, 4800, 5600,
    6800, 8000, 9600, 12000, 15600, 20000, 24000, 28800,
    34400, 40800, 48000, (1 << 32) - 1,
)
SUBBANDS = len(MODIFIED_OPUS_SUBBANDS) - 1
SPREAD_ALPHA = 0.8
QUANT_ALPHA = 0.75


@functools.lru_cache(maxsize=256)
def band_edges(dlen: int, srate: int) -> np.ndarray:
    """Bin index of each subband edge: round-half-even of
    dlen/(srate/2)*edge (reference p1tools.py:15-16), unclipped."""
    e = np.asarray(MODIFIED_OPUS_SUBBANDS, dtype=np.float64)
    return np.rint(dlen / (srate / 2) * e).astype(np.int64)


@functools.lru_cache(maxsize=256)
def _mask_consts(dlen: int, srate: int) -> tuple[np.ndarray, int, np.ndarray]:
    """(clipped band starts, number of active bands, AHT floor per band).

    Active bands = bands before the first empty bin range, matching the
    reference's early `break` (p1tools.py:22-23).
    """
    edges = band_edges(dlen, srate)
    starts = np.clip(edges, 0, dlen)
    widths = starts[1:] - starts[:-1]
    empty = np.flatnonzero(widths <= 0)
    nb = int(empty[0]) if empty.size else SUBBANDS

    mid = (np.asarray(MODIFIED_OPUS_SUBBANDS[:-1], dtype=np.float64)
           + np.asarray(MODIFIED_OPUS_SUBBANDS[1:], dtype=np.float64)) / 2.0
    f = mid / 1000.0
    with np.errstate(over="ignore"):
        aht = 10.0 ** (
            (3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2) + 1e-3 * f ** 4) / 20.0
        )
    aht_floor = np.minimum(aht, 1.0)
    return starts, nb, aht_floor


def mask_thres_mos(freqs: np.ndarray, srate: int, loss_level: float,
                   alpha: float = SPREAD_ALPHA) -> np.ndarray:
    """Masking thresholds per subband for [..., N] magnitude spectra.

    Returns [..., SUBBANDS]; bands at/after the first empty one are 0.
    """
    freqs = np.abs(np.asarray(freqs, dtype=np.float64))
    n = freqs.shape[-1]
    starts, nb, aht_floor = _mask_consts(n, srate)

    lead = freqs.shape[:-1]
    flat = freqs.reshape(-1, n)
    thres = np.zeros((flat.shape[0], SUBBANDS), dtype=np.float64)
    if nb > 0:
        sq = flat * flat
        cs = np.concatenate([np.zeros((flat.shape[0], 1)), np.cumsum(sq, axis=-1)], axis=-1)
        sums = cs[:, starts[1:nb + 1]] - cs[:, starts[:nb]]
        counts = (starts[1:nb + 1] - starts[:nb]).astype(np.float64)
        rms = np.sqrt(sums / counts) ** alpha
        thres[:, :nb] = np.maximum(rms, aht_floor[:nb]) * loss_level
    return thres.reshape(*lead, SUBBANDS)


def mapping_from_opus(mapped_thres: np.ndarray, freqs_len: int, srate: int) -> np.ndarray:
    """Interpolate per-band thresholds [..., >=SUBBANDS] back to per-bin
    divisors [..., freqs_len] (reference p1tools.py:35-41)."""
    mapped_thres = np.asarray(mapped_thres, dtype=np.float64)
    edges = band_edges(freqs_len, srate)
    starts = np.minimum(np.maximum(edges[:SUBBANDS], 0), freqs_len)

    out = np.zeros(mapped_thres.shape[:-1] + (freqs_len,), dtype=np.float64)
    t = np.arange(freqs_len, dtype=np.int64)
    # band index b(t): largest i in [0, SUBBANDS-2] with starts[i] <= t < starts[i+1]
    band = np.searchsorted(starts[1:SUBBANDS], t, side="right")
    valid = t < starts[SUBBANDS - 1]
    b = band[valid]
    tv = t[valid]
    c = (starts[b + 1] - starts[b]).astype(np.float64)
    frac = (tv - starts[b]).astype(np.float64)
    lo = mapped_thres[..., :SUBBANDS][..., b]
    hi = mapped_thres[..., :SUBBANDS][..., np.minimum(b + 1, SUBBANDS - 1)]
    # linspace(lo, hi, c, endpoint=False)[j] == lo + (hi-lo)/c * j
    out[..., valid] = lo + (hi - lo) / c * frac
    return out


def quant(x: np.ndarray) -> np.ndarray:
    """Power-law compand: sign(x)*|x|^0.75 (p1tools.py:43)."""
    return np.sign(x) * np.abs(x) ** QUANT_ALPHA


def dequant(x: np.ndarray) -> np.ndarray:
    """Inverse compand: sign(x)*|x|^(4/3) (p1tools.py:44)."""
    return np.sign(x) * np.abs(x) ** (1.0 / QUANT_ALPHA)


# ---------------------------------------------------------------------------
# JAX formulations for the batched pipeline (models/batch.py).
# Same math as above, expressed with static per-(dlen, srate) constants so
# everything jits to fixed-shape segment-matmul + gather ops.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _mask_consts_jnp(dlen: int, srate: int):
    """Constants for the jitted masking kernel: a [dlen, nb] band-indicator
    matrix (subband sums become one matmul), per-band 1/width, AHT floor,
    and the static interpolation gather/weight vectors for mapping."""
    starts, nb, aht_floor = _mask_consts(dlen, srate)
    ind = np.zeros((dlen, max(nb, 1)), dtype=np.float64)
    for i in range(nb):
        ind[starts[i]:starts[i + 1], i] = 1.0
    inv_w = np.zeros(max(nb, 1))
    inv_w[:nb] = 1.0 / (starts[1:nb + 1] - starts[:nb])

    # mapping constants: per-bin band index / interp fraction (unused bins -> nb sentinel)
    edges = band_edges(dlen, srate)
    mstarts = np.minimum(np.maximum(edges[:SUBBANDS], 0), dlen)
    t = np.arange(dlen)
    band = np.searchsorted(mstarts[1:SUBBANDS], t, side="right")
    valid = t < mstarts[SUBBANDS - 1]
    b = np.where(valid, band, 0)
    c = (mstarts[b + 1] - mstarts[b]).astype(np.float64)
    c = np.where(c == 0, 1.0, c)
    frac = (t - mstarts[b]) / c
    return ind, inv_w, aht_floor, nb, b, frac, valid


def mask_thres_mos_jnp(freqs, srate: int, loss_level, alpha: float = SPREAD_ALPHA):
    """JAX masking thresholds for [..., N] spectra -> [..., SUBBANDS]."""
    import jax
    import jax.numpy as jnp

    n = freqs.shape[-1]
    ind, inv_w, aht_floor, nb, *_ = _mask_consts_jnp(n, srate)
    dt = freqs.dtype
    sq = (freqs * freqs).astype(dt)
    # HIGHEST: an f32 dot left at DEFAULT runs in TF32 on a GPU
    sums = jnp.matmul(sq, jnp.asarray(ind, dtype=dt),
                      precision=jax.lax.Precision.HIGHEST)      # [..., nb]
    rms = jnp.sqrt(sums * jnp.asarray(inv_w, dtype=dt)) ** alpha
    th = jnp.maximum(rms, jnp.asarray(aht_floor[:ind.shape[1]], dtype=dt)) * loss_level
    pad = SUBBANDS - nb
    th = th[..., :nb]
    if pad > 0:
        th = jnp.concatenate([th, jnp.zeros(th.shape[:-1] + (pad,), dtype=dt)], axis=-1)
    return th


@functools.lru_cache(maxsize=256)
def _interp_matrix(dlen: int, srate: int) -> np.ndarray:
    """[SUBBANDS, dlen] dense interpolation matrix: column t holds the
    two band weights (1-frac, frac) of bin t, zero for invalid bins —
    so the per-bin divisor becomes `thres @ W`."""
    _, _, _, _, b, frac, valid = _mask_consts_jnp(dlen, srate)
    t = np.arange(dlen)
    hi = np.minimum(b + 1, SUBBANDS - 1)
    w = np.zeros((SUBBANDS, dlen), dtype=np.float64)
    np.add.at(w, (b, t), np.where(valid, 1.0 - frac, 0.0))
    np.add.at(w, (hi, t), np.where(valid, frac, 0.0))
    return w


def mapping_from_opus_jnp(mapped_thres, freqs_len: int, srate: int):
    """JAX per-bin divisor interpolation for [..., SUBBANDS] thresholds,
    as ONE [..., SUBBANDS] @ [SUBBANDS, freqs_len] matmul.

    The matmul replaces a per-bin gather (lo + (hi-lo)*frac). Numerically
    it computes lo*(1-frac) + hi*frac (vs the reference formula's
    lo + (hi-lo)*frac, reference p1tools.py:35-41) — an ulp-level
    reassociation; the numpy `mapping_from_opus` keeps the reference
    formula exactly. HIGHEST precision: the matrix is tiny and the
    thresholds deserve full f32."""
    import jax
    import jax.numpy as jnp

    dt = mapped_thres.dtype
    w = jnp.asarray(_interp_matrix(freqs_len, srate), dtype=dt)
    return jnp.matmul(mapped_thres[..., :SUBBANDS], w,
                      precision=jax.lax.Precision.HIGHEST)


def quant_jnp(x):
    """sign(x)*|x|^0.75 as sqrt(|x|*sqrt(|x|)) — two correctly rounded
    sqrts instead of the transcendental pow (exp o log); the
    compositions differ by <=1 ulp. The inverse (dequant) keeps pow."""
    import jax.numpy as jnp
    a = jnp.abs(x)
    return jnp.sign(x) * jnp.sqrt(a * jnp.sqrt(a))


def dequant_jnp(x):
    import jax.numpy as jnp
    return jnp.sign(x) * jnp.abs(x) ** (1.0 / QUANT_ALPHA)
