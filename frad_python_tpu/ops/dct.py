"""Batched DCT-II / inverse DCT with scipy `norm='forward'` semantics.

The reference transforms each channel with `scipy.fft.dct(x, norm='forward')`
/ `scipy.fft.idct(..., norm='forward')` in a per-channel Python loop
(src/libfrad/fourier/profile0.py:21,69, profile1.py:21,77). Here the
transform is batched over [..., N]:

* **Matmul path** (f32, N <= MATMUL_MAX_N): the DCT is a single
  [batch, N] @ [N, N] matmul (cuBLAS on a GPU) at the precision the
  caller names — HIGHEST unless told otherwise. Matrices are cached per
  (N, dtype).
* **FFT path** (all f64, and f32 above the matrix cap): Makhoul's
  N-point algorithm — even/odd reordering + complex FFT + twiddle —
  O(N log N). At f64 it is both ~57 dB more accurate than the matmul
  (no N-step rounding accumulation) and ~13x faster on the host CPU,
  matching the reference's scipy FFT-based DCT; it is mandatory for the
  archival 48/64-bit depths. c64 for f32 input, c128 for f64.

Normalisation (scipy 'forward'):
  forward:  X[k] = (1/N) * sum_t x[t] cos(pi k (2t+1) / (2N))
  inverse:  x[t] = X[0] + 2 * sum_{k>=1} X[k] cos(pi k (2t+1) / (2N))
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Largest N for which the NxN matmul formulation is used. 8192^2 f32 = 256 MiB
# per matrix. The matmul case is f32-only: at f64 (the CPU and archival
# path) the FFT formulation is BOTH ~57 dB more accurate (3.6e-16 vs
# 2.7e-13 rel err at N=2048 — the matmul accumulates N rounding steps per
# output) and ~13x faster on the host, matching the reference's scipy
# FFT-based DCT.
MATMUL_MAX_N = 8192


def use_matmul(n: int, dtype) -> bool:
    """Matmul formulation only for f32 and N within the matrix cap."""
    return n <= MATMUL_MAX_N and jnp.dtype(dtype) != jnp.float64


def _batched_fft(v: jax.Array, inverse: bool) -> jax.Array:
    fft = jnp.fft.ifft if inverse else jnp.fft.fft
    return fft(v, axis=-1)


@functools.lru_cache(maxsize=64)
def _dct_matrices(n: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(forward, inverse) DCT matrices. forward: X = x @ F; inverse: x = X @ G.

    Returned as host numpy arrays (cached); they become baked-in jit
    constants so the same matrix is materialised once per compiled shape.
    """
    # Build in float64 on host for accuracy, then cast.
    k = np.arange(n, dtype=np.float64)[:, None]
    t = np.arange(n, dtype=np.float64)[None, :]
    cos = np.cos(np.pi * k * (2.0 * t + 1.0) / (2.0 * n))
    fwd = (cos / n).T  # [t, k] so that x @ fwd -> X
    w = np.full((n, 1), 2.0)
    w[0, 0] = 1.0
    inv = w * cos  # [k, t] so that X @ inv -> x
    dt = np.dtype(dtype_name)
    return np.ascontiguousarray(fwd, dtype=dt), np.ascontiguousarray(inv, dtype=dt)


def _twiddle(n: int, dtype, sign: float) -> jax.Array:
    """exp(sign * i*pi*k/(2n)) in the complex type matching `dtype`
    (complex64 for f32, complex128 for f64)."""
    cdt = jnp.complex64 if jnp.dtype(dtype) == jnp.float32 else jnp.complex128
    k = np.arange(n, dtype=np.float64)
    tw = np.exp(sign * 1j * np.pi * k / (2.0 * n))
    return jnp.asarray(tw, dtype=cdt)


def _fft_dct2(x: jax.Array) -> jax.Array:
    """Unnormalised DCT-II (factor-2 convention) of the last axis via FFT."""
    n = x.shape[-1]
    v = jnp.concatenate([x[..., ::2], x[..., 1::2][..., ::-1]], axis=-1)
    big = _batched_fft(v, inverse=False)
    tw = _twiddle(n, x.dtype, -1.0)
    return 2.0 * jnp.real(big * tw).astype(x.dtype)


def _fft_idct2(yu: jax.Array) -> jax.Array:
    """Exact inverse of `_fft_dct2` (input: unnormalised DCT-II coeffs).

    Derivation: forward gives X[k] = 2 Re W[k] and X[N-k] = -2 Im W[k]
    where W[k] = e^{-i pi k/(2N)} FFT(reorder(x))[k]; so
    W = (X - i X_rev)/2, V = e^{+i pi k/(2N)} W, x = unreorder(ifft(V)).
    """
    n = yu.shape[-1]
    y_rev = jnp.concatenate([jnp.zeros_like(yu[..., :1]), yu[..., :0:-1]], axis=-1)
    tw = _twiddle(n, yu.dtype, 1.0)
    big = (0.5 * (yu - 1j * y_rev).astype(tw.dtype)) * tw
    v = jnp.real(_batched_fft(big, inverse=True)).astype(yu.dtype)
    half = (n + 1) // 2
    x = jnp.zeros_like(yu)
    x = x.at[..., ::2].set(v[..., :half])
    x = x.at[..., 1::2].set(v[..., half:][..., ::-1])
    return x


@functools.lru_cache(maxsize=8)
def _device_matrix_maker(n: int):
    """Jitted on-device builder of the f32 (forward, inverse) DCT matrices.

    The cosine argument is reduced with EXACT int32 arithmetic
    (k*(2t+1) mod 4n, products < 2^31 for every FrAD frame size, so the
    angle is < 2*pi before any float rounding) — measured 4e-7 max cos
    deviation from the host f64 build at n=8192, i.e. one f32 ulp.
    Building on device skips the host build and the upload of up to
    256 MB per matrix pair at first use.
    """

    def make():
        k = jnp.arange(n, dtype=jnp.int32)[:, None]
        t = jnp.arange(n, dtype=jnp.int32)[None, :]
        m = (k * (2 * t + 1)) % (4 * n)
        cos = jnp.cos(jnp.float32(np.pi / (2.0 * n)) * m.astype(jnp.float32))
        fwd = (cos / jnp.float32(n)).T
        w = jnp.where(k == 0, 1.0, 2.0).astype(jnp.float32)
        inv = w * cos
        return fwd, inv

    return jax.jit(make)


def device_matrices(n: int, dtype_name: str):
    """(forward, inverse) DCT matrices resident on the default device.
    Under an outer trace (a user jitting one of the public wrappers)
    returns uncached HOST constants instead — device_put/jit would yield
    tracers there, which must never enter the lru cache."""
    from jax._src import core as _core

    if not _core.trace_state_clean():
        return _dct_matrices(n, dtype_name)
    return _device_matrices_cached(n, dtype_name)


@functools.lru_cache(maxsize=64)
def _device_matrices_cached(n: int, dtype_name: str) -> tuple[jax.Array, jax.Array]:
    """(forward, inverse) DCT matrices resident on the default device.

    Passed to the jitted cores as ARGUMENTS rather than closed-over
    constants — a 16-64 MB HLO constant makes XLA constant-fold for tens
    of seconds per compiled shape; as parameters, compiles are fast and
    the persistent compilation cache stays effective.

    f32 matrices are generated ON the device (`_device_matrix_maker`);
    f64 (CPU backend) builds on host where f64 cos is native.
    """
    if np.dtype(dtype_name) == np.float32 and jax.default_backend() != "cpu":
        fwd, inv = _device_matrix_maker(n)()
        return fwd, inv
    fwd, inv = _dct_matrices(n, dtype_name)
    return jax.device_put(fwd), jax.device_put(inv)


def _dct2_impl(x: jax.Array, use_matmul: bool, mat: jax.Array | None = None,
               precision=None) -> jax.Array:
    """Traced helper (call inside jit): forward-normalised DCT-II.

    `precision` defaults to HIGHEST (the lossless contract); the lossy
    cores pass `policy.lossy_matmul_precision()`."""
    n = x.shape[-1]
    if use_matmul:
        if mat is None:
            mat, _ = _dct_matrices(n, str(x.dtype))
        return jnp.matmul(x, mat,
                          precision=precision or jax.lax.Precision.HIGHEST)
    return _fft_dct2(x) / (2.0 * n)


def _idct2_impl(y: jax.Array, use_matmul: bool, mat: jax.Array | None = None,
                precision=None) -> jax.Array:
    """Traced helper (call inside jit): inverse of `_dct2_impl`."""
    n = y.shape[-1]
    if use_matmul:
        if mat is None:
            _, mat = _dct_matrices(n, str(y.dtype))
        return jnp.matmul(y, mat,
                          precision=precision or jax.lax.Precision.HIGHEST)
    return _fft_idct2(y * (2.0 * n))


@functools.partial(jax.jit, static_argnames=("use_matmul",))
def _dct2_jit(x: jax.Array, mat, use_matmul: bool) -> jax.Array:
    return _dct2_impl(x, use_matmul, mat)


@functools.partial(jax.jit, static_argnames=("use_matmul",))
def _idct2_jit(y: jax.Array, mat, use_matmul: bool) -> jax.Array:
    return _idct2_impl(y, use_matmul, mat)


def _mats_for(n: int, dtype) -> tuple[jax.Array | None, jax.Array | None]:
    if not use_matmul(n, dtype):
        return None, None
    return device_matrices(n, str(jnp.dtype(dtype)))


def dct2_forward(x, axis: int = -1):
    """DCT-II with scipy norm='forward' over `axis`. Accepts np/jnp arrays."""
    x = jnp.asarray(x)
    x = jnp.moveaxis(x, axis, -1)
    fwd, _ = _mats_for(x.shape[-1], x.dtype)
    out = _dct2_jit(x, fwd, use_matmul(x.shape[-1], x.dtype))
    return jnp.moveaxis(out, -1, axis)


def idct2_forward(y, axis: int = -1):
    """Inverse DCT (scipy idct type-2, norm='forward') over `axis`."""
    y = jnp.asarray(y)
    y = jnp.moveaxis(y, axis, -1)
    _, inv = _mats_for(y.shape[-1], y.dtype)
    out = _idct2_jit(y, inv, use_matmul(y.shape[-1], y.dtype))
    return jnp.moveaxis(out, -1, axis)
