"""Profile 0 — lossless DCT archival codec.

Pipeline parity with reference src/libfrad/fourier/profile0.py:
forward DCT-II (norm='forward') per channel -> automatic bit-depth
escalation on container-float overflow (profile0.py:24-26) -> truncated
IEEE-float packing at 12..64 bits (profile0.py:29-42). Decode: re-pad
bytes, NaN/Inf scrub, inverse DCT (profile0.py:52-69).

Departures: the DCT runs batched over all channels at once as a single
[ch, N] @ [N, N] matmul (ops/dct.py) instead of a per-channel scipy
loop, and the bit-packings are vectorised numpy (ops/packing.py).
"""

from __future__ import annotations

import contextlib

import numpy as np

from ..ops import packing, policy
from ..ops.dct import dct2_forward, idct2_forward

DEPTHS = packing.DEPTHS


def _route(bits: int):
    """Archival depths run their f64 transform on the host CPU backend
    (policy.deep_device); every other depth on the default device."""
    if bits >= policy.DEEP_BITS:
        return policy.deep_device()
    return contextlib.nullcontext()


def _forward(pcm: np.ndarray, dt: str, bits: int) -> np.ndarray:
    """Forward DCT at dtype `dt` for a `bits`-deep container."""
    with _route(bits):
        return np.asarray(dct2_forward(pcm.astype(dt), axis=0),
                          dtype=np.float64)


def _escalates_deep(max_abs: float, bits: int) -> bool:
    """True when depth escalation from `bits` would land in a container
    deeper than f32 precision (incl. f32 overflow showing up as inf)."""
    if not np.isfinite(max_abs):
        return True
    try:
        return packing.needed_depth(max_abs, bits) >= policy.DEEP_BITS
    except OverflowError:
        return True


def analogue(pcm: np.ndarray, bits: int, srate: int, little_endian: bool) -> tuple[bytes, int, int, int]:
    """Encode one frame: [fsize, channels] f64 PCM -> (payload, depth index,
    channels, srate)."""
    if bits not in DEPTHS:
        bits = 16
    channels = pcm.shape[1] if pcm.ndim > 1 else 1
    pcm = np.asarray(pcm, dtype=np.float64).reshape(-1, channels)

    dt = policy.transform_dtype(bits)
    freqs = _forward(pcm, dt, bits)

    max_abs = float(np.max(np.abs(freqs))) if freqs.size else 0.0
    if dt != "float64" and _escalates_deep(max_abs, bits):
        # escalation crossed into a deeper-than-f32 container (possibly
        # via f32 overflow -> inf): redo at archival precision. The
        # 48-bit container shares f64's exponent range, so escalation
        # can never continue past it — the 64-bit depth is reached only
        # by explicit request.
        freqs = _forward(pcm, "float64", policy.DEEP_BITS)
        max_abs = float(np.max(np.abs(freqs))) if freqs.size else 0.0
    bits = packing.needed_depth(max_abs, bits)

    frad = packing.pack_floats(freqs.ravel(), bits, little_endian)
    return frad, DEPTHS.index(bits), channels, srate


def digital(frad: bytes, bit_depth_index: int, channels: int, little_endian: bool) -> np.ndarray:
    """Decode one frame payload -> [fsize, channels] f64 PCM."""
    bits = DEPTHS[bit_depth_index]
    flat = packing.unpack_floats(frad, bits, little_endian)
    n = (len(flat) // channels) * channels
    dt = policy.transform_dtype(bits)
    freqs = flat[:n].reshape(-1, channels).astype(dt)
    with _route(bits):
        return np.asarray(idct2_forward(freqs, axis=0), dtype=np.float64)
