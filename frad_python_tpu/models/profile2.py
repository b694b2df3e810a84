"""Profile 2 — lossy DCT codec with Temporal Noise Shaping (experimental).

Profile 1's chain with TNS analysis between masking and quantisation
and payload `[u16 lpc_len][lpc][u32 thres_len][thres][freqs]`
(reference src/libfrad/fourier/profile2.py). Kept out of AVAILABLE just
like the reference (src/libfrad/fourier/__init__.py:3) but implemented
for capability parity; depth table differs from profile 1
(profile2.py:7).

Batched: the whole chain — DCT, masking, batched order-12 LPC
(unrolled Levinson), FIR analysis / scanned IIR synthesis, quantisation —
is the fused jitted core in models/batch.py (shared with the batch
pipeline at B=1); host side is EGR + DEFLATE.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..ops import golomb, policy, psycho, tns_jax
from . import batch
from .profile1 import _scale_factor, _untrim, prepare_frame

DEPTHS = (8, 10, 12, 14, 16, 20, 24)


def pack_streams(freqs_flat: np.ndarray, thres_flat: np.ndarray,
                 lpc_flat: np.ndarray) -> bytes:
    """EGR-encode + frame layout + DEFLATE (profile2.py:48-54)."""
    lpc_gol = golomb.encode(lpc_flat)
    thres_gol = golomb.encode(thres_flat)
    freqs_gol = golomb.encode(freqs_flat)
    frad = (struct.pack(">H", len(lpc_gol)) + lpc_gol
            + struct.pack(">I", len(thres_gol)) + thres_gol + freqs_gol)
    return zlib.compress(frad, wbits=-15)


def unpack_streams(frad: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Inverse of `pack_streams`; None on corrupt payload."""
    try:
        frad = zlib.decompress(frad, wbits=-15)
    except Exception:
        return None
    if len(frad) < 6:
        return None
    (lpc_len,) = struct.unpack(">H", frad[:2])
    lpc_gol = frad[2:2 + lpc_len]
    frad = frad[2 + lpc_len:]
    if len(frad) < 4:
        return None
    (thres_len,) = struct.unpack(">I", frad[:4])
    thres_gol = frad[4:4 + thres_len]
    freqs_gol = frad[4 + thres_len:]
    return (golomb.decode(freqs_gol), golomb.decode(thres_gol),
            golomb.decode(lpc_gol))


def analogue(pcm: np.ndarray, bits: int, srate: int, loss_level: float) -> tuple[bytes, int, int, int]:
    if bits not in DEPTHS:
        bits = 16
    factor = _scale_factor(bits)
    pcm, srate, loss_level = prepare_frame(pcm, srate, loss_level)
    channels = pcm.shape[1]

    fq, tq, lq = batch.p2_encode_core(
        pcm[None].astype(policy.compute_dtype()), srate, loss_level, factor)
    freqs_flat = np.asarray(fq[0]).ravel()
    thres_flat = np.asarray(tq[0]).ravel()
    lpc_flat = np.asarray(lq[0]).ravel()

    return (pack_streams(freqs_flat, thres_flat, lpc_flat),
            DEPTHS.index(bits), channels, srate)


def digital(frad: bytes, bit_depth_index: int, channels: int, srate: int, fsize: int) -> np.ndarray:
    bits = DEPTHS[bit_depth_index]
    factor = _scale_factor(bits)

    streams = unpack_streams(frad)
    if streams is None:
        return np.zeros((fsize, channels))
    freqs_ints, thres_ints, lpc_ints = streams

    order1 = tns_jax.MAX_ORDER + 1
    freqs_flat = _untrim(freqs_ints.astype(np.float64), fsize, channels)[: fsize * channels]
    thres_flat = _untrim(thres_ints.astype(np.float64), psycho.SUBBANDS, channels)[: psycho.SUBBANDS * channels]
    lpc_flat = _untrim(lpc_ints.astype(np.float64), order1, channels)[: order1 * channels]

    dt = policy.compute_dtype()
    pcm = batch.p2_decode_core(
        freqs_flat.reshape(fsize, channels)[None].astype(dt),
        thres_flat.reshape(psycho.SUBBANDS, channels)[None].astype(dt),
        lpc_flat.reshape(order1, channels)[None].astype(dt),
        srate, factor)
    return np.asarray(pcm[0], dtype=np.float64)
