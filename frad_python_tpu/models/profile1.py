"""Profile 1 — lossy DCT codec with psychoacoustic quantisation.

Pipeline parity with reference src/libfrad/fourier/profile1.py:
pad frame to the next compact size -> DCT-II forward -> per-channel
psychoacoustic threshold -> per-bin divisor -> power-law quantisation
(alpha=0.75) -> log_{e/2}-companded thresholds -> Exp-Golomb-Rice streams
`[u32 thres_len][thres][freqs]` -> raw DEFLATE (wbits=-15).
Decode inverts the chain and emits a zero frame on corrupt DEFLATE
(reference profile1.py:59-64).

Batched: the whole tensor chain is the fused jitted core in
models/batch.py (one DCT matmul + one subband matmul + elementwise),
shared between this streaming wrapper (B=1) and the batch/sharded
pipelines so both produce identical streams. Host side: EGR + DEFLATE.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..ops import golomb, policy, psycho
from . import batch
from .profiles import compact

DEPTHS = (8, 12, 16, 24, 32, 48, 64)


def _scale_factor(bits: int) -> float:
    """2^(bits-1) (reference profile1.py:9-10)."""
    return float(2.0 ** (bits - 1))


def _untrim(arr: np.ndarray, fsize: int, channels: int) -> np.ndarray:
    """Zero-pad a flat array up to fsize*channels (profile1.py:12-13)."""
    need = fsize * channels - len(arr)
    return np.pad(arr, (0, max(0, need))) if need > 0 else arr


def pack_streams(freqs_flat: np.ndarray, thres_flat: np.ndarray) -> bytes:
    """EGR-encode + frame layout + DEFLATE (profile1.py:43-50)."""
    thres_gol = golomb.encode(thres_flat)
    freqs_gol = golomb.encode(freqs_flat)
    frad = struct.pack(">I", len(thres_gol)) + thres_gol + freqs_gol
    return zlib.compress(frad, wbits=-15)


def unpack_streams(frad: bytes) -> tuple[np.ndarray, np.ndarray] | None:
    """Inverse of `pack_streams`; None on corrupt payload."""
    try:
        frad = zlib.decompress(frad, wbits=-15)
    except Exception:
        return None
    if len(frad) < 4:
        return None
    (thres_len,) = struct.unpack(">I", frad[:4])
    thres_gol = frad[4:4 + thres_len]
    freqs_gol = frad[4 + thres_len:]
    return golomb.decode(freqs_gol), golomb.decode(thres_gol)


def prepare_frame(pcm: np.ndarray, srate: int, loss_level: float):
    """Shared preprocessing: pad to the compact grid, coerce srate/loss."""
    pcm = np.asarray(pcm, dtype=np.float64)
    dlen = compact.get_samples_min_ge(max(len(pcm), 1))
    if dlen > len(pcm):
        pcm = np.pad(pcm, ((0, dlen - len(pcm)), (0, 0)))
    return pcm, compact.get_valid_srate(srate), max(abs(loss_level), 0.125)


def analogue(pcm: np.ndarray, bits: int, srate: int, loss_level: float) -> tuple[bytes, int, int, int]:
    """Encode one frame: [fsize, channels] f64 PCM -> (payload, depth index,
    channels, srate)."""
    if bits not in DEPTHS:
        bits = 16
    factor = _scale_factor(bits)
    pcm, srate, loss_level = prepare_frame(pcm, srate, loss_level)
    channels = pcm.shape[1]

    fq, tq = batch.p1_encode_core(
        pcm[None].astype(policy.compute_dtype()), srate, loss_level, factor)
    freqs_flat = np.asarray(fq[0]).ravel()       # [N, C] -> interleaved
    thres_flat = np.asarray(tq[0]).ravel()       # [27, C] -> interleaved

    return pack_streams(freqs_flat, thres_flat), DEPTHS.index(bits), channels, srate


def digital(frad: bytes, bit_depth_index: int, channels: int, srate: int, fsize: int) -> np.ndarray:
    """Decode one frame payload -> [fsize, channels] f64 PCM."""
    bits = DEPTHS[bit_depth_index]
    factor = _scale_factor(bits)

    streams = unpack_streams(frad)
    if streams is None:
        return np.zeros((fsize, channels))
    freqs_ints, thres_ints = streams

    # pad up to / trim down to the frame grid (corrupt payloads may decode
    # to ragged lengths; the reference would crash on reshape)
    freqs_flat = _untrim(freqs_ints.astype(np.float64), fsize, channels)[: fsize * channels]
    thres_flat = _untrim(thres_ints.astype(np.float64), psycho.SUBBANDS, channels)[: psycho.SUBBANDS * channels]

    freqs = freqs_flat.reshape(fsize, channels)
    thres = thres_flat.reshape(psycho.SUBBANDS, channels)

    dt = policy.compute_dtype()
    pcm = batch.p1_decode_core(freqs[None].astype(dt), thres[None].astype(dt),
                               srate, factor)
    return np.asarray(pcm[0], dtype=np.float64)
