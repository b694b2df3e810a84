"""On-device Exp-Golomb-Rice bit-packing.

SURVEY §7 hard part (a): frame byte-lengths are data-dependent, so the
device stage emits a FIXED-shape padded word tensor plus per-frame bit
lengths, and the host finishes the bitstream. Packing on the device
shrinks device->host traffic ~8x versus shipping raw int32 coefficient
tensors (the EGR stream is ~4-10 bits/symbol after masking).

The emitted words reproduce the host EGR codec (ops/golomb.py /
native frad_egr_encode) bit-for-bit: same k, same signed mapping, same
unary+binary codes, zero padding to the byte boundary. Valid for symbol
magnitudes < 2^23 (exact float32 bit-length arithmetic); larger depths
fall back to the host encoder per frame via the overflow mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_EXACT = 1 << 23  # |mapped value| bound for exact f32 frexp bit-lengths


def _bitlen(v: jax.Array) -> jax.Array:
    """Exact bit length of positive int32 values < 2^24 via f32 frexp."""
    _, e = jnp.frexp(v.astype(jnp.float32))
    return e.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_words",))
def egr_pack_frames(symbols: jax.Array, max_words: int):
    """Pack [B, M] int32 symbol frames into EGR bitstreams on device.

    Returns (words [B, max_words] uint32 — big-endian bit order within
    each word, i.e. byte `4w+i` of the stream is byte i of word w's
    big-endian form —, total_bits [B] int32, k [B] int32, overflow [B]
    bool). Frames flagged `overflow` exceeded max_words*32 bits and must
    be re-encoded on the host.
    """
    b, m = symbols.shape
    s = symbols.astype(jnp.int32)

    dmax = jnp.max(jnp.abs(s), axis=1)                       # [B]
    k = _bitlen(jnp.maximum(dmax - 1, 0))                    # ceil(log2(dmax))
    mapped = jnp.where(s > 0, (s << 1) - 1, (-s) << 1)
    v = (mapped + (jnp.int32(1) << k[:, None])).astype(jnp.uint32)   # [B, M]

    blen = _bitlen(v.astype(jnp.int32))                      # [B, M]
    code_len = 2 * blen - k[:, None] - 1

    ends = jnp.cumsum(code_len, axis=1)                      # inclusive ends
    total_bits = ends[:, -1]
    overflow = total_bits > max_words * 32

    # value v occupies stream bits [end-blen, end); split across <= 2 words
    end = ends
    start = end - blen
    w0 = start >> 5
    w1 = (end - 1) >> 5

    # contribution to word w: ((v >> (end - bhi)) & mask) << (32w + 32 - bhi)
    # where [blo, bhi) is the intersection of the value's bit range with w
    def word_contrib(w):
        blo = jnp.maximum(start, w << 5)
        bhi = jnp.minimum(end, (w << 5) + 32)
        nbits = bhi - blo
        chunk = (v >> (end - bhi).astype(jnp.uint32)) & (
            (jnp.uint32(1) << nbits.astype(jnp.uint32)) - jnp.uint32(1))
        return chunk << ((w << 5) + 32 - bhi).astype(jnp.uint32)

    c0 = word_contrib(w0)
    c1 = jnp.where(w1 > w0, word_contrib(w1), jnp.uint32(0))
    w1c = jnp.minimum(w1, max_words - 1)
    w0c = jnp.minimum(w0, max_words - 1)

    base = (jnp.arange(b, dtype=jnp.int32) * max_words)[:, None]
    flat = jnp.zeros((b * max_words,), dtype=jnp.uint32)
    flat = flat.at[(base + w0c).ravel()].add(c0.ravel(), mode="drop")
    flat = flat.at[(base + w1c).ravel()].add(
        jnp.where(w1 > w0, c1, 0).ravel(), mode="drop")
    words = flat.reshape(b, max_words)
    return words, total_bits, k, overflow


def words_to_stream(words: np.ndarray, total_bits: int, k: int) -> bytes:
    """Host finisher: one frame's packed words -> EGR byte stream
    (k header byte + ceil(total_bits/8) big-endian bytes)."""
    nbytes = (int(total_bits) + 7) // 8
    raw = words.astype(">u4").tobytes()[:nbytes]
    return bytes([int(k)]) + raw


# ---------------------------------------------------------------------------
# On-device truncated-float packing for the lossless profiles.
#
# The lossless payload is each coefficient's IEEE float truncated to the
# stream depth (reference profile0.py:29-42); packing it ON the device
# means the d2h transfer carries 2/3/4 bytes per value instead of a 4-byte
# f32, and the host skips a full re-pack pass. The emitted words'
# little-endian host byte stream is byte-identical to
# ops/packing.pack_floats(x, bits, little).
# ---------------------------------------------------------------------------

TRUNC_DEVICE_BITS = (16, 24, 32)


def _pack_byte_triples(t: jax.Array, msb_first: bool) -> jax.Array:
    """[B, M] 24-bit values (M % 4 == 0) -> uint32 words [B, M*3//4] whose
    LE host byte stream is the values' 3-byte serialisation."""
    b, m = t.shape
    if msb_first:
        s = jnp.stack([t >> 16, (t >> 8) & 0xFF, t & 0xFF], axis=-1)
    else:
        s = jnp.stack([t & 0xFF, (t >> 8) & 0xFF, t >> 16], axis=-1)
    s = s.reshape(b, m * 3 // 4, 4)
    return s[..., 0] | (s[..., 1] << 8) | (s[..., 2] << 16) | (s[..., 3] << 24)


def pcm_to_i24_words(pcm: jax.Array) -> jax.Array:
    """Traced helper: [B, N, C] float PCM -> packed int24 fixed-point words
    [B, N*C*3//4] (LSB-first triples). Quantisation step 2^-23 puts the
    transfer noise floor at -138 dB — inaudible against any lossless
    stream's own storage truncation — while cutting the d2h PCM transfer
    to 3 bytes/sample."""
    b = pcm.shape[0]
    v = jnp.clip(jnp.rint(pcm.astype(jnp.float32) * (1 << 23)),
                 -(1 << 23), (1 << 23) - 1)
    t = v.astype(jnp.int32).astype(jnp.uint32) & jnp.uint32(0xFFFFFF)
    return _pack_byte_triples(t.reshape(b, -1), msb_first=False)


def i24_words_to_pcm_device(words: jax.Array) -> jax.Array:
    """Traced inverse of `pcm_to_i24_words` ON the device: [B, W] uint32
    packed LSB-first int24 triples -> [B, W*4//3] f32 PCM. Used by the
    i24-upload encode path so the h2d link carries 3 bytes/sample."""
    b, w = words.shape
    c = jnp.stack([words & 0xFF, (words >> 8) & 0xFF,
                   (words >> 16) & 0xFF, words >> 24], axis=-1)
    c = c.reshape(b, w * 4 // 3, 3)
    t = (c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)).astype(jnp.int32)
    v = (t ^ jnp.int32(0x800000)) - jnp.int32(0x800000)
    return v.astype(jnp.float32) * jnp.float32(1.0 / (1 << 23))


def pcm_to_i24_words_host(pcm: np.ndarray) -> np.ndarray:
    """Host forward pack: f64 PCM (flat, size % 4 == 0) -> uint32 words
    matching `pcm_to_i24_words`'s layout, for the encode upload path."""
    from .. import native
    flat = np.ascontiguousarray(pcm, dtype=np.float64).reshape(-1)
    if native.has("frad_f64_to_i24"):
        tri = native.f64_to_i24(flat)
    else:
        v = np.clip(np.rint(flat * (1 << 23)), -(1 << 23), (1 << 23) - 1)
        u = v.astype(np.int64).astype(np.uint32) & np.uint32(0xFFFFFF)
        tri = np.empty(flat.size * 3, dtype=np.uint8)
        tri[0::3] = u & 0xFF
        tri[1::3] = (u >> 8) & 0xFF
        tri[2::3] = u >> 16
    return tri.view("<u4")


def i24_words_to_pcm(words: np.ndarray) -> np.ndarray:
    """Host inverse of `pcm_to_i24_words`: [B, W] uint32 -> [B, W*4//3]
    float64 PCM (flat per row; caller reshapes)."""
    from .. import native
    raw = words.astype("<u4", copy=False).tobytes()
    if native.has("frad_i24_to_f64"):
        # single-pass C++ (the numpy fallback's strided temporaries cost
        # 20+ s on the hi-res config where the C++ loop takes < 0.5 s)
        return native.i24_to_f64(raw).reshape(words.shape[0], -1)
    u8 = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    v = (u8[:, 0].astype(np.int32) | (u8[:, 1].astype(np.int32) << 8)
         | (u8[:, 2].astype(np.int32) << 16))
    v = (v ^ 0x800000) - 0x800000
    return (v.astype(np.float64) * (1.0 / (1 << 23))).reshape(words.shape[0], -1)


@functools.partial(jax.jit, static_argnames=("bits", "little"))
def trunc_pack(x: jax.Array, bits: int, little: bool = False) -> jax.Array:
    """[B, M] f32 -> packed words whose LE byte stream equals
    packing.pack_floats(x, bits, little).

    bits=16 -> uint16 [B, M]; bits=24 -> uint32 [B, M*3//4] (M % 4 == 0);
    bits=32 -> uint32 [B, M].
    """
    x = x.astype(jnp.float32)
    if bits == 16:
        u = jax.lax.bitcast_convert_type(x.astype(jnp.float16), jnp.uint16)
        if little:
            return u
        return (u >> 8) | (u << 8)
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    if bits == 32:
        if little:
            return u
        return ((u >> 24) | ((u >> 8) & 0xFF00)
                | ((u << 8) & 0xFF0000) | (u << 24))
    # 24-bit: keep the top 3 bytes of each f32, stream them in big-endian
    # (or reversed for little) order, 4 values per 3 words.
    return _pack_byte_triples(u >> 8, msb_first=not little)


@functools.partial(jax.jit, static_argnames=("bits", "little"))
def trunc_unpack(words: jax.Array, bits: int, little: bool = False) -> jax.Array:
    """Inverse of `trunc_pack`: packed words -> [B, M] f32 with NaN/Inf
    scrubbed to 0 (reference profile0.py:52-66 semantics)."""
    if bits == 16:
        u = words if little else (words >> 8) | (words << 8)
        x = jax.lax.bitcast_convert_type(u, jnp.float16).astype(jnp.float32)
    elif bits == 32:
        u = words
        if not little:
            u = ((u >> 24) | ((u >> 8) & 0xFF00)
                 | ((u << 8) & 0xFF0000) | (u << 24))
        x = jax.lax.bitcast_convert_type(u, jnp.float32)
    else:
        b, w = words.shape
        c = jnp.stack([words & 0xFF, (words >> 8) & 0xFF,
                       (words >> 16) & 0xFF, words >> 24], axis=-1)
        c = c.reshape(b, w * 4 // 3, 3)
        if little:
            t = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
        else:
            t = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        x = jax.lax.bitcast_convert_type(t << 8, jnp.float32)
    return jnp.where(jnp.isfinite(x), x, jnp.float32(0.0))
