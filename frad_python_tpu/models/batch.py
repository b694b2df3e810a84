"""Fused, batched compute cores for the FrAD profiles.

This is the tensor-domain heart of the framework: each core is a single
jitted function over a frame batch [B, N, C] that XLA fuses into a few
matmuls (DCT, subband reduction) plus elementwise work. The
streaming engines call these with B=1; `parallel.batch_encode/decode`
feed whole files; `parallel.sharded` pjits them over a device mesh.

Reference mapping: profile0.py:21/69 (DCT), profile1.py:21-45 (DCT ->
masking -> quant -> compand), executed there as per-channel scipy/numpy
loops — here one traced graph, batched over frames AND channels.
"""

from __future__ import annotations

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import psycho
from ..ops.dct import _dct2_impl, _idct2_impl, device_matrices, use_matmul


def _use_matmul(n: int, dtype=jnp.float32) -> bool:
    return use_matmul(n, dtype)


def _mats(n: int, dtype) -> tuple[jax.Array | None, jax.Array | None]:
    """DCT matrices as device-resident jit ARGUMENTS (never HLO
    constants — giant constants stall XLA constant folding for tens of
    seconds per compiled shape)."""
    if not use_matmul(n, dtype):
        return None, None
    return device_matrices(n, str(jnp.dtype(dtype)))


# ---------------------------------------------------------------------------
# Automatic frame-batch data parallelism (SURVEY §2 N1)
#
# Every public core below routes its [B, ...] input through `place_rows`:
# with >1 visible device the batch axis is laid out row-sharded over a 1-D
# 'data' mesh, so the SAME jitted programs compile SPMD and XLA splits the
# DCT/subband matmuls per shard with zero communication (overlap-add's
# neighbour shift becomes one compiler-inserted collective-permute). With
# one device this is a plain device_put.
# Per-row results are bit-identical either way — rows never interact
# except in overlap-add, whose halo row is exchanged, not recomputed.
# ---------------------------------------------------------------------------

#: don't shard tiny batches: under 2 rows/device the collective + padding
#: overhead beats the win, and B=1 streaming calls must stay single-device
_MIN_ROWS_PER_DEVICE = 2

#: master switch for automatic data-parallel sharding (env
#: FRAD_TPU_NO_SHARD=1 disables it for a whole process; the context
#: manager below disables it for a scope — used by equality tests and
#: the driver dryrun to compare sharded vs single-device output)
SHARDING = not os.environ.get("FRAD_TPU_NO_SHARD")


@contextlib.contextmanager
def sharding_disabled():
    """Force the single-device path within the scope (for comparisons)."""
    global SHARDING
    old, SHARDING = SHARDING, False
    try:
        yield
    finally:
        SHARDING = old


@functools.lru_cache(maxsize=1)
def _data_mesh():
    """1-D mesh over this process's devices, or None when single-device.

    Local devices only: under multi-process (multi-host) execution each
    process encodes its own host_span with its own chips — cross-host
    parallelism is the span split plus the byte-domain gather
    (parallel/multihost.py), not a global array."""
    devs = jax.local_devices()
    if len(devs) < 2:
        return None
    from jax.sharding import Mesh

    return Mesh(np.asarray(devs), ("data",))


def data_sharding(nbatch: int):
    """NamedSharding for a [B, ...] batch, or None when sharding is off
    (single device / batch too small to amortise)."""
    if not SHARDING:
        return None
    mesh = _data_mesh()
    if mesh is None or nbatch < _MIN_ROWS_PER_DEVICE * mesh.devices.size:
        return None
    from jax.sharding import NamedSharding, PartitionSpec

    return NamedSharding(mesh, PartitionSpec("data"))


def place_rows(arr) -> tuple[jax.Array, int]:
    """Place a [B, ...] array row-sharded over the data mesh.

    Returns (device_array, pad): `pad` zero rows were appended so B
    divides the device count — callers slice them off the result.
    """
    if isinstance(arr, jax.core.Tracer):
        # called under an outer jit/vmap trace: placement is the outer
        # transform's job; run the single-device program
        return arr, 0
    arr = np.asarray(arr) if not isinstance(arr, jax.Array) else arr
    spec = data_sharding(arr.shape[0])
    if spec is not None and arr.dtype == np.float64 \
            and spec.mesh.devices.flat[0].platform != "cpu":
        # archival f64 transforms run on the host CPU backend
        # (policy.deep_device); never shard them onto a GPU mesh
        spec = None
    if spec is None:
        return jnp.asarray(arr), 0
    ndev = spec.mesh.devices.size
    pad = (-arr.shape[0]) % ndev
    if pad:
        arr = np.concatenate(
            [np.asarray(arr),
             np.zeros((pad,) + arr.shape[1:], dtype=np.asarray(arr).dtype)])
    return jax.device_put(arr, spec), pad


def _unpad(out, pad: int):
    return out[:-pad] if pad else out


@functools.lru_cache(maxsize=64)
def _replicated_mats(n: int, dtype_name: str):
    """DCT matrices replicated over the data mesh (jit rejects mixing a
    mesh-sharded batch with operands committed to a single device)."""
    from jax.sharding import NamedSharding, PartitionSpec

    fwd, inv = device_matrices(n, dtype_name)
    rep = NamedSharding(_data_mesh(), PartitionSpec())
    return jax.device_put(fwd, rep), jax.device_put(inv, rep)


def _mats_like(n: int, dtype, arr) -> tuple[jax.Array | None, jax.Array | None]:
    """`_mats`, matched to `arr`'s placement (replicated when sharded)."""
    if not use_matmul(n, dtype):
        return None, None
    if not isinstance(arr, jax.core.Tracer) \
            and isinstance(arr, jax.Array) and len(arr.sharding.device_set) > 1:
        return _replicated_mats(n, str(jnp.dtype(dtype)))
    return device_matrices(n, str(jnp.dtype(dtype)))


# ---------------------------------------------------------------------------
# Profile 0 cores: plain forward/inverse DCT over the frame axis
# ---------------------------------------------------------------------------
@jax.jit
def _p0_encode_jit(frames: jax.Array, fwd) -> jax.Array:
    x = jnp.swapaxes(frames, 1, 2)                 # [B, C, N]
    y = _dct2_impl(x, _use_matmul(x.shape[-1], x.dtype), fwd)
    return jnp.swapaxes(y, 1, 2)


def p0_encode_core(frames) -> jax.Array:
    """[B, N, C] PCM -> [B, N, C] DCT-II 'forward' coefficients."""
    frames, pad = place_rows(frames)
    fwd, _ = _mats_like(frames.shape[1], frames.dtype, frames)
    return _unpad(_p0_encode_jit(frames, fwd), pad)


@jax.jit
def _p0_decode_jit(freqs: jax.Array, inv) -> jax.Array:
    y = jnp.swapaxes(freqs, 1, 2)
    x = _idct2_impl(y, _use_matmul(y.shape[-1], y.dtype), inv)
    return jnp.swapaxes(x, 1, 2)


def p0_decode_core(freqs) -> jax.Array:
    """[B, N, C] coefficients -> [B, N, C] PCM."""
    freqs, pad = place_rows(freqs)
    _, inv = _mats_like(freqs.shape[1], freqs.dtype, freqs)
    return _unpad(_p0_decode_jit(freqs, inv), pad)


def p0_encode_pack_core(frames, bits: int, little: bool):
    """[B, N, C] PCM -> (packed payload words [B, W], maxabs [B] f32).

    Fuses the forward DCT with the on-device truncated-float packing
    (ops/bitpack.trunc_pack) so the d2h link carries the final payload
    bytes, not f32 coefficients. `maxabs` drives the host's bit-depth
    escalation check (reference profile0.py:24-26); frames whose max
    exceeds the container float's range must fall back to the host path.
    """
    frames, pad = place_rows(np.asarray(frames, dtype=np.float32))
    fwd, _ = _mats_like(frames.shape[1], frames.dtype, frames)
    words, maxabs = _p0_encode_pack_jit(frames, bits, little, fwd)
    return _unpad(words, pad), _unpad(maxabs, pad)


@functools.partial(jax.jit, static_argnames=("bits", "little"))
def _p0_encode_pack_jit(frames: jax.Array, bits: int, little: bool, fwd):
    from ..ops import bitpack

    b = frames.shape[0]
    x = jnp.swapaxes(frames, 1, 2)                 # [B, C, N]
    y = _dct2_impl(x, _use_matmul(x.shape[-1], x.dtype), fwd)
    flat = jnp.swapaxes(y, 1, 2).reshape(b, -1)    # frame-major interleave
    maxabs = jnp.max(jnp.abs(flat), axis=1)
    words = bitpack.trunc_pack.__wrapped__(flat, bits, little)
    return words, maxabs


def p0_encode_pack_core_i24(words, bits: int, little: bool, n: int, ch: int):
    """i24-upload variant of `p0_encode_pack_core`: [B, n*ch*3//4] uint32
    packed int24 PCM words -> (payload words, maxabs). The h2d link
    carries 3 bytes/sample instead of a 4-byte f32 (the i24 step is
    -138 dB, far under the 24-bit container's own truncation)."""
    words, pad = place_rows(words)
    fwd, _ = _mats_like(n, jnp.float32, words)
    out_w, maxabs = _p0_encode_pack_i24_jit(words, bits, little, n, ch, fwd)
    return _unpad(out_w, pad), _unpad(maxabs, pad)


@functools.partial(jax.jit, static_argnames=("bits", "little", "n", "ch"))
def _p0_encode_pack_i24_jit(words: jax.Array, bits: int, little: bool,
                            n: int, ch: int, fwd):
    from ..ops import bitpack

    b = words.shape[0]
    frames = bitpack.i24_words_to_pcm_device(words).reshape(b, n, ch)
    return _p0_encode_pack_jit.__wrapped__(frames, bits, little, fwd)


def p0_unpack_decode_core(words, bits: int, little: bool, n: int, ch: int):
    """Packed payload words [B, W] -> [B, n, ch] PCM: on-device unpack
    (ops/bitpack.trunc_unpack) fused with the inverse DCT — the h2d link
    carries the stream's own payload bytes."""
    words, pad = place_rows(words)
    _, inv = _mats_like(n, jnp.float32, words)
    return _unpad(_p0_unpack_decode_jit(words, bits, little, n, ch, inv), pad)


@functools.partial(jax.jit, static_argnames=("bits", "little", "n", "ch", "i24"))
def _p0_unpack_decode_jit(words: jax.Array, bits: int, little: bool,
                          n: int, ch: int, inv, i24: bool = False):
    from ..ops import bitpack

    flat = bitpack.trunc_unpack.__wrapped__(words, bits, little)
    freqs = flat.reshape(words.shape[0], n, ch)
    y = jnp.swapaxes(freqs, 1, 2)
    x = _idct2_impl(y, _use_matmul(n, y.dtype), inv)
    pcm = jnp.swapaxes(x, 1, 2)
    if i24:
        return bitpack.pcm_to_i24_words(pcm)
    return pcm


def p0_unpack_decode_i24_core(words, bits: int, little: bool, n: int, ch: int):
    """`p0_unpack_decode_core` returning packed int24 fixed-point PCM words
    (ops/bitpack.pcm_to_i24_words) — 3 bytes/sample over the d2h link."""
    words, pad = place_rows(words)
    _, inv = _mats_like(n, jnp.float32, words)
    return _unpad(
        _p0_unpack_decode_jit(words, bits, little, n, ch, inv, i24=True), pad)


# ---------------------------------------------------------------------------
# Profile 1 cores: DCT -> psychoacoustic masking -> power-law quantisation
# ---------------------------------------------------------------------------
def p1_encode_core(frames, srate: int, loss_level, factor):
    """[B, N, C] PCM -> (freqs_q [B, N, C] int, thres_q [B, SUBBANDS, C] int).

    Integer outputs feed the host EGR+DEFLATE stage; everything here is
    one fused graph (reference profile1.py:21-40 chain).
    """
    frames, pad = place_rows(frames)
    fwd, _ = _mats_like(frames.shape[1], frames.dtype, frames)
    fq, tq = _p1_encode_jit(frames, srate,
                            jnp.asarray(loss_level, frames.dtype),
                            jnp.asarray(factor, frames.dtype), fwd)
    return _unpad(fq, pad), _unpad(tq, pad)


@functools.partial(jax.jit, static_argnames=("srate",))
def _p1_encode_jit(frames: jax.Array, srate: int, loss_level: jax.Array,
                   factor: jax.Array, fwd):
    from ..ops import policy

    n = frames.shape[1]
    x = jnp.swapaxes(frames, 1, 2)                             # [B, C, N]
    # lossy profile: precision from policy.lossy_matmul_precision
    freqs = _dct2_impl(x, _use_matmul(n, x.dtype), fwd,
                       precision=policy.lossy_matmul_precision())

    thres = psycho.mask_thres_mos_jnp(jnp.abs(freqs) * factor, srate, loss_level)
    div = psycho.mapping_from_opus_jnp(thres, n, srate)
    div = jnp.where(div == 0.0, jnp.inf, div)
    masked = freqs / div

    idt = (jnp.int64 if (frames.dtype == jnp.float64
                         and jax.config.read("jax_enable_x64")) else jnp.int32)
    freqs_q = jnp.rint(psycho.quant_jnp(masked * factor)).astype(idt)
    log_base = jnp.log(jnp.asarray(np.e / 2.0, dtype=frames.dtype))
    thres_q = jnp.rint(
        psycho.dequant_jnp(jnp.log(jnp.clip(thres, min=1.0)) / log_base)
    ).astype(idt)

    return jnp.swapaxes(freqs_q, 1, 2), jnp.swapaxes(thres_q, 1, 2)


def p1_encode_core_i16(frames_i16, srate: int, loss_level, factor):
    """i16-upload variant of `p1_encode_core`: [B, N, C] int16 PCM
    (x * 32768) -> same outputs. Halves the encode h2d transfer; the
    -96 dB quantisation floor is inaudible against the lossy profile's
    masking-dominated noise."""
    frames_i16, pad = place_rows(frames_i16)
    fwd, _ = _mats_like(frames_i16.shape[1], jnp.float32, frames_i16)
    fq, tq = _p1_encode_i16_jit(frames_i16, srate,
                                jnp.asarray(loss_level, jnp.float32),
                                jnp.asarray(factor, jnp.float32), fwd)
    return _unpad(fq, pad), _unpad(tq, pad)


@functools.partial(jax.jit, static_argnames=("srate",))
def _p1_encode_i16_jit(frames_i16: jax.Array, srate: int, loss_level: jax.Array,
                       factor: jax.Array, fwd):
    frames = frames_i16.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
    return _p1_encode_jit.__wrapped__(frames, srate, loss_level, factor, fwd)


def p1_decode_core(freqs_flat, thres_flat, srate: int, factor) -> jax.Array:
    """([B, N, C] compand-domain floats, [B, SUBBANDS, C] threshold ints)
    -> [B, N, C] PCM (reference profile1.py:66-77 chain)."""
    freqs_flat, pad = place_rows(freqs_flat)
    thres_flat, _ = place_rows(np.concatenate(
        [np.asarray(thres_flat),
         np.zeros((pad,) + np.asarray(thres_flat).shape[1:],
                  np.asarray(thres_flat).dtype)]) if pad else thres_flat)
    _, inv = _mats_like(freqs_flat.shape[1], freqs_flat.dtype, freqs_flat)
    return _unpad(_p1_decode_jit(freqs_flat, thres_flat, srate,
                                 jnp.asarray(factor, freqs_flat.dtype), inv),
                  pad)


@functools.partial(jax.jit, static_argnames=("srate",))
def _p1_decode_jit(freqs_flat: jax.Array, thres_flat: jax.Array, srate: int,
                   factor: jax.Array, inv) -> jax.Array:
    n = freqs_flat.shape[1]
    masked = jnp.swapaxes(freqs_flat, 1, 2)                    # [B, C, N]
    thres_c = jnp.swapaxes(thres_flat, 1, 2)                   # [B, C, 27]

    masked = psycho.dequant_jnp(masked) / factor
    e_half = jnp.asarray(np.e / 2.0, dtype=freqs_flat.dtype)
    thres = jnp.power(e_half, psycho.quant_jnp(thres_c))
    div = psycho.mapping_from_opus_jnp(thres, n, srate)
    freqs = masked * div

    from ..ops import policy
    pcm = _idct2_impl(freqs, _use_matmul(n, freqs.dtype), inv,
                      precision=policy.lossy_matmul_precision())
    return jnp.swapaxes(pcm, 1, 2)


# ---------------------------------------------------------------------------
# Profile 2 cores: profile 1's chain + Temporal Noise Shaping
# ---------------------------------------------------------------------------
def p2_encode_core(frames, srate: int, loss_level, factor):
    """[B, N, C] PCM -> (freqs_q [B,N,C], thres_q [B,27,C], lpc_q [B,13,C]).

    Reference profile2.py:21-51 chain with the TNS analysis between
    masking and quantisation (ops/tns_jax.py, fully batched)."""
    frames, pad = place_rows(frames)
    fwd, _ = _mats_like(frames.shape[1], frames.dtype, frames)
    fq, tq, lq = _p2_encode_jit(frames, srate,
                                jnp.asarray(loss_level, frames.dtype),
                                jnp.asarray(factor, frames.dtype), fwd)
    return _unpad(fq, pad), _unpad(tq, pad), _unpad(lq, pad)


@functools.partial(jax.jit, static_argnames=("srate",))
def _p2_encode_jit(frames: jax.Array, srate: int, loss_level: jax.Array,
                   factor: jax.Array, fwd):
    from ..ops import policy, tns_jax

    n = frames.shape[1]
    x = jnp.swapaxes(frames, 1, 2)                             # [B, C, N]
    freqs = _dct2_impl(x, _use_matmul(n, x.dtype), fwd,
                       precision=policy.lossy_matmul_precision())

    thres = psycho.mask_thres_mos_jnp(jnp.abs(freqs) * factor, srate, loss_level)
    div = psycho.mapping_from_opus_jnp(thres, n, srate)
    div = jnp.where(div == 0.0, jnp.inf, div)
    masked, lpc_q = tns_jax.tns_analysis(freqs / div)

    idt = (jnp.int64 if (frames.dtype == jnp.float64
                         and jax.config.read("jax_enable_x64")) else jnp.int32)
    freqs_q = jnp.rint(psycho.quant_jnp(masked * factor)).astype(idt)
    log_base = jnp.log(jnp.asarray(np.e / 2.0, dtype=frames.dtype))
    thres_q = jnp.rint(
        psycho.dequant_jnp(jnp.log(jnp.clip(thres, min=1.0)) / log_base)
    ).astype(idt)

    return (jnp.swapaxes(freqs_q, 1, 2), jnp.swapaxes(thres_q, 1, 2),
            jnp.swapaxes(lpc_q.astype(idt), 1, 2))


def p2_decode_core(freqs_flat, thres_flat, lpc_flat, srate: int,
                   factor) -> jax.Array:
    """Inverse of `p2_encode_core` (reference profile2.py:58-91)."""
    freqs_flat, pad = place_rows(freqs_flat)
    if pad:  # keep aux streams aligned with the padded batch
        z = lambda a: np.concatenate(
            [np.asarray(a), np.zeros((pad,) + np.asarray(a).shape[1:],
                                     np.asarray(a).dtype)])
        thres_flat, lpc_flat = z(thres_flat), z(lpc_flat)
    thres_flat, _ = place_rows(thres_flat)
    lpc_flat, _ = place_rows(lpc_flat)
    # int16 symbol uploads compute in f32 (the in-graph cast is exact)
    cdt = jnp.float32 if freqs_flat.dtype == jnp.int16 else freqs_flat.dtype
    _, inv = _mats_like(freqs_flat.shape[1], cdt, freqs_flat)
    return _unpad(_p2_decode_jit(freqs_flat, thres_flat, lpc_flat, srate,
                                 jnp.asarray(factor, cdt), inv),
                  pad)


@functools.partial(jax.jit, static_argnames=("srate",))
def _p2_decode_jit(freqs_flat: jax.Array, thres_flat: jax.Array,
                   lpc_flat: jax.Array, srate: int, factor: jax.Array,
                   inv) -> jax.Array:
    from ..ops import tns_jax

    if freqs_flat.dtype == jnp.int16:
        # i16 symbol upload: exact cast back to f32 (see p1_decode_oa_core)
        freqs_flat = freqs_flat.astype(jnp.float32)
    n = freqs_flat.shape[1]
    masked = jnp.swapaxes(freqs_flat, 1, 2)
    thres_c = jnp.swapaxes(thres_flat, 1, 2)
    lpc_c = jnp.swapaxes(lpc_flat, 1, 2)

    masked = psycho.dequant_jnp(masked) / factor
    e_half = jnp.asarray(np.e / 2.0, dtype=freqs_flat.dtype)
    thres = jnp.power(e_half, psycho.quant_jnp(thres_c))
    div = psycho.mapping_from_opus_jnp(thres, n, srate)
    freqs = tns_jax.tns_synthesis(masked, lpc_c) * div

    from ..ops import policy
    pcm = _idct2_impl(freqs, _use_matmul(n, freqs.dtype), inv,
                      precision=policy.lossy_matmul_precision())
    return jnp.swapaxes(pcm, 1, 2)


def p1_decode_core_i16(freqs_flat, thres_flat, srate: int, factor) -> jax.Array:
    """`p1_decode_core` emitting clamped s16 PCM (x * 32768) — halves the
    device->host transfer for the lossy profiles, whose SNR (< 40 dB) is
    far below the s16 noise floor."""
    pcm = p1_decode_core(freqs_flat, thres_flat, srate, factor)
    return jnp.clip(jnp.rint(pcm * 32768.0), -32768, 32767).astype(jnp.int16)


def p1_decode_oa_core(freqs_flat, thres_flat, srate: int, factor,
                      olap: int, cut: int, i16: bool):
    """Fused profile-1 decode + overlap-add: one kernel, one d2h.

    Returns (pcm_out [B, cut, C] — s16-scaled int16 when `i16` else the
    compute dtype —, fragment [olap, C] raw tail of the last frame). The
    fragment seeds the streaming tail decoder exactly like the
    per-frame path.
    """
    nreal = np.asarray(freqs_flat).shape[0] \
        if not isinstance(freqs_flat, jax.Array) else freqs_flat.shape[0]
    freqs_flat, pad = place_rows(freqs_flat)
    if pad:
        thres_flat = np.concatenate(
            [np.asarray(thres_flat),
             np.zeros((pad,) + np.asarray(thres_flat).shape[1:],
                      np.asarray(thres_flat).dtype)])
    thres_flat, _ = place_rows(thres_flat)
    # int16 symbol uploads compute in f32 (the in-graph cast is exact)
    cdt = jnp.float32 if freqs_flat.dtype == jnp.int16 else freqs_flat.dtype
    _, inv = _mats_like(freqs_flat.shape[1], cdt, freqs_flat)
    out, frag = _p1_decode_oa_jit(freqs_flat, jnp.asarray(thres_flat), srate,
                                  jnp.asarray(factor, cdt), olap,
                                  cut, i16, inv, last=nreal - 1)
    return _unpad(out, pad), frag


@functools.partial(jax.jit, static_argnames=("srate", "olap", "cut", "i16",
                                              "last"))
def _p1_decode_oa_jit(freqs_flat: jax.Array, thres_flat: jax.Array,
                      srate: int, factor: jax.Array, olap: int, cut: int,
                      i16: bool, inv, last: int | None = None):
    if freqs_flat.dtype == jnp.int16:
        # i16 symbol upload (see p1_decode_oa_core): the EGR symbols are
        # small integers, exact in int16 — casting back to f32 reproduces
        # the f32 upload bit-for-bit at half the h2d bytes
        freqs_flat = freqs_flat.astype(jnp.float32)
    pcm = _p1_decode_jit.__wrapped__(freqs_flat, thres_flat, srate, factor, inv)
    last = pcm.shape[0] - 1 if last is None else last
    frag = pcm[last, cut:cut + olap, :] if olap else pcm[last, :0, :]
    out = overlap_add_core.__wrapped__(pcm, olap, cut)
    if i16:
        out = jnp.clip(jnp.rint(out * 32768.0), -32768, 32767).astype(jnp.int16)
    return out, frag


# ---------------------------------------------------------------------------
# Batched overlap windows (encode gather / decode crossfade), static shapes
# ---------------------------------------------------------------------------
def overlap_frame_starts(total: int, fsize: int, overlap_ratio: int) -> tuple[np.ndarray, int]:
    """Frame start offsets and overlap length for a uniformly-framed stream.

    Mirrors the streaming engine's fragment carry (encoder.py:35-51): each
    frame after the first re-reads the trailing `fsize - fsize*(r-1)//r`
    samples of its predecessor.
    """
    if overlap_ratio > 1:
        olap = fsize - fsize * (overlap_ratio - 1) // overlap_ratio
    else:
        olap = 0
    hop = fsize - olap
    if total <= fsize:
        return np.array([0], dtype=np.int64), olap
    n_extra = -(-(total - fsize) // hop)
    starts = np.concatenate([[0], fsize - olap + hop * np.arange(n_extra)])
    return starts.astype(np.int64), olap


@functools.partial(jax.jit, static_argnames=("fsize",), donate_argnums=())
def gather_frames(samples: jax.Array, starts: jax.Array, fsize: int) -> jax.Array:
    """[T, C] samples -> [B, fsize, C] overlapped frames via one gather.

    `samples` must be zero-padded so every start+fsize is in range.
    """
    idx = starts[:, None] + jnp.arange(fsize)[None, :]
    return samples[idx]


@functools.partial(jax.jit, static_argnames=("olap", "cut"))
def overlap_add_core(frames: jax.Array, olap: int, cut: int) -> jax.Array:
    """Batched decoder crossfade for uniform frames.

    frames: [B, N, C] decoded PCM. Each frame's first `olap` samples are
    crossfaded with the previous frame's tail (its samples [cut:cut+olap]),
    and each frame contributes its first `cut` samples to the output
    (reference decoder.py:28-46 per-sample loop, vectorised over the whole
    batch). Returns [B, cut, C]; the stream tail beyond the last cut is
    frames[-1, cut:, :] (emitted by the caller at flush).
    """
    if olap == 0:
        return frames[:, :cut, :]
    w = 0.5 * (1.0 - jnp.cos(jnp.pi * jnp.arange(1, olap + 1, dtype=frames.dtype) / (olap + 1)))
    heads = frames[:, :olap, :]
    tails = jnp.concatenate([jnp.zeros_like(frames[:1, cut:cut + olap, :]),
                             frames[:-1, cut:cut + olap, :]], axis=0)
    first_mask = jnp.concatenate([jnp.zeros((1,), dtype=frames.dtype),
                                  jnp.ones((frames.shape[0] - 1,), dtype=frames.dtype)])
    blend = heads * jnp.where(first_mask[:, None, None] > 0, w[None, :, None], 1.0) \
        + tails * w[None, ::-1, None] * first_mask[:, None, None]
    return jnp.concatenate([blend, frames[:, olap:cut, :]], axis=1)
