"""Whole-file batch codec pipeline.

The streaming engines (encoder.py/decoder.py) process one frame per call;
this module is the batched fast path: it plans every frame of a stream
up front, runs the tensor domain as batched jitted core calls
([B, N, C] through models/batch.py), and finishes the byte domain
(EGR/DEFLATE/RS/ASFH) on the host — threaded, since the native codecs
and zlib release the GIL.

Transfer design: big batches are split into row chunks that are
uploaded, computed, and downloaded concurrently, so a chunk's h2d, the
previous chunk's compute and an earlier chunk's d2h can overlap. Whether
this chunking pays on a PCIe-attached GPU is not measured yet.

Output is byte-exact with the streaming Encoder fed by process()+flush()
at the default compute dtype (tested in tests/test_parallel.py): same
frame boundaries, same overlap fragments, same force-flush terminators.
"""

from __future__ import annotations

import functools
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from ..common import FRM_SIGN
from ..container import ecc as ecc_mod
from ..container.asfh import ASFH, COMPLETE, FORCE_FLUSH
from ..decoder import Decoder
from ..models import COMPACT, batch, profile0, profile1, profile2
from ..models.profiles import compact
from ..ops import bitpack, golomb, packing, policy
from ..ops.window import hanning_in_overlap
from ..utils.tracing import StageTimer

DEFAULT_ECC_RATIO = (96, 24)

#: when set, pipeline stages accumulate wall-clock here (bench.py wires a
#: timer in and prints the per-stage breakdown to stderr)
STAGES: StageTimer | None = None


def _stage(name: str):
    if STAGES is None:
        import contextlib

        return contextlib.nullcontext()
    return STAGES.stage(name)


def _meter(direction: str, nbytes: int) -> None:
    """Record `nbytes` of host<->device traffic ('h2d' | 'd2h') so bench
    runs can report bytes moved per stage."""
    if STAGES is not None:
        STAGES.add_bytes(direction, nbytes)


@functools.lru_cache(maxsize=1)
def _pool() -> ThreadPoolExecutor:
    """Shared host-work pool (native EGR/RS and zlib release the GIL, and
    chunked device transfers run concurrently on it)."""
    return ThreadPoolExecutor(max_workers=8, thread_name_prefix="frad-host")


@functools.lru_cache(maxsize=32)
def _egr_compact_packer(max_words: int, cap: int):
    """One jitted program: EGR-pack the symbol frames AND compact every
    frame's used words into one flat buffer.

    Padding each row to the batch's max width would make the EGR fetch
    carry ~2.5x the stream's real bytes (the max frame sets the width,
    the mean frame is far narrower). Scattering row i's
    ceil(nbits/32) words to its cumsum offset ships exactly the stream
    bytes plus bucketed slack. No offset table crosses the link — the
    host re-derives the same cumsum from the meta. `cap` comes from the
    previous batch's observed total (bucketed); undershoots are healed
    by one padded-matrix refetch. Returns (meta [B, 3+tqcols] u32,
    flat [cap] u32, words [B, max_words] u32 — kept on device for the
    refetch path).
    """
    import jax
    import jax.numpy as jnp

    def pack(fq2d, tq):
        words, nbits, ks, ovf = bitpack.egr_pack_frames(fq2d, max_words)
        b = nbits.shape[0]
        meta = jnp.concatenate(
            [nbits[:, None].astype(jnp.int32), ks[:, None].astype(jnp.int32),
             ovf[:, None].astype(jnp.int32),
             tq.reshape(b, -1).astype(jnp.int32)], axis=1)
        used = jnp.where(ovf, 0, (nbits + 31) // 32).astype(jnp.int32)
        offs = jnp.cumsum(used) - used
        j = jnp.arange(max_words, dtype=jnp.int32)
        idx = jnp.where(j[None, :] < used[:, None],
                        offs[:, None] + j[None, :], cap)
        flat = jnp.zeros(cap, words.dtype).at[idx.ravel()].set(
            words.ravel(), mode="drop")
        return jax.lax.bitcast_convert_type(meta, jnp.uint32), flat, words

    return jax.jit(pack)


@functools.lru_cache(maxsize=32)
def _p1_enc_egr_fused(srate: int, b: int, max_words: int, cap: int, nsl: int):
    """ONE jitted program for the whole P1 encode tensor domain:
    i16 PCM -> DCT/mask/quant core -> EGR bit-pack -> word compaction ->
    pre-split d2h slices.

    The unfused path (core jit, packer jit, splitter jit) pays three
    dispatches per batch before the first d2h byte moves. Fusing them
    means the meta and every flat slice are queued for copy right behind
    a single dispatch. Returns (meta u32 [b, 3+tqcols], slice tuple, words
    [b, max_words] — kept on device for the undershoot refetch — and fq
    for the rare per-row overflow fallback)."""
    import jax
    import jax.numpy as jnp

    from ..models import batch as _batch

    def run(frames_i16, loss_level, factor, fwd):
        fq, tq = _batch._p1_encode_i16_jit.__wrapped__(
            frames_i16, srate, loss_level, factor, fwd)
        fq = fq[:b]          # drop place_rows' shard-padding rows
        tq = tq[:b]
        m = fq.shape[1] * fq.shape[2]
        words, nbits, ks, ovf = bitpack.egr_pack_frames(
            fq.reshape(b, m), max_words)
        meta = jnp.concatenate(
            [nbits[:, None].astype(jnp.int32), ks[:, None].astype(jnp.int32),
             ovf[:, None].astype(jnp.int32),
             tq.reshape(b, -1).astype(jnp.int32)], axis=1)
        used = jnp.where(ovf, 0, (nbits + 31) // 32).astype(jnp.int32)
        offs = jnp.cumsum(used) - used
        j = jnp.arange(max_words, dtype=jnp.int32)
        idx = jnp.where(j[None, :] < used[:, None],
                        offs[:, None] + j[None, :], cap)
        flat = jnp.zeros(cap, words.dtype).at[idx.ravel()].set(
            words.ravel(), mode="drop")
        bounds = [cap * i // nsl for i in range(nsl + 1)]
        slices = tuple(flat[bounds[i]:bounds[i + 1]] for i in range(nsl))
        return jax.lax.bitcast_convert_type(meta, jnp.uint32), slices, words, fq

    return jax.jit(run)


#: (symbols, tq_cols, max_words) -> flat word capacity to allocate next
#: time — the EGR stage's capacity predictor (see _egr_compact_packer)
_WFETCH: dict[tuple[int, int, int], int] = {}

_WBUCKET = 64   # 256-byte granularity bounds the compiled shape count


def _bucket_words(w: int, max_words: int) -> int:
    return min(max_words, -(-max(w, 1) // _WBUCKET) * _WBUCKET)


@functools.lru_cache(maxsize=8)
def _splitter(parts: int):
    """One jitted program emitting `parts` slices (single compile per
    input shape; separate output buffers enable concurrent d2h)."""
    import jax

    def split(a):
        b = a.shape[0]
        bounds = [b * i // parts for i in range(parts + 1)]
        return tuple(a[bounds[i]:bounds[i + 1]] for i in range(parts))

    return jax.jit(split)


def _put_concurrent(arr: np.ndarray, target: int = 2 << 20):
    """Host->device upload split into concurrent row chunks, restacked on
    device (one cheap on-device concat)."""
    import jax
    import jax.numpy as jnp

    _meter("h2d", arr.nbytes)
    spans = _spans(arr.shape[0], arr.nbytes, target=target)
    if len(spans) < 2:
        return jax.device_put(arr)
    chunks = list(_pool().map(lambda s: jax.device_put(arr[s[0]:s[1]]), spans))
    return jnp.concatenate(chunks)


def _fetch(arr, parts: int = 8) -> np.ndarray:
    """Device->host fetch with `parts` concurrent slice transfers (the
    split is one jitted program so each batch shape compiles exactly
    once)."""
    _meter("d2h", arr.nbytes)
    if arr.shape[0] < parts * 2:
        return np.asarray(arr)
    chunks = _splitter(parts)(arr)
    for c in chunks:
        c.copy_to_host_async()
    return np.concatenate([np.asarray(c) for c in chunks])


#: chunked-pipeline geometry (module-level so tools/ab_geometry.py can
#: A/B alternate settings inside one process)
SPAN_TARGET = 2 << 20
SPAN_MAX_PARTS = 8


def _spans(rows: int, nbytes: int, target: int | None = None,
           max_parts: int | None = None) -> list[tuple[int, int]]:
    """Row spans for the chunked transfer pipeline: ~`target`-byte chunks,
    at most `max_parts` (more chunks => more per-dispatch latency)."""
    target = SPAN_TARGET if target is None else target
    max_parts = SPAN_MAX_PARTS if max_parts is None else max_parts
    parts = max(1, min(max_parts, nbytes // target, rows))
    bounds = [rows * i // parts for i in range(parts + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(parts)]


def _deep_transform_batch(arr: np.ndarray, inverse: bool,
                          stage_prefix: str) -> np.ndarray:
    """Archival f64 (I)DCT over a [B, n, ch] batch on the host CPU
    backend (policy.deep_device) — the same program the per-frame
    engines run (models/profile0._route), so batch and stream agree."""
    core = batch.p0_decode_core if inverse else batch.p0_encode_core
    with _stage(f"{stage_prefix}:core"), policy.deep_device():
        return np.asarray(core(arr.astype(np.float64)), dtype=np.float64)


def plan_frames(total: int, fsize: int, overlap_ratio: int, is_compact: bool
                ) -> tuple[list[tuple[int, int]], int]:
    """Replicates the streaming engine's read plan (encoder.py:72-90).

    Returns ([(start, length), ...], n_terminators). Frame i covers
    samples [start, start+length); overlapping regions are re-read,
    mirroring the fragment carry. n_terminators is how many force-flush
    headers a process()+flush() sequence would emit (compact only).
    """
    n = compact.get_samples_min_ge(fsize) if is_compact else fsize
    olap_active = is_compact and overlap_ratio > 1

    frames: list[tuple[int, int]] = []
    pos = 0
    frag = 0
    while True:
        new = n - frag
        if pos + new > total:
            break
        frames.append((pos - frag, n))
        frag = (n - n * (overlap_ratio - 1) // overlap_ratio) if olap_active else 0
        pos += new

    remaining = total - pos
    has_tail = remaining > 0 or frag > 0
    if has_tail:
        frames.append((pos - frag, frag + remaining))

    if not is_compact:
        terms = 0
    else:
        terms = 2 if has_tail else 1
    return frames, terms


class _BlobParts:
    """A batch of equal-length payloads kept as ONE joined blob.

    The lossless host pack emits all frames of a single-depth batch as one
    contiguous byte string; keeping it joined lets the native framer slice
    by offset instead of materialising B Python bytes objects (the
    no-transform profile-4 config spends visible wall on those copies)."""

    __slots__ = ("blob", "per", "bdi", "flen", "n")

    def __init__(self, blob: bytes, per: int, bdi: int, flen: int, n: int):
        self.blob, self.per, self.bdi, self.flen, self.n = blob, per, bdi, flen, n

    def as_parts(self) -> list[tuple[bytes, int, int]]:
        return [(self.blob[i * self.per:(i + 1) * self.per], self.bdi, self.flen)
                for i in range(self.n)]


def _asfh_for(profile: int, bit_depth_index: int, channels: int, srate: int,
              fsize: int, *, ecc: bool, ecc_ratio: tuple[int, int],
              little_endian: bool, overlap_ratio: int) -> ASFH:
    a = ASFH()
    a.profile = profile
    a.bit_depth_index = bit_depth_index
    a.channels = channels
    a.srate = srate
    a.fsize = fsize
    a.ecc = ecc
    a.ecc_dsize, a.ecc_codesize = ecc_ratio if ecc else (0, 0)
    a.endian = little_endian
    a.overlap_ratio = overlap_ratio
    return a


def batch_encode(pcm: np.ndarray, profile: int, srate: int, bit_depth: int,
                 frame_size: int, *, loss_level: float = 0.5,
                 enable_ecc: bool = False,
                 ecc_ratio: tuple[int, int] = DEFAULT_ECC_RATIO,
                 little_endian: bool = False, overlap_ratio: int = 16,
                 workers: int = 4, compute_dtype: str | None = None,
                 i24_upload: bool = False, i16_upload: bool = False,
                 final: bool = True) -> bytes:
    """Encode a whole [T, C] f64 PCM array into a FrAD byte stream.

    `final=False` encodes a NON-TERMINAL span of a larger stream (the
    multi-host path: each host encodes its frame-aligned span, the next
    host re-reads the overlap halo): the trailing partial frame and the
    force-flush terminators are suppressed, so concatenating the spans
    (final=True only on the last) is byte-identical to encoding the whole
    stream on one host. The caller must cut non-final spans on the
    multihost.host_span grid (frame-aligned, halo included).

    Byte-exact with streaming `Encoder(...).process(raw) + flush()` at the
    default compute dtype (f64). `compute_dtype='float32'` runs the
    tensor cores in f32 — the GPU default: the stream stays fully
    format-compatible (quantised ints / truncated floats differ only in
    the last ulp of the transform) at hardware-native speed.

    `i24_upload` / `i16_upload` quantise the h2d PCM transfer to 3 or
    2 bytes/sample (lossless / lossy profiles respectively); the
    quantisation floors (-138 dB / -96 dB) sit far below the stream's own
    noise. Only active with compute_dtype='float32'.
    """
    if compute_dtype is None and policy.compute_dtype() != "float64":
        compute_dtype = policy.compute_dtype()
    pcm = np.asarray(pcm, dtype=np.float64)
    total, channels = pcm.shape
    is_compact = profile in COMPACT
    if is_compact:
        srate = compact.get_valid_srate(srate)
        loss_level = max(abs(loss_level), 0.125)
        overlap_ratio = overlap_ratio if overlap_ratio == 0 else max(2, min(256, overlap_ratio))
    else:
        overlap_ratio = 0

    frames, terms = plan_frames(total, frame_size, overlap_ratio, is_compact)
    if not final:
        # non-terminal span of a larger stream: the next host encodes the
        # continuation, so no tail frame and no force-flush terminators
        n_full = frames[0][1] if frames else 0
        frames = [f for f in frames if f[1] == n_full]
        terms = 0
    if not frames:
        if not final:
            return b""
        a = _asfh_for(profile, 0, max(channels, 1), srate,
                      compact.get_samples_min_ge(frame_size) if is_compact else frame_size,
                      ecc=enable_ecc, ecc_ratio=ecc_ratio,
                      little_endian=little_endian, overlap_ratio=overlap_ratio)
        return a.force_flush() * max(terms, 1) if is_compact else b""

    n = frames[0][1]
    uniform = [f for f in frames if f[1] == n]
    tail = frames[len(uniform):]            # 0 or 1 non-uniform tail frame

    # ---- tensor domain: batched core calls over the uniform frames ----
    olap_active = is_compact and overlap_ratio > 1

    def _gather(frs: list[tuple[int, int]], length: int) -> np.ndarray:
        s0 = frs[0][0]
        if (not olap_active and s0 >= 0
                and frs[-1][0] - s0 == (len(frs) - 1) * length
                and frs[-1][0] + length <= total):
            # contiguous non-overlapping frames: a reshape VIEW of the pcm
            # (the lossless profiles' hot path pays no gather copy)
            return pcm[s0: s0 + len(frs) * length].reshape(
                len(frs), length, channels)
        out = np.zeros((len(frs), length, channels), dtype=np.float64)
        for i, (s, ln) in enumerate(frs):
            sa = max(s, 0)
            out[i, sa - s: ln] = pcm[sa: s + ln]
        return out

    def _encode_frames(frs: list[tuple[int, int]]) -> list[tuple[bytes, int, int]]:
        if not frs:
            return []
        flen = frs[0][1]
        with _stage("enc:gather"):
            arr = _gather(frs, flen)
        if profile == 1:
            arr_p, srate_v, ll = profile1.prepare_frame(arr[0], srate, loss_level)
            dlen = arr_p.shape[0]
            if dlen != flen:
                pad = np.zeros((len(frs), dlen, channels))
                pad[:, :flen] = arr
                arr = pad
            factor = profile1._scale_factor(bit_depth if bit_depth in profile1.DEPTHS else 16)
            bits = bit_depth if bit_depth in profile1.DEPTHS else 16
            bdi = profile1.DEPTHS.index(bits)

            # On-device EGR bit-pack (bits <= 24 keeps symbols < 2^23, the
            # exact-f32 range): ships ~4-12 bits/symbol over the d2h link
            # instead of 32. The used
            # words are COMPACTED on device into one flat buffer, so the
            # fetch carries the stream's real bytes, not rows padded to
            # the batch-max width; meta (nbits/k/overflow/thresholds)
            # rides in a concurrent transfer — no latency-bound sizing
            # round trip.
            device_egr = bits <= 24 and len(frs) > 1
            fused = device_egr and i16_upload and compute_dtype == "float32"
            if device_egr:
                from ..ops import psycho

                b = len(frs)
                m = arr.shape[1] * channels
                max_words = max(m * 12 // 32, 16)
                mcols = 3 + psycho.SUBBANDS * channels
                pkey = (m, mcols, max_words)
                # capacity predictor: total words the batch's streams need
                # (8 bits/symbol first guess; relearned from each batch)
                cap = _WFETCH.get(pkey,
                                  _bucket_words(b * m // 4, b * max_words))
                nsl = 8 if b >= 16 else 1

            def to_i16(a: np.ndarray) -> np.ndarray:
                # 2 B/sample over the h2d link (-96 dB floor, far below
                # the lossy profile's masking noise)
                if native.has("frad_f64_to_i16"):
                    return native.f64_to_i16(a)
                return np.clip(np.rint(a * 32768.0),
                               -32768, 32767).astype(np.int16)

            if fused:
                # i16 fast path: PCM -> core -> EGR pack -> compaction ->
                # pre-split slices, ALL as one jitted program — one
                # dispatch where the unfused path pays three, and every
                # d2h byte is queued right behind it
                import jax.numpy as jnp

                with _stage("enc:core"):
                    arr_t = to_i16(arr)
                    if batch.data_sharding(b) is None:
                        placed = _put_concurrent(arr_t)
                    else:
                        placed = batch.place_rows(arr_t)[0]
                    fwd, _ = batch._mats_like(placed.shape[1], jnp.float32,
                                              placed)
                with _stage("enc:egr-pack"):
                    meta_d, slices, words_d, fq = _p1_enc_egr_fused(
                        srate_v, b, max_words, cap, nsl)(
                            placed, jnp.asarray(ll, jnp.float32),
                            jnp.asarray(factor, jnp.float32), fwd)
                    meta_d.copy_to_host_async()
                    for c in slices:
                        c.copy_to_host_async()
                _meter("d2h", meta_d.nbytes + cap * 4)
            else:
                with _stage("enc:core"):
                    if i16_upload and compute_dtype == "float32":
                        fq, tq = batch.p1_encode_core_i16(
                            _put_concurrent(to_i16(arr)), srate_v, ll, factor)
                    else:
                        if compute_dtype:
                            arr = arr.astype(compute_dtype)
                        _meter("h2d", arr.nbytes)
                        fq, tq = batch.p1_encode_core(arr, srate_v, ll, factor)
                if device_egr:
                    with _stage("enc:egr-pack"):
                        meta_d, flat_d, words_d = _egr_compact_packer(
                            max_words, cap)(fq.reshape(b, m), tq)
                        meta_d.copy_to_host_async()
                        slices = _splitter(nsl)(flat_d) if nsl > 1 else (flat_d,)
                        for c in slices:
                            c.copy_to_host_async()
                    _meter("d2h", meta_d.nbytes + flat_d.nbytes)

            if device_egr:

                with _stage("enc:d2h"):
                    meta = np.asarray(meta_d).view(np.int32)
                nbits = meta[:, 0].astype(np.int64)
                ks = meta[:, 1].astype(np.int64)
                ovf = meta[:, 2].astype(bool)
                tqh = meta[:, 3:].astype(np.int64)
                used = np.where(ovf, 0, (nbits + 31) // 32)
                ends = np.cumsum(used)
                total = int(ends[-1]) if b else 0
                # (rare) frames whose stream overflowed max_words
                fq_fallback = {int(i): np.asarray(fq[int(i)])
                               for i in np.flatnonzero(ovf)}
                use_native = native.has("frad_p1_pack_batch")
                results: list[tuple[bytes, int, int]] = []
                futures: list = []

                def pack_one(wrow, fq_fb, nb, k, trow, flen):
                    if fq_fb is not None:
                        freqs_gol = golomb.encode(
                            fq_fb.ravel().astype(np.int64))
                    else:
                        freqs_gol = bitpack.words_to_stream(wrow, nb, k)
                    thres_gol = golomb.encode(trow)
                    frad = (struct.pack(">I", len(thres_gol))
                            + thres_gol + freqs_gol)
                    return (zlib.compress(frad, wbits=-15), bdi, flen)

                def emit(lo: int, hi: int, words_mat: np.ndarray) -> None:
                    if use_native:
                        # one C++ pass per segment: EGR thresholds +
                        # word serialisation + raw deflate, threaded
                        pls = native.p1_pack_batch(
                            np.ascontiguousarray(words_mat),
                            nbits[lo:hi], ks[lo:hi], ovf[lo:hi], tqh[lo:hi])
                        for j, pl in enumerate(pls):
                            if pl is None:  # overflow -> host fallback
                                pl = profile1.pack_streams(
                                    fq_fallback[lo + j].ravel(),
                                    tqh[lo + j].ravel())
                            results.append((pl, bdi, frs[lo + j][1]))
                    else:
                        for j in range(hi - lo):
                            futures.append(_pool().submit(
                                pack_one, words_mat[j],
                                fq_fallback.get(lo + j), nbits[lo + j],
                                ks[lo + j], tqh[lo + j], frs[lo + j][1]))

                if total > cap:
                    # capacity undershoot (healed below by the relearn):
                    # one padded-matrix fetch serves the whole batch
                    with _stage("enc:d2h"):
                        _meter("d2h", words_d.nbytes)
                        emit(0, b, np.asarray(words_d))
                else:
                    # rows become packable as their flat span arrives;
                    # host byte work for segment k overlaps slice k+1's
                    # d2h (zeros past the arrived prefix are never read:
                    # the packer stops at each row's nbits)
                    flat_buf = np.zeros(cap + max_words + 1, dtype=np.uint32)
                    offs = ends - used
                    pos = 0
                    row = 0
                    for k, c in enumerate(slices):
                        with _stage("enc:d2h"):
                            a = np.asarray(c)
                        flat_buf[pos: pos + a.shape[0]] = a
                        pos += a.shape[0]
                        hi = b if k == nsl - 1 else int(
                            np.searchsorted(ends, pos, side="right"))
                        if hi > row:
                            with _stage("enc:pack"):
                                w_seg = max(int(used[row:hi].max()), 1)
                                idx = (offs[row:hi, None]
                                       + np.arange(w_seg)[None, :])
                                emit(row, hi, flat_buf[idx])
                            row = hi
                if futures:
                    with _stage("enc:pack"):
                        results = [f.result() for f in futures]
                # predict the next batch's capacity: observed total plus
                # 1/8 headroom, bucketed. Hysteresis: grow immediately
                # (an undershoot costs a padded refetch) but only shrink
                # once the slack exceeds 2x — each distinct cap is a
                # separate XLA compile of the packer, and content-driven
                # flutter would otherwise recompile mid-stream for a few
                # hundred KB of fetch slack.
                need = _bucket_words(total * 9 // 8, b * max_words)
                if need > cap or need * 2 < cap:
                    _WFETCH[pkey] = need
                return results

            fq = np.asarray(fq)
            tq = np.asarray(tq)

            def pack_one(i: int) -> tuple[bytes, int, int]:
                return (profile1.pack_streams(fq[i].ravel(), tq[i].ravel()),
                        bdi, frs[i][1])

            return list(_pool().map(pack_one, range(len(frs))))

        if profile == 2:
            arr_p, srate_v, ll = profile2.prepare_frame(arr[0], srate, loss_level)
            dlen = arr_p.shape[0]
            if dlen != flen:
                pad = np.zeros((len(frs), dlen, channels))
                pad[:, :flen] = arr
                arr = pad
            bits = bit_depth if bit_depth in profile2.DEPTHS else 16
            factor = profile2._scale_factor(bits)
            if compute_dtype:
                arr = arr.astype(compute_dtype)
            fq, tq, lq = batch.p2_encode_core(arr, srate_v, ll, factor)
            fqh = np.asarray(fq)
            tqh = np.asarray(tq)
            lqh = np.asarray(lq)
            bdi = profile2.DEPTHS.index(bits)

            def pack_one(i: int) -> tuple[bytes, int, int]:
                return (profile2.pack_streams(fqh[i].ravel(), tqh[i].ravel(),
                                              lqh[i].ravel()),
                        bdi, frs[i][1])

            return list(_pool().map(pack_one, range(len(frs))))

        # lossless profiles
        if profile == 0:
            base_bits = bit_depth if bit_depth in packing.DEPTHS else 16
            if (compute_dtype == "float32"
                    and base_bits in bitpack.TRUNC_DEVICE_BITS
                    and (flen * channels) % 4 == 0):
                # fast path: DCT + truncated-float packing fused on device;
                # transfers carry payload-density bytes in BOTH directions
                # and the row-chunk pipeline overlaps h2d/compute/d2h.
                # Escalated frames (coefficient beyond the container
                # float's range) force the generic path.
                import jax

                use_i24 = i24_upload and base_bits == 24
                spans = _spans(len(frs), arr.nbytes // (3 if use_i24 else 2))

                def upload(s0: int, s1: int):
                    blk = arr[s0:s1]
                    if use_i24:
                        w = bitpack.pcm_to_i24_words_host(blk).reshape(s1 - s0, -1)
                        _meter("h2d", w.nbytes)
                        return jax.device_put(w)
                    blk = blk.astype(np.float32)
                    _meter("h2d", blk.nbytes)
                    return jax.device_put(blk)

                ups = [_pool().submit(upload, s0, s1) for s0, s1 in spans]
                outs = []
                for f in ups:
                    with _stage("enc:h2d"):
                        d = f.result()
                    with _stage("enc:core"):
                        if use_i24:
                            wd, md = batch.p0_encode_pack_core_i24(
                                d, base_bits, little_endian, flen, channels)
                        else:
                            wd, md = batch.p0_encode_pack_core(
                                d, base_bits, little_endian)
                        wd.copy_to_host_async()
                        md.copy_to_host_async()
                        outs.append((wd, md))
                with _stage("enc:d2h"):
                    maxabs = np.concatenate([np.asarray(md) for _, md in outs])
                    _meter("d2h", maxabs.nbytes)
                limit = packing.FLOAT_MAX[packing.DEPTHS.index(base_bits)]
                if np.all(maxabs <= limit):
                    with _stage("enc:d2h"):
                        _meter("d2h", sum(wd.nbytes for wd, _ in outs))
                        fetches = [_pool().submit(np.asarray, wd)
                                   for wd, _ in outs]
                        words = np.concatenate([f.result() for f in fetches])
                    bdi = packing.DEPTHS.index(base_bits)
                    # one joined blob instead of B per-frame tobytes()
                    # copies — the native framer slices by offset
                    return _BlobParts(words.tobytes(),
                                      words.shape[1] * words.itemsize,
                                      bdi, frs[0][1], len(frs))
            with _stage("enc:core"):
                if base_bits >= policy.DEEP_BITS:
                    # deep containers (48/64-bit) exceed f32 precision:
                    # archival-exact f64 transform on the host; the
                    # 6-byte truncation happens in the host pack below
                    coeffs = _deep_transform_batch(arr, inverse=False,
                                                   stage_prefix="enc")
                else:
                    _meter("h2d", arr.nbytes // (2 if compute_dtype == "float32" else 1))
                    coeffs = _fetch(batch.p0_encode_core(
                        arr.astype(compute_dtype) if compute_dtype else arr))
        else:  # profile 4
            coeffs = arr
        base_bits = bit_depth if bit_depth in packing.DEPTHS else 16
        fused_blob: bytes | None = None
        with _stage("enc:maxabs"):
            if coeffs.size:
                flat = coeffs.reshape(len(frs), -1)
                if (coeffs.dtype == np.float64 and base_bits != 12
                        and native.has("frad_pack_floats_maxabs")):
                    # one fused pass: pack at the target depth AND record
                    # each row's max (the escalation probe). The blob is
                    # used as-is below unless a row escalated (rare).
                    fused_blob, maxabs = native.pack_floats_maxabs(
                        flat, base_bits, little_endian)
                elif coeffs.dtype == np.float64 and native.has("frad_maxabs_rows"):
                    maxabs = native.maxabs_rows(flat)
                else:
                    # max(|x|) as max/-min (no |x| temporary: profile 4 is
                    # the no-transform config, every pass shows on the clock)
                    maxabs = np.maximum(flat.max(axis=1), -flat.min(axis=1))
            else:
                maxabs = np.zeros(len(frs))
        if profile == 0 and coeffs.dtype != np.float64 and any(
                profile0._escalates_deep(float(m), base_bits) for m in maxabs):
            # escalation crossed into a deeper-than-f32 container (possibly
            # via f32 overflow -> inf): redo the whole batch at archival
            # precision (rare overflow corner)
            with policy.deep_device():
                coeffs = np.asarray(batch.p0_encode_core(arr), dtype=np.float64)
            maxabs = np.max(np.abs(coeffs.reshape(len(frs), -1)), axis=1)
        depths = [packing.needed_depth(float(m), base_bits) for m in maxabs]
        if fused_blob is not None and all(d == base_bits for d in depths):
            return _BlobParts(fused_blob, len(fused_blob) // len(frs),
                              packing.DEPTHS.index(base_bits), frs[0][1],
                              len(frs))
        results: list[tuple[bytes, int, int] | None] = [None] * len(frs)
        # Group frames by escalated depth and pack each group as ONE numpy
        # pass (byte-aligned depths concatenate losslessly); 12-bit frames
        # carry per-frame nibble padding so they stay per-frame.
        for d in sorted(set(depths)):
            idxs = [i for i, dd in enumerate(depths) if dd == d]
            bdi = packing.DEPTHS.index(d)
            if d == 12:
                for i in idxs:
                    payload = packing.pack_floats(coeffs[i].ravel(), d, little_endian)
                    results[i] = (payload, bdi, frs[i][1])
                continue
            group = coeffs if len(idxs) == len(frs) else coeffs[idxs]
            with _stage("enc:host-pack"):
                blob = packing.pack_floats(group.reshape(-1), d, little_endian)
            per = len(blob) // len(idxs)
            if len(idxs) == len(frs):
                # single-depth batch (the common case): keep the payloads
                # as one joined blob — the native framer slices by offset,
                # skipping B bytes-object copies
                return _BlobParts(blob, per, bdi, frs[0][1], len(frs))
            for j, i in enumerate(idxs):
                results[i] = (blob[j * per:(j + 1) * per], bdi, frs[i][1])
        return results

    groups = [g for g in (_encode_frames(uniform), _encode_frames(tail)) if g]

    # ---- byte domain: ECC + framing (order-preserving) ----
    use_native = (native.has("frad_frame_pack_batch")
                  and not (enable_ecc and ecc_ratio[0] <= 0))
    framed: list[bytes] = []
    with _stage("enc:frame"):
        for g in groups:
            if isinstance(g, _BlobParts) and not use_native:
                g = g.as_parts()
            if not use_native:
                def frame_bytes(part: tuple[bytes, int, int]) -> bytes:
                    payload, bdi, flen = part
                    if enable_ecc:
                        payload = ecc_mod.encode(payload, *ecc_ratio)
                    a = _asfh_for(profile, bdi, channels, srate, flen,
                                  ecc=enable_ecc, ecc_ratio=ecc_ratio,
                                  little_endian=little_endian,
                                  overlap_ratio=overlap_ratio)
                    return a.write(payload)

                framed.extend(_pool().map(frame_bytes, g))
                continue
            # threaded C++ pass: RS armor + ASFH header + CRC per frame,
            # written straight into the output stream buffer
            if isinstance(g, _BlobParts):
                b = g.n
                payloads: object = (
                    g.blob, np.arange(b + 1, dtype=np.int64) * g.per)
                bdis = np.full(b, g.bdi, np.uint8)
                flens = np.full(b, g.flen, np.uint32)
            else:
                b = len(g)
                payloads = [p[0] for p in g]
                bdis = np.fromiter((p[1] for p in g), np.uint8, b)
                flens = np.fromiter((p[2] for p in g), np.uint32, b)
            if is_compact:
                fidx_of = {fl: compact.get_samples_index(int(fl))
                           for fl in set(flens.tolist())}
                fidx = np.fromiter((fidx_of[int(f)] for f in flens),
                                   np.uint8, b)
                sidx = compact.get_srate_index(srate)
            else:
                fidx, sidx = None, 0
            framed.append(native.frame_pack_batch(
                payloads, bdis, flens, fidx,
                profile=profile, is_compact=is_compact, channels=channels,
                srate=srate, srate_idx=sidx, overlap_ratio=overlap_ratio,
                little_endian=little_endian, ecc=enable_ecc,
                ecc_dsize=ecc_ratio[0], ecc_codesize=ecc_ratio[1]))

    if is_compact and terms:
        last = groups[-1]
        last_bdi, last_flen = ((last.bdi, last.flen)
                               if isinstance(last, _BlobParts)
                               else (last[-1][1], last[-1][2]))
        a = _asfh_for(profile, last_bdi, channels, srate, last_flen,
                      ecc=enable_ecc, ecc_ratio=ecc_ratio,
                      little_endian=little_endian, overlap_ratio=overlap_ratio)
        framed.append(a.force_flush() * terms)
    return b"".join(framed)


def _scan_native(stream: bytes):
    """C++ whole-stream ASFH scan -> (headers, payloads, tail_pos,
    starts), or None when the native parser is unavailable.

    ~50 ns/frame vs ~5 us/frame for the per-frame Python parse; the
    vectorised field decode leaves only object fill per frame. Each
    header carries its raw bytes in `.buffer`; starts[i] is the byte
    offset of frame i's FRM_SIGN (callers recover junk spans between
    frames from it). tail_pos is the offset of the unparsed tail, -1
    when none.
    """
    if not native.has("frad_frame_parse_batch"):
        return None
    (cnt, pay_off, pay_len, is_ff, pfb, chans, srates, fsizes, olaps,
     eccds, ecccs, crcs, hdrlens, tail_pos) = \
        native.frame_parse_batch(stream)
    rows = zip(pay_len[:cnt].tolist(),
               (pfb[:cnt] >> 5).tolist(),
               ((pfb[:cnt] >> 4) & 1).astype(bool).tolist(),
               ((pfb[:cnt] >> 3) & 1).astype(bool).tolist(),
               (pfb[:cnt] & 7).tolist(),
               chans[:cnt].tolist(), srates[:cnt].tolist(),
               fsizes[:cnt].tolist(), olaps[:cnt].tolist(),
               eccds[:cnt].tolist(), ecccs[:cnt].tolist(),
               crcs[:cnt].tolist(), hdrlens[:cnt].tolist(),
               is_ff[:cnt].tolist(), pay_off[:cnt].tolist())
    headers: list[ASFH] = []
    payloads: list[bytes | None] = []
    new = ASFH.__new__
    for (fb, prof, ecc, endian, bdi, ch, sr, fs, ol, ed, ec, crc, hl,
         ff, off) in rows:
        a = new(ASFH)
        a.frmbytes = fb
        a.profile = prof
        a.ecc = ecc
        a.endian = endian
        a.bit_depth_index = bdi
        a.channels = ch
        a.srate = sr
        a.fsize = fs
        a.overlap_ratio = ol
        a.ecc_dsize = ed
        a.ecc_codesize = ec
        a.crc = crc
        a.header_bytes = hl
        a.all_set = True
        # raw header bytes: _reframe()'s authoritative serialisation
        a.buffer = stream[off - hl: off]
        payloads.append(None if ff else stream[off: off + fb])
        headers.append(a)
    starts = (pay_off[:cnt] - hdrlens[:cnt]).tolist()
    return headers, payloads, int(tail_pos), starts


def _parse_frames(stream: bytes) -> tuple[list[ASFH], list[bytes | None], bytes]:
    """O(n) frame scan; headers are <= 40 bytes incl. the u64 extension.

    Force-flush terminator frames are recorded as (header, None) pairs so
    the batched decoder can replicate the streaming flush without falling
    back to the per-frame engine. The scan itself runs in C++ when
    available (~100x the per-frame Python parse); both paths return
    identical structures.
    """
    scan = _scan_native(stream)
    if scan is not None:
        headers, payloads, tail_pos, _starts = scan
        return headers, payloads, (b"" if tail_pos < 0 else stream[tail_pos:])

    headers = []
    payloads = []
    pos = 0
    n = len(stream)
    while True:
        idx = stream.find(FRM_SIGN, pos)
        if idx < 0:
            return headers, payloads, b""
        a = ASFH()
        status, _ = a.read(stream[idx: idx + 48])
        if status == FORCE_FLUSH:
            headers.append(a)
            payloads.append(None)
            pos = idx + a.header_bytes
            continue
        if status != COMPLETE or idx + a.header_bytes + a.frmbytes > n:
            return headers, payloads, stream[idx:]
        headers.append(a)
        payloads.append(stream[idx + a.header_bytes: idx + a.header_bytes + a.frmbytes])
        pos = idx + a.header_bytes + a.frmbytes


def _run_key(h: ASFH):
    # ecc_dsize/ecc_codesize are run-splitting too: _decode_run unarmors
    # the whole run with h0's ratio, so a mid-stream re-armor at a new
    # ratio must start a new run (caught by
    # test_parallel.py::test_mixed_ecc_ratio_stream)
    return (h.profile, h.bit_depth_index, h.channels, h.srate, h.fsize,
            h.ecc, h.endian, h.overlap_ratio, h.ecc_dsize, h.ecc_codesize)


def _frag_head(out: np.ndarray, frag: np.ndarray) -> np.ndarray:
    """Crossfade an incoming overlap fragment into the head of a decoded
    run (the streaming decoder's frame-0 crossfade, reference
    decoder.py:33-40, applied after the batched overlap-add which treats
    frame 0's head as fade-free). Returns the blended head; the caller
    emits it followed by out[len(frag):] (no full-array copy)."""
    take = len(frag)
    w = hanning_in_overlap(take, str(out.dtype)) if out.dtype.kind == "f" \
        else hanning_in_overlap(take)
    return out[:take] * w[:, None] + frag * w[::-1, None]


def _decode_run(hs: list[ASFH], ps: list[bytes], *, fix_error: bool,
                compute_dtype: str | None, i16_transfer: bool,
                i24_transfer: bool) -> tuple[np.ndarray, np.ndarray]:
    """Decode one uniform frame run as batched core calls.

    Returns (pcm [S, C] — already overlap-added WITHIN the run, frame 0's
    head left fade-free for the caller's fragment fixup —, trailing
    overlap fragment [olap, C] f64)."""
    import jax

    h0 = hs[0]
    run = len(hs)
    ch = h0.channels
    n = h0.fsize
    prof = h0.profile

    if h0.ecc:
        with _stage("dec:ecc"):
            if (native.has("frad_unarmor_batch") and h0.ecc_dsize > 0
                    and h0.ecc_codesize > 0
                    and h0.ecc_dsize + h0.ecc_codesize <= 255):
                # ratios GF(256) can honor only; hand-crafted headers
                # claiming more fall to the per-frame path, which strips
                # parity best-effort (container/ecc.py)
                # one threaded C++ pass: CRC verify + parity strip (or
                # RS repair on mismatch) for the whole run
                crcs = np.fromiter((h.crc for h in hs), np.uint32, run)
                ps, _ok = native.unarmor_batch(
                    ps, h0.ecc_dsize, h0.ecc_codesize, crcs,
                    prof in COMPACT, fix_error)
            else:
                def de_ecc(i: int) -> bytes:
                    repair = fix_error and not hs[i].payload_crc_matches(ps[i])
                    return ecc_mod.decode(ps[i], hs[i].ecc_dsize,
                                          hs[i].ecc_codesize, repair)
                ps = list(_pool().map(de_ecc, range(run)))

    if prof in COMPACT and h0.overlap_ratio > 1:
        cut = n * (h0.overlap_ratio - 1) // h0.overlap_ratio
    else:
        cut = n
    olap = n - cut

    if prof == 1:
        factor = profile1._scale_factor(profile1.DEPTHS[h0.bit_depth_index])

        with _stage("dec:unpack"):
            if native.has("frad_p1_unpack_batch") and compute_dtype == "float32":
                # one C++ pass: inflate + EGR + untrim straight into the
                # [B, n*ch] f32 upload buffers (no per-frame Python churn)
                fqf, tqf, _, _ok = native.p1_unpack_batch(ps, n * ch, 27 * ch)
                fq = fqf.reshape(run, n, ch)
                tq = tqf.reshape(run, 27, ch)
            else:
                def unpack_one(i: int):
                    s = profile1.unpack_streams(ps[i])
                    if s is None:
                        return (np.zeros(n * ch), np.zeros(27 * ch))
                    fi, ti = s
                    fi = profile1._untrim(fi.astype(np.float64), n, ch)[: n * ch]
                    ti = profile1._untrim(ti.astype(np.float64), 27, ch)[: 27 * ch]
                    return fi, ti

                unpacked = list(_pool().map(unpack_one, range(run)))
                fq = np.stack([u[0].reshape(n, ch) for u in unpacked])
                tq = np.stack([u[1].reshape(27, ch) for u in unpacked])
                if compute_dtype:
                    fq = fq.astype(compute_dtype)
                    tq = tq.astype(compute_dtype)
            if (compute_dtype == "float32" and fq.dtype == np.float32
                    and float(np.abs(fq).max(initial=0.0)) <= 32767.0):
                # EGR symbols are small exact integers: int16 halves the
                # decode h2d transfer; the in-graph cast back to f32 makes
                # the core's output bit-identical to the f32 upload
                fq = fq.astype(np.int16)
        i16 = bool(i16_transfer and compute_dtype == "float32")

        def conv(a: np.ndarray) -> np.ndarray:
            if not i16:
                return a
            if native.has("frad_i16_to_f64"):
                return native.i16_to_f64(a).reshape(a.shape)
            return a.astype(np.float64) / 32768.0

        out_bytes = run * cut * ch * (2 if i16 else fq.dtype.itemsize)
        # ~2 MB spans: the P1 tensors are small next to the P0 payloads,
        # but overlapping their h2d/compute/d2h still hides the shorter
        # leg of the transfer chain behind the longer one
        spans = _spans(run, fq.nbytes + out_bytes) \
            if run >= 32 else [(0, run)]
        if len(spans) > 1:
            # chunked decode: span k+1's h2d upload and span
            # k-1's d2h fetch ride the link while span k computes; chunk
            # boundaries are re-blended on the host with the same
            # crossfade the streaming decoder applies between frames
            # (byte-exact on the f64 path, tested)
            def up(s0: int, s1: int):
                _meter("h2d", fq[s0:s1].nbytes + tq[s0:s1].nbytes)
                return jax.device_put(fq[s0:s1]), jax.device_put(tq[s0:s1])

            ups = [_pool().submit(up, s0, s1) for s0, s1 in spans]
            outs = []
            for f in ups:
                with _stage("dec:h2d"):
                    fq_d, tq_d = f.result()
                with _stage("dec:core"):
                    od, fd = batch.p1_decode_oa_core(
                        fq_d, tq_d, h0.srate, factor, olap, cut, i16)
                    od.copy_to_host_async()
                    fd.copy_to_host_async()
                    outs.append((od, fd))
            def fetch_conv_p1(od, fd):
                # per-chunk: wait the (pre-queued) async copy, then run
                # the GIL-releasing i16->f64 conversion — chunk k converts
                # while chunk k+1's bytes are still on the wire
                return (conv(np.asarray(od)).reshape(-1, ch),
                        np.asarray(fd, dtype=np.float64))

            with _stage("dec:d2h"):
                _meter("d2h", sum(od.nbytes + fd.nbytes for od, fd in outs))
                parts = [f.result() for f in
                         [_pool().submit(fetch_conv_p1, od, fd)
                          for od, fd in outs]]
            with _stage("dec:host-conv"):
                chunks_out: list[np.ndarray] = []
                prev_frag: np.ndarray | None = None
                for out_h, fr in parts:
                    if prev_frag is not None and olap:
                        out_h = np.concatenate(
                            [_frag_head(out_h, prev_frag), out_h[olap:]])
                    chunks_out.append(out_h)
                    prev_frag = fr
            return np.concatenate(chunks_out), prev_frag

        with _stage("dec:core"):
            _meter("h2d", fq.nbytes + tq.nbytes)
            out_d, frag_d = batch.p1_decode_oa_core(fq, tq, h0.srate, factor,
                                                    olap, cut, i16)
        with _stage("dec:d2h"):
            out_h = _fetch(out_d)
            _meter("d2h", frag_d.nbytes)
            frag = np.asarray(frag_d, dtype=np.float64)
        with _stage("dec:host-conv"):
            out_h = conv(out_h)
        return out_h.reshape(-1, ch), frag

    if prof in (0, 4):
        bits = packing.DEPTHS[h0.bit_depth_index]
        sizes = {len(p) for p in ps}
        frames = None
        if (prof == 0 and compute_dtype == "float32"
                and bits in bitpack.TRUNC_DEVICE_BITS
                and sizes == {n * ch * bits // 8}
                and (n * ch) % 4 == 0):
            # fast path: ship the payload bytes to the device as packed
            # words; unpack + IDCT run as one fused kernel. Row chunks
            # overlap the h2d and d2h legs.
            wdt = "<u2" if bits == 16 else "<u4"
            with _stage("dec:unpack"):
                words = np.frombuffer(b"".join(ps), dtype=wdt).reshape(run, -1)
            i24 = bool(i24_transfer and bits == 24)
            spans = _spans(run, words.nbytes)

            def upload(s0: int, s1: int):
                _meter("h2d", words[s0:s1].nbytes)
                return jax.device_put(words[s0:s1])

            ups = [_pool().submit(upload, s0, s1) for s0, s1 in spans]
            outs = []
            for f in ups:
                with _stage("dec:h2d"):
                    wd = f.result()
                with _stage("dec:core"):
                    if i24:
                        od = batch.p0_unpack_decode_i24_core(
                            wd, bits, h0.endian, n, ch)
                    else:
                        od = batch.p0_unpack_decode_core(
                            wd, bits, h0.endian, n, ch)
                    od.copy_to_host_async()
                    outs.append(od)

            def fetch_conv(od) -> np.ndarray:
                h = np.asarray(od)
                if i24:
                    # int24 fixed-point PCM over the link (3 B/sample,
                    # -138 dB transfer noise floor)
                    return bitpack.i24_words_to_pcm(h).reshape(-1, n, ch)
                return h

            with _stage("dec:d2h"):
                _meter("d2h", sum(od.nbytes for od in outs))
                frames = np.concatenate(
                    [f.result() for f in
                     [_pool().submit(fetch_conv, od) for od in outs]])
        else:
            with _stage("dec:unpack"):
                if bits != 12 and len(sizes) == 1:
                    # equal byte-aligned payloads: one vectorised unpack
                    flat = packing.unpack_floats(b"".join(ps), bits, h0.endian)
                    coeffs = flat.reshape(run, -1, ch)[:, :n, :]
                else:
                    def unpack_one(i: int):
                        flat = packing.unpack_floats(ps[i], bits, h0.endian)
                        m = (len(flat) // ch) * ch
                        arr = flat[:m].reshape(-1, ch)
                        if len(arr) < n:
                            arr = np.pad(arr, ((0, n - len(arr)), (0, 0)))
                        return arr[:n]

                    coeffs = np.stack(list(_pool().map(unpack_one, range(run))))
            if prof == 0:
                if bits >= policy.DEEP_BITS:
                    # archival depths decode with the host f64 transform
                    frames = _deep_transform_batch(
                        coeffs, inverse=True, stage_prefix="dec")
                else:
                    if compute_dtype:
                        coeffs = coeffs.astype(compute_dtype)
                    with _stage("dec:core"):
                        _meter("h2d", coeffs.nbytes)
                        frames = _fetch(batch.p0_decode_core(coeffs))
            else:
                frames = coeffs
    elif prof == 2:
        factor = profile2._scale_factor(profile2.DEPTHS[h0.bit_depth_index])
        order1 = 13

        with _stage("dec:unpack"):
            if native.has("frad_p1_unpack_batch") and compute_dtype == "float32":
                fqf, tqf, lqf, _ok = native.p1_unpack_batch(
                    ps, n * ch, 27 * ch, order1 * ch)
                fq = fqf.reshape(run, n, ch)
                tq = tqf.reshape(run, 27, ch)
                lq = lqf.reshape(run, order1, ch)
            else:
                def unpack_one2(i: int):
                    st = profile2.unpack_streams(ps[i])
                    if st is None:
                        return (np.zeros(n * ch), np.zeros(27 * ch), np.zeros(order1 * ch))
                    fi, ti, li = st
                    fi = profile1._untrim(fi.astype(np.float64), n, ch)[: n * ch]
                    ti = profile1._untrim(ti.astype(np.float64), 27, ch)[: 27 * ch]
                    li = profile1._untrim(li.astype(np.float64), order1, ch)[: order1 * ch]
                    return fi, ti, li

                unpacked = list(_pool().map(unpack_one2, range(run)))
                fq = np.stack([u[0].reshape(n, ch) for u in unpacked])
                tq = np.stack([u[1].reshape(27, ch) for u in unpacked])
                lq = np.stack([u[2].reshape(order1, ch) for u in unpacked])
                if compute_dtype:
                    fq = fq.astype(compute_dtype)
                    tq = tq.astype(compute_dtype)
                    lq = lq.astype(compute_dtype)
            if (compute_dtype == "float32" and fq.dtype == np.float32
                    and float(np.abs(fq).max(initial=0.0)) <= 32767.0):
                # same int16 symbol upload as the P1 path (exact cast)
                fq = fq.astype(np.int16)
        with _stage("dec:core"):
            _meter("h2d", fq.nbytes + tq.nbytes + lq.nbytes)
            frames = _fetch(batch.p2_decode_core(fq, tq, lq, h0.srate, factor))
    else:  # pragma: no cover - caller filters profiles
        raise ValueError(f"profile {prof} is not batchable")

    if olap:
        with _stage("dec:overlap"):
            out = np.asarray(batch.overlap_add_core(frames, olap, cut)).reshape(-1, ch)
        frag = np.asarray(frames[-1, cut:, :], dtype=np.float64)
    else:
        out = frames.reshape(-1, ch)
        frag = np.empty((0, 0), dtype=np.float64)
    return out, frag


_BATCHABLE = (0, 1, 2, 4)


def batch_decode(stream: bytes, *, fix_error: bool = False,
                 workers: int = 4, compute_dtype: str | None = None,
                 i16_transfer: bool = False, i24_transfer: bool = False,
                 return_remainder: bool = False):
    """Decode a FrAD byte stream in batched mode.

    EVERY uniform run (same profile/depth/channels/srate/fsize/endian/
    ecc/overlap, full-length frames) is decoded as one batched core call
    with a vectorised overlap-add; the overlap fragment carries across
    run boundaries (mid-stream bit-depth escalations stay batched).
    Only genuinely streaming cases fall back to the per-frame Decoder:
    a fragment longer than the next run's emit window (multi-frame
    crossfade) or a reserved profile. Returns (pcm [T, C], srate); with
    `return_remainder`, returns (pcm, srate, remainder_bytes) where
    `remainder_bytes` is non-empty when the stream changes channel
    layout or sample rate mid-way (the reference's `crit` split) —
    decode it with another call.
    """
    if compute_dtype is None and policy.compute_dtype() != "float64":
        compute_dtype = policy.compute_dtype()
    # ---- host parse: split stream into frames ----
    with _stage("dec:parse"):
        headers, payloads, tail_bytes = _parse_frames(stream)
    if not any(p is not None for p in payloads):
        dec = Decoder(fix_error=fix_error)
        out = dec.process(stream).pcm
        tail = dec.flush().pcm
        parts = [p for p in (out, tail) if p.size]
        pcm_out = np.concatenate(parts) if parts else np.empty((0,))
        if return_remainder:
            return pcm_out, dec.asfh.srate, b""
        return pcm_out, dec.asfh.srate

    out_parts: list[np.ndarray] = []
    first = next(h for h, p in zip(headers, payloads) if p is not None)
    srate = first.srate
    info = (first.channels, first.srate)
    frag = np.empty((0, 0), dtype=np.float64)
    idx = 0
    remainder = b""
    stream_rest = False

    while idx < len(headers):
        h0 = headers[idx]
        if payloads[idx] is None:
            # force-flush terminator: emit the overlap tail (streaming
            # Decoder.flush(), reference asfh.py:75-87 semantics)
            if frag.size:
                out_parts.append(frag)
            frag = np.empty((0, 0), dtype=np.float64)
            idx += 1
            continue
        if (h0.channels, h0.srate) != info:
            # mid-stream format change: emit the old format's overlap
            # tail and hand the rest back (the reference's `crit` split)
            if frag.size:
                out_parts.append(frag)
            frag = np.empty((0, 0), dtype=np.float64)
            remainder = b"".join(
                _reframe(headers[i], payloads[i]) for i in range(idx, len(headers))
            ) + tail_bytes
            tail_bytes = b""
            break
        if h0.profile not in _BATCHABLE:
            stream_rest = True
            break
        key0 = _run_key(h0)
        run = 1
        while (idx + run < len(headers) and payloads[idx + run] is not None
               and _run_key(headers[idx + run]) == key0):
            run += 1

        n = h0.fsize
        if h0.profile in COMPACT and h0.overlap_ratio > 1:
            cut = n * (h0.overlap_ratio - 1) // h0.overlap_ratio
        else:
            cut = n
        if frag.size and (len(frag) > cut or frag.shape[1] != h0.channels):
            # the fragment spans multiple frames of the new run — the
            # streaming engine's progressive crossfade handles it exactly
            stream_rest = True
            break

        out, new_frag = _decode_run(
            headers[idx: idx + run], payloads[idx: idx + run],
            fix_error=fix_error, compute_dtype=compute_dtype,
            i16_transfer=i16_transfer, i24_transfer=i24_transfer)
        if frag.size and len(out):
            out_parts.append(_frag_head(out, frag))
            out_parts.append(out[len(frag):])
        else:
            out_parts.append(out)
        frag = new_frag
        srate = h0.srate
        idx += run

    # ---- stream whatever could not be batched, with carried state ----
    if not remainder:
        dec = Decoder(fix_error=fix_error)
        dec.overlap_fragment = np.asarray(frag, dtype=np.float64)
        dec.info = info
        rest_stream = (b"".join(
            _reframe(headers[i], payloads[i]) for i in range(idx, len(headers))
        ) if stream_rest else b"") + tail_bytes
        if rest_stream:
            r = dec.process(rest_stream)
            out_parts.append(r.pcm)
            srate = r.srate or srate
            if r.crit:
                # the pending frame's header is already parsed inside
                # `dec`; reserialise it + the unread buffer for the
                # caller's next segment
                remainder = dec.asfh.buffer + dec.buffer
            else:
                out_parts.append(dec.flush().pcm)
        elif frag.size:
            out_parts.append(frag)

    parts = [np.atleast_2d(p) for p in out_parts if p.size]
    if not parts:
        pcm_out = np.empty((0, first.channels))
    elif len(parts) == 1:
        pcm_out = parts[0]          # single run: skip the 8 B/sample copy
    else:
        pcm_out = np.concatenate(parts, axis=0)
    if return_remainder:
        return pcm_out, srate, remainder
    return pcm_out, srate


def _reframe(a: ASFH, payload: bytes | None) -> bytes:
    """Reserialise an already-parsed frame (header buffer is authoritative)."""
    return a.buffer + (payload or b"")


def batch_repair(stream: bytes, ecc_ratio: tuple[int, int] = DEFAULT_ECC_RATIO,
                 *, fix_error: bool = True) -> bytes:
    """Re-armor a whole FrAD stream in batched mode (the Repairer engine's
    fast path; byte-identical to streaming Repairer.process()+flush()).

    Every complete frame is CRC-verified, RS-repaired when damaged (and
    `fix_error`), and re-armored at `ecc_ratio` with a recomputed CRC —
    payload bytes stay untouched (reference repairer.py:28-71 semantics).
    Non-frame bytes (file header, junk, trailing partials) and
    force-flush terminators pass through verbatim. Consecutive frames
    sharing a header configuration are unarmored + re-framed as single
    threaded native batch calls.
    """
    from ..repairer import sanitize_ecc_ratio

    ecc_ratio, _warn = sanitize_ecc_ratio(ecc_ratio)
    out: list[bytes] = []
    pos = 0
    n = len(stream)
    # pending run of frames sharing a re-frame configuration
    run_key = None
    run_hs: list[ASFH] = []
    run_ps: list[bytes] = []

    def flush_run() -> None:
        nonlocal run_key, run_hs, run_ps
        if not run_hs:
            return
        hs, ps = run_hs, run_ps
        run_key, run_hs, run_ps = None, [], []
        h0 = hs[0]
        if h0.ecc:
            if (native.has("frad_unarmor_batch") and h0.ecc_dsize > 0
                    and h0.ecc_codesize > 0
                    and h0.ecc_dsize + h0.ecc_codesize <= 255):
                # ratios GF(256) can honor only; hand-crafted headers
                # claiming more fall to the per-frame path, which strips
                # parity best-effort (container/ecc.py)
                crcs = np.fromiter((h.crc for h in hs), np.uint32, len(hs))
                ps, _ok = native.unarmor_batch(
                    ps, h0.ecc_dsize, h0.ecc_codesize, crcs,
                    h0.profile in COMPACT, fix_error)
            else:
                ps = [ecc_mod.decode(
                    p, h0.ecc_dsize, h0.ecc_codesize,
                    fix_error and not h.payload_crc_matches(p))
                    for h, p in zip(hs, ps)]
        if native.has("frad_frame_pack_batch"):
            b = len(hs)
            bdis = np.fromiter((h.bit_depth_index for h in hs), np.uint8, b)
            flens = np.fromiter((h.fsize for h in hs), np.uint32, b)
            if h0.profile in COMPACT:
                fidx_of = {fl: compact.get_samples_index(int(fl))
                           for fl in set(flens.tolist())}
                fidx = np.fromiter((fidx_of[int(f)] for f in flens),
                                   np.uint8, b)
                sidx = compact.get_srate_index(h0.srate)
            else:
                fidx, sidx = None, 0
            out.append(native.frame_pack_batch(
                ps, bdis, flens, fidx, profile=h0.profile,
                is_compact=h0.profile in COMPACT, channels=h0.channels,
                srate=h0.srate, srate_idx=sidx,
                overlap_ratio=h0.overlap_ratio, little_endian=h0.endian,
                ecc=True, ecc_dsize=ecc_ratio[0], ecc_codesize=ecc_ratio[1]))
        else:
            for h, p in zip(hs, ps):
                h.ecc = True
                h.ecc_dsize, h.ecc_codesize = ecc_ratio
                out.append(h.write(ecc_mod.encode(p, *ecc_ratio)))

    scan = _scan_native(stream)
    if scan is not None:
        headers_s, payloads_s, _tail_pos, starts = scan
        prev = 0
        for a, p, st in zip(headers_s, payloads_s, starts):
            if st > prev:
                flush_run()
                out.append(stream[prev:st])       # passthrough bytes
            if p is None:                         # force-flush terminator
                flush_run()
                out.append(a.buffer)
                prev = st + a.header_bytes
                continue
            key = (a.profile, a.channels, a.srate, a.endian,
                   a.overlap_ratio, a.ecc, a.ecc_dsize, a.ecc_codesize)
            if key != run_key:
                flush_run()
                run_key = key
            run_hs.append(a)
            run_ps.append(p)
            prev = st + a.header_bytes + a.frmbytes
        flush_run()
        # trailing junk / truncated frame passes through (Repairer.flush())
        out.append(stream[prev:])
        return b"".join(out)

    while True:
        idx = stream.find(FRM_SIGN, pos)
        if idx < 0:
            flush_run()
            out.append(stream[pos:])
            break
        if idx > pos:
            flush_run()
            out.append(stream[pos:idx])           # passthrough bytes
        a = ASFH()
        status, _ = a.read(stream[idx: idx + 48])
        if status == FORCE_FLUSH:
            flush_run()
            out.append(stream[idx: idx + a.header_bytes])
            pos = idx + a.header_bytes
            continue
        if status != COMPLETE or idx + a.header_bytes + a.frmbytes > n:
            # truncated trailing frame: passes through (Repairer.flush())
            flush_run()
            out.append(stream[idx:])
            break
        key = (a.profile, a.channels, a.srate, a.endian, a.overlap_ratio,
               a.ecc, a.ecc_dsize, a.ecc_codesize)
        if key != run_key:
            flush_run()
            run_key = key
        run_hs.append(a)
        run_ps.append(stream[idx + a.header_bytes:
                             idx + a.header_bytes + a.frmbytes])
        pos = idx + a.header_bytes + a.frmbytes
        if pos >= n:
            flush_run()
            break

    return b"".join(out)
