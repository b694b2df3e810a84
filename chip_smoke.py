"""Smoke test of the FrAD engine's main path on a GPU.

    python chip_smoke.py           # phases 0-2 on one GPU
    python chip_smoke.py --four    # phase 3 only: the auto-sharded path on 4 GPUs

Phase 0 names the device. Phase 1 runs each kernel of the main path, as
compiled for the card, at real widths against the plain reference (scipy
/ numpy, or the same core on the host CPU backend in f64). Phase 2 drives
every bench.py cell (30 s of audio) through batch_encode / batch_decode /
batch_repair with the bench's own kwargs, the streaming Encoder/Decoder
and the CLI. Phase 3 compares the batch pipeline auto-sharded over four
cards with the single-device path.

Every check prints its observed value, bound and the bound's reason. The
last stdout line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

printed only when every check passed. Without a GPU, or when any check
fails, the script exits non-zero and prints no such line. Timings printed
here are smoke, not a benchmark. Everything runs in this one process.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

FRM_SIGN = b"\xff\xd0\xd2\x98"

#: mantissa bits a lossless container keeps (16 = f16, 24 = f32 cut to 3
#: bytes, 32 = f32, 48 = f64 cut to 6 bytes, 64 = f64)
CONTAINER_MANTISSA = {12: 6, 16: 10, 24: 15, 32: 23, 48: 36, 64: 52}

#: P1/P2 quantised-symbol agreement between the card's f32 core and the
#: host's f64 core: share of differing symbols, and largest |difference|
SYMBOL_FLIP_SHARE = 1e-4
SYMBOL_MAX_DIFF = 1


class Checks:
    """Collects pass/fail results; every check prints its bound and why."""

    def __init__(self) -> None:
        self.failed: list[str] = []
        self.passed = 0

    def check(self, name: str, ok: bool, observed, bound, reason: str) -> bool:
        ok = bool(ok)
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {observed} "
              f"(bound {bound}: {reason})", flush=True)
        if ok:
            self.passed += 1
        else:
            self.failed.append(name)
        return ok

    def note(self, text: str) -> None:
        print(f"  {text}", flush=True)


# ---------------------------------------------------------------------------
# compare helpers
# ---------------------------------------------------------------------------
def rel_err_vs_peak(got, ref) -> float:
    """Largest per-row max|got - ref| / max|ref| over the last axis."""
    got = np.asarray(got, np.float64).reshape(-1, np.shape(ref)[-1])
    ref = np.asarray(ref, np.float64).reshape(got.shape)
    peak = np.maximum(np.abs(ref).max(axis=1), np.finfo(np.float64).tiny)
    return float((np.abs(got - ref).max(axis=1) / peak).max())


def symbol_diff(a, b) -> tuple[float, int]:
    """(share of differing integer symbols, largest |difference|)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    d = np.abs(a - b)
    return float(np.count_nonzero(d)) / max(d.size, 1), int(d.max(initial=0))


def lossless_tol(bits: int, peak: float) -> float:
    """Decoded-PCM bound between two lossless decodes of one signal: one
    container ulp at the signal's peak (a transform-noise truncation flip
    moves a coefficient by one ulp of ITS value, which the inverse
    transform spreads below that)."""
    return 2.0 ** -CONTAINER_MANTISSA[bits] * peak


def frames_differing(a: bytes, b: bytes) -> tuple[int, int]:
    """(frames whose bytes differ, frames) between two streams."""
    fa, fb = a.split(FRM_SIGN), b.split(FRM_SIGN)
    n = max(len(fa), len(fb)) - 1
    same = sum(x == y for x, y in zip(fa[1:], fb[1:]))
    return n - same, n


@contextlib.contextmanager
def on_host():
    """Run JAX work on the host CPU backend, unsharded (the f64
    reference)."""
    import jax

    from frad_python_tpu.models import batch

    with jax.default_device(jax.devices("cpu")[0]), batch.sharding_disabled():
        yield


def _timed(fn, *a, **k):
    t0 = time.perf_counter()
    out = fn(*a, **k)
    import jax
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _frames(seconds: float, srate: int, ch: int, n: int) -> np.ndarray:
    import bench

    pcm = bench.make_audio(seconds, srate, ch)
    b = len(pcm) // n
    return pcm[: b * n].reshape(b, n, ch)


def _rows(frames: np.ndarray) -> np.ndarray:
    """[B, N, C] -> [B*C, N] channel rows."""
    b, n, c = frames.shape
    return np.ascontiguousarray(frames.transpose(0, 2, 1).reshape(b * c, n))


# ---------------------------------------------------------------------------
# phase 0: device
# ---------------------------------------------------------------------------
def phase_device(ck: Checks) -> dict:
    import jax

    import bench
    from frad_python_tpu import native
    from frad_python_tpu.ops import policy

    info = bench.device_info()
    print(f"phase 0: device {info['platform']} {info['device_kind']} "
          f"x{info['count']}", flush=True)
    print(f"  nvidia-smi: {info['nvidia_smi']}")
    print(f"  jax {jax.__version__}; compile cache "
          f"{jax.config.jax_compilation_cache_dir}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    t0 = time.perf_counter()
    native_ok = bench.build_native()
    ck.check("native module built from source and active", native_ok,
             native.available(), True,
             "the byte domain's C++ fast paths (set-up "
             f"{time.perf_counter() - t0:.1f}s)")
    ck.check("compute dtype", policy.compute_dtype() == "float32",
             policy.compute_dtype(), "float32", "the GPU platform policy")
    return info


# ---------------------------------------------------------------------------
# phase 1: kernels against the plain reference at real widths
# ---------------------------------------------------------------------------
#: DCT shapes: the 30 s 44.1 kHz stereo batch (646 frames x 2 ch) and the
#: hires batch (351 frames x 8 ch at 8192)
DCT_SHAPES = ((44100, 2, 2048, 30.0), (96000, 8, 8192, 30.0))
#: f32 FFT-DCT above the matrix cap, > 256 rows (where the old chunking
#: workaround applied): P1 frame sizes 16384 and 28672
FFT_SHAPES = ((48000, 2, 16384, 90.0), (48000, 2, 28672, 160.0))

#: f32 FFT-DCT vs scipy f64, max error relative to the frame peak (FFT
#: rounding grows like log2(N) * 2^-24)
DCT_FFT_TOL = 1e-6


def dct_matmul_tol(n: int) -> float:
    """A matmul DCT/IDCT sums N terms per output in f32: its rounding
    grows like sqrt(N) * 2^-24 relative to the frame peak; 2x margin."""
    return 2.0 * np.sqrt(n) * 2.0 ** -24


def check_dct(ck: Checks, shapes=DCT_SHAPES, fft_shapes=FFT_SHAPES) -> None:
    import jax.numpy as jnp
    from scipy.fft import dct as sdct, idct as sidct

    from frad_python_tpu.ops.dct import dct2_forward, idct2_forward, use_matmul

    for srate, ch, n, secs in tuple(shapes) + tuple(fft_shapes):
        x = _rows(_frames(secs, srate, ch, n))
        ref = sdct(x, norm="forward", axis=-1)
        path = "matmul" if use_matmul(n, jnp.float32) else "fft"
        xd = jnp.asarray(x, jnp.float32)
        got, t = _timed(dct2_forward, xd)
        err = rel_err_vs_peak(got, ref)
        tol = dct_matmul_tol(n) if path == "matmul" else DCT_FFT_TOL
        why = ("HIGHEST f32 matmul: sqrt(N) * 2^-24 accumulation, x2"
               if path == "matmul" else "f32 FFT: ~log2(N) * 2^-24")
        ck.check(f"f32 DCT ({path}) [{x.shape[0]}, {n}] vs scipy f64, "
                 "relative to the frame peak", err <= tol,
                 f"{err:.3e} ({t * 1e3:.1f} ms cold)", f"{tol:.2e}", why)
        refi = sidct(ref, norm="forward", axis=-1)
        goti = idct2_forward(jnp.asarray(ref, jnp.float32))
        erri = rel_err_vs_peak(goti, refi)
        ck.check(f"f32 IDCT ({path}) [{x.shape[0]}, {n}] vs scipy f64, "
                 "relative to the frame peak", erri <= tol, f"{erri:.3e}",
                 f"{tol:.2e}", why)
    # the f64 path on the card: c128 FFT
    x = _rows(_frames(5.0, 44100, 2, 2048))
    ref = sdct(x, norm="forward", axis=-1)
    got = dct2_forward(jnp.asarray(x, jnp.float64))
    err = rel_err_vs_peak(got, ref)
    ck.check(f"f64 DCT (c128 FFT) [{x.shape[0]}, 2048] vs scipy", err <= 1e-12,
             f"{err:.3e}", 1e-12, "f64 FFT rounding (~log2 N ulps)")


def check_psycho(ck: Checks, srate: int = 44100, seconds: float = 30.0) -> None:
    import jax
    import jax.numpy as jnp
    from scipy.fft import dct as sdct

    from frad_python_tpu.ops import psycho

    n = 2048
    freqs = np.abs(sdct(_rows(_frames(seconds, srate, 2, n)), norm="forward",
                        axis=-1)) * 2.0 ** 15
    want = psycho.mask_thres_mos(freqs, srate, 0.5)
    got = np.asarray(jax.jit(lambda f: psycho.mask_thres_mos_jnp(
        f, srate, jnp.float32(0.5)))(jnp.asarray(freqs, jnp.float32)))
    err = rel_err_vs_peak(got, want)
    ck.check(f"mask_thres_mos_jnp [{freqs.shape[0]}, {n}] vs numpy f64",
             err <= 1e-5, f"{err:.3e}", 1e-5, "f32 band sums of up to N/2 "
             "squares (~sqrt(width) * 2^-24) through sqrt and pow, relative "
             "to the frame's largest threshold")
    wmap = psycho.mapping_from_opus(want, n, srate)
    gmap = np.asarray(jax.jit(lambda t: psycho.mapping_from_opus_jnp(
        t, n, srate))(jnp.asarray(want, jnp.float32)))
    err = rel_err_vs_peak(gmap, wmap)
    ck.check(f"mapping_from_opus_jnp [{want.shape[0]}, 27->{n}] vs numpy f64",
             err <= 1e-6, f"{err:.3e}", 1e-6, "two-term f32 interpolation: "
             "input rounding plus one reassociation, a few 2^-24")


def check_lossy_cores(ck: Checks, srate: int = 44100, seconds: float = 30.0):
    """P1/P2 encode-core ints on the card (f32) vs the same cores on the
    host CPU backend in f64, on the same frames. Returns the card's P1
    symbols for the packer check."""
    import jax
    import jax.numpy as jnp

    from frad_python_tpu.models import batch, profile1, profile2

    frames = _frames(seconds, srate, 2, 2048)
    out = {}
    for prof, core, factor in (
            (1, batch.p1_encode_core, profile1._scale_factor(16)),
            (2, batch.p2_encode_core, profile2._scale_factor(16))):
        dev, t = _timed(core, frames.astype(np.float32), srate, 0.5, factor)
        dev = [np.asarray(a) for a in dev]
        with on_host():
            host = [np.asarray(a) for a in core(frames, srate, 0.5, factor)]
        for name, a, b in zip(("freqs", "thres", "lpc"), dev, host):
            share, mx = symbol_diff(a, b)
            ck.check(f"P{prof} encode core {name} ints [{frames.shape[0]}, "
                     f"2048, 2] card f32 vs host f64", share <=
                     SYMBOL_FLIP_SHARE and mx <= SYMBOL_MAX_DIFF,
                     f"{share:.3e} of {a.size} differ, max |diff| {mx}",
                     f"<= {SYMBOL_FLIP_SHARE:g}, |diff| <= {SYMBOL_MAX_DIFF}",
                     "f32 transform noise moves values that sit within "
                     "~1e-6 of a rounding boundary by one step")
        ck.note(f"P{prof} encode core first call {t:.2f}s (compile + run, "
                "smoke)")
        out[prof] = dev

    # the TNS synthesis IIR (a sample-wise lax.scan) lives in P2 decode
    fq, tq, lq = (jnp.asarray(a, jnp.float32) for a in out[2])
    dec = jax.jit(batch._p2_decode_jit.__wrapped__, static_argnums=(3,))
    _, inv = batch._mats_like(2048, jnp.float32, fq)
    fac = jnp.float32(profile2._scale_factor(16))
    _, t_first = _timed(dec, fq, tq, lq, srate, fac, inv)
    _, t_run = _timed(dec, fq, tq, lq, srate, fac, inv)
    ck.note(f"P2 decode (TNS IIR lax.scan over 2048 samples) "
            f"[{fq.shape[0]}, 2048, 2]: compile ~{t_first - t_run:.2f}s, "
            f"run {t_run * 1e3:.1f} ms (smoke)")

    # decode cores on the card (f32) vs the host (f64), same symbols
    tol = 2 * dct_matmul_tol(2048)
    for prof, core, syms, factor in (
            (1, batch.p1_decode_core, out[1], profile1._scale_factor(16)),
            (2, batch.p2_decode_core, out[2], profile2._scale_factor(16))):
        got = np.asarray(core(*(a.astype(np.float32) for a in syms), srate,
                              factor))
        with on_host():
            want = np.asarray(core(*(a.astype(np.float64) for a in syms),
                                   srate, factor))
        err = rel_err_vs_peak(got.transpose(0, 2, 1), want.transpose(0, 2, 1))
        ck.check(f"P{prof} decode core [{got.shape[0]}, 2048, 2] card f32 vs "
                 "host f64, relative to the frame peak", err <= tol,
                 f"{err:.3e}", f"{tol:.2e}", "the f32 IDCT bound, x2 for "
                 "the dequant pow" + (" and the TNS IIR" if prof == 2 else ""))
    return out[1][0]


def check_transfer_words(ck: Checks, frames: np.ndarray, srate: int = 44100
                         ) -> None:
    """The i24 / i16 transfer formats: device converters vs the host's."""
    import jax.numpy as jnp

    from frad_python_tpu.models import batch, profile1
    from frad_python_tpu.ops import bitpack

    b, n, ch = frames.shape
    x = np.clip(frames, -1.0, 1.0).astype(np.float32)
    dev = np.asarray(bitpack.pcm_to_i24_words(jnp.asarray(x)))
    host = bitpack.pcm_to_i24_words_host(x.astype(np.float64)).reshape(b, -1)
    back = np.asarray(bitpack.i24_words_to_pcm_device(jnp.asarray(host)))
    want = bitpack.i24_words_to_pcm(host)
    ok = np.array_equal(dev, host) and np.array_equal(back, want)
    ck.check(f"i24 PCM words [{b}, {n}, {ch}] device vs host pack/unpack", ok,
             "equal" if ok else "differ", "bit-exact",
             "integer rounding of f32-exact samples")

    q = np.clip(np.rint(frames * 32768.0), -32768, 32767).astype(np.int16)
    factor = profile1._scale_factor(16)
    a = batch.p1_encode_core_i16(q, srate, 0.5, factor)
    c = batch.p1_encode_core(q.astype(np.float32) / np.float32(32768.0),
                             srate, 0.5, factor)
    diffs = [symbol_diff(u, v) for u, v in zip(a, c)]
    share, mx = max(d[0] for d in diffs), max(d[1] for d in diffs)
    ck.check(f"P1 i16-upload encode [{b}, {n}, {ch}] vs f32 upload of the "
             "same samples", share <= SYMBOL_FLIP_SHARE and mx <=
             SYMBOL_MAX_DIFF, f"{share:.3e} of symbols differ, max |diff| "
             f"{mx}", f"<= {SYMBOL_FLIP_SHARE:g}, |diff| <= "
             f"{SYMBOL_MAX_DIFF}", "i16/32768 is exact in f32; only a "
             "different GEMM kernel for the fused program could move a "
             "boundary value")

    fq, tq = (np.asarray(v, np.float32) for v in c)
    cut = n * 15 // 16
    o16, _ = batch.p1_decode_oa_core(fq, tq, srate, factor, n - cut, cut, True)
    of, _ = batch.p1_decode_oa_core(fq, tq, srate, factor, n - cut, cut, False)
    want = np.clip(np.rint(np.asarray(of, np.float64) * 32768.0), -32768, 32767)
    share, mx = symbol_diff(np.asarray(o16), want)
    ck.check(f"P1 decode i16 output [{b}, {cut}, {ch}] vs host rounding of "
             "the f32 decode", share <= SYMBOL_FLIP_SHARE and mx <= 1,
             f"{share:.3e} of samples differ, max |diff| {mx}",
             f"<= {SYMBOL_FLIP_SHARE:g}, |diff| <= 1", "round-half-even of "
             "the same f32 samples, computed by two compiled programs")


def check_packers(ck: Checks, fq: np.ndarray, x: np.ndarray) -> None:
    """On-device EGR and truncated-float packers vs the host encoders,
    bit-exact on the same inputs."""
    import jax.numpy as jnp

    from frad_python_tpu.ops import bitpack, golomb, packing

    b = fq.shape[0]
    sym = fq.reshape(b, -1).astype(np.int32)
    max_words = max(sym.shape[1] * 12 // 32, 16)
    words, nbits, ks, ovf = (np.asarray(a) for a in bitpack.egr_pack_frames(
        jnp.asarray(sym), max_words))
    rows = np.flatnonzero(~ovf)
    bad = sum(bitpack.words_to_stream(words[i], nbits[i], ks[i])
              != golomb.encode(sym[i]) for i in rows)
    ck.check(f"egr_pack_frames [{b}, {sym.shape[1]}] vs host golomb", bad == 0,
             f"{bad} of {len(rows)} rows differ ({int(ovf.sum())} overflow "
             "rows go to the host)", 0, "bit-exact by construction")

    xf = np.asarray(x, np.float32)
    for bits in (16, 24, 32):
        for little in (False, True):
            w = bitpack.trunc_pack(jnp.asarray(xf), bits, little)
            ref = packing.pack_floats(xf.reshape(-1), bits, little)
            back = np.asarray(bitpack.trunc_unpack(w, bits, little),
                              np.float64).reshape(-1)
            want = packing.unpack_floats(ref, bits, little)
            ok = np.asarray(w).tobytes() == ref and np.array_equal(back, want)
            ck.check(f"trunc_pack/unpack {bits}-bit {'LE' if little else 'BE'}"
                     f" [{xf.shape[0]}, {xf.shape[1]}] vs host packing", ok,
                     "equal" if ok else "differ", "bit-exact",
                     "same IEEE truncation on both sides")


def check_overlap_add(ck: Checks, frames: np.ndarray, ratio: int = 16) -> None:
    import jax.numpy as jnp

    from frad_python_tpu.models import batch
    from frad_python_tpu.ops.window import crossfade

    n = frames.shape[1]
    cut = n * (ratio - 1) // ratio
    olap = n - cut
    f32 = frames.astype(np.float32)
    got = np.asarray(batch.overlap_add_core(jnp.asarray(f32), olap, cut))
    frag = np.empty((0, frames.shape[2]))
    want = []
    for f in f32.astype(np.float64):
        if frag.size:
            f, _ = crossfade(f, frag, 0)
        frag = f[cut:]
        want.append(f[:cut])
    want = np.stack(want)
    err = float(np.abs(got - want).max())
    tol = 4 * 2.0 ** -24 * float(np.abs(want).max())
    ck.check(f"overlap_add_core [{frames.shape[0]}, {n}, {frames.shape[2]}] "
             "vs streaming crossfade", err <= tol, f"{err:.3e}", f"{tol:.2e}",
             "two f32 products and a sum per sample: a few 2^-24 of the peak")


def check_compiled(ck: Checks, b: int = 646, srate: int = 44100) -> None:
    """Memory of the P1 encode core, and f64/s64 ops in the f32 cores."""
    import jax.numpy as jnp

    from frad_python_tpu.models import batch

    n, ch = 2048, 2
    x = jnp.zeros((b, n, ch), jnp.float32)
    fwd, inv = batch._mats_like(n, jnp.float32, x)
    s = jnp.float32(0.5)
    lowered = {
        "P1 encode": batch._p1_encode_jit.lower(x, srate, s, s, fwd),
        "P1 decode+OA": batch._p1_decode_oa_jit.lower(
            x, jnp.zeros((b, 27, ch), jnp.float32), srate, s, 128, 1920,
            True, inv),
        "P2 encode": batch._p2_encode_jit.lower(x, srate, s, s, fwd),
        "P0 encode+pack": batch._p0_encode_pack_jit.lower(x, 24, False, fwd),
    }
    for name, low in lowered.items():
        c = low.compile()
        if name == "P1 encode":
            ck.note(f"{name} [{b}, {n}, {ch}] memory_analysis: "
                    f"{c.memory_analysis()}")
        txt = c.as_text()
        ck.note(f"{name}: {txt.count('f64[')} f64 and {txt.count('s64[')} "
                "s64 shapes in the compiled HLO (observation; jax_enable_x64 "
                "is on)")


def phase_kernels(ck: Checks, small: bool = False) -> None:
    """Phase 1. `small` shrinks every width for a CPU rehearsal."""
    print("phase 1: kernels vs the plain reference", flush=True)
    if small:
        check_dct(ck, shapes=((44100, 2, 256, 0.5),),
                  fft_shapes=((48000, 1, 9000, 2.0),))
        check_psycho(ck, seconds=0.5)
        fq = check_lossy_cores(ck, seconds=0.5)
        check_packers(ck, fq, _rows(_frames(0.5, 44100, 2, 256)))
        check_transfer_words(ck, _frames(0.5, 44100, 2, 256))
        check_overlap_add(ck, _frames(0.5, 44100, 2, 256))
        check_compiled(ck, b=4)
        return
    check_dct(ck)
    check_psycho(ck)
    fq = check_lossy_cores(ck)
    check_packers(ck, fq, _rows(_frames(30.0, 44100, 2, 2048)))
    check_transfer_words(ck, _frames(30.0, 44100, 2, 2048))
    check_overlap_add(ck, _frames(30.0, 44100, 2, 2048))
    check_compiled(ck)


# ---------------------------------------------------------------------------
# phase 2: the main path at bench size
# ---------------------------------------------------------------------------
def _cell_gate(ck: Checks, name: str, cfg: dict, pcm, stream, out,
               ref_stream, ref_out) -> None:
    import bench

    prof, bits = cfg["profile"], cfg["bits"]
    if prof == 1:
        d = bench.snr_db(pcm, out) - bench.snr_db(pcm, ref_out)
        ck.check(f"{name} lossy SNR vs host f64 run", abs(d) <= 0.1,
                 f"{bench.snr_db(pcm, out):.3f} dB ({d:+.4f})", "0.1 dB",
                 "quality on the card must match the f64 codec")
    elif bits >= 48:
        ok = stream == ref_stream and np.array_equal(out, ref_out)
        ck.check(f"{name} archival stream route=host", ok,
                 "byte-equal" if ok else "differs", "byte-equal",
                 "the same f64 program on the same host backend")
    else:
        m = min(len(out), len(ref_out))
        err = float(np.abs(out[:m] - ref_out[:m]).max()) if m else 0.0
        tol = lossless_tol(bits, float(np.abs(pcm).max()))
        ck.check(f"{name} lossless decode vs host f64 decode", err <= tol
                 and len(out) == len(ref_out), f"{err:.3e}", f"{tol:.2e}",
                 f"one {bits}-bit container ulp at the signal peak")


def phase_main_path(ck: Checks, seconds: float = 30.0,
                    stream_seconds: float = 10.0) -> None:
    import bench
    from frad_python_tpu.parallel import batch_decode, batch_encode, batch_repair
    from frad_python_tpu.utils.damage import damage_stream

    smi = bench.device_info()["nvidia_smi"]
    print(f"phase 2: main path, {seconds:g} s per cell (timings: smoke, not "
          f"a benchmark, on {smi})", flush=True)
    for name, cfg in bench.CONFIGS.items():
        pcm = bench.make_audio(seconds, cfg["srate"], cfg["channels"])
        args = (cfg["profile"], cfg["srate"], cfg["bits"], cfg["frame_size"])
        kw, dec_kw = bench.cell_kwargs(cfg)
        t0 = time.perf_counter()
        stream = batch_encode(pcm, *args, **kw)
        out, _ = batch_decode(stream, **dec_kw)
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        stream = batch_encode(pcm, *args, **kw)
        out, _ = batch_decode(stream, **dec_kw)
        t_warm = time.perf_counter() - t0
        rkw, rdec = bench.cell_kwargs(cfg, "float64")
        with on_host():
            ref_stream = batch_encode(pcm, *args, **rkw)
            ref_out, _ = batch_decode(ref_stream, **rdec)
        ck.note(f"{name}: route={bench.route(cfg)}, {stream.count(FRM_SIGN)} "
                f"frames, cold {t_cold:.2f}s, warm enc+dec {t_warm:.3f}s")
        _cell_gate(ck, name, cfg, pcm, stream, out, ref_stream, ref_out)

    for name, cfg in bench.REPAIR_CONFIGS.items():
        pcm = bench.make_audio(seconds, cfg["srate"], cfg["channels"])
        kw, dec_kw = bench.cell_kwargs(cfg)
        stream = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                              cfg["frame_size"], **kw)
        damaged = damage_stream(stream)
        t0 = time.perf_counter()
        repaired = batch_repair(damaged, (96, 24))
        t = time.perf_counter() - t0
        out_r, _ = batch_decode(repaired, **dec_kw)
        out_o, _ = batch_decode(stream, **dec_kw)
        ck.check(f"{name} repaired stream decodes equal to undamaged",
                 np.array_equal(out_r, out_o),
                 f"{sum(a != b for a, b in zip(stream, damaged))} bytes "
                 f"damaged, repair {t:.3f}s", "equal",
                 "damage within RS capacity is fully corrected")

    check_streaming(ck, stream_seconds)
    check_cli(ck)
    check_f64_override(ck, seconds)


def check_streaming(ck: Checks, seconds: float) -> None:
    """Streaming Encoder/Decoder in 32 KiB pushes vs the batch stream."""
    import bench
    from frad_python_tpu import Decoder, Encoder
    from frad_python_tpu.parallel import batch_decode, batch_encode

    push = 32 << 10
    for name in ("p1_stereo_48k_ecc", "p0_stereo_44k1"):
        cfg = bench.CONFIGS[name]
        pcm = bench.make_audio(seconds, cfg["srate"], cfg["channels"])
        ecc = bool(cfg.get("ecc"))
        enc = Encoder(cfg["profile"], cfg["srate"], cfg["channels"],
                      cfg["bits"], cfg["frame_size"], "f64be")
        if ecc:
            enc.set_ecc(True, (96, 24))
        if cfg["profile"] == 1:
            enc.set_overlap_ratio(16)      # batch_encode's default
        raw = pcm.astype(">f8").tobytes()
        t0 = time.perf_counter()
        parts = [enc.process(raw[i:i + push]).buf
                 for i in range(0, len(raw), push)]
        s_stream = b"".join(parts) + enc.flush().buf
        t_enc = time.perf_counter() - t0
        b_stream = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                                cfg["frame_size"], enable_ecc=ecc)
        nd, nf = frames_differing(s_stream, b_stream)
        ck.note(f"{name} streaming encode ({push >> 10} KiB pushes, "
                f"{t_enc:.2f}s): byte-equal to batch "
                f"{s_stream == b_stream} ({nd} of {nf} frames differ)")
        dec = Decoder(fix_error=ecc)
        t0 = time.perf_counter()
        outs = [dec.process(s_stream[i:i + push]).pcm
                for i in range(0, len(s_stream), push)]
        outs.append(dec.flush().pcm)
        s_out = np.concatenate([o for o in outs if o.size])
        t_dec = time.perf_counter() - t0
        b_out, _ = batch_decode(b_stream, fix_error=ecc)
        if cfg["profile"] == 1:
            d = bench.snr_db(pcm, s_out) - bench.snr_db(pcm, b_out)
            ck.check(f"{name} stream-vs-batch SNR", abs(d) <= 0.1
                     and len(s_out) == len(b_out), f"{d:+.4f} dB "
                     f"(decode {t_dec:.2f}s)", "0.1 dB",
                     "streaming micro-batches compile other shapes; quality "
                     "must not move")
        else:
            m = min(len(s_out), len(b_out))
            err = float(np.abs(s_out[:m] - b_out[:m]).max())
            tol = lossless_tol(cfg["bits"], float(np.abs(pcm).max()))
            ck.check(f"{name} stream-vs-batch decoded PCM", err <= tol
                     and len(s_out) == len(b_out), f"{err:.3e} "
                     f"(decode {t_dec:.2f}s)", f"{tol:.2e}",
                     f"one {cfg['bits']}-bit container ulp at the peak")


def check_cli(ck: Checks, seconds: float = 10.0) -> None:
    """CLI encode / repair / decode, in-process, on a 10 s file."""
    import bench
    from frad_python_tpu.app.main import main as cli

    pcm = np.clip(bench.make_audio(seconds, 44100, 2), -1, 1)
    src = (pcm * 32767).astype(">i2")
    with tempfile.TemporaryDirectory() as td:
        d = pathlib.Path(td)
        (d / "in.pcm").write_bytes(src.tobytes())
        t0 = time.perf_counter()
        cli(["frad-tpu", "encode", str(d / "in.pcm"), "--srate", "44100",
             "--ch", "2", "--pcm", "s16be", "--bits", "16", "--profile", "1",
             "--ecc", "-o", str(d / "a.frad"), "-y"])
        cli(["frad-tpu", "repair", str(d / "a.frad"), "--ecc", "96", "24",
             "-o", str(d / "r.frad"), "-y"])
        cli(["frad-tpu", "decode", str(d / "a.frad"), "--pcm", "s16be",
             "--ecc", "-o", str(d / "a"), "-y"])
        cli(["frad-tpu", "decode", str(d / "r.frad"), "--pcm", "s16be",
             "--ecc", "-o", str(d / "r"), "-y"])
        t = time.perf_counter() - t0
        a = np.frombuffer((d / "a.pcm").read_bytes(), ">i2")
        r = np.frombuffer((d / "r.pcm").read_bytes(), ">i2")
    ref = src.astype(np.float64).ravel()
    snr = bench.snr_db(ref, a.astype(np.float64))
    ok = abs(len(a) - ref.size) <= 2048 * 2 and np.array_equal(a, r) \
        and snr > 10.0
    ck.check("CLI encode/repair/decode (P1+ECC, 10 s, in-process)", ok,
             f"SNR {snr:.2f} dB, {len(a)} of {ref.size} samples, repaired "
             f"decode equal {np.array_equal(a, r)}, {t:.2f}s",
             "> 10 dB, within a frame, equal",
             "the lossy profile's own quality at loss 0.5; repair is "
             "lossless")


def check_f64_override(ck: Checks, seconds: float) -> None:
    """One lossless cell under FRAD_TPU_COMPUTE_DTYPE=float64 (c128 cuFFT
    on the card) against the host f64 run."""
    import bench
    from frad_python_tpu.ops import policy
    from frad_python_tpu.parallel import batch_decode, batch_encode

    name = "p0_stereo_44k1"
    cfg = bench.CONFIGS[name]
    old = os.environ.get("FRAD_TPU_COMPUTE_DTYPE")
    os.environ["FRAD_TPU_COMPUTE_DTYPE"] = "float64"
    policy.compute_dtype.cache_clear()
    try:
        pcm = bench.make_audio(seconds, cfg["srate"], cfg["channels"])
        args = (cfg["profile"], cfg["srate"], cfg["bits"], cfg["frame_size"])
        kw, dec_kw = bench.cell_kwargs(cfg)
        t0 = time.perf_counter()
        stream = batch_encode(pcm, *args, **kw)
        out, _ = batch_decode(stream, **dec_kw)
        t = time.perf_counter() - t0
        with on_host():
            ref_stream = batch_encode(pcm, *args, **kw)
            ref_out, _ = batch_decode(ref_stream, **dec_kw)
    finally:
        if old is None:
            os.environ.pop("FRAD_TPU_COMPUTE_DTYPE")
        else:
            os.environ["FRAD_TPU_COMPUTE_DTYPE"] = old
        policy.compute_dtype.cache_clear()
    nd, nf = frames_differing(stream, ref_stream)
    ck.note(f"{name} under FRAD_TPU_COMPUTE_DTYPE=float64 ({t:.2f}s cold): "
            f"{nd} of {nf} frames differ from the host stream")
    _cell_gate(ck, f"{name} [float64]", cfg, pcm, stream, out, ref_stream,
               ref_out)


# ---------------------------------------------------------------------------
# phase 3: four cards
# ---------------------------------------------------------------------------
def phase_four(ck: Checks, seconds: float = 600.0, ndev: int = 4) -> None:
    import jax

    import bench
    from frad_python_tpu.models import batch
    from frad_python_tpu.parallel import batch_decode, batch_encode
    from frad_python_tpu.parallel.sharded import (
        make_mesh, overlap_add_sharded, overlap_add_sharded_fn)

    print(f"phase 3: batch pipeline auto-sharded over {ndev} devices vs one, "
          f"{seconds:g} s of 48 kHz stereo", flush=True)
    ck.check("device count", len(jax.devices()) == ndev, len(jax.devices()),
             ndev, "the sharded phase needs one device per shard")
    pcm = bench.make_audio(seconds, 48000, 2)
    peak = float(np.abs(pcm).max())
    for prof, bits, extra in ((0, 24, {}), (1, 16, {"ecc": True}), (2, 16, {})):
        cfg = dict(profile=prof, srate=48000, channels=2, bits=bits,
                   frame_size=2048, **extra)
        kw, dec_kw = bench.cell_kwargs(cfg)
        args = (prof, 48000, bits, 2048)
        t0 = time.perf_counter()
        s_shard = batch_encode(pcm, *args, **kw)
        o_shard, _ = batch_decode(s_shard, **dec_kw)
        t_shard = time.perf_counter() - t0
        t0 = time.perf_counter()
        with batch.sharding_disabled():
            s_one = batch_encode(pcm, *args, **kw)
            o_one, _ = batch_decode(s_one, **dec_kw)
        t_one = time.perf_counter() - t0
        nd, nf = frames_differing(s_shard, s_one)
        m = min(len(o_shard), len(o_one))
        err = float(np.abs(o_shard[:m] - o_one[:m]).max())
        if prof == 0:
            # truncated floats: a row's f32 matmul rounding depends on the
            # batch shape, so truncation tails may flip (PARITY.md 7)
            tol = lossless_tol(bits, peak)
            same = True
            why = (f"one {bits}-bit container ulp at the peak; the "
                   "truncated floats may differ in their last bit")
        else:
            # quantised ints must agree; decoded PCM within one step of
            # the decode transfer (int16 for P1) or f32 noise
            tol = 2.0 ** -15 if dec_kw["i16_transfer"] else 1e-6
            same = s_shard == s_one
            why = ("quantised symbols byte-equal; decoded PCM within one "
                   + ("int16 transfer step" if dec_kw["i16_transfer"]
                      else "f32 rounding step"))
        ck.check(f"P{prof} {seconds:g} s pipeline sharded over {ndev} vs one",
                 same and len(o_shard) == len(o_one) and err <= tol,
                 f"{nd} of {nf} frames differ, decoded max |diff| {err:.3e} "
                 f"(cold: sharded {t_shard:.1f}s, one {t_one:.1f}s, smoke)",
                 f"{'byte-equal, ' if prof else ''}{tol:.2e}", why)

    mesh = make_mesh(ndev)
    frames = np.asarray(_frames(20.0, 48000, 2, 2048), np.float32)
    frames = frames[: len(frames) // ndev * ndev]
    cut = 2048 * 15 // 16
    olap = 2048 - cut
    got = overlap_add_sharded(mesh, frames, olap, cut)
    with batch.sharding_disabled():
        want = np.asarray(batch.overlap_add_core(frames, olap, cut))
    err = float(np.abs(got - want).max())
    ck.check("overlap_add_sharded vs overlap_add_core", err <= 1e-6,
             f"{err:.3e}", 1e-6, "the same f32 crossfade on each shard")
    hlo = overlap_add_sharded_fn(mesh, olap, cut, frames.dtype).lower(
        jax.device_put(frames, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("data")))).compile().as_text()
    ck.check("overlap_add_sharded halo is a collective-permute",
             "collective-permute" in hlo, "collective-permute" in hlo, True,
             "the ring ppermute must reach the devices' interconnect")
    for d in jax.devices():
        stats = d.memory_stats() or {}
        ck.note(f"{d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


# ---------------------------------------------------------------------------
def _with_cpu_backend() -> None:
    """The references run on the host CPU backend next to the GPU."""
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    four = "--four" in argv
    _with_cpu_backend()
    sys.path.insert(0, str(REPO))
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX default platform is "
              f"{devs[0].platform!r})", file=sys.stderr)
        return 1
    import frad_python_tpu  # noqa: F401  (x64, compile cache)

    ck = Checks()
    t0 = time.perf_counter()
    info = phase_device(ck)
    if four:
        phase_four(ck)
    else:
        phase_kernels(ck)
        phase_main_path(ck)
    print(f"{ck.passed} checks passed, {len(ck.failed)} failed in "
          f"{time.perf_counter() - t0:.0f}s on {info['nvidia_smi']}")
    if ck.failed:
        print("FAILED: " + "; ".join(ck.failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["device_kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
