"""Batch pipeline + multi-device sharding tests on the virtual 8-CPU mesh
(SURVEY §4.7): batch encode byte-exact vs streaming; sharded cores
bit-exact vs single-device."""

import os
import pathlib

import jax
import numpy as np
import pytest

from frad_python_tpu import Decoder, Encoder

REPO = pathlib.Path(__file__).resolve().parent.parent
from frad_python_tpu.models import batch
from frad_python_tpu.parallel import (
    batch_decode, batch_encode, make_mesh, overlap_add_sharded,
    pad_to_multiple, plan_frames, sharded_p0_decode, sharded_p0_encode,
    sharded_p1_decode, sharded_p1_encode,
)

rng = np.random.default_rng(21)


def stream_encode(pcm, profile, srate, bits, fsize, overlap_ratio=16,
                  enable_ecc=False, loss_level=0.5):
    enc = Encoder(profile, srate, pcm.shape[1], bits, fsize, "f64be")
    enc.set_overlap_ratio(overlap_ratio)
    if enable_ecc:
        enc.set_ecc(True, (96, 24))
    enc.loss_level = loss_level
    raw = pcm.astype(">f8").tobytes()
    return enc.process(raw).buf + enc.flush().buf


def stream_decode(stream, fix=False):
    d = Decoder(fix_error=fix)
    out = [d.process(stream).pcm, d.flush().pcm]
    return np.concatenate([p for p in out if p.size])


class TestPlanFrames:
    def test_lossless_plain_chunks(self):
        frames, terms = plan_frames(5000, 512, 0, False)
        assert frames[:-1] == [(i * 512, 512) for i in range(9)]
        assert frames[-1] == (4608, 392)
        assert terms == 0

    def test_compact_overlap_carry(self):
        frames, terms = plan_frames(8192, 2048, 16, True)
        # hop = 2048 - 128 = 1920 after the first frame
        assert frames[0] == (0, 2048)
        assert frames[1] == (1920, 2048)
        assert terms == 2  # tail (fragment) frame exists

    def test_exact_multiple_no_overlap(self):
        frames, terms = plan_frames(4096, 2048, 0, True)
        assert frames == [(0, 2048), (2048, 2048)]
        assert terms == 1


@pytest.mark.parametrize("cfg", [
    dict(profile=4, srate=44100, bits=64, fsize=512, total=5000, ch=2),
    dict(profile=0, srate=44100, bits=24, fsize=2048, total=10000, ch=2),
    dict(profile=1, srate=48000, bits=16, fsize=2048, total=9999, ch=2),
    dict(profile=1, srate=48000, bits=16, fsize=1000, total=7000, ch=1,
         overlap_ratio=2),
    dict(profile=4, srate=44100, bits=64, fsize=512, total=5000, ch=2,
         enable_ecc=True),
])
class TestBatchPipeline:
    def test_encode_byte_exact_vs_streaming(self, cfg):
        pcm = rng.standard_normal((cfg["total"], cfg["ch"])) * 0.4
        ref = stream_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                            cfg["fsize"], cfg.get("overlap_ratio", 16),
                            cfg.get("enable_ecc", False))
        got = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                           cfg["fsize"],
                           overlap_ratio=cfg.get("overlap_ratio", 16),
                           enable_ecc=cfg.get("enable_ecc", False))
        assert got == ref

    def test_decode_matches_streaming(self, cfg):
        pcm = rng.standard_normal((cfg["total"], cfg["ch"])) * 0.4
        stream = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                              cfg["fsize"],
                              overlap_ratio=cfg.get("overlap_ratio", 16),
                              enable_ecc=cfg.get("enable_ecc", False))
        ref = stream_decode(stream, cfg.get("enable_ecc", False))
        got, srate = batch_decode(stream, fix_error=cfg.get("enable_ecc", False))
        assert got.shape == ref.shape
        assert srate == (cfg["srate"] if cfg["profile"] != 1 else ref.shape and srate)
        if cfg["profile"] == 4:
            np.testing.assert_array_equal(got, ref)
        else:
            # XLA batching reassociates the DCT matmuls: equal to fp noise
            np.testing.assert_allclose(got, ref, atol=1e-12)


class TestStageMetering:
    def test_stage_timer_collects_stages_and_link_bytes(self):
        """With a StageTimer wired in, a round trip books named stages
        AND device-link byte counts in both directions (the bench's link
        speed-of-light accounting feeds off these)."""
        from frad_python_tpu.parallel import pipeline
        from frad_python_tpu.utils.tracing import StageTimer

        pcm = rng.standard_normal((9999, 2)) * 0.4
        pipeline.STAGES = t = StageTimer()
        try:
            stream = batch_encode(pcm, 1, 48000, 16, 2048)
            out, _ = batch_decode(stream)
        finally:
            pipeline.STAGES = None
        assert out.shape[0] > 0
        assert t.bytes["h2d"] > 0 and t.bytes["d2h"] > 0
        assert any(k.startswith("enc:") for k in t.totals)
        assert any(k.startswith("dec:") for k in t.totals)
        # the summary renders the link lines without error
        assert "link h2d" in t.summary() and "link d2h" in t.summary()
        # transfer_wait sums exactly the :h2d / :d2h stage families
        assert t.transfer_wait("d2h") == sum(
            v for k, v in t.totals.items() if k.endswith(":d2h"))


class TestEgrFetchPredictor:
    def test_underestimated_width_refetches_and_stays_byte_exact(self):
        """Force the EGR word-fetch predictor to undershoot: the column
        refetch path must heal it and the stream stays byte-identical."""
        from frad_python_tpu.parallel import pipeline

        pcm = rng.standard_normal((9999, 2)) * 0.4
        want = batch_encode(pcm, 1, 48000, 16, 2048)
        saved = dict(pipeline._WFETCH)
        try:
            pipeline._WFETCH.clear()
            # every key maps to the minimum bucket -> guaranteed undershoot
            got_full = batch_encode(pcm, 1, 48000, 16, 2048)  # seeds keys
            for k in list(pipeline._WFETCH):
                pipeline._WFETCH[k] = pipeline._WBUCKET
            got = batch_encode(pcm, 1, 48000, 16, 2048)
            relearned = dict(pipeline._WFETCH)
        finally:
            pipeline._WFETCH.clear()
            pipeline._WFETCH.update(saved)
        assert got_full == want
        assert got == want
        # and the predictor re-learned a sane width from the refetch run
        assert all(v > pipeline._WBUCKET for v in relearned.values())

    def test_capacity_hysteresis_is_stable_across_passes(self):
        """The learned word capacity keys a (heavy) jitted program; small
        content-driven flutter must NOT change it between passes — only
        undershoot (grow) or >2x slack (shrink) may."""
        from frad_python_tpu.parallel import pipeline

        pcm = rng.standard_normal((9999, 2)) * 0.4
        saved = dict(pipeline._WFETCH)
        try:
            pipeline._WFETCH.clear()
            batch_encode(pcm, 1, 48000, 16, 2048)           # learn
            learned = dict(pipeline._WFETCH)
            batch_encode(pcm, 1, 48000, 16, 2048)           # same content
            assert pipeline._WFETCH == learned              # no flutter
            # much smaller need (quiet content) within 2x slack: capacity
            # must hold; far below half: it may shrink
            batch_encode(pcm * 1e-4, 1, 48000, 16, 2048)
            for k in learned:
                assert pipeline._WFETCH[k] <= learned[k]
        finally:
            pipeline._WFETCH.clear()
            pipeline._WFETCH.update(saved)


class TestBatchRepair:
    """batch_repair must be byte-identical to the streaming Repairer."""

    def _stream_repair(self, stream, ratio=(96, 24)):
        from frad_python_tpu import Repairer
        rep = Repairer(ratio)
        return rep.process(stream) + rep.flush()

    @pytest.mark.parametrize("profile,bits,ecc", [
        (4, 64, False), (4, 64, True), (0, 24, False), (1, 16, True),
    ])
    def test_matches_streaming_repairer(self, profile, bits, ecc):
        from frad_python_tpu.parallel import batch_repair
        pcm = rng.standard_normal((6000, 2)) * 0.4
        stream = batch_encode(pcm, profile, 44100, bits, 512 if profile != 1
                              else 2048, enable_ecc=ecc)
        got = batch_repair(stream, (96, 24))
        want = self._stream_repair(stream, (96, 24))
        assert got == want

    def test_damaged_stream_and_junk_passthrough(self):
        from frad_python_tpu.container import head
        from frad_python_tpu.parallel import batch_repair
        pcm = rng.standard_normal((4000, 2)) * 0.4
        stream = bytearray(
            head.builder([("k", b"v")], b"")
            + batch_encode(pcm, 4, 44100, 64, 512, enable_ecc=True))
        stream[160] ^= 0xAA          # damage inside the first frame body
        stream = bytes(stream)
        got = batch_repair(stream, (48, 12))
        want = self._stream_repair(stream, (48, 12))
        assert got == want
        # and the repaired stream decodes clean without repair enabled
        out = stream_decode(got[got.find(b"\xff\xd0\xd2\x98"):], fix=False)
        np.testing.assert_array_equal(out, pcm)

    def test_mixed_profile_runs(self):
        from frad_python_tpu.parallel import batch_repair
        pcm = rng.standard_normal((4096, 2)) * 0.4
        s = (batch_encode(pcm, 0, 44100, 24, 512)
             + batch_encode(pcm, 1, 48000, 16, 2048, enable_ecc=True)
             + batch_encode(pcm, 4, 44100, 64, 512))
        got = batch_repair(s, (96, 24))
        want = self._stream_repair(s, (96, 24))
        assert got == want

    def test_bench_damage_model_repairs_clean(self):
        """The bench's deterministic damage (utils/damage.py) stays within
        RS correction capacity: repaired stream decodes identically to the
        undamaged one and matches the streaming Repairer byte-for-byte."""
        from frad_python_tpu.parallel import batch_repair
        from frad_python_tpu.utils.damage import damage_stream
        pcm = rng.standard_normal((16000, 2)) * 0.4
        stream = batch_encode(pcm, 1, 48000, 16, 2048, enable_ecc=True,
                              loss_level=0.5)
        damaged = damage_stream(stream)
        assert damaged != stream and len(damaged) == len(stream)
        got = batch_repair(damaged, (96, 24))
        assert got == self._stream_repair(damaged, (96, 24))
        out_r = stream_decode(got, fix=True)
        out_o = stream_decode(stream, fix=True)
        np.testing.assert_array_equal(out_r, out_o)

    def test_python_fallback_matches_native(self, monkeypatch):
        from frad_python_tpu import native
        from frad_python_tpu.parallel import batch_repair
        pcm = rng.standard_normal((3000, 2)) * 0.4
        stream = batch_encode(pcm, 4, 44100, 64, 512, enable_ecc=True)
        got_native = batch_repair(stream, (96, 24))
        monkeypatch.setattr(native, "has", lambda name: False)
        got_py = batch_repair(stream, (96, 24))
        assert got_native == got_py


class TestShardedCores:
    def setup_method(self, method):
        assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
        self.mesh = make_mesh(8)

    def test_p0_sharded_matches_single_device(self):
        # raw f64 DCT coefficients agree to the last ulp (XLA reassociates
        # the matmul reduction per batch partition; ~1e-16 noise); the
        # quantised integer outputs (P1 test below) are bit-exact.
        frames = rng.standard_normal((16, 1024, 2))
        want = np.asarray(batch.p0_encode_core(frames))
        got = sharded_p0_encode(self.mesh, frames)
        np.testing.assert_allclose(got, want, atol=1e-14, rtol=1e-13)
        back = sharded_p0_decode(self.mesh, got)
        np.testing.assert_allclose(back, np.asarray(batch.p0_decode_core(want)),
                                   atol=1e-14, rtol=1e-13)

    def test_p1_sharded_bit_exact(self):
        frames = rng.standard_normal((8, 2048, 2)) * 0.4
        factor = 2.0 ** 15
        want_f, want_t = batch.p1_encode_core(frames, 48000, 0.5, factor)
        got_f, got_t = sharded_p1_encode(self.mesh, frames, 48000, 0.5, factor)
        np.testing.assert_array_equal(got_f, np.asarray(want_f))
        np.testing.assert_array_equal(got_t, np.asarray(want_t))

        want_pcm = np.asarray(batch.p1_decode_core(
            np.asarray(want_f, dtype=np.float64),
            np.asarray(want_t, dtype=np.float64), 48000, factor))
        got_pcm = sharded_p1_decode(self.mesh, np.asarray(got_f, np.float64),
                                    np.asarray(got_t, np.float64), 48000, factor)
        # decoded floats carry last-ulp matmul reassociation noise
        np.testing.assert_allclose(got_pcm, want_pcm, atol=1e-12)

    def test_p2_sharded_bit_exact(self):
        from frad_python_tpu.parallel import sharded_p2_decode, sharded_p2_encode
        frames = rng.standard_normal((8, 2048, 2)) * 0.4
        factor = 2.0 ** 15
        want_f, want_t, want_l = batch.p2_encode_core(frames, 48000, 0.5, factor)
        got_f, got_t, got_l = sharded_p2_encode(self.mesh, frames, 48000, 0.5,
                                                factor)
        np.testing.assert_array_equal(got_f, np.asarray(want_f))
        np.testing.assert_array_equal(got_t, np.asarray(want_t))
        np.testing.assert_array_equal(got_l, np.asarray(want_l))

        want_pcm = np.asarray(batch.p2_decode_core(
            np.asarray(want_f, np.float64), np.asarray(want_t, np.float64),
            np.asarray(want_l, np.float64), 48000, factor))
        got_pcm = sharded_p2_decode(
            self.mesh, np.asarray(got_f, np.float64),
            np.asarray(got_t, np.float64), np.asarray(got_l, np.float64),
            48000, factor)
        # decoded floats carry last-ulp matmul reassociation noise
        np.testing.assert_allclose(got_pcm, want_pcm, atol=1e-12)

    def test_overlap_add_halo_exchange(self):
        frames = rng.standard_normal((16, 512, 2))
        cut = 512 * 15 // 16
        olap = 512 - cut
        want = np.asarray(batch.overlap_add_core(frames, olap, cut))
        got = overlap_add_sharded(self.mesh, frames, olap, cut)
        np.testing.assert_allclose(got, want, atol=1e-15)

    def test_pad_to_multiple(self):
        frames = rng.standard_normal((13, 64, 1))
        padded, pad = pad_to_multiple(frames, 8)
        assert padded.shape[0] == 16 and pad == 3
        np.testing.assert_array_equal(padded[:13], frames)
        assert not padded[13:].any()


class TestOverlapAddCore:
    def test_matches_streaming_decoder_semantics(self):
        """overlap_add_core must equal the sequential crossfade."""
        from frad_python_tpu.ops.window import crossfade, hanning_in_overlap

        frames = rng.standard_normal((5, 256, 2))
        r = 8
        cut = 256 * (r - 1) // r
        olap = 256 - cut
        got = np.asarray(batch.overlap_add_core(frames, olap, cut))

        frag = np.empty((0, 2))
        outs = []
        for i in range(5):
            f = frames[i].copy()
            if frag.size:
                f, _ = crossfade(f, frag, 0)
            frag = f[cut:]
            outs.append(f[:cut])
        want = np.stack(outs)
        np.testing.assert_allclose(got, want, atol=1e-15)


class TestI16SymbolUpload:
    def test_i16_symbols_decode_bit_identical_to_f32(self):
        """The decode upload ships EGR symbols as int16 when they fit
        (pipeline._decode_run); the core must produce bit-identical
        output to the f32 upload (the in-graph cast is exact)."""
        fq = rng.integers(-3000, 3000, (6, 2048, 2)).astype(np.float32)
        tq = rng.integers(0, 120, (6, 27, 2)).astype(np.float32)
        kw = dict(srate=48000, factor=float(1 << 15), olap=128, cut=1920,
                  i16=True)
        out_f, frag_f = batch.p1_decode_oa_core(fq, tq, **kw)
        out_i, frag_i = batch.p1_decode_oa_core(fq.astype(np.int16), tq, **kw)
        np.testing.assert_array_equal(np.asarray(out_f), np.asarray(out_i))
        np.testing.assert_array_equal(np.asarray(frag_f), np.asarray(frag_i))

    def test_pipeline_activates_i16_symbols_for_f32_decode(self, monkeypatch):
        """End-to-end: an f32 batch_decode of a P1 stream uploads int16
        symbols (when they fit int16) and still matches the f64 decode
        to transform precision."""
        from frad_python_tpu.parallel import pipeline

        seen = []
        orig = batch.p1_decode_oa_core

        def spy(fq, tq, *a, **k):
            seen.append(np.asarray(fq).dtype)
            return orig(fq, tq, *a, **k)

        monkeypatch.setattr(batch, "p1_decode_oa_core", spy)
        pcm = rng.standard_normal((48000, 2)) * 0.4
        stream = batch_encode(pcm, 1, 48000, 16, 2048)
        got, _ = batch_decode(stream, compute_dtype="float32")
        want, _ = batch_decode(stream)
        assert any(d == np.int16 for d in seen)
        assert got.shape == want.shape
        m = min(len(got), len(want))
        err = got[:m] - want[:m]
        snr = 10 * np.log10(np.sum(want[:m] ** 2) / max(np.sum(err ** 2), 1e-30))
        assert snr > 60  # f32-vs-f64 transform noise only


class TestQuantisedUploads:
    """The bench's f32 (GPU) path quantises the h2d PCM transfer (i16 lossy /
    i24 lossless) and fuses the P1 i16 encode with the on-device EGR
    pack into one jitted program (pipeline._p1_enc_egr_fused). On the
    8-device CPU mesh this also exercises the fused program SPMD."""

    def test_p1_i16_upload_fused_matches_unfused(self):
        from frad_python_tpu import native

        pcm = rng.standard_normal((44100 * 2, 2)) * 0.4
        fused = batch_encode(pcm, 1, 44100, 16, 2048,
                             compute_dtype="float32", i16_upload=True)
        # the unfused path over the same i16-quantised samples runs the
        # identical traced math (i16/32768 is exact in f32) — the fused
        # single-dispatch program must be byte-identical
        if native.has("frad_f64_to_i16"):
            q = native.f64_to_i16(pcm)
        else:
            q = np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int16)
        unfused = batch_encode(q.astype(np.float64) / 32768.0, 1, 44100, 16,
                               2048, compute_dtype="float32")
        assert fused == unfused
        out, _ = batch_decode(fused, compute_dtype="float32",
                              i16_transfer=True)
        m = min(len(out), len(pcm))
        err = out[:m] - pcm[:m]
        snr = 10 * np.log10(np.sum(pcm[:m] ** 2) / max(np.sum(err ** 2), 1e-30))
        assert snr > 10  # lossy profile at loss_level default

    def test_p0_i24_upload_roundtrip_noise_floor(self):
        pcm = np.clip(rng.standard_normal((44100, 2)) * 0.3, -0.97, 0.97)
        stream = batch_encode(pcm, 0, 44100, 24, 2048,
                              compute_dtype="float32", i24_upload=True)
        out, _ = batch_decode(stream, compute_dtype="float32",
                              i24_transfer=True)
        m = min(len(out), len(pcm))
        err = out[:m] - pcm[:m]
        snr = 10 * np.log10(np.sum(pcm[:m] ** 2) / max(np.sum(err ** 2), 1e-30))
        # f32 transform noise dominates (~-98 dB, matching the reference's
        # own 24-bit storage floor); the i24 transfer floor sits at -138 dB
        assert snr > 90


class TestChannelSharding:
    """SURVEY §2 N3: the per-channel transform chain shards over a 2-D
    (data, channel) mesh with zero communication."""

    def setup_method(self, method):
        from frad_python_tpu.parallel.sharded import make_mesh_2d
        assert len(jax.devices()) == 8
        self.mesh = make_mesh_2d(4, 2)

    def test_p1_encode_2d_mesh_bit_exact(self):
        frames = rng.standard_normal((8, 2048, 2)) * 0.4
        factor = 2.0 ** 15
        want_f, want_t = batch.p1_encode_core(frames, 48000, 0.5, factor)
        got_f, got_t = sharded_p1_encode(self.mesh, frames, 48000, 0.5, factor)
        np.testing.assert_array_equal(got_f, np.asarray(want_f))
        np.testing.assert_array_equal(got_t, np.asarray(want_t))

    def test_p0_roundtrip_2d_mesh(self):
        frames = rng.standard_normal((8, 1024, 4))
        got = sharded_p0_encode(self.mesh, frames)
        np.testing.assert_allclose(got, np.asarray(batch.p0_encode_core(frames)),
                                   atol=1e-14, rtol=1e-13)
        back = sharded_p0_decode(self.mesh, got)
        np.testing.assert_allclose(back, frames, atol=1e-12)

    def test_p2_encode_2d_mesh_bit_exact(self):
        from frad_python_tpu.parallel import sharded_p2_encode
        frames = rng.standard_normal((8, 2048, 2)) * 0.4
        factor = 2.0 ** 15
        want_f, want_t, want_l = batch.p2_encode_core(frames, 48000, 0.5, factor)
        got_f, got_t, got_l = sharded_p2_encode(self.mesh, frames, 48000, 0.5,
                                                factor)
        np.testing.assert_array_equal(got_f, np.asarray(want_f))
        np.testing.assert_array_equal(got_t, np.asarray(want_t))
        np.testing.assert_array_equal(got_l, np.asarray(want_l))

    def test_overlap_add_2d_mesh_matches_sequential(self):
        frames = rng.standard_normal((8, 512, 4))
        cut = 512 * 15 // 16
        olap = 512 - cut
        got = overlap_add_sharded(self.mesh, frames, olap, cut)
        want = np.asarray(batch.overlap_add_core(frames, olap, cut))
        np.testing.assert_allclose(got, want, atol=1e-15)

    def test_2d_mesh_encode_has_no_communication(self):
        """The compiled 2-D sharded encode core must be communication-free
        (channels never interact; frames never interact)."""
        from jax.sharding import NamedSharding
        from frad_python_tpu.parallel.sharded import _frame_spec
        import jax.numpy as jnp

        spec = NamedSharding(self.mesh, _frame_spec(self.mesh))
        frames = jax.device_put(
            rng.standard_normal((8, 1024, 2)).astype(np.float32), spec)
        fwd, _ = batch._mats(1024, frames.dtype)
        fn = jax.jit(
            lambda fr, ll, fc, m: batch._p1_encode_jit.__wrapped__(
                fr, 48000, ll, fc, m),
            in_shardings=(spec, None, None, None),
            out_shardings=(spec, spec))
        txt = fn.lower(frames, jnp.float32(0.5), jnp.float32(2.0 ** 15),
                       fwd).compile().as_text()
        comm = [op for op in ("collective-permute", "all-reduce",
                              "all-gather", "all-to-all") if op in txt]
        assert not comm, f"2-D sharded encode has communication: {comm}"
        # per-device block: 2 rows (8/4) and 1 channel (2/2)
        assert "f32[2,1024,1]" in txt


class TestMultihost:
    def test_host_spans_cover_stream_with_halo(self):
        from frad_python_tpu.parallel import multihost
        total, fsize, ratio = 100000, 2048, 16
        n = 2048
        olap = n - n * (ratio - 1) // ratio
        spans = [multihost.host_span(total, fsize, ratio, True, pid, 4)
                 for pid in range(4)]
        assert spans[0].start == 0
        assert spans[-1].stop == total
        for a, b in zip(spans, spans[1:]):
            # consecutive spans overlap by exactly the halo
            assert b.start == a.stop - olap

    def test_host_span_single_process(self):
        from frad_python_tpu.parallel import multihost
        s = multihost.host_span(5000, 512, 0, False, 0, 1)
        assert (s.start, s.stop, s.first_frame) == (0, 5000, 0)

    def test_gather_bitstream_single_process(self):
        from frad_python_tpu.parallel import multihost
        assert multihost.gather_bitstream(b"abc") == b"abc"

    def test_spanwise_encode_matches_global(self):
        """Per-host span encodes (final=False on non-last hosts)
        concatenated == single global encode, byte for byte."""
        from frad_python_tpu.parallel import multihost
        rng2 = np.random.default_rng(55)
        total, fsize, ratio = 40960, 2048, 16
        pcm = rng2.standard_normal((total, 2)) * 0.4
        ref = batch_encode(pcm, 1, 48000, 16, fsize, overlap_ratio=ratio)

        nproc = 4
        parts = []
        for pid in range(nproc):
            s = multihost.host_span(total, fsize, ratio, True, pid, nproc)
            parts.append(batch_encode(pcm[s.start:s.stop], 1, 48000, 16,
                                      fsize, overlap_ratio=ratio,
                                      final=pid == nproc - 1))
        assert b"".join(parts) == ref

    def test_spanwise_encode_matches_global_lossless(self):
        from frad_python_tpu.parallel import multihost
        rng2 = np.random.default_rng(56)
        total, fsize = 13000, 512   # non-aligned: last host owns the tail
        pcm = rng2.standard_normal((total, 1)) * 0.4
        ref = batch_encode(pcm, 0, 44100, 24, fsize)
        parts = []
        for pid in range(3):
            s = multihost.host_span(total, fsize, 0, False, pid, 3)
            parts.append(batch_encode(pcm[s.start:s.stop], 0, 44100, 24,
                                      fsize, final=pid == 2))
        assert b"".join(parts) == ref

    def test_gather_bitstream_two_processes(self, tmp_path):
        """Run the REAL allgather branch (multihost.py) under a 2-process
        jax.distributed CPU cluster (SURVEY §4.7): each process encodes
        its host_span and process 0 assembles the stream, ordered by
        HostSpan.first_frame. Must byte-equal the single-host encode."""
        import subprocess
        import sys

        script = tmp_path / "worker.py"
        out = tmp_path / "stream.bin"
        script.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
pid = int(sys.argv[1])
jax.distributed.initialize('localhost:{{port}}'.format(port=sys.argv[2]),
                           num_processes=2, process_id=pid)
import numpy as np
from frad_python_tpu.parallel import batch_encode, multihost
rng = np.random.default_rng(99)
pcm = rng.standard_normal((20480, 2)) * 0.4
span = multihost.host_span(len(pcm), 2048, 16, True)
part = batch_encode(pcm[span.start:span.stop], 1, 48000, 16, 2048,
                    overlap_ratio=16, final=pid == 1)
full = multihost.gather_bitstream(part, order_key=span.first_frame)
if pid == 0:
    open({str(out)!r}, 'wb').write(full)
""")
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # 1 device per process is enough
        procs = [subprocess.Popen([sys.executable, str(script), str(i), str(port)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
                 for i in range(2)]
        try:
            for p in procs:
                _, err = p.communicate(timeout=240)
                if p.returncode != 0:
                    pytest.skip(f"jax.distributed CPU cluster unavailable: "
                                f"{err.decode()[-400:]}")
        finally:
            for p in procs:
                p.kill()

        rng2 = np.random.default_rng(99)
        pcm = rng2.standard_normal((20480, 2)) * 0.4
        ref = batch_encode(pcm, 1, 48000, 16, 2048, overlap_ratio=16)
        assert out.read_bytes() == ref

    def test_gather_bitstream_uneven_spans_two_processes(self, tmp_path):
        """Ragged gather with STRONGLY uneven spans (64 B vs 5 MiB —
        several KV chunks) and reversed order keys: the big stream must
        cross the chunking path intact and land FIRST in the assembly.
        Two consecutive gathers prove the generation keying."""
        import subprocess
        import sys

        script = tmp_path / "worker.py"
        out = tmp_path / "gathered.bin"
        script.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import jax
jax.config.update('jax_platforms', 'cpu')
pid = int(sys.argv[1])
jax.distributed.initialize('localhost:{{port}}'.format(port=sys.argv[2]),
                           num_processes=2, process_id=pid)
import numpy as np
from frad_python_tpu.parallel import multihost
small = bytes(range(64))
big = np.random.default_rng(5).integers(0, 256, (5 << 20) + 13,
                                        dtype=np.uint8).tobytes()
mine, key = (small, 7) if pid == 0 else (big, 3)   # big sorts FIRST
full = multihost.gather_bitstream(mine, order_key=key)
again = multihost.gather_bitstream(mine, order_key=key)
if pid == 0:
    assert full == again
    open({str(out)!r}, 'wb').write(full)
""")
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        procs = [subprocess.Popen([sys.executable, str(script), str(i), str(port)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
                 for i in range(2)]
        try:
            for p in procs:
                _, err = p.communicate(timeout=240)
                if p.returncode != 0:
                    pytest.skip(f"jax.distributed CPU cluster unavailable: "
                                f"{err.decode()[-400:]}")
        finally:
            for p in procs:
                p.kill()

        big = np.random.default_rng(5).integers(0, 256, (5 << 20) + 13,
                                                dtype=np.uint8).tobytes()
        assert out.read_bytes() == big + bytes(range(64))

    def test_gather_fallback_chunk_slicing(self):
        """_gather_allgather_chunked reassembles ragged lengths across
        chunk boundaries (single-process identity allgather)."""
        from frad_python_tpu.parallel import multihost
        data = bytes(np.random.default_rng(3).integers(
            0, 256, 10_000, dtype=np.uint8))
        got = multihost._gather_allgather_chunked(data, key=0,
                                                  chunk_bytes=999)
        assert got == data
        assert multihost._gather_allgather_chunked(b"", 0, 999) == b""


class TestProfile2Batch:
    def test_p2_batch_encode_byte_exact_vs_streaming(self):
        rng2 = np.random.default_rng(77)
        pcm = rng2.standard_normal((9000, 2)) * 0.4
        from frad_python_tpu.models import profile2

        # streaming via engine is not possible (profile 2 not AVAILABLE,
        # matching the reference); compare against the per-frame kernel
        ref_frames = []
        frames, terms = plan_frames(len(pcm), 2048, 16, True)
        frag = 0
        for s, ln in frames:
            fr = np.zeros((ln, 2))
            s0 = max(s, 0)
            fr[s0 - s: ln] = pcm[s0: s + ln]
            payload, bdi, chn, sr = profile2.analogue(fr, 16, 48000, 0.5)
            ref_frames.append(payload)

        got = batch_encode(pcm, 2, 48000, 16, 2048, overlap_ratio=16)
        # every reference per-frame payload must appear in order
        pos = 0
        for pl_bytes in ref_frames:
            idx = got.find(pl_bytes, pos)
            assert idx >= 0
            pos = idx + len(pl_bytes)

    def test_p2_batch_roundtrip(self):
        rng2 = np.random.default_rng(78)
        t = np.arange(12000) / 48000
        pcm = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                        0.5 * np.sin(2 * np.pi * 660 * t)], 1)
        stream = batch_encode(pcm, 2, 48000, 16, 2048, overlap_ratio=16,
                              loss_level=0.125)
        got, srate = batch_decode(stream)
        ref = stream_decode(stream)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-9)
        m = min(len(pcm), len(got))
        snr = 10 * np.log10(np.sum(pcm[:m] ** 2)
                            / np.sum((pcm[:m] - got[:m]) ** 2))
        assert snr > 15


class TestBatchDecodeFormatChange:
    def test_remainder_on_crit(self):
        rng3 = np.random.default_rng(91)
        a = rng3.standard_normal((4096, 2)) * 0.4
        b = rng3.standard_normal((3000, 1)) * 0.4
        s1 = batch_encode(a, 4, 44100, 64, 512)
        s2 = batch_encode(b, 4, 48000, 64, 512)
        stream = s1 + s2

        pcm1, sr1, rest = batch_decode(stream, return_remainder=True)
        assert pcm1.shape == (4096, 2) and sr1 == 44100
        np.testing.assert_array_equal(pcm1, a)
        assert rest
        pcm2, sr2, rest2 = batch_decode(rest, return_remainder=True)
        assert pcm2.shape == (3000, 1) and sr2 == 48000
        np.testing.assert_array_equal(pcm2, b)
        assert rest2 == b""

    def test_mixed_ecc_ratio_stream(self):
        """A mid-stream ECC ratio change must split the batched run:
        _decode_run unarmors a whole run with h0's (dsize, codesize), so
        grouping (96,24) and (48,12) frames together corrupts every
        frame after the switch (round-3 regression)."""
        rng3 = np.random.default_rng(92)
        pcm = rng3.standard_normal((8192, 2)) * 0.4
        stream = (batch_encode(pcm, 4, 44100, 16, 512, enable_ecc=True,
                               ecc_ratio=(96, 24))
                  + batch_encode(pcm, 4, 44100, 16, 512, enable_ecc=True,
                                 ecc_ratio=(48, 12)))
        want = stream_decode(stream, fix=True)
        got, sr = batch_decode(stream, fix_error=True)
        assert sr == 44100
        np.testing.assert_array_equal(got, want)


class TestP0DeviceFastPath:
    """The fused device pack/unpack fast path (compute_dtype='float32',
    bits in 16/24/32) must emit byte-identical streams and PCM to the
    generic host-packed path."""

    @pytest.mark.parametrize("bits", [16, 24, 32])
    def test_stream_and_pcm_match_generic_path(self, bits, monkeypatch):
        from frad_python_tpu.ops import bitpack
        from frad_python_tpu.parallel import batch_decode, batch_encode

        r = np.random.default_rng(7)
        pcm = (0.4 * np.sin(2 * np.pi * 440 * np.arange(3 * 2048) / 44100)[:, None]
               * np.ones((1, 2)) + 0.01 * r.standard_normal((3 * 2048, 2)))
        fast = batch_encode(pcm, 0, 44100, bits, 1024, compute_dtype="float32")
        out_fast, _ = batch_decode(fast, compute_dtype="float32")
        monkeypatch.setattr(bitpack, "TRUNC_DEVICE_BITS", ())
        ref = batch_encode(pcm, 0, 44100, bits, 1024, compute_dtype="float32")
        out_ref, _ = batch_decode(fast, compute_dtype="float32")
        assert fast == ref
        np.testing.assert_array_equal(np.asarray(out_fast, np.float64),
                                      np.asarray(out_ref, np.float64))

    def test_i24_transfer_quantisation_bound(self):
        from frad_python_tpu.parallel import batch_decode, batch_encode

        r = np.random.default_rng(8)
        pcm = np.clip(0.3 * r.standard_normal((4096, 2)), -1, 1)
        s = batch_encode(pcm, 0, 44100, 24, 1024, compute_dtype="float32")
        o_f32, _ = batch_decode(s, compute_dtype="float32")
        o_i24, _ = batch_decode(s, compute_dtype="float32", i24_transfer=True)
        assert o_f32.shape == o_i24.shape
        assert np.max(np.abs(o_f32 - o_i24)) < 2.0 ** -23

    def test_escalation_falls_back_to_generic_path(self, monkeypatch):
        """A frame whose f32 DCT coefficients exceed the f16 container max
        (bits=16) must escalate exactly like the host path — the device
        fast path detects it via the fused maxabs and defers."""
        from frad_python_tpu.ops import bitpack
        from frad_python_tpu.parallel import batch_decode, batch_encode

        pcm3 = np.full((4096, 1), 7e4)  # DCT DC coeff ~7e4 > f16 max 65504
        fast = batch_encode(pcm3, 0, 44100, 16, 2048, compute_dtype="float32")
        monkeypatch.setattr(bitpack, "TRUNC_DEVICE_BITS", ())
        ref = batch_encode(pcm3, 0, 44100, 16, 2048, compute_dtype="float32")
        monkeypatch.undo()
        assert fast == ref
        out, _ = batch_decode(fast, compute_dtype="float32")
        # escalated frames decode losslessly at the deeper container
        np.testing.assert_allclose(out[: len(pcm3)], pcm3, rtol=1e-3)


class TestLongStreamScale:
    def test_minute_scale_stream_with_damage_and_repair(self):
        """BASELINE config 5 at CI scale: a 60 s 48 kHz stereo stream
        (~1.5k frames) through the sharded batch pipeline with ECC,
        damaged within RS capacity, re-armored, and decoded — output
        must equal the clean stream's decode, and the streaming
        engines must agree with the batch path on the same bytes."""
        from frad_python_tpu import Decoder
        from frad_python_tpu.parallel import batch_repair
        from frad_python_tpu.utils.damage import damage_stream

        t = np.arange(60 * 48000) / 48000.0
        pcm = np.stack([0.4 * np.sin(2 * np.pi * 220 * t),
                        0.4 * np.sin(2 * np.pi * 331 * t)], axis=1) \
            + 0.005 * rng.standard_normal((len(t), 2))
        stream = batch_encode(pcm, 1, 48000, 16, 2048, enable_ecc=True,
                              overlap_ratio=16, loss_level=0.5)
        nframes = stream.count(b"\xff\xd0\xd2\x98")
        assert nframes > 1400

        damaged = damage_stream(stream)
        repaired = batch_repair(damaged, (96, 24))
        out_clean, sr = batch_decode(stream, fix_error=True)
        out_rep, _ = batch_decode(repaired, fix_error=True)
        assert sr == 48000
        np.testing.assert_array_equal(out_rep, out_clean)

        # streaming decoder over the repaired megastream, fed in 1 MiB
        # chunks, agrees with the batch decode to the documented bound
        d = Decoder(fix_error=True)
        parts = [d.process(repaired[i:i + (1 << 20)]).pcm
                 for i in range(0, len(repaired), 1 << 20)]
        parts.append(d.flush().pcm)
        got = np.concatenate([p for p in parts if p.size])
        assert got.shape == out_clean.shape
        np.testing.assert_allclose(got, out_clean, atol=1e-12)
