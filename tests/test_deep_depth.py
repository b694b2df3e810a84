"""Archival (48/64-bit) lossless depths always get the f64 transform.

SURVEY §7 hard part (b): the f32 compute dtype a GPU uses carries ~1e-7
transform noise — unacceptable for containers that store 36/52 mantissa
bits. policy.transform_dtype routes deep depths to the f64 program, run
on the host CPU backend (policy.deep_device), so deep-depth streams are
byte-identical across platforms. These tests simulate the GPU policy by
forcing compute dtype / the pipeline's `compute_dtype="float32"` argument
on the CPU rig.
"""

import numpy as np
import pytest

from frad_python_tpu.models import profile0
from frad_python_tpu.ops import policy
from frad_python_tpu.parallel import batch_decode, batch_encode

rng = np.random.default_rng(21)


@pytest.fixture
def f32_policy(monkeypatch):
    """Simulate the GPU's compute-dtype policy on the CPU rig."""
    monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", "float32")
    policy.compute_dtype.cache_clear()
    yield
    policy.compute_dtype.cache_clear()


def _pcm(frames=6, n=512, ch=2):
    return rng.standard_normal((frames * n, ch)) * 0.5


class TestStreamingDeepDepth:
    @pytest.mark.parametrize("bits", [48, 64])
    def test_payload_identical_to_f64_policy(self, f32_policy, bits):
        pcm = _pcm(1)[:512]
        frad32, bdi32, *_ = profile0.analogue(pcm, bits, 44100, False)
        policy.compute_dtype.cache_clear()
        import os

        del os.environ["FRAD_TPU_COMPUTE_DTYPE"]
        frad64, bdi64, *_ = profile0.analogue(pcm, bits, 44100, False)
        assert frad32 == frad64 and bdi32 == bdi64
        back = profile0.digital(frad32, bdi32, 2, False)
        err = back - pcm
        snr = 10 * np.log10(np.sum(pcm**2) / max(np.sum(err**2), 1e-300))
        assert snr > (195 if bits == 48 else 250)

    def test_shallow_depths_keep_f32_under_f32_policy(self, f32_policy):
        pcm = _pcm(1)[:512]
        frad, bdi, *_ = profile0.analogue(pcm, 24, 44100, False)
        back = profile0.digital(frad, bdi, 2, False)
        # f32 transform noise visible but bounded (24-bit container regime)
        assert 90 < 10 * np.log10(np.sum(pcm**2) / np.sum((back - pcm) ** 2)) < 200

    def test_escalation_through_f32_overflow(self, f32_policy):
        # coefficients beyond f32 range: the f32 transform sees inf; the
        # deep recompute must kick in and escalate 32 -> 48 losslessly
        pcm = np.full((256, 1), 1e39)
        frad, bdi, *_ = profile0.analogue(pcm, 32, 44100, False)
        assert profile0.DEPTHS[bdi] == 48
        back = profile0.digital(frad, bdi, 1, False)
        np.testing.assert_allclose(back, pcm, rtol=1e-9)


class TestHostArchivalRoute:
    """Archival (48/64-bit) transforms run on the host CPU backend
    (policy.deep_device). On a GPU platform that is a real placement
    change; these tests simulate the GPU platform decision on the CPU
    rig and check that archival work lands on the CPU device."""

    @pytest.fixture
    def gpu_platform(self, monkeypatch):
        """Simulate the GPU platform decision (deep_device then pins
        the CPU device explicitly instead of being a no-op)."""
        monkeypatch.setattr(policy, "platform", lambda: "gpu")

    @pytest.fixture
    def host_calls(self, monkeypatch):
        """Count entries into the host route."""
        calls = []
        orig = policy.deep_device

        def spy():
            calls.append(1)
            return orig()

        monkeypatch.setattr(policy, "deep_device", spy)
        return calls

    def test_oversize_frames_stay_on_host(self, gpu_platform, host_calls):
        """A 48-bit frame beyond the matmul matrix cap takes the host f64
        FFT route and keeps archival quality."""
        from frad_python_tpu.ops.dct import MATMUL_MAX_N
        pcm = _pcm(1, MATMUL_MAX_N + 2048, 1)[: MATMUL_MAX_N + 2048]
        frad, bdi, *_ = profile0.analogue(pcm, 48, 44100, False)
        back = profile0.digital(frad, bdi, 1, False)
        assert len(host_calls) == 2          # forward + inverse
        err = back - pcm
        snr = 10 * np.log10(np.sum(pcm**2) / max(np.sum(err**2), 1e-300))
        assert snr > 195

    def test_escalation_into_48_stays_on_host(self, f32_policy, gpu_platform,
                                              host_calls):
        # f32 overflow escalates 32 -> 48 with content BEYOND the f32
        # range: the redo must take the host real-f64 route and still
        # escalate + round-trip losslessly.
        pcm = np.full((512, 1), 1e39)
        frad, bdi, *_ = profile0.analogue(pcm, 32, 44100, False)
        assert profile0.DEPTHS[bdi] == 48
        assert len(host_calls) == 1          # the archival redo only
        back = profile0.digital(frad, bdi, 1, False)
        np.testing.assert_allclose(back, pcm, rtol=1e-9)

    def test_deep_device_pins_cpu_on_gpu_platform(self, gpu_platform):
        import jax
        import jax.numpy as jnp
        with policy.deep_device():
            x = jnp.ones(4) * 2.0
        assert x.devices() == {jax.devices("cpu")[0]}


class TestPipelineDeepDepth:
    @pytest.mark.parametrize("bits", [48, 64])
    def test_stream_identical_to_f64_pipeline(self, bits):
        pcm = _pcm()
        s32 = batch_encode(pcm, 0, 44100, bits, 512, compute_dtype="float32")
        s64 = batch_encode(pcm, 0, 44100, bits, 512, compute_dtype=None)
        assert s32 == s64
        out32, _ = batch_decode(s32, compute_dtype="float32")
        out64, _ = batch_decode(s32, compute_dtype=None)
        np.testing.assert_array_equal(out32, out64)

    def test_pipeline_escalation_recompute(self):
        pcm = _pcm(4, 512, 1)
        pcm[600:700] = 1e39  # one loud region -> f32 inf -> deep recompute
        s32 = batch_encode(pcm, 0, 44100, 32, 512, compute_dtype="float32")
        s64 = batch_encode(pcm, 0, 44100, 32, 512, compute_dtype=None)
        assert s32 == s64
        out, _ = batch_decode(s32)
        # quiet frames stay in the 32-bit container (f32-grade noise);
        # the escalated loud frame must carry f64-grade relative precision
        # (its quiet samples are drowned by frame-relative container
        # noise — inherent to float storage, same as the reference)
        np.testing.assert_allclose(out[:512], pcm[:512], rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(out[1024:], pcm[1024:], rtol=2e-6, atol=1e-7)
        # 48-bit container noise accumulated over the IDCT sum (~2^-37 per
        # coefficient x sqrt(N)); the f32 path would have produced inf here
        np.testing.assert_allclose(out[600:700], pcm[600:700], rtol=1e-7)
        assert np.all(np.isfinite(out))
