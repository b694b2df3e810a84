"""chip_smoke.py: its compare helpers and phases at tiny size on the CPU,
its refusal to run without a GPU, and — marked `gpu` — the same phases at
real widths, which skip here and run on the card (`python chip_smoke.py`
runs them as one command)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def f32_policy(monkeypatch):
    """The GPU's f32 policy on the CPU rig."""
    from frad_python_tpu.ops import policy

    monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", "float32")
    policy.compute_dtype.cache_clear()
    yield
    policy.compute_dtype.cache_clear()


class TestHelpers:
    def test_rel_err_vs_peak_is_per_row(self):
        ref = np.array([[1.0, -4.0], [0.01, 0.02]])
        got = ref + np.array([[0.04, 0.0], [0.0, 0.0002]])
        # row 0: 0.04/4, row 1: 0.0002/0.02 -> the worst row wins
        assert cs.rel_err_vs_peak(got, ref) == pytest.approx(0.01)

    def test_symbol_diff(self):
        share, mx = cs.symbol_diff([1, 2, 3, 4], [1, 3, 3, 2])
        assert share == 0.5 and mx == 2
        assert cs.symbol_diff(np.zeros(5), np.zeros(5)) == (0.0, 0)

    @pytest.mark.parametrize("bits,mant", [(16, 10), (24, 15), (32, 23)])
    def test_lossless_tol_is_one_container_ulp(self, bits, mant):
        assert cs.lossless_tol(bits, 0.5) == 0.5 * 2.0 ** -mant

    def test_frames_differing(self):
        s = cs.FRM_SIGN
        a = b"hd" + s + b"aa" + s + b"bb" + s + b"cc"
        b = b"hd" + s + b"aa" + s + b"bX" + s + b"cc"
        assert cs.frames_differing(a, b) == (1, 3)
        assert cs.frames_differing(a, a) == (0, 3)

    def test_dct_matmul_tol_grows_with_sqrt_n(self):
        assert cs.dct_matmul_tol(8192) == pytest.approx(
            2 * cs.dct_matmul_tol(2048))

    def test_checks_collects_failures(self, capsys):
        ck = cs.Checks()
        assert ck.check("a", True, 1, 2, "why")
        assert not ck.check("b", False, 3, 2, "why")
        assert ck.passed == 1 and ck.failed == ["b"]
        out = capsys.readouterr().out
        assert "[PASS] a: 1 (bound 2: why)" in out and "[FAIL] b" in out


def test_phase_kernels_small_under_f32_policy(f32_policy):
    """Phase 1 at tiny widths: the card's f32 path, emulated on the CPU,
    against the plain references."""
    ck = cs.Checks()
    cs.phase_kernels(ck, small=True)
    assert not ck.failed, ck.failed
    assert ck.passed >= 20


def test_phase_four_on_virtual_devices():
    """Phase 3 at tiny size on the 8-device virtual CPU mesh (conftest)."""
    import jax

    ck = cs.Checks()
    cs.phase_four(ck, seconds=3.0, ndev=len(jax.devices()))
    assert not ck.failed, ck.failed


def test_exits_nonzero_without_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, never at
    import, so every xdist worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


@pytest.mark.gpu
def test_gpu_phase_kernels(gpu):
    ck = cs.Checks()
    cs.phase_kernels(ck)
    assert not ck.failed, ck.failed


@pytest.mark.gpu
def test_gpu_phase_main_path(gpu):
    ck = cs.Checks()
    cs.phase_main_path(ck)
    assert not ck.failed, ck.failed
