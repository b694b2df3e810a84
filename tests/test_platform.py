"""Platform policy (ops/policy.py), explicit matmul precision in the cores,
the unchunked FFT transforms, the compile-cache location and bench.py's
device tables — everything the GPU port decides, checked on the CPU."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from scipy.fft import dct as sdct, idct as sidct

from frad_python_tpu.ops import policy

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402


@pytest.fixture
def fresh_policy():
    policy.compute_dtype.cache_clear()
    policy.lossy_matmul_precision.cache_clear()
    yield
    policy.compute_dtype.cache_clear()
    policy.lossy_matmul_precision.cache_clear()


@pytest.fixture(params=["cpu", "gpu"])
def platform(request, monkeypatch, fresh_policy):
    monkeypatch.delenv("FRAD_TPU_COMPUTE_DTYPE", raising=False)
    monkeypatch.delenv("FRAD_TPU_LOSSY_PRECISION", raising=False)
    monkeypatch.setattr(policy, "platform", lambda: request.param)
    return request.param


class TestPlatformPolicy:
    def test_compute_dtype(self, platform):
        want = {"cpu": "float64", "gpu": "float32"}[platform]
        assert policy.compute_dtype() == want

    def test_lossy_precision_is_highest(self, platform):
        # DEFAULT would be TF32 on a GPU
        assert policy.lossy_matmul_precision() == lax.Precision.HIGHEST

    def test_archival_route_is_host(self, platform):
        assert policy.transform_dtype(48) == "float64"
        assert policy.transform_dtype(64) == "float64"
        with policy.deep_device():
            x = jnp.arange(4.0) * 2.0
        assert x.devices() == {jax.devices("cpu")[0]}

    def test_real_platform_is_cpu_here(self):
        assert policy.platform() == "cpu"

    def test_unknown_platform_raises(self, monkeypatch):
        class Dev:
            platform = "neuron"

        monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            policy.platform()


def _dots(jaxpr):
    """Every dot_general equation in a (closed) jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dots(inner)


CORES = ("p0_encode", "p0_decode", "p0_encode_pack", "p1_encode",
         "p1_decode_oa", "p2_encode", "p2_decode")


def _core_jaxpr(core: str):
    from frad_python_tpu.models import batch
    from frad_python_tpu.ops.dct import _dct_matrices

    b, n, c = 2, 256, 2
    x = jnp.zeros((b, n, c), jnp.float32)
    t = jnp.zeros((b, 27, c), jnp.float32)
    lq = jnp.zeros((b, 13, c), jnp.float32)
    fwd, inv = (jnp.asarray(m) for m in _dct_matrices(n, "float32"))
    s = jnp.float32(0.5)
    mk = jax.make_jaxpr
    return {
        "p0_encode": lambda: mk(batch._p0_encode_jit)(x, fwd),
        "p0_decode": lambda: mk(batch._p0_decode_jit)(x, inv),
        "p0_encode_pack": lambda: mk(batch._p0_encode_pack_jit,
                                     static_argnums=(1, 2))(x, 24, False, fwd),
        "p1_encode": lambda: mk(batch._p1_encode_jit, static_argnums=(1,))(
            x, 48000, s, s, fwd),
        "p1_decode_oa": lambda: mk(batch._p1_decode_oa_jit,
                                   static_argnums=(2, 4, 5, 6))(
            x, t, 48000, s, 16, 240, True, inv),
        "p2_encode": lambda: mk(batch._p2_encode_jit, static_argnums=(1,))(
            x, 48000, s, s, fwd),
        "p2_decode": lambda: mk(batch._p2_decode_jit, static_argnums=(3,))(
            x, t, lq, 48000, s, inv),
    }[core]().jaxpr


@pytest.mark.parametrize("core", CORES)
def test_every_dot_has_explicit_precision(core):
    """No f32 dot on the lossy or lossless path may be left to the
    platform default (TF32 on a GPU)."""
    dots = list(_dots(_core_jaxpr(core)))
    assert dots, f"{core}: no dot_general found"
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(p is not None for p in prec), \
            f"{core}: dot_general without explicit precision"
        assert set(prec) == {lax.Precision.HIGHEST}, f"{core}: {prec}"


class TestUnchunkedFFT:
    """The FFT path runs jnp.fft over the whole batch (the 256-row
    chunking workaround is gone): check it above 256 rows."""

    @pytest.mark.parametrize("dtype,n,tol", [(np.float32, 9000, 1e-6),
                                             (np.float64, 1024, 1e-12)])
    def test_forward_and_inverse_vs_scipy(self, dtype, n, tol):
        from frad_python_tpu.ops.dct import dct2_forward, idct2_forward, use_matmul

        assert not use_matmul(n, dtype)
        rng = np.random.default_rng(5)
        x = rng.standard_normal((300, n))
        ref = sdct(x, norm="forward", axis=-1)
        got = np.asarray(dct2_forward(x.astype(dtype)), np.float64)
        peak = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(got - ref) / peak).max() <= tol
        back = np.asarray(idct2_forward(ref.astype(dtype)), np.float64)
        refi = sidct(ref, norm="forward", axis=-1)
        peak = np.abs(refi).max(axis=1, keepdims=True)
        assert (np.abs(back - refi) / peak).max() <= tol


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is
    the fixed <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "FRAD_TPU_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(tmp_path / "cc") if env_dir else str(REPO / ".jax_cache")
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c", "import jax, frad_python_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.strip().splitlines()[-1] == want


class TestBenchTables:
    def test_h100_peaks(self):
        p = bench.peak_tflops("NVIDIA H100 80GB HBM3")
        assert p == {"bf16": 989.0, "tf32": 495.0, "fp32": 67.0, "fp64": 67.0}

    def test_unknown_device_raises(self):
        with pytest.raises(ValueError, match="no peak rates"):
            bench.peak_tflops("Some Accelerator 9000")

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_cell_kwargs_follow_dtype(self, dtype):
        f32 = dtype == "float32"
        enc, dec = bench.cell_kwargs(bench.CONFIGS["p0_stereo_44k1"], dtype)
        assert enc["compute_dtype"] == dtype and dec["compute_dtype"] == dtype
        assert enc["i24_upload"] is f32 and not enc["i16_upload"]
        enc, _ = bench.cell_kwargs(bench.CONFIGS["p1_stereo_44k1"], dtype)
        assert enc["i16_upload"] is f32 and not enc["i24_upload"]

    def test_routes(self):
        assert {n: bench.route(c) for n, c in bench.CONFIGS.items()
                if bench.route(c) != "device"} == {
            "p4_mono_44k1": "none", "p0_stereo_48b": "host",
            "p0_stereo_64b": "host"}

    def test_refuses_cpu(self):
        out = subprocess.run([sys.executable, "bench.py", "p4_mono_44k1"],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=120,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert out.returncode != 0
        assert "only the CPU" in out.stderr
        assert out.stdout == ""
