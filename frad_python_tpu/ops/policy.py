"""Platform-aware compute policy.

Every policy that depends on the machine reads ONE decision, `platform()`:
the platform of the default JAX device, `"cpu"` or `"gpu"`. Any other
platform is refused.

* CPU computes in float64: the FrAD container stores up to 64-bit floats,
  and the f64 transforms keep the batch and streaming paths byte-exact.
* GPU computes in float32: the accelerator design the batched cores, the
  on-device EGR / truncated-float packers, the i16/i24 uploads and the
  data-parallel sharding in `models.batch.place_rows` are built for. f32
  exceeds the precision of the commonly used stream depths (<= 24-bit).

Archival depths (48/64-bit) always get the f64 transform; on a GPU it
runs on the host CPU backend (`deep_device`).

Override the dtype with FRAD_TPU_COMPUTE_DTYPE=float64|float32.
"""

from __future__ import annotations

import functools
import os

#: platforms this engine runs on
PLATFORMS = ("cpu", "gpu")


def platform() -> str:
    """Platform of the default JAX device: 'cpu' or 'gpu' (else raises)."""
    import jax

    p = jax.devices()[0].platform
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: frad_python_tpu runs on "
            f"{' or '.join(PLATFORMS)}")
    return p


@functools.lru_cache(maxsize=1)
def compute_dtype() -> str:
    env = os.environ.get("FRAD_TPU_COMPUTE_DTYPE")
    if env:
        return env
    return "float64" if platform() == "cpu" else "float32"


#: container depths >= this exceed f32 transform precision (f32 carries a
#: 24-bit mantissa; the 48/64-bit containers store 36/52 mantissa bits —
#: a truncated f64 keeps sign(1) + exponent(11) + 36 mantissa bits)
DEEP_BITS = 48


@functools.lru_cache(maxsize=1)
def lossy_matmul_precision():
    """Matmul precision for the LOSSY (P1/P2) transform matmuls.

    HIGHEST on every platform. On a GPU, DEFAULT for an f32 dot means
    TF32 (about three decimal digits), which would move the masking
    thresholds and their quantised ints away from the CPU's; whether a
    lower precision is worth its quality cost is an open measurement.
    f32/f64 dots on the CPU have no reduced-precision mode.

    Override with FRAD_TPU_LOSSY_PRECISION=default|high|highest
    (resolved once per process at first compile).
    """
    from jax import lax

    name = os.environ.get("FRAD_TPU_LOSSY_PRECISION", "").lower()
    table = {"default": lax.Precision.DEFAULT,
             "high": lax.Precision.HIGH,
             "highest": lax.Precision.HIGHEST}
    return table.get(name, lax.Precision.HIGHEST)


def transform_dtype(bits: int) -> str:
    """Dtype for a LOSSLESS transform targeting a `bits`-deep container.

    Deep containers (48/64-bit) always get the f64 transform — archival
    exactness is the product contract at those depths (north star:
    bit-exact lossless; SURVEY §7 hard part (b)), so on a GPU the call
    site runs the program on the host CPU via `deep_device()` rather than
    accept f32 transform noise (~1e-7 relative). Depths <= 32 fit inside
    f32's mantissa and keep the platform's dtype.
    """
    return "float64" if bits >= DEEP_BITS else compute_dtype()


def deep_device():
    """Context manager placing jit execution on the host CPU backend.

    Used around the archival f64 transforms, which therefore always run
    on the host (the route bench.py and chip_smoke.py label
    `route=host`). A no-op on a CPU platform.
    Streams produced under this context are byte-identical to the
    CPU-platform encoder's by construction — same program, same device
    kind.
    """
    import contextlib

    import jax

    if platform() == "cpu":
        return contextlib.nullcontext()
    return jax.default_device(jax.devices("cpu")[0])
