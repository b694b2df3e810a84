"""frad_python_tpu — FrAD (Fourier Analogue-in-Digital) engine in JAX.

A from-scratch JAX/XLA implementation of the FrAD archival streaming
audio codec with full capability parity to the reference Python
implementation (H4n-uL/FrAD_Python), re-architected for an accelerator:

* batched tensor pipeline (DCT / masking / quantisation) as fused
  jitted cores on the default device (a GPU, or the host CPU)
* vectorised byte-domain kernels + C++ native module on the host
* `parallel/` shards frame batches over a `jax.sharding.Mesh` with a
  ring halo exchange for overlap state

Public API mirrors the reference `libfrad` package
(src/libfrad/__init__.py): Encoder/Decoder/Repairer engines, ASFH,
head builder/parser, profile tables, and PCM format helpers.
"""

from __future__ import annotations

import os

# Determinism pin for the CPU-backend f64 transforms: XLA:CPU's DUCC FFT
# custom call plans by the number of pool threads AVAILABLE at call time,
# and the plan changes the rounding of every output element — the same
# program on the same bytes returns one of two ~1-ulp-apart results
# run to run (measured 11-56/60 flips on a 2-vCPU host; fan-out of the
# r4 advisor's "decoded PCM nondeterministic for identical input"
# finding). The reference decoder is exactly deterministic
# (src/libfrad/decoder.py:28-46), so pin the single-threaded FFT plan.
# Measured cost on a CPU host: <6% on the f64 FFT-DCT, none on matmul
# (the thunk runtime stopped using Eigen for dots). GPU programs are
# unaffected (CPU-only flag). Opt out with FRAD_TPU_FFT_MT=1;
# a user-provided xla_cpu_multi_thread_eigen flag wins. Best-effort by
# construction: XLA parses XLA_FLAGS at first backend use, so importing
# frad_python_tpu after running other jax programs may be too late.
if not os.environ.get("FRAD_TPU_FFT_MT") \
        and "xla_cpu_multi_thread_eigen" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_multi_thread_eigen=false").strip()

# f64 is the codec's native sample type (the container stores up to 64-bit
# floats); enable x64 before any jax arrays are created. Opt out with
# FRAD_TPU_NO_X64=1 (compute cores then run in f32).
if not os.environ.get("FRAD_TPU_NO_X64"):
    import jax

    jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the batched cores compile one program
# per (batch, frame, channel) shape; paying that once per checkout instead
# of once per process keeps the CLI usable. An explicit
# JAX_COMPILATION_CACHE_DIR (or a prior jax.config setting) wins and no
# other directory is set; otherwise the cache lives at the fixed path
# <checkout>/.jax_cache (gitignored). Opt out with
# FRAD_TPU_NO_COMPILE_CACHE=1.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")

if not os.environ.get("FRAD_TPU_NO_COMPILE_CACHE"):
    import jax

    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .container import head  # noqa: E402
from .container.asfh import ASFH  # noqa: E402
from .decoder import DecodeResult, Decoder  # noqa: E402
from .encoder import EncodeResult, Encoder  # noqa: E402
from .models import AVAILABLE, BIT_DEPTHS, COMPACT, LOSSLESS, SEGMAX, profiles  # noqa: E402
from .ops.pcm import ff_format_to_numpy_type, from_f64, to_f64  # noqa: E402
from .repairer import Repairer  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ASFH", "AVAILABLE", "BIT_DEPTHS", "COMPACT", "DecodeResult", "Decoder",
    "EncodeResult", "Encoder", "LOSSLESS", "Repairer", "SEGMAX",
    "ff_format_to_numpy_type", "from_f64", "head", "profiles", "to_f64",
]
