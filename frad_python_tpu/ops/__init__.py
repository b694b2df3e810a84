"""Compute ops: transforms, masking, packing, entropy and error-correction
kernels. Tensor-domain ops are JAX; byte-domain ops are
vectorised numpy with C++ native fast paths (frad_python_tpu.native)."""

from . import dct, golomb, packing, pcm, psycho, rs, tns_jax, window

__all__ = ["dct", "golomb", "packing", "pcm", "psycho", "rs", "tns_jax", "window"]
