"""Find the ~100s per-process warm-up cost in the p1 encode path."""
from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax

import frad_python_tpu  # noqa: F401


t_ = time.perf_counter()
def stamp(label):
    global t_
    t1 = time.perf_counter()
    print(f"  {label}: {t1 - t_:.2f}s", file=sys.stderr)
    t_ = t1

from frad_python_tpu.models import batch, profile1
from frad_python_tpu.ops import bitpack, dct
import jax.numpy as jnp
stamp("imports")

d = jax.devices()[0]
x = jnp.zeros((8,), jnp.float32) + 1
x.block_until_ready()
stamp("first tiny dispatch")

fwd, inv = dct.device_matrices(2048, "float32")
fwd.block_until_ready()
stamp("device_matrices 2048 f32")

B = 688
arr = np.random.default_rng(0).standard_normal((B, 2048, 2)).astype(np.float32)
fq, tq = batch.p1_encode_core(arr, 44100, 0.5, 32768.0)
fq.block_until_ready()
stamp("p1_encode_core first call (B=688)")

m = fq.shape[1] * fq.shape[2]
max_words = max(m * 12 // 32, 16)
words, nbits, ks, ovf = bitpack.egr_pack_frames(fq.reshape(B, m), max_words)
words.block_until_ready()
stamp("egr_pack_frames first call")

from frad_python_tpu.parallel import pipeline
meta = pipeline._meta_packer()(nbits, ks, ovf, tq)
np.asarray(meta)
stamp("meta_packer first call")

chunks = pipeline._splitter(8)(words)
for c in chunks:
    c.copy_to_host_async()
_ = [np.asarray(c) for c in chunks]
stamp("splitter first call + fetch")

# tail frame (B=1)
arr1 = arr[:1]
fq1, tq1 = batch.p1_encode_core(arr1, 44100, 0.5, 32768.0)
fq1.block_until_ready()
stamp("p1_encode_core B=1")
fqh = np.asarray(fq1)
tqh = np.asarray(tq1)
stamp("B=1 fetch")
pl = profile1.pack_streams(fqh[0].ravel(), tqh[0].ravel())
stamp("pack_streams host")
