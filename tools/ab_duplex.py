"""A/B sequential vs full-duplex pass pipelining inside ONE process.

Separate runs on different cards or at different times can't compare
the two pass schedules. This alternates them (A, B, A, B, ...) on one
config and reports per-arm medians — run-to-run drift hits both arms
equally.

Arm A (seq):    encode pass k, then decode pass k, serially.
Arm B (duplex): encode pass k+1 on a worker thread while decode pass k
                drains — h2d and d2h transfers run concurrently.

Usage: python tools/ab_duplex.py p0_stereo_44k1 [reps]
"""
from __future__ import annotations

import pathlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from frad_python_tpu import native  # noqa: E402

if not native.available():
    from frad_python_tpu.native import build as native_build
    native_build.build()
    native.reload()

from frad_python_tpu.parallel import batch_decode, batch_encode  # noqa: E402

import bench  # noqa: E402

name = sys.argv[1] if len(sys.argv) > 1 else "p0_stereo_44k1"
reps = int(sys.argv[2]) if len(sys.argv) > 2 else 4
passes_per_arm = int(sys.argv[3]) if len(sys.argv) > 3 else 3

cfg = bench.CONFIGS[name]
pcm = bench.make_audio(30.0, cfg["srate"], cfg["channels"])
kw, dec_kw = bench.cell_kwargs(cfg)


def enc() -> bytes:
    return batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                        cfg["frame_size"], **kw)


# warm-up (compiles + EGR predictor)
stream = enc()
if cfg["profile"] == 1:
    stream = enc()
batch_decode(stream, **dec_kw)
nframes = stream.count(b"\xff\xd0\xd2\x98")


def arm_seq(n: int) -> float:
    """n sequential passes; returns frames/s over the arm."""
    t0 = time.perf_counter()
    for _ in range(n):
        batch_decode(enc(), **dec_kw)
    return n * nframes / (time.perf_counter() - t0)


def arm_duplex(n: int) -> float:
    """n pipelined passes; returns frames/s over the arm."""
    ex = ThreadPoolExecutor(max_workers=1)
    t0 = time.perf_counter()
    fut = ex.submit(enc)
    for k in range(n):
        s = fut.result()
        if k + 1 < n:
            fut = ex.submit(enc)
        batch_decode(s, **dec_kw)
    dt = time.perf_counter() - t0
    ex.shutdown(wait=False)
    return n * nframes / dt


res = {"seq": [], "duplex": []}
for r in range(reps):
    for lab, fn in (("seq", arm_seq), ("duplex", arm_duplex)):
        fps = fn(passes_per_arm)
        res[lab].append(fps)
        print(f"rep {r} {lab:>6}: {fps:7.1f} f/s", file=sys.stderr)

pairs = [d / s for s, d in zip(res["seq"], res["duplex"])]
print(f"\n{name}: seq median {np.median(res['seq']):.1f} f/s, "
      f"duplex median {np.median(res['duplex']):.1f} f/s")
print(f"paired duplex/seq ratios: {[round(p, 2) for p in pairs]} "
      f"(median {np.median(pairs):.2f}x)")
