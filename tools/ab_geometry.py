"""A/B the chunked-pipeline transfer geometry inside ONE process.

Separate runs of the bench on different cards or at different times
can't compare span-geometry settings. This alternates settings
pass-by-pass (A, B, A, B, ...) on one config and reports per-setting
medians — run-to-run drift hits both arms equally.

Usage: python tools/ab_geometry.py p0_stereo_44k1 [reps]
"""
from __future__ import annotations

import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from frad_python_tpu import native  # noqa: E402

if not native.available():
    from frad_python_tpu.native import build as native_build
    native_build.build()
    native.reload()

from frad_python_tpu.parallel import batch_decode, batch_encode, pipeline  # noqa: E402

import bench  # noqa: E402

name = sys.argv[1] if len(sys.argv) > 1 else "p0_stereo_44k1"
reps = int(sys.argv[2]) if len(sys.argv) > 2 else 4

#: (label, span_target, span_max_parts)
ARMS = [
    ("A 2MBx8 ", 2 << 20, 8),
    ("B 1MBx16", 1 << 20, 16),
]

cfg = bench.CONFIGS[name]
pcm = bench.make_audio(30.0, cfg["srate"], cfg["channels"])
kw, dec_kw = bench.cell_kwargs(cfg)


def one_pass() -> tuple[float, float, int]:
    t0 = time.perf_counter()
    stream = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                          cfg["frame_size"], **kw)
    t1 = time.perf_counter()
    batch_decode(stream, **dec_kw)
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, stream.count(b"\xff\xd0\xd2\x98")


# warm every arm's compiled shapes before timing
for _, tgt, mp in ARMS:
    pipeline.SPAN_TARGET, pipeline.SPAN_MAX_PARTS = tgt, mp
    one_pass()
    if cfg["profile"] == 1:
        one_pass()   # learned-capacity EGR program

res: dict[str, list[float]] = {lab: [] for lab, _, _ in ARMS}
for r in range(reps):
    for lab, tgt, mp in ARMS:
        pipeline.SPAN_TARGET, pipeline.SPAN_MAX_PARTS = tgt, mp
        enc, dec, nf = one_pass()
        fps = nf / (enc + dec)
        res[lab].append(fps)
        print(f"  rep {r} {lab}: enc {enc:.2f}s dec {dec:.2f}s "
              f"{fps:6.0f} f/s", file=sys.stderr)

for lab, fps in res.items():
    print(f"{lab}: median {np.median(fps):6.0f} f/s  "
          f"(all: {', '.join(f'{x:.0f}' for x in fps)})", file=sys.stderr)
