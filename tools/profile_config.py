"""Quick per-stage profiling of one bench config (stderr breakdown).

Usage: python tools/profile_config.py p1_stereo_44k1 [passes]
"""
from __future__ import annotations

import pathlib
import sys
import time


REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


import frad_python_tpu  # noqa: E402,F401
from frad_python_tpu import native  # noqa: E402

if not native.available():
    from frad_python_tpu.native import build as native_build
    native_build.build()
    native.reload()

from frad_python_tpu.parallel import batch_decode, batch_encode, pipeline  # noqa: E402
from frad_python_tpu.utils.tracing import StageTimer  # noqa: E402

import bench  # noqa: E402  (REPO is already on sys.path)

name = sys.argv[1] if len(sys.argv) > 1 else "p1_stereo_44k1"
passes = int(sys.argv[2]) if len(sys.argv) > 2 else 3
cfg = bench.CONFIGS[name]
pcm = bench.make_audio(30.0, cfg["srate"], cfg["channels"])
kw, dec_kw = bench.cell_kwargs(cfg)

# warm-up
stream = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                      cfg["frame_size"], **kw)
if cfg["profile"] == 1:
    # second warm pass so the learned-capacity EGR program's jit lands
    # here, not in timed pass 0 (mirrors bench.run_config)
    stream = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                          cfg["frame_size"], **kw)
out, _ = batch_decode(stream, **dec_kw)
nframes = stream.count(b"\xff\xd0\xd2\x98")
print(f"{name}: {nframes} frames, stream {len(stream)/1e6:.1f} MB, "
      f"pcm {pcm.nbytes/1e6:.1f} MB f64", file=sys.stderr)

pipeline.STAGES = StageTimer()
for i in range(passes):
    t0 = time.perf_counter()
    stream = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                          cfg["frame_size"], **kw)
    t1 = time.perf_counter()
    out, _ = batch_decode(stream, **dec_kw)
    t2 = time.perf_counter()
    # f/s covers enc+dec combined; recount frames from THIS pass's stream
    nframes = stream.count(b"\xff\xd0\xd2\x98")
    print(f"  pass {i}: enc {t1-t0:.2f}s dec {t2-t1:.2f}s "
          f"({nframes/(t2-t0):.0f} f/s enc+dec)", file=sys.stderr)
print(pipeline.STAGES.summary(), file=sys.stderr)
