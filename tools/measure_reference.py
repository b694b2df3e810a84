"""Measure the reference FrAD_Python implementation's throughput.

Runs the reference (/root/reference/src) in-process on this machine's CPU
to establish the denominator for bench.py's vs_baseline. The reference
depends on `reedsolo`, which is not installed here; a shim backed by our
own (native C++) Reed-Solomon module is injected — strictly generous to
the baseline, since real reedsolo is pure Python and slower.

Writes BASELINE_MEASURED.json at the repo root.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
import types

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = pathlib.Path("/root/reference/src")


def install_reedsolo_shim() -> None:
    sys.path.insert(0, str(REPO))
    from frad_python_tpu.ops import rs as _rs

    mod = types.ModuleType("reedsolo")

    class ReedSolomonError(Exception):
        pass

    class RSCodec:
        def __init__(self, nsym: int, nsize: int = 255, *a, **k):
            self.nsym = nsym

        def encode(self, data):
            arr = np.frombuffer(bytes(data), dtype=np.uint8)
            parity = _rs.encode_blocks(arr[None, :], self.nsym)[0]
            return bytearray(arr.tobytes() + parity.tobytes())

        def decode(self, data):
            arr = np.frombuffer(bytes(data), dtype=np.uint8)
            fixed, ok = _rs.decode_blocks(arr[None, :], self.nsym)
            if not ok[0]:
                raise ReedSolomonError("uncorrectable")
            return bytearray(fixed[0].tobytes()), bytearray(bytes(data)), []

    mod.RSCodec = RSCodec
    mod.ReedSolomonError = ReedSolomonError
    sys.modules["reedsolo"] = mod


def measure(config: dict, seconds_audio: float, min_wall: float = 3.0) -> dict:
    sys.path.insert(0, str(REF))
    from libfrad import Decoder, Encoder  # noqa: PLC0415

    srate = config["srate"]
    ch = config["channels"]
    fsize = config["frame_size"]
    n = int(seconds_audio * srate)
    rng = np.random.default_rng(0)
    t = np.arange(n) / srate
    sig = sum(0.3 / (i + 1) * np.sin(2 * np.pi * (220 * (i + 1)) * t[:, None] + i)
              for i in range(4)) * np.ones((1, ch))
    sig = sig + 0.01 * rng.standard_normal((n, ch))
    raw = sig.astype(">f8").tobytes()

    def one_pass() -> tuple[int, float, float, np.ndarray]:
        enc = Encoder(config["profile"], srate, ch, config["bits"], fsize, "f64be")
        if config.get("ecc"):
            enc.set_ecc(True, (96, 24))
        enc.set_overlap_ratio(config.get("overlap_ratio", 16))
        enc.set_loss_level(config.get("loss_level", 0.5))
        t0 = time.perf_counter()
        stream = enc.process(raw).buf + enc.flush().buf
        t1 = time.perf_counter()
        dec = Decoder(fix_error=bool(config.get("ecc")))
        out = dec.process(stream)
        tail = dec.flush()
        t2 = time.perf_counter()
        nframes = max(out.frames, 1)
        pcm = np.concatenate([p for p in (out.pcm, tail.pcm) if p.size]) \
            if (out.pcm.size or tail.pcm.size) else np.empty((0, ch))
        return nframes, t1 - t0, t2 - t1, pcm

    # warm + repeat until min wall time
    total_frames = 0
    enc_time = dec_time = 0.0
    pcm = np.empty((0, ch))
    while enc_time + dec_time < min_wall:
        f, te, td, pcm = one_pass()
        total_frames += f
        enc_time += te
        dec_time += td

    # decoded quality vs the source (same SNR definition as bench.py)
    m = min(len(pcm), len(sig))
    err = np.atleast_2d(pcm)[:m] - sig[:m]
    snr = float(10 * np.log10(np.sum(sig[:m] ** 2)
                              / max(np.sum(err ** 2), 1e-300))) if m else 0.0

    wall = enc_time + dec_time
    return {
        "frames": total_frames,
        "encode_s": enc_time,
        "decode_s": dec_time,
        "frames_per_s": total_frames / wall,
        "audio_seconds_per_s": total_frames * fsize / srate / wall,
        "snr_db": snr,
    }


def measure_repair(config: dict, seconds_audio: float,
                   min_wall: float = 3.0) -> dict:
    """Time the reference Repairer re-armoring a damaged ECC stream
    (BASELINE config 5's repair pass, reference repairer.py:28-71).

    The stream is encoded by the reference encoder and damaged with the
    exact helper bench.py uses (frad_python_tpu.utils.damage), so both
    implementations repair identical bytes.
    """
    sys.path.insert(0, str(REF))
    from libfrad import Encoder, Repairer  # noqa: PLC0415

    from frad_python_tpu.utils.damage import damage_stream  # noqa: PLC0415

    srate, ch, fsize = config["srate"], config["channels"], config["frame_size"]
    n = int(seconds_audio * srate)
    rng = np.random.default_rng(0)
    t = np.arange(n) / srate
    sig = sum(0.3 / (i + 1) * np.sin(2 * np.pi * (220 * (i + 1)) * t[:, None] + i)
              for i in range(4)) * np.ones((1, ch))
    sig = sig + 0.01 * rng.standard_normal((n, ch))

    enc = Encoder(config["profile"], srate, ch, config["bits"], fsize, "f64be")
    enc.set_ecc(True, (96, 24))
    enc.set_overlap_ratio(config.get("overlap_ratio", 16))
    enc.set_loss_level(config.get("loss_level", 0.5))
    stream = enc.process(sig.astype(">f8").tobytes()).buf + enc.flush().buf
    damaged = damage_stream(stream)
    nframes = stream.count(b"\xff\xd0\xd2\x98")

    total_frames = 0
    wall = 0.0
    while wall < min_wall:
        rep = Repairer((96, 24))
        t0 = time.perf_counter()
        out = rep.process(damaged) + rep.flush()
        wall += time.perf_counter() - t0
        total_frames += nframes
        assert len(out) >= len(damaged)
    return {
        "frames": total_frames,
        "repair_s": wall,
        "frames_per_s": total_frames / wall,
        "audio_seconds_per_s": total_frames * fsize / srate / wall,
    }


CONFIGS = {
    "p4_mono_44k1": dict(profile=4, srate=44100, channels=1, bits=16, frame_size=2048),
    "p0_stereo_44k1": dict(profile=0, srate=44100, channels=2, bits=24, frame_size=2048),
    "p1_stereo_48k": dict(profile=1, srate=48000, channels=2, bits=16, frame_size=2048,
                          overlap_ratio=16, loss_level=0.5),
    "p1_stereo_44k1": dict(profile=1, srate=44100, channels=2, bits=16, frame_size=2048,
                           overlap_ratio=16, loss_level=0.5),
    "hires_96k_8ch": dict(profile=0, srate=96000, channels=8, bits=24, frame_size=8192),
    "p1_stereo_48k_ecc": dict(profile=1, srate=48000, channels=2, bits=16,
                              frame_size=2048, overlap_ratio=16, loss_level=0.5,
                              ecc=True),
    # archival deep depths: the reference runs these through the same f64
    # path as 24-bit (profile0.py:21); ours runs both on the host CPU
    # backend's f64 FFT (ops/policy.deep_device)
    "p0_stereo_48b": dict(profile=0, srate=44100, channels=2, bits=48,
                          frame_size=2048),
    "p0_stereo_64b": dict(profile=0, srate=44100, channels=2, bits=64,
                          frame_size=2048),
}

#: repair-pass configs (BASELINE config 5): measured with measure_repair
REPAIR_CONFIGS = {
    "repair_48k_ecc": dict(profile=1, srate=48000, channels=2, bits=16,
                           frame_size=2048, overlap_ratio=16, loss_level=0.5,
                           ecc=True),
}


def main() -> None:
    install_reedsolo_shim()
    results = {}
    for name, cfg in CONFIGS.items():
        res = measure(cfg, seconds_audio=4.0)
        results[name] = {"config": cfg, **res}
        print(f"{name}: {res['frames_per_s']:.1f} frames/s "
              f"({res['audio_seconds_per_s']:.2f}x realtime)", file=sys.stderr)
    for name, cfg in REPAIR_CONFIGS.items():
        res = measure_repair(cfg, seconds_audio=4.0)
        results[name] = {"config": cfg, **res}
        print(f"{name}: {res['frames_per_s']:.1f} frames/s repair "
              f"({res['audio_seconds_per_s']:.2f}x realtime)", file=sys.stderr)

    # merge with any prior measurement, keeping the FASTER frames_per_s
    # per config — generous to the reference baseline
    path = REPO / "BASELINE_MEASURED.json"
    if path.exists():
        prior = json.loads(path.read_text())["results"]
        for name, old in prior.items():
            new = results.get(name)
            if new is None or old.get("frames_per_s", 0) > new["frames_per_s"]:
                results[name] = {**old, **({"snr_db": new["snr_db"]}
                                           if new and "snr_db" in new else {})}
    out = {
        "machine": "bench host CPU (reference is single-threaded pure Python)",
        "note": "reedsolo shimmed with frad_python_tpu native RS (favours the "
                "reference); per-config frames_per_s is the fastest measured run",
        "results": results,
    }
    path.write_text(json.dumps(out, indent=2))
    print(json.dumps({k: round(v["frames_per_s"], 2) for k, v in results.items()}))


if __name__ == "__main__":
    main()
