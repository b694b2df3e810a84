"""FrAD engine benchmark on one GPU.

Runs every cell of CONFIGS (30 s of audio, PCM -> FrAD bytes -> PCM
through parallel.batch_encode / batch_decode) and of REPAIR_CONFIGS
(parallel.batch_repair of a damaged ECC stream), then the fused P1
cores' device-resident rate. Per-pass times, the StageTimer breakdown
(wall-clock and bytes moved per stage) and per-cell results go to
stderr; stdout gets ONE JSON line with every result. Each result
carries the platform, device_kind, device count and the card's
`nvidia-smi` name and power limit.

    python bench.py [cell ...] [--out PATH]

A measurement needs a GPU: on a CPU platform the script refuses to run.
Archival cells (48/64-bit) compute their f64 transform on the host CPU
backend (ops/policy.deep_device) and say so with `route=host`.

vs_baseline divides by the reference implementation's frames/s from
BASELINE_MEASURED.json (tools/measure_reference.py, taken on another
machine's CPU).
"""

from __future__ import annotations

import functools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

HEADLINE = "p1_stereo_44k1"

CONFIGS = {
    "p4_mono_44k1": dict(profile=4, srate=44100, channels=1, bits=16, frame_size=2048),
    "p0_stereo_44k1": dict(profile=0, srate=44100, channels=2, bits=24, frame_size=2048),
    "p1_stereo_48k": dict(profile=1, srate=48000, channels=2, bits=16, frame_size=2048),
    "p1_stereo_44k1": dict(profile=1, srate=44100, channels=2, bits=16, frame_size=2048),
    "hires_96k_8ch": dict(profile=0, srate=96000, channels=8, bits=24, frame_size=8192),
    "p1_stereo_48k_ecc": dict(profile=1, srate=48000, channels=2, bits=16,
                              frame_size=2048, ecc=True),
    # archival depths: f64 transform on the host CPU backend
    "p0_stereo_48b": dict(profile=0, srate=44100, channels=2, bits=48,
                          frame_size=2048),
    "p0_stereo_64b": dict(profile=0, srate=44100, channels=2, bits=64,
                          frame_size=2048),
}

#: repair-pass configs (BASELINE config 5): batch_repair over a stream
#: damaged by frad_python_tpu.utils.damage (same bytes the reference
#: Repairer is timed on in tools/measure_reference.py)
REPAIR_CONFIGS = {
    "repair_48k_ecc": dict(profile=1, srate=48000, channels=2, bits=16,
                           frame_size=2048, ecc=True),
}

#: hires crosses into 8192-point frames and 8 channels; it needs a longer
#: window than the 2048-frame configs to land >= 3 passes
BUDGET_S = {"hires_96k_8ch": 150.0}

#: Dense peak TFLOP/s per precision, keyed by jax device_kind. Source:
#: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense (no
#: sparsity), at the full 700 W power limit. fp32/fp64 are the non-tensor
#: FP32 and FP64-tensor-core rates.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.0, "tf32": 495.0,
                              "fp32": 67.0, "fp64": 67.0},
}


def peak_tflops(kind: str) -> dict[str, float]:
    """Peak table for a device_kind; an unknown device is an error."""
    try:
        return PEAK_TFLOPS[kind]
    except KeyError:
        raise ValueError(f"no peak rates known for device kind {kind!r}; "
                         f"add it to bench.PEAK_TFLOPS with its source") from None


def precision_label(compute_dtype: str) -> tuple[str, str]:
    """(label, peak key) of the lossy cores' matmuls on a GPU."""
    if compute_dtype == "float64":
        return "f64 (FP64)", "fp64"
    from jax import lax

    from frad_python_tpu.ops import policy
    return {lax.Precision.DEFAULT: ("DEFAULT (TF32 tensor cores)", "tf32"),
            lax.Precision.HIGH: ("HIGH (TF32 tensor cores)", "tf32"),
            lax.Precision.HIGHEST: ("HIGHEST (full FP32)", "fp32"),
            }[policy.lossy_matmul_precision()]


def nvidia_smi() -> str:
    """`name, power.limit` of the card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


@functools.lru_cache(maxsize=1)
def device_info() -> dict:
    """What every result is tagged with."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "count": len(d), "nvidia_smi": nvidia_smi()}


def make_audio(seconds: float, srate: int, ch: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * srate)) / srate
    sig = sum(0.3 / (i + 1) * np.sin(2 * np.pi * (220 * (i + 1)) * t[:, None] + i)
              for i in range(4)) * np.ones((1, ch))
    return sig + 0.01 * rng.standard_normal((len(t), ch))


def cell_kwargs(cfg: dict, compute_dtype: str | None = None
                ) -> tuple[dict, dict]:
    """(batch_encode kwargs, batch_decode kwargs) of a cell. The f32
    policy (GPU) quantises the transfers: 3 B/sample lossless, 2 B/sample
    lossy."""
    from frad_python_tpu.ops import policy

    cd = compute_dtype or policy.compute_dtype()
    f32 = cd == "float32"
    enc = dict(loss_level=0.5, enable_ecc=bool(cfg.get("ecc")),
               compute_dtype=cd, workers=4,
               i24_upload=f32 and cfg["profile"] == 0 and cfg["bits"] == 24,
               i16_upload=f32 and cfg["profile"] == 1 and cfg["bits"] == 16)
    dec = dict(fix_error=bool(cfg.get("ecc")), compute_dtype=cd,
               i16_transfer=cfg["profile"] == 1,
               i24_transfer=cfg["profile"] == 0 and cfg["bits"] == 24)
    return enc, dec


def route(cfg: dict) -> str:
    """Where a cell's transform runs: archival depths on the host."""
    from frad_python_tpu.ops import policy

    if cfg["profile"] == 0 and cfg["bits"] >= policy.DEEP_BITS:
        return "host"
    return "device" if cfg["profile"] != 4 else "none"


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    m = min(len(ref), len(got))
    err = got[:m] - ref[:m]
    return float(10 * np.log10(np.sum(ref[:m] ** 2)
                               / max(np.sum(err ** 2), 1e-300)))


def run_config(name: str, cfg: dict, seconds: float = 30.0,
               min_wall: float = 3.0, min_passes: int = 5) -> dict:
    from frad_python_tpu.parallel import batch_decode, batch_encode, pipeline
    from frad_python_tpu.utils.tracing import StageTimer

    pcm = make_audio(seconds, cfg["srate"], cfg["channels"])
    kw, dec_kw = cell_kwargs(cfg)
    args = (cfg["profile"], cfg["srate"], cfg["bits"], cfg["frame_size"])

    # warm-up (compile). P1's EGR capacity predictor learns its word-fetch
    # bucket from the first pass; encode once more so the learned-capacity
    # program's compile lands here, not in timed pass 0
    t0 = time.perf_counter()
    stream = batch_encode(pcm, *args, **kw)
    if cfg["profile"] == 1:
        stream = batch_encode(pcm, *args, **kw)
    out, _ = batch_decode(stream, **dec_kw)
    setup_s = time.perf_counter() - t0

    nframes = stream.count(b"\xff\xd0\xd2\x98")
    enc_t = dec_t = 0.0
    pass_fps = []
    pipeline.STAGES = StageTimer()
    budget = time.perf_counter() + BUDGET_S.get(name, 75.0)
    while (enc_t + dec_t < min_wall or len(pass_fps) < min_passes) \
            and (time.perf_counter() < budget or not pass_fps):
        t0 = time.perf_counter()
        strm = batch_encode(pcm, *args, **kw)
        t1 = time.perf_counter()
        out, _ = batch_decode(strm, **dec_kw)
        t2 = time.perf_counter()
        enc_t += t1 - t0
        dec_t += t2 - t1
        pass_fps.append(nframes / (t2 - t0))
        print(f"  {name} pass: enc {t1-t0:.3f}s dec {t2-t1:.3f}s "
              f"({pass_fps[-1]:.0f} f/s)", file=sys.stderr)
    stages = pipeline.STAGES
    pipeline.STAGES = None
    print(f"  {name} stages:", file=sys.stderr)
    for line in stages.summary().splitlines():
        print(f"    {line}", file=sys.stderr)

    npass = len(pass_fps)
    return {
        "frames_per_s": float(np.median(pass_fps)),
        "pass_fps_min": float(np.min(pass_fps)),
        "pass_fps_max": float(np.max(pass_fps)),
        "passes": npass,
        "encode_s": enc_t,
        "decode_s": dec_t,
        "setup_s": setup_s,
        "frames": nframes * npass,
        "snr_db": snr_db(pcm, out),
        "realtime_x": nframes * npass * cfg["frame_size"] / cfg["srate"]
        / (enc_t + dec_t),
        "route": route(cfg),
        "stage_s_per_pass": {k: v / npass for k, v in stages.totals.items()},
        "bytes_per_pass": {k: v / npass for k, v in stages.bytes.items()},
    }


def run_repair_config(name: str, cfg: dict, seconds: float = 30.0,
                      min_wall: float = 3.0) -> dict:
    """Time batch_repair re-armoring a damaged ECC stream (the Repairer
    engine's fast path; reference repairer.py:28-71)."""
    from frad_python_tpu.parallel import batch_decode, batch_encode, batch_repair
    from frad_python_tpu.utils.damage import damage_stream

    pcm = make_audio(seconds, cfg["srate"], cfg["channels"])
    kw, dec_kw = cell_kwargs(cfg)
    stream = batch_encode(pcm, cfg["profile"], cfg["srate"], cfg["bits"],
                          cfg["frame_size"], **kw)
    damaged = damage_stream(stream)
    nframes = stream.count(b"\xff\xd0\xd2\x98")

    repaired = batch_repair(damaged, (96, 24))        # warm-up
    wall = 0.0
    pass_fps = []
    while wall < min_wall or len(pass_fps) < 5:
        t0 = time.perf_counter()
        repaired = batch_repair(damaged, (96, 24))
        dt = time.perf_counter() - t0
        wall += dt
        pass_fps.append(nframes / dt)
        print(f"  {name} pass: repair {dt:.3f}s ({pass_fps[-1]:.0f} f/s)",
              file=sys.stderr)

    # correctness: the repaired stream must decode identically to the
    # undamaged original
    out_r, _ = batch_decode(repaired, **dec_kw)
    out_o, _ = batch_decode(stream, **dec_kw)
    return {
        "frames_per_s": float(np.median(pass_fps)),
        "repair_s": wall,
        "frames": nframes * len(pass_fps),
        "realtime_x": nframes * len(pass_fps) * cfg["frame_size"]
        / cfg["srate"] / wall,
        "repaired_decode_equal": bool(np.array_equal(out_r, out_o)),
        "damaged_bytes": sum(a != b for a, b in zip(stream, damaged)),
        "route": "none",
    }


def measure_core_fps(b: int = 646, n: int = 2048, ch: int = 2,
                     srate: int = 44100, k1: int = 8, k2: int = 64) -> dict:
    """Device-resident throughput of the fused P1 cores.

    Each core is iterated inside ONE `lax.scan` program whose carry feeds
    iteration k's output into iteration k+1's input, so XLA cannot drop
    the chain and dispatch is paid once per program. The per-iteration
    wall is the SLOPE between two scan lengths (k1, k2), which cancels the
    constant overhead (dispatch, transfers, scan setup). Each (body,
    length) is timed best-of-4.

    FLOPs are counted from the matmuls that dominate the cores: encode =
    DCT [B*C, N]@[N, N] + subband [B*C, N]@[N, 27]; decode = the inverse
    DCT. Elementwise work is excluded, so every rate is a lower bound.
    The share is against the card's published peak for the precision
    the cores' matmuls use (`precision_label`).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from frad_python_tpu.models import batch
    from frad_python_tpu.ops import policy, psycho

    cd = policy.compute_dtype()
    dt = jnp.dtype(cd)
    pcm = make_audio(b * n / srate, srate, ch)
    frames = jnp.asarray(pcm[: b * n].reshape(b, n, ch), dtype=dt)
    ll = jnp.asarray(0.5, dt)
    factor = jnp.asarray(2.0 ** 15, dt)
    fwd, inv = batch._mats_like(n, dt, frames)
    eps = jnp.asarray(1e-30, dt)

    fq0, tq0 = batch._p1_encode_jit(frames, srate, ll, factor, fwd)
    fqf, tqf = fq0.astype(dt), tq0.astype(dt)

    # the DCT matrices ride as jit ARGUMENTS (closure capture would bake
    # them in as giant HLO constants, see models/batch._mats)
    @functools.partial(jax.jit, static_argnames=("body", "length"))
    def run(init, fwd_m, inv_m, body, length):
        def enc_body(fr, _):
            fq, tq = batch._p1_encode_jit.__wrapped__(
                fr, srate, ll, factor, fwd_m)
            return fr + eps * fq.astype(dt) + eps * tq.astype(dt).sum(), None

        def dec_body(carry, _):
            fr, th = carry
            pcm_d = batch._p1_decode_jit.__wrapped__(
                fr, th, srate, factor, inv_m)
            return (fr + eps * pcm_d, th), None

        def both_body(fr, _):
            fq, tq = batch._p1_encode_jit.__wrapped__(
                fr, srate, ll, factor, fwd_m)
            pcm_d = batch._p1_decode_jit.__wrapped__(
                fq.astype(dt), tq.astype(dt), srate, factor, inv_m)
            return pcm_d, None

        out, _ = lax.scan({"enc": enc_body, "dec": dec_body,
                           "both": both_body}[body], init, None,
                          length=length)
        return out

    def slope_s(body, init, reps: int = 4) -> float:
        walls = {}
        for k in (k1, k2):
            jax.block_until_ready(run(init, fwd, inv, body, k))  # compile
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(run(init, fwd, inv, body, k))
                best = min(best, time.perf_counter() - t0)
            walls[k] = best
        return max((walls[k2] - walls[k1]) / (k2 - k1), 1e-12)

    nb = psycho._mask_consts(n, srate)[1]
    flops = {"enc": 2 * ch * n * n + 2 * ch * n * nb, "dec": 2 * ch * n * n}
    flops["both"] = flops["enc"] + flops["dec"]
    label, key = precision_label(cd)
    peak = peak_tflops(device_info()["device_kind"])[key]
    fps = {"enc": b / slope_s("enc", frames),
           "dec": b / slope_s("dec", (fqf, tqf)),
           "both": b / slope_s("both", frames)}
    tflops = {k: fps[k] * flops[k] / 1e12 for k in fps}
    print(f"device core (chained lax.scan, slope {k1}->{k2}, B={b}, N={n}): "
          + ", ".join(f"{k} {fps[k]:,.0f} f/s ({tflops[k]:.2f} TFLOP/s, "
                      f"{100 * tflops[k] / peak:.2f}% of {peak:.0f})"
                      for k in fps) + f" [{label}]", file=sys.stderr)
    return {"core_fps": fps, "tflops": tflops,
            "peak_share_pct": {k: 100 * v / peak for k, v in tflops.items()},
            "peak_tflops": peak, "matmul_precision": label,
            "flops_per_frame": flops, "core_batch": b}


def build_native() -> bool:
    """Build the C++ host module from source (set-up time; a copied .so
    may not match this machine)."""
    from frad_python_tpu import native
    from frad_python_tpu.native import build as native_build

    native_build.build(verbose=False)
    return native.reload()


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = pathlib.Path(argv[i + 1])
        del argv[i:i + 2]
    only = set(argv)
    unknown = only - set(CONFIGS) - set(REPAIR_CONFIGS)
    if unknown:
        sys.exit(f"unknown cell(s): {sorted(unknown)}")

    import frad_python_tpu  # noqa: F401  (x64, compile cache)
    from frad_python_tpu.ops import policy
    from frad_python_tpu.utils import hostmem

    info = device_info()
    if info["platform"] == "cpu":
        sys.exit("bench.py measures a GPU and JAX found only the CPU; "
                 "a CPU timing is not a device measurement")
    policy.platform()                     # refuses unknown platforms
    peak_tflops(info["device_kind"])      # refuses unknown devices
    hostmem.tune()
    native_ok = build_native()
    cd = policy.compute_dtype()
    print(f"device: {info['platform']} {info['device_kind']} x{info['count']}"
          f" | nvidia-smi: {info['nvidia_smi']} | compute_dtype={cd} "
          f"| native={native_ok}", file=sys.stderr)

    baseline, ref_snr = {}, {}
    bl_path = REPO / "BASELINE_MEASURED.json"
    if bl_path.exists():
        ref = json.loads(bl_path.read_text())["results"]
        baseline = {k: v["frames_per_s"] for k, v in ref.items()}
        ref_snr = {k: v["snr_db"] for k, v in ref.items() if "snr_db" in v}

    detail = {}
    cells = [(n, c, run_config) for n, c in CONFIGS.items()] \
        + [(n, c, run_repair_config) for n, c in REPAIR_CONFIGS.items()]
    for name, cfg, fn in cells:
        if only and name not in only:
            continue
        try:
            res = fn(name, cfg)
        except Exception as e:  # keep the bench alive; report the failure
            print(f"{name}: FAILED {type(e).__name__}: {e}", file=sys.stderr)
            detail[name] = {"error": f"{type(e).__name__}: {e}"}
            continue
        ref = baseline.get(name)
        res["vs_baseline"] = res["frames_per_s"] / ref if ref else None
        if name in ref_snr and "snr_db" in res:
            res["vs_ref_snr_db"] = res["snr_db"] - ref_snr[name]
        res["compute_dtype"] = cd
        res.update(device=info)
        detail[name] = res
        extra = (f", SNR {res['snr_db']:.2f} dB" if "snr_db" in res
                 else f", decode-equal {res['repaired_decode_equal']}")
        print(f"{name}: {res['frames_per_s']:.0f} frames/s "
              f"({res['realtime_x']:.0f}x realtime{extra}, "
              f"route={res['route']})", file=sys.stderr)

    core = {}
    if not only or HEADLINE in only:
        try:
            core = measure_core_fps()
            core["device"] = info
        except Exception as e:
            print(f"core measure failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            core = {"error": f"{type(e).__name__}: {e}"}

    head = detail.get(HEADLINE, {})
    summary = {
        "metric": "p1 44.1kHz stereo 2048-frame encode+decode throughput",
        "value": head.get("frames_per_s"),
        "unit": "frames/s",
        "device": info,
        "compute_dtype": cd,
        "results": detail,
        "core": core,
    }
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    if any("error" in r for r in detail.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
