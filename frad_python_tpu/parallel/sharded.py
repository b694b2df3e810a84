"""Multi-chip sharded codec: frame-batch data parallelism over a Mesh.

SURVEY §2 N1-N5: the FrAD stream is embarrassingly parallel across frames
once the overlap halo is materialised, so the sharding recipe is

* N1 (DP): shard the frame batch [B, N, C] over the 'data' mesh axis and
  pjit the fused profile cores — XLA partitions the DCT/subband matmuls
  per shard with zero communication.
* N2 (SP/halo): the decoder's overlap-add needs each frame's left
  neighbour's tail; at shard boundaries that's one depth-1 ring
  `ppermute` inside `shard_map` (`overlap_add_sharded`).
* N3 (channel sharding): the transform chain is channel-independent, so
  a 2-D (data, channel) mesh (`make_mesh_2d`) shards the C axis too —
  `_frame_spec` picks the PartitionSpec per mesh, and the compiled
  program stays communication-free (tests prove zero collective ops).
* N4/N5: multi-host init is `jax.distributed.initialize` + the same mesh
  over all processes (`make_mesh` uses every visible device); the byte
  domain (EGR/ASFH) stays host-local per shard and the bitstream is
  assembled in frame order on the host (pipeline.py).

Everything compiles with n real chips or with a virtual CPU mesh
(xla_force_host_platform_device_count) — tests run the latter.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import batch


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """1-D device mesh over the first n (default: all) visible devices."""
    devs = np.asarray(jax.devices()[:n_devices] if n_devices else jax.devices())
    return Mesh(devs, (axis,))


def make_mesh_2d(n_data: int, n_channel: int) -> Mesh:
    """2-D (data, channel) mesh — SURVEY §2 N3: the per-channel transform
    chain (DCT / masking / quant) is channel-independent, so the C axis
    shards with ZERO communication."""
    devs = np.asarray(jax.devices()[: n_data * n_channel])
    assert devs.size == n_data * n_channel, (
        f"need {n_data * n_channel} devices, have {devs.size}")
    return Mesh(devs.reshape(n_data, n_channel), ("data", "channel"))


def _frame_spec(mesh: Mesh) -> P:
    """PartitionSpec for a [B, N, C] frame batch on this mesh: batch over
    'data', channels over 'channel' when the mesh has that axis."""
    if "channel" in mesh.axis_names:
        return P("data", None, "channel")
    return P("data")


def pad_to_multiple(frames: np.ndarray, m: int) -> tuple[np.ndarray, int]:
    """Pad the batch axis to a multiple of m (shardable); returns (padded, pad)."""
    b = frames.shape[0]
    pad = (-b) % m
    if pad:
        frames = np.concatenate([frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
    return frames, pad


def sharded_p1_encode(mesh: Mesh, frames: np.ndarray, srate: int,
                      loss_level: float, factor: float):
    """Data-parallel profile-1 encode core over the mesh.

    frames [B, N, C] with B % n_devices == 0. Returns host arrays
    (freqs_q, thres_q) identical to the single-device core.
    """
    spec = NamedSharding(mesh, _frame_spec(mesh))
    f = jax.device_put(jnp.asarray(frames), spec)
    fwd, _ = batch._mats(f.shape[1], f.dtype)
    fn = jax.jit(
        lambda fr, ll, fc, m: batch._p1_encode_jit.__wrapped__(fr, srate, ll, fc, m),
        in_shardings=(spec, None, None, None),
        out_shardings=(spec, spec),
    )
    fq, tq = fn(f, jnp.asarray(loss_level, f.dtype), jnp.asarray(factor, f.dtype), fwd)
    return np.asarray(fq), np.asarray(tq)


def sharded_p0_encode(mesh: Mesh, frames: np.ndarray) -> np.ndarray:
    spec = NamedSharding(mesh, _frame_spec(mesh))
    f = jax.device_put(jnp.asarray(frames), spec)
    fwd, _ = batch._mats(f.shape[1], f.dtype)
    fn = jax.jit(batch._p0_encode_jit.__wrapped__,
                 in_shardings=(spec, None), out_shardings=spec)
    return np.asarray(fn(f, fwd))


def sharded_p0_decode(mesh: Mesh, coeffs: np.ndarray) -> np.ndarray:
    spec = NamedSharding(mesh, _frame_spec(mesh))
    c = jax.device_put(jnp.asarray(coeffs), spec)
    _, inv = batch._mats(c.shape[1], c.dtype)
    fn = jax.jit(batch._p0_decode_jit.__wrapped__,
                 in_shardings=(spec, None), out_shardings=spec)
    return np.asarray(fn(c, inv))


def sharded_p1_decode(mesh: Mesh, freqs: np.ndarray, thres: np.ndarray,
                      srate: int, factor: float) -> np.ndarray:
    spec = NamedSharding(mesh, _frame_spec(mesh))
    f = jax.device_put(jnp.asarray(freqs), spec)
    t = jax.device_put(jnp.asarray(thres), spec)
    _, inv = batch._mats(f.shape[1], f.dtype)
    fn = jax.jit(
        lambda fr, th, fc, m: batch._p1_decode_jit.__wrapped__(fr, th, srate, fc, m),
        in_shardings=(spec, spec, None, None), out_shardings=spec)
    return np.asarray(fn(f, t, jnp.asarray(factor, f.dtype), inv))


def sharded_p2_encode(mesh: Mesh, frames: np.ndarray, srate: int,
                      loss_level: float, factor: float):
    """Data-parallel profile-2 encode core (P1 chain + TNS) over the mesh.

    frames [B, N, C] with B % n_devices == 0. Returns host arrays
    (freqs_q, thres_q, lpc_q) identical to the single-device
    `batch.p2_encode_core` (reference profile2.py:21-51). The TNS
    Levinson recursion and IIR scan are frame- and channel-local, so
    the compiled program stays communication-free on both 1-D and 2-D
    (data, channel) meshes.
    """
    spec = NamedSharding(mesh, _frame_spec(mesh))
    f = jax.device_put(jnp.asarray(frames), spec)
    fwd, _ = batch._mats(f.shape[1], f.dtype)
    fn = jax.jit(
        lambda fr, ll, fc, m: batch._p2_encode_jit.__wrapped__(fr, srate, ll, fc, m),
        in_shardings=(spec, None, None, None),
        out_shardings=(spec, spec, spec),
    )
    fq, tq, lq = fn(f, jnp.asarray(loss_level, f.dtype),
                    jnp.asarray(factor, f.dtype), fwd)
    return np.asarray(fq), np.asarray(tq), np.asarray(lq)


def sharded_p2_decode(mesh: Mesh, freqs: np.ndarray, thres: np.ndarray,
                      lpc: np.ndarray, srate: int, factor: float) -> np.ndarray:
    """Inverse of `sharded_p2_encode` (reference profile2.py:58-91)."""
    spec = NamedSharding(mesh, _frame_spec(mesh))
    f = jax.device_put(jnp.asarray(freqs), spec)
    t = jax.device_put(jnp.asarray(thres), spec)
    lp = jax.device_put(jnp.asarray(lpc), spec)
    _, inv = batch._mats(f.shape[1], f.dtype)
    fn = jax.jit(
        lambda fr, th, lq, fc, m: batch._p2_decode_jit.__wrapped__(
            fr, th, lq, srate, fc, m),
        in_shardings=(spec, spec, spec, None, None), out_shardings=spec)
    return np.asarray(fn(f, t, lp, jnp.asarray(factor, f.dtype), inv))


def overlap_add_sharded_fn(mesh: Mesh, olap: int, cut: int, dtype):
    """The jitted shard_map program behind `overlap_add_sharded`, for
    callers that lower it (e.g. to check the halo collective)."""
    from jax import shard_map

    ndev = mesh.shape["data"]
    w = (0.5 * (1.0 - np.cos(np.pi * np.arange(1, olap + 1) / (olap + 1)))).astype(dtype)

    def local(fr):
        # fr: [B/ndev, N, C or C/n_channel] local shard — the crossfade is
        # per-channel elementwise, so a channel-sharded mesh needs no
        # extra communication here; the halo ppermute rides 'data' only
        idx = jax.lax.axis_index("data")
        tails = fr[:, cut:cut + olap, :]
        last_tail = tails[-1:, :, :]
        perm = [(i, (i + 1) % ndev) for i in range(ndev)]
        halo = jax.lax.ppermute(last_tail, "data", perm)
        prev_tails = jnp.concatenate([halo, tails[:-1]], axis=0)

        wj = jnp.asarray(w)[None, :, None]
        heads = fr[:, :olap, :]
        blended = heads * wj + prev_tails * wj[:, ::-1, :]
        # the global first frame keeps its raw head (no predecessor)
        first = (idx == 0)
        row0 = jnp.where(first, fr[0, :olap, :], blended[0])
        blended = jnp.concatenate([row0[None], blended[1:]], axis=0)
        return jnp.concatenate([blended, fr[:, olap:cut, :]], axis=1)

    return jax.jit(shard_map(local, mesh=mesh, in_specs=_frame_spec(mesh),
                             out_specs=_frame_spec(mesh)))


def overlap_add_sharded(mesh: Mesh, frames: np.ndarray, olap: int, cut: int
                        ) -> np.ndarray:
    """Decoder overlap-add with an explicit ring halo exchange.

    frames [B, N, C] sharded on B. Each shard crossfades locally; the
    tail of each shard's LAST frame is sent to the right neighbour with a
    depth-1 ring `ppermute` so shard boundaries blend exactly like the
    sequential decoder. Device 0 masks the wrapped-around halo (the
    global first frame has no predecessor).
    """
    ndev = mesh.shape["data"]
    assert frames.shape[0] % ndev == 0, "batch must divide the mesh's data axis"
    fn = overlap_add_sharded_fn(mesh, olap, cut, frames.dtype)
    spec = NamedSharding(mesh, _frame_spec(mesh))
    return np.asarray(fn(jax.device_put(jnp.asarray(frames), spec)))


def training_step_equivalent(mesh: Mesh, pcm_frames: np.ndarray, srate: int,
                             loss_level: float, factor: float):
    """One full sharded 'step': encode core -> decode core -> overlap-add,
    all jitted over the mesh. This is the flagship multi-chip path used by
    __graft_entry__.dryrun_multichip."""
    fq, tq = sharded_p1_encode(mesh, pcm_frames, srate, loss_level, factor)
    pcm = sharded_p1_decode(mesh, fq.astype(np.float64), tq.astype(np.float64),
                            srate, factor)
    n = pcm_frames.shape[1]
    cut = n * 15 // 16
    return overlap_add_sharded(mesh, pcm, n - cut, cut)
