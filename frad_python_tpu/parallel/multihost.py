"""Multi-host orchestration (SURVEY §2 N4, §5 distributed backend).

A FrAD pod job splits a stream into contiguous sample spans per host
(overlap-halo included in the span so no cross-host exchange is needed on
the encode side), runs the sharded cores over the global mesh, and
assembles the serial bitstream on host 0 in frame order — frame lengths
are data-dependent, so bitstream concatenation is host work
(SURVEY §7 hard part (a)).

Usage on each host of a pod slice:

    from frad_python_tpu.parallel import multihost
    multihost.init_distributed(coordinator, num_processes, process_id)
    mesh = multihost.global_mesh()          # all chips on all hosts
    span = multihost.host_span(total_samples, frame_size, overlap_ratio)
    stream_part = batch_encode(pcm[span.start:span.stop], ...)
    multihost.gather_bitstream(stream_part)  # -> full stream on host 0

Collectives ride the devices' interconnect within a host and the network
across hosts; the byte-domain gather moves ragged per-host streams point-to-point through
the distributed-runtime KV service (O(total bytes), full stream only on
process 0), with a chunk-bounded allgather fallback.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh

from ..models.profiles import compact


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bring up the jax distributed runtime (no-op when single-process).

    Pass the coordinator address (`host:port`), the process count and
    this process's id; nothing is autodetected on a plain GPU cluster.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every device of every process (JAX's global order)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


@dataclass(frozen=True)
class HostSpan:
    start: int          # first sample this host encodes
    stop: int           # one-past-last sample
    first_frame: int    # global index of this host's first frame


def host_span(total_samples: int, frame_size: int, overlap_ratio: int,
              is_compact: bool = True, process_id: int | None = None,
              num_processes: int | None = None) -> HostSpan:
    """Contiguous frame range for this host, halo included.

    Frames are distributed evenly; each host's sample span starts at its
    first frame's start offset (which already re-reads the overlap halo
    from the previous frame — the same duplication the streaming encoder
    performs), so hosts need NO sample exchange to encode.
    """
    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes

    n = compact.get_samples_min_ge(frame_size) if is_compact else frame_size
    olap = (n - n * (overlap_ratio - 1) // overlap_ratio) \
        if (is_compact and overlap_ratio > 1) else 0
    hop = n - olap
    n_frames = max(1, -(-(total_samples - olap) // hop)) if total_samples > 0 else 0

    lo_frame = n_frames * pid // nproc
    hi_frame = n_frames * (pid + 1) // nproc
    start = max(lo_frame * hop, 0)
    stop = min(hi_frame * hop + olap if hi_frame > lo_frame else start, total_samples)
    if pid == nproc - 1:
        stop = total_samples
    return HostSpan(start=start, stop=stop, first_frame=lo_frame)


#: generation counter — gather_bitstream is collective, so every process
#: advances it in lockstep and per-call KV keys never collide
_GATHER_GEN = 0
#: stay under the coordination service's gRPC message ceiling (4 MiB)
_KV_CHUNK = 2 << 20
_KV_TIMEOUT_MS = 600_000


def gather_bitstream(local_stream: bytes,
                     order_key: int | None = None,
                     chunk_bytes: int = _KV_CHUNK) -> bytes | None:
    """Order-preserving concatenation of per-host byte streams on host 0.

    RAGGED: only (length, order) metadata is exchanged collectively; the
    bytes themselves move point-to-point through the distributed-runtime
    KV service in gRPC-sized chunks, so traffic and memory are O(total
    bytes) — the full stream materialises only on process 0 — instead of
    the O(n_hosts x max_len) a padded allgather costs on EVERY process
    (ruinous for hour-long streams with uneven spans). Falls back to a
    chunk-bounded allgather when the KV client is unavailable.

    Returns the full stream on process 0 and None elsewhere.
    Single-process: identity.

    Segments are ordered by `order_key` (pass HostSpan.first_frame) so
    the assembly is correct even under a non-monotonic span→process
    assignment; with the default None the process index is the key
    (host_span assigns spans monotonically by pid, so both agree).
    """
    global _GATHER_GEN
    if jax.process_count() == 1:
        return local_stream
    _GATHER_GEN += 1
    gen = _GATHER_GEN
    pid = jax.process_index()
    nproc = jax.process_count()
    key = pid if order_key is None else int(order_key)

    from jax._src import distributed
    client = getattr(distributed.global_state, "client", None)
    if client is None:                      # pragma: no cover - exotic init
        return _gather_allgather_chunked(local_stream, key, chunk_bytes)

    pref = f"frad/gather/{gen}"
    if pid != 0:
        for ci, off in enumerate(range(0, len(local_stream), chunk_bytes)):
            client.key_value_set_bytes(
                f"{pref}/data/{pid}/{ci}",
                local_stream[off: off + chunk_bytes])
        client.key_value_set_bytes(
            f"{pref}/meta/{pid}",
            struct.pack(">qq", len(local_stream), key))
        # hold the call open until process 0 has drained every key, so
        # the collective contract (and key deletion) stays race-free
        client.wait_at_barrier(f"frad_gather_{gen}", _KV_TIMEOUT_MS)
        return None

    parts = [(key, local_stream)]
    for p in range(1, nproc):
        ln, k = struct.unpack(">qq", client.blocking_key_value_get_bytes(
            f"{pref}/meta/{p}", _KV_TIMEOUT_MS))
        chunks = [client.blocking_key_value_get_bytes(
            f"{pref}/data/{p}/{ci}", _KV_TIMEOUT_MS)
            for ci in range(-(-ln // chunk_bytes))]
        parts.append((k, b"".join(chunks)))
    client.wait_at_barrier(f"frad_gather_{gen}", _KV_TIMEOUT_MS)
    client.key_value_delete(pref)
    parts.sort(key=lambda t: t[0])
    return b"".join(p for _, p in parts)


def _gather_allgather_chunked(local_stream: bytes, key: int,
                              chunk_bytes: int) -> bytes | None:
    """Fallback byte gather: chunk-bounded allgather rounds.

    Peak memory is O(n_hosts x chunk) per round instead of
    O(n_hosts x max_len); assembly still only on process 0.
    """
    from jax.experimental import multihost_utils

    arr = np.frombuffer(local_stream, dtype=np.uint8)
    meta = np.array([len(arr), key], dtype=np.int64)
    all_meta = multihost_utils.process_allgather(meta)
    maxn = int(all_meta[:, 0].max())
    pid = jax.process_index()
    parts: list[list[bytes]] = [[] for _ in range(len(all_meta))]
    for off in range(0, max(maxn, 1), chunk_bytes):
        w = min(chunk_bytes, maxn - off) if maxn else 0
        if w <= 0:
            break
        buf = np.zeros(w, dtype=np.uint8)
        take = min(max(len(arr) - off, 0), w)
        if take:
            buf[:take] = arr[off: off + take]
        g = multihost_utils.process_allgather(buf)
        if pid == 0:
            for p in range(len(all_meta)):
                rem = int(all_meta[p, 0]) - off
                if rem > 0:
                    parts[p].append(g[p, : min(rem, w)].tobytes())
    if pid != 0:
        return None
    order = np.argsort(all_meta[:, 1], kind="stable")
    return b"".join(b"".join(parts[int(i)]) for i in order)
