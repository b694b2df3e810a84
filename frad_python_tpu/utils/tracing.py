"""Tracing / profiling utilities (SURVEY §5 auxiliary subsystems).

The reference's only observability is a stderr stats line (see
utils/telemetry.py for that); here:

* `trace(path)` — context manager around `jax.profiler` emitting a
  TensorBoard-loadable trace of the device kernels.
* `StageTimer` — lightweight named wall-clock stage accumulator used to
  attribute pipeline time (gather / core / d2h / host-pack / framing).
* `annotate(name)` — `jax.profiler.TraceAnnotation` passthrough so host
  stages show up inside device traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace into `log_dir` for TensorBoard."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that appears on the host track of device traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)


class StageTimer:
    """Accumulates wall-clock per named stage; pretty summary on demand.

    Also meters host<->device traffic: transfer sites call
    `add_bytes('h2d'|'d2h', n)` so a bench run can report the bytes
    moved and the effective bandwidth per direction."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add_bytes(self, direction: str, n: int) -> None:
        self.bytes[direction] += int(n)

    def transfer_wait(self, direction: str) -> float:
        """Total wall-clock spent BLOCKED on `direction` transfers
        (stages named `enc:h2d`, `dec:d2h`, ...)."""
        return sum(t for name, t in self.totals.items()
                   if name.endswith(":" + direction))

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{name:>16}: {t:8.3f}s ({t / total * 100:5.1f}%) x{self.counts[name]}"
                 for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])]
        for d in ("h2d", "d2h"):
            if self.bytes.get(d):
                w = self.transfer_wait(d)
                mb = self.bytes[d] / (1 << 20)
                eff = f" -> {mb / w:7.1f} MB/s blocked-effective" if w > 1e-9 else ""
                lines.append(f"{'link ' + d:>16}: {mb:8.1f} MB{eff}")
        return "\n".join(lines)
