"""Profiling and tracing utilities.

The reference's observability is OpenCL event profiling feeding
`compute_time` (main.cpp:33-76) plus printf banners.  Equivalents:

  * `Stopwatch` — wall-clock stage timer that waits for each stage's
    result with `jax.block_until_ready` (the engine behind
    bench.harness.StageTimer).
  * `trace` — context manager around jax.profiler for device traces
    when deeper analysis is needed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


class Stopwatch:
    """Accumulating wall-clock timer with device synchronisation."""

    def __init__(self):
        self.ms: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            jax.block_until_ready(holder.get("out", sync_value))
            self.ms[name] = self.ms.get(name, 0.0) + (
                time.perf_counter() - t0) * 1000.0
            self.counts[name] = self.counts.get(name, 0) + 1

    def timed(self, name: str, fn, *args):
        with self.section(name) as h:
            h["out"] = fn(*args)
        return h["out"]

    def report(self) -> str:
        width = max((len(k) for k in self.ms), default=0)
        lines = [
            f"{k:<{width}}  {v:9.3f} ms  (x{self.counts[k]})"
            for k, v in sorted(self.ms.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace for TensorBoard (xprof) inspection."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
