"""Tracing / profiling hooks (SURVEY.md §5.1).

The reference's only instrumentation is tic/toc wall clocks. Here:
* ``wallclock`` — labeled wall-clock sections with a throughput counter
  (per-kernel solves/sec counters);
* ``device_trace`` — a jax.profiler trace context writing a TensorBoard-
  loadable profile (XLA op-level device timing).
"""
from __future__ import annotations

import contextlib
import time


class Timings:
    """Accumulates labeled wall-clock sections and item throughputs."""

    def __init__(self):
        self.sections: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, label: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.sections[label] = self.sections.get(label, 0.0) + dt
            self.counts[label] = self.counts.get(label, 0) + items

    def report(self) -> str:
        lines = [f"{'section':<28} {'time (s)':>10} {'items/s':>12}"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            n = self.counts.get(k, 0)
            rate = f"{n / v:,.0f}" if n and v > 0 else "-"
            lines.append(f"{k:<28} {v:>10.3f} {rate:>12}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
