"""Profiling & observability: jax.profiler traces + throughput counters.

The reference has no tracing/metrics beyond two counters (SURVEY.md §5);
this framework adds the planned equivalents: device traces around encode
steps and audio-seconds/sec accounting.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class ThroughputMeter:
    """Accumulates encoded audio-seconds and wall time."""

    sample_rate: int = 44100
    frames: int = 0
    bytes_out: int = 0
    wall_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, frames: int = 0, bytes_out: int = 0) -> None:
        self.wall_seconds += time.perf_counter() - self._t0
        self.frames += frames
        self.bytes_out += bytes_out

    @property
    def audio_seconds(self) -> float:
        return self.frames * 1152 / self.sample_rate

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self) -> dict:
        return {
            "frames": self.frames,
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "realtime_factor": round(self.realtime_factor, 1),
            "bytes_out": self.bytes_out,
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace around a code block (view with TensorBoard or
    xprof). No-op fallback if the profiler is unavailable."""
    import jax

    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region (shows up in profiler timelines)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
