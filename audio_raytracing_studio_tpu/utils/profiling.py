"""Tracing / profiling harness (SURVEY §5.1).

The reference's only instrumentation is print() narration; this module is
the framework-grade replacement: named trace annotations that show up in the
JAX device profiler, a block-until-ready timing harness for steady-state
throughput numbers, and a programmatic profiler-session helper.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from typing import Callable, Iterator

import jax


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Named region for the JAX profiler timeline."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profiler_session(log_dir: str) -> Iterator[None]:
    """Capture a full device trace into ``log_dir`` (TensorBoard format)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class TimingResult:
    name: str
    iterations: int
    seconds_per_call: float
    seconds_median: float
    seconds_min: float

    def realtime_factor(self, audio_seconds: float) -> float:
        return audio_seconds / self.seconds_per_call

    def __str__(self) -> str:
        return (
            f"{self.name}: {self.seconds_per_call * 1e3:.2f} ms/call "
            f"(median {self.seconds_median * 1e3:.2f}, min {self.seconds_min * 1e3:.2f}, "
            f"n={self.iterations})"
        )


def time_jitted(
    fn: Callable,
    *args,
    name: str = "fn",
    iterations: int = 5,
    warmup: int = 1,
    **kwargs,
) -> TimingResult:
    """Steady-state timing of a device computation.

    Compiles/warms up first, then measures wall time per call; every call
    ends in ``jax.block_until_ready`` so the clock covers the device work,
    not just the enqueue.
    """
    for _ in range(max(1, warmup)):
        jax.block_until_ready(fn(*args, **kwargs))
    samples = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        samples.append(time.perf_counter() - t0)
    return TimingResult(
        name=name,
        iterations=iterations,
        seconds_per_call=sum(samples) / len(samples),
        seconds_median=statistics.median(samples),
        seconds_min=min(samples),
    )


REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compilation_cache_dir() -> str:
    """Where compiled executables persist: ``JAX_COMPILATION_CACHE_DIR``
    when set, else the fixed ``.jax_cache`` at the checkout root (a fixed
    path, because the path is part of what a later process must find)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_compilation_cache() -> str:
    """Persist compiled XLA executables across processes (SURVEY §5.4).

    Makes "resume" include warm compile state: a rerun of the same render
    configuration skips its first compile.  Returns the directory used.
    """
    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
