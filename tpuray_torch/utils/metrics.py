"""Render reports, profiling and device timing.

Port of :mod:`tpuray.utils.metrics`.  The reference's observability is one
printf ("Done, took: N ms", raypng.c:96); here a timed render gives a
``RenderReport`` with the headline metric (Mrays/s, primary rays per
second) and names the device it ran on.  ``profile_trace`` wraps
``torch.profiler`` (the JAX package's wraps ``jax.profiler``) and writes a
Chrome trace; ``timed`` brackets a block with the device's synchronise;
``cuda_time_ms`` times work on the card with CUDA events.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import time
from typing import Callable, Iterator, List, Optional, Tuple

import torch


@dataclasses.dataclass
class RenderReport:
    width: int
    height: int
    max_depth: int
    seconds: float
    device: str
    first_seconds: Optional[float] = None   # first render, kernel build incl.

    @property
    def primary_rays(self) -> int:
        return self.width * self.height

    @property
    def mrays_per_s(self) -> float:
        return self.primary_rays / self.seconds / 1e6

    def to_json(self) -> str:
        """The JAX report's keys with its values (``compile_seconds`` is the
        first render, kernel build included), then the port's own."""
        d = {"width": self.width, "height": self.height,
             "max_depth": self.max_depth, "seconds": self.seconds,
             "compile_seconds": self.first_seconds,
             "mrays_per_s": round(self.mrays_per_s, 3)}
        d.update(dataclasses.asdict(self))
        return json.dumps(d)

    def __str__(self) -> str:
        first = (f" (first render {self.first_seconds * 1e3:.1f} ms)"
                 if self.first_seconds is not None else "")
        return (f"{self.width}x{self.height} depth={self.max_depth} on "
                f"{self.device}: {self.seconds * 1e3:.1f} ms, "
                f"{self.mrays_per_s:.2f} Mrays/s{first}")


def cuda_time_ms(fn: Callable[[], object], warmup: int = 3,
                 iters: int = 10) -> Tuple[float, List[float]]:
    """Median and all per-call times (ms) of ``fn`` on the current CUDA
    stream, each call bracketed by CUDA events after ``warmup`` calls.
    Raises without a card: a device time cannot come from the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block, CPU activity and, where a card is
    present, CUDA kernels; writes a Chrome trace (``*.pt.trace.json``,
    Perfetto or chrome://tracing) into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def timed(label: str, device="cpu") -> Iterator[None]:
    """Wall-clock bracket that ends with the device's synchronise (the
    clFinish equivalent, opencl_wrap.c:380) where ``device`` is CUDA."""
    device = torch.device(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
