"""Render reports and device timing.

Port of :mod:`tpuray.utils.metrics`.  The reference's observability is one
printf ("Done, took: N ms", raypng.c:96); here a timed render gives a
``RenderReport`` with the headline metric (Mrays/s, primary rays per
second) and names the device it ran on.  ``cuda_time_ms`` times work on the
card with CUDA events.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, List, Optional, Tuple

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
