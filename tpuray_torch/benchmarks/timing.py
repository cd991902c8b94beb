"""Timing, device reporting and kernel launch counts for the port's
benchmark and profiling entry points.

The JAX scripts timed a chain of renders inside one jitted program and took
the slope over the chain length (``bench.py:95-114``,
``benchmarks/stages.py:19-53``, ``benchmarks/scaling.py:33-55``,
``scripts/profile_tri.py:19-42``), because asynchronous dispatch could make
a TPU call return before its work was done.  On the card each call is
bracketed by CUDA events on its stream (:func:`utils.metrics.cuda_time_ms`),
so one call is one sample and the spread of the samples is reported beside
their median.  On an explicit ``--device cpu`` the host clock times the
plain PyTorch versions, and every row says so (``timer: "host"``).
"""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Optional

import torch

from ..kernels.megakernel import render_megakernel, render_megakernel_record
from ..kernels.query import tri_query_blocker, tri_query_closest
from ..utils.metrics import cuda_time_ms

WARMUP = 2
REPS = 10


def require_device(name: str) -> torch.device:
    """The torch device ``--device name`` asks for.  A CUDA device on a
    machine without one raises: a measurement never falls back to the
    CPU."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected cuda or cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to time the plain PyTorch "
                           "versions on the host clock)")
    return device


def measure(fn: Callable[[], object], device, warmup: int = WARMUP,
            reps: int = REPS) -> dict:
    """Time ``reps`` calls of ``fn`` after ``warmup`` calls: the median
    ``ms``, ``min_ms``, ``max_ms``, ``reps`` and ``timer``.  On a CUDA
    device each call is bracketed by CUDA events on the current stream
    (``timer: "cuda_events"``); on the CPU by the host clock (``"host"``)."""
    if reps < 1:
        raise ValueError(f"reps must be at least 1, got {reps}")
    device = torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            ms, times = cuda_time_ms(fn, warmup, reps)
        timer = "cuda_events"
    else:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms, timer = statistics.median(times), "host"
    return {"ms": ms, "min_ms": min(times), "max_ms": max(times),
            "reps": reps, "timer": timer}


def _smi_line(index: int) -> str:
    """The card's line of ``nvidia-smi --query-gpu=name,power.limit``, or
    its name from torch and why the power limit is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return (f"{torch.cuda.get_device_name(index)}, power limit not read "
                f"({type(e).__name__})")
    lines = [ln.strip() for ln in out if ln.strip()]
    return lines[index] if index < len(lines) else lines[0]


def device_info(device) -> dict:
    """What a row names its device by: ``device`` is the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (``"cpu"`` on the CPU), with the
    torch and CUDA versions beside it."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        label = _smi_line(index)
    else:
        label = "cpu"
    return {"device": label, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def print_device(info: dict) -> None:
    """The line every entry point prints before its rows."""
    print(f"device: {info['device']}; torch {info['torch']}; CUDA "
          f"{info['cuda']}", flush=True)


def launch_counts() -> dict:
    """The kernel wrappers' launch counters now: K1-K4 (``megakernel``),
    K5 (``megakernel_record``) and K6 (``tri_query``, both queries)."""
    return {"megakernel": render_megakernel.launches,
            "megakernel_record": render_megakernel_record.launches,
            "tri_query": tri_query_closest.launches
            + tri_query_blocker.launches}


def launches_since(before: dict) -> dict:
    """Launches of each kernel since ``before`` (:func:`launch_counts`)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def cuda_kernel_count(fn: Callable[[], object],
                      device) -> Optional[int]:
    """The device operations (kernels, copies, memsets) one call of ``fn``
    puts on the card, counted by ``torch.profiler`` tracing the card alone
    (the host's ops unrecorded, the raw events counted: a replay step at
    depth 15 puts ~80k operations on the card); None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type() == DeviceType.CUDA
               for e in prof.profiler.kineto_results.events())
