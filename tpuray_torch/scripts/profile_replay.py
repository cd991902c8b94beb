"""Profile of the replay's gradient at 512x384 depth 3 (the BASELINE row)
or another depth and size.

Port of the JAX package's ``scripts/profile_replay.py``, with its
arguments and its four rows, under its labels:

* ``record fwd (kernel+resolve)``: the scene packed and K5, the record
  mode of the megakernel (``render_megakernel_record``);
* ``replay fwd``: ``replay.replay_render`` on K5's records;
* ``replay loss+grad``: the L2 loss through the replay and its gradient
  (``torch.autograd.grad``) with respect to every float leaf of the scene;
* ``full custom-vjp loss+grad``: the same through
  ``diff.render_megakernel_diff``, K5 forward and the replay backward.

The rows keep the JAX keys (``what``, ``ms``, ``config``) and add the
spread, ``timer``, ``cuda_kernels`` (the device operations one call puts on
the card, counted by ``torch.profiler``), ``peak_mib`` (the most memory a
call allocated), the kernels' ``launches`` over the timed calls and
``device``.  The four rows are timed in one process, interleaved call by
call, so their parts come from one run.  The allocator's cache is emptied
before each timed call (outside its time): the depth-15 replay allocates
tens of GB, and no row is timed with another row's blocks cached, so each
time includes its own allocations.

The JAX kernel deferred texel fetches to bounded event buffers
(``event_slots``); the port's kernel fetches texels itself, so it has none
and the script prints ``event_slots: 0``.

    python -m tpuray_torch.scripts.profile_replay [depth] [--json]
        [width height] [--device cuda] [--scene render.map]
        [--asset-dir assets] [--reps 5]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict

import torch

from ..benchmarks import add_input_args, golden_basis, load_inputs
from ..benchmarks.timing import (cuda_kernel_count,
                                 device_info, launch_counts, launches_since,
                                 print_device, require_device)
from ..config import RenderConfig
from ..diff import combine, l2_image_loss, partition, render_megakernel_diff
from ..kernels.megakernel import pack_scene, render_megakernel_record
from ..kernels.replay import replay_render

# one warm-up call and 5 timed calls a row: nothing compiles, and a
# depth-15 gradient row takes ~2 s a call
WARMUP = 1
REPS = 5
RECORD = "record fwd (kernel+resolve)"
REPLAY = "replay fwd"
REPLAY_GRAD = "replay loss+grad"
FULL = "full custom-vjp loss+grad"


def row_functions(scene, assets, basis,
                  cfg: RenderConfig) -> Dict[str, Callable[[], object]]:
    """label -> the row's call.  The forward rows return the image; the
    gradient rows return (loss, {leaf name: gradient}) over every float
    leaf of ``scene`` (``diff.partition``), the loss against a black
    target, as the JAX script's."""
    img0, records = render_megakernel_record(pack_scene(scene, basis),
                                             assets, cfg)
    target = torch.zeros_like(img0)
    d_scene, rest = partition(scene)

    def loss_and_grads(render):
        params = {k: v.detach().requires_grad_() for k, v in d_scene.items()}
        loss = l2_image_loss(render(combine(params, rest)), target)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for (k, p), g in zip(params.items(), grads)}

    return {
        RECORD: lambda: render_megakernel_record(pack_scene(scene, basis),
                                                 assets, cfg)[0],
        REPLAY: lambda: replay_render(scene, assets, basis, records, cfg),
        REPLAY_GRAD: lambda: loss_and_grads(
            lambda s: replay_render(s, assets, basis, records, cfg)),
        FULL: lambda: loss_and_grads(
            lambda s: render_megakernel_diff(s, assets, basis, cfg)),
    }


def _timed_call(fn, device) -> float:
    """ms of one call: CUDA events on the card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def profile_rows(rows: Dict[str, Callable[[], object]], device,
                 warmup: int = WARMUP, reps: int = REPS) -> Dict[str, dict]:
    """Time the rows interleaved: ``warmup`` calls of each, then ``reps``
    rounds of one timed call of each, then one call of each under the
    profiler.  label -> its statistics, with the kernels' ``launches`` over
    its ``reps`` timed calls."""
    cuda = device.type == "cuda"
    for fn in rows.values():
        for _ in range(warmup):
            fn()
    times = {label: [] for label in rows}
    peaks = dict.fromkeys(rows, 0.0)
    launches = {label: dict.fromkeys(launch_counts(), 0) for label in rows}
    for _ in range(reps):
        for label, fn in rows.items():
            before = launch_counts()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            times[label].append(_timed_call(fn, device))
            if cuda:
                peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
                peaks[label] = max(peaks[label], peak)
            for k, v in launches_since(before).items():
                launches[label][k] += v
    return {label: {"ms": statistics.median(times[label]),
                    "min_ms": min(times[label]), "max_ms": max(times[label]),
                    "reps": reps, "timer": "cuda_events" if cuda else "host",
                    "cuda_kernels": cuda_kernel_count(fn, device),
                    "peak_mib": peaks[label] if cuda else None,
                    "launches": launches[label]}
            for label, fn in rows.items()}


def main(argv=None) -> list:
    """Run the CLI; returns the rows (with ``--json``, the rows printed)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("depth", type=int, nargs="?", default=3)
    ap.add_argument("size", type=int, nargs="*", metavar="width height")
    ap.add_argument("--json", action="store_true",
                    help="one JSON row per line")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="timed calls a row, after warm-up calls")
    add_input_args(ap)
    args = ap.parse_intermixed_args(argv)
    if len(args.size) not in (0, 2):
        ap.error("give the size as two numbers: width height")
    width, height = args.size or (512, 384)
    device = require_device(args.device)
    info = device_info(device)
    print_device(info)

    scene, assets = load_inputs(args, device)
    cfg = RenderConfig(width=width, height=height, max_depth=args.depth,
                       shadow_samples=0)
    basis = golden_basis(width, height, device)
    print("record_slots:", cfg.resolved_record_slots(), "event_slots:", 0,
          "(the port's kernel fetches texels itself: no event buffers)",
          flush=True)
    config = f"{width}x{height}_d{args.depth}"
    rows = []
    for label, s in profile_rows(row_functions(scene, assets, basis, cfg),
                                 device, reps=args.reps).items():
        row = {"what": label, "ms": s.pop("ms"), "config": config, **s,
               "device": info["device"]}
        rows.append(row)
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            print(f"{label:40s} {row['ms']:8.2f} ms", flush=True)
    return rows


if __name__ == "__main__":
    main()
