"""Multi-rank scaling harness: the sharded forward render over worlds of
1, 2, 4, ... ranks, with throughput and efficiency against one rank.

Port of the JAX package's ``benchmarks/scaling.py``, with its layouts,
flags and row keys (``layout``, ``backend``, ``devices``,
``ms_per_render``, ``mrays_per_s``, ``efficiency``).  As in the JAX
harness, both layouts render with the whole-image tracer:

* ``pixel`` (default): ``parallel.shard.render_sharded`` on ``--scene``,
  the pixels split over the ranks;
* ``scene``: ``render_scene_parallel`` on ``mesh_benchmark_scene``, every
  rank tracing every ray against its slice of the triangles (on the card
  through the triangle-query kernel, K6).

Each world is started by ``parallel.distributed.launch``.  On the card a
world of up to ``torch.cuda.device_count()`` ranks runs NCCL, a rank a
card; a larger world shares the cards over gloo (NCCL refuses two ranks on
one card), and its row says so in ``dist_backend``: such rows check the
plumbing, they do not measure scaling.  With ``--device cpu`` every world
runs gloo on the CPU.  Each rank times the render as every entry point
does (``timing.measure``); a world's time is its slowest rank's median.
The rows add ``dist_backend``, the spread, ``timer``, each rank's median
(``rank_ms``), rank 0's kernel ``launches`` and ``device``.

    python -m tpuray_torch.benchmarks.scaling [--max-devices N]
        [--layout pixel|scene] [--width 1920 --height 1080 --depth 4]
        [--mesh-order 4] [--reps 10] [--device cuda] [--scene render.map]
        [--asset-dir assets]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..config import RenderConfig
from ..meshes import mesh_benchmark_scene
from ..scene import build_scene
from ..sceneio import load_scene
from ..textures import load_default_assets
from . import require_path, add_input_args, golden_basis
from .timing import (REPS, device_info, launch_counts, launches_since,
                     measure, print_device, require_device)

WORLD_TIMEOUT = 3600.0


def rank_time(layout: str, cfg: RenderConfig, scene_path: str,
              asset_dir: str, mesh_order: int, device_type: str,
              reps: int) -> dict:
    """One rank of a world (run by ``distributed.launch``): build the
    inputs on this rank's device, then time the sharded render."""
    from ..parallel.shard import (make_mesh, render_scene_parallel,
                                  render_sharded)

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    assets = load_default_assets(asset_dir, device=dev)
    if layout == "scene":
        scene = build_scene(mesh_benchmark_scene(mesh_order), dev)
        render = render_scene_parallel
    else:
        scene = load_scene(scene_path).to_scene(dev)
        render = render_sharded
    mesh = make_mesh(device=dev)
    basis = golden_basis(cfg.width, cfg.height, dev)
    before = launch_counts()
    t = measure(lambda: render(scene, assets, basis, cfg, mesh), dev,
                reps=reps)
    return {**t, "launches": launches_since(before)}


def main(argv=None) -> list:
    """Run the CLI; returns the rows it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--max-devices", type=int, default=None,
                    help="largest world (default: the cards, or 1 rank on "
                         "the CPU)")
    ap.add_argument("--layout", default="pixel", choices=("pixel", "scene"))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--mesh-order", type=int, default=4,
                    help="icosphere order for --layout scene")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="timed renders a rank, after warm-up renders")
    add_input_args(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    info = device_info(device)
    print_device(info)

    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    n_max = args.max_devices or cards
    asset_dir = require_path(args.asset_dir, "--asset-dir")
    scene_path = (require_path(args.scene, "--scene") if args.layout == "pixel"
                  else args.scene)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, chunk_size=0, engine="tracer")
    if device.type == "cuda":
        from ..kernels.build import load_library
        load_library()      # once here: every rank loads the cached build
    from ..parallel.distributed import launch

    rows, base_rate, n = [], None, 1
    while n <= n_max:
        backend = "nccl" if device.type == "cuda" and n <= cards else "gloo"
        ranks = launch(rank_time, n, args.layout, cfg, scene_path, asset_dir,
                       args.mesh_order, device.type, args.reps,
                       backend=backend, device=device.type,
                       timeout=WORLD_TIMEOUT)
        slowest = max(ranks, key=lambda r: r["ms"])
        rate = cfg.width * cfg.height / slowest["ms"] / 1e3
        base_rate = base_rate or rate
        row = {"layout": args.layout, "backend": device.type, "devices": n,
               "ms_per_render": slowest["ms"], "mrays_per_s": rate,
               "efficiency": rate / (base_rate * n), "dist_backend": backend,
               "min_ms": slowest["min_ms"], "max_ms": slowest["max_ms"],
               "reps": args.reps, "timer": slowest["timer"],
               "rank_ms": [r["ms"] for r in ranks],
               "launches": ranks[0]["launches"], "device": info["device"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        n *= 2
    return rows


if __name__ == "__main__":
    main()
