"""The large-mesh benchmark: the scene whose triangle tables the JAX kernel
streamed from HBM (K4; one code path with K3 in the port).

Port of the JAX package's ``benchmarks/stream.py``, with its defaults:
an order-6 icosphere (81,920 triangles) and a 256 x 160 torus (81,920
more), 163,840 triangles in all, at 512x384 depth 3.  The row's ``config``
names ``scene.num_triangles``, as the JAX row does.  Its timings are those
of :func:`stages.time_render`; ``build_s`` is the host's build of the
scene (``mesh_benchmark_scene`` and ``build_scene``), which the JAX row did
not time.

    python -m tpuray_torch.benchmarks.stream [--order 6] [--torus 256,160]
        [--width 512 --height 384 --depth 3] [--chain 10]
        [--device cuda] [--asset-dir assets]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import RenderConfig
from ..meshes import mesh_benchmark_scene
from ..scene import build_scene
from . import add_input_args, golden_basis, load_assets
from .stages import time_render
from .timing import REPS, device_info, print_device, require_device


def main(argv=None) -> dict:
    """Run the CLI; returns the row it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--order", type=int, default=6,
                    help="icosphere order (6 -> 81,920 triangles)")
    ap.add_argument("--torus", default="256,160",
                    help="nu,nv torus resolution (256,160 -> 81,920)")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--chain", type=int, default=REPS,
                    help="timed calls, after warm-up calls")
    add_input_args(ap, scene=False)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    info = device_info(device)
    print_device(info)

    assets = load_assets(args, device)
    nu, nv = (int(x) for x in args.torus.split(","))
    t0 = time.perf_counter()
    scene = build_scene(mesh_benchmark_scene(args.order, torus_res=(nu, nv)),
                        device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, chunk_size=0,
                       engine="megakernel")
    basis = golden_basis(cfg.width, cfg.height, device)
    row = {"config": f"{args.width}x{args.height}_d{args.depth}_"
                     f"tri{scene.num_triangles}_streamed",
           **time_render(scene, assets, basis, cfg, device, reps=args.chain),
           "build_s": build_s, "device": info["device"]}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
