"""Staged benchmark suite: the BASELINE stages 1-6, one JSON row a stage.

Port of the JAX package's ``benchmarks/stages.py``, with its stages
(``STAGES``), its row keys (``stage``, ``config``, ``ms_per_render``,
``mrays_per_s``) and its engine, the megakernel (K1 on the canonical scene,
K3 on the meshes).  Each row adds the spread of its samples, ``timer``,
``kernel_ms`` (the kernel alone, on a scene packed once), the kernels'
``launches`` and ``device``.

``ms_per_render`` is the time of a whole ``render_from_basis`` call, as the
JAX script timed the whole jitted render: it packs the scene (and, for a
mesh, builds its triangle tables) on every call, then launches the kernel.

    python -m tpuray_torch.benchmarks.stages [--stages 1,2,3] [--chain 10]
        [--device cuda] [--scene render.map] [--asset-dir assets]
        [--width W --height H]

``--chain`` is the number of timed calls a stage (the JAX script's chain
length; here each call is a sample).  ``--width``/``--height`` shrink every
stage to one size for a quick run; its rows say so under ``reduced``.
"""
from __future__ import annotations

import argparse
import json
from typing import NamedTuple, Optional, Tuple

from ..config import RenderConfig
from ..kernels.megakernel import pack_scene, render_megakernel
from ..meshes import mesh_benchmark_scene
from ..render import render_from_basis
from ..scene import build_scene
from . import add_input_args, golden_basis, load_assets, load_inputs
from .timing import (REPS, WARMUP, device_info, launch_counts, launches_since,
                     measure, print_device, require_device)


class Stage(NamedTuple):
    stage: int
    config: str            # the JAX row's name
    width: int
    height: int
    max_depth: int
    shadow_samples: int
    # None: the canonical scene (--scene); else mesh_benchmark_scene's
    # (order, torus_res)
    mesh: Optional[Tuple[int, Tuple[int, int]]]


# benchmarks/stages.py:81-103; every stage renders with chunk_size=0
STAGES = {s.stage: s for s in (
    Stage(1, "256x256_depth1_diffuse", 256, 256, 1, 0, None),
    Stage(2, "800x600_depth15_reference", 800, 600, 15, 2, None),
    Stage(3, "1920x1080_depth4", 1920, 1080, 4, 2, None),
    Stage(4, "3840x2160_depth6", 3840, 2160, 6, 2, None),
    Stage(5, "512x384_depth3_mesh7k", 512, 384, 3, 2, (4, (48, 24))),
    Stage(6, "3840x2160_depth6_mesh10k", 3840, 2160, 6, 2, (4, (64, 40))),
)}


def stage_config(stage: Stage, width: Optional[int] = None,
                 height: Optional[int] = None) -> RenderConfig:
    """The stage's configuration, at ``width`` x ``height`` if given."""
    return RenderConfig(width=width or stage.width,
                        height=height or stage.height,
                        max_depth=stage.max_depth,
                        shadow_samples=stage.shadow_samples, chunk_size=0,
                        engine="megakernel")


def time_render(scene, assets, basis, cfg: RenderConfig, device,
                warmup: int = WARMUP, reps: int = REPS) -> dict:
    """A row's timings: ``render_from_basis`` (``ms_per_render`` and its
    ``mrays_per_s``, primary rays a second, with ``min_ms``, ``max_ms``,
    ``reps`` and ``timer``), then the megakernel alone on the scene packed
    once (``kernel_ms``, ``kernel_min_ms``, ``kernel_max_ms``), and the
    kernels' ``launches`` over both."""
    before = launch_counts()
    call = measure(lambda: render_from_basis(scene, assets, basis, cfg),
                   device, warmup, reps)
    packed = pack_scene(scene, basis)
    kernel = measure(lambda: render_megakernel(packed, assets, cfg), device,
                     warmup, reps)
    return {"ms_per_render": call["ms"],
            "mrays_per_s": cfg.width * cfg.height / call["ms"] / 1e3,
            "min_ms": call["min_ms"], "max_ms": call["max_ms"],
            "reps": reps, "timer": call["timer"],
            "kernel_ms": kernel["ms"], "kernel_min_ms": kernel["min_ms"],
            "kernel_max_ms": kernel["max_ms"],
            "launches": launches_since(before)}


def main(argv=None) -> list:
    """Run the CLI; returns the rows it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stages", default="1,2,3")
    ap.add_argument("--chain", type=int, default=REPS,
                    help="timed calls a stage, after warm-up calls")
    ap.add_argument("--width", type=int, default=None,
                    help="render every stage at this width (a reduced run)")
    ap.add_argument("--height", type=int, default=None)
    add_input_args(ap)
    args = ap.parse_args(argv)
    stages = sorted({int(s) for s in args.stages.split(",")})
    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        raise ValueError(f"unknown stage(s) {unknown}; expected some of "
                         f"{sorted(STAGES)}")
    device = require_device(args.device)
    info = device_info(device)
    print_device(info)

    if any(STAGES[s].mesh is None for s in stages):
        canonical, assets = load_inputs(args, device)
    else:
        assets = load_assets(args, device)
    rows = []
    for s in stages:
        stage = STAGES[s]
        cfg = stage_config(stage, args.width, args.height)
        scene = (canonical if stage.mesh is None else
                 build_scene(mesh_benchmark_scene(*stage.mesh), device))
        basis = golden_basis(cfg.width, cfg.height, device)
        row = {"stage": s, "config": stage.config,
               **time_render(scene, assets, basis, cfg, device,
                             reps=args.chain),
               "device": info["device"]}
        if args.width or args.height:
            row["reduced"] = f"{cfg.width}x{cfg.height}"
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
