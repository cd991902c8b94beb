"""Decompose the mesh render's time (stage 5: 7,424 triangles at 512x384
depth 3): closest hits against shadow feelers against the rest.

Port of the JAX package's ``scripts/profile_tri.py``: the same variants,
each by the same ``RenderConfig.replace`` of the base configuration, and
its row keys (``variant``, ``ms``, ``mrays_per_s``), with the timings of
:func:`benchmarks.stages.time_render` beside them.

    python -m tpuray_torch.scripts.profile_tri [--variants base,noshadow,d1]
        [--order 4] [--width 512 --height 384 --depth 3] [--chain 10]
        [--device cuda] [--asset-dir assets]

Variants: ``base``; ``noshadow`` (no shadow samples); ``d1`` (depth 1);
``d1noshadow``; ``s1`` (one shadow sample); ``notri`` (the same scene with
the mesh removed: spheres, planes, lights and the DFS alone).  The JAX
script's ``nocull`` turned off a debug switch of the TPU kernel's triangle
culls (``pallas_trace._TRI_CULL``), which the port does not have; asking
for it raises.  So the default list leaves it out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..benchmarks import add_input_args, golden_basis, load_assets
from ..benchmarks.stages import time_render
from ..benchmarks.timing import (REPS, device_info, print_device,
                                 require_device)
from ..config import RenderConfig
from ..meshes import mesh_benchmark_scene
from ..scene import build_scene

# name -> the fields the JAX script replaces in the base configuration
# (profile_tri.py:82-102); notri renders the base configuration without
# the mesh
VARIANTS = {
    "base": {},
    "noshadow": {"shadow_samples": 0},
    "d1": {"max_depth": 1},
    "d1noshadow": {"max_depth": 1, "shadow_samples": 0},
    "s1": {"shadow_samples": 1},
    "notri": {},
}
NOT_PORTED = {
    "nocull": "the variant 'nocull' toggled pallas_trace._TRI_CULL, a debug "
              "switch of the TPU kernel's triangle culls (the TPURAY_TRI_* "
              "knobs, which the port does not carry over); the port's "
              "triangle walk has no such switch",
}


def variant_configs(base: RenderConfig, names) -> dict:
    """name -> configuration of each variant in ``names``.  Raises on a
    variant that is not ported or unknown, before anything is rendered."""
    for name in names:
        if name in NOT_PORTED:
            raise ValueError(NOT_PORTED[name])
        if name not in VARIANTS:
            raise ValueError(f"unknown variant {name!r}; expected some of "
                             f"{sorted(VARIANTS)}")
    return {name: base.replace(**VARIANTS[name]) for name in names}


def main(argv=None) -> list:
    """Run the CLI; returns the rows it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--variants", default="base,noshadow,d1")
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--chain", type=int, default=REPS,
                    help="timed calls a variant, after warm-up calls")
    add_input_args(ap, scene=False)
    args = ap.parse_args(argv)
    base = RenderConfig(width=args.width, height=args.height,
                        max_depth=args.depth, chunk_size=0,
                        engine="megakernel")
    configs = variant_configs(base, args.variants.split(","))
    device = require_device(args.device)
    info = device_info(device)
    print_device(info)

    assets = load_assets(args, device)
    spec = mesh_benchmark_scene(args.order)
    mesh = build_scene(spec, device)
    basis = golden_basis(base.width, base.height, device)
    rows = []
    for name, cfg in configs.items():
        scene = (build_scene(dataclasses.replace(spec, triangles=[]), device)
                 if name == "notri" else mesh)
        t = time_render(scene, assets, basis, cfg, device, reps=args.chain)
        row = {"variant": name, "ms": t.pop("ms_per_render"), **t,
               "device": info["device"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
