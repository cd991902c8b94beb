"""Offline renderer CLI, the ``raypng`` equivalent (raypng.c:11-106).

Port of :mod:`tpuray.apps.raypng`.  Loads a scene archive and the textures,
renders once with the reference camera (raypng.c:17-21), reports the time
and Mrays/s (the reference prints "Done, took: N ms", raypng.c:92-96),
writes a PNG and can diff it against the reference's committed image.

    python -m tpuray_torch.apps.raypng [--scene render.map] [--out out/scene.png]
        [--width 800 --height 600] [--depth 15] [--device cuda] [--compare-golden]
        [--engine auto|megakernel|tracer] [--chunk-size 65536]
        [--repeat N] [--profile LOGDIR] [--selfcheck]

``--engine tracer`` renders with the whole-image tracer (on the card its
triangle queries go through the triangle-query kernel), in chunks of
``--chunk-size`` pixels.  ``--profile LOGDIR`` traces the ``--repeat``
re-renders after the first with ``torch.profiler`` and writes a Chrome trace
into LOGDIR.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from ..camera import Camera
from ..config import (ENGINES, GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                      GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                      REFERENCE_DIR, RenderConfig)
from ..io import GOLDEN_PNG, image_diff_stats, read_png, write_png
from ..render import quantize_image, render
from ..sceneio import load_scene
from ..textures import DEFAULT_SKYBOX, REFERENCE_ASSETS, load_default_assets
from ..utils.debug import check_finite
from ..utils.metrics import RenderReport, profile_trace


def _render_once(scene, assets, cam, cfg, device):
    t0 = time.perf_counter()
    rgb = render(scene, assets, cam, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return rgb, time.perf_counter() - t0


def main(argv=None) -> dict:
    """Run the CLI; returns {"rgb", "image", "report", "golden"} (golden is
    the ``DiffStats`` with ``--compare-golden``, else None)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene",
                    default=os.path.join(REFERENCE_DIR, "scenes", "render.map"))
    ap.add_argument("--asset-dir", default=REFERENCE_ASSETS,
                    help="directory holding the four textures and bg/")
    ap.add_argument("--out", default="out/scene.png")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--depth", type=int, default=15)
    ap.add_argument("--shadow-samples", type=int, default=2)
    ap.add_argument("--skybox", default=DEFAULT_SKYBOX,
                    help="cross-layout cubemap relative to the asset dir "
                         "(the reference also ships bg/lake.png)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' runs the CUDA kernels")
    ap.add_argument("--engine", default="auto", choices=ENGINES,
                    help="'megakernel', 'tracer', or 'auto': the megakernel "
                         "where it takes the scene")
    ap.add_argument("--chunk-size", type=int, default=65536,
                    help="pixels per traced chunk of the tracer engine "
                         "(0: the whole image)")
    ap.add_argument("--compare-golden", action="store_true",
                    help="diff the output against the reference's committed "
                         "out/scene.png")
    ap.add_argument("--repeat", type=int, default=1,
                    help="renders to time; the best is reported")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="trace the re-renders after the first with "
                         "torch.profiler; a Chrome trace goes into LOGDIR")
    ap.add_argument("--selfcheck", action="store_true",
                    help="assert the rendered image is finite (NaN guard)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu for the plain "
                           "PyTorch version)")
    scene = load_scene(args.scene).to_scene(device)
    assets = load_default_assets(args.asset_dir, args.skybox, device=device)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                 GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth,
                       shadow_samples=args.shadow_samples,
                       engine=args.engine, chunk_size=args.chunk_size)

    rgb, first = _render_once(scene, assets, cam, cfg, device)
    best = first
    profile_ctx = (profile_trace(args.profile) if args.profile
                   else contextlib.nullcontext())
    with profile_ctx:
        for _ in range(max(0, args.repeat - 1)):
            rgb, s = _render_once(scene, assets, cam, cfg, device)
            best = min(best, s)

    if args.selfcheck:
        check_finite(rgb, "render")
        print("selfcheck: image finite")
    img = quantize_image(rgb, cfg.width, cfg.height).cpu().numpy()

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    report = RenderReport(width=cfg.width, height=cfg.height,
                          max_depth=cfg.max_depth, seconds=best, device=name,
                          first_seconds=first)
    print(report)
    print(f"Done, took: {best * 1000.0:.0f} ms")  # raypng.c:96 format

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, img)
    print(f"wrote {args.out}")

    stats = None
    if args.compare_golden:
        stats = image_diff_stats(img, read_png(GOLDEN_PNG))
        print(f"golden diff: {stats}")
    return {"rgb": rgb, "image": img, "report": report, "golden": stats}


if __name__ == "__main__":
    main()
