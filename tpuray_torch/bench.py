"""Headline benchmark: primary Mrays/s at 1920x1080, depth 4, on render.map.

Port of the JAX package's ``bench.py``: the same configuration (the golden
camera at a 90 degree field of view, ``chunk_size=0``), the same metric
name and ``vs_baseline`` against the same ``BASELINE_MRAYS``.  It prints the
device on one line, then ONE JSON line: ``metric``, ``value``, ``unit``,
``vs_baseline`` (the JAX keys), then ``config``, ``ms_per_render`` with
its spread (``min_ms``, ``max_ms``, ``reps``, ``timer``), ``kernel_ms`` with
its spread, the kernels' ``launches`` and ``device``.

``value`` is computed over the whole ``render.render_from_basis`` call, as
the JAX script timed the whole render call: the scene is packed on every
call, then K1 is launched.  ``kernel_ms`` is K1 alone (CUDA events around
``render_megakernel`` on the scene packed once), so the line shows both the
call and the kernel.

    python -m tpuray_torch.bench [--scene render.map] [--asset-dir assets]
        [--device cuda] [--reps 10] [--width 1920 --height 1080 --depth 4]
"""
from __future__ import annotations

import argparse
import json

from .benchmarks import add_input_args, golden_basis, load_inputs
from .benchmarks.stages import time_render
from .benchmarks.timing import REPS, device_info, print_device, require_device
from .config import RenderConfig

# 1.0 == 100 Mrays/s, the JAX package's BASELINE.json north star
BASELINE_MRAYS = 100.0
METRIC = "primary_mrays_per_s_1080p_depth4"


def main(argv=None) -> dict:
    """Run the CLI; returns the row it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--reps", type=int, default=REPS,
                    help="timed calls, after warm-up calls")
    add_input_args(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    info = device_info(device)
    print_device(info)

    scene, assets = load_inputs(args, device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, chunk_size=0,
                       engine="megakernel")
    basis = golden_basis(cfg.width, cfg.height, device)
    t = time_render(scene, assets, basis, cfg, device, reps=args.reps)
    mrays = t.pop("mrays_per_s")
    row = {"metric": METRIC, "value": mrays, "unit": "Mrays/s/chip",
           "vs_baseline": mrays / BASELINE_MRAYS,
           "config": f"{cfg.width}x{cfg.height}_d{cfg.max_depth}", **t,
           "device": info["device"]}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
