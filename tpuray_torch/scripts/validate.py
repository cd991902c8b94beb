"""Validation run: the port's evidence suite in one JSON file.

Port of the JAX package's ``scripts/validate.py``, with its sections and
its JSON layout (``round``, ``timestamp``, ``golden``, ``stages``,
``invrender``, ``replay``, ``bench``, ``golden_gate_psnr45``):

* ``golden``: the 800x600 depth-15 render (``render_from_basis_checked``)
  against the reference's ``out/scene.png`` (``--golden``).  Without that
  file the section records ``{"measured": false, "reason": ...}`` and the
  gate is ``null``;
* ``stages``: the rows of :mod:`tpuray_torch.benchmarks.stages`;
* ``invrender``: the recovery of ``tpuray_torch.apps.invrender`` at 128x96
  depth 3 over 200 steps (parameter and observable errors before and
  after);
* ``replay``: the rows of :mod:`tpuray_torch.scripts.profile_replay` at
  depths 3 and 15;
* ``bench``: the line of :mod:`tpuray_torch.bench`.

Every section runs in this process on ``--device`` with ``--scene`` and
``--asset-dir``.  A section that fails raises, and a golden PSNR under
45 dB exits nonzero after the file is written.  The file goes to
``out/validate/validate_r<round>.json`` unless ``--out`` says otherwise.

    python -m tpuray_torch.scripts.validate [--round 3] [--out PATH]
        [--stages 1,2,3,4,5,6] [--skip-stages] [--skip-invrender]
        [--skip-replay] [--golden out/scene.png] [--device cuda]
        [--scene render.map] [--asset-dir assets]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from .. import bench
from ..apps import invrender
from ..benchmarks import add_input_args, golden_basis, load_inputs, stages
from ..benchmarks.timing import (device_info, launch_counts, launches_since,
                                 print_device, require_device)
from ..config import RenderConfig
from ..io import GOLDEN_PNG, image_diff_stats, read_png
from ..render import quantize_image, render_from_basis_checked
from . import profile_replay

OUT_DIR = os.path.join("out", "validate")
GOLDEN_GATE_PSNR = 45.0
# the sections' configurations, as the JAX script runs them
GOLDEN_CFG = RenderConfig(width=800, height=600, max_depth=15, chunk_size=0)
STAGES_ARGV: list = []
INVRENDER_ARGV = ["--steps", "200", "--width", "128", "--height", "96",
                  "--lr", "3e-2", "--light-lr-scale", "1.0"]
REPLAY_ARGV = (["3", "--json"], ["15", "--json"])
BENCH_ARGV: list = []


def run_golden(scene, assets, golden_path: str, device, info: dict) -> dict:
    """The golden section at ``GOLDEN_CFG``: the JAX keys, ``measured``,
    the image compared with and ``device``."""
    cfg = GOLDEN_CFG
    config = (f"{cfg.width}x{cfg.height}_depth{cfg.max_depth}"
              "_vs_reference_golden")
    if not os.path.exists(golden_path):
        return {"config": config, "measured": False,
                "reason": f"no golden image at {golden_path}",
                "device": info["device"]}
    basis = golden_basis(cfg.width, cfg.height, device)
    rgb, report = render_from_basis_checked(scene, assets, basis, cfg)
    img = quantize_image(rgb, cfg.width, cfg.height).cpu().numpy()
    s = image_diff_stats(img, read_png(golden_path))
    return {"config": config, "backend": device.type,
            "engine": report["engine"], "event_retries": report["retries"],
            "mean_abs": s.mean_abs, "max_abs": s.max_abs,
            "frac_within_1": s.frac_within_1,
            "frac_within_8": s.frac_within_8, "psnr_db": float(s.psnr),
            "measured": True, "golden": golden_path,
            "device": info["device"]}


def run_invrender(argv: list, info: dict) -> dict:
    """The recovery section: the JAX keys, the host time of the training
    loop, the kernels' launches and ``device``."""
    before = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        res = invrender.main([*INVRENDER_ARGV, *argv, "--checkpoint",
                              os.path.join(tmp, "validate_inv.pt")])
    a = dict(zip(INVRENDER_ARGV[::2], INVRENDER_ARGV[1::2]))
    obs0, obs1 = res["obs0"], res["obs1"]
    return {"config": f"{a['--width']}x{a['--height']}_depth"
                      f"{a.get('--depth', 3)}_{a['--steps']}steps",
            "param_err_start": res["err0"], "param_err_end": res["err1"],
            "observable_err_start": obs0, "observable_err_end": obs1,
            "recovered_frac": 1.0 - obs1 / max(obs0, 1e-9),
            "train_seconds": res["train_seconds"],
            "launches": launches_since(before), "device": info["device"]}


def main(argv=None) -> dict:
    """Run the CLI; returns the results it wrote."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--round", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--stages", default="1,2,3,4,5,6")
    ap.add_argument("--skip-stages", action="store_true")
    ap.add_argument("--skip-invrender", action="store_true")
    ap.add_argument("--skip-replay", action="store_true")
    ap.add_argument("--golden", default=GOLDEN_PNG,
                    help="the reference's out/scene.png")
    add_input_args(ap)
    args = ap.parse_args(argv)
    out_path = args.out or os.path.join(OUT_DIR,
                                        f"validate_r{args.round}.json")
    device = require_device(args.device)
    info = device_info(device)
    print_device(info)
    inputs = ["--device", args.device, "--scene", args.scene, "--asset-dir",
              args.asset_dir]
    results = {"round": args.round, "timestamp": int(time.time())}

    def section(name):
        print(f"== {name} ==", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    section("golden parity")
    scene, assets = load_inputs(args, device)
    results["golden"] = run_golden(scene, assets, args.golden, device, info)
    print(json.dumps(results["golden"]), flush=True)
    del scene, assets

    if not args.skip_stages:
        section("stages")
        results["stages"] = stages.main(["--stages", args.stages, *inputs,
                                         *STAGES_ARGV])
    if not args.skip_invrender:
        section("invrender recovery")
        results["invrender"] = run_invrender(inputs, info)
        print(json.dumps(results["invrender"]), flush=True)
    if not args.skip_replay:
        section("replay VJP")
        results["replay"] = [row for a in REPLAY_ARGV
                             for row in profile_replay.main([*a, *inputs])]
    section("headline bench")
    results["bench"] = bench.main([*inputs, *BENCH_ARGV])

    golden = results["golden"]
    ok = (bool(golden["psnr_db"] >= GOLDEN_GATE_PSNR) if golden["measured"]
          else None)
    results["golden_gate_psnr45"] = ok
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out_path}  (golden gate >= {GOLDEN_GATE_PSNR:g} dB: "
          f"{'not measured' if ok is None else ok})", flush=True)
    if ok is False:
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
