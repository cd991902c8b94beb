"""Device time per launch of the megakernel in several source trees, to
compare two versions on one card in one run.

    python -m tpuray_torch.utils.kernel_ab PARENT . . PARENT

Each argument is a directory that holds a ``tpuray_torch`` package (this
checkout, or a ``git archive`` of another commit unpacked somewhere).  Each
tree runs in a process of its own, in the order given, so that the order
can alternate: it builds that tree's kernels, then times each case with
``torch.profiler``: the device time of the launches whose kernel name holds
``megakernel``, 5 warm-ups, median of 30, host overhead excluded.  The
cases are K1 and K5 (record mode) on ``canonical_scene_spec()`` at 512x384
depth 3 without shadow samples, at 128x96 depth 3 without, and at 800x600
depth 15 with 2; in a tree that has ``meshes.py``, the triangle path and
its record mode on ``mesh_benchmark_scene(4)`` (7,424 triangles) at
512x384 depth 3 with 2; and, in a tree that takes ``filter='bilinear'``,
K2 at 800x600 depth 15 with 2.  Assets are ``random_asset_arrays(0, 512, 512)``.

It prints the card's name and power limit, then per tree the registers and
stack frame that ptxas reports for each instantiation (when the tree's
kernels were built in this run) and one JSON line of medians in
microseconds.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CAMERA = ((0.8, 2.5, -8.0), (0.2, 0.0, 1.0), 90.0, 1.0)
WARMUP = 5
ITERS = 30
CASES = [  # name, width, height, depth, shadow samples, record, mesh, filter
    ("K1 512x384 d3 ss0", 512, 384, 3, 0, False, False, "nearest"),
    ("K1 128x96 d3 ss0", 128, 96, 3, 0, False, False, "nearest"),
    ("K1 800x600 d15 ss2", 800, 600, 15, 2, False, False, "nearest"),
    ("K5 512x384 d3 ss0", 512, 384, 3, 0, True, False, "nearest"),
    ("K5 128x96 d3 ss0", 128, 96, 3, 0, True, False, "nearest"),
    ("K5 800x600 d15 ss2", 800, 600, 15, 2, True, False, "nearest"),
    ("K3 512x384 d3 ss2 7424 tris", 512, 384, 3, 2, False, True, "nearest"),
    ("K5 512x384 d3 ss2 7424 tris", 512, 384, 3, 2, True, True, "nearest"),
    ("K2 800x600 d15 ss2", 800, 600, 15, 2, False, False, "bilinear"),
]


def worker(tree: str) -> None:
    """Time the cases with the ``tpuray_torch`` of ``tree``."""
    sys.path[0] = tree    # in place of this script's directory
    import torch

    import tpuray_torch as tt
    from tpuray_torch.kernels import build
    from tpuray_torch.kernels.megakernel import (pack_scene,
                                                 render_megakernel,
                                                 render_megakernel_record)
    if not os.path.abspath(tt.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {tt.__file__}, not the one in {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    log = build.load_library().log
    for line in log.splitlines():
        if "entry function" in line or "registers" in line \
                or "stack frame" in line:
            print("   ", line.strip())
    has_meshes = os.path.exists(os.path.join(tree, "tpuray_torch",
                                             "meshes.py"))
    dev = torch.device("cuda")
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 512, 512), dev)
    camera = tt.Camera(*CAMERA)
    out = {}
    for name, width, height, depth, samples, record, mesh, filt in CASES:
        if mesh and not has_meshes:
            continue
        try:
            cfg = tt.RenderConfig(width=width, height=height,
                                  max_depth=depth, shadow_samples=samples,
                                  filter=filt)
        except (NotImplementedError, ValueError):
            continue          # a tree without bilinear filtering
        if mesh:
            from tpuray_torch.meshes import mesh_benchmark_scene
            spec = mesh_benchmark_scene(4)
        else:
            spec = tt.canonical_scene_spec()
        packed = pack_scene(tt.build_scene(spec, dev), tt.perspective_basis(
            camera, width, height, device=dev))
        render = render_megakernel_record if record else render_megakernel
        for _ in range(WARMUP):
            render(packed, assets, cfg)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                render(packed, assets, cfg)
            torch.cuda.synchronize()
        times = [e.device_time for e in prof.events()
                 if "megakernel" in e.name]
        if len(times) != ITERS:
            raise RuntimeError(f"{name}: the profiler saw {len(times)} "
                               f"kernel launches, not {ITERS}")
        out[name] = round(statistics.median(times), 2)
    print("median us", json.dumps(out), flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--worker":
        worker(argv[1])
        return
    if not argv:
        raise SystemExit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in argv:
        tree = os.path.abspath(tree)
        print("==", tree, flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", tree], check=True, timeout=900)


if __name__ == "__main__":
    main()
