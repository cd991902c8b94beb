"""Device time per launch of the CUDA kernels in several source trees, to
compare two versions on one card in one run.

    python -m tpuray_torch.utils.kernel_ab [--only PREFIX] PARENT . . PARENT

Each argument is a directory that holds a ``tpuray_torch`` package (this
checkout, or a ``git archive`` of another commit unpacked somewhere).  Each
tree runs in a process of its own, in the order given, so that the order
can alternate: it builds that tree's kernels, then times each case with
``torch.profiler``: the device time of the kernels whose name holds
``megakernel`` or ``tri_query`` (all of one call summed: the query kernel
may be two launches), 5 warm-ups, median of 30 calls, host overhead
excluded.  The cases are K1 and K5 (record mode) on
``canonical_scene_spec()`` at 512x384 depth 3 without shadow samples, at
128x96 depth 3 without, and at 800x600 depth 15 with 2 (K1 and K5 also on
rows 368-399 of that frame, which hold its deepest pixels, with 2 and
without; K1 at 1920x1080 depth 4 with 2 and without; K5 at 256x192 depth 3
with 2, and with ``filter='bilinear'`` at 800x600 depth 15 with 2, in a tree
that takes it); in a tree that has ``meshes.py``, the
triangle path and its record mode on ``mesh_benchmark_scene(4)`` (7,424
triangles) at 512x384 depth 3 with 2, the triangle path on 163,840
triangles (``(6, torus_res=(256, 160))``) at 512x384 depth 3 with 2 and on
10,240 (``(4, torus_res=(64, 40))``) at 3840x2160 depth 6 with 2; in a tree
that takes ``filter='bilinear'``, K2 at 800x600 depth 15 and 1920x1080
depth 4 with 2; and in a tree that has ``kernels/query.py``, the
triangle-query kernel's closest and blocker queries on the 512x384 primary
rays over 7,424 and 163,840 triangles (blocker ranges 1.5 or 0.5 times the
closest hit, 4 on a miss, every 11th ray inactive).  Assets are
``random_asset_arrays(0, 512, 512)``.  ``--only`` keeps the cases whose name
starts with PREFIX (or one of several, comma-separated).

It prints the card's name and power limit, then per tree the registers and
stack frame that ptxas reports for each instantiation (when the tree's
kernels were built in this run) and one JSON line of medians in
microseconds (null for a case whose profile lost events three times, with a
line naming it; the run then goes on to the other trees and exits nonzero at
the end).  Needs a CUDA device.
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
MESH_K3 = (4, (48, 24))      # 7,424 triangles
MESH_K4 = (6, (256, 160))    # 163,840
MESH_4K = (4, (64, 40))      # 10,240
DEEP_SLAB = (368, 32)         # rows 368-399 of 800x600: the deepest pixels
CASES = [  # name, width, height, depth, shadow samples, record, mesh, filter
    ("K1 512x384 d3 ss0", 512, 384, 3, 0, False, None, "nearest"),
    ("K1 128x96 d3 ss0", 128, 96, 3, 0, False, None, "nearest"),
    ("K1 800x600 d15 ss2", 800, 600, 15, 2, False, None, "nearest"),
    ("K1 800x600 d15 rows 368-399", 800, 600, 15, 2, False, None, "nearest"),
    ("K1 800x600 d15 ss0 rows 368-399", 800, 600, 15, 0, False, None,
     "nearest"),
    ("K1 1920x1080 d4 ss2", 1920, 1080, 4, 2, False, None, "nearest"),
    ("K1 1920x1080 d4 ss0", 1920, 1080, 4, 0, False, None, "nearest"),
    ("K5 512x384 d3 ss0", 512, 384, 3, 0, True, None, "nearest"),
    ("K5 128x96 d3 ss0", 128, 96, 3, 0, True, None, "nearest"),
    ("K5 800x600 d15 ss2", 800, 600, 15, 2, True, None, "nearest"),
    ("K5 800x600 d15 rows 368-399", 800, 600, 15, 2, True, None, "nearest"),
    ("K5 800x600 d15 ss0 rows 368-399", 800, 600, 15, 0, True, None,
     "nearest"),
    ("K5 256x192 d3 ss2", 256, 192, 3, 2, True, None, "nearest"),
    ("K5 800x600 d15 ss2 bilinear", 800, 600, 15, 2, True, None,
     "bilinear"),
    ("K3 512x384 d3 ss2 7424 tris", 512, 384, 3, 2, False, MESH_K3,
     "nearest"),
    ("K5 512x384 d3 ss2 7424 tris", 512, 384, 3, 2, True, MESH_K3, "nearest"),
    ("K4 512x384 d3 ss2 163840 tris", 512, 384, 3, 2, False, MESH_K4,
     "nearest"),
    ("K3 3840x2160 d6 ss2 10240 tris", 3840, 2160, 6, 2, False, MESH_4K,
     "nearest"),
    ("K2 800x600 d15 ss2", 800, 600, 15, 2, False, None, "bilinear"),
    ("K2 1920x1080 d4 ss2", 1920, 1080, 4, 2, False, None, "bilinear"),
]
QUERY_CASES = [  # name, query, mesh: on the 512x384 primary rays
    ("K6 closest 7424 tris", "closest", MESH_K3),
    ("K6 blocker 7424 tris", "blocker", MESH_K3),
    ("K6 closest 163840 tris", "closest", MESH_K4),
    ("K6 blocker 163840 tris", "blocker", MESH_K4),
]


def device_us(prof, calls):
    """Median over the calls of the device time of their kernels.  The
    profiler may drop an event at the end of its buffer: the calls it saw
    whole count, and at least all but two must be there."""
    times = [e.device_time for e in prof.events()
             if "megakernel" in e.name or "tri_query" in e.name]
    per_call = max(1, round(len(times) / calls))
    whole = len(times) // per_call
    if whole < calls - 2:
        raise RuntimeError(f"the profiler saw {len(times)} kernel launches "
                           f"in {calls} calls")
    return round(statistics.median(
        sum(times[i * per_call:(i + 1) * per_call]) for i in range(whole)), 2)


def timed(name, fn, attempts=3):
    """``device_us`` of ITERS calls of ``fn`` after WARMUP; profiled again
    when the profiler dropped more events than it tolerates, and ``None``
    (with a line naming case ``name``) when it did so every time."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        try:
            return device_us(prof, ITERS)
        except RuntimeError as err:
            if attempt == attempts - 1:
                print(f"{name}: not measured ({err})", flush=True)
                return None


def worker(tree: str, only: str = "") -> None:
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
    package = os.path.join(tree, "tpuray_torch")
    has_meshes = os.path.exists(os.path.join(package, "meshes.py"))
    has_query = os.path.exists(os.path.join(package, "kernels", "query.py"))
    dev = torch.device("cuda")
    assets = tt.assets_from_arrays(*tt.random_asset_arrays(0, 512, 512), dev)
    camera = tt.Camera(*CAMERA)
    scenes = {}
    prefixes = tuple(only.split(","))

    def mesh_scene(mesh):
        from tpuray_torch.meshes import mesh_benchmark_scene
        if mesh not in scenes:
            scenes[mesh] = tt.build_scene(
                mesh_benchmark_scene(mesh[0], torus_res=mesh[1]), dev)
        return scenes[mesh]

    out = {}
    for name, width, height, depth, samples, record, mesh, filt in CASES:
        if not name.startswith(prefixes) or (mesh and not has_meshes):
            continue
        row0, rows = DEEP_SLAB if "rows" in name else (0, height)
        try:
            cfg = tt.RenderConfig(width=width, height=rows,
                                  max_depth=depth, shadow_samples=samples,
                                  filter=filt)
        except (NotImplementedError, ValueError):
            continue          # a tree without bilinear filtering
        scene = (mesh_scene(mesh) if mesh
                 else tt.build_scene(tt.canonical_scene_spec(), dev))
        packed = pack_scene(scene, tt.perspective_basis(
            camera, width, height, device=dev), row0)
        render = render_megakernel_record if record else render_megakernel
        out[name] = timed(name, lambda: render(packed, assets, cfg))
        del packed
        torch.cuda.empty_cache()
    if has_query:
        from tpuray_torch.kernels import query
        from tpuray_torch.kernels.triblocks import build_query_tables
        o, d = (x.contiguous() for x in tt.generate_rays(
            tt.perspective_basis(camera, 512, 384, device=dev), 512, 384))
        for name, mode, mesh in QUERY_CASES:
            if not name.startswith(prefixes):
                continue
            scene = mesh_scene(mesh)
            tables = build_query_tables(scene.tri_v0, scene.tri_v1,
                                        scene.tri_v2,
                                        scene.tri_mat.transparent)
            t, _ = query.tri_query_closest(tables, o, d)
            scale = torch.where(torch.arange(t.shape[0], device=dev) % 4 < 2,
                                1.5, 0.5)
            tmax = torch.where(torch.isfinite(t), t * scale,
                               torch.full_like(t, 4.0))
            tmax[::11] = 0.0
            if mode == "closest":
                out[name] = timed(name, lambda: query.tri_query_closest(
                    tables, o, d))
            else:
                out[name] = timed(name, lambda: query.tri_query_blocker(
                    tables, o, d, tmax))
    print("median us", json.dumps(out), flush=True)
    lost = [name for name, us in out.items() if us is None]
    if lost:
        raise SystemExit(f"kernel_ab: not measured in {tree}: {lost}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) >= 2 and argv[0] == "--worker":
        worker(*argv[1:])
        return
    only = ""
    if argv[:1] == ["--only"] and len(argv) >= 2:
        only, argv = argv[1], argv[2:]
    if not argv:
        raise SystemExit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    failed = []
    for tree in argv:
        tree = os.path.abspath(tree)
        print("==", tree, flush=True)
        if subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--worker", tree, only], timeout=900).returncode:
            failed.append(tree)
    if failed:
        raise SystemExit(f"kernel_ab: a case or a tree failed in {failed}")


if __name__ == "__main__":
    main()
