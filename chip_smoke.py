"""Smoke run of the PyTorch/CUDA port (``tpuray_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:

1. the card (name and power limit), PyTorch, CUDA and nvcc versions;
2. the CUDA megakernel built with nvcc from ``tpuray_torch/kernels/csrc``;
3. the kernel against its plain PyTorch version on the card, at two test
   shapes and at the raypng shape (800x600, depth 15);
4. the slice as a user runs it: ``tpuray_torch.apps.raypng`` at 800x600
   depth 15, which must go through the kernel; with the reference tree
   mounted, on render.map and its assets against the golden image;
5. kernel and plain times (CUDA events, 3 warm-ups, median of 10) at the
   raypng shape and at the benchmark's 1920x1080 depth 4.

It prints a JSON line of per-kernel results, then, last, the line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails and
prints no result.
"""
import json
import os
import subprocess
import tempfile
import time

import torch

AGREE_ABS = 1e-3
AGREE_FRAC = 0.999
MEAN_ABS = 1e-4
# the golden drive's bar (ROADMAP.md, Tier-1 verify)
GOLDEN_MEAN = 1.0
GOLDEN_WITHIN_8 = 0.99
GOLDEN_PSNR = 40.0
GOLDEN_CAMERA = ((0.8, 2.5, -8.0), (0.2, 0.0, 1.0), 90.0, 1.0)
ASSET_SEED = 0


def phase(n, name, text):
    print(f"phase {n} {name}: {text}", flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "NVIDIA GPU")
    import tpuray_torch as tt
    from tpuray_torch.apps import raypng
    from tpuray_torch.config import REFERENCE_DIR
    from tpuray_torch.kernels import build
    from tpuray_torch.kernels.megakernel import (render_megakernel,
                                                 render_megakernel_reference)
    from tpuray_torch.utils.metrics import cuda_time_ms

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. the card and the toolchain --
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    nvcc_version = run([nvcc, "--version"]).splitlines()[-1]
    phase(1, "card", f"{card}; torch {torch.__version__} CUDA "
                     f"{torch.version.cuda}; {nvcc_version}")

    # -- 2. build --
    t0 = time.perf_counter()
    lib = build.load_library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "stack frame" in ln]
    phase(2, "build", f"{os.path.relpath(lib.path)} in "
                      f"{time.perf_counter() - t0:.1f} s; "
                      f"{' | '.join(ptxas)}")

    mounted = os.path.exists(os.path.join(REFERENCE_DIR, "scenes",
                                          "render.map"))
    if mounted:
        print(f"inputs: render.map and assets from {REFERENCE_DIR}",
              flush=True)
        scene = tt.load_scene(os.path.join(REFERENCE_DIR, "scenes",
                                           "render.map")).to_scene(dev)
        assets = tt.load_default_assets(device=dev)
    else:
        print(f"inputs: canonical_scene_spec() and seeded random assets "
              f"(seed {ASSET_SEED}); no reference tree at {REFERENCE_DIR}",
              flush=True)
        scene = tt.build_scene(tt.canonical_scene_spec(), dev)
        tex, sky = tt.random_asset_arrays(ASSET_SEED, 512, 512)
        assets = tt.assets_from_arrays(tex, sky, dev)
    camera = tt.Camera(*GOLDEN_CAMERA)

    def inputs(width, height, depth):
        cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                              shadow_samples=2)
        basis = tt.perspective_basis(camera, width, height, device=dev)
        return tt.pack_scene(scene, basis), cfg

    # -- 3. kernel against its plain version --
    max_err = 0.0
    results = []
    for width, height, depth in ((256, 64, 3), (200, 50, 6),
                                 (800, 600, 15)):
        packed, cfg = inputs(width, height, depth)
        before = render_megakernel.launches
        got = render_megakernel(packed, assets, cfg)
        torch.cuda.synchronize()
        if render_megakernel.launches != before + 1:
            raise RuntimeError("the wrapper did not count its launch")
        want = render_megakernel_reference(packed, assets, cfg)
        torch.cuda.synchronize()
        if got.shape != (height, width, 3) or torch.isnan(got).any():
            raise RuntimeError(f"kernel output {tuple(got.shape)} has NaN "
                               "or the wrong shape")
        diff = (got - want).abs()
        agree = float((diff.amax(-1) < AGREE_ABS).float().mean())
        mean = float(diff.mean())
        max_err = max(max_err, float(diff.max()))
        results.append(f"{width}x{height} d{depth}: {agree:.6f} of pixels "
                       f"within {AGREE_ABS}, mean|d| {mean:.3g}, "
                       f"max|d| {float(diff.max()):.3g}")
        if agree < AGREE_FRAC or mean >= MEAN_ABS:
            raise RuntimeError("kernel disagrees with the plain version: "
                               + results[-1])
    phase(3, "kernel vs plain", "; ".join(results))

    # -- 4. the slice: raypng through the kernel --
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--width", "800", "--height", "600", "--depth", "15",
                "--device", "cuda", "--selfcheck",
                "--out", os.path.join(tmp, "scene.png")]
        if mounted:
            argv.append("--compare-golden")
        else:
            scene_path = os.path.join(tmp, "render.map")
            tt.dump_scene(scene_path, tt.canonical_scene_spec())
            asset_dir = os.path.join(tmp, "assets")
            os.makedirs(os.path.join(asset_dir, "bg"))
            for name, img in zip(tt.textures.DEFAULT_TEXTURES, tex):
                tt.write_png(os.path.join(asset_dir, name), img)
            tt.write_png(os.path.join(asset_dir, tt.textures.DEFAULT_SKYBOX),
                         sky)
            argv += ["--scene", scene_path, "--asset-dir", asset_dir]
        render_megakernel.launches = 0
        t0 = time.perf_counter()
        res = raypng.main(argv)
        wall = time.perf_counter() - t0
        launches = render_megakernel.launches
        written = tt.read_png(os.path.join(tmp, "scene.png"))
    if launches < 1:
        raise RuntimeError("raypng did not launch the CUDA megakernel")
    rgb = res["rgb"]
    if rgb.device.type != "cuda" or rgb.shape != (600, 800, 3) \
            or not bool(torch.isfinite(rgb).all()):
        raise RuntimeError("raypng's image is not a finite 600x800x3 CUDA "
                           "tensor")
    if not (written == res["image"]).all():
        raise RuntimeError("the written PNG differs from the render")
    text = (f"800x600 d15, {launches} kernel launch(es), {res['report']}; "
            f"whole run (load, render, PNG) {wall:.3f} s")
    if mounted:
        g = res["golden"]
        text += f"; golden {g}"
        if not (g.mean_abs < GOLDEN_MEAN and g.frac_within_8 >= GOLDEN_WITHIN_8
                and g.psnr >= GOLDEN_PSNR):
            raise RuntimeError(f"golden bar missed: {g}")
    phase(4, "raypng", text)

    # -- 5. timing --
    timings = {}
    for width, height, depth in ((800, 600, 15), (1920, 1080, 4)):
        packed, cfg = inputs(width, height, depth)
        for name, fn in (("kernel", render_megakernel),
                         ("plain", render_megakernel_reference)):
            timings[(width, height, depth, name)] = cuda_time_ms(
                lambda: fn(packed, assets, cfg))[0]
    phase(5, "timing", f"{card}: " + "; ".join(
        f"{w}x{h} d{d} {name} {ms:.4f} ms ({w * h / ms / 1e3:.2f} Mrays/s)"
        for (w, h, d, name), ms in timings.items()))

    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "tpuray_torch/kernels/csrc/megakernel.cu",
        "replaces": "tpuray/kernels/pallas_trace.py:659",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timings[(800, 600, 15, "kernel")],
        "plain_ms": timings[(800, 600, 15, "plain")],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
