"""Smoke run of the PyTorch/CUDA port (``tpuray_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:

1. the card (name and power limit), PyTorch, CUDA and nvcc versions;
2. the CUDA kernels built with nvcc from ``tpuray_torch/kernels/csrc``
   (the megakernel in its base and record instantiations);
3. the base kernel (K1) against its plain PyTorch version on the card, at
   two test shapes and at the raypng shape (800x600, depth 15);
4. the raypng path as a user runs it: ``tpuray_torch.apps.raypng`` at
   800x600 depth 15, which must go through K1; with the reference tree
   mounted, on render.map and its assets against the golden image;
5. K1 and plain times (CUDA events, 3 warm-ups, median of 10) at the
   raypng shape and at the benchmark's 1920x1080 depth 4;
6. the record kernel (K5) against its plain version: records, texel picks,
   shadow ratios and ``max_nodes``, and its image against K1's;
7. the replay on the card: it reproduces K5's image, and the gradient
   through ``render_megakernel_diff`` matches the same on the CPU;
8. the inverse-rendering path as a user runs it:
   ``tpuray_torch.apps.invrender`` at 128x96 depth 3 for 20 steps, which
   must go through K5 and lower the loss;
9. times: K5 against K1 (the cost of recording), one training step and its
   parts with peak memory, at the training shapes.

It prints a JSON line of per-kernel results, then, last, the line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails and
prints no result.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the larger of its FLOPs over 67 TFLOP/s (fp32 outside the tensor
cores) and its bytes over 3.35 TB/s (H100 SXM data sheet).  The FLOPs are
counted from this run's DFS nodes, read from K5's records at the same
inputs (solid hits, misses and light hits, at most 64 per pixel), times the
fp32 operations of one node reckoned from ``csrc/megakernel.cu`` (a sqrt,
a division or a sine counted as one); the bytes are the image written once,
the texels the nodes fetched, the packed scene and, for K5, the records.
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
SSR_ABS = 1e-5
# the replay's bar and the gradient's (tests/test_pallas_vjp.py:82-83 and
# :297-303): the card's reductions sum in another order than the CPU's
REPLAY_MEAN = 1e-3
REPLAY_MAX = 5e-2
GRAD_ATOL = 2e-2
# the golden drive's bar (ROADMAP.md, Tier-1 verify)
GOLDEN_MEAN = 1.0
GOLDEN_WITHIN_8 = 0.99
GOLDEN_PSNR = 40.0
GOLDEN_CAMERA = ((0.8, 2.5, -8.0), (0.2, 0.0, 1.0), 90.0, 1.0)
ASSET_SEED = 0
INVRENDER_STEPS = 20
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def phase(n, name, text):
    print(f"phase {n} {name}: {text}", flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def node_flops(ns, npl, nl, samples):
    """fp32 operations of one DFS node by kind, reckoned from
    csrc/megakernel.cu: a sphere test (sphere_t plus the compare) is 37, a
    plane test 19, a light test 36; a solid hit adds its normal, texel or
    ambient term and continuation (100) and, per light, the Phong terms
    (77) and per shadow sample the point on the light (41) and the
    occluder tests."""
    per_node = 36 * nl + 37 * ns + 19 * npl
    sample = 41 + 37 * ns + 18 * npl
    return {"node": per_node, "solid": 100 + nl * (77 + samples * sample),
            "miss": 25, "light": 10}


def bound(records, packed, cfg, with_records):
    """(bound_ms, bound_by, node counts) of one megakernel launch on these
    inputs, from the records of K5 on the same inputs."""
    lay = packed.layout
    rec = records["rec"]
    code, written = rec & 0xFF, rec >= 0
    counts = {"nodes": int(written.sum()),
              "solid": int((written & (code < lay.n_spheres
                                       + lay.n_planes)).sum()),
              "miss": int((written & (code == 127)).sum()),
              "picks": int((records["pick"] >= 0).sum())}
    counts["light"] = counts["nodes"] - counts["solid"] - counts["miss"]
    f = node_flops(lay.n_spheres, lay.n_planes, lay.n_lights,
                   cfg.shadow_samples)
    flops = (counts["nodes"] * f["node"] + counts["solid"] * f["solid"]
             + counts["miss"] * f["miss"] + counts["light"] * f["light"])
    n_pix = cfg.width * cfg.height
    nbytes = n_pix * 12 + counts["picks"] * 3 + packed.buf.numel() * 4
    if with_records:
        nbytes += rec.shape[0] * n_pix * (8 + 4 * lay.n_lights) + 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    counts.update(flops=flops, bytes=nbytes,
                  max_nodes=int(records["max_nodes"]))
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", counts)


def profile_step(trainer, shape):
    """One training step under torch.profiler: its CUDA kernel launches,
    the time the device was busy with them (the union of their intervals),
    the step's wall time under the profiler and the three kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.step(True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    if not spans:
        return (f"profiled step {shape}: device time not measured (the "
                "profiler recorded no CUDA events)")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return (f"profiled step {shape}: {len(spans)} CUDA kernels, "
            f"device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"wall under the profiler ({busy / wall_us:.1%}); most device "
            "time: " + ", ".join(f"{name[:48]} {us / 1e3:.3f} ms"
                                 for name, us in top))


def write_inputs(tt, tmp, tex, sky):
    """A render.map of the canonical scene and an asset directory of the
    seeded images, as the apps read them."""
    scene_path = os.path.join(tmp, "render.map")
    tt.dump_scene(scene_path, tt.canonical_scene_spec())
    asset_dir = os.path.join(tmp, "assets")
    os.makedirs(os.path.join(asset_dir, "bg"))
    for name, img in zip(tt.textures.DEFAULT_TEXTURES, tex):
        tt.write_png(os.path.join(asset_dir, name), img)
    tt.write_png(os.path.join(asset_dir, tt.textures.DEFAULT_SKYBOX), sky)
    return ["--scene", scene_path, "--asset-dir", asset_dir]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "NVIDIA GPU")
    import tpuray_torch as tt
    from tpuray_torch.apps import invrender, raypng
    from tpuray_torch.config import REFERENCE_DIR
    from tpuray_torch.kernels import build
    from tpuray_torch.kernels.megakernel import (
        render_megakernel, render_megakernel_record,
        render_megakernel_record_reference, render_megakernel_reference)
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
             if "registers" in ln or "stack frame" in ln
             or "Compiling entry" in ln]
    phase(2, "build", f"{os.path.relpath(lib.path)} in "
                      f"{time.perf_counter() - t0:.1f} s; "
                      f"{' | '.join(ptxas)}")

    mounted = os.path.exists(os.path.join(REFERENCE_DIR, "scenes",
                                          "render.map"))
    tex, sky = tt.random_asset_arrays(ASSET_SEED, 512, 512)
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
        assets = tt.assets_from_arrays(tex, sky, dev)
    camera = tt.Camera(*GOLDEN_CAMERA)

    def inputs(width, height, depth, samples=2, **kw):
        cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                              shadow_samples=samples, **kw)
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

    with tempfile.TemporaryDirectory() as tmp:
        app_inputs = [] if mounted else write_inputs(tt, tmp, tex, sky)

        # -- 4. the raypng path through K1 --
        argv = ["--width", "800", "--height", "600", "--depth", "15",
                "--device", "cuda", "--selfcheck",
                "--out", os.path.join(tmp, "scene.png")] + app_inputs
        if mounted:
            argv.append("--compare-golden")
        render_megakernel.launches = 0
        render_megakernel_record.launches = 0
        t0 = time.perf_counter()
        res = raypng.main(argv)
        wall = time.perf_counter() - t0
        k1_launches = render_megakernel.launches
        if render_megakernel_record.launches:
            raise RuntimeError("raypng launched the record kernel")
        written = tt.read_png(os.path.join(tmp, "scene.png"))
        if k1_launches < 1:
            raise RuntimeError("raypng did not launch the CUDA megakernel")
        rgb = res["rgb"]
        if rgb.device.type != "cuda" or rgb.shape != (600, 800, 3) \
                or not bool(torch.isfinite(rgb).all()):
            raise RuntimeError("raypng's image is not a finite 600x800x3 "
                               "CUDA tensor")
        if not (written == res["image"]).all():
            raise RuntimeError("the written PNG differs from the render")
        text = (f"800x600 d15, {k1_launches} kernel launch(es), "
                f"{res['report']}; whole run (load, render, PNG) "
                f"{wall:.3f} s")
        if mounted:
            g = res["golden"]
            text += f"; golden {g}"
            if not (g.mean_abs < GOLDEN_MEAN
                    and g.frac_within_8 >= GOLDEN_WITHIN_8
                    and g.psnr >= GOLDEN_PSNR):
                raise RuntimeError(f"golden bar missed: {g}")
        phase(4, "raypng", text)

        # -- 5. K1 timing --
        timings = {}
        for width, height, depth in ((800, 600, 15), (1920, 1080, 4)):
            packed, cfg = inputs(width, height, depth)
            for name, fn in (("kernel", render_megakernel),
                             ("plain", render_megakernel_reference)):
                timings[(width, height, depth, name)] = cuda_time_ms(
                    lambda: fn(packed, assets, cfg))[0]
        phase(5, "timing", f"{card}: " + "; ".join(
            f"{w}x{h} d{d} {name} {ms:.4f} ms "
            f"({w * h / ms / 1e3:.2f} Mrays/s)"
            for (w, h, d, name), ms in timings.items()))
        packed, cfg = inputs(800, 600, 15, record_slots=64)
        _, recs = render_megakernel_record(packed, assets, cfg)
        k1_bound, k1_by, k1_counts = bound(recs, packed, cfg, False)
        del recs

        # -- 6. K5 against its plain version --
        k5_err = 0.0
        results = []
        for width, height, depth, samples in ((256, 64, 3, 2),
                                              (200, 50, 6, 2),
                                              (128, 96, 3, 0)):
            packed, cfg = inputs(width, height, depth, samples)
            before = render_megakernel_record.launches
            img, rec = render_megakernel_record(packed, assets, cfg)
            torch.cuda.synchronize()
            if render_megakernel_record.launches != before + 1:
                raise RuntimeError("the record wrapper did not count its "
                                   "launch")
            want, plain = render_megakernel_record_reference(packed, assets,
                                                             cfg)
            base = render_megakernel(packed, assets, cfg)
            torch.cuda.synchronize()
            n_pix = width * height
            krec = cfg.resolved_record_slots()
            if img.shape != (height, width, 3) \
                    or rec["rec"].shape != (krec, n_pix) \
                    or rec["ssr"].shape != (krec, scene.num_lights, n_pix) \
                    or not bool(torch.isfinite(img).all()):
                raise RuntimeError("record kernel outputs have the wrong "
                                   "shape or are not finite")
            same = {k: float((rec[k] == plain[k]).all(0).float().mean())
                    for k in ("rec", "pick")}
            ssr_err = float((rec["ssr"] - plain["ssr"]).abs().max())
            d_plain = (img - want).abs()
            d_base = (img - base).abs()
            k5_err = max(k5_err, float(d_plain.max()))
            base_agree = float((d_base.amax(-1) < AGREE_ABS).float().mean())
            nodes = (int(rec["max_nodes"]), int(plain["max_nodes"]))
            results.append(
                f"{width}x{height} d{depth} ss{samples}: records equal on "
                f"{same['rec']:.6f} and picks on {same['pick']:.6f} of "
                f"pixels, ssr max|d| {ssr_err:.3g}, max_nodes {nodes[0]} "
                f"(plain {nodes[1]}), image vs plain max|d| "
                f"{float(d_plain.max()):.3g}, vs K1 {base_agree:.6f} within "
                f"{AGREE_ABS} (mean {float(d_base.mean()):.3g})")
            if min(same.values()) < AGREE_FRAC or ssr_err > SSR_ABS \
                    or nodes[0] != nodes[1] or base_agree < AGREE_FRAC \
                    or float(d_base.mean()) >= MEAN_ABS \
                    or float(d_plain.mean()) >= MEAN_ABS:
                raise RuntimeError("record kernel disagrees: " + results[-1])
        phase(6, "record kernel vs plain", "; ".join(results))

        # -- 7. replay and gradient on the card --
        results = []
        for width, height, depth, samples in ((128, 96, 3, 0),
                                              (256, 64, 3, 2)):
            packed, cfg = inputs(width, height, depth, samples)
            basis = tt.perspective_basis(camera, width, height, device=dev)
            img, rec = render_megakernel_record(packed, assets, cfg)
            rep = tt.replay_render(scene, assets, basis, rec, cfg)
            d = (rep - img).abs()
            results.append(f"replay {width}x{height} d{depth} ss{samples}: "
                           f"mean|d| {float(d.mean()):.3g}, max|d| "
                           f"{float(d.max()):.3g}")
            if float(d.mean()) >= REPLAY_MEAN or float(d.max()) >= REPLAY_MAX:
                raise RuntimeError("replay disagrees: " + results[-1])
        grads = {}
        width, height = 64, 48
        for where in (dev, torch.device("cpu")):
            g_scene = tt.build_scene(tt.canonical_scene_spec(), where)
            g_assets = assets.to(where)
            basis = tt.perspective_basis(camera, width, height, device=where)
            cfg = tt.RenderConfig(width=width, height=height, max_depth=3,
                                  shadow_samples=2)
            diff, rest = tt.partition(g_scene)
            leaves = {k: v.clone().requires_grad_() for k, v in diff.items()}
            gen = torch.Generator().manual_seed(0)
            w = torch.rand(height, width, 3, generator=gen).to(where)
            img = tt.render_megakernel_diff(tt.combine(leaves, rest),
                                            g_assets, basis, cfg)
            g = torch.autograd.grad((img * w).sum(), list(leaves.values()))
            grads[where.type] = dict(zip(leaves, (x.cpu() for x in g)))
        worst = 0.0
        for name, ours in grads["cuda"].items():
            want = grads["cpu"][name]
            if not bool(torch.isfinite(ours).all()):
                raise RuntimeError(f"gradient of {name} is not finite")
            if want.numel():
                scale = max(float(want.abs().max()), 1e-3)
                err = float((ours - want).abs().max()) / scale
                worst = max(worst, err)
                if err > GRAD_ATOL:
                    raise RuntimeError(f"gradient of {name} on the card is "
                                       f"{err:.3g} * max|g| off the CPU's")
        results.append(f"gradient {width}x{height} d3 ss2 on the card vs "
                       f"the CPU: worst leaf max|d| {worst:.3g} * max|g| "
                       f"(bar {GRAD_ATOL}), all finite")
        phase(7, "replay and gradient", "; ".join(results))

        # -- 8. the invrender path through K5 --
        argv = ["--steps", str(INVRENDER_STEPS), "--width", "128",
                "--height", "96", "--depth", "3", "--device", "cuda",
                "--every", "10",
                "--checkpoint", os.path.join(tmp, "invrender.pt")] \
            + app_inputs
        render_megakernel.launches = 0
        render_megakernel_record.launches = 0
        res = invrender.main(argv)
        k5_launches = render_megakernel_record.launches
        if k5_launches < INVRENDER_STEPS + 1:
            raise RuntimeError(f"invrender launched the record kernel "
                               f"{k5_launches} times in "
                               f"{INVRENDER_STEPS} steps")
        if render_megakernel.launches:
            raise RuntimeError("invrender launched the base kernel")
        losses = res["losses"]
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"the loss did not fall: {losses}")
        if not all(bool(torch.isfinite(v).all())
                   for v in res["params"].values()):
            raise RuntimeError("invrender's parameters are not finite")
        phase(8, "invrender", (
            f"128x96 d3 ss0, {INVRENDER_STEPS} steps, {k5_launches} record "
            f"kernel launches; loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
            f"param error {res['err0']:.4f} -> {res['err1']:.4f}, "
            f"observable {res['obs0']:.4f} -> {res['obs1']:.4f}; "
            f"{res['train_seconds'] / res['steps'] * 1e3:.1f} ms per step "
            f"(host clock, first step included) on {card}"))

    # -- 9. timing: recording, training steps --
    texts = []
    for width, height, depth, samples in ((512, 384, 3, 0),
                                          (800, 600, 15, 2)):
        packed, cfg = inputs(width, height, depth, samples)
        base_ms = cuda_time_ms(lambda: render_megakernel(packed, assets,
                                                         cfg))[0]
        rec_ms = cuda_time_ms(lambda: render_megakernel_record(
            packed, assets, cfg))[0]
        texts.append(f"{width}x{height} d{depth} ss{samples} K1 "
                     f"{base_ms:.4f} ms, K5 {rec_ms:.4f} ms "
                     f"({rec_ms / base_ms:.2f}x, Krec "
                     f"{cfg.resolved_record_slots()})")
    # K5 at the invrender shape, its plain version and its bound
    packed, cfg = inputs(128, 96, 3, 0)
    k5_ms = cuda_time_ms(lambda: render_megakernel_record(packed, assets,
                                                          cfg))[0]
    k5_plain_ms = cuda_time_ms(lambda: render_megakernel_record_reference(
        packed, assets, cfg))[0]
    _, recs = render_megakernel_record(packed, assets, cfg)
    k5_bound, k5_by, k5_counts = bound(recs, packed, cfg, True)
    texts.append(f"128x96 d3 ss0 K5 {k5_ms:.4f} ms, plain "
                 f"{k5_plain_ms:.4f} ms, bound {k5_bound:.5f} ms "
                 f"({k5_by}; {k5_counts})")
    texts.append(f"800x600 d15 ss2 K1 bound {k1_bound:.5f} ms ({k1_by}; "
                 f"{k1_counts})")

    truth = tt.partition(scene)

    def trainer_for(width, height, depth, samples, slots=0):
        cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                              shadow_samples=samples, record_slots=slots)
        basis = tt.perspective_basis(camera, width, height, device=dev)

        def render(s):
            return tt.render_megakernel_diff(s, assets, basis,
                                             cfg).clamp(0, 1)

        with torch.no_grad():
            target = render(scene)
        mask = invrender.optimize_mask(truth[0])
        trainer = invrender.Trainer(
            invrender.perturb(truth[0], mask, 0, light_shift=0.3),
            truth[1], mask, render, target, steps=300)
        return trainer, cfg, basis

    for width, height, depth, samples, slots, reps in (
            (128, 96, 3, 0, 0, 10), (256, 192, 3, 2, 0, 10),
            (512, 384, 3, 0, 0, 10), (800, 600, 15, 2, 64, 2)):
        shape = f"{width}x{height} d{depth} ss{samples}"
        warmup = 3 if reps >= 10 else 1
        try:
            trainer, cfg, basis = trainer_for(width, height, depth, samples,
                                              slots)
            packed = tt.pack_scene(scene, basis)
            _, recs = render_megakernel_record(packed, assets, cfg)
            gimg = torch.rand(height, width, 3, device=dev)
            # the replay as the step runs it: gradients of the trained
            # leaves only
            params = {k: v.detach().requires_grad_(trainer.mask[k])
                      for k, v in trainer.params.items()}
            trained = [params[k] for k in trainer.trained]

            def replay_backward():
                img = tt.replay_render(tt.combine(params, truth[1]), assets,
                                       basis, recs, cfg)
                return torch.autograd.grad(img, trained, gimg)

            torch.cuda.reset_peak_memory_stats()
            step_ms = cuda_time_ms(lambda: trainer.step(True), warmup=warmup,
                                   iters=reps)[0]
            step_peak = torch.cuda.max_memory_allocated() / 2 ** 20
            grads_ms = cuda_time_ms(trainer.loss_and_grads, warmup=warmup,
                                    iters=reps)[0]
            fwd_ms = cuda_time_ms(lambda: render_megakernel_record(
                packed, assets, cfg), iters=reps)[0]
            torch.cuda.reset_peak_memory_stats()
            replay_ms = cuda_time_ms(replay_backward, warmup=warmup,
                                     iters=reps)[0]
            replay_peak = torch.cuda.max_memory_allocated() / 2 ** 20
            texts.append(
                f"step {shape}: {step_ms:.3f} ms (peak {step_peak:.0f} MiB);"
                f" loss and gradients {grads_ms:.3f} ms, of which K5 "
                f"{fwd_ms:.4f} ms and the replay forward+backward "
                f"{replay_ms:.3f} ms (peak {replay_peak:.0f} MiB); "
                f"optimizer and the rest {step_ms - grads_ms:.3f} ms; "
                f"max_nodes {int(recs['max_nodes'])}, Krec "
                f"{cfg.resolved_record_slots()}")
            del trainer, recs, params, trained
        except torch.cuda.OutOfMemoryError:
            texts.append(f"step {shape}: does not fit (peak "
                         f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f}"
                         " MiB)")
        torch.cuda.empty_cache()
    for width, height in ((128, 96), (512, 384)):
        texts.append(profile_step(trainer_for(width, height, 3, 0)[0],
                                  f"{width}x{height} d3 ss0"))
    phase(9, "timing", f"{card}: " + "; ".join(texts))

    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "tpuray_torch/kernels/csrc/megakernel.cu",
        "replaces": "tpuray/kernels/pallas_trace.py:659",
        "launches": k1_launches,
        "max_abs_err": max_err,
        "ms": timings[(800, 600, 15, "kernel")],
        "plain_ms": timings[(800, 600, 15, "plain")],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "shape": "800x600 d15 ss2",
    }, {
        "name": "megakernel_record",
        "route": "cuda",
        "source": "tpuray_torch/kernels/csrc/megakernel.cu",
        "replaces": "tpuray/kernels/pallas_trace.py:2665",
        "launches": k5_launches,
        "max_abs_err": k5_err,
        "ms": k5_ms,
        "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound,
        "bound_by": k5_by,
        "library_ms": None,
        "shape": "128x96 d3 ss0",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
