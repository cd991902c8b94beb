"""Inverse rendering: recover a scene's material parameters and light
positions from a target image by gradient descent.

Port of :mod:`tpuray.apps.invrender`, with its flags and printed lines.
The target is a render of the true scene (``render.map`` by default); the
optimization starts from perturbed material parameters (rgb, ambient,
diffuse, specular and reflectivity of every sphere and plane) and
perturbed light positions, and recovers them with Adam on the L2 loss
between display-space images.  With ``--engine megakernel`` each step
renders through :func:`diff.render_megakernel_diff`: the record-mode CUDA
megakernel forward and the replay's backward.  With ``--engine tracer``
(the JAX app's ``xla`` engine) each step renders through the whole-image
tracer, ``loop='scan'``, and autograd differentiates it
(invrender.py:233-236); on the card its triangle queries go through the
triangle-query kernel.  ``auto`` takes the megakernel, and the tracer with
a ``RuntimeWarning`` where the megakernel does not take the scene or the
depth (``render.resolve_engine``).

    python -m tpuray_torch.apps.invrender [--steps 300] [--width 128 --height 96]
        [--depth 3] [--shadow-samples 0] [--scene render.map]
        [--asset-dir assets] [--device cuda] [--engine auto|megakernel|tracer]
        [--checkpoint out/invrender.pt] [--resume]

The optimizer follows the JAX app's optax chain (invrender.py:245-284):

=====================================  ======================================
``optax.zero_nans()``                  NaN gradients set to 0
``optax.clip_by_global_norm(5.0)``     ``g * 5 / |g|`` where ``|g| >= 5``
``optax.adam(cosine_decay_schedule)``  ``torch.optim.Adam`` (same b1, b2,
                                       eps) with a ``LambdaLR`` of the same
                                       cosine formula
light updates ``* light_lr_scale``     a parameter group with the scaled
                                       learning rate (Adam is linear in it)
=====================================  ======================================
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Dict, Optional

import torch

from ..camera import Camera, perspective_basis
from ..config import (ENGINES, GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                      GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                      REFERENCE_DIR, RenderConfig)
from ..diff import combine, l2_image_loss, partition, render_megakernel_diff
from ..kernels.megakernel import pack_scene, render_megakernel_record
from ..render import render_from_basis_tracer, resolve_engine
from ..sceneio import load_scene
from ..textures import REFERENCE_ASSETS, load_default_assets
from ..utils.checkpoint import load_checkpoint, save_checkpoint

Leaves = Dict[str, torch.Tensor]

LIGHT = "light_origin"
# "material params + light position" (BASELINE.json config 4): every
# shading-weight field of every sphere and plane material, plus the light
# origins.  Geometry, IoR, shininess and texture ids and scales stay frozen.
OPT_MAT_FIELDS = ("rgb", "ambient", "diffuse", "specular", "reflectivity")
MAX_GRAD_NORM = 5.0
ADAM_BETAS = (0.9, 0.999)     # optax.adam's defaults
ADAM_EPS = 1e-8


def optimize_mask(params: Leaves) -> Dict[str, bool]:
    """Which float leaves the optimization may move, by name."""
    def pick(name):
        prefix, _, field = name.rpartition(".")
        return name == LIGHT or (prefix in ("sphere_mat", "plane_mat")
                                 and field in OPT_MAT_FIELDS)
    return {name: pick(name) for name in params}


def perturb(params: Leaves, mask: Dict[str, bool], seed: int = 0,
            mat_scale: float = 0.5, light_shift: float = 0.5) -> Leaves:
    """The recovery's start: multiplicative noise on the optimized
    material leaves (then ``+ 0.05``, clamped at 0), additive noise on the
    light origins.  The noise comes from a ``torch.Generator`` seeded by
    ``seed``, on the CPU, so the start is the same on every device; it is
    not the JAX app's start, which draws with ``jax.random``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, leaf in params.items():
        if not mask[name]:
            out[name] = leaf
            continue
        u = torch.rand(leaf.shape, generator=gen).to(leaf.device)
        if name == LIGHT:
            out[name] = leaf + (2.0 * u - 1.0) * light_shift
        else:
            fac = (1.0 - mat_scale) + 2.0 * mat_scale * u
            out[name] = (leaf * fac + 0.05).clamp(min=0.0)
    return out


def param_error(params: Leaves, truth: Leaves, mask: Dict[str, bool],
                group: Optional[str] = None) -> float:
    """Mean |recovered - truth| over the optimized leaves; ``group``
    'light' keeps the light origins only, 'mat' the material leaves only."""
    errs, n = 0.0, 0
    for name, p in params.items():
        if not mask[name] or (group == "light" and name != LIGHT) \
                or (group == "mat" and name == LIGHT):
            continue
        errs += float((p.detach() - truth[name]).abs().sum())
        n += p.numel()
    return errs / max(n, 1)


def observable_error(params: Leaves, truth: Leaves) -> float:
    """Mean |recovered - truth| over the observable parameters.

    Material rgb enters the image only through the ambient term
    ``f * rgb * ambient`` (raytracing.cl:83-84), so (rgb * ambient,
    diffuse, specular, reflectivity, light origin) is what an image can
    identify; raw (rgb, ambient) has a per-material gauge freedom."""
    errs, n = 0.0, 0
    for solid in ("sphere_mat", "plane_mat"):
        def get(tree, field):
            return tree[f"{solid}.{field}"].detach()
        pairs = [(get(params, "rgb") * get(params, "ambient")[:, None],
                  get(truth, "rgb") * get(truth, "ambient")[:, None])]
        pairs += [(get(params, f), get(truth, f))
                  for f in ("diffuse", "specular", "reflectivity")]
        for a, b in pairs:
            errs += float((a - b).abs().sum())
            n += a.numel()
    errs += float((params[LIGHT].detach() - truth[LIGHT]).abs().sum())
    n += params[LIGHT].numel()
    return errs / max(n, 1)


def cosine_decay(step: int, steps: int, alpha: float) -> float:
    """optax.cosine_decay_schedule's factor: ``alpha + (1 - alpha) * 0.5 *
    (1 + cos(pi * t / T))``, held at ``alpha`` past T."""
    t = min(step, steps)
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / steps)) + alpha


class Trainer:
    """The optimization state and its update rule.

    ``params`` are all float leaves of the scene; the masked ones are
    trained, the rest stay as given.  ``render`` maps a ``Scene`` to the
    image the loss compares with ``target``."""

    def __init__(self, params: Leaves, static: Leaves,
                 mask: Dict[str, bool], render: Callable, target, *,
                 steps: int, lr: float = 1e-2, lr_alpha: float = 0.05,
                 light_lr_scale: float = 0.25):
        self.params = {k: v.detach().clone().requires_grad_(mask[k])
                       for k, v in params.items()}
        self.static, self.mask = static, mask
        self.render, self.target = render, target
        # material weights are projected back to >= 0 after each update;
        # light origins are unconstrained
        self.projected = [k for k in params if mask[k] and k != LIGHT]
        self.trained = [k for k in params if mask[k]]
        self.opt = torch.optim.Adam(
            [{"params": [self.params[k] for k in self.projected], "lr": lr},
             {"params": [self.params[LIGHT]], "lr": lr * light_lr_scale}],
            betas=ADAM_BETAS, eps=ADAM_EPS)
        total = max(steps, 1)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda t: cosine_decay(t, total, lr_alpha))

    def loss_and_grads(self):
        """(loss, gradients of the trained leaves by name)."""
        img = self.render(combine(self.params, self.static))
        loss = l2_image_loss(img, self.target)
        grads = torch.autograd.grad(
            loss, [self.params[k] for k in self.trained])
        return loss.detach(), dict(zip(self.trained, grads))

    @torch.no_grad()
    def apply(self, grads: Leaves, lights_on: bool) -> None:
        """One update from ``grads``: lights frozen unless ``lights_on``,
        NaN set to 0, global norm clipped to 5, Adam at the scheduled rate,
        material leaves projected to >= 0."""
        g = {k: (grads[k] if lights_on or k != LIGHT
                 else torch.zeros_like(grads[k])).nan_to_num(
                     nan=0.0, posinf=math.inf, neginf=-math.inf)
             for k in self.trained}
        norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
        g = {k: torch.where(norm < MAX_GRAD_NORM, v,
                            (v / norm) * MAX_GRAD_NORM)
             for k, v in g.items()}
        for k in self.trained:
            self.params[k].grad = g[k]
        self.opt.step()
        self.sched.step()
        for k in self.trained:
            self.params[k].grad = None
        for k in self.projected:
            self.params[k].clamp_(min=0.0)

    def step(self, lights_on: bool) -> torch.Tensor:
        loss, grads = self.loss_and_grads()
        self.apply(grads, lights_on)
        return loss

    def save(self, path: str, step: int) -> None:
        save_checkpoint(path, self.params,
                        {"adam": self.opt.state_dict(),
                         "schedule": self.sched.state_dict()}, step)

    def restore(self, path: str) -> int:
        """Load a checkpoint of a run like this one; returns its step."""
        like = {k: v.detach() for k, v in self.params.items()}
        params, state, step = load_checkpoint(path, like,
                                              map_location=self.target.device)
        with torch.no_grad():
            for k, v in params.items():
                self.params[k].copy_(v)
        self.opt.load_state_dict(state["adam"])
        self.sched.load_state_dict(state["schedule"])
        return step


def main(argv=None) -> dict:
    """Run the CLI; returns {"err0", "err1", "obs0", "obs1", "losses",
    "steps", "train_seconds", "params"}: the parameter and observable
    errors before and after, the loss of each step run, the steps run, the
    host time of the training loop (ending in a synchronise) and the
    recovered float leaves."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--shadow-samples", type=int, default=0,
                    help="soft-shadow samples in the optimization loss. "
                         "Default 0 (shadows off in target and render): "
                         "shadow boundaries are discontinuities whose "
                         "motion has no gradient, so with shadows on, "
                         "light-position steps jump the loss")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--lr-alpha", type=float, default=0.05,
                    help="cosine-decay floor as a fraction of --lr")
    ap.add_argument("--light-lr-scale", type=float, default=0.25,
                    help="light-origin step size relative to --lr")
    ap.add_argument("--mat-scale", type=float, default=0.5,
                    help="multiplicative material perturbation")
    ap.add_argument("--light-shift", type=float, default=0.3,
                    help="additive light-origin perturbation (world units)")
    ap.add_argument("--phase1-frac", type=float, default=0.4,
                    help="fraction of steps fitting materials only before "
                         "the lights unfreeze")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="out/invrender.pt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--scene",
                    default=os.path.join(REFERENCE_DIR, "scenes", "render.map"))
    ap.add_argument("--asset-dir", default=REFERENCE_ASSETS,
                    help="directory holding the four textures and bg/")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' runs the CUDA kernels")
    ap.add_argument("--engine", default="auto", choices=ENGINES,
                    help="'megakernel': the record-mode megakernel and the "
                         "replay; 'tracer': autograd through the "
                         "whole-image tracer; 'auto': the megakernel, or "
                         "the tracer (with a warning) above its triangle "
                         "or depth cap")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu for the plain "
                           "PyTorch version)")
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, chunk_size=0, loop="scan",
                       shadow_samples=args.shadow_samples,
                       engine=args.engine)
    assets = load_default_assets(args.asset_dir, device=device)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                 GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)
    basis = perspective_basis(cam, cfg.width, cfg.height, device=device)
    truth = load_scene(args.scene).to_scene(device)
    # 'auto': the megakernel, or the tracer where the megakernel does not
    # take the scene or the depth (render.resolve_engine warns)
    cfg = cfg.replace(engine=resolve_engine(truth, cfg))
    tracer = cfg.engine == "tracer"
    truth_params, static = partition(truth)
    mask = optimize_mask(truth_params)

    if not tracer:
        # preflight: size the node records to the scene's deepest DFS, so
        # the replay loses no subtree's gradient
        _, rec0 = render_megakernel_record(pack_scene(truth, basis), assets,
                                           cfg)
        need = int(rec0["max_nodes"])
        if need > cfg.resolved_record_slots():
            if need > 64:
                print(f"warning: scene needs {need} record slots > the "
                      "64-slot cap; deep-path gradients will be dropped")
            cfg = cfg.replace(record_slots=min(need, 64))
            print(f"record preflight: record_slots -> "
                  f"{cfg.resolved_record_slots()}")

    # the loss compares display-space images (clamped to [0, 1], as the
    # reference's output path, raytracing.cl:193): unclamped L2 is
    # dominated by directly seen lights, whose position is a step function
    def render(scene):
        if tracer:
            img = render_from_basis_tracer(scene, assets, basis, cfg)
        else:
            img = render_megakernel_diff(scene, assets, basis, cfg)
        return img.clamp(0, 1)

    with torch.no_grad():
        target = render(truth)

    params = perturb(truth_params, mask, args.seed, mat_scale=args.mat_scale,
                     light_shift=args.light_shift)
    err0 = param_error(params, truth_params, mask)
    obs0 = observable_error(params, truth_params)
    trainer = Trainer(params, static, mask, render, target, steps=args.steps,
                      lr=args.lr, lr_alpha=args.lr_alpha,
                      light_lr_scale=args.light_lr_scale)
    step0 = 0
    if args.resume and os.path.exists(args.checkpoint):
        step0 = trainer.restore(args.checkpoint)
        print(f"resumed from {args.checkpoint} @ step {step0}")

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    print(f"device={name}  engine={cfg.engine}  {cfg.width}x{cfg.height} "
          f"depth={cfg.max_depth}  start param err={err0:.4f}")
    phase1_end = int(args.steps * args.phase1_frac)
    losses = []
    t0 = time.perf_counter()
    for step in range(step0, args.steps):
        losses.append(trainer.step(step >= phase1_end))
        if step % args.every == 0 or step == args.steps - 1:
            p = trainer.params
            print(f"step {step:4d}  loss {float(losses[-1]):.5f}  "
                  f"param err {param_error(p, truth_params, mask):.4f} "
                  f"(light {param_error(p, truth_params, mask, 'light'):.4f}"
                  f" mat {param_error(p, truth_params, mask, 'mat'):.4f})"
                  f"  ({time.perf_counter() - t0:.1f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_seconds = time.perf_counter() - t0

    os.makedirs(os.path.dirname(args.checkpoint) or ".", exist_ok=True)
    trainer.save(args.checkpoint, args.steps)

    rec = trainer.params
    err1 = param_error(rec, truth_params, mask)
    obs1 = observable_error(rec, truth_params)
    print(f"\nparam error: {err0:.4f} -> {err1:.4f} "
          f"({err1 / max(err0, 1e-9):.1%} of start)")
    print(f"observable param error: {obs0:.4f} -> {obs1:.4f} "
          f"({obs1 / max(obs0, 1e-9):.1%} of start; rgb*ambient product "
          f"instead of the gauge-free raw pair — see observable_error)")
    print("recovered vs truth:")
    print("  light origins\n", rec[LIGHT].detach().cpu().numpy(), "\nvs\n",
          truth_params[LIGHT].cpu().numpy())
    print("  sphere ambient",
          rec["sphere_mat.ambient"].detach().cpu().numpy(), "vs",
          truth_params["sphere_mat.ambient"].cpu().numpy())
    return {"err0": err0, "err1": err1, "obs0": obs0, "obs1": obs1,
            "losses": [float(v) for v in losses],
            "steps": args.steps - step0, "train_seconds": train_seconds,
            "params": {k: v.detach() for k, v in rec.items()}}


if __name__ == "__main__":
    main()
