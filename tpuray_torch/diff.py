"""Differentiable rendering: scene leaves and the megakernel's gradient.

Port of :mod:`tpuray.diff`.  A ``Scene`` mixes float leaves (geometry,
materials, lights: all differentiable) with integer and bool leaves
(texture ids, material flags: structural).  :func:`partition` and
:func:`combine` split and rejoin the two, as dicts keyed by leaf name
(``sphere_mat.rgb`` etc., :func:`scene.scene_leaves`).

:func:`render_megakernel_diff` is the counterpart of ``render_pallas_diff``
(``tpuray/diff.py:73-120``): the forward is the record-mode megakernel (K5,
the CUDA kernel on the card), the backward is autograd through the replay
(``kernels/replay.py``), wrapped in a ``torch.autograd.Function``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .camera import PerspectiveBasis
from .config import RenderConfig
from .kernels.megakernel import pack_scene, render_megakernel_record
from .kernels.replay import replay_render
from .scene import Scene, scene_from_leaves, scene_leaves
from .textures import SceneAssets

Leaves = Dict[str, torch.Tensor]
_BASIS_FIELDS = ("corner", "origin", "up", "right", "w_factor", "h_factor")


def partition(scene: Scene) -> Tuple[Leaves, Leaves]:
    """(float leaves, other leaves) of ``scene``, by leaf name."""
    leaves = scene_leaves(scene)
    diff = {k: v for k, v in leaves.items() if v.is_floating_point()}
    rest = {k: v for k, v in leaves.items() if not v.is_floating_point()}
    return diff, rest


def combine(diff: Leaves, rest: Leaves) -> Scene:
    """Inverse of :func:`partition`."""
    return scene_from_leaves({**diff, **rest})


def value_and_scene_grad(fn: Callable[..., torch.Tensor], scene: Scene,
                         *args, **kw):
    """(value, grads) of the scalar ``fn(scene, *args, **kw)`` with respect
    to every float leaf of ``scene``; ``grads`` is a dict by leaf name, with
    zeros for leaves the value does not depend on."""
    diff, rest = partition(scene)
    leaves = {k: v.detach().requires_grad_() for k, v in diff.items()}
    value = fn(combine(leaves, rest), *args, **kw)
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True)
    return value.detach(), {k: torch.zeros_like(v) if g is None else g
                            for (k, v), g in zip(leaves.items(), grads)}


def l2_image_loss(rendered: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    return torch.sum((rendered - target) ** 2)


class _RecordReplay(torch.autograd.Function):
    """Forward: the record-mode megakernel.  Backward: the replay's VJP."""

    @staticmethod
    def forward(ctx, side, *tensors):
        names, rest, assets, cfg, row0 = side
        n = len(names)
        leaves = dict(zip(names, tensors[:n]))
        basis = PerspectiveBasis(*tensors[n:])
        img, records = render_megakernel_record(
            pack_scene(combine(leaves, rest), basis, row0), assets, cfg)
        ctx.side = side
        ctx.records = records
        ctx.save_for_backward(*tensors)
        return img

    @staticmethod
    def backward(ctx, grad_img):
        names, rest, assets, cfg, row0 = ctx.side
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(want)
                      for t, want in zip(ctx.saved_tensors, need)]
            n = len(names)
            scene = combine(dict(zip(names, inputs[:n])), rest)
            img = replay_render(scene, assets,
                                PerspectiveBasis(*inputs[n:]), ctx.records,
                                cfg, row0)
            wanted = [t for t in inputs if t.requires_grad]
            grads = (torch.autograd.grad(img, wanted, grad_img,
                                         allow_unused=True)
                     if img.requires_grad else [None] * len(wanted))
        grads = iter(grads)
        out = []
        for t in inputs:
            g = next(grads) if t.requires_grad else None
            if g is None and t.requires_grad:
                g = torch.zeros_like(t)   # a leaf the replay does not read
            out.append(g)
        return (None, *out)


def render_megakernel_diff(scene: Scene, assets: SceneAssets,
                           basis: PerspectiveBasis, cfg: RenderConfig,
                           row0: int = 0) -> torch.Tensor:
    """Differentiable megakernel render: [H, W, 3] f32 linear rgb.

    The forward is the record-mode megakernel (the same image as
    :func:`kernels.megakernel.render_megakernel`, plus the node records);
    the backward is autograd through :func:`kernels.replay.replay_render`
    on those records.  Gradients reach every float leaf of ``scene`` and
    the basis tensors that require them; the u8 assets, the integer leaves
    and ``cfg`` carry none.  ``row0`` is the first image row rendered."""
    diff, rest = partition(scene)
    names = tuple(diff)
    tensors = [*diff.values(), *(getattr(basis, f) for f in _BASIS_FIELDS)]
    return _RecordReplay.apply((names, rest, assets, cfg, row0), *tensors)
