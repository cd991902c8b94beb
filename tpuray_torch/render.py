"""Public forward-rendering API.

Port of :mod:`tpuray.render`: the reference's host pipeline (raypng.c:11-100),
camera perspective -> raygen -> raytracer -> image.  Everything runs on the
scene's device: CUDA tensors go through the CUDA megakernel, CPU tensors
through its plain PyTorch version.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera import Camera, PerspectiveBasis, perspective_basis
from .config import RenderConfig
from .kernels.megakernel import pack_scene, render_megakernel
from .scene import Scene
from .textures import SceneAssets


def render_from_basis(scene: Scene, assets: SceneAssets,
                      basis: PerspectiveBasis, cfg: RenderConfig,
                      row0: int = 0) -> torch.Tensor:
    """Render ``cfg.height`` rows starting at image row ``row0``: float32
    linear rgb [H, W, 3] on the scene's device."""
    return render_megakernel(pack_scene(scene, basis, row0), assets, cfg)


def render(scene: Scene, assets: SceneAssets, camera: Camera,
           cfg: RenderConfig) -> torch.Tensor:
    """Render to float32 linear rgb [H, W, 3]."""
    basis = perspective_basis(camera, cfg.width, cfg.height,
                              device=scene.device)
    return render_from_basis(scene, assets, basis, cfg)


def quantize_image(rgb: torch.Tensor, width: int,
                   height: int) -> torch.Tensor:
    """Clamp to [0, 1], scale by 255 and truncate, the reference's output
    packing (raytracing.cl:193-194) without the 0RGB word: u8 [H, W, 3].
    NaN becomes 0, as XLA's float -> u8 convert does."""
    q = rgb.clamp(0.0, 1.0) * 255.0
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.to(torch.uint8).reshape(height, width, 3)


def render_u8(scene: Scene, assets: SceneAssets, camera: Camera,
              cfg: RenderConfig) -> np.ndarray:
    """Render and quantize like the reference's output path; returns a host
    u8 [H, W, 3] array."""
    rgb = render(scene, assets, camera, cfg)
    return quantize_image(rgb, cfg.width, cfg.height).cpu().numpy()
