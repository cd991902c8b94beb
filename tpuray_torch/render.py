"""Public forward-rendering API.

Port of :mod:`tpuray.render`: the reference's host pipeline (raypng.c:11-100),
camera perspective -> raygen -> raytracer -> image.  Everything runs on the
scene's device.  Two engines (``cfg.engine``): the megakernel (CUDA tensors
launch the CUDA kernel, CPU tensors run its plain PyTorch version) and the
whole-image tracer (``kernels/trace.py``), which renders in chunks of
``cfg.chunk_size`` pixels and is differentiable by autograd.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .camera import Camera, PerspectiveBasis, generate_rays, perspective_basis
from .config import RenderConfig
from .kernels.megakernel import (MAX_DEPTH_CAP, pack_scene,
                                 render_megakernel)
from .kernels.trace import trace_rays
from .kernels.triblocks import TRI_MAX_TRIANGLES
from .scene import Scene
from .textures import SceneAssets


def megakernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Whether the megakernel takes the scene and config: it covers every
    feature (both filters, triangles, records) up to ``TRI_MAX_TRIANGLES``
    triangles (``pallas_supported``, pallas_trace.py:2749) and depths up to
    its ray stack's ``MAX_DEPTH_CAP`` levels (the JAX kernel sizes its stack
    by the depth, pallas_trace.py:2421-2426)."""
    return (scene.num_triangles <= TRI_MAX_TRIANGLES
            and cfg.max_depth <= MAX_DEPTH_CAP)


def resolve_engine(scene: Scene, cfg: RenderConfig) -> str:
    """The engine that renders ``scene`` under ``cfg``: ``'megakernel'`` or
    ``'tracer'``.  ``'auto'`` takes the megakernel where it is supported
    and the tracer, with a ``RuntimeWarning``, where it is not."""
    if cfg.engine != "auto":
        return cfg.engine
    if megakernel_supported(scene, cfg):
        return "megakernel"
    if scene.num_triangles > TRI_MAX_TRIANGLES:
        why = (f"the scene's {scene.num_triangles:,} triangles exceed the "
               f"megakernel's cap ({TRI_MAX_TRIANGLES:,})")
    else:
        why = (f"max_depth={cfg.max_depth} exceeds the megakernel's ray "
               f"stack (MAX_DEPTH_CAP = {MAX_DEPTH_CAP} levels)")
    # never downgrade silently: the tracer is far slower
    warnings.warn(f"engine='auto' fell back to the whole-image tracer: "
                  f"{why}; expect a much slower render", RuntimeWarning,
                  stacklevel=3)
    return "tracer"


def render_from_basis_tracer(scene: Scene, assets: SceneAssets,
                             basis: PerspectiveBasis, cfg: RenderConfig,
                             row0: int = 0) -> torch.Tensor:
    """The whole-image tracer's render of ``cfg.height`` rows from image row
    ``row0``: primary rays -> :func:`kernels.trace.trace_rays`, in chunks of
    ``cfg.chunk_size`` pixels (0: one chunk).  float32 linear rgb [H, W, 3]
    on the scene's device, differentiable in the scene and basis tensors."""
    width, height = cfg.width, cfg.height
    n_pix = width * height
    origins, dirs = generate_rays(basis, width, height, row0)
    pixel_ids = torch.arange(n_pix, device=origins.device) + row0 * width
    chunk = min(cfg.chunk_size or n_pix, n_pix) or 1
    rgb = [trace_rays(scene, assets, origins[a:a + chunk], dirs[a:a + chunk],
                      pixel_ids[a:a + chunk], cfg)
           for a in range(0, n_pix, chunk)]
    return torch.cat(rgb).reshape(height, width, 3)


def render_from_basis(scene: Scene, assets: SceneAssets,
                      basis: PerspectiveBasis, cfg: RenderConfig,
                      row0: int = 0) -> torch.Tensor:
    """Render ``cfg.height`` rows starting at image row ``row0`` with the
    engine ``cfg.engine`` picks: float32 linear rgb [H, W, 3] on the scene's
    device.  ``'auto'`` takes the megakernel, and the tracer (with a
    ``RuntimeWarning``) above the megakernel's triangle or depth cap."""
    if resolve_engine(scene, cfg) == "megakernel":
        return render_megakernel(pack_scene(scene, basis, row0), assets, cfg)
    return render_from_basis_tracer(scene, assets, basis, cfg, row0)


def render_from_basis_checked(scene: Scene, assets: SceneAssets,
                              basis: PerspectiveBasis, cfg: RenderConfig,
                              max_retries: int = 2):
    """:func:`render_from_basis` with the JAX package's drop report: (img,
    {dropped, retries, event_slots, engine}).  The JAX megakernel deferred
    texels to a bounded event buffer and re-rendered with more slots when
    it dropped some; the port's kernel fetches texels itself, so nothing
    drops, ``dropped``, ``retries`` and ``event_slots`` are 0, and
    ``max_retries`` is never used."""
    engine = resolve_engine(scene, cfg)
    cfg = cfg.replace(engine=engine)
    return (render_from_basis(scene, assets, basis, cfg),
            {"dropped": 0, "retries": 0, "event_slots": 0, "engine": engine})


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
