"""tpuray_torch: the Whitted raytracer of :mod:`tpuray` in PyTorch, with its
megakernel hand-written in CUDA for NVIDIA Hopper (H100).

It keeps ``tpuray``'s module names so that each counterpart is easy to
find, imports neither ``jax`` nor ``tpuray``, and is held against the JAX
package by ``tests/test_torch_*.py``.

Layer map (reference -> here):
  src/cl/*.cl (device kernels)   -> tpuray_torch.kernels (CUDA + plain torch)
  src/cpu_ray.{h,c} (camera/png) -> tpuray_torch.camera, tpuray_torch.io
  src/cpu_obj.{h,c} (scene/ser.) -> tpuray_torch.scene, tpuray_torch.sceneio
  raypng.c / scene_dump.c (apps) -> tpuray_torch.apps.{raypng,scenegen}
  (no reference analog: gradients) -> tpuray_torch.diff, kernels.replay,
                                      apps.invrender, utils.checkpoint
"""

from .camera import Camera, PerspectiveBasis, generate_rays, perspective_basis
from .config import RenderConfig
from .diff import (combine, l2_image_loss, partition, render_megakernel_diff,
                   value_and_scene_grad)
from .io import DiffStats, image_diff_stats, read_png, write_png
from .kernels.megakernel import (pack_scene, render_megakernel,
                                 render_megakernel_record,
                                 render_megakernel_record_reference,
                                 render_megakernel_reference)
from .kernels.replay import replay_render
from .render import quantize_image, render, render_from_basis, render_u8
from .scene import (GLASS, MIRROR, PLASTIC, STONE, LightSpec, MaterialSpec,
                    Materials, PlaneSpec, Scene, SceneSpec, SphereSpec,
                    TriangleSpec, build_scene, canonical_scene_spec,
                    scene_from_arrays, scene_from_leaves, scene_leaves)
from .sceneio import dump_scene, dumps_scene, load_scene, loads_scene
from .textures import (SceneAssets, assets_from_arrays, load_default_assets,
                       random_asset_arrays, solid_assets)

__version__ = "0.1.0"
