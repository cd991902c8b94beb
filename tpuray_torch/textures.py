"""Plane textures + cubemap skybox.

Port of :mod:`tpuray.textures` (``cl_wrap_load_images``,
opencl_wrap.c:189-349, which loads N same-size RGB8 PNGs into one OpenCL
``image2d_array``).  ``SceneAssets`` holds the textures as one
``[N, H, W, 3] uint8`` tensor and the skybox, a 4x3 horizontal-cross
cubemap (face size = width / 4, raytracing.cl:62-63), as ``[Hs, Ws, 3]
uint8``, both on one device.  The CUDA kernel reads texels straight from
them, so there is no packed atlas.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from .config import REFERENCE_DIR
from .io import read_png

REFERENCE_ASSETS = os.path.join(REFERENCE_DIR, "assets")

# Texture load order of both reference apps (raypng.c:74-78,
# rayinteractive.c:170-174): the ground plane's texture_id=2 is check.png.
DEFAULT_TEXTURES = ("cobblestone.png", "sand.png", "check.png", "grass.png")
DEFAULT_SKYBOX = "bg/stormydays.png"


@dataclasses.dataclass
class SceneAssets:
    textures: torch.Tensor  # [N, H, W, 3] u8 plane textures
    skybox: torch.Tensor    # [Hs, Ws, 3] u8 4x3-cross cubemap

    @property
    def device(self) -> torch.device:
        return self.textures.device

    def to(self, device) -> "SceneAssets":
        return SceneAssets(self.textures.to(device), self.skybox.to(device))


def _check_skybox(sky: np.ndarray, name: str) -> None:
    if sky.ndim != 3 or sky.shape[2] != 3 or sky.shape[1] % 4 \
            or sky.shape[0] * 4 != sky.shape[1] * 3:
        raise ValueError(f"skybox {name} has shape {sky.shape}; expected a "
                         "4x3 horizontal-cross cubemap [3F, 4F, 3]")


def assets_from_arrays(textures: np.ndarray, skybox: np.ndarray,
                       device) -> SceneAssets:
    """u8 numpy arrays ([N, H, W, 3] and [Hs, Ws, 3]) -> ``SceneAssets``."""
    # order 'C': a copy in numpy's default order 'K' keeps a broadcast
    # array's strides, and the kernels take contiguous assets only
    tex = np.array(textures, np.uint8, order="C")
    sky = np.array(skybox, np.uint8, order="C")
    if tex.ndim != 4 or tex.shape[0] < 1 or tex.shape[3] != 3:
        raise ValueError(f"textures must be u8 [N>=1, H, W, 3], got "
                         f"{tex.shape}")
    _check_skybox(sky, "array")
    return SceneAssets(torch.from_numpy(tex).to(device),
                       torch.from_numpy(sky).to(device))


def load_textures(paths: Sequence[str]) -> np.ndarray:
    """Same-size RGB8 PNGs -> [N, H, W, 3] u8."""
    imgs = [read_png(p) for p in paths]
    for p, im in zip(paths, imgs):
        if im.shape != imgs[0].shape:
            raise ValueError(f"texture size mismatch: {p} has {im.shape}, "
                             f"expected {imgs[0].shape} (all layers must "
                             "match, as in opencl_wrap.c:223-231)")
    return np.stack(imgs)


def load_default_assets(asset_dir: str = REFERENCE_ASSETS,
                        skybox: str = DEFAULT_SKYBOX, *,
                        device) -> SceneAssets:
    """The asset set the reference apps bind (raypng.c:74-81).  ``skybox``
    is relative to ``asset_dir`` (the reference ships ``bg/stormydays.png``,
    used, and ``bg/lake.png``)."""
    tex = load_textures([os.path.join(asset_dir, t) for t in DEFAULT_TEXTURES])
    sky_path = os.path.join(asset_dir, skybox)
    sky = read_png(sky_path)
    _check_skybox(sky, sky_path)
    return assets_from_arrays(tex, sky, device)


def solid_assets(n_textures: int = 1, tex_size: int = 8, sky_face: int = 4,
                 rgb=(0, 0, 0), *, device) -> SceneAssets:
    """Flat-colour assets for scenes without textures."""
    col = np.asarray(rgb, np.uint8)
    tex = np.broadcast_to(col, (n_textures, tex_size, tex_size, 3))
    sky = np.broadcast_to(col, (sky_face * 3, sky_face * 4, 3))
    return assets_from_arrays(tex, sky, device)


def random_asset_arrays(seed: int, tex_size: int = 64, sky_face: int = 32,
                        block: int = 8):
    """Seeded stand-in for the reference's assets, in their layout: four
    textures [4, tex_size, tex_size, 3] and a 4x3-cross skybox
    [3 * sky_face, 4 * sky_face, 3], u8 numpy arrays.  Each image is made
    of ``block`` x ``block`` squares of one random colour, so that, as in
    the real images, neighbouring texels mostly agree and a nearest fetch
    that lands one texel over changes the colour only at square edges."""
    if tex_size % block or sky_face % block:
        raise ValueError(f"tex_size={tex_size} and sky_face={sky_face} must "
                         f"be multiples of block={block}")
    rng = np.random.default_rng(seed)

    def squares(shape):
        img = rng.integers(0, 256, shape[:-3] + (shape[-3] // block,
                                                 shape[-2] // block, 3),
                           dtype=np.uint8)
        return img.repeat(block, -3).repeat(block, -2)

    tex = squares((len(DEFAULT_TEXTURES), tex_size, tex_size, 3))
    sky = squares((3 * sky_face, 4 * sky_face, 3))
    return tex, sky
