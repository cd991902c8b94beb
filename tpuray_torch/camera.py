"""Camera model and perspective-basis math.

Port of :mod:`tpuray.camera`: ``rinit_camera`` (cpu_ray.c:24-35) and
``rlookat`` (cpu_ray.c:37-39), ``rgen_perspective`` (cpu_ray.c:42-106) and
the spherical-angle camera controls of the interactive viewer
(rayinteractive.c:85-92).

The perspective construction is reproduced formula for formula in float32,
including the *unnormalised* right/up basis vectors (the reference builds
them with raw cross products, cpu_ray.c:82-91) and the world-up (0,1,0)
convention, so ray directions match the raygen kernel (raygen.cl:16-21).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

_FLT_EPSILON = np.float32(1.1920929e-07)


@dataclasses.dataclass
class Camera:
    """Position + look direction + intrinsics (cpu_ray.h:19-26)."""
    origin: Tuple[float, float, float]
    lookdir: Tuple[float, float, float]   # normalised on construction
    fov: float = 90.0                     # degrees
    focal_length: float = 1.0

    def __post_init__(self):
        d = np.asarray(self.lookdir, np.float32)
        n = np.float32(1.0) / np.float32(np.sqrt(np.float32(
            d[0] * d[0] + d[1] * d[1] + d[2] * d[2])))
        self.lookdir = tuple(np.float32(x * n) for x in d)

    def lookat(self, direction) -> "Camera":
        """rlookat (cpu_ray.c:37-39): replace the look direction."""
        return Camera(self.origin, tuple(direction), self.fov,
                      self.focal_length)

    def with_spherical(self, x_rot: float, y_rot: float) -> "Camera":
        """Spherical-angle look direction, y-up (rayinteractive.c:85-92)."""
        d = (np.sin(x_rot) * np.cos(y_rot), np.cos(x_rot),
             np.sin(x_rot) * np.sin(y_rot))
        return self.lookat(d)

    def moved(self, delta) -> "Camera":
        o = tuple(np.float32(a + b) for a, b in zip(self.origin, delta))
        return Camera(o, self.lookdir, self.fov, self.focal_length)


@dataclasses.dataclass
class PerspectiveBasis:
    """The six quantities the reference uploads as raygen kernel arguments
    (raypng.c:50-57), as float32 tensors on one device."""
    corner: torch.Tensor    # [3] vector to the image's left-top corner
    origin: torch.Tensor    # [3] camera origin
    up: torch.Tensor        # [3] (unnormalised)
    right: torch.Tensor     # [3] (unnormalised)
    w_factor: torch.Tensor  # [] image-plane step per pixel column
    h_factor: torch.Tensor  # [] image-plane step per pixel row

    def to(self, device) -> "PerspectiveBasis":
        return PerspectiveBasis(**{f.name: getattr(self, f.name).to(device)
                                   for f in dataclasses.fields(self)})


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def perspective_basis(camera: Camera, width: int, height: int,
                      validate: bool = True, *,
                      device) -> PerspectiveBasis:
    """rgen_perspective (cpu_ray.c:42-106), float32 throughout.

    Rejects fov ~ 180 deg / ~ 0 deg and a look direction equal to world-up
    (gimbal lock) as the reference does (cpu_ray.c:58-62).
    """
    fov = np.float32(camera.fov)
    if validate:
        is_180 = (fov - np.float32(180.0) <= _FLT_EPSILON
                  and fov - np.float32(180.0) >= 0)
        if is_180 or fov <= _FLT_EPSILON or \
                tuple(camera.lookdir) == (0.0, 1.0, 0.0):
            raise ValueError(
                f"invalid camera: fov={camera.fov} lookdir={camera.lookdir} "
                "(fov must be in (0, 180) and lookdir must not equal world-up)")

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    origin = t(camera.origin)
    lookdir = t(camera.lookdir)
    top = t([0.0, 1.0, 0.0])
    focal = t(camera.focal_length)

    half_fov = (fov / np.float32(360.0)) * np.float32(np.pi)
    aspect = t(np.float32(height) / np.float32(width))
    fov_tan = torch.tan(t(half_fov))

    image_width = fov_tan * focal * 2
    image_height = aspect * image_width

    w_factor = image_width / t(width)
    h_factor = image_height / t(height)

    forward = -lookdir
    right = _cross(top, forward)
    up = _cross(forward, right)

    image_center = -forward * focal
    corner = image_center - right * (image_width / 2) + up * (image_height / 2)
    return PerspectiveBasis(corner=corner, origin=origin, up=up, right=right,
                            w_factor=w_factor, h_factor=h_factor)


def generate_rays(basis: PerspectiveBasis, width: int, height: int,
                  row0: int = 0):
    """Per-pixel primary rays, the raygen kernel (raygen.cl:5-25).

    Pixel (col, row) looks along ``normalize(corner + right*w_factor*col -
    up*h_factor*row)`` at integer pixel offsets (no half-pixel centring,
    raygen.cl:13-16).  ``row0`` is the image row of the first generated row,
    so a slab of rows gets the directions the full image gives them.

    Returns (origins [H*W, 3], dirs [H*W, 3]) on the basis' device.
    """
    dev = basis.corner.device
    w = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    h = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + row0
    vec = (basis.corner[None, None, :]
           + basis.right[None, None, :] * (basis.w_factor * w)[..., None]
           - basis.up[None, None, :] * (basis.h_factor * h)[..., None])
    norm = torch.sqrt(vec[..., 0] * vec[..., 0] + vec[..., 1] * vec[..., 1]
                      + vec[..., 2] * vec[..., 2])[..., None]
    dirs = (vec / norm).reshape(-1, 3)
    origins = basis.origin.expand(height * width, 3)
    return origins, dirs
