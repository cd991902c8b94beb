"""The port's benchmark entry points, counterparts of the JAX package's
``benchmarks/`` scripts, and the inputs they share.

* :mod:`.stages`: the BASELINE stages 1-6, one JSON row a stage;
* :mod:`.stream`: the 163,840-triangle scene of the streamed tables (K4);
* :mod:`.scaling`: the sharded renders over worlds of 1, 2, 4, ... ranks;
* :mod:`.timing`: CUDA-event timing, the card's name and power limit, the
  kernels' launch counts.

The headline, ``tpuray_torch.bench``, and the profiling and validation
scripts, ``tpuray_torch.scripts``, time with the same module.  Every entry
point renders on the card unless ``--device cpu`` is given, prints the
device on its own line and then its rows, and reads its scene and textures
from ``--scene`` and ``--asset-dir`` (the reference tree's by default, as
``apps/raypng``).  A missing file raises, naming its path.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..camera import Camera, PerspectiveBasis, perspective_basis
from ..config import (GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                      GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                      REFERENCE_DIR)
from ..sceneio import load_scene
from ..textures import REFERENCE_ASSETS, SceneAssets, load_default_assets

DEFAULT_SCENE = os.path.join(REFERENCE_DIR, "scenes", "render.map")


def add_input_args(ap: argparse.ArgumentParser, scene: bool = True) -> None:
    """``--device`` (default cuda), ``--asset-dir`` and, with ``scene``,
    ``--scene``, with raypng's defaults."""
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' runs the CUDA kernels and "
                         "times them with CUDA events, 'cpu' the plain "
                         "versions on the host clock")
    if scene:
        ap.add_argument("--scene", default=DEFAULT_SCENE,
                        help="scene archive (render.map)")
    ap.add_argument("--asset-dir", default=REFERENCE_ASSETS,
                    help="directory holding the four textures and bg/")


def require_path(path: str, flag: str) -> str:
    """``path``, or a FileNotFoundError naming it and its flag."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{flag} {path}: no such file or directory")
    return path


def load_assets(args, device) -> SceneAssets:
    """The textures and sky of ``--asset-dir`` on ``device``."""
    return load_default_assets(require_path(args.asset_dir, "--asset-dir"),
                               device=device)


def load_inputs(args, device) -> tuple:
    """(scene, assets) from ``--scene`` and ``--asset-dir`` on ``device``."""
    spec = load_scene(require_path(args.scene, "--scene"))
    return spec.to_scene(device), load_assets(args, device)


def golden_basis(width: int, height: int, device) -> PerspectiveBasis:
    """The reference camera (raypng.c:17-21) at ``width`` x ``height``."""
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                 GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)
    return perspective_basis(cam, width, height, device=torch.device(device))
