"""Render configuration.

Port of :mod:`tpuray.config`.  The reference's config surface is all
compile-time ``#define``s: WIDTH/HEIGHT (raypng.c:8-9), MAX_DEPTH=15 and
MAX_SOFT_SHADOWS=2 (raytracing.cl:9-11), EPSILON=0.001 and
TRANSPERENT_THROUGH=0.8 (primitives.cl:5-7).  ``RenderConfig`` keeps those
fields and their defaults.  The JAX package's TPU execution knobs
(``chunk_size``, ``max_iters``, ``loop``, ``scan_iters``, ``event_slots``,
``record_slots``, ``engine``) have no meaning here: the CUDA kernel runs one
thread per pixel, fetches texels itself and needs no event buffers.
"""
from __future__ import annotations

import dataclasses
import os

# Location of the reference tree (``scenes/render.map``, ``assets/``,
# ``out/scene.png``): $TPURAY_REFERENCE, else the mount point the JAX
# package reads.
REFERENCE_DIR = os.environ.get("TPURAY_REFERENCE",
                               os.path.join(os.sep, "root", "reference"))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800                  # raypng.c:8
    height: int = 600                 # raypng.c:9
    max_depth: int = 15               # raytracing.cl:9
    shadow_samples: int = 2           # MAX_SOFT_SHADOWS, raytracing.cl:11
    epsilon: float = 1e-3             # primitives.cl:5
    transparent_through: float = 0.8  # primitives.cl:7
    default_n: float = 1.0            # raytracing.cl:7
    # 'nearest' is the reference's integer texel fetch (primitives.cl:250-256,
    # raytracing.cl:67-76) and the only mode the port has so far.
    filter: str = "nearest"

    def __post_init__(self):
        if self.filter == "bilinear":
            raise NotImplementedError(
                "filter='bilinear' is not ported yet (ROADMAP.md queue B, "
                "K2); use filter='nearest'")
        if self.filter != "nearest":
            raise ValueError(f"unknown filter {self.filter!r}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Reference camera for the golden render (raypng.c:17-21).
GOLDEN_CAMERA_ORIGIN = (0.8, 2.5, -8.0)
GOLDEN_CAMERA_LOOKDIR = (0.2, 0.0, 1.0)
GOLDEN_CAMERA_FOV = 90.0
GOLDEN_CAMERA_FOCAL = 1.0
