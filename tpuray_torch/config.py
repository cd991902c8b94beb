"""Render configuration.

Port of :mod:`tpuray.config`.  The reference's config surface is all
compile-time ``#define``s: WIDTH/HEIGHT (raypng.c:8-9), MAX_DEPTH=15 and
MAX_SOFT_SHADOWS=2 (raytracing.cl:9-11), EPSILON=0.001 and
TRANSPERENT_THROUGH=0.8 (primitives.cl:5-7).  ``RenderConfig`` keeps those
fields and their defaults, the texture filter, the engine and the whole-image
tracer's loop knobs, and ``record_slots``, the node-record capacity of the
record-mode megakernel that feeds the gradient (``kernels/replay.py``).

The JAX package's ``event_slots`` has no counterpart: the CUDA kernel fetches
texels itself, so there are no event buffers and nothing drops.
"""
from __future__ import annotations

import dataclasses
import os

# Location of the reference tree (``scenes/render.map``, ``assets/``,
# ``out/scene.png``): $TPURAY_REFERENCE, else the mount point the JAX
# package reads.
REFERENCE_DIR = os.environ.get("TPURAY_REFERENCE",
                               os.path.join(os.sep, "root", "reference"))

FILTERS = ("nearest", "bilinear")
ENGINES = ("auto", "megakernel", "tracer")
LOOPS = ("while", "scan")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800                  # raypng.c:8
    height: int = 600                 # raypng.c:9
    max_depth: int = 15               # raytracing.cl:9
    shadow_samples: int = 2           # MAX_SOFT_SHADOWS, raytracing.cl:11
    epsilon: float = 1e-3             # primitives.cl:5
    transparent_through: float = 0.8  # primitives.cl:7
    default_n: float = 1.0            # raytracing.cl:7

    # --- the whole-image tracer (kernels/trace.py) ---
    # Pixels per traced chunk; chunks run one after another, so the
    # tracer's memory stays bounded.  0 = the whole image.
    chunk_size: int = 65536
    # Cap on DFS steps per chunk (safety only: the loop ends as soon as
    # every lane is done).
    max_iters: int = 8192
    # 'while' runs until every lane is done (or max_iters); 'scan' runs at
    # most resolved_scan_iters() steps.  Autograd differentiates both.
    loop: str = "while"
    # Steps for loop='scan'.  0 = auto (2 * 2^max_depth, capped).
    scan_iters: int = 0
    # Rendering engine: 'megakernel' = the CUDA megakernel (its plain
    # PyTorch version for CPU tensors), 'tracer' = the whole-image tracer,
    # 'auto' = the megakernel where it takes the scene (at most 524,288
    # triangles), else the tracer with a RuntimeWarning.  These are the JAX
    # package's 'pallas', 'xla' and 'auto'.
    engine: str = "auto"
    # Texture and skybox sampling: 'nearest' is the reference's integer
    # texel fetch (primitives.cl:250-256, raytracing.cl:67-76), which the
    # golden comparison needs; 'bilinear' weights the 4 neighbouring texels,
    # which gives texture lookups a spatial derivative.  Both engines take
    # both.
    filter: str = "nearest"
    # Node-record slots per pixel in record mode (one record per DFS node:
    # hit code, parent slot and branch, per-light shadow ratios, texel
    # picks).  0 = auto: 2^(max_depth+1)-1 capped at 48.  Parent slots are
    # 6-bit, so at most 64.  A node past the last slot is not recorded and
    # its subtree gets no gradient; the kernel still reports the true
    # node count (``max_nodes``).
    record_slots: int = 0

    def __post_init__(self):
        for name, allowed in (("filter", FILTERS), ("engine", ENGINES),
                              ("loop", LOOPS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; "
                                 f"expected one of {allowed}")

    def resolved_record_slots(self) -> int:
        if self.record_slots:
            if not 1 <= self.record_slots <= 64:
                raise ValueError("record_slots must be in [1, 64] (parent "
                                 "slots are 6-bit)")
            return self.record_slots
        return min(2 ** (self.max_depth + 1) - 1, 48)

    def resolved_scan_iters(self) -> int:
        if self.scan_iters:
            return self.scan_iters
        return min(2 * (2 ** self.max_depth), self.max_iters)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Reference camera for the golden render (raypng.c:17-21).
GOLDEN_CAMERA_ORIGIN = (0.8, 2.5, -8.0)
GOLDEN_CAMERA_LOOKDIR = (0.2, 0.0, 1.0)
GOLDEN_CAMERA_FOV = 90.0
GOLDEN_CAMERA_FOCAL = 1.0
