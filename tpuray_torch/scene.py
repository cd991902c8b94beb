"""Scene model: materials, spheres, planes, triangles, lights as tensors.

Port of :mod:`tpuray.scene` (the reference's cpu_obj.{h,c}: struct defs at
cpu_obj.h:10-48, material presets at cpu_obj.c:6-49).  Two levels:

* ``MaterialSpec`` / ``SphereSpec`` / ... are host-side scalar dataclasses
  for authoring, field for field the JAX package's.
* ``Scene`` / ``Materials`` are structure-of-arrays dataclasses of tensors on
  one device, with the JAX ``Scene`` pytree's field names.

Triangles are carried (the archive format has them) but the renderer does
not take them yet (ROADMAP.md queue B, K3/K4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Vec3 = Tuple[float, float, float]


# ---------------------------------------------------------------------------
# Host-side authoring specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaterialSpec:
    """Phong material; field for field the reference's rmaterial
    (types.cl:4-19).  ``shininess`` is a uint in the archive but a float in
    shading (raytracing.cl:128)."""
    rgb: Vec3 = (1.0, 1.0, 1.0)
    ambient: float = 0.0
    diffuse: float = 0.0
    specular: float = 0.0
    shininess: float = 0.0
    transparent: bool = False        # reference spelling: "transperent"
    dielectric: bool = False
    n: float = 1.0                   # index of refraction
    reflectivity: float = 0.0
    texture_id: int = -1             # -1: no texture
    texture_scale: float = 0.0

    def replace(self, **kw) -> "MaterialSpec":
        return dataclasses.replace(self, **kw)


# Material presets, values from cpu_obj.c:6-49.
STONE = MaterialSpec(rgb=(1, 1, 1), ambient=0.4, diffuse=0.2, specular=0.6,
                     shininess=50, dielectric=True, n=1.57)
PLASTIC = MaterialSpec(rgb=(1, 1, 1), ambient=0.3, diffuse=0.2, specular=0.6,
                       shininess=50, n=1.4, reflectivity=0.1)
MIRROR = MaterialSpec(rgb=(0.2, 0.2, 0.2), ambient=0.3, diffuse=0.0,
                      specular=0.6, shininess=100, dielectric=True, n=1.0,
                      reflectivity=1.0)
GLASS = MaterialSpec(rgb=(0, 0, 0), ambient=0.1, diffuse=0.0, specular=0.0,
                     shininess=20, transparent=True, dielectric=True, n=1.52,
                     reflectivity=0.04)


@dataclasses.dataclass
class SphereSpec:
    origin: Vec3
    radius: float
    material: MaterialSpec


@dataclasses.dataclass
class PlaneSpec:
    normal: Vec3
    point_in_plane: Vec3
    material: MaterialSpec


@dataclasses.dataclass
class LightSpec:
    """Spherical area light (types.cl:36-42)."""
    origin: Vec3
    radius: float
    intensity: float
    rgb: Vec3


@dataclasses.dataclass
class TriangleSpec:
    v0: Vec3
    v1: Vec3
    v2: Vec3
    material: MaterialSpec


@dataclasses.dataclass
class SceneSpec:
    spheres: List[SphereSpec] = dataclasses.field(default_factory=list)
    planes: List[PlaneSpec] = dataclasses.field(default_factory=list)
    lights: List[LightSpec] = dataclasses.field(default_factory=list)
    triangles: List[TriangleSpec] = dataclasses.field(default_factory=list)

    def to_scene(self, device) -> "Scene":
        return build_scene(self, device)


# ---------------------------------------------------------------------------
# Device-side structure-of-arrays
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Materials:
    """One row per primitive."""
    rgb: torch.Tensor            # [N, 3] f32
    ambient: torch.Tensor        # [N] f32
    diffuse: torch.Tensor        # [N] f32
    specular: torch.Tensor       # [N] f32
    shininess: torch.Tensor      # [N] f32
    transparent: torch.Tensor    # [N] bool
    dielectric: torch.Tensor     # [N] bool
    n: torch.Tensor              # [N] f32
    reflectivity: torch.Tensor   # [N] f32
    texture_id: torch.Tensor     # [N] i32
    texture_scale: torch.Tensor  # [N] f32

    def to(self, device) -> "Materials":
        return Materials(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Scene:
    """Whole scene on one device; counts are the tensors' leading sizes."""
    sphere_origin: torch.Tensor    # [S, 3] f32
    sphere_radius: torch.Tensor    # [S] f32
    sphere_mat: Materials          # fields [S]
    plane_normal: torch.Tensor     # [P, 3] f32
    plane_point: torch.Tensor      # [P, 3] f32
    plane_mat: Materials           # fields [P]
    light_origin: torch.Tensor     # [L, 3] f32
    light_radius: torch.Tensor     # [L] f32
    light_intensity: torch.Tensor  # [L] f32
    light_rgb: torch.Tensor        # [L, 3] f32
    tri_v0: torch.Tensor           # [T, 3] f32
    tri_v1: torch.Tensor           # [T, 3] f32
    tri_v2: torch.Tensor           # [T, 3] f32
    tri_mat: Materials             # fields [T]

    @property
    def num_spheres(self) -> int:
        return self.sphere_radius.shape[0]

    @property
    def num_planes(self) -> int:
        return self.plane_normal.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_radius.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sphere_radius.device

    def to(self, device) -> "Scene":
        return Scene(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


_MATERIAL_DTYPES = {
    "rgb": np.float32, "ambient": np.float32, "diffuse": np.float32,
    "specular": np.float32, "shininess": np.float32,
    "transparent": np.bool_, "dielectric": np.bool_, "n": np.float32,
    "reflectivity": np.float32, "texture_id": np.int32,
    "texture_scale": np.float32,
}


def _stack_materials(mats: Sequence[MaterialSpec]) -> Dict[str, np.ndarray]:
    out = {}
    for name, dtype in _MATERIAL_DTYPES.items():
        shape = (len(mats), 3) if name == "rgb" else (len(mats),)
        out[name] = np.array([getattr(m, name) for m in mats],
                             dtype).reshape(shape)
    return out


def _morton_argsort(tris: Sequence[TriangleSpec]) -> np.ndarray:
    """Spatial (Morton / Z-order) ordering of triangles by centroid, as
    :func:`tpuray.scene._morton_argsort`: 10 bits per axis over the scene's
    bounding box, stable argsort.  Keeps the triangle order of a built
    scene identical to the JAX package's."""
    n = len(tris)
    if n <= 1:
        return np.arange(n)
    v = np.array([[t.v0, t.v1, t.v2] for t in tris], np.float64)
    c = v.mean(axis=1)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.minimum((c - lo) / span * 1024.0, 1023.0).astype(np.uint64)

    def part1by2(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
        return x

    code = part1by2(q[:, 0]) | (part1by2(q[:, 1]) << np.uint64(1)) \
        | (part1by2(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def spec_arrays(spec: SceneSpec) -> Dict[str, np.ndarray]:
    """The scene's leaves as numpy arrays under the JAX ``Scene`` field
    names (``sphere_origin``, ``sphere_mat.rgb``, ...)."""
    f32 = np.float32

    def vecs(items, get):
        return np.array([get(x) for x in items], f32).reshape(-1, 3)

    def scalars(items, get):
        return np.array([get(x) for x in items], f32).reshape(-1)

    tris = [spec.triangles[i] for i in _morton_argsort(spec.triangles)]
    arrays = {
        "sphere_origin": vecs(spec.spheres, lambda s: s.origin),
        "sphere_radius": scalars(spec.spheres, lambda s: s.radius),
        "plane_normal": vecs(spec.planes, lambda p: p.normal),
        "plane_point": vecs(spec.planes, lambda p: p.point_in_plane),
        "light_origin": vecs(spec.lights, lambda l: l.origin),
        "light_radius": scalars(spec.lights, lambda l: l.radius),
        "light_intensity": scalars(spec.lights, lambda l: l.intensity),
        "light_rgb": vecs(spec.lights, lambda l: l.rgb),
        "tri_v0": vecs(tris, lambda t: t.v0),
        "tri_v1": vecs(tris, lambda t: t.v1),
        "tri_v2": vecs(tris, lambda t: t.v2),
    }
    for prefix, mats in (("sphere_mat", [s.material for s in spec.spheres]),
                         ("plane_mat", [p.material for p in spec.planes]),
                         ("tri_mat", [t.material for t in tris])):
        for name, arr in _stack_materials(mats).items():
            arrays[f"{prefix}.{name}"] = arr
    return arrays


def scene_leaves(scene: Scene) -> Dict[str, torch.Tensor]:
    """The scene's tensors by name, in field order, materials as
    ``sphere_mat.rgb`` etc. (the names of the JAX ``Scene``'s leaves)."""
    out = {}
    for f in dataclasses.fields(scene):
        value = getattr(scene, f.name)
        if isinstance(value, Materials):
            for k in _MATERIAL_DTYPES:
                out[f"{f.name}.{k}"] = getattr(value, k)
        else:
            out[f.name] = value
    return out


def scene_from_leaves(leaves: Dict[str, torch.Tensor]) -> Scene:
    """Inverse of :func:`scene_leaves`; the tensors are used as they are."""
    kw = {}
    for f in dataclasses.fields(Scene):
        if f.type in ("Materials", Materials):
            kw[f.name] = Materials(**{k: leaves[f"{f.name}.{k}"]
                                      for k in _MATERIAL_DTYPES})
        else:
            kw[f.name] = leaves[f.name]
    return Scene(**kw)


def scene_from_arrays(arrays: Dict[str, np.ndarray], device) -> Scene:
    """Build a ``Scene`` from leaves named as the JAX ``Scene``'s fields
    (materials as ``sphere_mat.rgb`` etc.).  This is how identical numbers
    reach both packages: build once, convert each leaf to numpy, hand the
    dict to both."""
    def t(name):
        dtype = _MATERIAL_DTYPES.get(name.rpartition(".")[2], np.float32)
        return torch.from_numpy(np.array(arrays[name], dtype)).to(device)

    return scene_from_leaves({name: t(name) for name in arrays})


def build_scene(spec: SceneSpec, device) -> Scene:
    """Authoring spec -> ``Scene`` on ``device`` (triangles Morton-sorted
    like :func:`tpuray.scene.build_scene`)."""
    return scene_from_arrays(spec_arrays(spec), device)


def canonical_scene_spec() -> SceneSpec:
    """The canonical demo scene, value for value from scene_dump.c:8-69.

    Written with :func:`tpuray_torch.sceneio.dump_scene` it reproduces every
    meaningful byte of the reference's ``scenes/render.map``; only the 19
    struct-padding bytes, which the reference fills with uninitialised
    stack memory, differ (they are zero here).
    """
    spheres = [
        SphereSpec((4.5, 0.5, -1.0), 0.5,
                   PLASTIC.replace(rgb=(1.0, 0.0, 0.0))),
        SphereSpec((-1.0, 1.0, 4.5), 0.8,
                   PLASTIC.replace(rgb=(0.0, 0.0, 1.0))),
        SphereSpec((0.8, 0.8, 1.5), 0.8, GLASS),
        SphereSpec((-0.6, 0.8, -1.0), 0.8,
                   GLASS.replace(rgb=(0.0, 1.0, 0.0), ambient=0.05)),
    ]
    planes = [
        PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                  STONE.replace(rgb=(0.0, 0.0, 0.0), texture_scale=100.0,
                                texture_id=2)),
        PlaneSpec((0.0, 0.0, -1.0), (0.0, 0.0, 7.0),
                  MIRROR.replace(ambient=0.3, shininess=150, specular=0.4,
                                 rgb=(0.3, 0.3, 0.3))),
    ]
    lights = [
        LightSpec((-2.0, 3.0, 2.0), 0.1, 8.0, (0.0, 1.0, 0.0)),
        LightSpec((2.0, 1.5, 0.2), 0.1, 50.3, (1.0, 1.0, 1.0)),
        LightSpec((1.0, 4.0, 3.0), 0.1, 20.5, (0.0, 0.0, 1.0)),
    ]
    return SceneSpec(spheres=spheres, planes=planes, lights=lights)
