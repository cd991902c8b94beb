"""Triangle meshes for mesh scenes, made procedurally.

Port of :mod:`tpuray.meshes` (numpy, on the port's :mod:`scene`).  The
reference has only spheres and infinite planes (cpu_obj.h:10-48); triangles
are the JAX package's extension, and its mesh benchmark scenes are an
icosphere and a torus, so that they need no external asset.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .scene import (PLASTIC, MaterialSpec, SceneSpec, TriangleSpec,
                    canonical_scene_spec)

Vec3 = Tuple[float, float, float]


def icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron (12 vertices, 20 faces)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    return v, f


def icosphere(order: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron projected onto the unit sphere: 20 * 4^order
    triangles."""
    v, f = icosahedron()
    for _ in range(order):
        verts = list(map(tuple, v))
        index = {t: i for i, t in enumerate(verts)}

        def midpoint(a, b):
            m = v[a] + v[b]
            m /= np.linalg.norm(m)
            t = tuple(m)
            if t not in index:
                index[t] = len(verts)
                verts.append(t)
            return index[t]

        new_f = []
        for a, b, c in f:
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca = midpoint(c, a)
            new_f += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts, np.float64)
        f = np.asarray(new_f, np.int64)
    return v, f


def torus(major: float = 1.0, minor: float = 0.35, nu: int = 48,
          nv: int = 24) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulated torus: 2 * nu * nv triangles."""
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    y = minor * np.sin(vv)
    z = (major + minor * np.cos(vv)) * np.sin(uu)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = i * nv + (j + 1) % nv
            d = ((i + 1) % nu) * nv + (j + 1) % nv
            faces += [[a, b, c], [b, d, c]]
    return verts, np.asarray(faces, np.int64)


def mesh_triangles(verts: np.ndarray, faces: np.ndarray,
                   material: MaterialSpec, scale: float = 1.0,
                   offset: Vec3 = (0.0, 0.0, 0.0)) -> List[TriangleSpec]:
    """One TriangleSpec per face of a (verts, faces) mesh."""
    off = np.asarray(offset, np.float64)
    return [TriangleSpec(tuple(verts[a] * scale + off),
                         tuple(verts[b] * scale + off),
                         tuple(verts[c] * scale + off), material)
            for a, b, c in faces]


def add_mesh(spec: SceneSpec, verts: np.ndarray, faces: np.ndarray,
             material: MaterialSpec, scale: float = 1.0,
             offset: Vec3 = (0.0, 0.0, 0.0)) -> SceneSpec:
    spec.triangles += mesh_triangles(verts, faces, material, scale, offset)
    return spec


def mesh_benchmark_scene(order: int = 4,
                         torus_res: Tuple[int, int] = (48, 24)) -> SceneSpec:
    """The canonical scene's planes and lights, its first two spheres, an
    icosphere where the glass spheres were and a torus: 20 * 4^order +
    2 * nu * nv triangles (7,424 with the defaults; ``torus_res=(64, 40)``
    gives 10,240)."""
    spec = canonical_scene_spec()
    spec.spheres = spec.spheres[:2]
    v, f = icosphere(order)
    add_mesh(spec, v, f, PLASTIC.replace(rgb=(0.9, 0.7, 0.2)),
             scale=0.8, offset=(0.8, 0.8, 1.5))
    v2, f2 = torus(nu=torus_res[0], nv=torus_res[1])
    add_mesh(spec, v2, f2, PLASTIC.replace(rgb=(0.2, 0.8, 0.9)),
             scale=0.6, offset=(-0.6, 0.8, -1.0))
    return spec
