"""Byte-compatible reader/writer for the reference's binary scene archive.

Port of :mod:`tpuray.sceneio`, pure ``struct`` and byte for byte the same.
Format (dump_robj/extract_robj, cpu_obj.c:51-101): a tag-less little-endian
archive ``[u8 n][n x rsphere][u8 n][n x rplane][u8 n][n x rlight]`` of raw
16-byte-aligned C structs:

* ``rmaterial`` - 64 B: rgb float3 @0 (xyz + 4 B pad), ambient @16,
  diffuse @20, specular @24, shininess u32 @28, transperent u32 @32,
  dielectric u32 @36, n @40, reflectivity @44, texture_id i32 @48,
  texture_scale @52, pad -> 64.
* ``rsphere`` - 96 B: origin float3 @0, radius @16, pad, material @32.
* ``rplane`` - 96 B: normal float3 @0, point_in_plane float3 @16,
  material @32.
* ``rlight`` - 48 B: origin float3 @0, radius @16, intensity @20, pad,
  rgb float3 @32.

The "v2" section for triangles (an extension the reference does not have)
follows the v1 payload: magic ``b"TPURAY2\\0"``, then ``[u32 n][n x
rtriangle]`` where ``rtriangle`` is 112 B: v0/v1/v2 float3s (@0/@16/@32) +
material @48.  The reference's reader stops after the v1 bytes, so v2
archives stay readable by it.
"""
from __future__ import annotations

import struct
from typing import List

from .scene import (LightSpec, MaterialSpec, PlaneSpec, SceneSpec, SphereSpec,
                    TriangleSpec)

MATERIAL_SIZE = 64
SPHERE_SIZE = 96
PLANE_SIZE = 96
LIGHT_SIZE = 48
TRIANGLE_SIZE = 112
V2_MAGIC = b"TPURAY2\x00"


def _pack_vec3(v) -> bytes:
    return struct.pack("<3f4x", float(v[0]), float(v[1]), float(v[2]))


def _unpack_vec3(buf: bytes, off: int):
    return struct.unpack_from("<3f", buf, off)


def _pack_material(m: MaterialSpec) -> bytes:
    return (_pack_vec3(m.rgb) +
            struct.pack("<3fIIIff", float(m.ambient), float(m.diffuse),
                        float(m.specular), int(round(m.shininess)),
                        1 if m.transparent else 0, 1 if m.dielectric else 0,
                        float(m.n), float(m.reflectivity)) +
            struct.pack("<if8x", int(m.texture_id), float(m.texture_scale)))


def _unpack_material(buf: bytes, off: int) -> MaterialSpec:
    rgb = _unpack_vec3(buf, off)
    (ambient, diffuse, specular, shininess, transparent, dielectric, n,
     reflectivity) = struct.unpack_from("<3fIIIff", buf, off + 16)
    texture_id, texture_scale = struct.unpack_from("<if", buf, off + 48)
    return MaterialSpec(rgb=rgb, ambient=ambient, diffuse=diffuse,
                        specular=specular, shininess=float(shininess),
                        transparent=bool(transparent),
                        dielectric=bool(dielectric), n=n,
                        reflectivity=reflectivity, texture_id=texture_id,
                        texture_scale=texture_scale)


def _pack_sphere(s: SphereSpec) -> bytes:
    return (_pack_vec3(s.origin) + struct.pack("<f12x", float(s.radius)) +
            _pack_material(s.material))


def _unpack_sphere(buf: bytes, off: int) -> SphereSpec:
    origin = _unpack_vec3(buf, off)
    (radius,) = struct.unpack_from("<f", buf, off + 16)
    return SphereSpec(origin=origin, radius=radius,
                      material=_unpack_material(buf, off + 32))


def _pack_plane(p: PlaneSpec) -> bytes:
    return (_pack_vec3(p.normal) + _pack_vec3(p.point_in_plane) +
            _pack_material(p.material))


def _unpack_plane(buf: bytes, off: int) -> PlaneSpec:
    return PlaneSpec(normal=_unpack_vec3(buf, off),
                     point_in_plane=_unpack_vec3(buf, off + 16),
                     material=_unpack_material(buf, off + 32))


def _pack_light(l: LightSpec) -> bytes:
    return (_pack_vec3(l.origin) +
            struct.pack("<ff8x", float(l.radius), float(l.intensity)) +
            _pack_vec3(l.rgb))


def _unpack_light(buf: bytes, off: int) -> LightSpec:
    origin = _unpack_vec3(buf, off)
    radius, intensity = struct.unpack_from("<ff", buf, off + 16)
    rgb = _unpack_vec3(buf, off + 32)
    return LightSpec(origin=origin, radius=radius, intensity=intensity,
                     rgb=rgb)


def _pack_triangle(t: TriangleSpec) -> bytes:
    return (_pack_vec3(t.v0) + _pack_vec3(t.v1) + _pack_vec3(t.v2) +
            _pack_material(t.material))


def _unpack_triangle(buf: bytes, off: int) -> TriangleSpec:
    return TriangleSpec(v0=_unpack_vec3(buf, off),
                        v1=_unpack_vec3(buf, off + 16),
                        v2=_unpack_vec3(buf, off + 32),
                        material=_unpack_material(buf, off + 48))


def dumps_scene(spec: SceneSpec) -> bytes:
    """Serialize to the archive format (v1 + optional v2 triangle section)."""
    out = [struct.pack("<B", len(spec.spheres))]
    out += [_pack_sphere(s) for s in spec.spheres]
    out.append(struct.pack("<B", len(spec.planes)))
    out += [_pack_plane(p) for p in spec.planes]
    out.append(struct.pack("<B", len(spec.lights)))
    out += [_pack_light(l) for l in spec.lights]
    if spec.triangles:
        out.append(V2_MAGIC)
        out.append(struct.pack("<I", len(spec.triangles)))
        out += [_pack_triangle(t) for t in spec.triangles]
    return b"".join(out)


def loads_scene(buf: bytes) -> SceneSpec:
    """Parse an archive produced by dump_robj (cpu_obj.c:51-74) or by us."""
    off = 0
    (ns,) = struct.unpack_from("<B", buf, off)
    off += 1
    spheres = []
    for _ in range(ns):
        spheres.append(_unpack_sphere(buf, off))
        off += SPHERE_SIZE
    (npl,) = struct.unpack_from("<B", buf, off)
    off += 1
    planes = []
    for _ in range(npl):
        planes.append(_unpack_plane(buf, off))
        off += PLANE_SIZE
    (nl,) = struct.unpack_from("<B", buf, off)
    off += 1
    lights = []
    for _ in range(nl):
        lights.append(_unpack_light(buf, off))
        off += LIGHT_SIZE
    triangles: List[TriangleSpec] = []
    if buf[off:off + len(V2_MAGIC)] == V2_MAGIC:
        off += len(V2_MAGIC)
        (nt,) = struct.unpack_from("<I", buf, off)
        off += 4
        for _ in range(nt):
            triangles.append(_unpack_triangle(buf, off))
            off += TRIANGLE_SIZE
    return SceneSpec(spheres=spheres, planes=planes, lights=lights,
                     triangles=triangles)


def dump_scene(path: str, spec: SceneSpec) -> None:
    with open(path, "wb") as f:
        f.write(dumps_scene(spec))


def load_scene(path: str) -> SceneSpec:
    with open(path, "rb") as f:
        return loads_scene(f.read())
