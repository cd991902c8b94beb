"""Geometry, sampling and texel-index primitives on tensors.

Port of the parts of :mod:`tpuray.kernels.primitives` and of the megakernel's
helpers (``tpuray/kernels/pallas_trace.py``) that the plain version of the
megakernel needs.  Vectors are ``[..., 3]`` float32 tensors; every formula
keeps the megakernel's operation order (``b = 2*dot(v, d)`` in the sphere
test, ROADMAP C3), because grazing hits flip with the rounding.  The CUDA
kernel (``csrc/megakernel.cu``) implements the same formulas per thread.
"""
from __future__ import annotations

import numpy as np
import torch

INV_PI = float(np.float32(1.0 / np.pi))    # INVERSE_SQUARE_LIGHT, primitives.cl:6
TWO_PI = float(np.float32(2.0 * np.pi))
PI = float(np.float32(np.pi))
_U32 = 0xFFFFFFFF


def dot3(a, b):
    """ax*bx + ay*by + az*bz, in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length3(v):
    return torch.sqrt(dot3(v, v))


def distance3(a, b):
    return length3(a - b)


def cross3(a, b):
    """a x b, each component as ``a_i*b_j - a_j*b_i`` in the JAX order."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize3(v):
    """v * rsqrt(|v|^2), zero for a zero vector (pallas_trace.py:492)."""
    n2 = dot3(v, v)
    inv = torch.rsqrt(torch.where(n2 > 0, n2, torch.ones_like(n2)))
    inv = torch.where(n2 > 0, inv, torch.zeros_like(inv))
    return v * inv[..., None]


def trunc_i32(x):
    """float -> int32 conversion as XLA and CUDA's ``__float2int_rz`` do it:
    truncate toward zero, saturate at the int32 range, NaN -> 0.  Returned
    as int64 so that the floor-mods that follow cannot overflow."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return x.double().clamp(-2147483648.0, 2147483647.0).to(torch.int64)


def xorshift32(state):
    """One xorshift32 step (primitives.cl:116-125) per lane.

    ``state`` holds u32 values in an int64 tensor; shifts are masked to 32
    bits, so the right shift is logical.  The sample follows the megakernel
    (pallas_trace.py:499): the state's int32 bit pattern converted to f32,
    plus 2^32 where negative, then ``/ 2^31 * 2``, which maps the u32 range
    onto [0, 4) as the reference does.  Returns (new_state, sample f32).
    """
    x = state
    x = x ^ ((x << 13) & _U32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & _U32)
    signed = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
    fx = signed.to(torch.float32)
    fx = torch.where(fx < 0, fx + 4294967296.0, fx)
    return x, fx / 2147483648.0 * 2.0


def _cube_face_coords(d, face: int):
    """The cubemap mapping's core (primitives.cl:14-109): per-lane in-face
    fractions (fu, fv) in [0, 1] and the face's integer texel shifts (su,
    sv).  The six blocks are not exclusive and are applied in source order,
    so a later block wins a tie."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    m = torch.ones_like(x)
    uc = torch.zeros_like(x)
    vc = torch.zeros_like(x)
    su = torch.zeros_like(x, dtype=torch.int64)
    sv = torch.zeros_like(x, dtype=torch.int64)
    xp, yp, zp = x > 0, y > 0, z > 0
    for cond, mm, u, v, s_u, s_v in (
            (xp & (ax >= ay) & (ax >= az), ax, -z, y, 2 * face, face),
            (~xp & (ax >= ay) & (ax >= az), ax, z, y, 0, face),
            (yp & (ay >= ax) & (ay >= az), ay, x, -z, face, 2 * face),
            (~yp & (ay >= ax) & (ay >= az), ay, x, z, face, 0),
            (zp & (az >= ax) & (az >= ay), az, x, y, face, face),
            (~zp & (az >= ax) & (az >= ay), az, -x, y, 3 * face, face)):
        m = torch.where(cond, mm, m)
        uc = torch.where(cond, u, uc)
        vc = torch.where(cond, v, vc)
        su = torch.where(cond, s_u, su)
        sv = torch.where(cond, s_v, sv)
    safe = torch.where(m != 0, m, torch.ones_like(m))
    fu = 0.5 * (uc / safe + 1.0)
    fv = 0.5 * (vc / safe + 1.0)
    return fu, fv, su, sv


def map_to_cube(d, face: int):
    """Direction -> integer texel (u, v) in the 4x3 horizontal-cross cubemap
    (primitives.cl:14-109)."""
    fu, fv, su, sv = _cube_face_coords(d, face)
    return su + trunc_i32(fu * float(face)), sv + trunc_i32(fv * float(face))


def map_to_cube_float(d, face: int):
    """Continuous cubemap coordinates (uf, vf), the bilinear filter's
    counterpart of :func:`map_to_cube`; differentiable in ``d`` within a
    face."""
    fu, fv, su, sv = _cube_face_coords(d, face)
    return su.to(fu.dtype) + fu * float(face), sv.to(fv.dtype) + fv * float(face)


def bilinear_taps(u, v, w: int, h: int, wrap: bool):
    """The 4 bilinear taps of continuous texel coordinates (u, v), texel
    values sitting at integer coordinates: [(x, y, weight)] * 4 in the
    order (0, 0), (1, 0), (0, 1), (1, 1).  The integer coordinates wrap
    with a floor-mod (tiled plane textures) or clamp (the skybox's edges).
    The weights are differentiable in (u, v): that is the spatial gradient
    of a bilinear texture lookup (no reference analog)."""
    u0f, v0f = torch.floor(u), torch.floor(v)
    fu, fv = u - u0f, v - v0f
    u0, v0 = trunc_i32(u0f), trunc_i32(v0f)
    taps = []
    for du, dv, wgt in ((0, 0, (1 - fu) * (1 - fv)), (1, 0, fu * (1 - fv)),
                        (0, 1, (1 - fu) * fv), (1, 1, fu * fv)):
        x, y = u0 + du, v0 + dv
        if wrap:
            x, y = torch.remainder(x, w), torch.remainder(y, h)
        else:
            x, y = x.clamp(0, w - 1), y.clamp(0, h - 1)
        taps.append((x, y, wgt))
    return taps


def sky_texel(d, sky_h: int, sky_w: int):
    """Skybox texel (row, col) for direction ``d``: ``map_to_cube`` with the
    v flip and clamps of raytracing.cl:61-78 (pallas_trace.py:1826-1829)."""
    u, v = map_to_cube(d, sky_w // 4)
    return (sky_h - v).clamp(0, sky_h - 1), u.clamp(0, sky_w - 1)


def clip(x, lo: float, hi: float):
    """``jnp.clip``: max then min, whose gradient splits at a tie and lets
    NaN through."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def sky_coords(d, sky_h: int, sky_w: int):
    """Continuous skybox coordinates (x, y) for the bilinear fetch: the
    v-flipped cubemap coordinates clamped into the image
    (trace.py:573-575)."""
    uf, vf = map_to_cube_float(d, sky_w // 4)
    return clip(uf, 0.0, float(sky_w - 1)), clip(sky_h - vf, 0.0,
                                                 float(sky_h - 1))


def plane_texture_basis(normal):
    """Per-plane tangent basis (primitives.cl:219-235, pallas_trace.py:587):
    b0 is the first of cross(e_i, n), i = 0, 1, 2, with a nonzero component
    sum; b1 = cross(n, b0).  normal [..., 3] -> (b0, b1)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    c0 = torch.stack([0.0 * nx, -nz, ny], -1)
    c1 = torch.stack([nz, 0.0 * nx, -nx], -1)
    c2 = torch.stack([-ny, nx, 0.0 * nx], -1)
    s0 = (c0[..., 0] + c0[..., 1] + c0[..., 2] != 0)[..., None]
    s1 = (c1[..., 0] + c1[..., 1] + c1[..., 2] != 0)[..., None]
    b0 = torch.where(s0, c0, torch.where(s1, c1, c2))
    b1 = torch.stack([ny * b0[..., 2] - nz * b0[..., 1],
                      nz * b0[..., 0] - nx * b0[..., 2],
                      nx * b0[..., 1] - ny * b0[..., 0]], -1)
    return b0, b1


def texture_coords(b0, b1, point, scale):
    """Continuous plane-texture coordinates (u, v) of a hit point
    (primitives.cl:237-248), non-finite ones set to 0."""
    ui = dot3(b0, point) * scale
    vi = dot3(b1, point) * scale
    return (torch.where(torch.isfinite(ui), ui, torch.zeros_like(ui)),
            torch.where(torch.isfinite(vi), vi, torch.zeros_like(vi)))


def texture_texel_coords(b0, b1, point, scale, tex_h: int, tex_w: int):
    """Plane-texture texel (col, row) of a hit point (primitives.cl:237-256):
    non-finite coordinates become 0, the int cast truncates toward zero,
    and the wrap is a floor-mod, so negative coordinates tile correctly."""
    ui, vi = texture_coords(b0, b1, point, scale)
    return (torch.remainder(trunc_i32(ui), tex_w),
            torch.remainder(trunc_i32(vi), tex_h))


def intersect_sphere(o, d, center, radius):
    """Quadratic sphere test with the far-root rule (primitives.cl:170-195):
    if the near root is behind the origin the far root is used, which is
    what lets refracted rays leave a sphere.  Returns (hit, t)."""
    v = o - center
    a = dot3(d, d)
    b = 2.0 * dot3(v, d)
    c = dot3(v, v) - radius * radius
    disc = b * b - 4.0 * a * c
    has = disc >= 0
    sq = torch.sqrt(torch.where(has, disc, torch.zeros_like(disc)))
    t_near = (-b - sq) / (2.0 * a)
    t_far = (-b + sq) / (2.0 * a)
    t = torch.where(t_near < 0, t_far, t_near)
    return has & (t > 0), t


def intersect_plane(o, d, normal, point):
    """Infinite-plane test (primitives.cl:197-215), exact b == 0 reject."""
    b = dot3(d, normal)
    safe_b = torch.where(b == 0, torch.ones_like(b), b)
    t = dot3(point - o, normal) / safe_b
    return (b != 0) & (t > 0), t


TRI_DET_EPS = 1e-7


def intersect_triangle_edges(o, d, v0, e1, e2):
    """Möller–Trumbore on a triangle given as v0 and its edges e1 = v1 - v0,
    e2 = v2 - v0 (the megakernel's triangle table): double-faced, rejects
    ``|det| <= 1e-7`` on the unnormalised det, and hits where u >= 0,
    v >= 0, u + v <= 1 and t > 0.  Returns (hit, t)."""
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    ok = det.abs() > TRI_DET_EPS
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    return ok & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 0), t


def intersect_triangle(o, d, v0, v1, v2):
    """Möller–Trumbore ray/triangle test, as
    ``tpuray.kernels.primitives.intersect_triangle``.  Returns (hit, t)."""
    return intersect_triangle_edges(o, d, v0, v1 - v0, v2 - v0)


def reflect(incident, normal):
    """primitives.cl:127-130."""
    cos_i = -dot3(normal, incident)
    return incident + (2.0 * cos_i)[..., None] * normal


def sqrt_pos(x):
    """sqrt(max(x, 0)) whose gradient is zero, not NaN, where x <= 0 (TIR
    rays, degenerate quadratics on dead lanes): the double ``where`` keeps
    sqrt's infinite slope at 0 out of the backward (replay.py:52-61)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def refract(n1, n2, incident, normal):
    """primitives.cl:132-144 with the NaN TIR signal replaced by a mask and
    a gradient-guarded sqrt.  Returns (direction, tir)."""
    n = n1 / n2
    cos_i = -dot3(normal, incident)
    sin_t2 = n * n * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    cos_t = sqrt_pos(1.0 - sin_t2)
    out = n[..., None] * incident + (n * cos_i - cos_t)[..., None] * normal
    return out, tir


def schlick(n1, n2, incident, normal):
    """Schlick Fresnel (primitives.cl:146-160), with the n1 > n2
    transmission-angle substitution, the TIR -> 1 early out and a
    gradient-guarded sqrt."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -dot3(normal, incident)
    n = n1 / n2
    sin_t2 = n * n * (1.0 - cos_x * cos_x)
    tir = sin_t2 > 1.0
    cos_trans = sqrt_pos(1.0 - sin_t2)
    use_trans = n1 > n2
    cos_x = torch.where(use_trans, cos_trans, cos_x)
    x = 1.0 - cos_x
    fr = r0 + (1.0 - r0) * x * x * x * x * x
    return torch.where(use_trans & tir, torch.ones_like(fr), fr)
