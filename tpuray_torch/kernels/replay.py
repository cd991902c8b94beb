"""Saved-path replay: the backward of the record-mode megakernel.

Port of :mod:`tpuray.kernels.replay`.  The record-mode megakernel
(``megakernel.render_megakernel_record``) writes one record per DFS node:
the primitive or light it hit, its parent's slot and branch, the soft-shadow
ratio of each light and the texel it fetched.  Those freeze every discrete
decision of the traversal, all piecewise constant in the scene parameters.
:func:`replay_render` recomputes, with plain differentiable tensor code and
no primitive search, no shadow feelers and no loop over a ray stack, every
recorded node's hit point, normal, Phong shading against the recorded
ratios and Schlick-weighted child rays.  Each node reads its ray and
throughput from its parent's slot.  Summed, the nodes give the kernel's
image again, and autograd through that sum is the kernel's backward
(``diff.render_megakernel_diff``).

Differences from the JAX replay:

* The texel colour comes from the recorded pick, straight from the u8
  asset tensors (no atlas, no batched row gather): it is a constant, and
  only its weight (``f`` for the sky, ``f * ambient`` for a textured plane)
  carries a gradient.  Every pick is recorded, so nothing is dropped.
* Per-solid and per-light parameters are read with one one-hot product
  per slot (:func:`_pick_rows`), as in the JAX replay, over one table of
  all solids' fields rather than one product per field.  Its backward is
  a sum over pixels in a fixed order: no atomics, the same gradient from
  run to run.  (A row index, ``table[code]``, has an index-put backward
  that piles every pixel's gradient onto a handful of rows; on the H100
  it was most of a training step's device time, PERF.md.)
* A popped child reads its parent's reflected candidate with one gather
  over the candidates of the earlier slots (see :func:`replay_render`).
* Slots at and past ``max_nodes`` hold no record in any pixel and are
  skipped.

Triangles (K3/K4 records) and bilinear records (K2) are not ported yet
(ROADMAP.md queue B); :func:`replay_render` refuses them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..camera import PerspectiveBasis, generate_rays
from ..config import RenderConfig
from ..scene import Scene
from ..textures import SceneAssets
from . import primitives as pr
from .megakernel import (LIGHT_CODE, MAX_RECORD_LIGHTS, MAX_RECORD_SOLIDS,
                         MISS_CODE, PC_REFRACT, PC_VALID)

F32 = torch.float32


def _sqrt_pos(x):
    """sqrt(max(x, 0)) whose gradient is zero, not NaN, where x <= 0 (TIR
    rays, degenerate quadratics on dead slots): the double ``where`` keeps
    sqrt's infinite slope at 0 out of the backward (replay.py:52-61)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _sphere_t(o, d, center, radius, active):
    """Recorded-winner sphere t, far-root rule (primitives.cl:170-195).
    Inactive lanes get a unit ray, so the quadratic never divides by zero;
    ``b = 2 * dot(v, d)`` keeps the kernel's operation order, which grazing
    hits amplify (replay.py:64-85)."""
    unit = torch.tensor([0.0, 0.0, 1.0], dtype=F32, device=d.device)
    d = torch.where(active[:, None], d, unit)
    v = o - center
    a = pr.dot3(d, d)
    a = torch.where(a > 0, a, torch.ones_like(a))
    b = 2.0 * pr.dot3(v, d)
    c = pr.dot3(v, v) - radius * radius
    sq = _sqrt_pos(b * b - 4.0 * a * c)
    two_a = 2.0 * a
    t_near = (-b - sq) / two_a
    t_far = (-b + sq) / two_a
    return torch.where(t_near < 0, t_far, t_near)


def _refract(n1, n2, incident, normal):
    """primitives.cl:132-144 with a gradient-guarded TIR sqrt."""
    n = n1 / n2
    cos_i = -pr.dot3(normal, incident)
    sin_t2 = n * n * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    cos_t = _sqrt_pos(1.0 - sin_t2)
    out = n[:, None] * incident + (n * cos_i - cos_t)[:, None] * normal
    return out, tir


def _schlick(n1, n2, incident, normal):
    """primitives.cl:146-160 with a gradient-guarded transmission sqrt."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -pr.dot3(normal, incident)
    n = n1 / n2
    sin_t2 = n * n * (1.0 - cos_x * cos_x)
    tir = sin_t2 > 1.0
    cos_trans = _sqrt_pos(1.0 - sin_t2)
    use_trans = n1 > n2
    cos_x = torch.where(use_trans, cos_trans, cos_x)
    x = 1.0 - cos_x
    fr = r0 + (1.0 - r0) * x * x * x * x * x
    return torch.where(use_trans & tir, torch.ones_like(fr), fr)


# columns of the per-solid table (spheres first, then planes, as the codes)
_COLS = {"center": slice(0, 3), "radius": 3, "normal": slice(4, 7),
         "point": slice(7, 10), "rgb": slice(10, 13)}
_MAT_FIELDS = ("ambient", "diffuse", "specular", "shininess", "transparent",
               "dielectric", "n", "reflectivity", "texture_id",
               "texture_scale")
for _i, _name in enumerate(_MAT_FIELDS):
    _COLS[_name] = 13 + _i


def _pick_rows(code, table):
    """Row ``code[p]`` of ``table`` for each pixel p (codes outside the
    table give zeros): an exact one-hot product, differentiable in
    ``table``.  The product is elementwise, not a matmul, so a float32
    matmul setting (TF32) cannot round the parameters."""
    onehot = code[:, None] == torch.arange(table.shape[0],
                                           device=code.device)
    return (onehot.to(table.dtype)[:, :, None] * table[None]).sum(1)


def _solid_table(scene: Scene) -> torch.Tensor:
    """[ns + npl, 23] f32, differentiable in every float leaf: sphere
    center and radius (0 for planes), plane normal and point (0 for
    spheres), material rgb and the fields of ``_MAT_FIELDS``."""
    ns, npl = scene.num_spheres, scene.num_planes
    dev = scene.device

    def mat(m):
        return torch.cat([m.rgb] + [getattr(m, f).to(F32)[:, None]
                                    for f in _MAT_FIELDS], 1)

    spheres = torch.cat([scene.sphere_origin, scene.sphere_radius[:, None],
                         torch.zeros(ns, 6, dtype=F32, device=dev),
                         mat(scene.sphere_mat)], 1)
    planes = torch.cat([torch.zeros(npl, 4, dtype=F32, device=dev),
                        scene.plane_normal, scene.plane_point,
                        mat(scene.plane_mat)], 1)
    return torch.cat([spheres, planes], 0)


def replay_render(scene: Scene, assets: SceneAssets,
                  basis: PerspectiveBasis, records: dict,
                  cfg: RenderConfig, row0: int = 0) -> torch.Tensor:
    """Dense differentiable replay of recorded megakernel paths.

    Returns float32 linear rgb [H, W, 3], equal to the record render of the
    same scene and basis (up to float rounding) wherever no node
    overflowed the record slots; gradients flow to every float leaf of
    ``scene`` and to the basis tensors that require them.  ``records`` are
    :func:`megakernel.render_megakernel_record`'s, made with the same
    ``cfg`` and ``row0``.

    Parent lookup: a child that goes on in place (the refracted child of a
    node that pushed, else the reflected one) always sits in slot s - 1; a
    popped child is always the reflected child of an earlier slot.  The
    popped case gathers, per pixel, from the reflected candidates of slots
    0..s-2 stacked into one [s-1, n_pix, 8] f32 tensor.  That stack lives
    only for its slot's gather (forward) and scatter (backward): at most
    (Krec - 1) * n_pix * 32 bytes, 722 MB at 800x600 depth 15 (Krec 48).
    """
    ns, npl, nl = scene.num_spheres, scene.num_planes, scene.num_lights
    if scene.num_triangles:
        raise NotImplementedError(
            f"the scene has {scene.num_triangles} triangles; triangle records "
            "are not ported yet (ROADMAP.md queue B, K3/K4)")
    if ns + npl > MAX_RECORD_SOLIDS or nl > MAX_RECORD_LIGHTS:
        raise ValueError(f"the replay's hit codes take at most "
                         f"{MAX_RECORD_SOLIDS} solids and "
                         f"{MAX_RECORD_LIGHTS} lights")
    width, height = cfg.width, cfg.height
    n_pix = width * height
    dev = scene.device
    eps = float(np.float32(cfg.epsilon))
    default_n = float(np.float32(cfg.default_n))
    inv_pi = pr.INV_PI

    rec, ssr, pick = records["rec"], records["ssr"], records["pick"]
    n_slots = min(int(records["max_nodes"]), rec.shape[0])
    o0, d0 = generate_rays(basis, width, height, row0)
    table = _solid_table(scene)
    lights = torch.cat([scene.light_intensity[:, None], scene.light_rgb], 1)
    # every texel a pick can name: the textures, then the sky
    texels = torch.cat([assets.textures.reshape(-1, 3),
                        assets.skybox.reshape(-1, 3)], 0)
    img = torch.zeros(n_pix, 3, dtype=F32, device=dev)
    # child candidates per slot: reflected (o3 d3 f n1) and refracted
    refl_bufs, refr_bufs = [], []

    for s in range(n_slots):
        r = rec[s].to(torch.int64)
        code = r & 0xFF
        pbyte = (r >> 8) & 0xFF
        written = r >= 0
        if s == 0:
            o, d = o0, d0
            f = written.to(F32)
            n1 = torch.full((n_pix,), default_n, dtype=F32, device=dev)
            valid = written
        else:
            has_par = (pbyte & PC_VALID) != 0
            refracted = (pbyte & PC_REFRACT) != 0
            pslot = (pbyte & 0x3F).clamp(0, s - 1)
            side = torch.where(refracted[:, None], refr_bufs[s - 1],
                               refl_bufs[s - 1])
            if s >= 2:
                earlier = torch.stack(refl_bufs[:s - 1], 0)
                idx = pslot.clamp(max=s - 2)[None, :, None].expand(1, n_pix, 8)
                popped = torch.gather(earlier, 0, idx)[0]
                side = torch.where((pslot == s - 1)[:, None], side, popped)
            o, d, f, n1 = side[:, 0:3], side[:, 3:6], side[:, 6], side[:, 7]
            valid = written & has_par
            f = torch.where(valid, f, torch.zeros_like(f))

        is_sphere = code < ns
        is_plane = (code >= ns) & (code < ns + npl)
        is_solid = (is_sphere | is_plane) & valid
        is_light = (code >= LIGHT_CODE) & (code < LIGHT_CODE + nl) & valid
        is_miss = (code == MISS_CODE) & valid
        zero = torch.zeros_like(f)

        # ---- light hit: rgb * I / pi, no falloff (primitives.cl:287) ----
        light = _pick_rows(code - LIGHT_CODE, lights)
        img = img + torch.where(is_light, f * light[:, 0] * inv_pi,
                                zero)[:, None] * light[:, 1:4]

        # ---- the recorded solid hit, recomputed differentiably ----
        row = _pick_rows(code.clamp(0, ns + npl - 1), table)
        center, radius = row[:, _COLS["center"]], row[:, _COLS["radius"]]
        p_nrm, p_pt = row[:, _COLS["normal"]], row[:, _COLS["point"]]
        t_sph = _sphere_t(o, d, center, radius, is_sphere)
        _, t_pl = pr.intersect_plane(o, d, p_nrm, p_pt)
        t = torch.where(is_sphere, t_sph, torch.where(is_plane, t_pl, zero))
        t = torch.where(is_solid, t, zero)
        hit = o + t[:, None] * d
        n_vec = torch.where(is_sphere[:, None], pr.normalize3(hit - center),
                            p_nrm)
        ph = hit + eps * n_vec
        ambient = row[:, _COLS["ambient"]]

        # ---- texels: the sky on a miss, the texture on a textured plane
        # (raytracing.cl:61-84); the colour is the recorded pick's ----
        textured = is_solid & is_plane & (row[:, _COLS["texture_id"]] > -0.5)
        fetched = (is_miss | textured) & (pick[s] >= 0)
        w_tex = torch.where(is_miss, f, f * ambient)
        w_tex = torch.where(fetched, w_tex, zero) / 255.0
        texel = texels[pick[s].clamp(min=0).to(torch.int64)].to(F32)
        img = img + w_tex[:, None] * texel

        # ---- untextured ambient (raytracing.cl:83-84) ----
        img = img + torch.where(is_solid & ~textured, f * ambient,
                                zero)[:, None] * row[:, _COLS["rgb"]]

        # ---- Phong against the recorded shadow ratios (:87-136) ----
        v_dir = pr.normalize3(o - ph)
        shininess = row[:, _COLS["shininess"]]
        specular = row[:, _COLS["specular"]]
        diffuse = row[:, _COLS["diffuse"]]
        for i in range(nl):
            to_light = scene.light_origin[i][None, :] - ph
            sd = pr.normalize3(to_light)
            # a light exactly on the offset hit point must not NaN the
            # backward (sqrt'(0))
            dd2 = pr.dot3(to_light, to_light)
            dd = torch.where(dd2 > 0, _sqrt_pos(dd2), torch.ones_like(dd2))
            fall = inv_pi * scene.light_intensity[i] / (dd * dd) * ssr[s, i]
            half = pr.normalize3(v_dir + sd)
            ndh = pr.dot3(n_vec, half).clamp(min=0.0)
            spec = torch.pow(ndh.clamp(min=1e-30), shininess) * specular * f
            ndl = pr.dot3(n_vec, sd).clamp(min=0.0)
            diff = ndl * diffuse * f
            w = torch.where(is_solid, spec + diff, zero) * fall
            img = img + w[:, None] * scene.light_rgb[i][None, :]

        # ---- child candidates (raytracing.cl:138-179) ----
        n2 = torch.where(n1 == default_n, row[:, _COLS["n"]],
                         torch.full_like(n1, default_n))
        n2 = torch.where(n2 != 0, n2, torch.ones_like(n2))  # dead lanes
        fr = _schlick(n1, n2, d, n_vec)
        refl = row[:, _COLS["reflectivity"]]
        ra = torch.where(row[:, _COLS["dielectric"]] > 0.5,
                         refl + (1.0 - refl) * fr, refl)
        f_refl = torch.where(is_solid, f * ra, zero)
        entering = n1 < n2
        co = torch.where(entering[:, None], ph - 2.0 * eps * n_vec, ph)
        rn = torch.where(entering[:, None], n_vec, -n_vec)
        refr_d, tir = _refract(n1, n2, d, rn)
        can_refr = (is_solid & (row[:, _COLS["transparent"]] > 0.5)
                    & (ra < 1.0) & ~tir)
        f_refr = torch.where(can_refr, f * (1.0 - ra), zero)
        refl_bufs.append(torch.cat([ph, pr.reflect(d, n_vec), f_refl[:, None],
                                    n1[:, None]], 1))
        refr_bufs.append(torch.cat([co, refr_d, f_refr[:, None],
                                    n2[:, None]], 1))

    return img.reshape(height, width, 3)
