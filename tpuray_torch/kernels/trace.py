"""The whole-image tracer: the reference's depth-first traversal as one masked
step over a batch of pixel lanes, differentiable by autograd.

Port of :mod:`tpuray.kernels.trace`.  The reference runs one work-item per
pixel through a recursive-descent loop over a ray stack
(raytracing.cl:14-195): reflection goes on in place, dielectric refraction
pushes the reflected ray and follows the refracted one.  Here every step
(:func:`_trace_step`) does one node visit or one pop of that DFS for every
lane still active, with ``torch.where`` masks in place of branches, so the
traversal order, and with it each pixel's xorshift32 soft-shadow samples, is
the reference's.  The top-of-stack ray lives in per-lane registers; the
stack holds only saved parent continuations, written on a push and read on
a pop, which adds the child's colour to the restored parent's
(raytracing.cl:188).

Two loop modes (``cfg.loop``): ``'while'`` steps until every lane is done or
``cfg.max_iters`` steps have run; ``'scan'`` runs
``cfg.resolved_scan_iters()`` steps, the finished lanes idle.  Autograd
differentiates both: the tracer is the port's gradient oracle and the
inverse renderer's ``tracer`` engine.

Triangle queries: the closest hit and the blocker tests go through the
wrappers of the triangle-query kernel (``query.py``), over tables built
once per call (``triblocks.build_query_tables``).  On CUDA rays they launch
``csrc/tri_query.cu`` (the JAX package's ``tri_query_mode('pallas')``); on
CPU rays they run its plain version, the brute force (its ``'xla'``).  A
query's t carries no gradient: where autograd is on, the winner's t is
recomputed with ``primitives.intersect_triangle`` on the winner's vertices,
gathered by id, which is the gradient the JAX scan's ``min`` gives.  Blocked
flags and crossing counts are piecewise constant.  A query sees only the
lanes whose answer the step uses.

Where the JAX tracer's formulas differ in rounding from the megakernel's
(``1 / sqrt`` for ``normalize3``, the xorshift32 sample converted from u32),
this module follows the tracer.  Left out: the one-hot ``_take`` (a GPU
gathers).

Scene parallelism (``trace_rays(..., tri_group=group)``, JAX's ``tri_axis``
and ``tri_shards``): every rank of the process group traces the same rays
and builds its query tables from its own contiguous slice of
``ceil(T / n)`` triangles; the scene stays whole, because materials,
normals and the autograd t are read by global id.  A closest query reduces
t by ``all_reduce(MIN)``, then the global ids of the ranks holding that t
by a second ``MIN``, so the lowest id wins a tie across slices as it does
in one; a blocker query reduces the blocked flag by ``MAX`` and the
transparent count by ``SUM``.  A rank with an empty slice still takes part
in every reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..scene import Materials, Scene
from ..textures import SceneAssets
from . import primitives as pr
from . import query
from .triblocks import TRI_THROUGH, TriTables, build_query_tables

F32 = torch.float32


class TriangleQueries:
    """The triangle answers of one trace through the query wrappers, over
    tables built once (``trace.py:154-184``); with ``group``, over this
    rank's slice of the triangles, reduced over the group
    (``trace.py:257-290``, ``:357-370``)."""

    def __init__(self, scene: Scene, group=None):
        self.count = scene.num_triangles
        self.group = group
        self.lo, hi = 0, self.count
        if group is not None:
            per = -(-self.count // dist.get_world_size(group))
            self.lo = min(dist.get_rank(group) * per, self.count)
            hi = min(self.lo + per, self.count)
        self.tables: Optional[TriTables] = None
        if hi > self.lo:
            self.tables = build_query_tables(
                *(x[self.lo:hi] for x in (scene.tri_v0, scene.tri_v1,
                                          scene.tri_v2,
                                          scene.tri_mat.transparent)))

    def closest(self, o, d):
        o, d = o.detach().contiguous(), d.detach().contiguous()
        if self.tables is not None:
            t, wid = query.tri_query_closest(self.tables, o, d)
        else:
            t = torch.full(o.shape[:1], float("inf"), device=o.device)
            wid = torch.full(o.shape[:1], -1, dtype=torch.int32,
                             device=o.device)
        if self.group is None:
            return t, wid
        t_g = t.clone()
        dist.all_reduce(t_g, op=dist.ReduceOp.MIN, group=self.group)
        hit = torch.isfinite(t_g)
        gid = torch.where((t == t_g) & hit, wid.to(torch.int64) + self.lo,
                          torch.full_like(wid, self.count, dtype=torch.int64))
        dist.all_reduce(gid, op=dist.ReduceOp.MIN, group=self.group)
        return t_g, torch.where(hit, gid, -1)

    def blocker(self, o, d, tmax, inclusive: bool):
        o, d = o.detach().contiguous(), d.detach().contiguous()
        tmax = tmax.detach().contiguous()
        if self.tables is not None:
            blocked, count = query.tri_query_blocker(self.tables, o, d, tmax,
                                                     inclusive)
        else:
            blocked = torch.zeros(o.shape[:1], dtype=torch.bool,
                                  device=o.device)
            count = torch.zeros(o.shape[:1], dtype=torch.int32,
                                device=o.device)
        if self.group is None:
            return blocked, count
        blocked = blocked.to(torch.int32)
        dist.all_reduce(blocked, op=dist.ReduceOp.MAX, group=self.group)
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=self.group)
        return blocked.bool(), count


@dataclasses.dataclass
class SceneTables:
    """What a trace reads from the scene besides its leaves, made once per
    call: the materials of spheres, planes and triangles in hit order, the
    triangles' face normals, the planes' texture bases and the triangle
    queries."""
    mats: Materials
    tri_normals: torch.Tensor
    plane_b0: torch.Tensor
    plane_b1: torch.Tensor
    tris: TriangleQueries


def scene_tables(scene: Scene, tri_group=None) -> SceneTables:
    """The :class:`SceneTables` of ``scene``; triangle queries over
    ``tri_group`` as :class:`TriangleQueries` makes them."""
    parts = (scene.sphere_mat, scene.plane_mat, scene.tri_mat)
    mats = Materials(**{f.name: torch.cat([getattr(p, f.name) for p in parts])
                        for f in dataclasses.fields(Materials)})
    b0, b1 = pr.plane_texture_basis(scene.plane_normal)
    return SceneTables(
        mats=mats,
        tri_normals=_normalize(pr.cross3(scene.tri_v1 - scene.tri_v0,
                                         scene.tri_v2 - scene.tri_v0)),
        plane_b0=b0, plane_b1=b1,
        tris=TriangleQueries(scene, tri_group))


def _normalize(v):
    """The tracer's normalize3: v * (1 / sqrt(|v|^2)), 0 for a zero vector,
    NaN-free in the backward."""
    n2 = pr.dot3(v, v)
    pos = n2 > 0
    inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, n2,
                                                        torch.ones_like(n2))),
                      torch.zeros_like(n2))
    return v * inv[..., None]


def _xorshift32(state):
    """One xorshift32 step; the sample is the u32 state converted to f32,
    ``/ 2^31 * 2`` (the reference's [0, 4) range), as the JAX tracer
    converts it."""
    x, _ = pr.xorshift32(state)
    return x, x.to(F32) / 2147483648.0 * 2.0


def _take(table, idx):
    """``table[idx]`` with the index clamped into the table; zeros from an
    empty table."""
    n = table.shape[0]
    if n == 0:
        return table.new_zeros((idx.shape[0],) + tuple(table.shape[1:]))
    return table[idx.clamp(0, n - 1)]


def _lanes(mask):
    return mask.nonzero().squeeze(1)


# ---------------------------------------------------------------------------
# closest-hit and occlusion queries (findSolidIntersection and friends)
# ---------------------------------------------------------------------------

def _sphere_ts(scene: Scene, o, d):
    """[P, S] sphere hits and t."""
    return pr.intersect_sphere(o[:, None, :], d[:, None, :],
                               scene.sphere_origin[None],
                               scene.sphere_radius[None])


def _plane_ts(scene: Scene, o, d):
    return pr.intersect_plane(o[:, None, :], d[:, None, :],
                              scene.plane_normal[None],
                              scene.plane_point[None])


def _tri_closest(scene: Scene, tris: TriangleQueries, o, d, active):
    """Closest triangle hit of the ``active`` lanes: (t [P], inf on a miss
    and off the active lanes; id [P], 0 there).  The lowest id wins a tie.
    Where autograd is on, t is the winner's Möller–Trumbore t recomputed
    from the scene's vertices, so that it carries their gradient."""
    p = o.shape[0]
    t = torch.full((p,), float("inf"), dtype=F32, device=o.device)
    idx = torch.zeros(p, dtype=torch.int64, device=o.device)
    lanes = _lanes(active)
    if lanes.numel():
        t_s, i_s = tris.closest(o[lanes], d[lanes])
        t = t.index_put((lanes,), t_s)
        idx = idx.index_put((lanes,), i_s.to(torch.int64))
    hit = torch.isfinite(t)
    idx = torch.where(hit, idx, torch.zeros_like(idx))
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (o, d, scene.tri_v0, scene.tri_v1,
                                      scene.tri_v2)):
        _, t_grad = pr.intersect_triangle(o, d, scene.tri_v0[idx],
                                          scene.tri_v1[idx],
                                          scene.tri_v2[idx])
        t = torch.where(hit, t_grad, t)
    return t, idx


def _tri_any_blocker(tris: TriangleQueries, o, d, tmax, inclusive: bool,
                     active):
    """(blocked [P], opacity [P]) of the ``active`` rays against the
    triangles within tmax (t <= tmax where ``inclusive``): an opaque
    triangle blocks, each transparent one keeps 0.8 (trace.py:342-386).
    Off the active lanes: not blocked, opacity 1; where blocked the
    opacity is not defined (the kernel stops at the first opaque hit)."""
    p = o.shape[0]
    blocked = torch.zeros(p, dtype=torch.bool, device=o.device)
    opacity = torch.ones(p, dtype=F32, device=o.device)
    lanes = _lanes(active & (tmax > 0))
    if not tris.count or not lanes.numel():
        return blocked, opacity
    b, count = tris.blocker(o[lanes], d[lanes], tmax[lanes], inclusive)
    through = torch.tensor(TRI_THROUGH, dtype=F32, device=o.device)
    return (blocked.index_put((lanes,), b),
            opacity.index_put((lanes,), torch.pow(through, count.to(F32))))


def find_light_hit(scene: Scene, o, d, tables: SceneTables, active):
    """findLightIntersection (primitives.cl:262-318) per lane: (visible [P],
    colour [P, 3]).  The nearest light hit is occluded by an opaque sphere,
    a plane or an opaque triangle at t' <= t_light.  The colour keeps the
    reference's ``(1/d*d)`` precedence quirk (primitives.cl:287): a visible
    light shines at rgb * I / pi whatever its distance.  ``active`` [P]
    marks the lanes whose answer is used."""
    p = o.shape[0]
    if scene.num_lights == 0:
        return (torch.zeros(p, dtype=torch.bool, device=o.device),
                torch.zeros(p, 3, dtype=F32, device=o.device))
    hit_l, t_l = pr.intersect_sphere(o[:, None, :], d[:, None, :],
                                     scene.light_origin[None],
                                     scene.light_radius[None])
    t, win = torch.where(hit_l, t_l, torch.full_like(t_l, float("inf"))).min(1)
    any_hit = torch.isfinite(t)
    t_safe = torch.where(any_hit, t, torch.ones_like(t))
    interpoint = o + d * t_safe[:, None]
    dd = pr.distance3(o, interpoint)
    dd = torch.where(dd > 0, dd, torch.ones_like(dd))
    color = scene.light_rgb[win] * (scene.light_intensity[win] * pr.INV_PI
                                    * (1.0 / dd * dd))[:, None]

    blocked = torch.zeros(p, dtype=torch.bool, device=o.device)
    if scene.num_spheres:
        hs, ts = _sphere_ts(scene, o, d)
        blocked |= (hs & (ts <= t[:, None])
                    & ~scene.sphere_mat.transparent[None, :]).any(1)
    if scene.num_planes:
        hp, tp = _plane_ts(scene, o, d)
        blocked |= (hp & (tp <= t[:, None])).any(1)
    tri_block, _ = _tri_any_blocker(tables.tris, o, d, t, True,
                                    active & any_hit & ~blocked)
    return any_hit & ~blocked & ~tri_block, color


def find_solid_hit(scene: Scene, assets: SceneAssets, o, d,
                   cfg: RenderConfig, tables: SceneTables, active):
    """findSolidIntersection (primitives.cl:322-394) per lane: (hit [P],
    epsilon-offset hit point [P, 3], normal [P, 3], per-lane
    :class:`Materials`).  Spheres, then planes, then triangles; the first
    in that order wins a tie.  A textured plane's ``rgb`` is its texel at
    the hit point before the offset (primitives.cl:374-377), nearest or
    bilinear by ``cfg.filter``; a textured triangle is flat-shaded.
    ``active`` [P] marks the lanes whose answer is used."""
    ns, npl = scene.num_spheres, scene.num_planes
    p = o.shape[0]
    dev = o.device
    inf = float("inf")
    cand = []
    if ns:
        hs, ts = _sphere_ts(scene, o, d)
        cand.append(torch.where(hs, ts, torch.full_like(ts, inf)))
    if npl:
        hp, tp = _plane_ts(scene, o, d)
        cand.append(torch.where(hp, tp, torch.full_like(tp, inf)))
    if cand:
        t, win = torch.cat(cand, 1).min(1)
    else:
        t = torch.full((p,), inf, dtype=F32, device=dev)
        win = torch.zeros(p, dtype=torch.int64, device=dev)
    if scene.num_triangles:
        t_tri, i_tri = _tri_closest(scene, tables.tris, o, d, active)
        tri_better = t_tri < t
        t = torch.where(tri_better, t_tri, t)
        win = torch.where(tri_better, ns + npl + i_tri, win)

    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    point = o + d * t_safe[:, None]

    is_sph = win < ns
    is_pl = (win >= ns) & (win < ns + npl)
    n_sph = _normalize(point - _take(scene.sphere_origin, win))
    pl_idx = (win - ns).clamp(0, max(npl - 1, 0))
    n_pl = _take(scene.plane_normal, pl_idx)
    normal = torch.where(is_sph[:, None], n_sph, n_pl)
    if scene.num_triangles:
        n_tri = tables.tri_normals[i_tri]
        # double-faced: the geometric normal faces the ray
        n_tri = torch.where((pr.dot3(n_tri, d) > 0)[:, None], -n_tri, n_tri)
        normal = torch.where(is_sph[:, None] | is_pl[:, None], normal, n_tri)

    mat = Materials(**{f.name: _take(getattr(tables.mats, f.name), win)
                       for f in dataclasses.fields(Materials)})

    # the plane texture at the hit point before the offset (primitives.cl:377)
    tex = assets.textures
    if npl and tex.numel():
        b0, b1 = _take(tables.plane_b0, pl_idx), _take(tables.plane_b1, pl_idx)
        tex_h, tex_w = tex.shape[1], tex.shape[2]
        tid = mat.texture_id.to(torch.int64).clamp(0, tex.shape[0] - 1)
        flat = tex.reshape(-1, 3)
        if cfg.filter == "bilinear":
            ui, vi = pr.texture_coords(b0, b1, point, mat.texture_scale)
            tex_rgb = torch.zeros_like(point)
            for xi, yi, wgt in pr.bilinear_taps(ui, vi, tex_w, tex_h,
                                                wrap=True):
                texel = flat[(tid * tex_h + yi) * tex_w + xi]
                tex_rgb = tex_rgb + wgt[:, None] * texel.to(F32)
            tex_rgb = tex_rgb / 255.0
        else:
            xi, yi = pr.texture_texel_coords(b0, b1, point,
                                             mat.texture_scale, tex_h, tex_w)
            tex_rgb = flat[(tid * tex_h + yi) * tex_w + xi].to(F32) / 255.0
        textured = is_pl & (mat.texture_id >= 0)
        mat = dataclasses.replace(
            mat, rgb=torch.where(textured[:, None], tex_rgb, mat.rgb))

    point = point + normal * float(np.float32(cfg.epsilon))
    return hit, point, normal, mat


def test_shadow(scene: Scene, sample, point, cfg: RenderConfig,
                tables: SceneTables, active):
    """testShadowPath (primitives.cl:396-442) per lane: the feeler from
    ``point`` toward ``sample`` on a light.  Each transparent sphere it
    crosses keeps ``cfg.transparent_through``, each transparent triangle
    0.8; an opaque sphere, any plane or an opaque triangle strictly before
    the sample blocks it (0).  ``active`` [P] marks the lanes whose answer
    is used."""
    sdir = _normalize(sample - point)
    tmax = pr.distance3(sample, point)
    p = point.shape[0]
    dev = point.device
    blocked = torch.zeros(p, dtype=torch.bool, device=dev)
    opacity = torch.ones(p, dtype=F32, device=dev)
    if scene.num_spheres:
        hs, ts = _sphere_ts(scene, point, sdir)
        rel = hs & (ts < tmax[:, None])
        transp = scene.sphere_mat.transparent[None, :]
        blocked |= (rel & ~transp).any(1)
        opacity = opacity * torch.where(
            rel & transp, torch.full_like(ts, float(np.float32(
                cfg.transparent_through))), torch.ones_like(ts)).prod(1)
    if scene.num_planes:
        hp, tp = _plane_ts(scene, point, sdir)
        blocked |= (hp & (tp < tmax[:, None])).any(1)
    tri_block, tri_opacity = _tri_any_blocker(tables.tris, point, sdir, tmax,
                                              False, active & ~blocked)
    blocked |= tri_block
    opacity = opacity * tri_opacity
    return torch.where(blocked, torch.zeros_like(opacity), opacity)


def sample_skybox(skybox, d, filter: str = "nearest"):
    """The sky on a miss (raytracing.cl:61-78): the cubemap texel of the
    ray direction, read v-flipped and clamped into the image, / 255.  With
    ``filter='bilinear'`` the 4 texels around the continuous coordinate,
    weighted (no reference analog; the sky then has a derivative in the
    direction)."""
    sky_h, sky_w = skybox.shape[0], skybox.shape[1]
    flat = skybox.reshape(-1, 3)
    if filter == "bilinear":
        xf, yf = pr.sky_coords(d, sky_h, sky_w)
        texel = torch.zeros(d.shape[:-1] + (3,), dtype=F32, device=d.device)
        for xi, yi, wgt in pr.bilinear_taps(xf, yf, sky_w, sky_h,
                                            wrap=False):
            texel = texel + wgt[..., None] * flat[yi * sky_w + xi].to(F32)
        return texel / 255.0
    y, x = pr.sky_texel(d, sky_h, sky_w)
    return flat[y * sky_w + x].to(F32) / 255.0


# ---------------------------------------------------------------------------
# the DFS state machine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceState:
    # the top-of-stack ray, one register per lane
    o: torch.Tensor        # [P, 3] origin
    d: torch.Tensor        # [P, 3] direction
    c: torch.Tensor        # [P, 3] colour gathered by this ray so far
    dep: torch.Tensor      # [P] i64 bounce depth
    f: torch.Tensor        # [P] throughput
    n1: torch.Tensor       # [P] refractive index of the current medium
    sp: torch.Tensor       # [P] i64 stack size
    rng: torch.Tensor      # [P] i64 xorshift32 state (u32), seeded by pixel id
    done: torch.Tensor     # [P] bool
    result: torch.Tensor   # [P, 3] the pixel's colour once done
    # saved parent continuations [D, P, ...], written on a push, read on a
    # pop: origin, direction, colour, depth, throughput, index
    s_o: torch.Tensor
    s_d: torch.Tensor
    s_c: torch.Tensor
    s_dep: torch.Tensor
    s_f: torch.Tensor
    s_n: torch.Tensor


def _stack_set(arr, lvl, val, mask):
    """``arr`` [D, P, ...] with ``val`` [P, ...] written at level ``lvl`` [P]
    where ``mask``."""
    at = (torch.arange(arr.shape[0], device=arr.device)[:, None]
          == lvl[None, :]) & mask[None, :]
    if arr.dim() == 3:
        at = at[..., None]
    return torch.where(at, val[None], arr)


def _stack_get(arr, lvl):
    """``arr`` [D, P, ...] read at level ``lvl`` [P] (clamped)."""
    lanes = torch.arange(arr.shape[1], device=arr.device)
    return arr[lvl.clamp(0, arr.shape[0] - 1), lanes]


def _init_state(o, d, pixel_ids, cfg: RenderConfig) -> TraceState:
    p = o.shape[0]
    dev = o.device
    depth = max(cfg.max_depth, 1)
    z3 = torch.zeros(p, 3, dtype=F32, device=dev)
    zi = torch.zeros(p, dtype=torch.int64, device=dev)
    return TraceState(
        o=o.to(F32), d=d.to(F32), c=z3, dep=zi,
        f=torch.ones(p, dtype=F32, device=dev),
        n1=torch.full((p,), float(np.float32(cfg.default_n)), dtype=F32,
                      device=dev),
        sp=zi + 1, rng=pixel_ids.to(torch.int64) & 0xFFFFFFFF,
        done=torch.zeros(p, dtype=torch.bool, device=dev), result=z3,
        s_o=torch.zeros(depth, p, 3, dtype=F32, device=dev),
        s_d=torch.zeros(depth, p, 3, dtype=F32, device=dev),
        s_c=torch.zeros(depth, p, 3, dtype=F32, device=dev),
        s_dep=torch.zeros(depth, p, dtype=torch.int64, device=dev),
        s_f=torch.zeros(depth, p, dtype=F32, device=dev),
        s_n=torch.zeros(depth, p, dtype=F32, device=dev))


def _trace_step(scene: Scene, assets: SceneAssets, cfg: RenderConfig,
                st: TraceState, tables: SceneTables) -> TraceState:
    """One DFS node visit or pop per active lane: the body of the
    reference's nested loops (raytracing.cl:41-191) as one masked step."""
    eps = float(np.float32(cfg.epsilon))
    default_n = float(np.float32(cfg.default_n))
    active = ~st.done
    overdepth = st.dep >= cfg.max_depth          # the inner loop's test, :42
    do_work = active & ~overdepth

    light_hit, light_color = find_light_hit(scene, st.o, st.d, tables,
                                            do_work)
    solid_hit, point, normal, mat = find_solid_hit(
        scene, assets, st.o, st.d, cfg, tables, do_work & ~light_hit)
    is_light = do_work & light_hit               # raytracing.cl:48-54
    is_miss = do_work & ~light_hit & ~solid_hit  # :61-81
    is_solid = do_work & ~light_hit & solid_hit
    sky = sample_skybox(assets.skybox, st.d, cfg.filter)

    # --- the colour, in the reference's order of additions ---
    f3 = st.f[:, None]
    zero3 = torch.zeros_like(st.c)
    c2 = st.c + torch.where(is_light[:, None], f3 * light_color, zero3)
    c2 = c2 + torch.where(is_miss[:, None], f3 * sky, zero3)
    c2 = c2 + torch.where(is_solid[:, None],
                          f3 * mat.rgb * mat.ambient[:, None], zero3)

    # --- direct light with stochastic soft shadows (:87-136) ---
    rng = st.rng
    samples = cfg.shadow_samples
    v_dir = _normalize(st.o - point)
    for i in range(scene.num_lights):
        lo = scene.light_origin[i]
        lrad = scene.light_radius[i]
        shadow_dir = _normalize(lo[None, :] - point)
        soft = torch.zeros_like(st.f)
        for _ in range(samples):
            rng, r1 = _xorshift32(rng)
            theta = pr.TWO_PI * r1
            rng, r2 = _xorshift32(rng)
            phi = pr.PI * r2
            sin_phi = torch.sin(phi)
            offset = torch.stack([lrad * sin_phi * torch.cos(theta),
                                  lrad * sin_phi * torch.sin(theta),
                                  lrad * torch.cos(phi)], -1)
            soft = soft + test_shadow(scene, lo[None, :] + offset, point,
                                      cfg, tables, is_solid)
        # no samples: unshadowed direct light
        ssr = soft / float(samples) if samples else soft + 1.0
        dd = pr.distance3(lo[None, :], point)
        dd = torch.where(dd > 0, dd, torch.ones_like(dd))
        # ((rgb * I) * (1/pi)) * 1/(d*d), then * ssr (raytracing.cl:118-120)
        lr = ((scene.light_rgb[i][None, :] * scene.light_intensity[i]
               * pr.INV_PI) * (1.0 / (dd * dd))[:, None]) * ssr[:, None]
        half = _normalize(v_dir + shadow_dir)
        zero = torch.zeros_like(st.f)
        spec_f = torch.pow(torch.maximum(zero, pr.dot3(normal, half)),
                           mat.shininess)
        c2 = c2 + torch.where(is_solid[:, None],
                              (st.f * mat.specular)[:, None] * lr
                              * spec_f[:, None], zero3)
        diff_f = torch.maximum(zero, pr.dot3(normal, shadow_dir))
        c2 = c2 + torch.where(is_solid[:, None],
                              (st.f * mat.diffuse)[:, None] * lr
                              * diff_f[:, None], zero3)
    rng = torch.where(is_solid, rng, st.rng)     # advances on solid hits only

    # --- reflect / refract continuation (:138-179) ---
    n2 = torch.where(st.n1 == default_n, mat.n, torch.full_like(mat.n,
                                                                default_n))
    fr = pr.schlick(st.n1, n2, st.d, normal)
    refl = mat.reflectivity
    reflect_amount = torch.where(mat.dielectric, refl + (1.0 - refl) * fr,
                                 refl)
    f_cont = st.f * reflect_amount
    refl_dir = pr.reflect(st.d, normal)
    dep1 = st.dep + 1
    push_try = (is_solid & mat.transparent & (st.sp < cfg.max_depth)
                & (reflect_amount < 1.0))
    entering = (st.n1 < n2)[:, None]
    child_o = torch.where(entering, point - (2.0 * eps) * normal, point)
    refr_dir, tir = pr.refract(st.n1, n2, st.d,
                               torch.where(entering, normal, -normal))
    push = push_try & ~tir
    pop = active & (overdepth | is_light | is_miss)
    finish = pop & (st.sp == 1)
    popm = pop & (st.sp > 1)
    cont = is_solid & ~push       # reflection goes on in place (TIR too)

    # --- a push saves the parent's reflected continuation ---
    lvl = st.sp - 1
    s_o = _stack_set(st.s_o, lvl, point, push)
    s_d = _stack_set(st.s_d, lvl, refl_dir, push)
    s_c = _stack_set(st.s_c, lvl, c2, push)
    s_dep = _stack_set(st.s_dep, lvl, dep1, push)
    s_f = _stack_set(st.s_f, lvl, f_cont, push)
    s_n = _stack_set(st.s_n, lvl, st.n1, push)

    # --- a pop restores the parent and adds the child's colour (:188) ---
    lvl = st.sp - 2
    r_o, r_d, r_c = (_stack_get(s, lvl) for s in (s_o, s_d, s_c))
    r_dep, r_f, r_n = (_stack_get(s, lvl) for s in (s_dep, s_f, s_n))

    def pick(mask, a, b):
        return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)

    return TraceState(
        o=pick(push, child_o, pick(popm, r_o, pick(cont, point, st.o))),
        d=pick(push, refr_dir, pick(popm, r_d, pick(cont, refl_dir, st.d))),
        c=pick(push, zero3, pick(popm, r_c + c2, pick(cont | finish, c2,
                                                       st.c))),
        dep=torch.where(push | cont, dep1, torch.where(popm, r_dep, st.dep)),
        f=torch.where(push, st.f * (1.0 - reflect_amount),
                      torch.where(popm, r_f, torch.where(cont, f_cont,
                                                         st.f))),
        n1=torch.where(push, n2, torch.where(popm, r_n, st.n1)),
        sp=st.sp + push.to(torch.int64) - popm.to(torch.int64),
        rng=rng, done=st.done | finish,
        result=pick(finish, c2, st.result),
        s_o=s_o, s_d=s_d, s_c=s_c, s_dep=s_dep, s_f=s_f, s_n=s_n)


def trace_rays(scene: Scene, assets: SceneAssets, o, d, pixel_ids,
               cfg: RenderConfig, tri_group=None) -> torch.Tensor:
    """Trace the rays (o [P, 3], d [P, 3]) of the pixels ``pixel_ids`` [P]
    (which seed their xorshift32 states) to the end: linear rgb [P, 3],
    unclamped, as the reference accumulates it before its final clamp
    (raytracing.cl:193).  A lane still running after ``cfg.max_iters``
    steps (loop 'while') or the scan's steps reports what it gathered.

    With ``tri_group`` (a process group) the triangles are sharded over its
    ranks, which must all trace the same rays (scene parallelism, see the
    module docstring)."""
    tables = scene_tables(scene, tri_group)
    st = _init_state(o, d, pixel_ids, cfg)
    if cfg.loop == "while":
        it = 0
        while it < cfg.max_iters and bool((~st.done).any()):
            st = _trace_step(scene, assets, cfg, st, tables)
            it += 1
    else:
        for _ in range(cfg.resolved_scan_iters()):
            st = _trace_step(scene, assets, cfg, st, tables)
    return torch.where(st.done[:, None], st.result, st.c)
