"""The Whitted megakernel: one CUDA kernel renders the whole image.

Port of ``tpuray/kernels/pallas_trace.py``: the megakernel ``_make_kernel``'s
``kernel`` (:659) in its base configuration (K1), with bilinear filtering
(K2, :1882-1943), with triangles (K3 and K4 as one path) and in record mode
(K5), ``pack_uniforms`` (:151), ``_pallas_forward`` (:2314),
``render_pallas`` (:2452) and ``render_pallas_record`` (:2665).

Per pixel it runs the reference's whole traversal (raytracing.cl:14-195):
primary-ray generation (raygen.cl:5-25), the depth-first reflect/refract
stack machine, Phong lighting with xorshift32 soft shadows, and the texel
fetches of the skybox and the plane textures.  The TPU kernel could not
gather in VMEM, so it wrote texel "events" that an XLA gather resolved
after the kernel; here the texels are read where they are needed, so there
are no event buffers, no overflow counters and nothing to retry.  With
``cfg.filter='bilinear'`` each fetch weights the 4 texels around the
continuous coordinate (``primitives.bilinear_taps``; sky taps clamp, texture
taps wrap): the colour is ``sum_t w_t * texel_t``, times ``f / 255`` for the
sky and ``f * ambient / 255`` for a textured plane.

Triangles (the JAX package's extension; the tables are ``triblocks.py``'s)
follow the XLA tracer (``trace.py``): Möller–Trumbore, double-faced;
analytic solids win ties against triangles and the lowest triangle id
wins ties among triangles; the winner's face normal is flipped against the
ray; a textured triangle is flat-shaded, since texels are fetched for
plane hits only (``pallas_trace.py:1832-1837``, ROADMAP C6); opaque
triangles at t <= t_light occlude a light; a shadow feeler is blocked by
an opaque triangle at t < tmax and keeps 0.8 per transparent one.  The
JAX kernel's feeler guard that ignores occluders whose plane lies within
0.05 of the feeler's origin (``_TRI_FEELER_PLANE_DIST``) hides bf16 noise
the port does not have, and is not carried over (ROADMAP C).

The functions:

* :func:`pack_scene` flattens scene + camera basis into one f32 buffer with
  static offsets (:class:`SceneLayout`), the layout ``csrc/megakernel.cu``
  reads, and builds the triangle tables; :func:`swap_basis` gives a packed
  scene another camera without packing it again (the viewer's frames);
* :func:`render_megakernel_reference` is the plain PyTorch version: the same
  per-pixel DFS as whole-image masked tensor code, with the triangle search
  by brute force;
* :func:`render_megakernel` is the wrapper: CPU tensors go to the plain
  version, CUDA tensors launch the CUDA kernel (or raise);
* :func:`render_megakernel_record` and its plain version
  :func:`render_megakernel_record_reference` render the same image and
  also write one record per DFS node, which the gradient's replay
  (``replay.py``) reads.

Records (``pallas_trace.py:2102-2148``; the layout is the port's own):

* ``rec`` [Krec, n_pix] i32: ``code | parent_byte << 8`` for node slot s of
  each pixel, in DFS order, -1 where the pixel has no node s.  ``code`` is
  the solid hit (spheres first, then planes), ``TRI_CODE`` (126) for a
  triangle, ``LIGHT_CODE + l`` for light l, or ``MISS_CODE``.  The parent
  byte is the parent's 6-bit slot, plus ``PC_REFRACT`` for the refracted
  child, plus ``PC_VALID``; the root has 0.  A node past slot Krec - 1 is
  not written and its children get parent byte 0, so the replay drops the
  subtree.
* ``wid`` [Krec, n_pix] i32: the winning triangle's id (in the scene's
  Morton order) where the node hit a triangle, -1 elsewhere.  One plane for
  every triangle count (the JAX kernel packs 15 bits into ``rec`` below
  32,768 triangles and writes a wide plane above).
* ``ssr`` [Krec, nl, n_pix] f32: each solid node's soft-shadow ratio per
  light (1.0 without shadow samples), 0 elsewhere.
* ``pick`` [Krec, n_pix] i32: the texel the node fetched (a textured plane
  or the sky), -1 for none.  Textures come first in the index space
  (``(tid * tex_h + y) * tex_w + x``), then the sky (``n_tex * tex_h *
  tex_w + y * sky_w + x``), as in the JAX package's texel atlas.  With
  bilinear filtering ``pick`` is [Krec, 4, n_pix]: the 4 taps of the fetch,
  in ``bilinear_taps`` order (the JAX kernel's 4 events per fetch).
* ``max_nodes`` [] i32: the image-wide maximum of the true node count, also
  where it exceeds Krec.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..camera import PerspectiveBasis
from ..config import RenderConfig
from ..scene import Scene
from ..textures import SceneAssets
from ..utils.debug import check_kernel_output
from . import primitives as pr
from .triblocks import (ATTR_STRIDE, TRI_CODE, TRI_MAX_LEVELS, TRI_THROUGH,
                        BruteForce, TriTables, build_tri_tables,
                        material_rows)

# The kernel's per-thread ray stack has this many levels (csrc/megakernel.cu
# MAX_DEPTH_CAP); the reference's depth is 15.  engine='auto' renders deeper
# configurations with the tracer (render.resolve_engine).
MAX_DEPTH_CAP = 16

# record codes, mirrored by csrc/megakernel.cu
LIGHT_CODE = 64
MISS_CODE = 127
PC_VALID = 0x80
PC_REFRACT = 0x40
MAX_RECORD_SOLIDS = LIGHT_CODE     # solid codes must stay below LIGHT_CODE
MAX_RECORD_LIGHTS = 62             # LIGHT_CODE + l below TRI_CODE

# Packed layout, mirrored by the #defines in csrc/megakernel.cu:
#   [0:15)  basis: corner3, origin3, up3, right3, w_factor, h_factor, row0
#   spheres: 17 floats each: origin3, radius, material13
#   planes:  19 floats each: normal3, point3, material13
#   lights:   8 floats each: origin3, radius, intensity, rgb3
# material13: rgb3, ambient, diffuse, specular, shininess, transparent,
#             dielectric, n, reflectivity, texture_id, texture_scale
BASIS_SIZE = 15
MAT_SIZE = 13
SPHERE_STRIDE = 4 + MAT_SIZE
PLANE_STRIDE = 6 + MAT_SIZE
LIGHT_STRIDE = 8
(M_AMBIENT, M_DIFFUSE, M_SPECULAR, M_SHININESS, M_TRANSPARENT, M_DIELECTRIC,
 M_N, M_REFLECTIVITY, M_TEXTURE_ID, M_TEXTURE_SCALE) = range(3, MAT_SIZE)


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """Static offsets into the packed scene buffer."""
    n_spheres: int
    n_planes: int
    n_lights: int

    @property
    def sphere_base(self) -> int:
        return BASIS_SIZE

    @property
    def plane_base(self) -> int:
        return self.sphere_base + SPHERE_STRIDE * self.n_spheres

    @property
    def light_base(self) -> int:
        return self.plane_base + PLANE_STRIDE * self.n_planes

    @property
    def size(self) -> int:
        return self.light_base + LIGHT_STRIDE * self.n_lights


@dataclasses.dataclass
class PackedScene:
    buf: torch.Tensor      # [layout.size] f32 on the render device
    layout: SceneLayout
    max_texture_id: int    # largest plane texture id (-1: no textures)
    tris: Optional[TriTables] = None   # None: no triangles


def pack_scene(scene: Scene, basis: PerspectiveBasis,
               row0: int = 0) -> PackedScene:
    """Scene + camera basis -> one f32 buffer on the scene's device.

    ``row0`` is the image row of the first rendered row: a slab of rows
    keeps the ray directions and RNG seeds (the pixel ids) that the full
    image gives them.  Raises ``ValueError`` above
    ``triblocks.TRI_MAX_TRIANGLES`` triangles, before building anything."""
    tris = build_tri_tables(scene)
    dev = scene.device
    f32 = torch.float32
    parts = [_basis_head(basis, row0, dev)]
    parts.append(torch.cat([scene.sphere_origin, scene.sphere_radius[:, None],
                            material_rows(scene.sphere_mat)], 1).reshape(-1))
    parts.append(torch.cat([scene.plane_normal, scene.plane_point,
                            material_rows(scene.plane_mat)], 1).reshape(-1))
    parts.append(torch.cat([scene.light_origin, scene.light_radius[:, None],
                            scene.light_intensity[:, None], scene.light_rgb],
                           1).reshape(-1))
    buf = torch.cat([p.to(f32).reshape(-1) for p in parts]).contiguous()
    tid = scene.plane_mat.texture_id
    max_tid = int(tid.max()) if tid.numel() else -1
    lay = SceneLayout(scene.num_spheres, scene.num_planes, scene.num_lights)
    return PackedScene(buf=buf, layout=lay, max_texture_id=max_tid,
                       tris=tris)


def _basis_head(basis: PerspectiveBasis, row0: int, device) -> torch.Tensor:
    """The buffer's first ``BASIS_SIZE`` floats on ``device``."""
    f32 = torch.float32
    b = basis.to(device)
    return torch.cat([p.to(f32).reshape(-1) for p in (
        b.corner, b.origin, b.up, b.right, torch.stack([b.w_factor,
                                                        b.h_factor]),
        torch.tensor([float(row0)], dtype=f32, device=device))])


def swap_basis(packed: PackedScene, basis: PerspectiveBasis,
               row0: int = 0) -> PackedScene:
    """``packed`` seen from another camera: a new buffer whose basis head
    (``pack_scene``'s first ``BASIS_SIZE`` floats) holds ``basis`` and
    ``row0``, with the geometry copied on the device and the triangle
    tables shared, not rebuilt.  Equal, bit for bit, to a fresh
    ``pack_scene(scene, basis, row0)``.  A basis on the CPU costs one small
    host-to-device copy."""
    dev = packed.buf.device
    head = _basis_head(basis, row0, basis.corner.device).to(dev)
    return dataclasses.replace(
        packed, buf=torch.cat([head, packed.buf[BASIS_SIZE:]]))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _unpack(packed: PackedScene):
    buf, lay = packed.buf, packed.layout
    sph = buf[lay.sphere_base:lay.plane_base].view(lay.n_spheres,
                                                   SPHERE_STRIDE)
    pln = buf[lay.plane_base:lay.light_base].view(lay.n_planes, PLANE_STRIDE)
    lgt = buf[lay.light_base:lay.size].view(lay.n_lights, LIGHT_STRIDE)
    return sph, pln, lgt


def render_megakernel_reference(packed: PackedScene, assets: SceneAssets,
                                cfg: RenderConfig,
                                tri_search=None) -> torch.Tensor:
    """Plain PyTorch version of the megakernel: [H, W, 3] f32 linear rgb.

    Each pixel runs the kernel's DFS; here every lane quantity is an [N]
    tensor (vectors [N, 3]), each step works on the lanes not yet done, and
    the ray stack is [D, N, 11] + [D, N] indexed per lane.  A step is
    exactly one of: pop (over depth, a light hit or a miss; the last pop
    finishes the pixel), push (a transparent hit stacks the reflected ray
    and follows the refracted one) or continue along the reflected ray.

    ``tri_search`` answers the triangle queries of a step (the interface
    of :class:`triblocks.BruteForce`, the default, which takes each ray's
    pixel, ``pixels``, and ignores it); a measurement may pass one that
    also counts the work the kernel's walk does.
    """
    return _trace_reference(packed, assets, cfg, None, tri_search)[0]


def render_megakernel_record_reference(packed: PackedScene,
                                       assets: SceneAssets,
                                       cfg: RenderConfig):
    """Plain PyTorch version of the record-mode megakernel: (image
    [H, W, 3] f32, records) with the records of the module docstring."""
    _check_record(packed, cfg)
    return _trace_reference(packed, assets, cfg,
                            cfg.resolved_record_slots())


def _trace_reference(packed: PackedScene, assets: SceneAssets,
                     cfg: RenderConfig, krec, tri_search=None):
    """The whole-image DFS behind both plain versions; ``krec`` None
    renders without records."""
    dev = packed.buf.device
    f32 = torch.float32
    H, W, D = cfg.height, cfg.width, cfg.max_depth
    eps = float(np.float32(cfg.epsilon))
    through = float(np.float32(cfg.transparent_through))
    default_n = float(np.float32(cfg.default_n))
    n_samples = cfg.shadow_samples
    sph, pln, lgt = _unpack(packed)
    ns, npl, nl = sph.shape[0], pln.shape[0], lgt.shape[0]
    tex, sky = assets.textures, assets.skybox
    n_tex, tex_h, tex_w = tex.shape[0], tex.shape[1], tex.shape[2]
    sky_h, sky_w = sky.shape[0], sky.shape[1]
    s_mat = sph[:, 4:]
    p_mat = pln[:, 6:]
    s_transp = s_mat[:, M_TRANSPARENT] > 0.5
    p_b0, p_b1 = pr.plane_texture_basis(pln[:, 0:3])
    tris = packed.tris
    if tris is not None and tri_search is None:
        tri_search = BruteForce(tris)
    bilinear = cfg.filter == "bilinear"
    n_picks = 4 if bilinear else 1
    sky_flat, tex_flat = sky.reshape(-1, 3), tex.reshape(-1, 3)

    # ---- raygen (raygen.cl:10-24, pallas_trace.py:700-719) ----
    B = packed.buf[:BASIS_SIZE]
    row0 = int(B[14])
    row_g = torch.arange(H, device=dev) + row0
    col = torch.arange(W, device=dev)
    pid = (row_g[:, None] * W + col[None, :]).reshape(-1)
    w_scale = (B[12] * col.to(f32))[None, :]
    h_scale = (B[13] * row_g.to(f32))[:, None]
    v = torch.stack([B[k] + B[9 + k] * w_scale - B[6 + k] * h_scale
                     for k in range(3)], -1).reshape(-1, 3)
    n_pix = H * W
    d = pr.normalize3(v)
    o = B[3:6].expand(n_pix, 3).clone()
    c = torch.zeros(n_pix, 3, dtype=f32, device=dev)
    f = torch.ones(n_pix, dtype=f32, device=dev)
    n1 = torch.full((n_pix,), default_n, dtype=f32, device=dev)
    dep = torch.zeros(n_pix, dtype=torch.int64, device=dev)
    sp = torch.ones(n_pix, dtype=torch.int64, device=dev)
    rng = pid & 0xFFFFFFFF
    done = torch.zeros(n_pix, dtype=torch.bool, device=dev)
    # stack planes: origin3, dir3, colour3, f, n1
    stk = torch.zeros(D, n_pix, 11, dtype=f32, device=dev)
    stk_dep = torch.zeros(D, n_pix, dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    record = krec is not None
    if record:
        i32 = torch.int32
        rec = torch.full((krec, n_pix), -1, dtype=i32, device=dev)
        wid_out = torch.full((krec, n_pix), -1, dtype=i32, device=dev)
        pick = torch.full((krec, n_picks, n_pix), -1, dtype=i32, device=dev)
        ssr_out = torch.zeros(krec, nl, n_pix, dtype=f32, device=dev)
        nodes = torch.zeros(n_pix, dtype=torch.int64, device=dev)
        pcode = torch.zeros(n_pix, dtype=torch.int64, device=dev)
        stk_pc = torch.zeros(D, n_pix, dtype=torch.int64, device=dev)
        sky_base = n_tex * tex_h * tex_w

    while True:
        act = (~done).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        O, Dd, C, F, N1 = o[act], d[act], c[act], f[act], n1[act]
        DEP, SP, RNG = dep[act], sp[act], rng[act]
        overdepth = DEP >= D
        work = ~overdepth

        # --- findLightIntersection (primitives.cl:262-318) ---
        lt = inf.expand(act.shape[0]).clone()
        lwin = torch.zeros_like(DEP)
        for i in range(nl):
            h, t = pr.intersect_sphere(O, Dd, lgt[i, 0:3], lgt[i, 3])
            tm = torch.where(h, t, inf)
            better = tm < lt
            lt = torch.where(better, tm, lt)
            lwin = torch.where(better, i, lwin)
        light_any = torch.isfinite(lt)
        # --- findSolidIntersection (primitives.cl:322-394); occluders of
        #     the light are solid hits at t <= t_light, glass excepted ---
        bt = inf.expand(act.shape[0]).clone()
        bwin = torch.full_like(DEP, -1)
        lblock = torch.zeros_like(work)
        for i in range(ns):
            h, t = pr.intersect_sphere(O, Dd, sph[i, 0:3], sph[i, 3])
            lblock |= h & (t <= lt) & ~s_transp[i]
            tm = torch.where(h, t, inf)
            better = tm < bt
            bt = torch.where(better, tm, bt)
            bwin = torch.where(better, i, bwin)
        for i in range(npl):
            h, t = pr.intersect_plane(O, Dd, pln[i, 0:3], pln[i, 3:6])
            lblock |= h & (t <= lt)
            tm = torch.where(h, t, inf)
            better = tm < bt
            bt = torch.where(better, tm, bt)
            bwin = torch.where(better, ns + i, bwin)
        # --- triangles (trace.py:462-466): the analytic solids win ties ---
        wid = torch.full_like(DEP, -1)
        if tris is not None:
            t_tri = torch.full_like(bt, float("inf"))
            w_tri = torch.full_like(wid, -1)
            wk = work.nonzero().squeeze(1)
            if wk.numel():
                t_tri[wk], w_tri[wk], lb_tri = tri_search.closest(
                    O[wk], Dd[wk], lt[wk], bt[wk], pixels=act[wk])
                lblock[wk] |= lb_tri
            tri_better = t_tri < bt
            bt = torch.where(tri_better, t_tri, bt)
            bwin = torch.where(tri_better, TRI_CODE, bwin)
            wid = torch.where(tri_better, w_tri, wid)
        light_hit = light_any & ~lblock
        solid_hit = torch.isfinite(bt)
        t_safe = torch.where(solid_hit, bt, torch.zeros_like(bt))
        hpt = O + Dd * t_safe[:, None]

        # normal + material of the closest solid
        nrm = torch.zeros_like(O)
        mat = torch.zeros(act.shape[0], MAT_SIZE, dtype=f32, device=dev)
        for i in range(ns):
            sel = (bwin == i)[:, None]
            nrm = torch.where(sel, pr.normalize3(hpt - sph[i, 0:3]), nrm)
            mat = torch.where(sel, s_mat[i], mat)
        for i in range(npl):
            sel = (bwin == ns + i)[:, None]
            nrm = torch.where(sel, pln[i, 0:3], nrm)
            mat = torch.where(sel, p_mat[i], mat)
        if tris is not None:
            # the winner's face normal, flipped against the ray
            # (trace.py:479-484), and its material
            sel = (bwin == TRI_CODE)[:, None]
            row = tris.attr[wid.clamp(min=0)]
            tn = row[:, 0:3]
            tn = torch.where((pr.dot3(tn, Dd) > 0)[:, None], -tn, tn)
            nrm = torch.where(sel, tn, nrm)
            mat = torch.where(sel, row[:, 3:ATTR_STRIDE], mat)

        is_light = work & light_hit
        is_miss = work & ~light_hit & ~solid_hit
        is_solid = work & ~light_hit & solid_hit
        ambient = mat[:, M_AMBIENT]

        # --- light hit: rgb * I / pi with no distance term (the
        #     (1/d*d)==1 quirk, primitives.cl:287) ---
        lrow = lgt[lwin]
        lcol = lrow[:, 5:8] * (lrow[:, 4] * pr.INV_PI)[:, None]
        cx2 = torch.where(is_light[:, None], C + F[:, None] * lcol, C)

        # --- miss: skybox texel with weight f (raytracing.cl:61-81) ---
        if bilinear:
            xf, yf = pr.sky_coords(Dd, sky_h, sky_w)
            sky_rgb, sky_idx = _fetch(sky_flat, pr.bilinear_taps(
                xf, yf, sky_w, sky_h, wrap=False), 0, sky_w)
        else:
            sy, sx = pr.sky_texel(Dd, sky_h, sky_w)
            sky_idx = (sy * sky_w + sx)[:, None]
            sky_rgb = sky_flat[sky_idx[:, 0]].to(f32)
        cx2 = torch.where(is_miss[:, None],
                          cx2 + (F / 255.0)[:, None] * sky_rgb, cx2)

        # --- solid hit: textured plane -> texel * f * ambient, otherwise
        #     rgb * f * ambient (raytracing.cl:83-84, primitives.cl:217-259);
        #     a textured triangle is flat (pallas_trace.py:1832-1837) ---
        is_plane = (bwin >= ns) & (bwin < ns + npl)
        textured = is_solid & is_plane & (mat[:, M_TEXTURE_ID] > -0.5)
        tex_idx = torch.full((act.shape[0], n_picks), -1, dtype=torch.int64,
                             device=dev)
        if npl:
            pidx = (bwin - ns).clamp(0, npl - 1)
            tid = torch.where(textured, mat[:, M_TEXTURE_ID].to(torch.int64),
                              torch.zeros_like(DEP)).clamp(0, n_tex - 1)
            b0, b1, scale = p_b0[pidx], p_b1[pidx], mat[:, M_TEXTURE_SCALE]
            if bilinear:
                ui, vi = pr.texture_coords(b0, b1, hpt, scale)
                tex_rgb, tex_idx = _fetch(tex_flat, pr.bilinear_taps(
                    ui, vi, tex_w, tex_h, wrap=True), tid * tex_h, tex_w)
            else:
                tx, ty = pr.texture_texel_coords(b0, b1, hpt, scale, tex_h,
                                                 tex_w)
                tex_idx = ((tid * tex_h + ty) * tex_w + tx)[:, None]
                tex_rgb = tex_flat[tex_idx[:, 0]].to(f32)
            cx2 = torch.where(textured[:, None],
                              cx2 + ((F * ambient) / 255.0)[:, None] * tex_rgb,
                              cx2)
        flat = is_solid & ~textured
        cx2 = torch.where(flat[:, None],
                          cx2 + (F * ambient)[:, None] * mat[:, 0:3], cx2)

        ph = hpt + nrm * eps      # eps-offset hit point (primitives.cl:350)

        # --- per-light soft-shadow Phong (raytracing.cl:87-136) ---
        ssrs = None
        if bool(is_solid.any()):
            acc, rng_sh, ssrs = _shade(O, ph, nrm, mat, F, RNG, sph, s_transp,
                                       pln, lgt, n_samples, through, record,
                                       tri_search, act)
            cx2 = torch.where(is_solid[:, None], cx2 + acc, cx2)
            RNG = torch.where(is_solid, rng_sh, RNG)

        # --- node records (pallas_trace.py:2102-2148) ---
        if record:
            PC, slot = pcode[act], nodes[act]
            fits = slot < krec
            can = work & fits
            code = torch.where(is_light, LIGHT_CODE + lwin,
                               torch.where(is_miss, MISS_CODE, bwin))
            pk = torch.where(is_miss[:, None], sky_base + sky_idx,
                             torch.where(textured[:, None], tex_idx,
                                         torch.full_like(tex_idx, -1)))
            lanes, s_can = act[can], slot[can]
            rec[s_can, lanes] = (code | (PC << 8))[can].to(i32)
            wid_out[s_can, lanes] = torch.where(is_solid, wid,
                                                -1)[can].to(i32)
            pick[s_can, :, lanes] = pk[can].to(i32)
            if ssrs is not None:
                shaded = can & is_solid
                ssr_out[slot[shaded], :, act[shaded]] = torch.stack(
                    ssrs, 1)[shaded]
            pc_refl = torch.where(fits, PC_VALID | slot, 0)
            pc_refr = torch.where(fits, PC_VALID | PC_REFRACT | slot, 0)
            nodes[act] = slot + work.to(torch.int64)

        # --- reflect / refract continuation (raytracing.cl:138-179) ---
        mat_n = mat[:, M_N]
        n2 = torch.where(N1 == default_n, mat_n,
                         torch.full_like(mat_n, default_n))
        fr = pr.schlick(N1, n2, Dd, nrm)
        refl = mat[:, M_REFLECTIVITY]
        ra = torch.where(mat[:, M_DIELECTRIC] > 0.5,
                         refl + (1.0 - refl) * fr, refl)
        f_cont = F * ra
        rd = pr.reflect(Dd, nrm)
        dep1 = DEP + 1
        entering = N1 < n2
        co = torch.where(entering[:, None], ph - (2.0 * eps) * nrm, ph)
        rn = torch.where(entering[:, None], nrm, -nrm)
        td, tir = pr.refract(N1, n2, Dd, rn)
        push = (is_solid & (mat[:, M_TRANSPARENT] > 0.5) & (SP < D)
                & (ra < 1.0) & ~tir)
        pop = overdepth | is_light | is_miss
        finish = pop & (SP == 1)
        popm = pop & (SP > 1)
        cont = is_solid & ~push

        # push: the reflected ray waits on the stack, the refracted one goes
        if bool(push.any()):
            lanes, lvl = act[push], SP[push] - 1
            stk[lvl, lanes] = torch.cat(
                [ph[push], rd[push], cx2[push], f_cont[push, None],
                 N1[push, None]], 1)
            stk_dep[lvl, lanes] = dep1[push]
            if record:      # the stacked ray is the reflected child
                stk_pc[lvl, lanes] = pc_refl[push]
        new_o = torch.where(push[:, None], co,
                            torch.where(cont[:, None], ph, O))
        new_d = torch.where(push[:, None], td,
                            torch.where(cont[:, None], rd, Dd))
        new_c = torch.where(push[:, None], torch.zeros_like(cx2), cx2)
        new_dep = torch.where(push | cont, dep1, DEP)
        new_f = torch.where(push, F * (1.0 - ra),
                            torch.where(cont, f_cont, F))
        new_n1 = torch.where(push, n2, N1)
        # pop: resume the stacked ray, adding the colour gathered so far
        if bool(popm.any()):
            lanes, lvl = act[popm], SP[popm] - 2
            r = stk[lvl, lanes]
            new_o[popm] = r[:, 0:3]
            new_d[popm] = r[:, 3:6]
            new_c[popm] = r[:, 6:9] + cx2[popm]
            new_f[popm] = r[:, 9]
            new_n1[popm] = r[:, 10]
            new_dep[popm] = stk_dep[lvl, lanes]
        if record:
            new_pc = torch.where(push, pc_refr, torch.where(cont, pc_refl, PC))
            if bool(popm.any()):
                new_pc[popm] = stk_pc[SP[popm] - 2, act[popm]]
            pcode[act] = new_pc
        o[act], d[act], c[act], f[act], n1[act] = new_o, new_d, new_c, \
            new_f, new_n1
        dep[act] = new_dep
        sp[act] = SP + push.to(torch.int64) - popm.to(torch.int64)
        rng[act] = RNG
        done[act] = finish
    img = c.reshape(H, W, 3)
    if not record:
        return img, None
    max_nodes = (nodes.max() if n_pix else nodes.new_zeros(())).to(i32)
    if not bilinear:
        pick = pick.reshape(krec, n_pix)
    return img, {"rec": rec, "wid": wid_out, "ssr": ssr_out, "pick": pick,
                 "max_nodes": max_nodes}


def _fetch(flat, taps, row0, width):
    """Bilinear fetch from the u8 rgb rows ``flat``: (sum of weight * texel
    in tap order [n, 3] f32, the taps' rows ``(row0 + y) * width + x`` [n,
    4])."""
    acc = None
    idx = []
    for x, y, w in taps:
        idx.append((row0 + y) * width + x)
        term = w[:, None] * flat[idx[-1]].to(torch.float32)
        acc = term if acc is None else acc + term
    return acc, torch.stack(idx, 1)


def _shade(O, ph, nrm, mat, F, rng, sph, s_transp, pln, lgt, n_samples,
           through, record=False, tri_search=None, pixels=None):
    """Soft-shadow Phong of every light at the offset hit points ``ph``
    (raytracing.cl:87-136, pallas_trace.py:1963-2100).  Returns the added
    colour [n, 3], the advanced RNG state and each light's shadow ratio
    [n].

    Draw order: lights outer, samples inner, theta then phi.  A light that
    can add nothing at this point (backface gate, pallas_trace.py:2014)
    still draws its samples, which count as blocked.  In record mode the
    gate is geometric only (pallas_trace.py:1998-2012): a light dead only
    because diffuse or specular is 0 keeps its real ratio, which the
    gradient with respect to diffuse and specular needs.  ``pixels``: the
    pixel of each lane, for ``tri_search``."""
    diffuse, specular = mat[:, M_DIFFUSE], mat[:, M_SPECULAR]
    shininess = mat[:, M_SHININESS]
    vdir = pr.normalize3(O - ph)
    acc = torch.zeros_like(ph)
    ssrs = []
    for i in range(lgt.shape[0]):
        lo, lrad, inten = lgt[i, 0:3], lgt[i, 3], lgt[i, 4]
        cd = lo - ph
        sd = pr.normalize3(cd)
        hv = pr.normalize3(vdir + sd)
        geo_diff_dead = pr.dot3(nrm, sd) <= 0.0
        geo_spec_dead = (pr.dot3(nrm, hv) <= 0.0) & (shininess > 0.0)
        if record:
            dead = geo_diff_dead & geo_spec_dead
        else:
            dead = ((geo_diff_dead | (diffuse <= 0.0))
                    & ((specular <= 0.0) | geo_spec_dead))
        soft = torch.zeros_like(F)
        for _ in range(n_samples):
            rng, r1 = pr.xorshift32(rng)
            theta = pr.TWO_PI * r1
            rng, r2 = pr.xorshift32(rng)
            phi = pr.PI * r2
            sphi = torch.sin(phi)
            spt = torch.stack([lo[0] + lrad * sphi * torch.cos(theta),
                               lo[1] + lrad * sphi * torch.sin(theta),
                               lo[2] + lrad * torch.cos(phi)], -1)
            q = pr.normalize3(spt - ph)
            dd = spt - ph
            tmax = torch.sqrt(pr.dot3(dd, dd))
            blocked = dead.clone()
            opac = torch.ones_like(F)
            # testShadowPath (primitives.cl:396-442): glass lets 0.8 through
            for j in range(sph.shape[0]):
                h, t = pr.intersect_sphere(ph, q, sph[j, 0:3], sph[j, 3])
                rel = h & (t < tmax)
                blocked |= rel & ~s_transp[j]
                opac = opac * torch.where(rel & s_transp[j], through, 1.0)
            for j in range(pln.shape[0]):
                h, t = pr.intersect_plane(ph, q, pln[j, 0:3], pln[j, 3:6])
                blocked |= h & (t < tmax)
            if tri_search is not None:
                # the kernel sweeps the triangles of a sample not yet
                # blocked (trace.py:342-386)
                go = (~blocked).nonzero().squeeze(1)
                if go.numel():
                    tb, cnt = tri_search.blocked(ph[go], q[go], tmax[go],
                                                 pixels=pixels[go])
                    blocked[go] = tb
                    opac[go] = opac[go] * torch.pow(
                        torch.tensor(TRI_THROUGH, dtype=opac.dtype,
                                     device=opac.device), cnt.to(opac.dtype))
            soft = soft + torch.where(blocked, torch.zeros_like(opac), opac)
        ssr = soft / float(n_samples) if n_samples else soft + 1.0
        ssrs.append(ssr)
        dist = torch.sqrt(pr.dot3(cd, cd))
        dist = torch.where(dist > 0, dist, torch.ones_like(dist))
        fall = inten * pr.INV_PI / (dist * dist) * ssr
        ndh = pr.dot3(nrm, hv).clamp(min=0.0)
        spec = torch.pow(ndh.clamp(min=1e-30), shininess) * specular * F
        ndl = pr.dot3(nrm, sd).clamp(min=0.0)
        diff = ndl * diffuse * F
        acc = acc + ((spec + diff) * fall)[:, None] * lgt[i, 5:8]
    return acc, rng, ssrs


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _check_inputs(packed: PackedScene, assets: SceneAssets,
                  cfg: RenderConfig) -> None:
    buf, tex, sky = packed.buf, assets.textures, assets.skybox
    if not 0 <= cfg.max_depth <= MAX_DEPTH_CAP:
        raise ValueError(f"max_depth={cfg.max_depth}: the megakernel's ray "
                         f"stack holds at most {MAX_DEPTH_CAP} levels")
    if cfg.shadow_samples < 0:
        raise ValueError(f"shadow_samples={cfg.shadow_samples} < 0")
    if cfg.width * cfg.height >= 2 ** 31:
        raise ValueError(f"{cfg.width}x{cfg.height} pixels: the megakernel "
                         "indexes pixels with 32-bit integers")
    if not (buf.device == tex.device == sky.device):
        raise ValueError(f"scene on {buf.device}, textures on {tex.device}, "
                         f"skybox on {sky.device}: all must share a device")
    if buf.dtype != torch.float32 or buf.dim() != 1 \
            or buf.numel() != packed.layout.size or not buf.is_contiguous():
        raise ValueError("packed scene must be a contiguous f32 vector of "
                         f"{packed.layout.size} values (use pack_scene)")
    tris = packed.tris
    if tris is not None and any(
            t.device != buf.device or t.dtype != torch.float32
            or not t.is_contiguous()
            for t in (tris.geom, tris.attr, tris.node)):
        raise ValueError("triangle tables must be contiguous f32 on the "
                         "scene's device (use pack_scene)")
    if tris is not None and len(tris.level_n) > TRI_MAX_LEVELS:
        raise ValueError(f"the triangle tree has {len(tris.level_n)} levels; "
                         f"the kernel takes at most {TRI_MAX_LEVELS}")
    if tex.dtype != torch.uint8 or tex.dim() != 4 or tex.shape[3] != 3 \
            or tex.shape[0] < 1 or not tex.is_contiguous():
        raise ValueError(f"textures must be contiguous u8 [N>=1, H, W, 3], "
                         f"got {tex.dtype} {tuple(tex.shape)}")
    if sky.dtype != torch.uint8 or sky.dim() != 3 or sky.shape[2] != 3 \
            or sky.shape[1] < 4 or not sky.is_contiguous():
        raise ValueError(f"skybox must be contiguous u8 [Hs, Ws>=4, 3], got "
                         f"{sky.dtype} {tuple(sky.shape)}")
    if packed.max_texture_id >= tex.shape[0]:
        raise ValueError(f"a plane uses texture {packed.max_texture_id} but "
                         f"only {tex.shape[0]} textures are loaded")


def _check_record(packed: PackedScene, cfg: RenderConfig) -> int:
    """Record slots for ``cfg``; raises where a record code cannot hold
    the scene (replay.py:144-146)."""
    lay = packed.layout
    if lay.n_spheres + lay.n_planes > MAX_RECORD_SOLIDS \
            or lay.n_lights > MAX_RECORD_LIGHTS:
        raise ValueError(
            f"record mode takes at most {MAX_RECORD_SOLIDS} solids and "
            f"{MAX_RECORD_LIGHTS} lights; the scene has "
            f"{lay.n_spheres + lay.n_planes} solids and {lay.n_lights} lights")
    return cfg.resolved_record_slots()


def _kernel_error(lib, err, what):
    msg = ctypes.string_at(lib.tpuray_error_string(err)).decode()
    return RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _tri_args(tris: Optional[TriTables]) -> tuple:
    """The kernel's triangle arguments: geom, attr, node pointers, count,
    levels, the host array of nodes per level, block and fanout."""
    if tris is None:
        return (None, None, None, 0, 0, None, 1, 1)
    level_n = (ctypes.c_int * len(tris.level_n))(*tris.level_n)
    return (tris.geom.data_ptr(), tris.attr.data_ptr(), tris.node.data_ptr(),
            tris.n, len(tris.level_n), level_n, tris.block, tris.fanout)


def render_megakernel(packed: PackedScene, assets: SceneAssets,
                      cfg: RenderConfig) -> torch.Tensor:
    """Render ``cfg.height`` rows of ``cfg.width`` pixels: [H, W, 3] f32.

    Tensors on the CPU go to :func:`render_megakernel_reference`.  Tensors
    on a CUDA device launch the CUDA kernel on the current stream; a build
    or launch error raises and nothing falls back.  ``launches`` counts the
    kernel launches, ``bilinear_launches`` those with
    ``cfg.filter='bilinear'`` (K2).  Under ``utils.debug.nan_guard`` the
    image is checked for NaN (a CUDA kernel is out of the guard's sight)."""
    _check_inputs(packed, assets, cfg)
    dev = packed.buf.device
    if dev.type == "cpu":
        out = render_megakernel_reference(packed, assets, cfg)
        check_kernel_output("megakernel", out)
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .build import load_library

    lib = load_library().lib
    out = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lay, tex, sky = packed.layout, assets.textures, assets.skybox
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpuray_megakernel(
            packed.buf.data_ptr(), lay.n_spheres, lay.n_planes, lay.n_lights,
            *_tri_args(packed.tris),
            tex.data_ptr(), tex.shape[1], tex.shape[2],
            sky.data_ptr(), sky.shape[0], sky.shape[1],
            cfg.width, cfg.height, cfg.max_depth, cfg.shadow_samples,
            float(np.float32(cfg.epsilon)),
            float(np.float32(cfg.transparent_through)),
            float(np.float32(cfg.default_n)), int(cfg.filter == "bilinear"),
            out.data_ptr(), stream)
    if err:
        raise _kernel_error(lib, err, "megakernel")
    render_megakernel.launches += 1
    render_megakernel.bilinear_launches += cfg.filter == "bilinear"
    check_kernel_output("megakernel", out)
    return out


render_megakernel.launches = 0
render_megakernel.bilinear_launches = 0


def render_megakernel_checked(scene: Scene, assets: SceneAssets,
                              basis: PerspectiveBasis, cfg: RenderConfig,
                              row0: int = 0):
    """``render_pallas_checked`` (pallas_trace.py:2711): (image, dropped,
    needed).  The JAX kernel reported the texel events it could not store
    and the event slots that would have held them; this kernel fetches
    texels itself, so both are 0."""
    return render_megakernel(pack_scene(scene, basis, row0), assets, cfg), 0, 0


def render_megakernel_stats(scene: Scene, assets: SceneAssets,
                            basis: PerspectiveBasis,
                            cfg: RenderConfig) -> dict:
    """``render_pallas_stats`` (pallas_trace.py:2734): the JAX kernel's
    event-buffer use.  This kernel has no event buffer: no slot is used
    and nothing drops."""
    return {"dropped_events": 0, "max_slots_used": 0}


def render_megakernel_record(packed: PackedScene, assets: SceneAssets,
                             cfg: RenderConfig):
    """Record-mode render: (image [H, W, 3] f32, records), the records of
    the module docstring, on the scene's device.

    Tensors on the CPU go to :func:`render_megakernel_record_reference`.
    Tensors on a CUDA device launch the record instantiation of the CUDA
    kernel on the current stream (or raise); ``launches`` counts them,
    ``bilinear_launches`` those with ``cfg.filter='bilinear'``.  The
    outputs are allocated uninitialised: the kernel writes every element,
    unused slots included.  Without triangles it shades a warp's solid hits
    together, as the base kernel does (``warp_shade`` in
    ``csrc/megakernel.cu``), each hit's owner writing its shadow ratios.
    ``max_nodes`` stays on the device: reading it synchronises.  Under
    ``utils.debug.nan_guard`` the image and ``ssr`` are checked for NaN."""
    _check_inputs(packed, assets, cfg)
    krec = _check_record(packed, cfg)
    dev = packed.buf.device
    if dev.type == "cpu":
        out, records = render_megakernel_record_reference(packed, assets, cfg)
        check_kernel_output("record megakernel", out, records["ssr"])
        return out, records
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .build import load_library

    lib = load_library().lib
    lay, tex, sky = packed.layout, assets.textures, assets.skybox
    n_pix = cfg.height * cfg.width
    out = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=dev)
    rec = torch.empty((krec, n_pix), dtype=torch.int32, device=dev)
    wid = torch.empty((krec, n_pix), dtype=torch.int32, device=dev)
    ssr = torch.empty((krec, lay.n_lights, n_pix), dtype=torch.float32,
                      device=dev)
    bilinear = cfg.filter == "bilinear"
    pick = torch.empty((krec, 4, n_pix) if bilinear else (krec, n_pix),
                       dtype=torch.int32, device=dev)
    max_nodes = torch.empty((), dtype=torch.int32, device=dev)
    records = {"rec": rec, "wid": wid, "ssr": ssr, "pick": pick,
               "max_nodes": max_nodes}
    if n_pix == 0:
        max_nodes.zero_()
        return out, records
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpuray_megakernel_record(
            packed.buf.data_ptr(), lay.n_spheres, lay.n_planes, lay.n_lights,
            *_tri_args(packed.tris),
            tex.data_ptr(), tex.shape[0], tex.shape[1], tex.shape[2],
            sky.data_ptr(), sky.shape[0], sky.shape[1],
            cfg.width, cfg.height, cfg.max_depth, cfg.shadow_samples,
            float(np.float32(cfg.epsilon)),
            float(np.float32(cfg.transparent_through)),
            float(np.float32(cfg.default_n)), int(bilinear), krec,
            out.data_ptr(), rec.data_ptr(), wid.data_ptr(), ssr.data_ptr(),
            pick.data_ptr(), max_nodes.data_ptr(), stream)
    if err:
        raise _kernel_error(lib, err, "record megakernel")
    render_megakernel_record.launches += 1
    render_megakernel_record.bilinear_launches += bilinear
    check_kernel_output("record megakernel", out, ssr)
    return out, records


render_megakernel_record.launches = 0
render_megakernel_record.bilinear_launches = 0
