"""The Whitted megakernel: one CUDA kernel renders the whole image.

Port of ``tpuray/kernels/pallas_trace.py``: the megakernel ``_make_kernel``'s
``kernel`` (:659) without triangles and with nearest filtering, in its base
configuration and in record mode, ``pack_uniforms`` (:151),
``_pallas_forward`` (:2314), ``render_pallas`` (:2452) and
``render_pallas_record`` (:2665).

Per pixel it runs the reference's whole traversal (raytracing.cl:14-195):
primary-ray generation (raygen.cl:5-25), the depth-first reflect/refract
stack machine, Phong lighting with xorshift32 soft shadows, and the texel
fetches of the skybox and the plane textures.  The TPU kernel could not
gather in VMEM, so it wrote texel "events" that an XLA gather resolved
after the kernel; here the texels are read where they are needed, so there
are no event buffers, no overflow counters and nothing to retry.

The functions:

* :func:`pack_scene` flattens scene + camera basis into one f32 buffer with
  static offsets (:class:`SceneLayout`), the layout ``csrc/megakernel.cu``
  reads;
* :func:`render_megakernel_reference` is the plain PyTorch version: the same
  per-pixel DFS as whole-image masked tensor code;
* :func:`render_megakernel` is the wrapper: CPU tensors go to the plain
  version, CUDA tensors launch the CUDA kernel (or raise);
* :func:`render_megakernel_record` and its plain version
  :func:`render_megakernel_record_reference` render the same image and
  also write one record per DFS node, which the gradient's replay
  (``replay.py``) reads.

Records (``pallas_trace.py:2102-2148``; the layout is the port's own):

* ``rec`` [Krec, n_pix] i32: ``code | parent_byte << 8`` for node slot s of
  each pixel, in DFS order, -1 where the pixel has no node s.  ``code`` is
  the solid hit (spheres first, then planes), ``LIGHT_CODE + l`` for light
  l, or ``MISS_CODE``.  The parent byte is the parent's 6-bit slot, plus
  ``PC_REFRACT`` for the refracted child, plus ``PC_VALID``; the root has
  0.  A node past slot Krec - 1 is not written and its children get parent
  byte 0, so the replay drops the subtree.
* ``ssr`` [Krec, nl, n_pix] f32: each solid node's soft-shadow ratio per
  light (1.0 without shadow samples), 0 elsewhere.
* ``pick`` [Krec, n_pix] i32: the texel the node fetched (a textured plane
  or the sky), -1 for none.  Textures come first in the index space
  (``(tid * tex_h + y) * tex_w + x``), then the sky (``n_tex * tex_h *
  tex_w + y * sky_w + x``), as in the JAX package's texel atlas.
* ``max_nodes`` [] i32: the image-wide maximum of the true node count, also
  where it exceeds Krec.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..camera import PerspectiveBasis
from ..config import RenderConfig
from ..scene import Materials, Scene
from ..textures import SceneAssets
from . import primitives as pr

# The kernel's per-thread ray stack has this many levels (csrc/megakernel.cu
# MAX_DEPTH_CAP); the reference's depth is 15.
MAX_DEPTH_CAP = 16

# record codes, mirrored by csrc/megakernel.cu
LIGHT_CODE = 64
MISS_CODE = 127
PC_VALID = 0x80
PC_REFRACT = 0x40
MAX_RECORD_SOLIDS = LIGHT_CODE     # solid codes must stay below LIGHT_CODE
MAX_RECORD_LIGHTS = 62             # LIGHT_CODE + l below 126

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


def _material_rows(m: Materials) -> torch.Tensor:
    cols = [m.rgb, m.ambient[:, None], m.diffuse[:, None],
            m.specular[:, None], m.shininess[:, None],
            m.transparent[:, None], m.dielectric[:, None], m.n[:, None],
            m.reflectivity[:, None], m.texture_id[:, None],
            m.texture_scale[:, None]]
    return torch.cat([c.to(torch.float32) for c in cols], dim=1)


def pack_scene(scene: Scene, basis: PerspectiveBasis,
               row0: int = 0) -> PackedScene:
    """Scene + camera basis -> one f32 buffer on the scene's device.

    ``row0`` is the image row of the first rendered row: a slab of rows
    keeps the ray directions and RNG seeds (the pixel ids) that the full
    image gives them."""
    if scene.num_triangles:
        raise NotImplementedError(
            f"the scene has {scene.num_triangles} triangles; triangle meshes "
            "are not ported yet (ROADMAP.md queue B, K3/K4)")
    dev = scene.device
    f32 = torch.float32
    b = basis.to(dev)
    parts = [b.corner, b.origin, b.up, b.right,
             torch.stack([b.w_factor, b.h_factor]).to(f32),
             torch.tensor([float(row0)], dtype=f32, device=dev)]
    parts.append(torch.cat([scene.sphere_origin, scene.sphere_radius[:, None],
                            _material_rows(scene.sphere_mat)], 1).reshape(-1))
    parts.append(torch.cat([scene.plane_normal, scene.plane_point,
                            _material_rows(scene.plane_mat)], 1).reshape(-1))
    parts.append(torch.cat([scene.light_origin, scene.light_radius[:, None],
                            scene.light_intensity[:, None], scene.light_rgb],
                           1).reshape(-1))
    buf = torch.cat([p.to(f32).reshape(-1) for p in parts]).contiguous()
    tid = scene.plane_mat.texture_id
    max_tid = int(tid.max()) if tid.numel() else -1
    lay = SceneLayout(scene.num_spheres, scene.num_planes, scene.num_lights)
    return PackedScene(buf=buf, layout=lay, max_texture_id=max_tid)


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
                                cfg: RenderConfig) -> torch.Tensor:
    """Plain PyTorch version of the megakernel: [H, W, 3] f32 linear rgb.

    Each pixel runs the kernel's DFS; here every lane quantity is an [N]
    tensor (vectors [N, 3]), each step works on the lanes not yet done, and
    the ray stack is [D, N, 11] + [D, N] indexed per lane.  A step is
    exactly one of: pop (over depth, a light hit or a miss; the last pop
    finishes the pixel), push (a transparent hit stacks the reflected ray
    and follows the refracted one) or continue along the reflected ray.
    """
    return _trace_reference(packed, assets, cfg, None)[0]


def render_megakernel_record_reference(packed: PackedScene,
                                       assets: SceneAssets,
                                       cfg: RenderConfig):
    """Plain PyTorch version of the record-mode megakernel: (image
    [H, W, 3] f32, records) with the records of the module docstring."""
    _check_record(packed, cfg)
    return _trace_reference(packed, assets, cfg,
                            cfg.resolved_record_slots())


def _trace_reference(packed: PackedScene, assets: SceneAssets,
                     cfg: RenderConfig, krec):
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
        pick = torch.full((krec, n_pix), -1, dtype=i32, device=dev)
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
        sy, sx = pr.sky_texel(Dd, sky_h, sky_w)
        sky_rgb = sky[sy, sx].to(f32)
        cx2 = torch.where(is_miss[:, None],
                          cx2 + (F / 255.0)[:, None] * sky_rgb, cx2)

        # --- solid hit: textured plane -> texel * f * ambient, otherwise
        #     rgb * f * ambient (raytracing.cl:83-84, primitives.cl:217-259)
        is_plane = bwin >= ns
        textured = is_solid & is_plane & (mat[:, M_TEXTURE_ID] > -0.5)
        tex_idx = torch.full_like(DEP, -1)
        if npl:
            pidx = (bwin - ns).clamp(0, npl - 1)
            tx, ty = pr.texture_texel_coords(
                p_b0[pidx], p_b1[pidx], hpt, mat[:, M_TEXTURE_SCALE],
                tex_h, tex_w)
            tid = torch.where(textured, mat[:, M_TEXTURE_ID].to(torch.int64),
                              torch.zeros_like(tx)).clamp(0, n_tex - 1)
            tex_rgb = tex[tid, ty, tx].to(f32)
            tex_idx = (tid * tex_h + ty) * tex_w + tx
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
                                       pln, lgt, n_samples, through, record)
            cx2 = torch.where(is_solid[:, None], cx2 + acc, cx2)
            RNG = torch.where(is_solid, rng_sh, RNG)

        # --- node records (pallas_trace.py:2102-2148) ---
        if record:
            PC, slot = pcode[act], nodes[act]
            fits = slot < krec
            can = work & fits
            code = torch.where(is_light, LIGHT_CODE + lwin,
                               torch.where(is_miss, MISS_CODE, bwin))
            pk = torch.where(is_miss, sky_base + sy * sky_w + sx,
                             torch.where(textured, tex_idx,
                                         torch.full_like(tex_idx, -1)))
            lanes, s_can = act[can], slot[can]
            rec[s_can, lanes] = (code | (PC << 8))[can].to(i32)
            pick[s_can, lanes] = pk[can].to(i32)
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
    return img, {"rec": rec, "ssr": ssr_out, "pick": pick,
                 "max_nodes": max_nodes}


def _shade(O, ph, nrm, mat, F, rng, sph, s_transp, pln, lgt, n_samples,
           through, record=False):
    """Soft-shadow Phong of every light at the offset hit points ``ph``
    (raytracing.cl:87-136, pallas_trace.py:1963-2100).  Returns the added
    colour [n, 3], the advanced RNG state and each light's shadow ratio
    [n].

    Draw order: lights outer, samples inner, theta then phi.  A light that
    can add nothing at this point (backface gate, pallas_trace.py:2014)
    still draws its samples, which count as blocked.  In record mode the
    gate is geometric only (pallas_trace.py:1998-2012): a light dead only
    because diffuse or specular is 0 keeps its real ratio, which the
    gradient with respect to diffuse and specular needs."""
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
    if not (buf.device == tex.device == sky.device):
        raise ValueError(f"scene on {buf.device}, textures on {tex.device}, "
                         f"skybox on {sky.device}: all must share a device")
    if buf.dtype != torch.float32 or buf.dim() != 1 \
            or buf.numel() != packed.layout.size or not buf.is_contiguous():
        raise ValueError("packed scene must be a contiguous f32 vector of "
                         f"{packed.layout.size} values (use pack_scene)")
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


def render_megakernel(packed: PackedScene, assets: SceneAssets,
                      cfg: RenderConfig) -> torch.Tensor:
    """Render ``cfg.height`` rows of ``cfg.width`` pixels: [H, W, 3] f32.

    Tensors on the CPU go to :func:`render_megakernel_reference`.  Tensors
    on a CUDA device launch the CUDA kernel on the current stream; a build
    or launch error raises and nothing falls back.  ``launches`` counts the
    kernel launches."""
    _check_inputs(packed, assets, cfg)
    dev = packed.buf.device
    if dev.type == "cpu":
        return render_megakernel_reference(packed, assets, cfg)
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
            tex.data_ptr(), tex.shape[1], tex.shape[2],
            sky.data_ptr(), sky.shape[0], sky.shape[1],
            cfg.width, cfg.height, cfg.max_depth, cfg.shadow_samples,
            float(np.float32(cfg.epsilon)),
            float(np.float32(cfg.transparent_through)),
            float(np.float32(cfg.default_n)),
            out.data_ptr(), stream)
    if err:
        raise _kernel_error(lib, err, "megakernel")
    render_megakernel.launches += 1
    return out


render_megakernel.launches = 0


def render_megakernel_record(packed: PackedScene, assets: SceneAssets,
                             cfg: RenderConfig):
    """Record-mode render: (image [H, W, 3] f32, records), the records of
    the module docstring, on the scene's device.

    Tensors on the CPU go to :func:`render_megakernel_record_reference`.
    Tensors on a CUDA device launch the record instantiation of the CUDA
    kernel on the current stream (or raise); ``launches`` counts them.
    ``max_nodes`` stays on the device: reading it synchronises."""
    _check_inputs(packed, assets, cfg)
    krec = _check_record(packed, cfg)
    dev = packed.buf.device
    if dev.type == "cpu":
        return render_megakernel_record_reference(packed, assets, cfg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .build import load_library

    lib = load_library().lib
    lay, tex, sky = packed.layout, assets.textures, assets.skybox
    n_pix = cfg.height * cfg.width
    out = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=dev)
    rec = torch.empty((krec, n_pix), dtype=torch.int32, device=dev)
    ssr = torch.empty((krec, lay.n_lights, n_pix), dtype=torch.float32,
                      device=dev)
    pick = torch.empty((krec, n_pix), dtype=torch.int32, device=dev)
    max_nodes = torch.empty((), dtype=torch.int32, device=dev)
    records = {"rec": rec, "ssr": ssr, "pick": pick, "max_nodes": max_nodes}
    if n_pix == 0:
        max_nodes.zero_()
        return out, records
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpuray_megakernel_record(
            packed.buf.data_ptr(), lay.n_spheres, lay.n_planes, lay.n_lights,
            tex.data_ptr(), tex.shape[0], tex.shape[1], tex.shape[2],
            sky.data_ptr(), sky.shape[0], sky.shape[1],
            cfg.width, cfg.height, cfg.max_depth, cfg.shadow_samples,
            float(np.float32(cfg.epsilon)),
            float(np.float32(cfg.transparent_through)),
            float(np.float32(cfg.default_n)), krec,
            out.data_ptr(), rec.data_ptr(), ssr.data_ptr(), pick.data_ptr(),
            max_nodes.data_ptr(), stream)
    if err:
        raise _kernel_error(lib, err, "record megakernel")
    render_megakernel_record.launches += 1
    return out, records


render_megakernel_record.launches = 0
