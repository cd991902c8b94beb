"""Triangle tables of the megakernel's triangle sweep, and its plain version.

Port of ``build_tri_blocks`` (``tpuray/kernels/pallas_trace.py:367``) for the
megakernel's triangle configurations K3 (tables in VMEM, up to 32,768
triangles) and K4 (blocks streamed from HBM, up to 524,288).  On the H100
both are one path: the tables live in device memory, cached in L2, and the
kernel reads what it needs.  The TPU's bilinear-form rows, bf16 splits and
DMA blocks are not carried over; the tables hold what Möller–Trumbore and
the culls read, in f32.

:func:`build_tri_tables` works on the Morton-sorted triangles that
``build_scene`` gives and builds:

* ``geom`` [T, 12]: v0, the transparent flag, e1 = v1 - v0, 0, e2 = v2 - v0,
  0 (three float4 rows a thread reads per test);
* ``attr`` [T, 16]: the unit face normal and the 13 material fields, read
  for the winner only;
* ``node`` [n_nodes, 8]: an AABB tree, lo, 0, hi, 0 per node, its levels
  concatenated root first.  The last level holds the blocks of ``block``
  consecutive triangles (a short last block is padded with its last
  triangle, as ``build_tri_blocks`` pads, :453-460); each level above is
  the union of ``fanout`` consecutive nodes (the JAX package's superblocks,
  :296-304), up to the root, the whole mesh.  Morton order keeps the unions
  tight.  Every box is grown by ``AABB_PAD`` times the mesh's largest
  coordinate (at least 1), so that an f32 slab test never rejects a box
  whose triangle Möller–Trumbore hits, flat axis-aligned triangles included
  (``tri_cull_mask``'s ``inflate``, :1001).

:class:`BruteForce` is the plain version of the sweep: brute force over all
triangles, in chunks that keep a [lanes, chunk] pair tensor bounded
(``trace.py:218-339``), without culls, so that it checks that the kernel's
culls change nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..scene import Materials, Scene
from . import primitives as pr

# TRI_STREAM_MAX_TRIANGLES (pallas_trace.py:250-254): the JAX package's
# megakernel takes no more; above it the JAX package falls back to its XLA
# tracer, which the port does not have yet (ROADMAP A7)
TRI_MAX_TRIANGLES = 524_288
TRI_CODE = 126          # hit code of a triangle node in the records
TRI_BLOCK = 16          # triangles per leaf block
TRI_FANOUT = 8          # children of a node above the blocks
TRI_MAX_LEVELS = 8      # levels of the AABB tree the kernel takes
ATTR_STRIDE = 16        # normal3 + material13
AABB_PAD = 1e-5
# a feeler through transparent triangles keeps 0.8 per crossing: the literal
# of trace.py:385, not cfg.transparent_through
TRI_THROUGH = 0.8
# elements of one [lanes, chunk] pair tensor of the plain version, by device
# type: a pair test makes some 30 such temporaries
PAIR_BUDGET = {"cpu": 1 << 22, "cuda": 1 << 25}


def material_rows(m: Materials) -> torch.Tensor:
    """[N, 13] f32: rgb3, ambient, diffuse, specular, shininess,
    transparent, dielectric, n, reflectivity, texture_id, texture_scale."""
    cols = [m.rgb, m.ambient[:, None], m.diffuse[:, None],
            m.specular[:, None], m.shininess[:, None],
            m.transparent[:, None], m.dielectric[:, None], m.n[:, None],
            m.reflectivity[:, None], m.texture_id[:, None],
            m.texture_scale[:, None]]
    return torch.cat([c.to(torch.float32) for c in cols], dim=1)


@dataclasses.dataclass
class TriTables:
    geom: torch.Tensor       # [T, 12] f32
    attr: torch.Tensor       # [T, 16] f32
    node: torch.Tensor       # [n_nodes, 8] f32, levels root first
    level_n: Tuple[int, ...]  # nodes per level, root (1) first
    block: int
    fanout: int

    @property
    def n(self) -> int:
        return self.geom.shape[0]

    def level(self, i: int) -> torch.Tensor:
        """[level_n[i], 8] boxes of level ``i``."""
        a = sum(self.level_n[:i])
        return self.node[a:a + self.level_n[i]]

    @property
    def v0(self):
        return self.geom[:, 0:3]

    @property
    def e1(self):
        return self.geom[:, 4:7]

    @property
    def e2(self):
        return self.geom[:, 8:11]

    @property
    def transparent(self):
        return self.geom[:, 3] > 0.5


def check_triangle_count(n: int) -> None:
    if n > TRI_MAX_TRIANGLES:
        raise ValueError(
            f"the scene has {n:,} triangles; the megakernel takes at most "
            f"{TRI_MAX_TRIANGLES:,} (TRI_STREAM_MAX_TRIANGLES), and the "
            "whole-image tracer that the JAX package falls back to above it "
            "is not ported yet (ROADMAP A7)")


def _unions(lo, hi, k: int):
    """Boxes of ``k`` consecutive boxes; a short last group is padded with
    its last box."""
    n = lo.shape[0]
    pad = -n % k
    lo = torch.cat([lo, lo[-1:].expand(pad, 3)]).reshape(-1, k, 3)
    hi = torch.cat([hi, hi[-1:].expand(pad, 3)]).reshape(-1, k, 3)
    return lo.amin(1), hi.amax(1)


def build_tri_tables(scene: Scene) -> "TriTables | None":
    """The scene's triangle tables on its device (None without triangles);
    raises above ``TRI_MAX_TRIANGLES``."""
    n = scene.num_triangles
    check_triangle_count(n)
    if n == 0:
        return None
    v0, v1, v2 = (t.detach().to(torch.float32)
                  for t in (scene.tri_v0, scene.tri_v1, scene.tri_v2))
    e1, e2 = v1 - v0, v2 - v0
    zero = torch.zeros(n, 1, dtype=torch.float32, device=v0.device)
    transp = scene.tri_mat.transparent.detach().to(torch.float32)[:, None]
    geom = torch.cat([v0, transp, e1, zero, e2, zero], 1).contiguous()
    attr = torch.cat([pr.normalize3(pr.cross3(e1, e2)),
                      material_rows(scene.tri_mat).detach()], 1).contiguous()

    levels = [_unions(torch.minimum(torch.minimum(v0, v1), v2),
                      torch.maximum(torch.maximum(v0, v1), v2), TRI_BLOCK)]
    while levels[-1][0].shape[0] > 1:
        levels.append(_unions(*levels[-1], TRI_FANOUT))
    levels.reverse()
    big = torch.cat([v0, v1, v2]).abs().max().clamp(min=1.0)
    pad = AABB_PAD * big
    zl = [torch.zeros(lo.shape[0], 1, dtype=torch.float32, device=v0.device)
          for lo, _ in levels]
    node = torch.cat([torch.cat([lo - pad, z, hi + pad, z], 1)
                      for (lo, hi), z in zip(levels, zl)]).contiguous()
    return TriTables(geom=geom, attr=attr, node=node,
                     level_n=tuple(lo.shape[0] for lo, _ in levels),
                     block=TRI_BLOCK, fanout=TRI_FANOUT)


def _chunk(x: torch.Tensor) -> int:
    return max(1, PAIR_BUDGET.get(x.device.type, PAIR_BUDGET["cpu"])
               // max(x.shape[0], 1))


class BruteForce:
    """The plain version's triangle search (the default of
    ``render_megakernel_reference``): ``closest`` and ``blocked`` over all
    triangles, no culls."""

    def __init__(self, tris: TriTables):
        self.tris = tris

    def closest(self, o, d, lt, bt):
        """Closest triangle hit and light occlusion of the rays (o, d), over
        every triangle (``trace.py:433-488``): (t [N] f32, inf where none;
        wid [N] i64, -1 where none, the lowest id among equal t; lblock [N]
        bool, an opaque triangle at t <= lt).  ``bt``, the closest analytic
        hit, bounds only a search with culls."""
        tris, n = self.tris, o.shape[0]
        best = torch.full((n,), float("inf"), dtype=torch.float32,
                          device=o.device)
        wid = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        lblock = torch.zeros(n, dtype=torch.bool, device=o.device)
        step = _chunk(o)
        for c0 in range(0, tris.n, step):
            sl = slice(c0, c0 + step)
            hit, t = pr.intersect_triangle_edges(
                o[:, None], d[:, None], tris.v0[None, sl], tris.e1[None, sl],
                tris.e2[None, sl])
            tmin, arg = torch.where(hit, t, float("inf")).min(1)
            better = tmin < best
            best = torch.where(better, tmin, best)
            wid = torch.where(better, arg + c0, wid)
            lblock |= (hit & (t <= lt[:, None])
                       & ~tris.transparent[None, sl]).any(1)
        return best, wid, lblock

    def blocked(self, p, q, tmax):
        """Shadow feelers from p along the unit q against every triangle
        (``trace.py:342-386``): (blocked [N] bool, an opaque triangle at
        t < tmax; crossings [N] i64, transparent triangles at t < tmax)."""
        tris, n = self.tris, p.shape[0]
        blocked = torch.zeros(n, dtype=torch.bool, device=p.device)
        count = torch.zeros(n, dtype=torch.int64, device=p.device)
        step = _chunk(p)
        for c0 in range(0, tris.n, step):
            sl = slice(c0, c0 + step)
            hit, t = pr.intersect_triangle_edges(
                p[:, None], q[:, None], tris.v0[None, sl], tris.e1[None, sl],
                tris.e2[None, sl])
            rel = hit & (t < tmax[:, None])
            transp = tris.transparent[None, sl]
            blocked |= (rel & ~transp).any(1)
            count += (rel & transp).sum(1)
        return blocked, count
