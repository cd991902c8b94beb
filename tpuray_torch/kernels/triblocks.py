"""Triangle tables of the megakernel's triangle sweep and of the triangle-query
kernel, and their plain version.

Port of ``build_tri_blocks`` (``tpuray/kernels/pallas_trace.py:367``) for the
megakernel's triangle configurations K3 (tables in VMEM, up to 32,768
triangles) and K4 (blocks streamed from HBM, up to 524,288), and of
``build_query_blocks`` (:3129) for the triangle-query kernel K6.  On the H100
both megakernel configurations are one path: the tables live in device
memory, cached in L2, and the kernel reads what it needs.  The TPU's
bilinear-form rows, bf16 splits and DMA blocks are not carried over; the
tables hold what Möller–Trumbore and the culls read, in f32.

:func:`build_query_tables` works on triangle arrays in the order given (a
built scene's are Morton-sorted, which keeps the boxes tight) and builds:

* ``geom`` [T, 12]: v0, the transparent flag, e1 = v1 - v0, 0, e2 = v2 - v0,
  0 (three float4 rows a thread reads per test);
* ``node`` [n_nodes, 8]: an AABB tree, lo, 0, hi, 0 per node, its levels
  concatenated root first.  The last level holds the blocks of ``block``
  consecutive triangles (a short last block is padded with its last
  triangle, as ``build_tri_blocks`` pads, :453-460); each level above is
  the union of ``fanout`` consecutive nodes (the JAX package's superblocks,
  :296-304), up to the root, the whole mesh.  Every box is grown by
  ``AABB_PAD`` times the mesh's largest coordinate (at least 1), so that an
  f32 slab test never rejects a box whose triangle Möller–Trumbore hits,
  flat axis-aligned triangles included (``tri_cull_mask``'s ``inflate``,
  :1001).

:func:`build_tri_tables` adds, for the megakernel, ``attr`` [T, 16]: the
unit face normal and the 13 material fields, read for the winner only.

:class:`BruteForce` is the plain version of both kernels' triangle search:
brute force over all triangles, in chunks that keep a [lanes, chunk] pair
tensor bounded (``trace.py:218-339``), without culls, so that it checks that
the kernels' culls change nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..scene import Materials, Scene
from . import primitives as pr

# TRI_STREAM_MAX_TRIANGLES (pallas_trace.py:250-254): the megakernel takes no
# more; above it engine='auto' falls back to the whole-image tracer
TRI_MAX_TRIANGLES = 524_288
TRI_CODE = 126          # hit code of a triangle node in the records
TRI_BLOCK = 16          # triangles per leaf block
TRI_FANOUT = 8          # children of a node above the blocks (the walk takes 8)
TRI_MAX_LEVELS = 8      # levels of the AABB tree the kernels take
# the most triangles a tree of TRI_MAX_LEVELS levels holds: 16 * 8^7
TRI_QUERY_MAX_TRIANGLES = TRI_BLOCK * TRI_FANOUT ** (TRI_MAX_LEVELS - 1)
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
    attr: Optional[torch.Tensor]   # [T, 16] f32; None in query tables
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
    """Raises above the megakernel's cap."""
    if n > TRI_MAX_TRIANGLES:
        raise ValueError(
            f"the scene has {n:,} triangles; the megakernel takes at most "
            f"{TRI_MAX_TRIANGLES:,} (TRI_STREAM_MAX_TRIANGLES): render it "
            "with engine='tracer' (engine='auto' falls back to the tracer)")


def _unions(lo, hi, k: int):
    """Boxes of ``k`` consecutive boxes; a short last group is padded with
    its last box."""
    n = lo.shape[0]
    pad = -n % k
    lo = torch.cat([lo, lo[-1:].expand(pad, 3)]).reshape(-1, k, 3)
    hi = torch.cat([hi, hi[-1:].expand(pad, 3)]).reshape(-1, k, 3)
    return lo.amin(1), hi.amax(1)


def build_query_tables(v0, v1, v2, transparent) -> TriTables:
    """The triangle-query kernel's tables (``geom`` and ``node``, no
    ``attr``) for the triangles ``v0``, ``v1``, ``v2`` [T, 3] (T >= 1) and
    their transparent flags [T], on their device.

    The only limit is the tree's depth, ``TRI_MAX_LEVELS`` levels, that is
    ``TRI_QUERY_MAX_TRIANGLES`` = 16 * 8^7 triangles.  The JAX package's
    query kernels hold their blocks in VMEM and stop at 32,768 triangles,
    above which its tracer falls back to the XLA scan (trace.py:172-177);
    here the tables sit in device memory whatever their size."""
    n = v0.shape[0]
    if not 1 <= n <= TRI_QUERY_MAX_TRIANGLES:
        raise ValueError(f"{n:,} triangles: the query tables take 1 to "
                         f"{TRI_QUERY_MAX_TRIANGLES:,} ({TRI_MAX_LEVELS} "
                         "levels of the AABB tree)")
    v0, v1, v2 = (t.detach().to(torch.float32) for t in (v0, v1, v2))
    e1, e2 = v1 - v0, v2 - v0
    zero = torch.zeros(n, 1, dtype=torch.float32, device=v0.device)
    transp = transparent.detach().to(torch.float32)[:, None]
    geom = torch.cat([v0, transp, e1, zero, e2, zero], 1).contiguous()

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
    return TriTables(geom=geom, attr=None, node=node,
                     level_n=tuple(lo.shape[0] for lo, _ in levels),
                     block=TRI_BLOCK, fanout=TRI_FANOUT)


def build_tri_tables(scene: Scene) -> "TriTables | None":
    """The megakernel's triangle tables on the scene's device (None without
    triangles): the query tables plus ``attr``; raises above
    ``TRI_MAX_TRIANGLES``."""
    n = scene.num_triangles
    check_triangle_count(n)
    if n == 0:
        return None
    tables = build_query_tables(scene.tri_v0, scene.tri_v1, scene.tri_v2,
                                scene.tri_mat.transparent)
    tables.attr = torch.cat([pr.normalize3(pr.cross3(tables.e1, tables.e2)),
                             material_rows(scene.tri_mat).detach()],
                            1).contiguous()
    return tables


def _chunk(x: torch.Tensor) -> int:
    return max(1, PAIR_BUDGET.get(x.device.type, PAIR_BUDGET["cpu"])
               // max(x.shape[0], 1))


class BruteForce:
    """The plain version of the kernels' triangle search (the default of
    ``render_megakernel_reference``, and the triangle-query kernel's):
    ``closest`` and ``blocked`` over all triangles, no culls."""

    def __init__(self, tris: TriTables):
        self.tris = tris

    def closest(self, o, d, lt=None, bt=None, pixels=None):
        """Closest triangle hit of the rays (o, d) over every triangle
        (``trace.py:433-488``): (t [N] f32, inf where none; wid [N] i64, -1
        where none, the lowest id among equal t; lblock [N] bool, an opaque
        triangle at t <= lt, or None without ``lt``).  ``bt``, the closest
        analytic hit, bounds only a search with culls; ``pixels``, the rays'
        pixels, only a search that counts by warp."""
        tris, n = self.tris, o.shape[0]
        best = torch.full((n,), float("inf"), dtype=torch.float32,
                          device=o.device)
        wid = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        lblock = (None if lt is None
                  else torch.zeros(n, dtype=torch.bool, device=o.device))
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
            if lt is not None:
                lblock |= (hit & (t <= lt[:, None])
                           & ~tris.transparent[None, sl]).any(1)
        return best, wid, lblock

    def blocked(self, p, q, tmax, inclusive: bool = False, pixels=None):
        """Rays from p along q against every triangle (``trace.py:305-386``):
        (blocked [N] bool, an opaque triangle at t < tmax; crossings [N]
        i64, transparent triangles at t < tmax), with t <= tmax where
        ``inclusive`` (the light test, trace.py:426).  A ray with tmax <= 0
        meets nothing."""
        tris, n = self.tris, p.shape[0]
        blocked = torch.zeros(n, dtype=torch.bool, device=p.device)
        count = torch.zeros(n, dtype=torch.int64, device=p.device)
        step = _chunk(p)
        for c0 in range(0, tris.n, step):
            sl = slice(c0, c0 + step)
            hit, t = pr.intersect_triangle_edges(
                p[:, None], q[:, None], tris.v0[None, sl], tris.e1[None, sl],
                tris.e2[None, sl])
            within = t <= tmax[:, None] if inclusive else t < tmax[:, None]
            rel = hit & within
            transp = tris.transparent[None, sl]
            blocked |= (rel & ~transp).any(1)
            count += (rel & transp).sum(1)
        return blocked, count
