"""Smoke run of the PyTorch/CUDA port (``tpuray_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:

1. the card (name and power limit), PyTorch, CUDA and nvcc versions;
2. the CUDA kernels built with nvcc from ``tpuray_torch/kernels/csrc``
   (the megakernel in its base and record instantiations);
3. the base kernel (K1) against its plain PyTorch version on the card, at
   two test shapes (200x50 has lanes outside the image), at the raypng
   shape (800x600, depth 15) and on its rows 368-399, its deepest pixels;
4. the raypng path as a user runs it: ``tpuray_torch.apps.raypng`` at
   800x600 depth 15, which must go through K1; with the reference tree
   mounted, on render.map and its assets against the golden image;
5. K1 and plain times (CUDA events, 3 warm-ups, median of 10) at the
   raypng shape and at the benchmark's 1920x1080 depth 4;
6. the record kernel (K5) against its plain version: records, winner ids,
   texel picks, shadow ratios and ``max_nodes``, and its image bit-equal
   to K1's, at three test shapes, on 203x37 (lanes outside the image) and
   on rows 368-399 of 800x600 d15 (its deepest pixels);
7. the replay on the card: it reproduces K5's image, and the gradient
   through ``render_megakernel_diff`` matches the same on the CPU;
8. the inverse-rendering path as a user runs it:
   ``tpuray_torch.apps.invrender`` at 128x96 depth 3 for 20 steps, which
   must go through K5 and lower the loss;
9. times: K5 against K1 (the cost of recording), one training step and its
   parts with peak memory, at the training shapes;
10. the kernel with triangles (K3 and K4, one path) against its plain
    version, whose triangle search is brute force: ``mesh_benchmark_scene(4)``
    (7,424 triangles) at 512x384 depth 3, the whole image, and 163,840
    triangles on a slab of rows;
11. K5 on those mesh scenes: records, triangle ids, texel picks and shadow
    ratios against the plain version; the replay against K5's image; the
    gradient on the card against the CPU's, triangle vertices included;
12. the raypng path on mesh archives written by the port's ``sceneio``
    (7,424 and 163,840 triangles, 512x384 depth 3), one launch each, and
    the invrender path on the 7,424-triangle archive (128x96 depth 3, 10
    steps), which must go through K5 and lower the loss;
13. times and bounds of the mesh kernels: 512x384 d3 with 7,424 and with
    163,840 triangles, 3840x2160 d6 with 10,240, and K5 at 512x384 d3 with
    7,424; the walk's work as the kernel walks it (:class:`WalkCount`,
    and the id-order walk it replaced), on the 4K frame on a slab of rows;
14. bilinear filtering (K2, the ``BILINEAR`` instantiations) against its
    plain version at 256x64 d3, 200x50 d6, 800x600 d15 and on its rows
    368-399, ``render()`` with
    ``filter='bilinear'`` through it, K2 and K1 times at 800x600 d15 and
    1920x1080 d4, and the ptxas figures of every instantiation;
15. bilinear records (K5 with 4 texel picks per fetch) against the plain
    version, the replay against K5's image, and the bilinear gradient on
    the card against the CPU's, with a spatial gradient on ``plane_point``;
16. the triangle-query kernel (K6, ``csrc/tri_query.cu``) against its plain
    version: closest hits, strict and inclusive blocker tests, on 512x384
    primary rays and on random rays, over 7,424 and 163,840 triangles,
    with times, bounds and the walk's work as the kernel walks it;
17. the tracer engine on the card: ``render(engine='tracer')`` at 512x384
    d3 against K1 (canonical scene) and K3 (7,424 triangles), one of them
    under the profiler (CUDA kernels, device busy share), raypng
    ``--engine tracer`` at 800x600 d15 against K1's image, and the
    589,824-triangle scene above the megakernel's cap through
    ``engine='auto'``, which must go to the tracer and K6;
18. invrender ``--engine tracer``: 128x96 d3, 10 steps on the canonical
    scene, then 5 steps on the 7,424-triangle archive through K6;
19. the deepest pixels of 800x600 d15: K1's and K5's times on the whole
    frame and on its rows 368-399 alone (with and without shadow samples),
    K1's at depth 4, K5 less K1 at 512x384 d3 without samples (the cost of
    the records), and the DFS work per pixel and
    per warp (:class:`NodeCount`) at 800x600 d15 and 1920x1080 d4; the
    bounds of K1 and K2 at 1920x1080 d4 and K5's time and bound at 800x600
    d15, also at the fp32 rate without FMA;
20. sharding (``tpuray_torch.parallel``) on worlds of ranks on this one
    card, started by ``distributed.launch``: a world of 1 over NCCL
    (``render_sharded_pallas`` at 1920x1080 d4 and 800x600 d15 bit-equal
    to ``render()``, ``loss_and_scene_grad_sharded_pallas`` at 128x96 d3
    ss0 bit-equal to one rank's loss and gradients), what NCCL says to a
    world of 2 on one card, a world of 2 over gloo (K1, K2, K3 and K4 with
    rows sharded, bit-equal to one render; K5 and the replay against one
    rank's loss and gradients at the bar of
    ``tests/sharding_subproc.py:199-201``; triangles sharded over K6 on
    7,424 and 163,840 triangles against one rank's tracer) and a world of
    4 over gloo (pixels x triangles on a 2x2 mesh), with each check's max
    |d|, differing pixels, kernel launches and wall time per rank;
21. the viewer and the last host modules: ``apps/rayview --keys`` at
    800x600 d6 (19 keys, every binding) must pack the scene once and launch
    K1 once a frame, its last frame must agree with the plain version and
    its PNGs with its frames, with the median frame's device and host time
    and the host's split (swap, copy back, PNG); the same on the
    7,424-triangle archive at 512x384 d3 through K3, against a loop of
    ``render_from_basis``; ``serve`` on 127.0.0.1 with the real renderer
    (/frame.jpg, /key, one /stream part, shut down within 10 s) with the
    JPEG time a frame; raypng ``--profile`` at 800x600 d15, whose trace must
    hold a megakernel kernel event, and ``timed``; ``nan_guard`` catching a
    NaN out of K1; the native codec's status and, where it built, its PNGs
    and scene archives against the numpy + zlib codec and ``dumps_scene``;
22. the benchmark, profiling and validation entry points, each run as
    ``python3 -m`` at its defaults: ``tpuray_torch.bench``,
    ``benchmarks.stages`` (stages 1-6), ``benchmarks.stream``,
    ``scripts.profile_tri`` (base, noshadow, d1, notri),
    ``scripts.profile_replay`` at depths 3 and 15, ``benchmarks.scaling``
    for both layouts at 512x384 d3 (reduced: the tracer is slow at 1080p),
    ``scripts.validate --skip-stages --skip-replay`` (invrender's 200 steps
    at 128x96): every command must exit 0, print the card's line and rows
    that name it, launch the kernels each row says it launched, and bench's
    and stage 3's ``kernel_ms`` must lie within 25% of phase 5's K1 time at
    1920x1080 d4.

It prints a JSON line of per-kernel results, then, last, the line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails and
prints no result.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the larger of its FLOPs over 67 TFLOP/s (fp32 outside the tensor
cores) and its bytes over 3.35 TB/s (H100 SXM data sheet).  The FLOPs are
counted from this run's DFS nodes, read from K5's records at the same
inputs (solid hits, triangle hits included, misses and light hits, at most
64 per pixel), times the fp32 operations of one node reckoned from
``csrc/megakernel.cu`` (a sqrt, a division or a sine counted as one); the
bytes are the image written once, the texels the nodes fetched, the packed
scene, the triangle tables and, for K5, the records.  With triangles the
FLOPs add the work of the triangle walks: the box tests and the (ray,
triangle) Möller–Trumbore pairs that the kernel's AABB tree leaves, counted
on the host by :class:`TreeSearch` at the same inputs.  That is the bound of
this design (its tree, its culls), not of any acceleration structure.  A
bilinear fetch adds its 4 texels' bytes and ``BILINEAR_FETCH_FLOPS``.  The
triangle-query kernel's bound is the same count of box tests and pairs over
the fp32 rate against the rays' bytes (and the tables') over the memory
rate.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

from tpuray_torch.kernels import primitives as pr

AGREE_ABS = 1e-3
AGREE_FRAC = 0.999
MEAN_ABS = 1e-4
SSR_ABS = 1e-5
# the replay's bar and the gradient's (tests/test_pallas_vjp.py:82-83 and
# :297-303): the card's reductions sum in another order than the CPU's
REPLAY_MEAN = 1e-3
REPLAY_MAX = 5e-2
# with triangles (tests/test_pallas_vjp.py:96-97)
TRI_REPLAY_MEAN = 2e-3
TRI_REPLAY_MAX = 1e-1
GRAD_ATOL = 2e-2
# the golden drive's bar (ROADMAP.md, Tier-1 verify)
GOLDEN_MEAN = 1.0
GOLDEN_WITHIN_8 = 0.99
GOLDEN_PSNR = 40.0
GOLDEN_CAMERA = ((0.8, 2.5, -8.0), (0.2, 0.0, 1.0), 90.0, 1.0)
ASSET_SEED = 0
INVRENDER_STEPS = 20
MESH_INVRENDER_STEPS = 10
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W); the fp32
# rate counts an FMA as two operations, and the kernels are built without
# FMA (--fmad=false), so one operation an instruction is half of it
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_OPS_NO_FMA = PEAK_FP32_FLOPS / 2
PEAK_BYTES = 3.35e12
TRI_CODE = 126
# fp32 operations of one tri_t test and one box_hit test in
# csrc/megakernel.cu, every branch taken
MT_FLOPS = 54
BOX_FLOPS = 25
# the mesh cells (BASELINE stages 5 and 6, benchmarks/stream.py):
# (icosphere order, torus resolution) -> 7,424, 10,240 and 163,840 triangles
MESH_K3 = (4, (48, 24))
MESH_4K = (4, (64, 40))
MESH_K4 = (6, (256, 160))
# (row0, rows) of the slabs where the plain version is too slow for the
# whole image: through the meshes (rows 217-274 of 384 hold triangle hits)
K4_SLAB = (240, 16)
SLAB_4K = (1528, 16)
# (row0, rows) of the 800x600 d15 frame that hold its deepest pixels (the
# glass spheres: 583 pixels with 40 or more nodes lie in rows 318-394)
DEEP_SLAB = (368, 32)
# fp32 operations a bilinear fetch adds to a nearest one: the floors and
# fractions, 4 weights, 4 weighted texels and the wraps or clamps
BILINEAR_FETCH_FLOPS = 30
# bytes per ray of the triangle-query kernel: in (o, d[, tmax]), out (t and
# id, or blocked and count)
QUERY_RAY_BYTES = {"closest": 24 + 8, "blocker": 28 + 5}
QUERY_RANDOM_RAYS = 65536
# the scene above the megakernel's cap: 327,680 + 262,144 triangles
MESH_ABOVE_CAP = (7, (512, 256))
ABOVE_CAP_CHECK_RAYS = 4096
# the tracer against the megakernel (tests/test_render.py:83)
TRACER_AGREE_ABS = 1e-2
TRACER_AGREE_FRAC = 0.995
# u8 bar (tests/test_pallas_engine.py:343-348)
U8_WITHIN_1 = 0.98
U8_MEAN = 1.0
TRACER_INVRENDER_STEPS = 10
TRACER_MESH_STEPS = 5
# phase 20: worlds on the one card (name, ranks, backend); NCCL takes one
# rank per card, so several ranks share it over gloo
SHARD_WORLDS = (("world 1", 1, "nccl"), ("world 2", 2, "gloo"),
                ("world 4", 4, "gloo"))
SHARD_TIMEOUT = 300
NCCL_PROBE_TIMEOUT = 90
# sharded gradients against one rank's (tests/sharding_subproc.py:199-201);
# the scene-parallel tracer against one rank's
SHARD_LOSS_RTOL = 1e-5
SHARD_GRAD_RTOL, SHARD_GRAD_ABS = 5e-3, 5e-5
SCENE_PARALLEL_ABS = 1e-6
# phase 21: the viewer's key script, every binding (wasd, space, _, arrows),
# and its shapes (width, height, depth): the JAX viewer's default, the mesh
# archive's of phase 12, raypng's golden one for --profile
VIEWER_KEYS = "wasd _8246wd8 s6_a2"
VIEWER_SHAPE = (800, 600, 6)
VIEWER_MESH_SHAPE = (512, 384, 3)
PROFILE_SHAPE = (800, 600, 15)
# phase 22: the entry points as a user runs them; scaling at 512x384 d3
# (the tracer is slow at 1080p: the one reduced run); bench's and stage
# 3's kernel_ms within this share of phase 5's K1 time at 1080p d4
SCALING_SHAPE = ("--width", "512", "--height", "384", "--depth", "3")
ENTRY_TIMEOUT = 900
KERNEL_MS_RTOL = 0.25
VALIDATE_INVRENDER_STEPS = 200


def phase(n, name, text):
    print(f"phase {n} {name}: {text}", flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def node_flops(ns, npl, nl, samples):
    """fp32 operations of one DFS node by kind, reckoned from
    csrc/megakernel.cu: a sphere test (sphere_t plus the compare) is 37, a
    plane test 19, a light test 36; a solid hit adds its normal, texel or
    ambient term and continuation (100) and, per light, the Phong terms
    (77) and per shadow sample the point on the light (41) and the
    occluder tests."""
    per_node = 36 * nl + 37 * ns + 19 * npl
    sample = 41 + 37 * ns + 18 * npl
    return {"node": per_node, "solid": 100 + nl * (77 + samples * sample),
            "miss": 25, "light": 10}


def bound(records, packed, cfg, with_records, walks=None):
    """(bound_ms, bound_by, node counts) of one megakernel launch on these
    inputs, from the records of K5 on the same inputs and, with triangles,
    the counts of a :class:`TreeSearch` run at the same inputs."""
    lay = packed.layout
    rec = records["rec"]
    code, written = rec & 0xFF, rec >= 0
    solid = (code < lay.n_spheres + lay.n_planes) | (code == TRI_CODE)
    n_pix = cfg.width * cfg.height
    pick = records["pick"].reshape(rec.shape[0], -1, n_pix)
    counts = {"nodes": int(written.sum()),
              "solid": int((written & solid).sum()),
              "miss": int((written & (code == 127)).sum()),
              "picks": int((pick >= 0).sum()),
              "fetches": int((pick[:, 0] >= 0).sum())}
    counts["light"] = counts["nodes"] - counts["solid"] - counts["miss"]
    f = node_flops(lay.n_spheres, lay.n_planes, lay.n_lights,
                   cfg.shadow_samples)
    flops = (counts["nodes"] * f["node"] + counts["solid"] * f["solid"]
             + counts["miss"] * f["miss"] + counts["light"] * f["light"])
    if cfg.filter == "bilinear":
        flops += counts["fetches"] * BILINEAR_FETCH_FLOPS
    nbytes = n_pix * 12 + counts["picks"] * 3 + packed.buf.numel() * 4
    if packed.tris is not None:
        t = packed.tris
        nbytes += 4 * (t.geom.numel() + t.attr.numel() + t.node.numel())
        counts.update(mt_pairs=walks.pairs, box_tests=walks.boxes)
        flops += walks.pairs * MT_FLOPS + walks.boxes * BOX_FLOPS
    if with_records:   # rec, wid, the picks and ssr of every slot
        nbytes += rec.shape[0] * n_pix * (
            8 + 4 * pick.shape[1] + 4 * lay.n_lights) + 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    counts.update(flops=flops, bytes=nbytes,
                  max_nodes=int(records["max_nodes"]))
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", counts)


class TreeSearch:
    """The plain version's triangle search walked through the kernels' AABB
    tree level by level, which counts the work the tree leaves for the
    bound: box tests (``boxes``) and (ray, triangle) Möller–Trumbore pairs
    (``pairs``).  Its answers are the brute force's (the boxes are grown to
    be conservative).  The counts are a lower bound of a walk's: a
    closest-hit walk is counted with its final bound (the kernel's,
    :class:`WalkCount`, prunes with the bound it has so far), a shadow
    feeler in id order up to its first opaque triangle.  Rays go in chunks
    of ``chunk`` to bound the pair lists."""

    def __init__(self, tris, chunk=1 << 15):
        self.tris, self.chunk = tris, chunk
        self.pairs = 0
        self.boxes = 0

    @staticmethod
    def _inverse(d):
        return 1.0 / torch.where(d.abs() < 1e-12,
                                 torch.full_like(d, 1e-12), d)

    def _walk(self, o, inv, bound, stop=None):
        """(lane, triangle) of the triangles of every block the walk
        enters.  With ``stop`` [N] (the last triangle a lane's walk reaches)
        it counts the box tests and the pairs up to there."""
        t = self.tris
        dev = o.device
        lane = torch.arange(o.shape[0], device=dev)
        node = torch.zeros_like(lane)
        span = t.block * t.fanout ** (len(t.level_n) - 1)
        for level, n_level in enumerate(t.level_n):
            if level:
                lane = lane.repeat_interleave(t.fanout)
                node = (node[:, None] * t.fanout + torch.arange(
                    t.fanout, device=dev)).reshape(-1)
                keep = node < n_level
                lane, node = lane[keep], node[keep]
                span //= t.fanout
            if stop is not None:
                self.boxes += int((node * span <= stop[lane]).sum())
            box = t.level(level)[node]
            oo, ii = o[lane], inv[lane]
            t0 = (box[:, 0:3] - oo) * ii
            t1 = (box[:, 4:7] - oo) * ii
            near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
            lo = near[:, 0].clamp(min=0.0).maximum(near[:, 1]).maximum(
                near[:, 2])
            hi = torch.minimum(bound[lane], far[:, 0]).minimum(
                far[:, 1]).minimum(far[:, 2])
            hit = lo <= hi
            lane, node = lane[hit], node[hit]
        lane = lane.repeat_interleave(t.block)
        tri = (node[:, None] * t.block
               + torch.arange(t.block, device=dev)).reshape(-1)
        keep = tri < t.n
        lane, tri = lane[keep], tri[keep]
        if stop is not None:
            self.pairs += int((tri <= stop[lane]).sum())
        return lane, tri

    def _test(self, o, d, lane, tri):
        t = self.tris
        return pr.intersect_triangle_edges(o[lane], d[lane], t.v0[tri],
                                           t.e1[tri], t.e2[tri])

    def _chunked(self, fn, *lanes):
        outs = [fn(*(x[a:a + self.chunk] for x in lanes))
                for a in range(0, lanes[0].shape[0], self.chunk)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def closest(self, o, d, lt, bt, pixels=None):
        return self._chunked(self._closest, o, d, lt, bt)

    def blocked(self, p, q, tmax, pixels=None):
        return self._chunked(self._blocked, p, q, tmax)

    def _closest(self, o, d, lt, bt):
        n, dev, inv = o.shape[0], o.device, self._inverse(d)
        lt_seg = torch.where(torch.isfinite(lt), lt, torch.zeros_like(lt))
        lane, tri = self._walk(o, inv, torch.maximum(lt_seg, bt))
        hit, t = self._test(o, d, lane, tri)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        best = torch.full((n,), float("inf"), device=dev).scatter_reduce(
            0, lane, t, "amin")
        win = hit & (t == best[lane])
        wid = torch.full((n,), self.tris.n, dtype=torch.int64,
                         device=dev).scatter_reduce(0, lane[win], tri[win],
                                                    "amin")
        wid = torch.where(wid == self.tris.n, torch.full_like(wid, -1), wid)
        occ = hit & (t <= lt[lane]) & ~self.tris.transparent[tri]
        lblock = torch.zeros(n, dtype=torch.bool, device=dev)
        lblock[lane[occ]] = True
        final = torch.minimum(bt, best)
        final = torch.where(lblock, final, torch.maximum(lt_seg, final))
        self._walk(o, inv, final,
                   torch.full((n,), self.tris.n, dtype=torch.int64,
                              device=dev))
        return best, wid, lblock

    def _blocked(self, p, q, tmax):
        n, dev, inv = p.shape[0], p.device, self._inverse(q)
        lane, tri = self._walk(p, inv, tmax)
        hit, t = self._test(p, q, lane, tri)
        rel = hit & (t < tmax[lane])
        transp = self.tris.transparent[tri]
        opaque = rel & ~transp
        first = torch.full((n,), self.tris.n, dtype=torch.int64,
                           device=dev).scatter_reduce(0, lane[opaque],
                                                      tri[opaque], "amin")
        count = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, lane[rel & transp], torch.ones_like(lane[rel & transp]))
        self._walk(p, inv, tmax, first)
        return first < self.tris.n, count


# the lowest set bit of each byte (8 for none)
LOWBIT = torch.tensor([next((j for j in range(8) if m >> j & 1), 8)
                       for m in range(256)])


class WalkCount:
    """The triangle walk of ``csrc/tri_walk.cuh`` emulated ray by ray, all
    rays in lockstep, with its answers and its counts of work.

    ``order='nearest'`` is the walk the kernels run: wide steps (the 8
    children of a node tested at once), children the closest-hit query
    meets taken by entry t and tested again against the shrunk bound when
    taken up, a feeler's in id order.  ``order='id'`` is the stackless walk
    it replaced (one box test per child, children in id order), counted the
    same way.  Both prune with the running bound, as the kernel does.

    ``group`` is the lanes per ray (1: a thread alone, the megakernel and the
    old K6; K6's QUERY_GROUP): a group tests a whole leaf before a feeler
    stops, a thread stops at the first opaque triangle.  Per ray it counts
    box tests (``boxes``), Möller–Trumbore tests (``pairs``) and serial steps
    (a box or leaf test alone; a wide step, a retest or a leaf of a group);
    per warp of the kernel's lane layout (32 consecutive rays; a group's
    queue of rays that enter the root box; the megakernel's 16x2 pixels,
    from the ``pixels`` a plain render passes and ``width``) the union of
    its lanes' tests, and the slowest warp.  ``summary()`` adds them up over
    the queries so far."""

    def __init__(self, tris, order="nearest", group=1, width=None):
        self.tris, self.order, self.group, self.width = tris, order, group, width
        dev = tris.node.device
        self.off = torch.tensor([sum(tris.level_n[:i])
                                 for i in range(len(tris.level_n))],
                                device=dev)
        self.cnt = torch.tensor(tris.level_n, device=dev)
        self.lowbit = LOWBIT.to(dev)
        self.totals = dict(queries=0, rays=0, live=0, boxes=0, pairs=0,
                           steps=0, union_boxes=0, union_pairs=0, warps=0)
        self.slowest = dict(boxes=0, pairs=0)     # of one warp
        self.slowest_ray = dict(boxes=0, pairs=0, steps=0)

    # -- the tests, as the kernel's f32 operations --
    def _box(self, k, o, inv, bound):
        """(hit, entry t) of boxes k [R, ...] for rays [R, 3]."""
        box = self.tris.node[k]
        oo, ii = o.view(-1, *([1] * (k.dim() - 1)), 3), inv.view(
            -1, *([1] * (k.dim() - 1)), 3)
        t0 = (box[..., 0:3] - oo) * ii
        t1 = (box[..., 4:7] - oo) * ii
        near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
        tmn = torch.fmax(torch.fmax(torch.fmax(torch.zeros_like(near[..., 0]),
                                               near[..., 0]), near[..., 1]),
                         near[..., 2])
        b = bound.view(-1, *([1] * (k.dim() - 1)))
        tmx = torch.fmin(torch.fmin(torch.fmin(b.expand_as(tmn), far[..., 0]),
                                    far[..., 1]), far[..., 2])
        return tmn <= tmx, tmn

    def _leaf(self, o, d, leaf):
        """(triangle ids [R, block], valid, hit, t, transparent)."""
        t = self.tris
        tri = leaf[:, None] * t.block + torch.arange(t.block, device=o.device)
        valid = tri < t.n
        tri = tri.clamp(max=t.n - 1)
        hit, tt = pr.intersect_triangle_edges(o[:, None], d[:, None], t.v0[tri],
                                              t.e1[tri], t.e2[tri])
        return tri, valid, hit & valid, tt, t.transparent[tri]

    # -- the queries --
    def closest(self, o, d, lt, bt, pixels=None):
        n, dev = o.shape[0], o.device
        s = dict(tbest=torch.full((n,), float("inf"), device=dev),
                 wbest=torch.full((n,), -1, dtype=torch.int64, device=dev),
                 lblock=torch.zeros(n, dtype=torch.bool, device=dev))
        lt_seg = torch.where(torch.isfinite(lt), lt, torch.zeros_like(lt))

        def bound(r):
            b = torch.minimum(bt[r], s["tbest"][r])
            return torch.where(s["lblock"][r], b, torch.maximum(lt_seg[r], b))

        def leaf(r, lf):
            tri, valid, hit, t, transp = self._leaf(o[r], d[r], lf)
            tm = torch.where(hit, t, torch.full_like(t, float("inf")))
            tmin, arg = tm.min(1)       # the first of equal t: the lowest id
            win = tri.gather(1, arg[:, None])[:, 0]
            tb, wb = s["tbest"][r], s["wbest"][r]
            better = (tmin < tb) | ((tmin == tb) & (win < wb))
            s["tbest"][r] = torch.where(better, tmin, tb)
            s["wbest"][r] = torch.where(better, win, wb)
            s["lblock"][r] |= (hit & ~transp & (t <= lt[r, None])).any(1)
            return valid.sum(1), torch.zeros_like(lf, dtype=torch.bool)

        self._run(o, d, bound, leaf, True, pixels)
        return s["tbest"], s["wbest"], s["lblock"]

    def blocked(self, p, q, tmax, pixels=None, inclusive=False):
        n, dev = p.shape[0], p.device
        blocked = torch.zeros(n, dtype=torch.bool, device=dev)
        count = torch.zeros(n, dtype=torch.int64, device=dev)

        def leaf(r, lf):
            tri, valid, hit, t, transp = self._leaf(p[r], q[r], lf)
            tm = tmax[r, None]
            rel = hit & ((t <= tm) if inclusive else (t < tm))
            opaque = rel & ~transp
            stop = opaque.any(1)
            tested = valid.sum(1)
            cross = rel & transp
            if self.group == 1:    # a thread stops at the opaque triangle
                first = torch.where(opaque, torch.arange(
                    opaque.shape[1], device=dev), opaque.shape[1]).min(1).values
                before = torch.arange(opaque.shape[1], device=dev) < first[:, None]
                cross = cross & before
                tested = torch.where(stop, first + 1, tested)
            blocked[r] |= stop
            count[r] += cross.sum(1)
            return tested, stop

        active = tmax > 0
        self._run(p, q, lambda r: tmax[r], leaf, False, pixels, active)
        return blocked, count

    # -- the walks --
    def _run(self, o, d, bound, leaf, closest, pixels, active=None):
        n, dev = o.shape[0], o.device
        inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        nearest = self.order == "nearest" and closest
        boxes = torch.zeros(n, dtype=torch.int64, device=dev)
        pairs = torch.zeros_like(boxes)
        steps = torch.zeros_like(boxes)
        rec_box, rec_leaf = [], []       # (ray, node) and (ray, leaf, tests)
        r = torch.arange(n, device=dev)
        if active is not None:
            r = r[active[r]]
        hit, _ = self._box(torch.zeros_like(r), o[r], inv[r], bound(r))
        boxes[r] += 1
        steps[r] += 1
        rec_box.append((r, torch.zeros_like(r)))
        live = r[hit]
        last = len(self.tris.level_n) - 1
        lvl = torch.zeros(n, dtype=torch.int64, device=dev)
        cur = torch.zeros_like(lvl)
        pend = torch.zeros_like(lvl)

        def wide(r, lc, par, want):
            """One wide step (or retest) of rays r: (hit mask, nearest or
            lowest hit child)."""
            first = par * 8
            j = torch.arange(8, device=dev)
            valid = ((first[:, None] + j) < self.cnt[lc][:, None]) & (
                (want[:, None] >> j) & 1).bool()
            k = (self.off[lc][:, None] + first[:, None] + j).clamp(
                max=self.tris.node.shape[0] - 1)
            h, tmn = self._box(k, o[r], inv[r], bound(r))
            h &= valid
            boxes[r] += valid.sum(1)
            steps[r] += 1
            rr, kk = r[:, None].expand_as(k)[valid], k[valid]
            rec_box.append((rr, kk))
            mask = (h.long() << j).sum(1)
            if nearest:
                pick = torch.where(h, tmn, torch.full_like(tmn, float(
                    "inf"))).argmin(1)
            else:
                pick = self.lowbit[mask]
            return mask, pick

        def bit(j):
            return torch.ones_like(j) << j

        def up_to_pending(r):
            """Rays r after a leaf or a miss: up to the deepest level with a
            child to visit; returns the rays that go on."""
            go = []
            while r.numel():
                top = lvl[r] == 0
                r = r[~top]
                if not r.numel():
                    break
                lv = lvl[r]
                m = (pend[r] >> (8 * lv)) & 0xFF
                pend[r] &= ~(torch.full_like(lv, 0xFF) << (8 * lv))
                j = self.lowbit[m]
                if nearest:
                    re = m != 0
                    if bool(re.any()):
                        rr = r[re]
                        m2, j2 = wide(rr, lvl[rr], cur[rr] // 8, m[re])
                        m[re], j[re] = m2, j2
                has = m != 0
                rh, mh, jh = r[has], m[has], j[has]
                pend[rh] |= (mh & ~bit(jh)) << (8 * lvl[rh])
                cur[rh] = cur[rh] - cur[rh] % 8 + jh
                go.append(rh)
                r = r[~has]
                lvl[r] -= 1
                cur[r] //= 8
            return torch.cat(go) if go else r

        if self.order == "nearest":
            while live.numel():
                at_leaf = lvl[live] == last
                lf, inner = live[at_leaf], live[~at_leaf]
                nxt, back = [], []
                if lf.numel():
                    tested, stop = leaf(lf, cur[lf])
                    pairs[lf] += tested
                    steps[lf] += 1
                    rec_leaf.append((lf, cur[lf], tested))
                    back.append(lf[~stop])
                if inner.numel():
                    m, j = wide(inner, lvl[inner] + 1, cur[inner],
                                torch.full_like(inner, 0xFF))
                    down = m != 0
                    rd = inner[down]
                    lvl[rd] += 1
                    pend[rd] |= (m[down] & ~bit(j[down])) << (8 * lvl[rd])
                    cur[rd] = cur[rd] * 8 + j[down]
                    nxt.append(rd)
                    back.append(inner[~down])
                nxt.append(up_to_pending(torch.cat(back)))
                live = torch.cat(nxt).sort().values
        else:   # id order, one box at a time (the stackless walk it replaced)
            if last:                       # from the root to its first child
                lvl[live] = 1
            while live.numel():
                lv = lvl[live]
                leafs = lv == last
                k = self.off[lv] + cur[live]
                h, _ = self._box(k, o[live], inv[live], bound(live))
                if last:
                    boxes[live] += 1
                    steps[live] += 1
                    rec_box.append((live, k))
                else:                      # a lone leaf: the root's test
                    h = torch.ones_like(h)
                stop = torch.zeros_like(h)
                if bool((h & leafs).any()):
                    lf = live[h & leafs]
                    tested, stop[h & leafs] = leaf(lf, cur[lf])
                    pairs[lf] += tested
                    steps[lf] += 1
                    rec_leaf.append((lf, cur[lf], tested))
                down = live[h & ~leafs]
                lvl[down] += 1
                cur[down] *= 8
                adv = live[~(h & ~leafs) & ~stop]
                while adv.numel():     # climb while at a last child
                    lv, c = lvl[adv], cur[adv]
                    climb = (lv > 0) & ((c % 8 == 7) | (c + 1 == self.cnt[lv]))
                    if not bool(climb.any()):
                        break
                    cur[adv[climb]] //= 8
                    lvl[adv[climb]] -= 1
                adv = adv[lvl[adv] > 0]
                cur[adv] += 1
                live = torch.cat([down, adv]).sort().values
        self._tally(n, r, hit, boxes, pairs, steps, rec_box, rec_leaf, pixels)

    def _tally(self, n, rays, live, boxes, pairs, steps, rec_box, rec_leaf,
               pixels):
        dev = boxes.device
        if pixels is not None:      # the megakernel's 16x2-pixel warps
            row, col = pixels // self.width, pixels % self.width
            warp = (row // 2) * -(-self.width // 16) + col // 16
        elif self.group == 1:       # 32 consecutive rays
            warp = torch.arange(n, device=dev) // 32
        else:                       # the queue of rays in the root box
            warp = torch.full((n,), -1, dtype=torch.int64, device=dev)
            warp[rays[live]] = torch.arange(int(live.sum()), device=dev) // (
                32 // self.group)
        t = self.totals
        t["queries"] += 1
        t["rays"] += n
        t["live"] += int(live.sum())
        for key, v in (("boxes", boxes), ("pairs", pairs), ("steps", steps)):
            t[key] += int(v.sum())
        if n and int(steps.max()) > self.slowest_ray["steps"]:
            k = int(torch.argmax(steps))
            self.slowest_ray = dict(boxes=int(boxes[k]), pairs=int(pairs[k]),
                                    steps=int(steps[k]))
        # per warp: the distinct boxes its lanes test, and per leaf the most
        # triangles one of its lanes tests there
        nodes = self.tris.node.shape[0]
        rb = torch.cat([a for a, _ in rec_box])
        kb = torch.cat([b for _, b in rec_box])
        keep = warp[rb] >= 0      # a group's rays that miss the root: no warp
        wb = torch.unique(warp[rb[keep]] * nodes + kb[keep]).div(
            nodes, rounding_mode="floor")
        w_ids, w_boxes = torch.unique(wb, return_counts=True)
        per_warp = torch.zeros(int(warp.max()) + 1 if n else 0, 2,
                               dtype=torch.int64, device=dev)
        per_warp[w_ids, 0] = w_boxes
        if rec_leaf:
            rl, ll, tl = (torch.cat(x) for x in zip(*rec_leaf))
            key, inv_k = torch.unique(warp[rl] * nodes + ll,
                                      return_inverse=True)
            most = torch.zeros(key.shape[0], dtype=torch.int64,
                               device=dev).scatter_reduce(0, inv_k, tl, "amax")
            per_warp[:, 1].index_add_(0, key.div(nodes, rounding_mode="floor"),
                                      most)
        t["warps"] += int(w_ids.numel())
        t["union_boxes"] += int(per_warp[:, 0].sum())
        t["union_pairs"] += int(per_warp[:, 1].sum())
        if per_warp.shape[0]:
            w = int(torch.argmax(per_warp.sum(1)))
            b, p_ = (int(x) for x in per_warp[w])
            if b + p_ > self.slowest["boxes"] + self.slowest["pairs"]:
                self.slowest = dict(boxes=b, pairs=p_)

    def summary(self):
        """One line of the counts so far."""
        t = self.totals
        union = t["union_boxes"] + t["union_pairs"]
        # a warp of single-lane walks runs the union of its lanes' tests
        eff = (f", lane efficiency {(t['boxes'] + t['pairs']) / (32 * union):.3f}"
               if self.group == 1 and union else "")
        rays = max(t["rays"], 1)
        return (f"{self.order} order, {self.group} lane(s) per ray: "
                f"{t['boxes']:,} box tests, {t['pairs']:,} Möller–Trumbore "
                f"tests over {t['rays']:,} rays ({t['boxes'] / rays:.3f} and "
                f"{t['pairs'] / rays:.3f} per ray; {t['live']:,} in the root "
                f"box), warp unions {t['union_boxes']:,} and "
                f"{t['union_pairs']:,}{eff}, slowest warp {self.slowest['boxes']} "
                f"box and {self.slowest['pairs']} triangle tests, slowest ray "
                f"{self.slowest_ray['steps']} steps ({self.slowest_ray['boxes']}"
                f" box, {self.slowest_ray['pairs']} triangle tests)")


class WalkCounts:
    """Several :class:`WalkCount` on the same queries (a plain render's
    ``tri_search``); the answers are the first one's."""

    def __init__(self, *walks):
        self.walks = walks

    def closest(self, *args, **kw):
        return [w.closest(*args, **kw) for w in self.walks][0]

    def blocked(self, *args, **kw):
        return [w.blocked(*args, **kw) for w in self.walks][0]


def query_group():
    """Lanes per ray of the triangle-query kernel (csrc/tri_query.cu)."""
    path = os.path.join(os.path.dirname(os.path.abspath(pr.__file__)),
                        "csrc", "tri_query.cu")
    with open(path) as f:
        return int(re.search(r"#define QUERY_GROUP (\d+)", f.read()).group(1))


def profile_step(step, what):
    """One call of ``step`` under torch.profiler, after one unprofiled
    call: its CUDA kernel launches, the time the device was busy with them
    (the union of their intervals), the call's wall time under the
    profiler and the three kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    if not spans:
        return (f"profiled {what}: device time not measured (the "
                "profiler recorded no CUDA events)")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return (f"profiled {what}: {len(spans)} CUDA kernels, "
            f"device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"wall under the profiler ({busy / wall_us:.1%}); most device "
            "time: " + ", ".join(f"{name[:48]} {us / 1e3:.3f} ms"
                                 for name, us in top))


def agreement(got, want):
    """(share of pixels within AGREE_ABS, mean |d|, max |d|)."""
    diff = (got - want).abs()
    return (float((diff.amax(-1) < AGREE_ABS).float().mean()),
            float(diff.mean()), float(diff.max()))


class NodeCount:
    """The megakernel's DFS work per pixel and per warp, read from records
    (K5's, or its plain version's, at the same inputs; at most ``Krec``
    nodes a pixel are recorded, ``max_nodes`` is the true maximum).

    Per pixel: ``nodes`` (every recorded node) and ``solid`` (solid and
    triangle hits, the nodes that shade).  Per warp of the kernel's lane
    layout (16x16 blocks, a warp is 2 rows of 16 columns; lanes outside
    the image count 0, warps with no lane in it are left out): ``trips``,
    the most nodes of one of its lanes (a warp runs its DFS loop that
    often), and ``solid_trips``, the most solid nodes of one lane.  ``efficiency`` is the SIMT efficiency of the
    one-thread-a-pixel shading: solid nodes over 32 lanes times the warps'
    ``solid_trips``."""

    def __init__(self, records, layout, width, height):
        rec = records["rec"]
        code, written = rec & 0xFF, rec >= 0
        solid = (code < layout.n_spheres + layout.n_planes) \
            | (code == TRI_CODE)
        self.width, self.height = width, height
        self.nodes = written.sum(0).reshape(height, width).cpu()
        self.solid = (written & solid).sum(0).reshape(height, width).cpu()
        self.max_nodes = int(records["max_nodes"])

    @staticmethod
    def per_warp(counts):
        """[warps] the most of ``counts`` [H, W] over each warp's lanes,
        for the warps that hold a pixel of the image."""
        h, w = counts.shape
        hp, wp = -h % 16, -w % 16

        def lanes(x):
            x = torch.nn.functional.pad(x, (0, wp, 0, hp), value=-1)
            x = x.reshape((h + hp) // 16, 8, 2, (w + wp) // 16, 16)
            return x.permute(0, 3, 1, 2, 4).reshape(-1, 32).amax(1)

        most = lanes(counts)
        return most[lanes(torch.zeros_like(counts)) == 0]

    def summary(self, deep=40):
        trips = self.per_warp(self.nodes)
        solid_trips = self.per_warp(self.solid)
        n_pix = self.width * self.height
        rows, cols = torch.nonzero(self.nodes >= deep, as_tuple=True)
        where = (f"rows {int(rows.min())}-{int(rows.max())}, columns "
                 f"{int(cols.min())}-{int(cols.max())}" if rows.numel()
                 else "none")
        return dict(
            nodes=int(self.nodes.sum()), solid=int(self.solid.sum()),
            nodes_per_pixel=round(float(self.nodes.sum()) / n_pix, 3),
            solid_per_pixel=round(float(self.solid.sum()) / n_pix, 3),
            efficiency=round(float(self.solid.sum())
                             / max(32 * int(solid_trips.sum()), 1), 3),
            warps=trips.numel(), trips_mean=round(float(trips.float().mean()),
                                                  3),
            trips_max=int(trips.max()), warps_deep=int((trips >= deep).sum()),
            pixels_deep=int(rows.numel()), deep_where=where,
            max_nodes=self.max_nodes)


def deep_phase(tt, dev, card, scene, assets, camera):
    """Phase 19: where K1's and K5's 800x600 d15 frames spend their time.
    The whole frame, the 32-row slab of the deepest pixels (``DEEP_SLAB``:
    50 blocks that run at once) with 2 shadow samples and without, and
    K1's whole frame at depth 4, CUDA events, median of 10; a slab that
    takes most of the frame's time means the deepest pixels set it (the
    tail), not the work of all pixels, and the slab's time with samples
    less its time without is its feelers' time.  K5 less K1 at 512x384 d3
    without samples is the cost of the records.  Then the
    :class:`NodeCount` figures at 800x600 d15 and 1920x1080 d4, and the
    bounds (:func:`bound`, and its operations at ``PEAK_FP32_OPS_NO_FMA``)
    of K1 and K2 at 1920x1080 d4 and of K5 at 800x600 d15, with K5's
    time."""
    from tpuray_torch.kernels.megakernel import (render_megakernel,
                                                 render_megakernel_record)
    from tpuray_torch.utils.metrics import cuda_time_ms

    basis = tt.perspective_basis(camera, 800, 600, device=dev)
    cfg = tt.RenderConfig(width=800, height=600, max_depth=15,
                          shadow_samples=2)
    slab_rows = f"rows {DEEP_SLAB[0]}-{sum(DEEP_SLAB) - 1}"
    slab_packed = tt.pack_scene(scene, basis, DEEP_SLAB[0])
    small = tt.RenderConfig(width=512, height=384, max_depth=3,
                            shadow_samples=0)
    small_packed = tt.pack_scene(scene, tt.perspective_basis(
        camera, 512, 384, device=dev))
    runs = {"800x600 d15": (tt.pack_scene(scene, basis), cfg),
            f"{slab_rows} d15": (slab_packed,
                                 cfg.replace(height=DEEP_SLAB[1])),
            f"{slab_rows} d15 ss0": (slab_packed,
                                     cfg.replace(height=DEEP_SLAB[1],
                                                 shadow_samples=0)),
            "800x600 d4": (tt.pack_scene(scene, basis),
                           cfg.replace(max_depth=4)),
            "512x384 d3 ss0": (small_packed, small)}
    results = []
    times = {}
    for name, render in (("K1", render_megakernel),
                         ("K5", render_megakernel_record)):
        times[name] = {
            run: cuda_time_ms(lambda: render(packed, assets, c))[0]
            for run, (packed, c) in runs.items()
            if name == "K1" or run != "800x600 d4"}
        t = times[name]
        whole, slab = t["800x600 d15"], t[f"{slab_rows} d15"]
        results += [f"{name} " + ", ".join(f"{run} {ms:.4f} ms"
                                           for run, ms in t.items()),
                    f"{name} slab / whole {slab / whole:.3f}, slab ss2 - ss0 "
                    f"{slab - t[f'{slab_rows} d15 ss0']:.4f} ms"]
    k1, k5 = times["K1"], times["K5"]
    results += [f"K1 d4 / d15 {k1['800x600 d4'] / k1['800x600 d15']:.3f}",
                f"K5 - K1 at 512x384 d3 ss0 "
                f"{k5['512x384 d3 ss0'] - k1['512x384 d3 ss0']:.4f} ms "
                f"(Krec {small.resolved_record_slots()})"]
    del runs, slab_packed, small_packed
    for width, height, depth, slots in ((800, 600, 15, 64),
                                        (1920, 1080, 4, 0)):
        c = tt.RenderConfig(width=width, height=height, max_depth=depth,
                            shadow_samples=2, record_slots=slots)
        packed = tt.pack_scene(scene, tt.perspective_basis(
            camera, width, height, device=dev))
        _, recs = render_megakernel_record(packed, assets, c)
        counts = NodeCount(recs, packed.layout, width, height).summary()
        results.append(f"{width}x{height} d{depth} nodes (Krec "
                       f"{c.resolved_record_slots()}): {counts}")
        del recs
        torch.cuda.empty_cache()
    # bounds of the table's other shapes: K1 and K2 at 1920x1080 d4, K5
    # (with its time) at 800x600 d15
    for name, width, height, depth, filt, record in (
            ("K1", 1920, 1080, 4, "nearest", False),
            ("K2", 1920, 1080, 4, "bilinear", False),
            ("K5", 800, 600, 15, "nearest", True)):
        c = tt.RenderConfig(width=width, height=height, max_depth=depth,
                            shadow_samples=2, filter=filt)
        packed = tt.pack_scene(scene, tt.perspective_basis(
            camera, width, height, device=dev))
        _, recs = render_megakernel_record(packed, assets, c)
        ms, by, counts = bound(recs, packed, c, record)
        text = (f"{name} {width}x{height} d{depth}: bound {ms:.5f} ms "
                f"({by}; fp32 operations at {PEAK_FP32_OPS_NO_FMA / 1e12} T "
                f"a second without FMA: "
                f"{counts['flops'] / PEAK_FP32_OPS_NO_FMA * 1e3:.5f} ms; "
                f"{counts})")
        if record:
            text += (f", time {k5['800x600 d15']:.4f} ms (Krec "
                     f"{c.resolved_record_slots()})")
        results.append(text)
        del recs
        torch.cuda.empty_cache()
    phase(19, "deep pixels", f"{card}: " + "; ".join(results))


def mesh_phases(tt, dev, card, assets, camera, asset_args):
    """Phases 10-13, the triangle path; returns the K3 and K4 entries of
    the kernels line."""
    from tpuray_torch.apps import invrender, raypng
    from tpuray_torch.kernels.megakernel import (
        render_megakernel, render_megakernel_record,
        render_megakernel_record_reference, render_megakernel_reference)
    from tpuray_torch.meshes import mesh_benchmark_scene
    from tpuray_torch.utils.metrics import cuda_time_ms

    specs = {key: mesh_benchmark_scene(order, res) for key, (order, res) in
             (("k3", MESH_K3), ("4k", MESH_4K), ("k4", MESH_K4))}
    scenes = {key: tt.build_scene(spec, dev) for key, spec in specs.items()}
    n_tris = {key: scene.num_triangles for key, scene in scenes.items()}

    def inputs(key, width, height, depth, rows=None, row0=0):
        cfg = tt.RenderConfig(width=width, height=rows or height,
                              max_depth=depth, shadow_samples=2)
        basis = tt.perspective_basis(camera, width, height, device=dev)
        return tt.pack_scene(scenes[key], basis, row0), cfg, basis

    def where(key, cfg, row0):
        rows = (f" rows {row0}-{row0 + cfg.height - 1}" if row0 else "")
        return (f"{n_tris[key]:,} triangles, {cfg.width}x{cfg.height} "
                f"d{cfg.max_depth} ss{cfg.shadow_samples}{rows}")

    # -- 10. the triangle kernel against its brute-force plain version --
    max_err, images, results = {}, {}, []
    for key, rows, row0 in (("k3", None, 0), ("k4", K4_SLAB[1], K4_SLAB[0])):
        packed, cfg, _ = inputs(key, 512, 384, 3, rows, row0)
        before = render_megakernel.launches
        got = render_megakernel(packed, assets, cfg)
        torch.cuda.synchronize()
        if render_megakernel.launches != before + 1:
            raise RuntimeError("the wrapper did not count its launch")
        want = render_megakernel_reference(packed, assets, cfg)
        _, recs = render_megakernel_record(packed, assets, cfg)
        tri_nodes = int(((recs["rec"] & 0xFF) == TRI_CODE).sum())
        if got.shape != (cfg.height, 512, 3) \
                or not bool(torch.isfinite(got).all()):
            raise RuntimeError("mesh kernel output is not finite or has the "
                               "wrong shape")
        agree, mean, max_err[key] = agreement(got, want)
        images[key] = got
        results.append(f"{where(key, cfg, row0)}: {agree:.6f} of pixels "
                       f"within {AGREE_ABS}, mean|d| {mean:.3g}, max|d| "
                       f"{max_err[key]:.3g}, {tri_nodes} triangle nodes")
        if agree < AGREE_FRAC or mean >= MEAN_ABS or tri_nodes == 0:
            raise RuntimeError("mesh kernel disagrees with the plain "
                               "version: " + results[-1])
    phase(10, "mesh kernel vs plain", "; ".join(results))

    # -- 11. K5 on mesh scenes: records, replay, gradient --
    results = []
    for key, width, height, rows, row0 in (
            ("k3", 128, 96, None, 0), ("k4", 512, 384, K4_SLAB[1],
                                       K4_SLAB[0])):
        packed, cfg, basis = inputs(key, width, height, 3, rows, row0)
        img, rec = render_megakernel_record(packed, assets, cfg)
        want, plain = render_megakernel_record_reference(packed, assets, cfg)
        base = render_megakernel(packed, assets, cfg)
        same = {k: float((rec[k] == plain[k]).all(0).float().mean())
                for k in ("rec", "wid", "pick")}
        ssr_err = float((rec["ssr"] - plain["ssr"]).abs().max())
        nodes = (int(rec["max_nodes"]), int(plain["max_nodes"]))
        base_agree, base_mean, _ = agreement(img, base)
        plain_agree, plain_mean, _ = agreement(img, want)
        rep = tt.replay_render(scenes[key], assets, basis, rec, cfg, row0)
        d = (rep - img).abs()
        results.append(
            f"{where(key, cfg, row0)}: records equal on {same['rec']:.6f}, "
            f"triangle ids on {same['wid']:.6f}, picks on "
            f"{same['pick']:.6f} of pixels, ssr max|d| {ssr_err:.3g}, "
            f"max_nodes {nodes[0]} (plain {nodes[1]}), image vs plain "
            f"{plain_agree:.6f} within {AGREE_ABS}, vs K1 {base_agree:.6f}; "
            f"replay vs K5 mean|d| {float(d.mean()):.3g}, max|d| "
            f"{float(d.max()):.3g}")
        if min(same.values()) < AGREE_FRAC or ssr_err > SSR_ABS \
                or nodes[0] != nodes[1] or min(base_agree, plain_agree) \
                < AGREE_FRAC or max(base_mean, plain_mean) >= MEAN_ABS \
                or float(d.mean()) >= TRI_REPLAY_MEAN \
                or float(d.max()) >= TRI_REPLAY_MAX:
            raise RuntimeError("record kernel on a mesh disagrees: "
                               + results[-1])
    grads = {}
    width, height = 64, 48
    for place in (dev, torch.device("cpu")):
        g_scene = scenes["k3"].to(place)
        basis = tt.perspective_basis(camera, width, height, device=place)
        cfg = tt.RenderConfig(width=width, height=height, max_depth=3,
                              shadow_samples=2)
        diff, rest = tt.partition(g_scene)
        leaves = {k: v.clone().requires_grad_() for k, v in diff.items()}
        gen = torch.Generator().manual_seed(0)
        w = torch.rand(height, width, 3, generator=gen).to(place)
        img = tt.render_megakernel_diff(tt.combine(leaves, rest),
                                        assets.to(place), basis, cfg)
        g = torch.autograd.grad((img * w).sum(), list(leaves.values()))
        grads[place.type] = dict(zip(leaves, (x.cpu() for x in g)))
    worst = {}
    for name, ours in grads["cuda"].items():
        want = grads["cpu"][name]
        if not bool(torch.isfinite(ours).all()):
            raise RuntimeError(f"gradient of {name} is not finite")
        scale = max(float(want.abs().max()), 1e-3)
        worst[name] = float((ours - want).abs().max()) / scale
        if worst[name] > GRAD_ATOL:
            raise RuntimeError(f"gradient of {name} on the card is "
                               f"{worst[name]:.3g} * max|g| off the CPU's")
    for name in ("tri_v0", "tri_v1", "tri_v2", "tri_mat.diffuse"):
        if not float(grads["cuda"][name].abs().sum()) > 0:
            raise RuntimeError(f"no gradient reaches {name}")
    tri_worst = max(v for k, v in worst.items() if k.startswith("tri_"))
    results.append(
        f"gradient {where('k3', cfg, 0)} on the card vs the CPU: worst leaf "
        f"max|d| {max(worst.values()):.3g} * max|g|, worst triangle leaf "
        f"{tri_worst:.3g} (bar {GRAD_ATOL}), all finite, tri_v0/1/2 and "
        "tri_mat.diffuse non-zero")
    phase(11, "mesh record kernel, replay and gradient", "; ".join(results))

    # -- 12. the raypng path on mesh archives --
    launches, results = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for key in ("k3", "k4"):
            path = os.path.join(tmp, f"mesh_{key}.map")
            tt.dump_scene(path, specs[key])
            out = os.path.join(tmp, f"mesh_{key}.png")
            argv = ["--scene", path, "--width", "512", "--height", "384",
                    "--depth", "3", "--device", "cuda", "--selfcheck",
                    "--out", out] + asset_args
            render_megakernel.launches = 0
            render_megakernel_record.launches = 0
            t0 = time.perf_counter()
            res = raypng.main(argv)
            wall = time.perf_counter() - t0
            launches[key] = render_megakernel.launches
            if launches[key] != 1 or render_megakernel_record.launches:
                raise RuntimeError(f"raypng on the {key} mesh archive made "
                                   f"{launches[key]} kernel launches")
            rgb = res["rgb"]
            if rgb.device.type != "cuda" or rgb.shape != (384, 512, 3) \
                    or not bool(torch.isfinite(rgb).all()):
                raise RuntimeError("raypng's mesh image is not a finite "
                                   "384x512x3 CUDA tensor")
            if not (tt.read_png(out) == res["image"]).all():
                raise RuntimeError("the written PNG differs from the render")
            # the archive stores f32 vertices: the same image as phase 10's
            row0 = 0 if key == "k3" else K4_SLAB[0]
            agree, mean, _ = agreement(
                rgb[row0:row0 + images[key].shape[0]], images[key])
            results.append(f"{n_tris[key]:,} triangles: 512x384 d3, "
                           f"{launches[key]} kernel launch, {res['report']}; "
                           f"whole run {wall:.3f} s; phase 10's rows agree "
                           f"on {agree:.6f} of pixels")
            if agree < AGREE_FRAC or mean >= MEAN_ABS:
                raise RuntimeError("raypng's mesh image differs from the "
                                   "kernel's: " + results[-1])
        steps = MESH_INVRENDER_STEPS
        argv = ["--scene", os.path.join(tmp, "mesh_k3.map"), "--steps",
                str(steps), "--width", "128", "--height", "96", "--depth",
                "3", "--device", "cuda", "--every", "5", "--checkpoint",
                os.path.join(tmp, "mesh.pt")] + asset_args
        render_megakernel.launches = 0
        render_megakernel_record.launches = 0
        res = invrender.main(argv)
        k5_launches = render_megakernel_record.launches
        losses = res["losses"]
        results.append(
            f"invrender on the {n_tris['k3']:,}-triangle archive: 128x96 d3 "
            f"ss0, {steps} steps, {k5_launches} record kernel launches, "
            f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
            f"{res['train_seconds'] / res['steps'] * 1e3:.1f} ms per step "
            "(host clock, first step included)")
        if k5_launches < steps + 1 or render_megakernel.launches \
                or not losses[-1] < losses[0] \
                or not all(bool(torch.isfinite(v).all())
                           for v in res["params"].values()):
            raise RuntimeError("invrender on a mesh archive failed: "
                               + results[-1])
    phase(12, "raypng and invrender on mesh archives", "; ".join(results))

    # -- 13. times and bounds --
    entries, walked, results = {}, {}, []
    for key, width, height, depth, slab in (
            ("k3", 512, 384, 3, None), ("4k", 3840, 2160, 6, SLAB_4K),
            ("k4", 512, 384, 3, K4_SLAB)):
        packed, cfg, _ = inputs(key, width, height, depth)
        kernel_ms = cuda_time_ms(lambda: render_megakernel(packed, assets,
                                                           cfg))[0]
        walks = walked[key] = TreeSearch(packed.tris)
        img = render_megakernel_reference(packed, assets, cfg,
                                          tri_search=walks)
        agree, mean, _ = agreement(render_megakernel(packed, assets, cfg),
                                   img)
        if agree < AGREE_FRAC or mean >= MEAN_ABS:
            raise RuntimeError(f"the tree search disagrees with the kernel "
                               f"({agree:.6f} within {AGREE_ABS})")
        _, recs = render_megakernel_record(packed, assets, cfg)
        bound_ms, bound_by, counts = bound(recs, packed, cfg, False, walks)
        del recs, img
        text = (f"{where(key, cfg, 0)}: kernel {kernel_ms:.4f} ms "
                f"({width * height / kernel_ms / 1e3:.2f} Mrays/s), bound "
                f"{bound_ms:.5f} ms ({bound_by}; {counts})")
        # the walk as the kernel walks it (16x2-pixel warps), and the id
        # order it replaced; on the 4K frame, on the slab
        rows, row0 = (slab[1], slab[0]) if slab else (None, 0)
        cpacked, ccfg, _ = inputs(key, width, height, depth, rows, row0)
        walk_counts = WalkCounts(*(WalkCount(packed.tris, order,
                                             width=width)
                                   for order in ("nearest", "id")))
        img = render_megakernel_reference(cpacked, assets, ccfg,
                                          tri_search=walk_counts)
        agree, _, _ = agreement(render_megakernel(cpacked, assets, ccfg), img)
        if agree < AGREE_FRAC:
            raise RuntimeError(f"the walk's count disagrees with the kernel "
                               f"({agree:.6f} within {AGREE_ABS})")
        text += (f"; the walk on {where(key, ccfg, row0)}: " + "; ".join(
            w.summary() for w in walk_counts.walks))
        del img
        if slab is None:
            plain_ms = cuda_time_ms(lambda: render_megakernel_reference(
                packed, assets, cfg), warmup=0, iters=1)[0]
            text += f", plain {plain_ms:.1f} ms (one run)"
        else:
            spacked, scfg, _ = inputs(key, width, height, depth, slab[1],
                                      slab[0])
            plain_ms = cuda_time_ms(lambda: render_megakernel_reference(
                spacked, assets, scfg), warmup=0, iters=1)[0]
            slab_ms = cuda_time_ms(lambda: render_megakernel(
                spacked, assets, scfg))[0]
            text += (f"; on {where(key, scfg, slab[0])}: plain "
                     f"{plain_ms:.1f} ms (one run), kernel {slab_ms:.4f} ms")
        results.append(text)
        entries[key] = (kernel_ms, plain_ms, bound_ms, bound_by)
        torch.cuda.empty_cache()
    # K5 on the K3 cell: the same walks, plus the records
    packed, cfg, _ = inputs("k3", 512, 384, 3)
    k5_ms = cuda_time_ms(lambda: render_megakernel_record(packed, assets,
                                                          cfg))[0]
    k5_plain_ms = cuda_time_ms(lambda: render_megakernel_record_reference(
        packed, assets, cfg), warmup=0, iters=1)[0]
    _, recs = render_megakernel_record(packed, assets, cfg)
    k5_bound, k5_by, _ = bound(recs, packed, cfg, True, walked["k3"])
    results.append(f"K5 {where('k3', cfg, 0)}: {k5_ms:.4f} ms, plain "
                   f"{k5_plain_ms:.1f} ms (one run), bound {k5_bound:.5f} ms "
                   f"({k5_by})")
    phase(13, "mesh timing", f"{card}: " + "; ".join(results))

    def entry(key, name, err):
        kernel_ms, plain_ms, bound_ms, bound_by = entries[key]
        return {"name": name, "route": "cuda",
                "source": "tpuray_torch/kernels/csrc/megakernel.cu",
                "replaces": "tpuray/kernels/pallas_trace.py:"
                            + ("1196" if key == "k3" else "816"),
                "launches": launches[key], "max_abs_err": err,
                "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    k3 = entry("k3", "megakernel_triangles_resident", max_err["k3"])
    k3["shape"] = f"512x384 d3 ss2, {n_tris['k3']:,} triangles"
    k4 = entry("k4", "megakernel_triangles_streamed", max_err["k4"])
    k4["shape"] = (f"512x384 d3 ss2, {n_tris['k4']:,} triangles; plain_ms "
                   f"on rows {K4_SLAB[0]}-{sum(K4_SLAB) - 1}")
    return k3, k4, specs, scenes


def ptxas_figures(log):
    """'name: R registers, F B frame, S B spills' of each kernel entry in
    the build log, the template arguments of ``megakernel<RECORD, TRIS,
    BILINEAR>`` written out."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            args = re.findall(r"Lb([01])E", name.split("EEv")[0] + "E")
            base = re.sub(r"^_Z\d+", "", name).split("I")[0].split("4Tris")[0]
            name = f"{base}<{','.join(args)}>" if args else base
            frame = spills = "?"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            frame, spills = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {frame} B frame, "
                       f"{spills} B spills")
            name = None
    return out


def bilinear_phases(tt, dev, card, scene, assets, camera, lib_log):
    """Phases 14-15, bilinear filtering (K2) and its records; returns the
    kernels-line entries of K2 and of K5 with bilinear records."""
    from tpuray_torch.kernels.megakernel import (
        render_megakernel, render_megakernel_record,
        render_megakernel_record_reference, render_megakernel_reference)
    from tpuray_torch.utils.metrics import cuda_time_ms

    def inputs(width, height, depth, samples=2, rows=None, row0=0, **kw):
        cfg = tt.RenderConfig(width=width, height=rows or height,
                              max_depth=depth, shadow_samples=samples,
                              filter="bilinear", **kw)
        basis = tt.perspective_basis(camera, width, height, device=dev)
        return tt.pack_scene(scene, basis, row0), cfg, basis

    # -- 14. K2 against its plain version (200x50: lanes outside the image;
    #    the deep slab), the render() path, times --
    results, k2_err = [], 0.0
    for width, height, depth, rows, row0 in (
            (256, 64, 3, None, 0), (200, 50, 6, None, 0),
            (800, 600, 15, DEEP_SLAB[1], DEEP_SLAB[0]),
            (800, 600, 15, None, 0)):
        packed, cfg, _ = inputs(width, height, depth, rows=rows, row0=row0)
        before = render_megakernel.bilinear_launches
        got = render_megakernel(packed, assets, cfg)
        torch.cuda.synchronize()
        if render_megakernel.bilinear_launches != before + 1:
            raise RuntimeError("the wrapper did not count its bilinear launch")
        want = render_megakernel_reference(packed, assets, cfg)
        nearest = render_megakernel(packed, assets,
                                    cfg.replace(filter="nearest"))
        agree, mean, err = agreement(got, want)
        k2_err = max(k2_err, err)
        moved = float((got - nearest).abs().max())
        slab = f" rows {row0}-{row0 + rows - 1}" if rows else ""
        results.append(f"{width}x{height}{slab} d{depth}: {agree:.6f} of "
                       f"pixels within {AGREE_ABS}, mean|d| {mean:.3g}, max|d| "
                       f"{err:.3g}; vs nearest max|d| {moved:.3g}")
        if agree < AGREE_FRAC or mean >= MEAN_ABS or moved <= 1e-3 \
                or not bool(torch.isfinite(got).all()):
            raise RuntimeError("bilinear kernel disagrees with the plain "
                               "version: " + results[-1])
    cfg = tt.RenderConfig(width=800, height=600, max_depth=15,
                          shadow_samples=2, filter="bilinear")
    render_megakernel.launches = render_megakernel.bilinear_launches = 0
    render_megakernel_record.launches = 0
    rgb = tt.render(scene, assets, camera, cfg)
    torch.cuda.synchronize()
    k2_launches = render_megakernel.bilinear_launches
    if k2_launches != 1 or render_megakernel.launches != 1 \
            or render_megakernel_record.launches \
            or not bool(torch.isfinite(rgb).all()):
        raise RuntimeError(f"render(filter='bilinear') made {k2_launches} "
                           "bilinear launches")
    times = {}
    for width, height, depth in ((800, 600, 15), (1920, 1080, 4)):
        packed, cfg, _ = inputs(width, height, depth)
        for filt in ("nearest", "bilinear"):
            times[(width, height, depth, filt)] = cuda_time_ms(
                lambda: render_megakernel(packed, assets,
                                          cfg.replace(filter=filt)))[0]
    packed, cfg, _ = inputs(800, 600, 15)
    k2_plain_ms = cuda_time_ms(lambda: render_megakernel_reference(
        packed, assets, cfg), warmup=0, iters=1)[0]
    _, recs = render_megakernel_record(packed, assets,
                                       cfg.replace(record_slots=64))
    k2_bound, k2_by, k2_counts = bound(recs, packed, cfg, False)
    del recs
    results.append(f"render(filter='bilinear') 800x600 d15: {k2_launches} "
                   "bilinear launch")
    results.append("; ".join(
        f"{w}x{h} d{d} {'K2' if f == 'bilinear' else 'K1'} {ms:.4f} ms"
        for (w, h, d, f), ms in times.items()))
    results.append(f"K2 800x600 d15 plain {k2_plain_ms:.1f} ms (one run), "
                   f"bound {k2_bound:.5f} ms ({k2_by}; {k2_counts})")
    results.append("ptxas of the bilinear instantiations: " + " | ".join(
        f for f in ptxas_figures(lib_log) if f.startswith("megakernel")
        and f.split(">")[0].endswith(("<1", ",1"))))
    phase(14, "bilinear kernel", f"{card}: " + "; ".join(results))

    # -- 15. K5 with bilinear records, the replay, the gradient --
    results, k5b_err = [], 0.0
    for width, height, depth, samples in ((256, 64, 3, 2), (128, 96, 3, 0)):
        packed, cfg, basis = inputs(width, height, depth, samples)
        img, rec = render_megakernel_record(packed, assets, cfg)
        want, plain = render_megakernel_record_reference(packed, assets, cfg)
        base = render_megakernel(packed, assets, cfg)
        n_pix = width * height
        if rec["pick"].shape != (cfg.resolved_record_slots(), 4, n_pix):
            raise RuntimeError("bilinear picks have the wrong shape")
        same = {k: float((rec[k] == plain[k]).reshape(-1, n_pix).all(0)
                         .float().mean()) for k in ("rec", "wid", "pick")}
        ssr_err = float((rec["ssr"] - plain["ssr"]).abs().max())
        k5b_err = max(k5b_err, float((img - want).abs().max()))
        nodes = (int(rec["max_nodes"]), int(plain["max_nodes"]))
        # the replay's bar on the pixels whose recomputed path stays
        # within a texel of the kernel's: after a long chain of curved
        # reflections a few land further and weight their recorded texels
        # otherwise (2 of 16,384 at 256x64 d3 on the card, none on the
        # CPU); the JAX replay on the same records misses on such pixels
        # too (tests/test_torch_bilinear.py, 800x600 d6 rows 376-385)
        rep = tt.replay_render(scene, assets, basis, rec, cfg)
        d = (rep - img).abs()
        near = float((d.amax(-1) < REPLAY_MAX).float().mean())
        results.append(
            f"{width}x{height} d{depth} ss{samples}: records equal on "
            f"{same['rec']:.6f}, picks (4 per fetch) on {same['pick']:.6f} "
            f"of pixels, ssr max|d| {ssr_err:.3g}, max_nodes {nodes[0]} "
            f"(plain {nodes[1]}), image = K2's: {torch.equal(img, base)}; "
            f"replay vs K5 mean|d| {float(d.mean()):.3g}, max|d| "
            f"{float(d.max()):.3g}, {near:.6f} of pixels within "
            f"{REPLAY_MAX}")
        if min(same.values()) < AGREE_FRAC or ssr_err > SSR_ABS \
                or nodes[0] != nodes[1] or not torch.equal(img, base) \
                or float(d.mean()) >= REPLAY_MEAN or near < AGREE_FRAC:
            raise RuntimeError("bilinear records disagree: " + results[-1])
    grads, width, height = {}, 64, 48
    for place in (dev, torch.device("cpu")):
        g_scene = scene.to(place)
        basis = tt.perspective_basis(camera, width, height, device=place)
        cfg = tt.RenderConfig(width=width, height=height, max_depth=3,
                              shadow_samples=2, filter="bilinear")
        diff, rest = tt.partition(g_scene)
        leaves = {k: v.clone().requires_grad_() for k, v in diff.items()}
        gen = torch.Generator().manual_seed(0)
        w = torch.rand(height, width, 3, generator=gen).to(place)
        if place.type == "cuda":   # the bilinear gradient's path
            render_megakernel_record.launches = 0
            render_megakernel_record.bilinear_launches = 0
        img = tt.render_megakernel_diff(tt.combine(leaves, rest),
                                        assets.to(place), basis, cfg)
        g = torch.autograd.grad((img * w).sum(), list(leaves.values()))
        if place.type == "cuda":
            k5b_launches = render_megakernel_record.bilinear_launches
        grads[place.type] = dict(zip(leaves, (x.cpu() for x in g)))
    worst = 0.0
    for name, ours in grads["cuda"].items():
        want = grads["cpu"][name]
        if not bool(torch.isfinite(ours).all()):
            raise RuntimeError(f"bilinear gradient of {name} is not finite")
        if want.numel():
            err = float((ours - want).abs().max()) / max(
                float(want.abs().max()), 1e-3)
            worst = max(worst, err)
            if err > GRAD_ATOL:
                raise RuntimeError(f"bilinear gradient of {name} on the card "
                                   f"is {err:.3g} * max|g| off the CPU's")
    spatial = float(grads["cuda"]["plane_point"].abs().sum())
    if k5b_launches != 1 or not spatial > 0:
        raise RuntimeError(f"render_megakernel_diff(filter='bilinear') made "
                           f"{k5b_launches} launches; |d plane_point| "
                           f"{spatial}")
    packed, cfg, _ = inputs(128, 96, 3, 0)
    k5b_ms = cuda_time_ms(lambda: render_megakernel_record(packed, assets,
                                                           cfg))[0]
    k5b_plain_ms = cuda_time_ms(lambda: render_megakernel_record_reference(
        packed, assets, cfg), warmup=0, iters=1)[0]
    _, recs = render_megakernel_record(packed, assets, cfg)
    k5b_bound, k5b_by, _ = bound(recs, packed, cfg, True)
    results.append(
        f"gradient {width}x{height} d3 ss2 through {k5b_launches} bilinear "
        f"K5 launch: card vs CPU worst leaf {worst:.3g} * max|g| (bar "
        f"{GRAD_ATOL}), sum|d plane_point| {spatial:.4g}; K5 bilinear "
        f"128x96 d3 ss0 {k5b_ms:.4f} ms, plain {k5b_plain_ms:.1f} ms (one "
        f"run), bound {k5b_bound:.5f} ms ({k5b_by})")
    phase(15, "bilinear records, replay and gradient",
          f"{card}: " + "; ".join(results))
    source = "tpuray_torch/kernels/csrc/megakernel.cu"
    return ({"name": "megakernel_bilinear", "route": "cuda",
             "source": source,
             "replaces": "tpuray/kernels/pallas_trace.py:1882",
             "launches": k2_launches, "max_abs_err": k2_err,
             "ms": times[(800, 600, 15, "bilinear")],
             "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
             "bound_by": k2_by, "library_ms": None,
             "shape": "800x600 d15 ss2"},
            {"name": "megakernel_record_bilinear", "route": "cuda",
             "source": source,
             "replaces": "tpuray/kernels/pallas_trace.py:2665",
             "launches": k5b_launches, "max_abs_err": k5b_err,
             "ms": k5b_ms, "plain_ms": k5b_plain_ms, "bound_ms": k5b_bound,
             "bound_by": k5b_by, "library_ms": None,
             "shape": "128x96 d3 ss0; launches: one bilinear gradient"})


def query_checks(tables, o, d):
    """K6 against its plain version on the rays (o, d), the blocker tests
    with ranges past or short of the closest hits (``query_tmax``):
    (tmax, max |t - t_plain| over hits, a summary); raises on a
    disagreement: another hit set, t beyond 1e-6 relative, another winner,
    another blocked flag, another count where not blocked."""
    from tpuray_torch.kernels import query

    t, wid = query.tri_query_closest(tables, o, d)
    t_ref, wid_ref = query.tri_query_closest_reference(tables, o, d)
    tmax = query_tmax(t_ref)
    hit = torch.isfinite(t_ref)
    if not torch.equal(torch.isfinite(t), hit):
        raise RuntimeError("K6 closest: another hit set than the plain "
                           "version's")
    err = float((t - t_ref)[hit].abs().max()) if bool(hit.any()) else 0.0
    rel = (float(((t - t_ref).abs() / t_ref.abs())[hit].max())
           if bool(hit.any()) else 0.0)
    if rel > 1e-6 or not torch.equal(wid, wid_ref):
        raise RuntimeError(f"K6 closest: t {rel:.3g} relative off, or other "
                           "winners")
    text = [f"{o.shape[0]:,} rays, {int(hit.sum()):,} hits, t max "
            f"{rel:.3g} relative, ids equal"]
    for inclusive in (False, True):
        blocked, count = query.tri_query_blocker(tables, o, d, tmax,
                                                 inclusive)
        b_ref, c_ref = query.tri_query_blocker_reference(tables, o, d, tmax,
                                                         inclusive)
        if not torch.equal(blocked, b_ref) \
                or not torch.equal(count[~b_ref], c_ref[~b_ref]):
            raise RuntimeError(f"K6 blocker (inclusive={inclusive}) "
                               "disagrees with the plain version")
        text.append(f"{'inclusive' if inclusive else 'strict'} blocker: "
                    f"{int(blocked.sum()):,} blocked, equal")
    torch.cuda.synchronize()
    return tmax, err, ", ".join(text)


def query_rays(tables, n, seed=7):
    """n rays from random origins, every other one aimed near a random
    triangle's centre, every 37th with a zero direction."""
    gen = torch.Generator().manual_seed(seed)
    dev = tables.geom.device
    o = (torch.rand(n, 3, generator=gen) * 6.0 - 3.0).to(dev)
    d = torch.randn(n, 3, generator=gen).to(dev)
    centre = tables.v0 + (tables.e1 + tables.e2) / 3.0
    pick = torch.randint(0, tables.n, (n // 2,), generator=gen).to(dev)
    d[1::2] = centre[pick] - o[1::2] + 0.05 * torch.randn(
        n // 2, 3, generator=gen).to(dev)
    d[::37] = 0.0
    return o.contiguous(), d.contiguous()


def query_tmax(t):
    """Blocker ranges past or short of the closest hits t (4 on a miss),
    every 11th ray inactive (0)."""
    scale = torch.where(torch.arange(t.shape[0], device=t.device) % 4 < 2,
                        torch.full_like(t, 1.5), torch.full_like(t, 0.5))
    tmax = torch.where(torch.isfinite(t), t * scale, torch.full_like(t, 4.0))
    tmax[::11] = 0.0
    return tmax.contiguous()


def query_phase(tt, dev, card, scenes, camera):
    """Phase 16: K6 against its plain version, times and bounds; returns
    the closest and blocker entries (launches filled in by phase 17)."""
    from tpuray_torch.kernels import query
    from tpuray_torch.kernels.triblocks import build_query_tables
    from tpuray_torch.utils.metrics import cuda_time_ms

    results, entries, err = [], {}, 0.0
    basis = tt.perspective_basis(camera, 512, 384, device=dev)
    po, pd = (x.contiguous() for x in tt.generate_rays(basis, 512, 384))
    for key in ("k3", "k4"):
        scene = scenes[key]
        tables = build_query_tables(scene.tri_v0, scene.tri_v1, scene.tri_v2,
                                    scene.tri_mat.transparent)
        for what, (o, d) in (("random", query_rays(tables,
                                                   QUERY_RANDOM_RAYS)),
                             ("512x384 primary", (po, pd))):
            tmax, e, text = query_checks(tables, o, d)
            err = max(err, e)
            results.append(f"{tables.n:,} triangles, {what}: {text}")
        timed = {}
        for mode, kernel, plain, args in (
                ("closest", query.tri_query_closest,
                 query.tri_query_closest_reference, (po, pd)),
                ("blocker", query.tri_query_blocker,
                 query.tri_query_blocker_reference, (po, pd, tmax))):
            ms = cuda_time_ms(lambda: kernel(tables, *args))[0]
            # the plain version is timed where the entries are (7,424)
            plain_ms = (cuda_time_ms(lambda: plain(tables, *args), warmup=0,
                                     iters=1)[0] if key == "k3" else None)
            walks = TreeSearch(tables)
            # the walk as the kernel walks it, and as the one-thread,
            # id-order walk it replaced did
            kernel_walks = (WalkCount(tables, "nearest", query_group()),
                            WalkCount(tables, "id", 1))
            if mode == "closest":
                inf = torch.full_like(tmax, float("inf"))
                for w in (walks, *kernel_walks):
                    w.closest(po, pd, -inf, inf)
            else:
                for w in (walks, *kernel_walks):
                    w.blocked(po, pd, tmax)
            flops = walks.boxes * BOX_FLOPS + walks.pairs * MT_FLOPS
            nbytes = po.shape[0] * QUERY_RAY_BYTES[mode] + 4 * (
                tables.geom.numel() + tables.node.numel())
            t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            timed[mode] = (ms, plain_ms, bound_ms, bound_by)
            plain_text = (f", plain {plain_ms:.1f} ms (one run)"
                          if plain_ms else "")
            results.append(
                f"{tables.n:,} triangles, {mode} on 512x384 primary rays: "
                f"kernel {ms:.4f} ms{plain_text}, bound {bound_ms:.5f} ms "
                f"({bound_by}; {walks.boxes:,} box tests, {walks.pairs:,} "
                "pairs with the final bound); the walk: " + "; ".join(
                    w.summary() for w in kernel_walks))
        entries[key] = timed
        torch.cuda.empty_cache()
    phase(16, "triangle-query kernel vs plain", f"{card}: "
          + "; ".join(results))
    out = []
    for mode in ("closest", "blocker"):
        ms, plain_ms, bound_ms, bound_by = entries["k3"][mode]
        out.append({"name": f"tri_query_{mode}", "route": "cuda",
                    "source": "tpuray_torch/kernels/csrc/tri_query.cu",
                    "replaces": "tpuray/kernels/pallas_trace.py:2766",
                    "launches": None, "max_abs_err": err if mode ==
                    "closest" else 0.0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None,
                    "shape": "7,424 triangles, 512x384 primary rays"})
    return out


def tracer_phases(tt, dev, card, scene, assets, camera, mesh_specs,
                  mesh_scenes, app_inputs, asset_args, query_entries):
    """Phases 17-18: the tracer engine on the card, its apps; fills in the
    triangle-query kernel's launches on the tracer's mesh render."""
    import warnings

    from tpuray_torch.apps import invrender, raypng
    from tpuray_torch.kernels import query
    from tpuray_torch.kernels.megakernel import (render_megakernel,
                                                 render_megakernel_record)
    from tpuray_torch.kernels.triblocks import build_query_tables
    from tpuray_torch.meshes import mesh_benchmark_scene

    def reset():
        render_megakernel.launches = render_megakernel_record.launches = 0
        query.tri_query_closest.launches = 0
        query.tri_query_blocker.launches = 0

    def counts():
        torch.cuda.synchronize()
        return (render_megakernel.launches + render_megakernel_record.launches,
                query.tri_query_closest.launches,
                query.tri_query_blocker.launches)

    # -- 17. render(engine='tracer'), raypng --engine tracer, above the cap --
    results = []
    cfg = tt.RenderConfig(width=512, height=384, max_depth=3,
                          shadow_samples=2)
    for name, s in (("canonical", scene), ("7,424 triangles",
                                           mesh_scenes["k3"])):
        reset()
        t0 = time.perf_counter()
        img = tt.render(s, assets, camera, cfg.replace(engine="tracer"))
        mega, closest, blocker = counts()
        wall = time.perf_counter() - t0
        want = tt.render(s, assets, camera, cfg.replace(engine="megakernel"))
        diff = (img - want).abs().amax(-1)
        within = float((diff < TRACER_AGREE_ABS).float().mean())
        results.append(f"{name} 512x384 d3: tracer {wall:.3f} s (host "
                       f"clock), {closest} closest and {blocker} blocker "
                       f"query launches, {mega} megakernel launches; "
                       f"{within:.6f} of pixels within {TRACER_AGREE_ABS} "
                       "of the megakernel's")
        wants_k6 = s.num_triangles > 0
        if mega or within < TRACER_AGREE_FRAC \
                or bool(closest and blocker) != wants_k6 \
                or not bool(torch.isfinite(img).all()):
            raise RuntimeError("the tracer engine failed: " + results[-1])
        if wants_k6:
            for entry, n in zip(query_entries, (closest, blocker)):
                entry["launches"] = n
                entry["shape"] += ("; launches: render(engine='tracer') at "
                                   "512x384 d3")
            results.append(profile_step(
                lambda: tt.render(s, assets, camera,
                                  cfg.replace(engine="tracer")),
                f"tracer render, {name} 512x384 d3"))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tracer.png")
        argv = ["--width", "800", "--height", "600", "--depth", "15",
                "--device", "cuda", "--engine", "tracer", "--selfcheck",
                "--out", out] + app_inputs
        reset()
        t0 = time.perf_counter()
        res = raypng.main(argv)
        wall = time.perf_counter() - t0
        mega, _, _ = counts()
        k1 = tt.quantize_image(tt.render(
            scene, assets, camera, tt.RenderConfig(engine="megakernel")),
            800, 600).cpu().numpy()
        stats = tt.image_diff_stats(res["image"], k1)
        results.append(f"raypng --engine tracer 800x600 d15: whole run "
                       f"{wall:.3f} s, {res['report']}, {mega} megakernel "
                       f"launches; vs K1's image {stats}")
        if mega or stats.frac_within_1 <= U8_WITHIN_1 \
                or stats.mean_abs >= U8_MEAN:
            raise RuntimeError("raypng --engine tracer failed: "
                               + results[-1])
    t0 = time.perf_counter()
    order, res_ = MESH_ABOVE_CAP
    big = tt.build_scene(mesh_benchmark_scene(order, torus_res=res_), dev)
    build_s = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        img = tt.render(big, assets, camera, cfg)
    mega, closest, blocker = counts()
    wall = time.perf_counter() - t0
    warned = any(issubclass(w.category, RuntimeWarning) for w in caught)
    tables = build_query_tables(big.tri_v0, big.tri_v1, big.tri_v2,
                                big.tri_mat.transparent)
    basis = tt.perspective_basis(camera, 512, 384, device=dev)
    o, d = tt.generate_rays(basis, 512, 384)
    step = o.shape[0] // ABOVE_CAP_CHECK_RAYS
    o, d = o[::step].contiguous(), d[::step].contiguous()
    _, _, text = query_checks(tables, o, d)
    results.append(f"{big.num_triangles:,} triangles (built in {build_s:.1f} "
                   f"s), engine='auto' 512x384 d3: RuntimeWarning {warned}, "
                   f"tracer {wall:.3f} s, {closest} closest and {blocker} "
                   f"blocker query launches, {mega} megakernel launches; K6 "
                   f"vs plain on {text}")
    if not warned or mega or not (closest and blocker) \
            or not bool(torch.isfinite(img).all()):
        raise RuntimeError("the scene above the cap did not go through the "
                           "tracer: " + results[-1])
    del big, tables, img
    torch.cuda.empty_cache()
    phase(17, "tracer engine", f"{card}: " + "; ".join(results))

    # -- 18. invrender --engine tracer --
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        mesh_path = os.path.join(tmp, "mesh_k3.map")
        tt.dump_scene(mesh_path, mesh_specs["k3"])
        for what, steps, scene_args in (
                ("canonical", TRACER_INVRENDER_STEPS, app_inputs),
                ("7,424-triangle archive", TRACER_MESH_STEPS,
                 ["--scene", mesh_path] + asset_args)):
            argv = ["--engine", "tracer", "--steps", str(steps), "--width",
                    "128", "--height", "96", "--depth", "3", "--device",
                    "cuda", "--every", "5", "--checkpoint",
                    os.path.join(tmp, "tracer.pt")] + scene_args
            reset()
            res = invrender.main(argv)
            mega, closest, blocker = counts()
            losses = res["losses"]
            results.append(
                f"{what}: 128x96 d3 ss0, {steps} steps, loss "
                f"{losses[0]:.5f} -> {losses[-1]:.5f}, "
                f"{res['train_seconds'] / res['steps'] * 1e3:.1f} ms per "
                f"step (host clock, first step included), {closest} closest "
                f"and {blocker} blocker query launches, {mega} megakernel "
                "launches")
            wants_k6 = "triangle" in what
            if mega or not losses[-1] < losses[0] \
                    or bool(closest and blocker) != wants_k6 \
                    or not all(bool(torch.isfinite(v).all())
                               for v in res["params"].values()):
                raise RuntimeError("invrender --engine tracer failed: "
                                   + results[-1])
    phase(18, "invrender --engine tracer", f"{card}: " + "; ".join(results))


def shard_rank(world):
    """Phase 20 on one rank of a world of ``world`` ranks on the card (run
    by ``distributed.launch``): the checks of its world, each run once to
    warm up, then driven with its kernels' launch counts set to 0 just
    before it and read just after, timed on the host clock from a barrier
    to a synchronise; rank 0 also
    renders each check on its own and compares.  Returns one dict a
    check."""
    import numpy as np
    import torch.distributed as dist

    import tpuray_torch as tt
    from tpuray_torch.kernels import query
    from tpuray_torch.kernels.megakernel import (render_megakernel,
                                                 render_megakernel_record)
    from tpuray_torch.meshes import mesh_benchmark_scene
    from tpuray_torch.parallel import shard

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    camera = tt.Camera(*GOLDEN_CAMERA)
    scene = tt.build_scene(tt.canonical_scene_spec(), dev)
    assets = tt.assets_from_arrays(
        *tt.random_asset_arrays(ASSET_SEED, 512, 512), dev)
    kernels = {"K1": (render_megakernel,), "K2": (render_megakernel,),
               "K3": (render_megakernel,), "K4": (render_megakernel,),
               "K5": (render_megakernel_record,),
               "K6": (query.tri_query_closest, query.tri_query_blocker)}
    checks = []

    def inputs(width, height, depth, samples=2, **kw):
        cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                              shadow_samples=samples, **kw)
        return tt.perspective_basis(camera, width, height, device=dev), cfg

    def check(name, kernel, sharded, single, grads=False):
        sharded()               # warm-up, not timed and not counted
        for fn in kernels[kernel]:
            fn.launches = 0
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        got = sharded()
        torch.cuda.synchronize()
        entry = {"name": name, "kernel": kernel,
                 "wall": time.perf_counter() - t0,
                 "launches": sum(fn.launches for fn in kernels[kernel])}
        if rank == 0:
            want = single()
            if grads:
                (loss, g), (want_loss, w) = got, want
                pairs = [(g[k], w[k]) for k in w]
                entry["loss"] = (float(loss), float(want_loss))
                entry["within"] = bool(
                    abs(float(loss) - float(want_loss))
                    <= SHARD_LOSS_RTOL * abs(float(want_loss))
                    and all(torch.allclose(a, b, rtol=SHARD_GRAD_RTOL,
                                           atol=SHARD_GRAD_ABS)
                            for a, b in pairs))
                entry["equal"] = bool(float(loss) == float(want_loss) and all(
                    torch.equal(a, b) for a, b in pairs))
                entry["max_abs"] = max(float((a - b).abs().max())
                                       for a, b in pairs if a.numel())
                entry["n_diff"] = sum(int((a != b).sum()) for a, b in pairs)
                entry["finite"] = all(bool(torch.isfinite(a).all())
                                      for a, _ in pairs)
            else:
                entry["shape"] = tuple(got.shape)
                entry["equal"] = bool(torch.equal(got, want))
                entry["max_abs"] = float((got - want).abs().max())
                entry["n_diff"] = int((got != want).any(-1).sum())
                entry["finite"] = bool(torch.isfinite(got).all())
                entry["within"] = entry["max_abs"] <= SCENE_PARALLEL_ABS
        checks.append(entry)

    def rows_check(name, kernel, s, width, height, depth, mesh, **kw):
        basis, cfg = inputs(width, height, depth, **kw)
        check(name, kernel,
              lambda: shard.render_sharded_pallas(s, assets, basis, cfg,
                                                  mesh),
              lambda: tt.render_from_basis(s, assets, basis, cfg))

    def k5_check(mesh):
        basis, cfg = inputs(128, 96, 3, 0)
        rng = np.random.default_rng(ASSET_SEED)
        target = torch.from_numpy(rng.uniform(0, 1, (96, 128, 3)).astype(
            np.float32)).to(dev)

        def single():
            return tt.value_and_scene_grad(
                lambda s: torch.sum((tt.render_megakernel_diff(
                    s, assets, basis, cfg).clamp(0.0, 1.0) - target) ** 2),
                scene)

        check("K5 + replay 128x96 d3 ss0", "K5",
              lambda: shard.loss_and_scene_grad_sharded_pallas(
                  scene, assets, basis, target, cfg, mesh), single, True)

    def tracer_check(name, s, width, height, depth, mesh, fn):
        basis, cfg = inputs(width, height, depth)
        check(name, "K6", lambda: fn(s, assets, basis, cfg, mesh),
              lambda: tt.render_from_basis_tracer(s, assets, basis, cfg))

    if world == 1:
        mesh = shard.make_mesh()
        rows_check("K1 1920x1080 d4", "K1", scene, 1920, 1080, 4, mesh)
        rows_check("K1 800x600 d15", "K1", scene, 800, 600, 15, mesh)
        k5_check(mesh)
    elif world == 2:
        mesh = shard.make_mesh()
        t0 = time.perf_counter()
        meshes = {key: tt.build_scene(mesh_benchmark_scene(*spec), dev)
                  for key, spec in (("k3", MESH_K3), ("k4", MESH_K4))}
        checks.append({"name": "mesh scenes loaded", "rank": rank,
                       "wall": time.perf_counter() - t0})
        rows_check("K1 1920x1080 d4", "K1", scene, 1920, 1080, 4, mesh)
        rows_check("K1 800x600 d15", "K1", scene, 800, 600, 15, mesh)
        rows_check("K2 800x600 d15", "K2", scene, 800, 600, 15, mesh,
                   filter="bilinear")
        for key, kernel in (("k3", "K3"), ("k4", "K4")):
            rows_check(f"{kernel} {meshes[key].num_triangles:,} triangles "
                       "512x384 d3 ss2", kernel, meshes[key], 512, 384, 3,
                       mesh)
        k5_check(mesh)
        for key in ("k3", "k4"):
            tracer_check(f"K6 scene-parallel {meshes[key].num_triangles:,} "
                         "triangles 512x384 d3 ss2", meshes[key], 512, 384,
                         3, mesh, shard.render_scene_parallel)
    else:
        mesh2d = shard.make_mesh(shape=(world // 2, 2))
        k3 = tt.build_scene(mesh_benchmark_scene(*MESH_K3), dev)
        tracer_check(f"K6 pixels x triangles 2x2 {k3.num_triangles:,} "
                     "triangles 128x96 d2 ss2", k3, 128, 96, 2, mesh2d,
                     shard.render_sharded_2d)
    for entry in checks:
        entry["rank"] = rank
        entry["backend"] = dist.get_backend()
    return checks


def nccl_probe():
    """One all-reduce over NCCL (phase 20: a world of 2 on one card)."""
    import torch.distributed as dist
    x = torch.ones(1, device="cuda")
    dist.all_reduce(x)
    return float(x)


def shard_phase(card):
    """Phase 20: the worlds of ``SHARD_WORLDS`` on this card (see
    :func:`shard_rank`), and what NCCL says to a world of 2 on one card.
    Every check must pass, and every kernel of a check must have launched
    on every rank."""
    from tpuray_torch.parallel import distributed

    torch.cuda.empty_cache()
    results, failed = [], []
    for label, world, backend in SHARD_WORLDS:
        t0 = time.perf_counter()
        ranks = distributed.launch(shard_rank, world, world, backend=backend,
                                   device="cuda", timeout=SHARD_TIMEOUT)
        texts = []
        for name in [e["name"] for e in ranks[0]]:
            per_rank = [next(e for e in r if e["name"] == name)
                        for r in ranks]
            first = per_rank[0]
            walls = ", ".join(f"{e['wall']:.3f}" for e in per_rank)
            if "kernel" not in first:
                texts.append(f"{name}: {walls} s per rank")
                continue
            launches = [e["launches"] for e in per_rank]
            text = (f"{name}: max|d| {first['max_abs']:.3g}, "
                    f"{first['n_diff']} differing "
                    f"{'gradient elements' if 'loss' in first else 'pixels'}"
                    f", bit-equal {first['equal']}, {first['kernel']} "
                    f"launches {launches}, wall {walls} s per rank")
            if "loss" in first:
                text += (f", loss {first['loss'][0]!r} vs one rank's "
                         f"{first['loss'][1]!r}")
            texts.append(text)
            ok = first["finite"] and min(launches) >= 1 and (
                first["equal"] if world == 1 or first["kernel"] in
                ("K1", "K2", "K3", "K4") else first["within"])
            if not ok:
                failed.append(f"{label}: {text}")
        backends = sorted({e["backend"] for r in ranks for e in r})
        results.append(f"{label} ({'/'.join(backends)}, "
                       f"{time.perf_counter() - t0:.1f} s): "
                       + "; ".join(texts))
    try:
        distributed.launch(nccl_probe, 2, backend="nccl", device="cuda",
                           timeout=NCCL_PROBE_TIMEOUT)
        said = "a world of 2 over NCCL on one card ran"
    except (RuntimeError, TimeoutError) as e:
        lines = [ln.strip() for ln in str(e).splitlines()
                 if "NCCL" in ln or "Error" in ln or "Duplicate" in ln
                 or "did not finish" in ln]
        said = ("a world of 2 over NCCL on one card raised: "
                + " | ".join(lines[-3:]))
    results.append(said)
    phase(20, "sharding", f"{card}: " + "; ".join(results))
    if failed:
        raise RuntimeError("sharded paths disagree: " + "; ".join(failed))


class Counted:
    """Wraps a function of a module and counts its calls (and their host
    time in ms) until ``restore``."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.ms = []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kw)
        finally:
            self.ms.append((time.perf_counter() - t0) * 1e3)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def viewer_frames(tt, rayview, argv):
    """``rayview.main(argv)`` with the megakernel's launches counted from 0
    and the packs and triangle-table builds counted; returns (result,
    K1 launches, record launches, packs, table builds)."""
    from tpuray_torch.kernels import megakernel

    packs = Counted(rayview, "pack_scene")
    builds = Counted(megakernel, "build_tri_tables")
    try:
        megakernel.render_megakernel.launches = 0
        megakernel.render_megakernel_record.launches = 0
        res = rayview.main(argv)
        return (res, megakernel.render_megakernel.launches,
                megakernel.render_megakernel_record.launches,
                len(packs.ms), len(builds.ms))
    finally:
        packs.restore()
        builds.restore()


def frame_split(res):
    """Medians (ms) of the frames after the first: device (None off the
    card), host, and the host's swap, copy back and PNG writing."""
    times = res["loop"].times[1:]
    split = {key: statistics.median([t[key] for t in times])
             for key in ("frame", "swap", "copy")}
    device = [t["device"] for t in times]
    split["device"] = None if None in device else statistics.median(device)
    split["png"] = statistics.median(res["png_ms"])
    return split


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def viewer_phase(tt, dev, card, mesh_spec, tex, sky, mounted):
    """Phase 21: the viewer (``apps/rayview``: scripted frames on the
    canonical scene and on a mesh archive, ``serve``), raypng's
    ``--profile``, ``timed``, ``nan_guard`` and the native codec."""
    import urllib.request

    from tpuray_torch import io as tio
    from tpuray_torch import native_lib
    from tpuray_torch.apps import raypng, rayview
    from tpuray_torch.kernels.megakernel import (
        render_megakernel, render_megakernel_reference)
    from tpuray_torch.utils.debug import nan_guard
    from tpuray_torch.utils.metrics import timed

    results = []
    t_phase = time.perf_counter()
    width, height, depth = VIEWER_SHAPE

    def shape_args(w, h, d):
        return ["--width", str(w), "--height", str(h), "--depth", str(d),
                "--device", dev.type]

    with tempfile.TemporaryDirectory() as tmp:
        app_inputs = [] if mounted else write_inputs(tt, tmp, tex, sky)
        asset_args = app_inputs[2:]

        # -- (a) scripted frames: packed once, K1 a frame --
        frames = os.path.join(tmp, "frames")
        res, k1, k5, packs, builds = viewer_frames(
            tt, rayview, shape_args(*VIEWER_SHAPE) + [
                "--keys", VIEWER_KEYS, "--frames-dir", frames] + app_inputs)
        n = len(VIEWER_KEYS)
        loop = res["loop"]
        per_frame = int(dev.type == "cuda")     # the plain version: none
        if k1 != (n + 1) * per_frame or k5 or packs != 1 or builds != 1:
            raise RuntimeError(f"the viewer made {k1} K1 and {k5} record "
                               f"launches, {packs} packs and {builds} table "
                               f"builds for {n} keys")
        basis = tt.perspective_basis(res["camera"], width, height,
                                     device="cpu")
        want = render_megakernel_reference(
            tt.pack_scene(loop.scene, basis), loop.assets, loop.cfg)
        agree, mean, max_d = agreement(loop.rgb, want)
        if agree < AGREE_FRAC or mean >= MEAN_ABS:
            raise RuntimeError(f"the viewer's last frame disagrees with the "
                               f"plain version: {agree}, {mean}")
        for i, img in enumerate(res["images"]):
            path = os.path.join(frames, f"frame_{i:04d}.png")
            if not (tt.read_png(path) == img).all():
                raise RuntimeError(f"{path} differs from its frame")
        split = frame_split(res)
        results.append(
            f"(a) {width}x{height} d{depth}, {n} keys '{VIEWER_KEYS}': {k1} "
            f"K1 launches, 0 record, 1 pack, 1 table build; last frame vs "
            f"plain {agree:.6f} of pixels within {AGREE_ABS}, mean|d| "
            f"{mean:.3g}, max|d| {max_d:.3g}; {n} PNGs equal the frames; "
            f"median frame: device {fmt_ms(split['device'])} (CUDA events, "
            f"K1 + quantise), host {split['frame']:.3f} ms = swap "
            f"{split['swap']:.3f} + "
            f"launch and copy back {split['frame'] - split['swap']:.3f} "
            f"(copy back, waiting included, {split['copy']:.3f}); PNG "
            f"writing {split['png']:.3f} ms a frame")

        # -- (b) the 7,424-triangle archive of phase 12, 512x384 d3 --
        archive = os.path.join(tmp, "mesh_k3.map")
        tt.dump_scene(archive, mesh_spec)
        keys = "wd8 6"
        mw, mh, md = VIEWER_MESH_SHAPE
        res_m, k1, k5, packs, builds = viewer_frames(
            tt, rayview, shape_args(*VIEWER_MESH_SHAPE) + [
                "--scene", archive, "--keys", keys,
                "--frames-dir", os.path.join(tmp, "mesh_frames")]
            + asset_args)
        mloop = res_m["loop"]
        if mloop.packed is None or mloop.packed.tris is None \
                or k1 != (len(keys) + 1) * per_frame or k5 or packs != 1 \
                or builds != 1:
            raise RuntimeError(f"the viewer on the mesh archive made {k1} "
                               f"K3 launches, {packs} packs and {builds} "
                               "table builds")
        ctl = rayview.CameraController()
        fresh = []
        for k in keys:
            ctl.key(k)
            t0 = time.perf_counter()
            mbasis = tt.perspective_basis(ctl.camera(), mw, mh,
                                          device="cpu")
            rgb = tt.render_from_basis(mloop.scene, mloop.assets, mbasis,
                                       mloop.cfg)
            tt.quantize_image(rgb, mw, mh).cpu().numpy()
            fresh.append((time.perf_counter() - t0) * 1e3)
        msplit = frame_split(res_m)
        results.append(
            f"(b) {mloop.scene.num_triangles:,} triangles, {mw}x{mh} d{md}, "
            f"{len(keys)} keys: {k1} K3 launches, 1 pack, 1 table build; "
            f"median frame host {msplit['frame']:.3f} ms (device "
            f"{fmt_ms(msplit['device'])}) against "
            f"{statistics.median(fresh):.3f} ms for render_from_basis "
            "(packing and tables every frame)")

        # -- (c) serve on 127.0.0.1 with the real frame function --
        ctl = rayview.CameraController()
        jpeg = Counted(rayview, "encode_jpeg")
        box = {}
        server = threading.Thread(
            target=rayview.serve,
            args=(ctl, lambda: loop.frame(ctl.camera()), width, height, 0),
            kwargs={"host": "127.0.0.1",
                    "started": lambda httpd, stop: box.update(
                        httpd=httpd, stop=stop)}, daemon=True)
        try:
            render_megakernel.launches = 0
            server.start()
            for _ in range(400):
                if "httpd" in box:
                    break
                time.sleep(0.025)
            base = f"http://127.0.0.1:{box['httpd'].server_address[1]}"
            jpg = urllib.request.urlopen(f"{base}/frame.jpg",
                                         timeout=60).read()
            if jpg[:2] != b"\xff\xd8" or jpg[-2:] != b"\xff\xd9":
                raise RuntimeError("/frame.jpg is not a whole JPEG")
            origin, before = ctl.origin.copy(), render_megakernel.launches
            rendered = len(loop.times)
            urllib.request.urlopen(f"{base}/key?k=w", timeout=10).read()
            for _ in range(400):
                if len(loop.times) > rendered:
                    break
                time.sleep(0.025)
            time.sleep(0.1)
            moved = float(abs(ctl.origin - origin).max())
            launched = render_megakernel.launches - before
            if moved == 0 or len(loop.times) != rendered + 1 \
                    or launched != per_frame:
                raise RuntimeError(f"/key?k=w moved the camera by {moved} "
                                   f"and made {launched} K1 launches")
            with urllib.request.urlopen(f"{base}/stream", timeout=30) as r:
                head = b""
                while not head.endswith(b"\r\n\r\n"):
                    head += r.read(1)
                size = int(re.search(rb"Content-Length: (\d+)",
                                     head).group(1))
                part = r.read(size)
            if part[:2] != b"\xff\xd8" or part[-2:] != b"\xff\xd9":
                raise RuntimeError("a /stream part is not a whole JPEG")
        finally:
            t0 = time.perf_counter()
            if "httpd" in box:
                box["stop"].set()
                box["httpd"].shutdown()
            server.join(timeout=10)
            down = time.perf_counter() - t0
            jpeg.restore()
        if server.is_alive():
            raise RuntimeError("serve did not shut down within 10 s")
        results.append(
            f"(c) serve {width}x{height} d{depth}: /frame.jpg {len(jpg)} "
            "bytes (SOI..EOI), "
            f"/key?k=w moved the camera {moved:.3f} and made {launched} K1 "
            "launch(es), "
            f"a /stream part of {len(part)} bytes; JPEG encoding (quality 85)"
            f" per frame {', '.join(f'{ms:.1f}' for ms in jpeg.ms)} ms; "
            f"shut down in {down:.2f} s")

        # -- (d) raypng --profile and timed --
        prof = os.path.join(tmp, "profile")
        pw, ph, pd = PROFILE_SHAPE
        raypng.main(shape_args(*PROFILE_SHAPE) + [
            "--repeat", "3", "--profile", prof,
            "--out", os.path.join(tmp, "profiled.png")] + app_inputs)
        traces = [f for f in os.listdir(prof) if f.endswith(".json")]
        if len(traces) != 1:
            raise RuntimeError(f"raypng --profile wrote {traces}")
        with open(os.path.join(prof, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and "megakernel" in e.get("name", "")]
        if not kernels and dev.type == "cuda":
            raise RuntimeError("the profiler trace has no megakernel event")
        packed = tt.pack_scene(loop.scene, tt.perspective_basis(
            tt.Camera(*GOLDEN_CAMERA), pw, ph, device=dev))
        cfg_p = tt.RenderConfig(width=pw, height=ph, max_depth=pd)
        render_megakernel(packed, loop.assets, cfg_p)
        with timed(f"timed: K1 {pw}x{ph} d{pd} on {card}", dev):
            render_megakernel(packed, loop.assets, cfg_p)
        first = (f" ('{kernels[0]['name'][:40]}', {kernels[0].get('dur')} "
                 "us)" if kernels else "")
        results.append(
            f"(d) raypng --profile {pw}x{ph} d{pd} --repeat 3: trace "
            f"{traces[0]} parses, {len(events)} events, {len(kernels)} "
            f"megakernel kernel events{first}; timed printed its line")

        # -- (e) nan_guard: K1's wrapper checks the image --
        cfg = loop.cfg
        with nan_guard():
            render_megakernel(loop.packed, loop.assets, cfg)
        nan_counts = {}
        for what in ("radius", "rgb"):
            scene = tt.build_scene(tt.canonical_scene_spec(), dev)
            if what == "radius":
                scene.sphere_radius[0] = float("nan")
            else:
                scene.sphere_mat.rgb[:, 0] = float("nan")
            bad = tt.pack_scene(scene, basis)
            nan_counts[what] = int(torch.isnan(
                render_megakernel(bad, loop.assets, cfg)).any(-1).sum())
            try:
                with nan_guard():
                    render_megakernel(bad, loop.assets, cfg)
                raised = None
            except FloatingPointError as e:
                raised = str(e)
            if (raised is None) != (nan_counts[what] == 0):
                raise RuntimeError(f"nan_guard with a NaN sphere {what}: "
                                   f"{nan_counts[what]} NaN pixels, raised "
                                   f"{raised}")
        if not nan_counts["rgb"]:
            raise RuntimeError("a NaN sphere colour made no NaN pixel")
        results.append(
            f"(e) nan_guard: a clean K1 render passes; a NaN in the spheres' "
            f"colour makes {nan_counts['rgb']} NaN pixels and K1's wrapper "
            f"raised FloatingPointError ('{raised}'); a NaN radius makes "
            f"{nan_counts['radius']} (the sphere is missed) and nothing "
            "raises")

        # -- (f) the native codec --
        status = native_lib.status()
        text = f"(f) native codec {status}"
        if native_lib.available():
            img = res["images"][-1]
            ours = os.path.join(tmp, "native.png")
            theirs = os.path.join(tmp, "zlib.png")
            native_lib.write_png(ours, img)
            with open(theirs, "wb") as f:
                f.write(tio.encode_png(img))
            for path in (ours, theirs):
                for reader in (tio.read_png, native_lib.read_png):
                    if not (reader(path) == img).all():
                        raise RuntimeError(f"{reader.__module__} read {path} "
                                           "back different")
            canonical = os.path.join(tmp, "canonical.map")
            tt.dump_scene(canonical, tt.canonical_scene_spec())
            for name, spec, path in (
                    ("canonical", tt.canonical_scene_spec(), canonical),
                    ("mesh", mesh_spec, archive)):
                out = path + ".native"
                native_lib.scene_write(out, *native_lib.scene_read(path))
                with open(out, "rb") as f:
                    if f.read() != tt.dumps_scene(spec):
                        raise RuntimeError(f"scene_write on the {name} "
                                           "scene differs from dumps_scene")
            text += ("; its PNG and numpy + zlib's read back equal through "
                     "both readers; scene_write byte-equal to dumps_scene "
                     "on the canonical scene and the mesh archive")
        results.append(text)
    phase(21, "viewer and host modules",
          f"{card}: " + "; ".join(results)
          + f"; phase took {time.perf_counter() - t_phase:.1f} s")


def entry_point(module, args, card):
    """``python3 -m tpuray_torch.<module> args`` from the repository root:
    (its JSON rows, its wall time).  Raises unless it exits 0, prints the
    card's line and names the card in every row."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"tpuray_torch.{module}", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=ENTRY_TIMEOUT)
    wall = time.perf_counter() - t0
    what = f"{module} {' '.join(args)}"
    if proc.returncode:
        raise RuntimeError(f"{what} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    if not any(ln.startswith(f"device: {card};") for ln in lines):
        raise RuntimeError(f"{what} did not print the card's line")
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    if not rows or any(r.get("device") != card for r in rows):
        raise RuntimeError(f"{what}: no rows, or a row that does not name "
                           f"{card}: {rows}")
    return rows, wall


def fmt_spread(row, key="ms_per_render"):
    return (f"{row[key]:.4f} ms [{row['min_ms']:.4f}, {row['max_ms']:.4f}] "
            f"over {row['reps']}")


def entry_phase(card, app_inputs, k1_1080_ms, tmp):
    """Phase 22: the entry points (see the module docstring), their rows
    printed one a line, and the checks on their launches and times."""
    from tpuray_torch.benchmarks.timing import REPS, WARMUP
    from tpuray_torch.scripts import profile_replay

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    asset_args = app_inputs[2:]
    k1_calls = 2 * (WARMUP + REPS)   # render_from_basis, then K1 alone
    renders = {"megakernel": k1_calls, "megakernel_record": 0,
               "tri_query": 0}
    none = dict.fromkeys(renders, 0)
    with_k5 = {**none, "megakernel_record": profile_replay.REPS}
    runs = (
        ("bench", "bench", list(app_inputs)),
        ("stages", "benchmarks.stages", ["--stages", "1,2,3,4,5,6",
                                         *app_inputs]),
        ("stream", "benchmarks.stream", list(asset_args)),
        ("profile_tri", "scripts.profile_tri",
         ["--variants", "base,noshadow,d1,notri", *asset_args]),
        ("profile_replay d3", "scripts.profile_replay",
         ["3", "--json", *app_inputs]),
        ("profile_replay d15", "scripts.profile_replay",
         ["15", "--json", *app_inputs]),
        ("scaling pixel", "benchmarks.scaling",
         ["--layout", "pixel", *SCALING_SHAPE, *app_inputs]),
        ("scaling scene", "benchmarks.scaling",
         ["--layout", "scene", *SCALING_SHAPE, *app_inputs]),
        ("validate", "scripts.validate",
         ["--skip-stages", "--skip-replay", "--out",
          os.path.join(tmp, "validate.json"), *app_inputs]),
    )
    texts, failed, kernel_ms = [], [], {}
    for name, module, args in runs:
        rows, wall = entry_point(module, args, card)
        parts = []
        for row in rows:
            print(f"phase 22 row {name}: {json.dumps(row)}", flush=True)
            got, want = row.get("launches"), None
            if "param_err_start" in row:            # validate's invrender
                if got["megakernel_record"] <= VALIDATE_INVRENDER_STEPS \
                        or got["megakernel"] or got["tri_query"]:
                    failed.append(f"validate's invrender launched {got}")
                parts.append(
                    f"invrender {row['config']}: observable error "
                    f"{row['observable_err_start']:.4f} -> "
                    f"{row['observable_err_end']:.4f}, "
                    f"{row['train_seconds']:.1f} s, {got}")
            elif "measured" in row:                 # validate's golden
                parts.append(f"golden PSNR {row['psnr_db']:.2f} dB"
                             if row["measured"] else
                             f"golden not measured: {row['reason']}")
            elif "what" in row:                     # profile_replay
                want = with_k5 if row["what"] in (
                    profile_replay.RECORD, profile_replay.FULL) else none
                parts.append(f"{row['what']} {row['config']} "
                             f"{fmt_spread(row, 'ms')}, "
                             f"{row['cuda_kernels']} device ops, peak "
                             f"{row['peak_mib']:.0f} MiB")
            elif "layout" in row:                   # scaling
                ok = (got["tri_query"] > 0 if row["layout"] == "scene"
                      else not any(got.values()))
                if not ok or got["megakernel"] or got["megakernel_record"]:
                    failed.append(f"{name} launched {got}")
                parts.append(f"{row['devices']} rank(s) over "
                             f"{row['dist_backend']} "
                             f"{fmt_spread(row)}, efficiency "
                             f"{row['efficiency']:.3f}, rank 0 {got}")
            else:                                   # a render row
                want = renders
                label = row.get("config", row.get("variant"))
                if "metric" in row:
                    label = f"bench {label}"
                if "stage" in row:
                    label = f"stage {row['stage']} {label}"
                call = fmt_spread(row, "ms" if "variant" in row
                                  else "ms_per_render")
                parts.append(f"{label} {call}, kernel "
                             f"{row['kernel_ms']:.4f} ms "
                             f"[{row['kernel_min_ms']:.4f}, "
                             f"{row['kernel_max_ms']:.4f}]"
                             + (f", build {row['build_s']:.2f} s"
                                if "build_s" in row else ""))
                if name == "bench" or row.get("stage") == 3:
                    kernel_ms[label] = row["kernel_ms"]
            if want is not None and got != want:
                failed.append(f"{name}: launches {got}, expected {want}")
        texts.append(f"{name} ({wall:.1f} s): " + "; ".join(parts))
    for what, ms in kernel_ms.items():
        off = abs(ms / k1_1080_ms - 1.0)
        texts.append(f"{what} kernel_ms {ms:.4f} vs phase 5's K1 "
                     f"{k1_1080_ms:.4f} ms ({off:.1%} off)")
        if off > KERNEL_MS_RTOL:
            failed.append(f"{what}: kernel_ms {ms:.4f} is {off:.1%} off "
                          f"phase 5's {k1_1080_ms:.4f} ms")
    if len(kernel_ms) != 2:
        failed.append(f"expected bench's and stage 3's kernel_ms, got "
                      f"{sorted(kernel_ms)}")
    phase(22, "benchmark entry points",
          f"{card}: " + "; ".join(texts) + "; scaling ran at 512x384 d3 "
          f"(reduced); phase took {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise RuntimeError("entry points: " + "; ".join(failed))


def write_inputs(tt, tmp, tex, sky):
    """A render.map of the canonical scene and an asset directory of the
    seeded images, as the apps read them."""
    scene_path = os.path.join(tmp, "render.map")
    tt.dump_scene(scene_path, tt.canonical_scene_spec())
    asset_dir = os.path.join(tmp, "assets")
    os.makedirs(os.path.join(asset_dir, "bg"))
    for name, img in zip(tt.textures.DEFAULT_TEXTURES, tex):
        tt.write_png(os.path.join(asset_dir, name), img)
    tt.write_png(os.path.join(asset_dir, tt.textures.DEFAULT_SKYBOX), sky)
    return ["--scene", scene_path, "--asset-dir", asset_dir]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "NVIDIA GPU")
    import tpuray_torch as tt
    from tpuray_torch.apps import invrender, raypng
    from tpuray_torch.config import REFERENCE_DIR
    from tpuray_torch.kernels import build
    from tpuray_torch.kernels.megakernel import (
        render_megakernel, render_megakernel_record,
        render_megakernel_record_reference, render_megakernel_reference)
    from tpuray_torch.utils.metrics import cuda_time_ms

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. the card and the toolchain --
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    nvcc_version = run([nvcc, "--version"]).splitlines()[-1]
    phase(1, "card", f"{card}; torch {torch.__version__} CUDA "
                     f"{torch.version.cuda}; {nvcc_version}")

    # -- 2. build --
    t0 = time.perf_counter()
    lib = build.load_library()
    phase(2, "build", f"{os.path.relpath(lib.path)} in "
                      f"{time.perf_counter() - t0:.1f} s; "
                      f"{' | '.join(ptxas_figures(lib.log))}")

    mounted = os.path.exists(os.path.join(REFERENCE_DIR, "scenes",
                                          "render.map"))
    tex, sky = tt.random_asset_arrays(ASSET_SEED, 512, 512)
    if mounted:
        print(f"inputs: render.map and assets from {REFERENCE_DIR}",
              flush=True)
        scene = tt.load_scene(os.path.join(REFERENCE_DIR, "scenes",
                                           "render.map")).to_scene(dev)
        assets = tt.load_default_assets(device=dev)
    else:
        print(f"inputs: canonical_scene_spec() and seeded random assets "
              f"(seed {ASSET_SEED}); no reference tree at {REFERENCE_DIR}",
              flush=True)
        scene = tt.build_scene(tt.canonical_scene_spec(), dev)
        assets = tt.assets_from_arrays(tex, sky, dev)
    camera = tt.Camera(*GOLDEN_CAMERA)

    def inputs(width, height, depth, samples=2, rows=None, row0=0, **kw):
        cfg = tt.RenderConfig(width=width, height=rows or height,
                              max_depth=depth, shadow_samples=samples, **kw)
        basis = tt.perspective_basis(camera, width, height, device=dev)
        return tt.pack_scene(scene, basis, row0), cfg

    # -- 3. kernel against its plain version: 200x50 has lanes outside the
    #    image, the deep slab the frame's deepest pixels --
    max_err = 0.0
    results = []
    for width, height, depth, rows, row0 in (
            (256, 64, 3, None, 0), (200, 50, 6, None, 0),
            (800, 600, 15, DEEP_SLAB[1], DEEP_SLAB[0]),
            (800, 600, 15, None, 0)):
        packed, cfg = inputs(width, height, depth, rows=rows, row0=row0)
        before = render_megakernel.launches
        got = render_megakernel(packed, assets, cfg)
        torch.cuda.synchronize()
        if render_megakernel.launches != before + 1:
            raise RuntimeError("the wrapper did not count its launch")
        want = render_megakernel_reference(packed, assets, cfg)
        torch.cuda.synchronize()
        if got.shape != (cfg.height, width, 3) or torch.isnan(got).any():
            raise RuntimeError(f"kernel output {tuple(got.shape)} has NaN "
                               "or the wrong shape")
        diff = (got - want).abs()
        agree = float((diff.amax(-1) < AGREE_ABS).float().mean())
        mean = float(diff.mean())
        max_err = max(max_err, float(diff.max()))
        slab = f" rows {row0}-{row0 + rows - 1}" if rows else ""
        results.append(f"{width}x{height}{slab} d{depth}: {agree:.6f} of "
                       f"pixels within {AGREE_ABS}, mean|d| {mean:.3g}, "
                       f"max|d| {float(diff.max()):.3g}")
        if agree < AGREE_FRAC or mean >= MEAN_ABS:
            raise RuntimeError("kernel disagrees with the plain version: "
                               + results[-1])
    phase(3, "kernel vs plain", "; ".join(results))

    with tempfile.TemporaryDirectory() as tmp:
        app_inputs = [] if mounted else write_inputs(tt, tmp, tex, sky)

        # -- 4. the raypng path through K1 --
        argv = ["--width", "800", "--height", "600", "--depth", "15",
                "--device", "cuda", "--selfcheck",
                "--out", os.path.join(tmp, "scene.png")] + app_inputs
        if mounted:
            argv.append("--compare-golden")
        render_megakernel.launches = 0
        render_megakernel_record.launches = 0
        t0 = time.perf_counter()
        res = raypng.main(argv)
        wall = time.perf_counter() - t0
        k1_launches = render_megakernel.launches
        if render_megakernel_record.launches:
            raise RuntimeError("raypng launched the record kernel")
        written = tt.read_png(os.path.join(tmp, "scene.png"))
        if k1_launches < 1:
            raise RuntimeError("raypng did not launch the CUDA megakernel")
        rgb = res["rgb"]
        if rgb.device.type != "cuda" or rgb.shape != (600, 800, 3) \
                or not bool(torch.isfinite(rgb).all()):
            raise RuntimeError("raypng's image is not a finite 600x800x3 "
                               "CUDA tensor")
        if not (written == res["image"]).all():
            raise RuntimeError("the written PNG differs from the render")
        text = (f"800x600 d15, {k1_launches} kernel launch(es), "
                f"{res['report']}; whole run (load, render, PNG) "
                f"{wall:.3f} s")
        if mounted:
            g = res["golden"]
            text += f"; golden {g}"
            if not (g.mean_abs < GOLDEN_MEAN
                    and g.frac_within_8 >= GOLDEN_WITHIN_8
                    and g.psnr >= GOLDEN_PSNR):
                raise RuntimeError(f"golden bar missed: {g}")
        phase(4, "raypng", text)

        # -- 5. K1 timing --
        timings = {}
        for width, height, depth in ((800, 600, 15), (1920, 1080, 4)):
            packed, cfg = inputs(width, height, depth)
            for name, fn in (("kernel", render_megakernel),
                             ("plain", render_megakernel_reference)):
                timings[(width, height, depth, name)] = cuda_time_ms(
                    lambda: fn(packed, assets, cfg))[0]
        phase(5, "timing", f"{card}: " + "; ".join(
            f"{w}x{h} d{d} {name} {ms:.4f} ms "
            f"({w * h / ms / 1e3:.2f} Mrays/s)"
            for (w, h, d, name), ms in timings.items()))
        packed, cfg = inputs(800, 600, 15, record_slots=64)
        _, recs = render_megakernel_record(packed, assets, cfg)
        k1_bound, k1_by, k1_counts = bound(recs, packed, cfg, False)
        del recs

        # -- 6. K5 against its plain version: 203x37 has lanes outside the
        #    image, the deep slab the frame's deepest pixels --
        k5_err = 0.0
        results = []
        for width, height, depth, samples, rows, row0 in (
                (256, 64, 3, 2, None, 0), (200, 50, 6, 2, None, 0),
                (128, 96, 3, 0, None, 0), (203, 37, 6, 2, None, 0),
                (800, 600, 15, 2, DEEP_SLAB[1], DEEP_SLAB[0])):
            packed, cfg = inputs(width, height, depth, samples, rows=rows,
                                 row0=row0)
            before = render_megakernel_record.launches
            img, rec = render_megakernel_record(packed, assets, cfg)
            torch.cuda.synchronize()
            if render_megakernel_record.launches != before + 1:
                raise RuntimeError("the record wrapper did not count its "
                                   "launch")
            want, plain = render_megakernel_record_reference(packed, assets,
                                                             cfg)
            base = render_megakernel(packed, assets, cfg)
            torch.cuda.synchronize()
            n_pix = width * cfg.height
            krec = cfg.resolved_record_slots()
            if img.shape != (cfg.height, width, 3) \
                    or rec["rec"].shape != (krec, n_pix) \
                    or rec["ssr"].shape != (krec, scene.num_lights, n_pix) \
                    or not bool(torch.isfinite(img).all()):
                raise RuntimeError("record kernel outputs have the wrong "
                                   "shape or are not finite")
            same = {k: float((rec[k] == plain[k]).all(0).float().mean())
                    for k in ("rec", "wid", "pick")}
            ssr_err = float((rec["ssr"] - plain["ssr"]).abs().max())
            d_plain = (img - want).abs()
            k5_err = max(k5_err, float(d_plain.max()))
            base_equal = bool(torch.equal(img, base))
            nodes = (int(rec["max_nodes"]), int(plain["max_nodes"]))
            slab = f" rows {row0}-{row0 + rows - 1}" if rows else ""
            results.append(
                f"{width}x{height}{slab} d{depth} ss{samples}: records "
                f"equal on {same['rec']:.6f}, winner ids on "
                f"{same['wid']:.6f} and picks on {same['pick']:.6f} of "
                f"pixels, ssr max|d| {ssr_err:.3g}, max_nodes {nodes[0]} "
                f"(plain {nodes[1]}), image vs plain max|d| "
                f"{float(d_plain.max()):.3g}, bit-equal to K1's {base_equal}")
            if min(same.values()) < AGREE_FRAC or ssr_err > SSR_ABS \
                    or nodes[0] != nodes[1] or not base_equal \
                    or float(d_plain.mean()) >= MEAN_ABS:
                raise RuntimeError("record kernel disagrees: " + results[-1])
        phase(6, "record kernel vs plain", "; ".join(results))

        # -- 7. replay and gradient on the card --
        results = []
        for width, height, depth, samples in ((128, 96, 3, 0),
                                              (256, 64, 3, 2)):
            packed, cfg = inputs(width, height, depth, samples)
            basis = tt.perspective_basis(camera, width, height, device=dev)
            img, rec = render_megakernel_record(packed, assets, cfg)
            rep = tt.replay_render(scene, assets, basis, rec, cfg)
            d = (rep - img).abs()
            results.append(f"replay {width}x{height} d{depth} ss{samples}: "
                           f"mean|d| {float(d.mean()):.3g}, max|d| "
                           f"{float(d.max()):.3g}")
            if float(d.mean()) >= REPLAY_MEAN or float(d.max()) >= REPLAY_MAX:
                raise RuntimeError("replay disagrees: " + results[-1])
        grads = {}
        width, height = 64, 48
        for where in (dev, torch.device("cpu")):
            g_scene = tt.build_scene(tt.canonical_scene_spec(), where)
            g_assets = assets.to(where)
            basis = tt.perspective_basis(camera, width, height, device=where)
            cfg = tt.RenderConfig(width=width, height=height, max_depth=3,
                                  shadow_samples=2)
            diff, rest = tt.partition(g_scene)
            leaves = {k: v.clone().requires_grad_() for k, v in diff.items()}
            gen = torch.Generator().manual_seed(0)
            w = torch.rand(height, width, 3, generator=gen).to(where)
            img = tt.render_megakernel_diff(tt.combine(leaves, rest),
                                            g_assets, basis, cfg)
            g = torch.autograd.grad((img * w).sum(), list(leaves.values()))
            grads[where.type] = dict(zip(leaves, (x.cpu() for x in g)))
        worst = 0.0
        for name, ours in grads["cuda"].items():
            want = grads["cpu"][name]
            if not bool(torch.isfinite(ours).all()):
                raise RuntimeError(f"gradient of {name} is not finite")
            if want.numel():
                scale = max(float(want.abs().max()), 1e-3)
                err = float((ours - want).abs().max()) / scale
                worst = max(worst, err)
                if err > GRAD_ATOL:
                    raise RuntimeError(f"gradient of {name} on the card is "
                                       f"{err:.3g} * max|g| off the CPU's")
        results.append(f"gradient {width}x{height} d3 ss2 on the card vs "
                       f"the CPU: worst leaf max|d| {worst:.3g} * max|g| "
                       f"(bar {GRAD_ATOL}), all finite")
        phase(7, "replay and gradient", "; ".join(results))

        # -- 8. the invrender path through K5 --
        argv = ["--steps", str(INVRENDER_STEPS), "--width", "128",
                "--height", "96", "--depth", "3", "--device", "cuda",
                "--every", "10",
                "--checkpoint", os.path.join(tmp, "invrender.pt")] \
            + app_inputs
        render_megakernel.launches = 0
        render_megakernel_record.launches = 0
        res = invrender.main(argv)
        k5_launches = render_megakernel_record.launches
        if k5_launches < INVRENDER_STEPS + 1:
            raise RuntimeError(f"invrender launched the record kernel "
                               f"{k5_launches} times in "
                               f"{INVRENDER_STEPS} steps")
        if render_megakernel.launches:
            raise RuntimeError("invrender launched the base kernel")
        losses = res["losses"]
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"the loss did not fall: {losses}")
        if not all(bool(torch.isfinite(v).all())
                   for v in res["params"].values()):
            raise RuntimeError("invrender's parameters are not finite")
        phase(8, "invrender", (
            f"128x96 d3 ss0, {INVRENDER_STEPS} steps, {k5_launches} record "
            f"kernel launches; loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
            f"param error {res['err0']:.4f} -> {res['err1']:.4f}, "
            f"observable {res['obs0']:.4f} -> {res['obs1']:.4f}; "
            f"{res['train_seconds'] / res['steps'] * 1e3:.1f} ms per step "
            f"(host clock, first step included) on {card}"))

    # -- 9. timing: recording, training steps --
    texts = []
    for width, height, depth, samples in ((512, 384, 3, 0),
                                          (800, 600, 15, 2)):
        packed, cfg = inputs(width, height, depth, samples)
        base_ms = cuda_time_ms(lambda: render_megakernel(packed, assets,
                                                         cfg))[0]
        rec_ms = cuda_time_ms(lambda: render_megakernel_record(
            packed, assets, cfg))[0]
        texts.append(f"{width}x{height} d{depth} ss{samples} K1 "
                     f"{base_ms:.4f} ms, K5 {rec_ms:.4f} ms "
                     f"({rec_ms / base_ms:.2f}x, Krec "
                     f"{cfg.resolved_record_slots()})")
    # K5 at the invrender shape, its plain version and its bound
    packed, cfg = inputs(128, 96, 3, 0)
    k5_ms = cuda_time_ms(lambda: render_megakernel_record(packed, assets,
                                                          cfg))[0]
    k5_plain_ms = cuda_time_ms(lambda: render_megakernel_record_reference(
        packed, assets, cfg))[0]
    _, recs = render_megakernel_record(packed, assets, cfg)
    k5_bound, k5_by, k5_counts = bound(recs, packed, cfg, True)
    texts.append(f"128x96 d3 ss0 K5 {k5_ms:.4f} ms, plain "
                 f"{k5_plain_ms:.4f} ms, bound {k5_bound:.5f} ms "
                 f"({k5_by}; {k5_counts})")
    texts.append(f"800x600 d15 ss2 K1 bound {k1_bound:.5f} ms ({k1_by}; "
                 f"{k1_counts})")

    truth = tt.partition(scene)

    def trainer_for(width, height, depth, samples, slots=0):
        cfg = tt.RenderConfig(width=width, height=height, max_depth=depth,
                              shadow_samples=samples, record_slots=slots)
        basis = tt.perspective_basis(camera, width, height, device=dev)

        def render(s):
            return tt.render_megakernel_diff(s, assets, basis,
                                             cfg).clamp(0, 1)

        with torch.no_grad():
            target = render(scene)
        mask = invrender.optimize_mask(truth[0])
        trainer = invrender.Trainer(
            invrender.perturb(truth[0], mask, 0, light_shift=0.3),
            truth[1], mask, render, target, steps=300)
        return trainer, cfg, basis

    for width, height, depth, samples, slots, reps in (
            (128, 96, 3, 0, 0, 10), (256, 192, 3, 2, 0, 10),
            (512, 384, 3, 0, 0, 10), (800, 600, 15, 2, 64, 2)):
        shape = f"{width}x{height} d{depth} ss{samples}"
        warmup = 3 if reps >= 10 else 1
        try:
            trainer, cfg, basis = trainer_for(width, height, depth, samples,
                                              slots)
            packed = tt.pack_scene(scene, basis)
            _, recs = render_megakernel_record(packed, assets, cfg)
            gimg = torch.rand(height, width, 3, device=dev)
            # the replay as the step runs it: gradients of the trained
            # leaves only
            params = {k: v.detach().requires_grad_(trainer.mask[k])
                      for k, v in trainer.params.items()}
            trained = [params[k] for k in trainer.trained]

            def replay_backward():
                img = tt.replay_render(tt.combine(params, truth[1]), assets,
                                       basis, recs, cfg)
                return torch.autograd.grad(img, trained, gimg)

            torch.cuda.reset_peak_memory_stats()
            step_ms = cuda_time_ms(lambda: trainer.step(True), warmup=warmup,
                                   iters=reps)[0]
            step_peak = torch.cuda.max_memory_allocated() / 2 ** 20
            grads_ms = cuda_time_ms(trainer.loss_and_grads, warmup=warmup,
                                    iters=reps)[0]
            fwd_ms = cuda_time_ms(lambda: render_megakernel_record(
                packed, assets, cfg), iters=reps)[0]
            torch.cuda.reset_peak_memory_stats()
            replay_ms = cuda_time_ms(replay_backward, warmup=warmup,
                                     iters=reps)[0]
            replay_peak = torch.cuda.max_memory_allocated() / 2 ** 20
            texts.append(
                f"step {shape}: {step_ms:.3f} ms (peak {step_peak:.0f} MiB);"
                f" loss and gradients {grads_ms:.3f} ms, of which K5 "
                f"{fwd_ms:.4f} ms and the replay forward+backward "
                f"{replay_ms:.3f} ms (peak {replay_peak:.0f} MiB); "
                f"optimizer and the rest {step_ms - grads_ms:.3f} ms; "
                f"max_nodes {int(recs['max_nodes'])}, Krec "
                f"{cfg.resolved_record_slots()}")
            del trainer, recs, params, trained
        except torch.cuda.OutOfMemoryError:
            texts.append(f"step {shape}: does not fit (peak "
                         f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f}"
                         " MiB)")
        torch.cuda.empty_cache()
    for width, height in ((128, 96), (512, 384)):
        trainer = trainer_for(width, height, 3, 0)[0]
        texts.append(profile_step(lambda: trainer.step(True),
                                  f"step {width}x{height} d3 ss0"))
    phase(9, "timing", f"{card}: " + "; ".join(texts))

    with tempfile.TemporaryDirectory() as tmp:
        app_inputs = [] if mounted else write_inputs(tt, tmp, tex, sky)
        asset_args = app_inputs[2:]
        k3_entry, k4_entry, mesh_specs, mesh_scenes = mesh_phases(
            tt, dev, card, assets, camera, asset_args)
        k2_entry, k5b_entry = bilinear_phases(tt, dev, card, scene, assets,
                                              camera, lib.log)
        query_entries = query_phase(tt, dev, card, mesh_scenes, camera)
        tracer_phases(tt, dev, card, scene, assets, camera, mesh_specs,
                      mesh_scenes, app_inputs, asset_args, query_entries)
    deep_phase(tt, dev, card, scene, assets, camera)
    shard_phase(card)
    viewer_phase(tt, dev, card, mesh_specs["k3"], tex, sky, mounted)
    with tempfile.TemporaryDirectory() as tmp:
        app_inputs = [] if mounted else write_inputs(tt, tmp, tex, sky)
        entry_phase(card, app_inputs, timings[(1920, 1080, 4, "kernel")],
                    tmp)

    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "tpuray_torch/kernels/csrc/megakernel.cu",
        "replaces": "tpuray/kernels/pallas_trace.py:659",
        "launches": k1_launches,
        "max_abs_err": max_err,
        "ms": timings[(800, 600, 15, "kernel")],
        "plain_ms": timings[(800, 600, 15, "plain")],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "shape": "800x600 d15 ss2",
    }, k3_entry, k4_entry, {
        "name": "megakernel_record",
        "route": "cuda",
        "source": "tpuray_torch/kernels/csrc/megakernel.cu",
        "replaces": "tpuray/kernels/pallas_trace.py:2665",
        "launches": k5_launches,
        "max_abs_err": k5_err,
        "ms": k5_ms,
        "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound,
        "bound_by": k5_by,
        "library_ms": None,
        "shape": "128x96 d3 ss0",
    }, k2_entry, k5b_entry, *query_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
