"""Triangle queries over a ray array: the closest hit, and the blocker test of
shadow and light rays.

Port of the JAX package's standalone triangle-query kernel (K6):
``_make_query_kernel.kernel`` (``tpuray/kernels/pallas_trace.py:2766``),
launched by ``_query_rays`` (:3046) through ``tri_query_closest`` (:3109)
and ``tri_query_blocker`` (:3119).  The whole-image tracer
(``kernels/trace.py``) asks it for the triangle answers of every DFS step.

* :func:`tri_query_closest` gives, per ray, the closest hit t (inf on a
  miss) and the winner's id (-1 on a miss; the lowest id among equal t).
* :func:`tri_query_blocker` gives, per ray, whether an opaque triangle lies
  at 0 < t < tmax (t <= tmax where ``inclusive``) and the count of
  transparent ones there.  A ray with tmax <= 0 is inactive: not blocked,
  count 0.  The kernel stops a ray at its first opaque triangle, so the
  count is defined only where the ray is not blocked.

A zero direction misses everything.  Tables come from
``triblocks.build_query_tables``.  On CPU tensors the wrappers run their
plain versions, :func:`tri_query_closest_reference` and
:func:`tri_query_blocker_reference` (``triblocks.BruteForce``: every
triangle, no culls); on CUDA tensors they launch ``csrc/tri_query.cu`` on
the current stream, or raise.  ``launches`` on each wrapper counts its
kernel launches.  Under ``utils.debug.nan_guard`` the closest query's t is
checked for NaN (the blocker test's outputs are not floating).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.debug import check_kernel_output
from .triblocks import TRI_MAX_LEVELS, BruteForce, TriTables


def tri_query_closest_reference(tables: TriTables, o, d):
    """Plain version of :func:`tri_query_closest`: (t [P] f32, id [P]
    i32)."""
    t, wid, _ = BruteForce(tables).closest(o, d)
    return t, wid.to(torch.int32)


def tri_query_blocker_reference(tables: TriTables, o, d, tmax,
                                inclusive: bool = False):
    """Plain version of :func:`tri_query_blocker`: (blocked [P] bool, count
    [P] i32); the count is that of every transparent triangle in range,
    also where the ray is blocked."""
    blocked, count = BruteForce(tables).blocked(o, d, tmax, inclusive)
    return blocked, count.to(torch.int32)


def _check(tables: TriTables, o, d, tmax=None):
    dev = tables.geom.device
    rays = [o, d] + ([] if tmax is None else [tmax])
    if any(x.device != dev for x in rays) or tables.node.device != dev:
        raise ValueError(f"tables on {dev}, rays on {o.device}/{d.device}: "
                         "all must share a device")
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in rays):
        raise ValueError("rays (and tmax) must be contiguous f32")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o and d must be [P, 3], got {tuple(o.shape)} and "
                         f"{tuple(d.shape)}")
    if tmax is not None and tmax.shape != o.shape[:1]:
        raise ValueError(f"tmax must be [{o.shape[0]}], got "
                         f"{tuple(tmax.shape)}")
    if len(tables.level_n) > TRI_MAX_LEVELS:
        raise ValueError(f"the triangle tree has {len(tables.level_n)} "
                         f"levels; the kernel takes at most {TRI_MAX_LEVELS}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch(name, tables: TriTables, n: int, *args):
    """One query on the current stream; the kernel's scratch (the queue of
    rays that enter the mesh's box, and its two counters) is allocated
    here."""
    from .build import load_library

    lib = load_library().lib
    level_n = (ctypes.c_int * len(tables.level_n))(*tables.level_n)
    dev = tables.geom.device
    scratch = torch.empty(n + 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(
            tables.geom.data_ptr(), tables.node.data_ptr(), tables.n,
            len(tables.level_n), level_n, tables.block, tables.fanout, n,
            *args, scratch.data_ptr(), scratch.data_ptr() + 4 * n, stream)
    if err:
        msg = ctypes.string_at(lib.tpuray_error_string(err)).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def tri_query_closest(tables: TriTables, o, d):
    """Closest triangle hit of the rays (o [P, 3], d [P, 3]): (t [P] f32,
    inf on a miss; id [P] i32, -1 on a miss)."""
    dev = _check(tables, o, d)
    if dev.type == "cpu":
        t, wid = tri_query_closest_reference(tables, o, d)
        check_kernel_output("triangle-query closest", t)
        return t, wid
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    wid = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("tpuray_tri_query_closest", tables, n, o.data_ptr(),
                d.data_ptr(), t.data_ptr(), wid.data_ptr())
        tri_query_closest.launches += 1
        check_kernel_output("triangle-query closest", t)
    return t, wid


tri_query_closest.launches = 0


def tri_query_blocker(tables: TriTables, o, d, tmax, inclusive: bool = False):
    """Blocker test of the rays (o, d) within tmax [P]: (blocked [P] bool,
    count [P] i32 of transparent triangles in range, defined where not
    blocked)."""
    dev = _check(tables, o, d, tmax)
    if dev.type == "cpu":
        return tri_query_blocker_reference(tables, o, d, tmax, inclusive)
    n = o.shape[0]
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    count = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("tpuray_tri_query_blocker", tables, n, o.data_ptr(),
                d.data_ptr(), tmax.data_ptr(), int(inclusive),
                blocked.data_ptr(), count.data_ptr())
        tri_query_blocker.launches += 1
    return blocked, count


tri_query_blocker.launches = 0
