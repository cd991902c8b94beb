"""Multi-rank rendering: pixels, image rows or triangles sharded over a
``DeviceMesh``.

Port of :mod:`tpuray.parallel.shard`, on ``torch.distributed``.  JAX shards
one program over the devices of one process with ``shard_map``; here every
rank is a process (started by torchrun or by
:func:`distributed.launch`) that calls the same function with the same
arguments, renders its share and meets the others in collectives:

* **Forward**: pixels (the tracer, :func:`render_sharded`) or image rows
  (the megakernel, :func:`render_sharded_pallas`) are split into equal
  contiguous shares over the mesh dim ``"tiles"``; each rank renders its
  share and one ``all_gather`` gives every rank the image.  The scene is
  small and whole on every rank.
* **Backward**: every rank's pixels reach the same scene leaves, so the
  local gradients end in one ``all_reduce(SUM)`` (with the loss), in the
  leaf order of ``diff.partition``.
* **Scene parallelism** (:func:`render_scene_parallel`,
  :func:`render_sharded_2d`): every rank of a ``"tri"`` group traces the
  same rays and queries only its slice of the triangles; the per-query
  reductions are in :class:`kernels.trace.TriangleQueries`.

Every rank of a mesh must make the same calls in the same order: a rank
that skips a collective leaves the others waiting in it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import diff
from ..camera import PerspectiveBasis, generate_rays
from ..config import RenderConfig
from ..kernels.trace import trace_rays
from ..render import render_from_basis
from ..scene import Scene
from ..textures import SceneAssets

AXIS = "tiles"
TRI_AXIS = "tri"


def make_mesh(n: Optional[int] = None, device=None,
              shape: Optional[Tuple[int, int]] = None) -> DeviceMesh:
    """The render mesh over the world's ranks: 1-D over dim ``AXIS``, or,
    with ``shape=(tiles, tri)``, 2-D over dims ``(AXIS, TRI_AXIS)``.

    ``device`` defaults to CUDA.  Raises when no process group is set up
    (:func:`distributed.ensure_initialized`) or when the world has not
    ``n`` ranks (``prod(shape)`` for a 2-D mesh): a silently degraded
    1-rank mesh would make sharding tests pass without testing sharding.
    """
    device_type = torch.device(device if device is not None else "cuda").type
    if not dist.is_initialized():
        raise ValueError("no process group: run the ranks under "
                         "distributed.launch or torchrun, or call "
                         "distributed.ensure_initialized first")
    world, rank = dist.get_world_size(), dist.get_rank()
    dims = tuple(shape) if shape is not None else (world if n is None
                                                   else n,)
    want = 1
    for k in dims:
        want *= k
    if want != world:
        raise ValueError(f"requested a mesh of {want} rank(s) {dims} but "
                         f"the world has {world} (this is rank {rank}); "
                         f"launch a world of {want}")
    names = (AXIS,) if len(dims) == 1 else (AXIS, TRI_AXIS)
    return init_device_mesh(device_type, dims, mesh_dim_names=names)


def _share(n_items: int, n_shares: int, k: int) -> Tuple[int, int, int]:
    """(per, lo, hi): share ``k`` of ``ceil(n_items / n_shares)`` items,
    ``[lo, hi)`` of them real (empty past the end)."""
    per = -(-n_items // n_shares)
    lo = min(k * per, n_items)
    return per, lo, min(lo + per, n_items)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The equal-sized ``x`` of every rank of ``group``, concatenated in
    rank order on dim 0."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _trace(scene, assets, o, d, ids, cfg: RenderConfig, tri_group=None):
    """``trace_rays`` over the rays in chunks of ``cfg.chunk_size``."""
    n = o.shape[0]
    chunk = min(cfg.chunk_size or n, n) or 1
    parts = [trace_rays(scene, assets, o[a:a + chunk], d[a:a + chunk],
                        ids[a:a + chunk], cfg, tri_group=tri_group)
             for a in range(0, n, chunk)]
    return torch.cat(parts) if parts else o.new_zeros((0, 3))


def _render_pixel_share(scene, assets, basis, cfg, tiles, tri_group=None):
    """This rank's ``ceil(n_pix / n)`` pixels of the tracer's image over the
    ``tiles`` group, gathered into [H, W, 3]; a share's lanes past the image
    are zeros and cut off."""
    n_pix = cfg.width * cfg.height
    per, lo, hi = _share(n_pix, dist.get_world_size(tiles),
                         dist.get_rank(tiles))
    o, d = generate_rays(basis, cfg.width, cfg.height)
    ids = torch.arange(lo, hi, device=o.device)   # global: they seed the rng
    rgb = torch.zeros(per, 3, dtype=torch.float32, device=o.device)
    rgb[:hi - lo] = _trace(scene, assets, o[lo:hi], d[lo:hi], ids, cfg,
                           tri_group)
    return _all_gather(rgb, tiles)[:n_pix].reshape(cfg.height, cfg.width, 3)


def render_sharded(scene: Scene, assets: SceneAssets, basis: PerspectiveBasis,
                   cfg: RenderConfig, mesh: DeviceMesh) -> torch.Tensor:
    """The tracer's forward render with the pixels sharded over ``mesh``:
    float32 linear rgb [H, W, 3], the whole image on every rank."""
    with torch.no_grad():
        return _render_pixel_share(scene, assets, basis, cfg,
                                   mesh.get_group(AXIS))


def render_scene_parallel(scene: Scene, assets: SceneAssets,
                          basis: PerspectiveBasis, cfg: RenderConfig,
                          mesh: DeviceMesh) -> torch.Tensor:
    """The tracer's forward render with the TRIANGLES sharded over the 1-D
    ``mesh``: every rank traces every ray and queries only its
    ``ceil(T / n)`` triangles; each query's answer is reduced over the mesh
    (min of t then of the winner's global id, max of the blocked flag, sum
    of the transparent count).  float32 linear rgb [H, W, 3] on every rank,
    equal to the single-rank tracer's."""
    if mesh.ndim != 1:
        raise ValueError(f"render_scene_parallel shards over a 1-D mesh; got "
                         f"dims {mesh.mesh_dim_names}: use render_sharded_2d "
                         "for pixels x triangles")
    o, d = generate_rays(basis, cfg.width, cfg.height)
    ids = torch.arange(cfg.width * cfg.height, device=o.device)
    with torch.no_grad():
        rgb = _trace(scene, assets, o, d, ids, cfg, mesh.get_group())
    return rgb.reshape(cfg.height, cfg.width, 3)


def render_sharded_2d(scene: Scene, assets: SceneAssets,
                      basis: PerspectiveBasis, cfg: RenderConfig,
                      mesh: DeviceMesh) -> torch.Tensor:
    """The tracer's forward render over a 2-D mesh of dims ``(AXIS,
    TRI_AXIS)``: pixels sharded over ``AXIS`` as in :func:`render_sharded`,
    and each pixel share's triangle queries over its ``TRI_AXIS`` group,
    whose reductions stay inside that group."""
    if mesh.mesh_dim_names != (AXIS, TRI_AXIS):
        raise ValueError(f"render_sharded_2d needs mesh dims "
                         f"{(AXIS, TRI_AXIS)}, got {mesh.mesh_dim_names}")
    with torch.no_grad():
        return _render_pixel_share(scene, assets, basis, cfg,
                                   mesh.get_group(AXIS),
                                   mesh.get_group(TRI_AXIS))


def _row_share(cfg: RenderConfig, mesh: DeviceMesh):
    """(row0, the config) of this rank's slab of ``ceil(H / n)`` rows; the
    last slabs may reach past the image."""
    rows_per = -(-cfg.height // mesh.size())
    return mesh.get_local_rank() * rows_per, cfg.replace(height=rows_per)


def render_sharded_pallas(scene: Scene, assets: SceneAssets,
                          basis: PerspectiveBasis, cfg: RenderConfig,
                          mesh: DeviceMesh) -> torch.Tensor:
    """The megakernel's forward render with image ROWS sharded over the
    1-D ``mesh`` (the JAX function's name, after its Pallas megakernel).

    Rank r renders the ``ceil(H / n)`` rows from ``row0 = r * ceil(H / n)``
    through ``render_from_basis(..., row0)``: ray directions and each
    pixel's rng seed come from the global row, so the gathered image (cut
    to H rows) equals the unsharded render.  ``basis`` is the whole
    frame's.  float32 linear rgb [H, W, 3] on every rank."""
    row0, sub_cfg = _row_share(cfg, mesh)
    img = render_from_basis(scene, assets, basis, sub_cfg, row0)
    return _all_gather(img, mesh.get_group())[:cfg.height]


def _all_reduce_grads(loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                      group) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One ``all_reduce(SUM)`` of the loss and every gradient, flattened in
    the dict's order (``diff.partition``'s, the same on every rank)."""
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1)
                                          for g in grads.values()])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = {}, 1
    for k, g in grads.items():
        out[k] = flat[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
    return flat[0], out


def loss_and_scene_grad_sharded(
        scene: Scene, assets: SceneAssets, basis: PerspectiveBasis,
        target: torch.Tensor, cfg: RenderConfig,
        mesh: DeviceMesh) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tracer's L2 loss and its gradient with respect to every float
    leaf of ``scene`` (a dict by leaf name), with the pixels sharded over
    ``mesh`` and one ``all_reduce`` of the loss and the gradients.

    ``target`` is [H*W, 3] float32 linear rgb; ``cfg.loop`` must be
    ``'scan'``, as in the JAX package.  A rank traces only its share's
    pixels inside the image, so the padded lanes carry no loss."""
    if cfg.loop != "scan":
        raise ValueError(f"loss_and_scene_grad_sharded needs loop='scan', "
                         f"got {cfg.loop!r}")
    group = mesh.get_group(AXIS)
    n_pix = cfg.width * cfg.height
    _, lo, hi = _share(n_pix, mesh.size(), mesh.get_local_rank())
    o, d = generate_rays(basis, cfg.width, cfg.height)
    ids = torch.arange(lo, hi, device=o.device)
    tgt = target.reshape(-1, 3)[lo:hi]

    def local_loss(s):
        rgb = _trace(s, assets, o[lo:hi], d[lo:hi], ids, cfg)
        return torch.sum((rgb - tgt) ** 2)

    if hi > lo:
        loss, grads = diff.value_and_scene_grad(local_loss, scene)
    else:       # a share past the image: zeros into the all-reduce
        loss = torch.zeros((), device=o.device)
        grads = {k: torch.zeros_like(v)
                 for k, v in diff.partition(scene)[0].items()}
    return _all_reduce_grads(loss, grads, group)


def loss_and_scene_grad_sharded_pallas(
        scene: Scene, assets: SceneAssets, basis: PerspectiveBasis,
        target: torch.Tensor, cfg: RenderConfig,
        mesh: DeviceMesh) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The L2 loss and scene gradient on the megakernel, image rows sharded
    over ``mesh``: each rank renders its slab of rows through the
    record-mode megakernel (``diff.render_megakernel_diff`` with the slab's
    ``row0``), replays it backward, and the loss and the gradients go
    through one ``all_reduce``.  ``target`` is [H, W, 3] float32; the loss
    is taken on the image clamped to [0, 1], as ``apps/invrender``'s, and
    a slab's rows at or past H carry none.  Records and the replay's host
    sync are each rank's own."""
    row0, sub_cfg = _row_share(cfg, mesh)
    rows = max(0, min(sub_cfg.height, cfg.height - row0))
    tgt = target[row0:row0 + rows]

    def local_loss(s):
        img = diff.render_megakernel_diff(s, assets, basis, sub_cfg, row0)
        return torch.sum((img[:rows].clamp(0.0, 1.0) - tgt) ** 2)

    loss, grads = diff.value_and_scene_grad(local_loss, scene)
    return _all_reduce_grads(loss, grads, mesh.get_group())


def dryrun(device=None) -> dict:
    """Run by every rank of a world: one sharded forward on each engine,
    one sharded loss and gradient on each, the scene-parallel render and,
    on an even world, the 2-D one, on tiny shapes; checks the shapes and
    that the losses are finite.  Returns {name: shape or value}."""
    from ..camera import Camera, perspective_basis
    from ..config import GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN
    from ..meshes import mesh_benchmark_scene
    from ..scene import build_scene, canonical_scene_spec
    from ..textures import solid_assets
    from . import distributed

    device = torch.device(device if device is not None else "cuda")
    if not distributed.ensure_initialized(device=device):
        raise RuntimeError("dryrun runs on every rank of a world "
                           "(dryrun_multichip launches one)")
    mesh = make_mesh(device=device)
    world = mesh.size()
    scene = build_scene(canonical_scene_spec(), device)
    assets = solid_assets(4, device=device)    # the floor reads texture 2
    cfg = RenderConfig(width=32, height=16, max_depth=2, chunk_size=0,
                       loop="scan", scan_iters=10)
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR, 90.0, 1.0)
    basis = perspective_basis(cam, cfg.width, cfg.height, device=device)
    shape = (cfg.height, cfg.width, 3)
    out = {}

    for name, fn in (("render_sharded", render_sharded),
                     ("render_sharded_pallas", render_sharded_pallas)):
        img = fn(scene, assets, basis, cfg, mesh)
        if tuple(img.shape) != shape:
            raise RuntimeError(f"{name} gave {tuple(img.shape)}")
        out[name] = tuple(img.shape)
    for name, fn, target in (
            ("loss_and_scene_grad_sharded", loss_and_scene_grad_sharded,
             torch.zeros(cfg.width * cfg.height, 3, device=device)),
            ("loss_and_scene_grad_sharded_pallas",
             loss_and_scene_grad_sharded_pallas,
             torch.zeros(shape, device=device))):
        loss, _ = fn(scene, assets, basis, target, cfg, mesh)
        if not bool(torch.isfinite(loss)):
            raise RuntimeError(f"{name}: loss {float(loss)}")
        out[name] = float(loss)

    tscene = build_scene(mesh_benchmark_scene(order=0, torus_res=(8, 4)),
                         device)
    img = render_scene_parallel(tscene, assets, basis, cfg, mesh)
    out["render_scene_parallel"] = tuple(img.shape)
    if world % 2 == 0:
        mesh2d = make_mesh(device=device, shape=(world // 2, 2))
        img = render_sharded_2d(tscene, assets, basis, cfg, mesh2d)
        out["render_sharded_2d"] = tuple(img.shape)
    return out


def dryrun_multichip(n: int, device=None, backend: Optional[str] = None,
                     timeout: float = 600.0) -> list:
    """:func:`dryrun` over a fresh world of ``n`` ranks (the counterpart of
    ``__graft_entry__.dryrun_multichip``); on CUDA unless ``device`` says
    otherwise.  Several ranks on one card need ``backend='gloo'``: NCCL
    refuses them."""
    from .distributed import launch
    device = device if device is not None else "cuda"
    return launch(dryrun, n, device, backend=backend, device=device,
                  timeout=timeout)
