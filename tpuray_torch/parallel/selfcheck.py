"""The sharded paths on a local world of ranks, with their single-rank
counterparts, saved for a comparison: the CPU rig of the port's sharding.

    python -m tpuray_torch.parallel.selfcheck --world 2 --device cpu \
        --out r.npz
    python -m tpuray_torch.parallel.selfcheck --world 4 --mesh 2x2 \
        --device cpu --out r.npz

It launches ``--world`` ranks (:func:`distributed.launch`, gloo on the CPU);
every rank runs the same calls of :mod:`shard` on tiny shapes, and rank 0
also renders each case on its own, without a process group.  A 1-D world
runs, on the scenes of the JAX package's sharding checks
(``tests/sharding_subproc.py``): the tracer with pixels sharded (``a``),
the megakernel with rows sharded (``b``, and ``b_mesh`` on 272 triangles),
the tracer's and the megakernel's sharded loss and gradient (``c``, ``d``),
triangles sharded (``e``), a one-triangle scene whose second slice is
empty (``h``), two coincident triangles in different slices (``i``; the
single-rank ``sphere`` and ``i_second`` renders show which one won) and a
mesh larger than the world (``k``, its error message).  ``--mesh 2x2``
runs pixels x triangles (``f``).  The results go to one ``.npz``: for each
case ``<case>/sharded`` and ``<case>/single`` (losses and gradients under
``<case>/sharded/loss``, ``<case>/sharded/grad/<leaf>``), and the inputs
(``scene/<leaf>``, ``mesh_scene/<leaf>``, ``target/<case>``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..camera import Camera, perspective_basis
from ..config import (GOLDEN_CAMERA_FOCAL, GOLDEN_CAMERA_FOV,
                      GOLDEN_CAMERA_LOOKDIR, GOLDEN_CAMERA_ORIGIN,
                      RenderConfig)
from ..diff import render_megakernel_diff, value_and_scene_grad
from ..meshes import mesh_benchmark_scene
from ..render import render_from_basis, render_from_basis_tracer
from ..scene import (GLASS, PLASTIC, LightSpec, PlaneSpec, SceneSpec,
                     SphereSpec, TriangleSpec, build_scene, scene_leaves)
from ..textures import solid_assets
from . import distributed, shard

# flat assets, four textures as the canonical scene's planes use: a colour
# above 0 keeps the clamped loss away from clamp ties
ASSET_RGB = (32, 64, 96)
N_TEXTURES = 4
TARGET_SEED = 0
FORWARD = RenderConfig(width=64, height=32, max_depth=3, chunk_size=0)
SMALL = RenderConfig(width=32, height=16, max_depth=2, chunk_size=0)
GRAD = SMALL.replace(loop="scan", scan_iters=8)


def sphere_spec() -> SceneSpec:
    """``tests/sharding_subproc.py``'s scene: a red plastic and a glass
    sphere on a grey plane, one light."""
    return SceneSpec(
        spheres=[SphereSpec((0.0, 1.0, 3.0), 1.0,
                            PLASTIC.replace(rgb=(1.0, 0.2, 0.2))),
                 SphereSpec((1.5, 0.7, 2.0), 0.7, GLASS)],
        planes=[PlaneSpec((0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                          PLASTIC.replace(rgb=(0.4, 0.4, 0.4)))],
        lights=[LightSpec((2.0, 4.0, 0.0), 0.1, 30.0, (1.0, 1.0, 1.0))])


def triangle_spec(colours) -> SceneSpec:
    """The sphere scene with one opaque triangle per colour, all at the
    same place in front of the spheres (coincident where there are two)."""
    spec = sphere_spec()
    spec.triangles = [TriangleSpec((-2.5, 0.1, 1.2), (2.0, 0.1, 1.0),
                                   (-0.3, 3.0, 1.2),
                                   PLASTIC.replace(rgb=rgb))
                      for rgb in colours]
    return spec


def mesh_spec() -> SceneSpec:
    """``tests/sharding_subproc.py``'s mesh scene: 272 triangles."""
    return mesh_benchmark_scene(order=1, torus_res=(12, 8))


def targets(cfg: RenderConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded targets of the two losses: [H*W, 3] and [H, W, 3]."""
    rng = np.random.default_rng(TARGET_SEED)
    return (rng.uniform(0, 1, (cfg.width * cfg.height, 3)).astype(np.float32),
            rng.uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32))


def _np(x):
    return x.detach().cpu().numpy()


def _grads(prefix, loss, grads, out):
    out[f"{prefix}/loss"] = _np(loss)
    for k, g in grads.items():
        out[f"{prefix}/grad/{k}"] = _np(g)


def checks(device, mesh_shape: Optional[Tuple[int, int]] = None) -> dict:
    """Run on every rank of a world: the cases of the module docstring.
    Returns rank 0's results (numpy, by name), None on the other ranks."""
    device = torch.device(device)
    rank = torch.distributed.get_rank()
    cam = Camera(GOLDEN_CAMERA_ORIGIN, GOLDEN_CAMERA_LOOKDIR,
                 GOLDEN_CAMERA_FOV, GOLDEN_CAMERA_FOCAL)
    assets = solid_assets(N_TEXTURES, rgb=ASSET_RGB, device=device)

    def basis(cfg):
        return perspective_basis(cam, cfg.width, cfg.height, device=device)

    def tracer(s, cfg):
        return render_from_basis_tracer(s, assets, basis(cfg), cfg)

    out = {"backend": np.array(torch.distributed.get_backend())}

    def single(name, fn):
        # the single-rank counterpart: rank 0 only, no collective
        if rank == 0:
            out[f"{name}/single"] = _np(fn())

    if mesh_shape is not None:
        mesh = shard.make_mesh(device=device, shape=mesh_shape)
        scene = build_scene(mesh_spec(), device)
        out["f/sharded"] = _np(shard.render_sharded_2d(
            scene, assets, basis(SMALL), SMALL, mesh))
        single("f", lambda: tracer(scene, SMALL))
        return out if rank == 0 else None

    mesh = shard.make_mesh(device=device)
    scene = build_scene(sphere_spec(), device)
    tscene = build_scene(mesh_spec(), device)
    for prefix, s in (("scene", scene), ("mesh_scene", tscene)):
        for k, v in scene_leaves(s).items():
            out[f"{prefix}/{k}"] = _np(v)

    out["a/sharded"] = _np(shard.render_sharded(scene, assets,
                                                basis(FORWARD), FORWARD,
                                                mesh))
    single("a", lambda: tracer(scene, FORWARD))
    for name, s, cfg in (("b", scene, FORWARD), ("b_mesh", tscene, SMALL)):
        out[f"{name}/sharded"] = _np(shard.render_sharded_pallas(
            s, assets, basis(cfg), cfg, mesh))
        single(name, lambda: render_from_basis(s, assets, basis(cfg), cfg))

    flat_target, img_target = targets(GRAD)
    out["target/c"], out["target/d"] = flat_target, img_target
    tgt = torch.from_numpy(flat_target).to(device)
    _grads("c/sharded", *shard.loss_and_scene_grad_sharded(
        scene, assets, basis(GRAD), tgt, GRAD, mesh), out)
    if rank == 0:
        _grads("c/single", *value_and_scene_grad(
            lambda s: torch.sum((tracer(s, GRAD).reshape(-1, 3) - tgt) ** 2),
            scene), out)
    tgt = torch.from_numpy(img_target).to(device)
    _grads("d/sharded", *shard.loss_and_scene_grad_sharded_pallas(
        scene, assets, basis(GRAD), tgt, GRAD, mesh), out)
    if rank == 0:
        _grads("d/single", *value_and_scene_grad(
            lambda s: torch.sum((render_megakernel_diff(
                s, assets, basis(GRAD), GRAD).clamp(0.0, 1.0) - tgt) ** 2),
            scene), out)
        out["d/image"] = _np(render_from_basis(scene, assets, basis(GRAD),
                                               GRAD))

    colours = [(0.9, 0.6, 0.1), (0.1, 0.3, 0.9)]
    for name, s in (("e", tscene),
                    ("h", build_scene(triangle_spec(colours[:1]), device)),
                    ("i", build_scene(triangle_spec(colours), device))):
        out[f"{name}/sharded"] = _np(shard.render_scene_parallel(
            s, assets, basis(SMALL), SMALL, mesh))
        single(name, lambda: tracer(s, SMALL))
    # the scene without its triangle, and the second triangle alone
    for name, s in (("sphere", scene),
                    ("i_second", build_scene(triangle_spec(colours[1:]),
                                             device))):
        single(name, lambda: tracer(s, SMALL))

    try:
        shard.make_mesh(mesh.size() + 1, device=device)
        out["k/message"] = np.array("")
    except ValueError as e:
        out["k/message"] = np.array(str(e))
    return out if rank == 0 else None


def raise_on_rank(rank_to_fail: int) -> int:
    """Run by every rank: rank ``rank_to_fail`` raises, the others wait in
    a collective (a launch must fail with the message, not hang)."""
    rank = torch.distributed.get_rank()
    if rank == rank_to_fail:
        raise RuntimeError(f"rank {rank} failed on purpose")
    torch.distributed.barrier()
    return rank


def hang_on_rank(rank_to_hang: int) -> int:
    """Run by every rank: rank ``rank_to_hang`` sleeps, the others wait for
    it in a collective (a launch must end at its timeout)."""
    rank = torch.distributed.get_rank()
    if rank == rank_to_hang:
        time.sleep(3600)
    torch.distributed.barrier()
    return rank


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--mesh", default=None,
                    help="a 2-D mesh TILESxTRI, e.g. 2x2 (default: 1-D)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", required=True, help="the .npz to write")
    args = ap.parse_args(argv)
    shape = (tuple(int(k) for k in args.mesh.split("x"))
             if args.mesh else None)
    t0 = time.perf_counter()
    res = distributed.launch(checks, args.world, args.device, shape,
                             backend=args.backend, device=args.device,
                             timeout=args.timeout)[0]
    np.savez(args.out, **res)
    print(f"selfcheck: world {args.world}, mesh {args.mesh or '1-D'}, "
          f"{len(res)} arrays in {time.perf_counter() - t0:.1f} s -> "
          f"{args.out}", flush=True)


if __name__ == "__main__":
    main()
