"""Differentiable rendering: scene leaves and the megakernel's gradient.

Port of :mod:`tpuray.diff`.  A ``Scene`` mixes float leaves (geometry,
materials, lights: all differentiable) with integer and bool leaves
(texture ids, material flags: structural).  :func:`partition` and
:func:`combine` split and rejoin the two, as dicts keyed by leaf name
(``sphere_mat.rgb`` etc., :func:`scene.scene_leaves`).

:func:`render_megakernel_diff` is the counterpart of ``render_pallas_diff``
(``tpuray/diff.py:73-120``): the forward is the record-mode megakernel (K5,
the CUDA kernel on the card), the backward is autograd through the replay
(``kernels/replay.py``, :func:`replay_vjp`), wrapped in a
``torch.autograd.Function``.  On a CUDA device the backward replays one
captured CUDA graph of that work (:class:`ReplayGraph`): the JAX package
jits the whole step, so its replay is one XLA program; run eagerly, the
port's replay is ~11,400 launches from the host a training step.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .camera import PerspectiveBasis
from .config import RenderConfig
from .kernels.megakernel import pack_scene, render_megakernel_record
from .kernels.replay import record_slots, replay_render
from .scene import Scene, scene_from_leaves, scene_leaves
from .textures import SceneAssets

Leaves = Dict[str, torch.Tensor]
_BASIS_FIELDS = ("corner", "origin", "up", "right", "w_factor", "h_factor")
_RECORD_FIELDS = ("rec", "ssr", "pick", "wid")


def partition(scene: Scene) -> Tuple[Leaves, Leaves]:
    """(float leaves, other leaves) of ``scene``, by leaf name."""
    leaves = scene_leaves(scene)
    diff = {k: v for k, v in leaves.items() if v.is_floating_point()}
    rest = {k: v for k, v in leaves.items() if not v.is_floating_point()}
    return diff, rest


def combine(diff: Leaves, rest: Leaves) -> Scene:
    """Inverse of :func:`partition`."""
    return scene_from_leaves({**diff, **rest})


def value_and_scene_grad(fn: Callable[..., torch.Tensor], scene: Scene,
                         *args, **kw):
    """(value, grads) of the scalar ``fn(scene, *args, **kw)`` with respect
    to every float leaf of ``scene``; ``grads`` is a dict by leaf name, with
    zeros for leaves the value does not depend on."""
    diff, rest = partition(scene)
    leaves = {k: v.detach().requires_grad_() for k, v in diff.items()}
    value = fn(combine(leaves, rest), *args, **kw)
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True)
    return value.detach(), {k: torch.zeros_like(v) if g is None else g
                            for (k, v), g in zip(leaves.items(), grads)}


def l2_image_loss(rendered: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    return torch.sum((rendered - target) ** 2)


def replay_vjp(leaves: Leaves, basis: PerspectiveBasis, rest: Leaves,
               records: dict, grad_img: torch.Tensor, assets: SceneAssets,
               cfg: RenderConfig, row0: int, need: Sequence[bool], *,
               n_slots: Optional[int] = None) -> List[Optional[torch.Tensor]]:
    """The vector-Jacobian product of the replay: the gradients of
    ``sum(replay_render(...) * grad_img)`` with respect to the float
    ``leaves`` (in their order), then the six basis tensors: ``None`` where
    ``need`` is false, zeros for a wanted tensor the replay does not read.

    The backward of :func:`render_megakernel_diff`, run as it stands on the
    CPU; on a CUDA device the backward replays it as one captured CUDA graph
    (:class:`ReplayGraph`).  ``n_slots`` as in ``replay_render``."""
    tensors = [*leaves.values(), *(getattr(basis, f) for f in _BASIS_FIELDS)]
    n = len(leaves)
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(want)
                  for t, want in zip(tensors, need)]
        scene = combine(dict(zip(leaves, inputs[:n])), rest)
        img = replay_render(scene, assets, PerspectiveBasis(*inputs[n:]),
                            records, cfg, row0, n_slots=n_slots)
        wanted = [t for t in inputs if t.requires_grad]
        grads = (torch.autograd.grad(img, wanted, grad_img,
                                     allow_unused=True)
                 if img.requires_grad else [None] * len(wanted))
    grads = iter(grads)
    out = []
    for t in inputs:
        g = next(grads) if t.requires_grad else None
        if g is None and t.requires_grad:
            g = torch.zeros_like(t)   # a leaf the replay does not read
        out.append(g)
    return out


@dataclasses.dataclass(frozen=True)
class ReplayKey:
    """Everything that changes the work a captured replay does: the image
    and its first row, the record slots (``krec``) and those replayed
    (``n_slots``), the scene's counts (spheres, planes, lights, triangles),
    the filter, epsilon and default n, the gradients wanted, the device,
    the assets (pointer, shape, dtype: they are read in place, not copied)
    and the shape and dtype of every tensor copied in."""
    device: str
    height: int
    width: int
    row0: int
    krec: int
    n_slots: int
    counts: Tuple[int, int, int, int]
    filter: str
    epsilon: float
    default_n: float
    need: Tuple[bool, ...]
    assets: Tuple[tuple, tuple]
    inputs: Tuple[tuple, ...]


def _replay_inputs(leaves, basis, rest, records, grad_img, n_slots):
    """Every tensor the replay reads but the assets, in a fixed order: the
    float leaves, the basis, the other leaves, the replayed slots of the
    records, ``grad_img``."""
    return [*leaves.values(), *(getattr(basis, f) for f in _BASIS_FIELDS),
            *rest.values(), *(records[k][:n_slots] for k in _RECORD_FIELDS),
            grad_img]


def replay_key(leaves: Leaves, basis: PerspectiveBasis, rest: Leaves,
               records: dict, grad_img: torch.Tensor, assets: SceneAssets,
               cfg: RenderConfig, row0: int, need: Sequence[bool],
               n_slots: int) -> ReplayKey:
    """The :class:`ReplayKey` of :func:`replay_vjp`'s arguments."""
    scene = combine(leaves, rest)
    names = [*leaves, *_BASIS_FIELDS, *rest, *_RECORD_FIELDS, "grad_img"]
    tensors = _replay_inputs(leaves, basis, rest, records, grad_img, n_slots)
    return ReplayKey(
        device=str(grad_img.device), height=cfg.height, width=cfg.width,
        row0=row0, krec=records["rec"].shape[0], n_slots=n_slots,
        counts=(scene.num_spheres, scene.num_planes, scene.num_lights,
                scene.num_triangles),
        filter=cfg.filter, epsilon=cfg.epsilon, default_n=cfg.default_n,
        need=tuple(bool(w) for w in need),
        assets=tuple((t.data_ptr(), tuple(t.shape), str(t.dtype))
                     for t in (assets.textures, assets.skybox)),
        inputs=tuple((k, tuple(t.shape), str(t.dtype))
                     for k, t in zip(names, tensors)))


class ReplayGraph:
    """:func:`replay_vjp` captured as one CUDA graph and replayed: the same
    kernels in the same order, launched by one call in place of one host
    launch each (~11,400 a training step at 512x384 depth 3).

    One per process (:data:`replay_graph`), so that trainers of the same
    shapes replay one capture, each through its own copies; it holds at
    most one captured replay, for one :class:`ReplayKey`.  The first call with a key runs
    eagerly (it is the capture's warm-up) and drops the graph held for
    another key, with its memory pool; the second captures
    (``torch.cuda.graph`` synchronises and empties the allocator's cache
    first) and replays; later ones copy their inputs into the graph's
    static tensors and replay.  Every tensor the replay reads is copied (the
    records too: two forwards before one backward keep their own), but the
    assets, which the key holds by pointer.  The gradients returned are
    clones, so the next replay cannot overwrite them.  A capture or replay
    that fails raises ``RuntimeError`` naming the key.  ``captures`` and
    ``replays`` count the graph's captures and replays."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.key: Optional[ReplayKey] = None     # the captured replay's
        self._warm: Optional[ReplayKey] = None   # the last eager call's
        self._graph = self._static = self._out = None
        self._lock = threading.Lock()

    def release(self) -> None:
        """Drop the captured replay, return its pool to the device and
        forget the last key: the next call runs eagerly."""
        with self._lock:
            self._release()

    def _release(self):
        self._warm = None
        if self._graph is not None:
            self.key = self._graph = self._static = self._out = None
            torch.cuda.empty_cache()

    def vjp(self, leaves: Leaves, basis: PerspectiveBasis, rest: Leaves,
            records: dict, grad_img: torch.Tensor, assets: SceneAssets,
            cfg: RenderConfig, row0: int,
            need: Sequence[bool]) -> List[Optional[torch.Tensor]]:
        """:func:`replay_vjp` on a CUDA device, through the graph."""
        with self._lock:
            n_slots = record_slots(records)     # the backward's one sync
            key = replay_key(leaves, basis, rest, records, grad_img, assets,
                             cfg, row0, need, n_slots)
            sources = _replay_inputs(leaves, basis, rest, records, grad_img,
                                     n_slots)
            if key != self.key:
                if key != self._warm:
                    self._release()
                    self._warm = key
                    return replay_vjp(leaves, basis, rest, records, grad_img,
                                      assets, cfg, row0, need,
                                      n_slots=n_slots)
                self._capture(key, sources, list(leaves), list(rest),
                              assets, cfg, row0, need)
            try:
                for dst, src in zip(self._static, sources):
                    dst.copy_(src)
                self._graph.replay()
            except RuntimeError as e:
                self._release()
                raise _failure(e, "replaying", key) from e
            self.replays += 1
            return [None if g is None else g.clone() for g in self._out]

    def _capture(self, key, sources, names, rest_names, assets, cfg, row0,
                 need):
        self._release()
        static = [t.clone(memory_format=torch.contiguous_format)
                  for t in sources]
        n, m = len(names), len(names) + len(_BASIS_FIELDS)
        k = m + len(rest_names)
        graph = torch.cuda.CUDAGraph()
        try:
            # on a side stream, after a device-wide synchronise, with the
            # allocator's cache emptied (the eager call's blocks); the
            # capture's allocations go to the graph's private pool
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = replay_vjp(
                    dict(zip(names, static[:n])),
                    PerspectiveBasis(*static[n:m]),
                    dict(zip(rest_names, static[m:k])),
                    dict(zip(_RECORD_FIELDS, static[k:-1])), static[-1],
                    assets, cfg, row0, need, n_slots=key.n_slots)
        except RuntimeError as e:
            del graph
            torch.cuda.empty_cache()
            raise _failure(e, "capturing", key) from e
        self.key, self._graph, self._static, self._out = (key, graph,
                                                          static, out)
        self.captures += 1


def _failure(e: RuntimeError, what: str, key: ReplayKey) -> RuntimeError:
    """The error a failed capture or replay raises: out of memory stays
    out of memory."""
    cls = (torch.cuda.OutOfMemoryError
           if isinstance(e, torch.cuda.OutOfMemoryError) else RuntimeError)
    return cls(f"{what} the replay's CUDA graph failed, key {key}: {e}")


replay_graph = ReplayGraph()


class _RecordReplay(torch.autograd.Function):
    """Forward: the record-mode megakernel.  Backward: the replay's VJP,
    through :data:`replay_graph` on a CUDA device; eagerly
    (:func:`replay_vjp`) on the CPU and while autograd's anomaly mode is on
    (``utils.debug.nan_guard`` turns it on), whose NaN checks read values
    back on the host, which a capture cannot hold."""

    @staticmethod
    def forward(ctx, side, *tensors):
        names, rest, assets, cfg, row0 = side
        n = len(names)
        leaves = dict(zip(names, tensors[:n]))
        basis = PerspectiveBasis(*tensors[n:])
        img, records = render_megakernel_record(
            pack_scene(combine(leaves, rest), basis, row0), assets, cfg)
        ctx.side = side
        ctx.records = records
        ctx.save_for_backward(*tensors)
        return img

    @staticmethod
    def backward(ctx, grad_img):
        names, rest, assets, cfg, row0 = ctx.side
        saved = ctx.saved_tensors
        n = len(names)
        args = (dict(zip(names, saved[:n])), PerspectiveBasis(*saved[n:]),
                rest, ctx.records, grad_img, assets, cfg, row0,
                ctx.needs_input_grad[1:])
        if grad_img.device.type == "cuda" and not torch.is_anomaly_enabled():
            return (None, *replay_graph.vjp(*args))
        return (None, *replay_vjp(*args))


def render_megakernel_diff(scene: Scene, assets: SceneAssets,
                           basis: PerspectiveBasis, cfg: RenderConfig,
                           row0: int = 0) -> torch.Tensor:
    """Differentiable megakernel render: [H, W, 3] f32 linear rgb.

    The forward is the record-mode megakernel (the same image as
    :func:`kernels.megakernel.render_megakernel`, plus the node records);
    the backward is autograd through :func:`kernels.replay.replay_render`
    on those records.  Gradients reach every float leaf of ``scene`` and
    the basis tensors that require them; the u8 assets, the integer leaves
    and ``cfg`` carry none.  ``row0`` is the first image row rendered."""
    diff, rest = partition(scene)
    names = tuple(diff)
    tensors = [*diff.values(), *(getattr(basis, f) for f in _BASIS_FIELDS)]
    return _RecordReplay.apply((names, rest, assets, cfg, row0), *tensors)
