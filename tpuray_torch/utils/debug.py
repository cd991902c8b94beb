"""Debug hooks: NaN guards and finiteness checks.

Port of :mod:`tpuray.utils.debug`.  The failure modes that remain in a
pure-function renderer are NaN/Inf propagation (refract, normalise and pow
edge cases) and a kernel that writes wrong values:

* :func:`nan_guard` raises on the first NaN that an op makes.  The JAX
  package switches on ``jax_debug_nans``; here a ``TorchDispatchMode``
  checks the floating outputs of every PyTorch op, and
  ``torch.autograd.detect_anomaly(check_nan=True)`` covers the backward.
  The CUDA kernels are launched through ``ctypes``, out of the dispatcher's
  sight, so their wrappers call :func:`check_kernel_output` on what they
  return (on the CPU too); it does nothing unless a guard is active in the
  thread.  The whole-image plain versions (the megakernel's, the tracer,
  the replay) make NaNs on lanes whose results they drop (``refract``'s
  n1 / n2 where a lane's material has n = 0), so a guard over a render on
  the CPU raises where the render is right; on the card a megakernel
  render is one kernel and passes.  The guard turns on autograd's anomaly
  mode, and under it ``diff.render_megakernel_diff``'s backward runs the
  replay eagerly on the card too, not as its captured CUDA graph: the
  guard's checks read each value back on the host, which a capture cannot
  hold.
* :func:`check_finite` asserts that every floating leaf of a nested
  dict/list/tuple of tensors or arrays is finite (host side, for tests and
  the apps' ``--selfcheck``).

``interpret_mode`` has no counterpart: a CUDA kernel has no interpreter.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

_GUARD = threading.local()

# ops whose output is uninitialised memory, which may hold any bit pattern
_UNINITIALISED = frozenset(("empty", "empty_like", "empty_strided",
                            "empty_permuted", "new_empty",
                            "new_empty_strided"))


def _nan_count(t: torch.Tensor) -> int:
    if not (t.is_floating_point() or t.is_complex()) \
            or t.layout != torch.strided or t.device.type == "meta":
        return 0
    return int(torch.isnan(t).sum())


class _NanGuardMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            for t in _pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    bad = _nan_count(t)
                    if bad:
                        raise FloatingPointError(
                            f"nan_guard: {func} made {bad} NaN values "
                            f"(shape {tuple(t.shape)})")
        return out


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Raise ``FloatingPointError`` on the first NaN made inside, by a
    PyTorch op (forward or backward) or by a CUDA kernel of the port."""
    _GUARD.depth = getattr(_GUARD, "depth", 0) + 1
    try:
        with _NanGuardMode(), torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        _GUARD.depth -= 1


def guard_active() -> bool:
    return getattr(_GUARD, "depth", 0) > 0


def check_kernel_output(kernel: str, *outputs: torch.Tensor) -> None:
    """The kernel wrappers' hook: under an active :func:`nan_guard`, raise
    ``FloatingPointError`` if a floating output holds a NaN (this reads the
    outputs, so it waits for the kernel).  A no-op otherwise."""
    if not guard_active():
        return
    for t in outputs:
        bad = _nan_count(t)
        if bad:
            raise FloatingPointError(
                f"nan_guard: {bad} NaN values out of the {kernel} "
                f"(shape {tuple(t.shape)})")


class _AttrKey(str):
    """A named tuple's field in a leaf's path."""


def _keystr(path) -> str:
    """``jax.tree_util.keystr``'s format: ``['key']``, ``[0]``, ``.name``."""
    return "".join(f".{k}" if isinstance(k, _AttrKey) else f"[{k!r}]"
                   for k in path)


def _leaves_with_path(tree, path=()):
    """Leaves in ``jax.tree_util.tree_flatten_with_path``'s order: dict
    keys sorted, sequences in order, named tuples by field; None is an
    empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves_with_path(getattr(tree, name),
                                         path + (_AttrKey(name),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def check_finite(tree, label: str = "value") -> None:
    """Finiteness assertion over every floating leaf of a nested
    dict/list/tuple of tensors or arrays; raises ``FloatingPointError``
    naming the first bad leaf, as the JAX package does."""
    for path, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            finite = torch.isfinite(leaf.detach())
            shape = tuple(leaf.shape)
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind != "f":
                continue
            finite = np.isfinite(arr)
            shape = arr.shape
        if not bool(finite.all()):
            bad = int((~finite).sum())
            raise FloatingPointError(
                f"{label}{_keystr(path)}: {bad} non-finite values "
                f"(shape {shape})")
