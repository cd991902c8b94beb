"""Checkpoint and resume of an inverse-rendering run.

Port of :mod:`tpuray.utils.checkpoint`: the parameters, the optimizer's
state and the step, saved atomically (a temporary file, then a rename), so
a run interrupted while saving keeps its previous checkpoint.  The format
is ``torch.save``'s, loaded back with ``weights_only=True`` (tensors,
numbers, strings, lists and dicts only).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    optimizer: Any, step: int) -> None:
    """Write ``params`` (tensors by name), ``optimizer`` (a state dict)
    and ``step`` to ``path``."""
    tmp = f"{path}.tmp"
    torch.save({"params": {k: v.detach() for k, v in params.items()},
                "optimizer": optimizer, "step": int(step)}, tmp)
    os.replace(tmp, path)      # atomic: no torn checkpoint


def load_checkpoint(path: str, like: Dict[str, torch.Tensor],
                    map_location=None) -> Tuple[Dict[str, torch.Tensor],
                                                Any, int]:
    """(params, optimizer state, step) saved by :func:`save_checkpoint`.

    ``like`` gives the parameters the caller expects; the saved ones must
    have the same names, shapes and dtypes, or this raises instead of
    handing back parameters that do not fit."""
    data = torch.load(path, map_location=map_location, weights_only=True)
    params = data["params"]

    def signature(tree):
        return [(k, tuple(v.shape), v.dtype) for k, v in tree.items()]

    if signature(params) != signature(like):
        raise ValueError(f"checkpoint {path!r} holds parameters\n  "
                         f"{signature(params)}\nbut the run has\n  "
                         f"{signature(like)}")
    return params, data["optimizer"], data["step"]
