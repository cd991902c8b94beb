"""Process groups for multi-rank renders, and a launcher for a local world.

Port of :mod:`tpuray.parallel.distributed`.  JAX runs SPMD in one process
per host, so it needs a bootstrap only across hosts; on ``torch.distributed``
every rank is a process of its own:

* :func:`ensure_initialized` sets up the default process group when a
  multi-process configuration is present (torchrun's ``WORLD_SIZE``,
  ``RANK`` and ``MASTER_ADDR``, or explicit arguments), and is a no-op
  otherwise.  Backend: NCCL for a CUDA device, gloo for the CPU, or the one
  asked for.  It never falls back from one to the other: NCCL takes one
  rank per card, so a world of several ranks on one card asks for gloo
  (which stages CUDA tensors through the host) and a request for NCCL
  there raises.
* :func:`global_mesh` is the 1-D render mesh over every rank
  (:func:`shard.make_mesh`).
* :func:`launch` runs a function on every rank of a fresh local world, one
  process per rank (``spawn``), on a free loopback port: the tests, the
  multi-rank dry run and ``chip_smoke.py`` drive the sharded paths with it.
  JAX needs no such launcher, because its devices share one process.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# set by torchrun and other launchers
_ENV_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR")

# the device the process group was set up for (ensure_initialized)
_device: Optional[torch.device] = None


def ensure_initialized(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       backend: Optional[str] = None,
                       device="cuda") -> bool:
    """Set up the default process group for a multi-rank run.  Idempotent.

    Returns True when a process group exists (set up now or before), False
    for a plain single-process run: without ``init_method``,
    ``world_size`` or ``rank`` and without torchrun's variables it does
    nothing.  On a CUDA ``device`` the rank takes card ``LOCAL_RANK`` (else
    its rank) modulo the cards it sees.  A failing backend raises: there is
    no fallback."""
    global _device
    if dist.is_initialized():
        return True
    explicit = (init_method, world_size, rank) != (None, None, None)
    if not explicit and not all(os.environ.get(v) for v in _ENV_VARS):
        return False
    device = torch.device(device)
    backend = backend or ("gloo" if device.type == "cpu" else "nccl")
    kw = {}
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None else (
            rank if rank is not None else int(os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
        if backend == "nccl":
            kw["device_id"] = device      # NCCL's communicator at once
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kw)
    _device = device
    return True


def global_mesh(n: Optional[int] = None, device=None):
    """The 1-D render mesh (dim ``shard.AXIS``) over the world's ranks;
    raises, naming the world size and rank, when the world has not ``n``
    ranks."""
    from .shard import make_mesh
    return make_mesh(n, device if device is not None else _device)


def runtime_info() -> dict:
    """Snapshot of the distributed runtime (for logs and reports)."""
    up = dist.is_initialized()
    return {
        "rank": dist.get_rank() if up else 0,
        "world_size": dist.get_world_size() if up else 1,
        "local_rank": int(os.environ.get("LOCAL_RANK",
                                         dist.get_rank() if up else 0)),
        "backend": dist.get_backend() if up else None,
        "device": str(_device) if up and _device is not None else None,
        "initialized": up,
    }


def _free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, init_method, backend, device, fn, args, results):
    """One rank of :func:`launch`: join the world, run ``fn``, report."""
    torch.set_num_threads(1)
    try:
        ensure_initialized(init_method=init_method, world_size=world,
                           rank=rank, backend=backend, device=device)
        out = fn(*args)
        dist.barrier()          # no rank leaves while another still needs it
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable[..., Any], world: int, *args,
           backend: Optional[str] = None, device="cuda",
           timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on every rank of a fresh world of ``world``
    processes and return their results, by rank.

    Each rank is a new interpreter (start method ``spawn``) with one torch
    thread, in a process group on a free loopback port (backend as
    :func:`ensure_initialized` picks it for ``device``).  ``fn`` and
    ``args`` are pickled, so ``fn`` is a module-level function, and each
    result comes back pickled (numpy arrays, not tensors).  A rank that
    raises fails the launch with its traceback, a rank that dies fails it
    with its exit code, and a world that has not finished after
    ``timeout`` seconds is killed and raises ``TimeoutError``: a rank left
    waiting in a collective never holds the caller."""
    if world < 1:
        raise ValueError(f"a world needs at least one rank, got {world}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, init_method, backend, device,
                               fn, args, results))
             for rank in range(world)]
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world)) - set(out))
                raise TimeoutError(
                    f"a world of {world} rank(s) did not finish in "
                    f"{timeout} s (ranks {missing} still running); killed")
            # a rank found dead here had sent all it would send before the
            # get below started
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode is not None]
            try:
                rank, err, res = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} without a result")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            out[rank] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
    return [out[rank] for rank in range(world)]
