"""Multi-process bootstrap: the port of
``tensorflow_examples_tpu/core/distributed.py``.

The reference calls ``jax.distributed.initialize()``; the port starts a
``torch.distributed`` process group, one process per rank, from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit
arguments (a ``file://`` or ``tcp://`` ``init_method``, world size and
rank: the tests' spawned worlds). :func:`initialize` is idempotent and
does nothing in a one-process run.

The backend is chosen once, explicitly, and logged: ``nccl`` when the
device is CUDA and every local rank has a card of its own, ``gloo``
otherwise (the CPU tests, and several ranks sharing one card, which NCCL
refuses). ``core/collectives.py`` is the one place that reads it: on
``gloo`` it stages CUDA operands through pinned host buffers.

A rank's device is ``cuda:(LOCAL_RANK % device_count)`` unless the
caller asks for the CPU; a rank that finds no card raises
(``core/device.resolve_device``).
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import queue
import shutil
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tensorflow_examples_torch.core.device import resolve_device

log = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value else default


def local_rank() -> int:
    return _env_int("LOCAL_RANK", 0)


def choose_backend(device: str | torch.device, local_world_size: int) -> str:
    """``nccl`` when ``device`` is CUDA and the host has a card for every
    local rank, else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= max(local_world_size, 1):
        return "nccl"
    return "gloo"


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` for a CUDA
    request (raising without a card), the CPU when asked."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def initialize(*, device: str | torch.device = "cuda", init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               local_world_size: int | None = None, timeout_s: float = 600.0) -> str | None:
    """Start the process group once; returns its backend
    (:func:`choose_backend`), or None for a one-process run (no group).
    Explicit arguments win over the environment."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    if world_size <= 1 and init_method is None:
        return None
    rank = rank if rank is not None else _env_int("RANK", 0)
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE", world_size)
    backend = choose_backend(device, local_world_size)
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log.info("torch.distributed initialized: rank %d/%d, backend %s (%s)", rank, world_size,
             backend, "host-staged collectives" if backend == "gloo" and
             torch.device(device).type == "cuda" else "native collectives")
    return backend


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and summaries."""
    return process_index() == 0


def allgather_host(array) -> "np.ndarray":
    """Every rank's copy of a small host array, stacked ``[world, ...]``
    (the fleet vector, the placement digest, the eval have-more flags);
    the array itself in one process. A collective on the world group."""
    local = torch.as_tensor(np.asarray(array))
    if process_count() <= 1:
        return local.numpy()[None]
    if dist.get_backend() == "nccl":
        local = local.to(torch.device("cuda", torch.cuda.current_device()))
    out = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(out, local)
    return torch.stack(out).cpu().numpy()


def shutdown() -> None:
    """Destroy the process group if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _world_worker(fn, rank: int, world_size: int, init_method: str, device: str,
                  timeout_s: float, args: tuple, results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    try:
        initialize(device=device, init_method=init_method, world_size=world_size, rank=rank,
                   local_world_size=world_size, timeout_s=timeout_s)
        # By value: the queue's own pickler shares a tensor's storage by a
        # handle into this process, which is gone once the rank exits.
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def run_world(fn, world_size: int, *args, device: str = "cpu", timeout_s: float = 300.0,
              store_dir: str | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined
    in one process group (a ``file://`` store under ``store_dir``, a
    fresh temporary directory by default); returns each rank's result,
    in rank order. ``fn``, ``args`` and the results are pickled, the
    results by value (tensors in them included). A rank
    that raises, or a world still running after ``timeout_s`` (a wedged
    collective), kills every process and raises."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="world-") if own else store_dir
    init_method = "file://" + os.path.join(store_dir, f"store-{os.getpid()}-{id(fn)}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_world_worker, daemon=True,
                         args=(fn, r, world_size, init_method, device, timeout_s, args, results))
             for r in range(world_size)]
    out: dict[int, object] = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, payload = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise TimeoutError(f"world of {world_size} ranks did not finish in "
                                   f"{timeout_s:.0f} s (ranks done: {sorted(out)})") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world_size)]
