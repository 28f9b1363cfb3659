"""The (dp, tp) mesh over torch.distributed, one process per rank (the
port's counterpart of ``chatterbox_tpu/parallel/mesh.py``).

``dp`` splits the batch between replicas; ``tp`` splits T3's heads and MLP
width (``sharding.py``, ``tp.py``). Rank r of a world of dp·tp ranks sits at
``(r // tp, r % tp)``, so the ranks of one tensor-parallel group are
consecutive, as the JAX package's ``devices.reshape(dp, tp)`` lays them out.

``launch`` starts a rank group for a function: rank r in its own spawned
process on ``devices[r]``, the process group initialised through a file
store in a fresh temporary directory (no TCP port to collide with another
group on the same host). Its backend is NCCL when every rank has a GPU of
its own, and gloo otherwise: on the CPU, or where ``devices`` puts two ranks
on one card (NCCL refuses two ranks on one device; gloo reduces CUDA tensors
through the host, which is all this package asks of it: ``all_reduce``,
``broadcast``). The choice is logged and returned by ``backend_for``; no
failure is retried on another backend.
"""
from __future__ import annotations

import datetime
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from ..logging_config import log

# how long launch waits, after a rank's failure, for its peers' reports
FAILURE_GRACE_S = 2.0


@dataclass(frozen=True)
class MeshAxes:
    dp: str = "dp"
    tp: str = "tp"


AXES = MeshAxes()


def mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) for ``n`` ranks with the JAX package's defaults: all tensor
    parallel when neither is given, else the other one fills ``n``."""
    if tp is None and dp is None:
        dp, tp = 1, n
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    return dp, tp


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ``DeviceMesh`` with dims ("dp", "tp") over the initialised default
    process group (every rank calls it). ``devices``: every rank's device,
    as ``launch`` was given them (default: the CPU, or the current GPU under
    NCCL); dp·tp must equal the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (see launch)")
    n = dist.get_world_size()
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a world of {n} ranks")
    dp, tp = mesh_shape(n, dp, tp)
    if devices is not None:
        device_type = torch.device(devices[dist.get_rank()]).type
    else:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, tp),
                      mesh_dim_names=(AXES.dp, AXES.tp))


def backend_for(devices: Sequence) -> str:
    """"nccl" when every rank has a GPU of its own, else "gloo"."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs):
        cards = [d.index if d.index is not None else 0 for d in devs]
        if len(set(cards)) == len(cards):
            return "nccl"
    return "gloo"


@dataclass(frozen=True)
class Rank:
    """What ``launch`` hands the function in each rank's process."""
    rank: int
    world_size: int
    device: torch.device
    devices: Tuple[str, ...]   # every rank's device, in rank order
    backend: str


def _rank_main(fn, rank: int, devices: Tuple[str, ...], backend: str, init_method: str,
               timeout_s: float, args: tuple, results) -> None:
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=len(devices),
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(Rank(rank, len(devices), device, devices, backend), *args)
    except Exception:  # the rank's boundary: its traceback goes to the launcher
        # before the group is torn down, so the failure that started it
        # arrives ahead of its peers' lost-connection errors
        results.put((rank, False, traceback.format_exc()))
    else:
        results.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable[..., Any], devices: Sequence, args: tuple = (),
           timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(Rank, *args)`` in one spawned process per entry of
    ``devices`` → the ranks' return values in rank order. ``fn``, ``args``
    and the results cross processes by pickling (``fn`` by its import
    path). A rank that raises or dies fails the group: the others are
    stopped (they may wait in a collective) and ``RuntimeError`` carries
    the tracebacks of the ranks that failed within FAILURE_GRACE_S of the
    first, in the order they arrived; past ``timeout_s`` every rank is
    stopped and ``TimeoutError`` raised."""
    devices = tuple(str(torch.device(d)) for d in devices)
    n = len(devices)
    backend = backend_for(devices)
    log.info("launch: %d ranks on %s over %s", n, ", ".join(devices), backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    done, failed = {}, {}   # failed: in arrival order
    with tempfile.TemporaryDirectory(prefix="chatterbox-ranks-") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, devices, backend, f"file://{tmp}/store", timeout_s,
                                   args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline, first_failure = time.monotonic() + timeout_s, None
        try:
            while len(done) + len(failed) < n:
                if failed and first_failure is None:
                    first_failure = time.monotonic()
                if failed and time.monotonic() > first_failure + FAILURE_GRACE_S:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {n - len(done)} of {n} ranks still running "
                                       f"after {timeout_s:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in done and r not in failed and p.exitcode not in (None, 0):
                            failed[r] = f"exited with code {p.exitcode}"
                    continue
                (done if ok else failed)[rank] = payload
        finally:
            stop = len(done) < n   # a rank failed or the group timed out
            for p in procs:
                if stop and p.is_alive():
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed:
        raise RuntimeError(f"launch: {len(failed)} of {n} ranks failed\n" + "\n".join(
            f"--- rank {r} of {n} failed:\n{tb}" for r, tb in failed.items()))
    return [done[r] for r in range(n)]
