"""Process groups and the fleet's scaling measurement (port of
`mtf_tpu/parallel/multihost.py`).

The JAX package runs one process per host over `jax.distributed`; the
port runs one process per device over `torch.distributed`: NCCL with one
rank per GPU on the card, gloo with one rank per worker on the CPU.

    python -m torch.distributed.run --nproc-per-node=<GPUs> script.py
    # in script.py:
    rank = init_distributed()          # torchrun's env
    mesh = make_mesh({"tracker": -1})

`run_world` spawns such a world of processes on one host itself, with a
`file://` rendezvous, and hands each rank's result back to the caller.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from mtf_tpu_torch._device import resolve


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None,
                     device_type: str | None = None) -> int:
    """Initialise the default process group and return this process's
    rank (a no-op returning the rank where one exists). `init_method`
    ("file://...", "tcp://host:port") with `world_size` and `rank`;
    without it, torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, LOCAL_RANK) where set, else a world of one process.
    `backend`: NCCL on the card (`device_type` "cuda", the default),
    gloo on the CPU. On the card each rank takes the GPU of its local
    rank (modulo the GPUs there are)."""
    if dist.is_initialized():
        return dist.get_rank()
    device_type = device_type or resolve(None).type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if init_method is None and "RANK" in os.environ:
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    kw = {}
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    if init_method is None:
        if world_size not in (None, 1):
            raise ValueError("a world of more than one process needs an "
                             "init_method or torchrun's environment")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    return dist.get_rank()


def _rank_main(rank, world_size, init_file, backend, device_type, threads,
               fn, args_file, results):
    """One rank of `run_world`: init, `fn(rank, world_size, *args)` with
    the arguments read from `args_file`, and its result (or its
    traceback) on `results`."""
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        torch.set_num_threads(threads)
        init_distributed(f"file://{init_file}", world_size, rank, backend,
                         device_type)
        out = fn(rank, world_size, *args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:                          # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """A world of spawned ranks (`start_world`); `join` waits for them."""

    def __init__(self, procs, results, timeout):
        self.procs, self.results, self.timeout = procs, results, timeout

    def join(self) -> list:
        """Every rank's result, in rank order; raises RuntimeError with a
        rank's traceback if it failed, or if the world overran its
        `timeout` (every rank then is killed)."""
        n, out, errors = len(self.procs), {}, []
        deadline = time.monotonic() + self.timeout
        try:
            while len(out) + len(errors) < n:
                try:
                    rank, ok, val = self.results.get(
                        timeout=max(0.1, deadline - time.monotonic()))
                except queue.Empty:
                    dead = [p.exitcode for p in self.procs
                            if p.exitcode not in (None, 0)]
                    if time.monotonic() > deadline or dead:
                        raise RuntimeError(
                            f"world of {n}: {len(out)} ranks answered "
                            f"(exit codes {[p.exitcode for p in self.procs]}"
                            f"{', timed out' if not dead else ''})")
                    continue
                (out.__setitem__(rank, val) if ok
                 else errors.append(f"rank {rank}:\n{val}"))
        finally:
            for p in self.procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("\n".join(errors))
        return [out[r] for r in range(n)]


def start_world(fn, world_size: int, args: tuple = (), backend="gloo",
                device_type="cpu", init_file: str | None = None,
                threads: int = 1, timeout: float = 600.0) -> World:
    """Spawn `world_size` processes, each running `fn(rank, world_size,
    *args)` in an initialised world (`init_distributed` over a `file://`
    rendezvous at `init_file`, a new file by default; on the CPU, or on
    the card with `device_type` "cuda"), PyTorch on `threads` threads.
    `fn` must be importable by name (a module's top-level function), and
    its result picklable (numpy, not tensors). Returns at once;
    `World.join` collects the results."""
    import torch.multiprocessing as mp
    if init_file is None:
        init_file = os.path.join(tempfile.mkdtemp(prefix="mtf_world_"),
                                 "rendezvous")
    # the arguments go through a file: a spawned process reads those it
    # is started with as it unpickles them, importing as it goes, so
    # large ones would start the ranks one after the other
    args_file = f"{init_file}.args"
    with open(args_file, "wb") as f:
        pickle.dump(args, f)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world_size, init_file, backend, device_type, threads, fn,
        args_file, results)) for r in range(world_size)]
    for p in procs:
        p.start()
    return World(procs, results, timeout)


def run_world(fn, world_size: int, args: tuple = (), **kw) -> list:
    """`start_world(...).join()`: every rank's result, in rank order."""
    return start_world(fn, world_size, args, **kw).join()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_fleet_scaling(sm, frame, corners_fn, widths=(1, 2, 4, 8),
                          trackers_per_device: int = 32, steps: int = 10,
                          fixed_total: int | None = None) -> dict:
    """Throughput against mesh width for a tracker fleet; every rank of
    the world calls it together, and every rank gets the result.

    For each width n up to the world's size: the first n ranks form a
    `tracker` mesh (`make_mesh`, its group `new_group(ranks[:n])`), build
    the fleet of B trackers (`corners_fn(i) -> (4, 2)`), step it once,
    then time `steps` updates between barriers of the n ranks (the card
    synchronised before each). Returns {"fps": {n: frames/s}, "efficiency":
    {n: ...}} relative to the first width. The two protocols of the JAX
    package: weak scaling (default), B = trackers_per_device * n, where
    the ideal keeps frames/s per device constant; strong scaling
    (`fixed_total=B`), the same B trackers over more devices, efficiency
    = fps_n / fps_1, the one that stays meaningful where the ranks share
    one host's cores."""
    from mtf_tpu_torch.parallel.fleet import TrackerFleet
    from mtf_tpu_torch.parallel.mesh import make_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    device = sm.device
    results = {}
    for n in widths:
        if n > world:
            break
        B = fixed_total if fixed_total else trackers_per_device * n
        if B % n != 0:
            continue
        mesh = make_mesh({"tracker": n}, device_type=device.type)
        fps = [0.0]
        if rank < n:
            group = mesh.get_group("tracker")
            corners = np.stack([np.asarray(corners_fn(i), np.float32)
                                for i in range(B)])
            fleet = TrackerFleet(sm, mesh)
            states = fleet.update(fleet.initialize(frame, corners), frame)
            _sync(device)
            dist.barrier(group=group)
            t0 = time.perf_counter()
            for _ in range(steps):
                states = fleet.update(states, frame)
            _sync(device)
            dist.barrier(group=group)
            fps = [B * steps / (time.perf_counter() - t0)]
        dist.broadcast_object_list(fps, src=0)
        results[n] = fps[0]
    base = results.get(widths[0])
    if not base:
        return {"fps": results, "efficiency": {}}
    if fixed_total:
        eff = {n: fps / base for n, fps in results.items()}
    else:
        eff = {n: (fps / n) / (base / widths[0])
               for n, fps in results.items()}
    return {"fps": results, "efficiency": eff}
