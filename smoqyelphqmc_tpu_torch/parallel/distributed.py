"""Walker fleets across processes with torch.distributed (port of the JAX
package's parallel/distributed.py without the device mesh).

The reference scales by MPI ranks, one Markov chain each
(tutorials/holstein_honeycomb_mpi.jl:24-72). Here a fleet is P processes,
one a card, each owning a contiguous block of W / P walkers
(`local_walker_ids`); every process runs the same driver program
(`driver.simulate` / `run_simulation`) and writes the bins, tuning profiles
and checkpoint of its own block. A fleet gives the chains of one process
with all W walkers: the few quantities the walkers share are gathered so
that every rank computes them from all W walkers, in the order one process
uses:

  - the shared preconditioner refresh: the W fields and mus
    (`gather_walkers`), from which each rank takes the walker-mean fermion
    matrix and mu itself;
  - each sweep's per-walker acceptance flags, iteration counts and
    convergence (`gather_walkers` of the driver's float64 rows): the
    fallback controller's mean iteration count, the timestep law's mean
    acceptance and the metadata's walker means;
  - rank 0's decisions to checkpoint and to stop, and its data folder
    (`broadcast_object`), and the barriers around the folder's creation and
    the final merge (`barrier`).

The gathers run on gloo, which gathers CPU tensors: a CUDA tensor goes
through the host and comes back to its card. Launch one process a card with
`torchrun --nproc_per_node=<cards>` and call `initialize_distributed()`, or
call `initialize_distributed(init_method, world_size, rank)` in processes
started by hand (`spawn_processes` starts them on one host).
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> None:
    """Join this process to the fleet's gloo process group (call once, on
    every process, before the simulation). With no arguments it reads
    torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE);
    otherwise pass an init_method ('tcp://localhost:<port>' or
    'file://<path>'), the world size and this process's rank. Where a card is
    present, device="cuda" then means cuda:{LOCAL_RANK % device_count}
    (LOCAL_RANK from torchrun, else the rank)."""
    dist.init_process_group("gloo", init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size, rank=-1 if rank is None else rank)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def process_count() -> int:
    """The fleet's size P (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_walker_ids(n_walkers: int, rank: Optional[int] = None, world: Optional[int] = None) -> range:
    """The walkers (pIDs) that process `rank` of `world` owns: the contiguous
    block [rank W / P, (rank + 1) W / P). W must be a multiple of P. The
    defaults are this process's rank and the fleet's size."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if n_walkers % world:
        raise ValueError(f"n_walkers={n_walkers} must be a multiple of the number of processes {world}")
    per = n_walkers // world
    return range(rank * per, (rank + 1) * per)


def barrier(name: str = "smoqy_barrier") -> None:
    """Wait for every process of the fleet (no-op with one process); `name`
    labels the wait in a profiler trace."""
    if process_count() == 1:
        return
    with torch.profiler.record_function(f"barrier:{name}"):
        dist.barrier()


def gather_walkers(t: torch.Tensor) -> torch.Tensor:
    """All W walkers' rows in walker order, on every process, from this
    process's block t (W / P, ...) (t itself with one process). The result
    is on t's device."""
    world = process_count()
    if world == 1:
        return t
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    return torch.cat(parts).to(t.device)


def broadcast_object(obj, src: int = 0):
    """Process src's picklable obj, on every process (obj itself with one)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj) -> List:
    """Every process's picklable obj, by rank ([obj] with one process)."""
    world = process_count()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def spawn_processes(commands: Sequence[Sequence[str]], logs: Sequence[str], timeout: float,
                    env: Optional[dict] = None) -> List[int]:
    """Start one process a command, all at once, each writing its output to
    its log file (a fleet's ranks on this host, each joining through
    `initialize_distributed(init_method, world_size, rank)`), and wait for
    them: as soon as one fails, or `timeout` seconds pass, the others are
    killed. Returns the exit codes in command order (negative where a
    process was killed)."""
    procs = []
    try:
        for cmd, log in zip(commands, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(list(cmd), stdout=f, stderr=subprocess.STDOUT, env=env))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]
