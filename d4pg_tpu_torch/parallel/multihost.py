"""Multi-process learner startup: ranks of one ``torch.distributed`` group.

Counterpart of ``d4pg_tpu/parallel/multihost.py``. Every rank starts the
same program; ``initialize`` joins the group as rank ``process_id`` of
``num_processes`` through the coordinator's ``tcp://host:port`` (over
gloo, which carries the host values), and ``global_mesh`` builds this
rank's ``RankMesh``, choosing the device backend by one rule
(``choose_backend``): ``nccl`` when every rank on a host has a card of its
own, gloo otherwise (two ranks sharing one card, or CPU ranks). Both are
decided from what every rank reports, never by trying one backend and
taking the other.

A rank's local batch is its block of the global one: each rank samples
its own replay shard, rank r's rows are rows
``[r * B_local, (r + 1) * B_local)`` of a global batch of
``world * B_local`` rows, and rows never cross ranks. The reference
builds that global array across hosts; here the rank's tensors on its
device already are its block, and go to the sharded update as they are.

``spawn_local`` starts ``world`` local ranks with the ``spawn`` start
method on a free loopback port (the driver's ``--data_parallel N``, the
tests, the chip script), joins each with a deadline and raises if any
rank failed, hung or died.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable

import torch

from d4pg_tpu_torch.parallel.mesh import RankMesh

# how long a rank waits for its peers in a collective before it fails
COLLECTIVE_TIMEOUT_S = 300.0


def initialize(coordinator: str, num_processes: int, process_id: int,
               timeout_s: float = COLLECTIVE_TIMEOUT_S) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``
    through ``coordinator`` (``host:port`` of rank 0's store)."""
    import torch.distributed as dist

    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"--process_id {process_id} is outside "
                         f"[0, {num_processes})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group (no-op when there is none)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def device_identity(device: torch.device) -> tuple[str, str]:
    """``(host, device)``: two ranks with one identity share a device."""
    host = socket.gethostname()
    if device.type != "cuda":
        return host, device.type
    props = torch.cuda.get_device_properties(device)
    return host, f"cuda:{props.uuid}"


def choose_backend(identities: list[tuple[str, str]]) -> str:
    """``nccl`` when every rank is on a card and no two ranks of a host
    share one; ``gloo`` otherwise (NCCL refuses two ranks on one card)."""
    on_cards = all(dev.startswith("cuda:") for _, dev in identities)
    if on_cards and len(set(identities)) == len(identities):
        return "nccl"
    return "gloo"


def global_mesh(device: str | torch.device, model_parallel: int = 1,
                n_local: int = 1) -> RankMesh:
    """This rank's mesh over every rank of the initialized group (the
    world-1 mesh when there is no group), ``n_local`` data-axis shards per
    rank, ``model_parallel`` ranks per data row. Collective: every rank
    calls it, and every rank creates every data and model group in the
    same order (``dist.new_group`` is collective over the world)."""
    import torch.distributed as dist

    mp = max(1, int(model_parallel))
    device = torch.device(device)
    if not dist.is_initialized():
        if mp > 1:
            raise ValueError(f"model_parallel={mp} needs {mp} ranks or "
                             "more; there is no process group")
        return RankMesh.local(device, n_local)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % mp:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model_parallel={mp}")
    ids: list = [None] * world
    dist.all_gather_object(ids, device_identity(device))
    backend = choose_backend(ids)
    cpu_group = dist.group.WORLD
    group = cpu_group
    if backend == "nccl":
        torch.cuda.set_device(device)
        group = dist.new_group(backend="nccl")
    data_group, model_group = group, None
    if mp > 1:
        dp = world // mp
        # rank r sits at (r // mp, r % mp); both lists in one fixed order
        data_groups = [dist.new_group([d * mp + m for d in range(dp)],
                                      backend=backend) for m in range(mp)]
        model_groups = [dist.new_group([d * mp + m for m in range(mp)],
                                       backend=backend) for d in range(dp)]
        data_group = data_groups[rank % mp]
        model_group = model_groups[rank // mp]
    return RankMesh(world=world, rank=rank, device=device,
                    n_local=int(n_local), backend=backend, group=group,
                    cpu_group=cpu_group, model_parallel=mp,
                    data_group=data_group, model_group=model_group)


def barrier(mesh: RankMesh) -> None:
    """Cross-rank sync point (startup, train start, train end)."""
    mesh.barrier()


def global_min_scalar(mesh: RankMesh, x: float) -> float:
    """Min of a host scalar over every rank, e.g. the PER weight base:
    normalizing every rank's IS weights by one global base keeps their
    gradient contributions on one scale."""
    t = torch.tensor([float(x)], dtype=torch.float64)
    return float(mesh.all_reduce(t, "min")[0])


def replicate_state_global(init_fn: Callable, mesh: RankMesh):
    """The train state, identical on every rank: built by ``init_fn``,
    then rank 0's broadcast (``data_parallel.replicate_state``)."""
    from d4pg_tpu_torch.parallel.data_parallel import replicate_state

    return replicate_state(init_fn(), mesh)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclasses.dataclass(frozen=True)
class RankLaunch:
    """What ``spawn_local`` hands each rank. The arguments travel as plain
    pickle bytes: multiprocessing's own pickler would move tensors into
    shared memory, and every rank would then update the SAME Adam
    moments in place."""

    fn: Callable
    args: bytes
    world: int
    port: int
    device_type: str
    n_local: int
    model_parallel: int = 1


def _rank_main(launch: RankLaunch, rank: int, results) -> None:
    try:
        if launch.device_type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        initialize(f"127.0.0.1:{launch.port}", launch.world, rank)
        try:
            mesh = global_mesh(device, model_parallel=launch.model_parallel,
                               n_local=launch.n_local)
            out = launch.fn(mesh, *pickle.loads(launch.args))
        finally:
            shutdown()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_local(fn: Callable, world: int, args: tuple = (),
                device_type: str = "cpu", n_local: int = 1,
                timeout_s: float | None = 120.0,
                model_parallel: int = 1) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` local ranks (rank r on
    ``cuda:r``, or the CPU), each a ``spawn``ed process in one group on a
    free loopback port, the mesh ``model_parallel`` ranks per data row.
    ``fn`` must be importable by name. Returns the ranks' results in rank
    order; raises if a rank fails or dies, or if the ranks do not all
    finish within ``timeout_s`` (None: no deadline). More ranks than CUDA
    devices is a ``ValueError``, as the reference's ``MeshSpec.resolve``
    refuses a mesh larger than its devices."""
    import multiprocessing as mp

    if device_type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"--data_parallel {world} needs {world} CUDA devices (one card "
            f"per rank), have {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    launch = RankLaunch(fn, pickle.dumps(tuple(args)), int(world),
                        free_port(), device_type, int(n_local),
                        int(model_parallel))
    procs = [ctx.Process(target=_rank_main, args=(launch, r, results),
                         name=f"rank-{r}") for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [p.name for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{dead} died without a result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} did "
                        f"not finish within {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=30.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
    return [out[r] for r in range(world)]

