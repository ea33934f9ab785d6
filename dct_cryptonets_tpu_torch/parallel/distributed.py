"""Multi-process initialization, the 2-D host x chip mesh and the
collectives the sharded paths use, counterpart of
``dct_cryptonets_tpu.parallel.distributed``, over ``torch.distributed``.

Every process runs the same program and owns its local devices.  The
encrypted eval needs no collective on its hot path: the server keys are
broadcast once, each process bootstraps its shards of the ciphertext
batch, and the outputs are gathered.  Data-parallel training all-reduces
the gradients and the batch statistics.

The backend is NCCL where every rank has a GPU of its own and gloo
otherwise: NCCL refuses two ranks on one GPU ("Duplicate GPU detected"),
so two processes on one card run gloo.  Gloo broadcasts and all-reduces
CUDA tensors; its all-gather here goes through host memory.

Tested without a GPU by spawning processes on the CPU
(``tests/test_torch_multihost.py``).
"""
from datetime import timedelta

import torch
import torch.distributed as dist

from .mesh import (Mesh, Sharded, data_mesh, make_mesh,  # noqa: F401
                   norm_device, replicate, shard_batch, tree_map)

# this process's devices, set by initialize()
_LOCAL: list = []


def default_backend(num_processes: int, devices) -> str:
    """NCCL when this process's devices are GPUs and the host has one GPU
    per rank (rank i then takes GPU i), gloo otherwise."""
    cuda = all(torch.device(d).type == "cuda" for d in devices)
    if cuda and dist.is_nccl_available() and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, devices=None,
               backend: str | None = None,
               timeout: float = 300.0) -> str | None:
    """Join a ``num_processes`` world as rank ``process_id`` through a
    ``tcp://`` rendezvous at ``coordinator_address`` (``host:port``); a
    no-op for a single process (both None), as in JAX.

    The process's devices: ``devices`` (explicit ``torch.device``\\ s, CPU
    ones allowed, repeats allowed), else CUDA devices
    ``local_device_ids``, else the GPU ``process_id`` modulo the count.
    Raises without a GPU unless CPU devices are given.  ``backend``
    defaults to :func:`default_backend`; it is printed, and never swapped
    for another after a failure.  ``timeout`` (seconds) bounds the
    rendezvous and every collective.  Returns the backend."""
    global _LOCAL
    if num_processes is None and coordinator_address is None:
        return None
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this process; pass "
                               "devices=['cpu'] to run on the CPU")
        ids = local_device_ids if local_device_ids is not None else [
            process_id % torch.cuda.device_count()]
        devices = [torch.device("cuda", i) for i in ids]
    devices = [torch.device(d) for d in devices]
    backend = backend or default_backend(num_processes, devices)
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    addr = coordinator_address
    if not addr.startswith(("tcp://", "file://")):
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout))
    _LOCAL = [norm_device(d) for d in devices]
    print(f"process {process_id}/{num_processes}: torch.distributed "
          f"backend {backend}, devices "
          f"{[str(d) for d in _LOCAL]}", flush=True)
    return backend


def local_devices() -> list:
    """This process's devices (the visible GPUs before initialize())."""
    if _LOCAL:
        return list(_LOCAL)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: call initialize(devices=...) "
                           "with CPU devices to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shutdown():
    """Leave the process group (no-op when none was joined)."""
    global _LOCAL
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL = []


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_chip_mesh(chips_per_host: int | None = None) -> Mesh:
    """2-D ('host', 'chip') mesh: rows are ranks, columns each rank's
    local devices (the first ``chips_per_host`` of them)."""
    world = _world_size()
    mine = [str(d) for d in local_devices()]
    if chips_per_host is not None:
        mine = mine[:chips_per_host]
    per_rank = [None] * world
    if world > 1:
        dist.all_gather_object(per_rank, mine)
    else:
        per_rank = [mine]
    per = len(per_rank[0])
    if any(len(p) != per for p in per_rank):
        raise ValueError(f"ranks hold different device counts: {per_rank}")
    devices = [d for p in per_rank for d in p]
    ranks = [r for r in range(world) for _ in range(per)]
    return make_mesh(devices, ranks, (world, per), ("host", "chip"))


def global_data_mesh() -> Mesh:
    """1-D 'data' mesh over every rank's devices, rank by rank."""
    m = host_chip_mesh()
    return make_mesh(m.devices, m.ranks, (m.size,), ("data",))


def local_batch_to_global(mesh: Mesh, tree):
    """Assemble a globally sharded batch from per-process local batches.

    Every process passes its local portion (leading axis = global batch
    over the process count); it is split over this process's entries and
    the result is a :class:`Sharded` of the global length per leaf: the
    multi-process analog of :func:`shard_batch`."""
    world = _world_size()
    local = mesh.local()

    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        n = len(x) * world
        shards = [None] * mesh.size
        for k, part in zip(local, x.chunk(len(local), dim=0)):
            shards[k] = part.to(mesh.devices[k])
        if any(len(s) != n // mesh.size for s in shards if s is not None):
            raise ValueError(f"a local batch of {len(x)} does not split "
                             f"over {len(local)} local entries")
        return Sharded(mesh, shards, n)
    return tree_map(put, tree)


# ---------------------------------------------------------------------------
# collectives (a CUDA tensor stays on the card except where gloo cannot
# take it)


def _gloo() -> bool:
    return dist.get_backend() == "gloo"


def coll_device() -> torch.device:
    """Where a collective's small host-made tensors go: the CPU under
    gloo, this process's GPU under NCCL."""
    return torch.device("cpu") if _gloo() else local_devices()[0]


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    dist.broadcast(t, src)
    return t


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op)
    return t


def all_gather(t: torch.Tensor) -> list:
    """One tensor per rank, each of ``t``'s shape, on ``t``'s device;
    under gloo a CUDA tensor is staged through host memory."""
    staged = t.cpu() if _gloo() else t
    out = [torch.empty_like(staged) for _ in range(dist.get_world_size())]
    dist.all_gather(out, staged.contiguous())
    return [o.to(t.device) for o in out]


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

