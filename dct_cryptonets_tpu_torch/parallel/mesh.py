"""Device meshes for data-parallel training and ciphertext-batch sharding,
counterpart of ``dct_cryptonets_tpu.parallel.mesh``.

A :class:`Mesh` is an explicit, ordered list of entries under axis names:
each entry is a ``torch.device`` and the rank of the process that owns
it.  A device may appear more than once; its entries then run one after
another on it.  That is how the CPU tests hold the 8-entry mesh the JAX
tests get from 8 virtual CPU devices, and how one GPU holds a 2-entry
mesh.

* :func:`shard_batch` splits a batch's leading axis into one shard per
  entry: a :class:`Sharded` holds this process's shards (the other
  processes' entries hold ``None``) and :meth:`Sharded.gather` joins them
  again, across processes too.
* :func:`replicate` places one copy of a pytree (keys, parameters) on each
  distinct device; repeated entries share it, and a value already on its
  device is not copied.  When the mesh spans processes the copies come
  from one rank by broadcast.
* :func:`run_sharded` calls a function on each of this process's entries
  with that entry's shard and copy.

A sharded batch is a small class rather than a list because it carries
what a list would lose: the mesh (whose entries belong to other processes
too) and the global batch length, which :meth:`Sharded.gather` needs to
join the shards in mesh order.
"""
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


def process_rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def norm_device(d) -> torch.device:
    """``torch.device`` with the CUDA index made explicit, so that
    ``cuda`` and ``cuda:0`` name one device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class Mesh:
    """Entries ``devices[i]`` owned by process ``ranks[i]``, laid out
    row-major in ``shape`` under ``axis_names``."""
    devices: tuple
    ranks: tuple
    shape: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def local(self) -> list:
        """Indices of this process's entries, in mesh order."""
        me = process_rank()
        return [i for i, r in enumerate(self.ranks) if r == me]

    @property
    def spans_processes(self) -> bool:
        return len(set(self.ranks)) > 1


def make_mesh(devices, ranks, shape, axis_names) -> Mesh:
    devices = tuple(norm_device(d) if r == process_rank() else torch.device(d)
                    for d, r in zip(devices, ranks))
    if len(devices) != int(np.prod(shape)) or len(ranks) != len(devices):
        raise ValueError(f"{len(devices)} entries do not fill shape {shape}")
    return Mesh(devices, tuple(ranks), tuple(shape), tuple(axis_names))


def data_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """1-D ``data`` mesh of ``num_devices`` entries on this process's
    devices, taken in turn (a count above the number of devices repeats
    them).  ``devices`` defaults to every visible CUDA device and raises
    without a GPU; pass CPU devices (``devices="cpu"``) to run on the
    CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh; pass "
                               "devices='cpu' to build a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [norm_device(d) for d in devices]
    n = len(devices) if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one entry, not {n}")
    return make_mesh([devices[i % len(devices)] for i in range(n)],
                     [process_rank()] * n, (n,), ("data",))


# ---------------------------------------------------------------------------
# pytrees (tuples, named tuples, lists, dicts; anything else is a leaf)


def tree_map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


# ---------------------------------------------------------------------------
# sharded batches


@dataclass
class Sharded:
    """A batch of ``n`` rows split on its leading axis over ``mesh``:
    ``shards[i]`` is entry i's rows on its device, ``None`` for entries
    of other processes."""
    mesh: Mesh
    shards: list
    n: int

    def local(self) -> list:
        """(entry index, shard) of this process's entries."""
        return [(i, self.shards[i]) for i in self.mesh.local()]

    def gather(self, device=None) -> torch.Tensor:
        """The whole batch on ``device`` (default: this process's first
        entry's device); across processes an all-gather."""
        local = self.local()
        device = norm_device(device or local[0][1].device)
        if not self.mesh.spans_processes:
            return torch.cat([s.to(device) for _, s in local], dim=0)
        from .distributed import all_gather  # it imports this module
        mine = torch.cat([s.to(device) for _, s in local], dim=0)
        parts = all_gather(mine)                   # one per rank
        per_rank = {}
        for r, part in enumerate(parts):
            k = self.mesh.ranks.count(r)
            per_rank[r] = list(part.to(device).chunk(k, dim=0)) if k else []
        return torch.cat([per_rank[r].pop(0) for r in self.mesh.ranks],
                         dim=0)


def shard_rows(n: int, mesh: Mesh, i: int) -> slice:
    """Entry i's rows of an n-row batch."""
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not divide the "
                         f"{mesh.size}-entry mesh")
    s = n // mesh.size
    return slice(i * s, (i + 1) * s)


def shard_batch(mesh: Mesh, tree):
    """Shard the leading (batch) axis of every leaf (tensor or array)
    across the mesh: a :class:`Sharded` per leaf.  Raises on a length the
    mesh does not divide."""
    def put(x):
        n = len(x)
        shards = [None] * mesh.size
        for i in mesh.local():
            shards[i] = _as_tensor(x[shard_rows(n, mesh, i)]).to(
                mesh.devices[i])
        return Sharded(mesh, shards, n)
    return tree_map(put, tree)


class Replicated(tuple):
    """One copy of a pytree per mesh entry (``None`` for entries of other
    processes); entries on one device share one copy."""


class _Spec:
    """A tensor's shape and dtype, sent ahead of its bytes."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def replicate(mesh: Mesh, tree, src: int = 0) -> Replicated:
    """Fully replicate a pytree (params, keys) across the mesh: one copy
    per distinct device of this process.  When the mesh spans processes,
    rank ``src``'s tree is broadcast (the one-time key broadcast); the
    other ranks may pass ``None``."""
    local = mesh.local()
    if mesh.spans_processes:
        tree = _broadcast_tree(tree, mesh.devices[local[0]], src)
    copies = {}
    out = [None] * mesh.size
    for i in local:
        d = mesh.devices[i]
        if d not in copies:
            copies[d] = tree_map(
                lambda x: _as_tensor(x).to(d)
                if isinstance(x, (torch.Tensor, np.ndarray)) else x, tree)
        out[i] = copies[d]
    return Replicated(out)


def _broadcast_tree(tree, device, src):
    """Rank src's pytree on every rank: its structure (shapes, dtypes and
    the other leaves) as one object, then each tensor's bytes."""
    from .distributed import broadcast      # distributed imports this module
    me = dist.get_rank()
    if me == src:
        tree = tree_map(lambda x: _as_tensor(x).to(device)
                        if isinstance(x, (torch.Tensor, np.ndarray)) else x,
                        tree)
        spec = [tree_map(lambda x: _Spec(x) if isinstance(x, torch.Tensor)
                         else x, tree)]
    else:
        spec = [None]
    dist.broadcast_object_list(spec, src)
    if me != src:
        tree = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device=device)
                        if isinstance(x, _Spec) else x, spec[0])
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            broadcast(t, src)
    return tree


def run_sharded(mesh: Mesh, fn, *args) -> Sharded:
    """``fn(*args)`` on each of this process's entries, one after another:
    a :class:`Sharded` argument gives its entry's shard, a
    :class:`Replicated` one its entry's copy, any other is passed as is.
    Returns the outputs (one tensor per entry) as a :class:`Sharded`."""
    n = next(a.n for a in args if isinstance(a, Sharded))
    shards = [None] * mesh.size
    for i in mesh.local():
        shards[i] = fn(*(a.shards[i] if isinstance(a, Sharded)
                         else a[i] if isinstance(a, Replicated) else a
                         for a in args))
    return Sharded(mesh, shards, n)
