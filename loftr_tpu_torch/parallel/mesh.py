"""Process groups and a named-axis mesh over ranks
(``loftr_tpu.parallel.mesh``).

JAX declares parallelism as a device mesh with named axes and lets GSPMD
insert the collectives.  Here a process is a rank (one device each), the
mesh lays the ranks out on a grid with named axes, and each axis is a
``torch.distributed`` group: the ranks that differ only in that axis's
coordinate.  Collectives over an axis take its group
(``parallel/comm.py``).

Axes, as in JAX:
  'data'  - batch-parallel (the reference's DDP);
  'model' - reserved for tensor-parallel sharding of d_model;
  'seq'   - the coarse token axis (``coarse.seq_axis``,
            ``parallel/seq_attention.py``).

Launch several ranks with ``torchrun --nproc-per-node N ...``;
:func:`init_process_group` reads torchrun's environment.
"""
from __future__ import annotations

import contextvars
import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from loftr_tpu_torch.parallel import comm

_MESH = contextvars.ContextVar("loftr_mesh", default=None)


def init_process_group(device=None, backend: Optional[str] = None,
                       init_method: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group described by torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``), or by
    ``init_method`` (e.g. ``file:///path/to/store``; the environment's
    ``LOFTR_INIT_METHOD`` when not given).  The backend is NCCL for a CUDA
    ``device`` and gloo otherwise, unless ``backend`` names one.  Returns
    (rank, world size); joins nothing when ``WORLD_SIZE`` is unset or 1 and
    no ``init_method`` is given."""
    if comm.initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    init_method = init_method or os.environ.get("LOFTR_INIT_METHOD")
    if world == 1 and init_method is None:
        return 0, 1
    rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        cuda = device is not None and torch.device(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    kw = {}
    if backend == "nccl" and device is not None:
        kw["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, **kw)
    return rank, world


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK``: the device index of this process."""
    return int(os.environ.get("LOCAL_RANK", "0"))


class Mesh:
    """Ranks on a row-major grid with named axes; each axis a process
    group of the ranks that share the other coordinates.

    Outside a process group a mesh of shape (1, ..., 1) stands for the one
    process: its groups are None and every collective is the identity.
    ``with mesh:`` makes it the ambient mesh (:func:`current_mesh`), as
    ``jax.set_mesh`` does; ``coarse.seq_axis`` looks its axis up there."""

    def __init__(self, shape: Dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        n = 1
        for s in shape.values():
            n *= s
        world = comm.group_size()
        if n != world:
            raise ValueError(f"mesh {shape} holds {n} ranks, the process "
                             f"group {world}")
        rank = comm.group_rank()
        sizes = [shape[a] for a in self.axis_names]
        self.coords = dict(zip(self.axis_names, _unravel(rank, sizes)))
        self.groups: Dict[str, object] = {}
        for i, axis in enumerate(self.axis_names):
            mine = None
            # every rank creates every group, in one order (new_group's rule)
            for rest in _grid([s for j, s in enumerate(sizes) if j != i]):
                ranks = [_ravel(rest[:i] + (k,) + rest[i:], sizes)
                         for k in range(sizes[i])]
                g = dist.new_group(ranks) if comm.initialized() else None
                if rank in ranks:
                    mine = g
            self.groups[axis] = mine

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __enter__(self):
        self._token = _MESH.set(self)
        return self

    def __exit__(self, *exc):
        _MESH.reset(self._token)


def _grid(sizes: Sequence[int]):
    if not sizes:
        yield ()
        return
    for i in range(sizes[0]):
        for rest in _grid(sizes[1:]):
            yield (i,) + rest


def _ravel(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _unravel(rank: int, sizes):
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def current_mesh() -> Optional[Mesh]:
    """The ambient mesh (``with mesh:``), or None."""
    return _MESH.get()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """A ('data', 'model') mesh over the process group's ranks."""
    if n_data is None:
        n_data = comm.group_size() // n_model
    return Mesh({"data": n_data, "model": n_model})


def make_seq_mesh(n_data: Optional[int] = None, n_seq: int = 1) -> Mesh:
    """A ('data', 'seq') mesh for sequence-parallel runs: 'seq' shards the
    coarse token axis (``coarse.seq_axis = 'seq'``); the communication is
    one all-reduce of the [B, H, D, Dv+1] linear-attention statistics a
    layer, or the K/V ring of full attention."""
    if n_data is None:
        n_data = comm.group_size() // n_seq
    return Mesh({"data": n_data, "seq": n_seq})


def local_device_mesh(devices=None) -> dict:
    """A serving mesh over this process's devices (``MatchingService(
    mesh=...)``): ``{"data": [device, ...]}``, every CUDA device when not
    given."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return {"data": [torch.device(d) for d in devices]}


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """This rank's rows of a global batch: a tensor [B, ...], a dict of
    them or a dataclass of them (``MatchInput``; None stays None), split
    evenly over ``axis``."""
    n, i = mesh.size(axis), mesh.index(axis)

    def rows(x):
        if x is None:
            return None
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {n} ranks")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    if isinstance(batch, torch.Tensor):
        return rows(batch)
    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return dataclasses.replace(batch, **{
        f.name: rows(getattr(batch, f.name))
        for f in dataclasses.fields(batch)})


def replicate(module: torch.nn.Module, group=None, src: int = 0) -> None:
    """Broadcast the module's parameters and buffers from rank ``src`` of
    ``group``, in place: every rank then holds rank ``src``'s state."""
    if not comm.initialized():
        return
    root = dist.get_global_rank(group or dist.group.WORLD, src)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t, root, group=group)
