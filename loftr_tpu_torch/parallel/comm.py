"""Collectives over ``torch.distributed`` process groups
(``loftr_tpu.parallel.comm`` and the psums of the JAX package's GSPMD
programs).

- :func:`process_allgather_objects`: one picklable object a process,
  gathered on every process (the evaluator's merge of per-pair metrics).
- :func:`all_reduce_sum`: a SUM all-reduce that carries its gradient (its
  backward all-reduces the incoming gradient), for sums that feed every
  rank's part of one global loss: BatchNorm's batch statistics, the
  linear-attention statistics of a token-sharded stack.
- :func:`reduce_sum`: the same without a graph, for counts and scalars.
- :func:`all_gather`, :func:`split`, :func:`ring_shift`: concatenation
  along an axis, this rank's chunk of it, and a one-step ring exchange, all
  differentiable; :func:`sum_grad`, the identity whose backward sums the
  gradient over the ranks.

Every function is the identity without a group (``group=None`` outside a
process group), as JAX's collectives are on a single device; with a group,
even of one rank, the collective runs.

**Transport.** The gloo backend carries only ``broadcast`` and
``all_reduce`` for CUDA tensors.  For the other collectives on CUDA tensors
under gloo (all-gather, point-to-point), the tensors go through host
memory: copied to the CPU, exchanged, copied back.  The choice follows the
backend and the tensor's device, never a caught error, and
:data:`STAGED` counts each staged call by operation.  Only the transport
moves: the computation stays on the tensor's device.

**The data-parallel scope.** ``with data_parallel(group):`` makes the batch
reductions of a training step global over ``group``, as one GSPMD program
over the global batch computes them: BatchNorm statistics
(``models/backbone.py``), loss denominators (``losses.py``) and the
selection's batch (``ops/matching.py``) read :func:`data_group`.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

# staged calls of gloo collectives on CUDA tensors, by operation
STAGED = {"all_gather": 0, "ring_shift": 0}

_DATA = contextvars.ContextVar("loftr_data_parallel", default=None)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def group_size(group=None) -> int:
    """Ranks in ``group`` (the default group for None); 1 outside a
    process group."""
    return dist.get_world_size(group) if initialized() else 1


def group_rank(group=None) -> int:
    """This process's rank within ``group``; 0 outside a process group."""
    return dist.get_rank(group) if initialized() else 0


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective other than broadcast / all-reduce on ``t`` goes
    through host memory: gloo carries those only for CPU tensors."""
    return (t.device.type != "cpu"
            and dist.get_backend(group) == dist.Backend.GLOO)


# ---------------------------------------------------------------- objects

def process_allgather_objects(obj: Any, group=None) -> List[Any]:
    """Gather one picklable object a process; every process returns the
    full ``[obj_rank0, obj_rank1, ...]`` list.  Outside a process group (or
    in a group of one), ``[obj]`` without any exchange."""
    if group_size(group) == 1:
        return [obj]
    out: List[Any] = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------- tensors

def reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """SUM all-reduce over ``group`` without a graph (a new tensor); ``x``
    itself outside a process group."""
    if not initialized():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """SUM all-reduce whose backward all-reduces the incoming gradient.

    With each rank's loss its part of one global loss (the parts sum to
    it), a sum of per-rank partials ``y = sum_r x_r`` gets on every rank
    ``dL/dx_r = sum_q dL_q/dy``: the gradient of the global loss.  ``x``
    itself outside a process group."""
    if not initialized():
        return x
    return _AllReduceSum.apply(x, group)


def _all_gather_raw(x: torch.Tensor, group) -> List[torch.Tensor]:
    staged = _staged(x, group)
    if staged:
        STAGED["all_gather"] += 1
    src = x.detach().contiguous()
    src = src.cpu() if staged else src
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts] if staged else parts


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.n, ctx.rank = group_size(group), group_rank(group)
        return torch.cat(_all_gather_raw(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), \
            None, None


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` (equal shapes), in rank
    order.  The backward takes this rank's slice of the gradient: the
    convention of a consumer that every rank runs alike on the gathered
    tensor (a replicated computation).  ``x`` itself outside a process
    group."""
    if not initialized():
        return x
    return _AllGather.apply(x, dim, group)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, r = group_size(group), group_rank(group)
        return x.chunk(n, dim=dim)[r].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(_all_gather_raw(grad, ctx.group), dim=ctx.dim), \
            None, None


def split(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (equal chunks, in rank
    order).  The backward all-gathers the chunks' gradients: the
    convention of a producer that every rank runs alike, which then gets
    the whole gradient on every rank.  ``x`` itself outside a process
    group."""
    if not initialized():
        return x
    if x.shape[dim] % group_size(group):
        raise ValueError(f"{x.shape[dim]} rows do not split over "
                         f"{group_size(group)} ranks")
    if not x.requires_grad:
        return x.chunk(group_size(group), dim=dim)[group_rank(group)]
    return _Split.apply(x, dim, group)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def sum_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """The identity, whose backward sums the gradient over ``group``: a
    parameter used by every rank on its own shard of the data gets, on
    every rank, the gradient of all the shards.  ``x`` itself outside a
    process group."""
    if not initialized():
        return x
    return _SumGrad.apply(x, group)


def _shift_raw(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` ahead in the group's ring, receive
    from the rank ``step`` behind."""
    n, r = group_size(group), group_rank(group)
    staged = _staged(x, group)
    if staged:
        STAGED["ring_shift"] += 1
    src = x.detach().contiguous()
    src = src.cpu() if staged else src
    dst = torch.empty_like(src)
    g = group or dist.group.WORLD
    to = dist.get_global_rank(g, (r + step) % n)
    frm = dist.get_global_rank(g, (r - step) % n)
    ops = [dist.P2POp(dist.isend, src, to, group),
           dist.P2POp(dist.irecv, dst, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return dst.to(x.device) if staged else dst


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift_raw(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift_raw(grad, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """One step of a ring: every rank sends ``x`` to the next rank and
    returns what the previous rank sent.  The gradient travels the other
    way.  ``x`` itself outside a process group or in a group of one."""
    if group_size(group) == 1:
        return x
    if not x.requires_grad:
        return _shift_raw(x, group, 1)
    return _RingShift.apply(x, group)


# ------------------------------------------------------- data parallelism

class DataGroup:
    """The process group of a data-parallel step and this rank's place in
    it.  Every rank holds ``rows`` batch rows of a global batch of
    ``size * rows``: rank r holds rows ``[r * rows, (r + 1) * rows)``."""

    def __init__(self, group, rows: int):
        self.group = group
        self.size = group_size(group)
        self.rank = group_rank(group)
        self.rows = rows

    @property
    def global_rows(self) -> int:
        return self.size * self.rows

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor [size * rows, ...]."""
        return x[self.rank * self.rows:(self.rank + 1) * self.rows]


@contextlib.contextmanager
def data_parallel(group, rows: int):
    """Within the block, the batch reductions of the training step are
    global over ``group``; each rank holds ``rows`` rows of the batch."""
    token = _DATA.set(DataGroup(group, rows))
    try:
        yield
    finally:
        _DATA.reset(token)


def data_group() -> Optional[DataGroup]:
    """The active data-parallel group, or None."""
    return _DATA.get()


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """A count or scalar summed over the data-parallel group (no graph);
    ``x`` itself outside :func:`data_parallel`."""
    dg = _DATA.get()
    return x if dg is None else reduce_sum(x, dg.group)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce_sum` over the data-parallel group; ``x`` itself
    outside :func:`data_parallel`."""
    dg = _DATA.get()
    return x if dg is None else _AllReduceSum.apply(x, dg.group)


def flat_all_reduce_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """SUM all-reduce of a list of tensors in place, as one flat buffer."""
    if not initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n
