"""The collectives of data parallel over `torch.distributed`: what GSPMD
inserts for the JAX package's global-batch step (`egovlpv2_tpu/train/
step.py`), written out.

Every rank computes the same global loss from gathered rows. The gathers
are differentiable with the true adjoint: the backward of `all_gather` is
a SUM reduce-scatter of the gathered gradient, and that of
`all_reduce_sum` an all-reduce sum, so a rank's rows receive the gradient
that every rank's copy of the loss sends them (W times d loss / d rows),
and `sync_gradients`' mean over the ranks leaves each parameter's gradient
exactly d(global loss)/d(parameter), as in one process over the whole
batch. A gather whose backward only slices the rank's own part (the
reference's `AllGather_multi`) would drop the gradient a gathered row gets
from another rank's pass, which ITM's mined pairs give it.

Without a process group every function is the identity (a gather of one
process is its input), so the same step code runs in one process.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist

from egovlpv2_torch.parallel.distributed import world_size


def _gathered(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((world_size() * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _gathered(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0] // world_size(),)
                             + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad, op=dist.ReduceOp.SUM)
        return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """[b, ...] on each rank -> [W * b, ...], the ranks' rows in rank
    order, the same on every rank; differentiable (a sum reduce-scatter
    back). Every rank must give the same b."""
    if not dist.is_initialized():
        return x
    return _AllGather.apply(x) if x.requires_grad else _gathered(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, on every rank; differentiable (an all-reduce
    sum back)."""
    if not dist.is_initialized():
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def comm_device() -> torch.device:
    """Where a collective's tensor lives: this rank's card under NCCL, else
    the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (an all-reduce max of
    one int); `flag` itself without a group."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(flag)], dtype=torch.int32, device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_gather_object(obj) -> List:
    """Every rank's `obj`, in rank order (picklable objects)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def sync_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Every parameter's gradient becomes its mean over the ranks: one
    all-reduce a dtype over the gradients flattened into one buffer, then
    divided by W and copied back. Gradients must all be set. A no-op
    without a group."""
    if not dist.is_initialized():
        return
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    w = world_size()
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(w)
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n
