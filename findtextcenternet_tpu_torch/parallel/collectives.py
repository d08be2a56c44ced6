"""The collectives seam: every ``torch.distributed`` call of the port.

The port keeps plain local tensors on every rank (no DTensor, no
``DistributedDataParallel``: gradients come from ``torch.autograd.grad``
over a parameter dict, and the attention kernels are ctypes ops behind
``autograd.Function`` s) and issues its own collectives on the data and
model sub-groups of :class:`..parallel.mesh.Mesh`. They are all here.

A group that is ``None``, or any group with no process group initialised,
is inactive: every call below is then the identity (or a no-op), so the
single-process path, whose mesh has no groups, runs exactly the code it
ran before the mesh existed. A group of one rank is active: a world of 1
under NCCL (the one-card check) issues every collective a larger world
issues, each the identity on its values.

Only names present in both torch 2.11 and 2.13 are used
(``all_gather_into_tensor`` and ``reduce_scatter_tensor``, not their 2.13
successors, which 2.11 lacks; 2.13's deprecation warning for them is
silenced here). Reductions are sums; gathers and scatters work on any dim by
moving it to the front, and give contiguous tensors (NCCL refuses
strided ones where gloo takes them).
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[object]


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def active(group: Group) -> bool:
    """True where ``group`` is a process group's (of any size)."""
    return group is not None and initialized()


def size(group: Group) -> int:
    return dist.get_world_size(group) if active(group) else 1


def rank(group: Group) -> int:
    return dist.get_rank(group) if active(group) else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if initialized() else 0


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if active(group):
        c = t if t.is_contiguous() else t.contiguous()
        dist.all_reduce(c, op=dist.ReduceOp.SUM, group=group)
        if c is not t:
            t.copy_(c)
    return t


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in rank
    order."""
    if not active(group):
        return t
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, group: Group, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's ``1/n`` slice along ``dim`` of the sum of the ranks'
    ``t`` (``t.shape[dim]`` divisible by the group's size)."""
    if not active(group):
        return t
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
    return out.movedim(0, dim).contiguous()


def broadcast_(t: torch.Tensor, src: int = 0, group: Group = None
               ) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s in place (over the whole
    world when ``group`` is None)."""
    if initialized():
        dist.broadcast(t, src=src, group=group)
    return t


def broadcast_batch(batch, device, src: int = 0) -> dict:
    """Global rank ``src``'s ``batch`` (a dict of numpy arrays or tensors;
    the other ranks pass None) on every rank, as tensors on ``device``:
    one loader feeds the whole mesh, so every rank holds the same global
    batch whatever order the loader's workers deliver in. ``batch`` itself
    with no process group."""
    if not initialized():
        return batch
    import numpy as np

    mine = world_rank() == src
    tensors = ({k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(
                    np.ascontiguousarray(v))).to(device).contiguous()
                for k, v in batch.items()} if mine else {})
    meta = [{k: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for k, t in tensors.items()} if mine else None]
    dist.broadcast_object_list(meta, src=src)
    out = {}
    for k, (shape, dtype) in meta[0].items():
        t = tensors[k] if mine else torch.empty(
            shape, dtype=getattr(torch, dtype), device=device)
        dist.broadcast(t, src=src)
        out[k] = t
    return out


def barrier() -> None:
    """Wait for every rank (a no-op with no process group)."""
    if initialized():
        dist.barrier()


# ---------------------------------------------------------------------------
# autograd-aware collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of each rank's input is the sum of
    the ranks' output gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, gradient summed over the group: the input of a
    column-split layer, whose ranks each see part of its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum forward, identity backward: the partial outputs of a row-split
    layer, whose sum every rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """Gather along ``dim`` forward; backward keeps this rank's slice of
    the gradient (the ranks compute alike on the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group) if active(group) else x


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group) if active(group) else x


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group) if active(group) else x


def gather_from_group(x: torch.Tensor, group: Group, dim: int = -1
                      ) -> torch.Tensor:
    if not active(group):
        return x
    return _GatherFromGroup.apply(x, group, dim % x.dim())
