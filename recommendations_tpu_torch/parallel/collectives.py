"""The collectives of the multi-device layers, each with the gradient JAX's
``shard_map`` gives it.

In the JAX package these are ``lax.psum``, ``ppermute``, ``all_to_all`` and
``all_gather`` inside ``shard_map``; here they are ``torch.distributed``
calls over a process group, wrapped in ``torch.autograd.Function`` where a
gradient flows through them. A group of None is this rank alone: every
function then returns its input.

- ``psum``: all-reduce whose output is replicated over the group. Its
  backward is the identity (JAX transposes a psum of a replicated value
  to a pass-through): with ``copy_to_group`` it makes Megatron's f/g pair.
  ``torch.distributed.nn.functional.all_reduce`` all-reduces the cotangent
  again, which would multiply such gradients by the group's size.
- ``copy_to_group``: the identity forward whose backward all-reduces the
  cotangent, where a replicated value feeds a computation split over the
  group (the experts of an expert group).
- ``all_gather``: tiled along a dimension, output replicated; its backward
  keeps this rank's block of the cotangent. ``scatter_to_group`` is its
  inverse: keep this rank's block, backward all-gather.
- ``all_to_all``: tiled along dimension 0 (block j goes to rank j); its
  backward is the same exchange of the cotangent.
- ``ppermute``: each rank sends to the rank ``shift`` after it on the
  group's ring and receives from the one before (paired ``isend`` and
  ``irecv`` through ``batch_isend_irecv``).

Under gloo, torch takes CUDA tensors only for ``broadcast`` and
``all_reduce``. For every other operation on a gloo group this module, and
only this module, moves a CUDA tensor through host memory and back
(``_host``); the arithmetic stays on the card. It never does so under NCCL.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _via_host(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group: the operation runs on a host copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor, group) -> torch.Tensor:
    return t.cpu() if _via_host(t, group) else t


def _peer(group, group_index: int) -> int:
    """The global rank of a group's ``group_index``-th member."""
    return dist.get_global_rank(group, group_index)


# -- plain collectives (no gradient) -------------------------------------------


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place; gloo and NCCL both take CUDA tensors."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_tensor(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group order (equal
    shapes)."""
    if group is None:
        return t
    src = _host(t.contiguous(), group)
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_to_all_tensor(t: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all along dimension 0: block j of this rank's ``t`` goes
    to group rank j; block i of the result came from group rank i."""
    if group is None:
        return t
    src = _host(t.contiguous(), group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def ppermute_tensor(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Send to group rank (r + shift) mod n, receive from (r - shift) mod n."""
    n = group_size(group)
    if n == 1:
        return t
    r = group_rank(group)
    src = _host(t.contiguous(), group)
    out = torch.empty_like(src)
    ops = [
        dist.P2POp(dist.isend, src, _peer(group, (r + shift) % n), group=group),
        dist.P2POp(dist.irecv, out, _peer(group, (r - shift) % n), group=group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device)


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def any_rank(flags: List[bool], group) -> List[bool]:
    """Element-wise OR of a few flags over the group, one all-reduce."""
    if group is None:
        return list(flags)
    t = torch.tensor([1.0 if f else 0.0 for f in flags], dtype=torch.float32)
    if dist.get_backend(group) == "nccl":
        t = t.cuda()
    all_reduce_(t, group)
    return [bool(v > 0) for v in t.tolist()]


# -- differentiable collectives --------------------------------------------------


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        all_reduce_(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_(g, ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather_tensor(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = group_size(group)
        return x.chunk(n, dim=dim)[group_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_tensor(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_tensor(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ppermute_tensor(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ppermute_tensor(g, ctx.group, -ctx.shift), None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, replicated; backward the identity."""
    return x if group is None else _PSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; backward sums the cotangent over the group."""
    return x if group is None else _CopyToGroup.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``dim``, replicated; backward keeps this
    rank's block."""
    return x if group is None else _AllGather.apply(x, group, dim)


def scatter_to_group(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim``; backward all-gathers."""
    return x if group is None else _ScatterToGroup.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all along dimension 0; backward the same exchange."""
    return x if group is None else _AllToAll.apply(x, group)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Ring shift by ``shift``; backward shifts the cotangent back."""
    return x if group is None else _PPermute.apply(x, group, shift)

