"""The collectives the training path issues around the port's kernels.

Megatron's conjugate pair, as ``torch.autograd.Function``s over the
model axis's process group:

- ``copy_to_model`` (Megatron's f): identity forward, all-reduce of the
  gradient backward. It stands before each column-parallel product, so
  the replicated activation it reads gets the sum of every model rank's
  gradient.
- ``reduce_from_model`` (g): all-reduce forward, identity backward. It
  follows each row-parallel product (the partial sums of ``c_proj``).

``global_mean`` is the data-parallel loss normalisation; see its
docstring for the invariant it keeps. A ``None`` group (no world, or an
axis of one outside a world) makes each of them the identity.

Inference runs the same f and g (under ``no_grad`` they record no
graph), and two collectives of its own: ``all_gather_rows`` (every data
rank's equal block of rows) and ``agree`` (a stop decision taken by
every rank of a group at once: a rank that left a decode loop early
would leave its partner waiting in a collective).

``HEARTBEAT_S`` bounds how long a lockstep driver (rank 0 of the server
or the REPL) leaves its followers waiting in a broadcast while it waits
itself, for a request or a line: far inside any process group's timeout
(10 min on NCCL, 30 min on gloo by default).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

HEARTBEAT_S = 1.0


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def global_mean(s: torch.Tensor, n: torch.Tensor, group) -> torch.Tensor:
    """The mean over the whole data axis of a sum ``s`` over ``n`` items
    that each data rank holds a part of: the value is S / max(N, 1) with
    S and N the all-reduced sums (a mean over the global count, not a
    mean of per-rank means: ranks hold different counts).

    The invariant of the gradient: each rank's loss differentiates as
    ``s_local / N`` with N detached, and the data-parallel gradient
    reduction SUMS the ranks' gradients, so the reduced gradient is d(S /
    N), the gradient of one device over the global batch. No
    differentiable all-reduce is involved (its backward would sum
    cotangents across ranks, and a later averaging would then be right
    only by accident)."""
    n = n.float()
    if group is None:
        return s / torch.clamp_min(n, 1.0)
    both = torch.stack([s.detach().float(), n])
    dist.all_reduce(both, group=group)
    denom = torch.clamp_min(both[1], 1.0)
    return both[0] / denom + (s - s.detach()) / denom


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every data rank's block of rows (equal sizes: the fill rows pad
    them), concatenated along dim 0 in rank order."""
    if group is None:
        return x
    x = x.contiguous()
    got = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, x, group=group)
    return torch.cat(got)


def agree(flag: bool, group, device) -> bool:
    """The logical AND of ``flag`` over ``group``: every rank gets the
    same answer."""
    if group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())
