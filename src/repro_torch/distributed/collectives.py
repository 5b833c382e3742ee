"""Collectives over a ``torch.distributed`` process group (PyTorch port of
``repro.distributed.collectives``): the island-migration primitives of the
sharded search, the int8-compressed gradient mean with error feedback,
and the few differentiable collectives the data- and expert-parallel
paths need.

**Island migration.**  :func:`ring_shift` rotates every leaf one rank on
around a ring of ``isend`` / ``irecv`` pairs: rank ``i`` sends its block to
rank ``(i + shift) % size`` and receives rank ``(i - shift) % size``'s.  A
rotation moves rows and never copies or drops one, so the global genome
multiset is kept.  :func:`gather_islands` is the matching ``all_gather``
(stacked on a new axis, or concatenated with ``tiled=True``).

**Compressed gradient mean.**

    q      = quantize_int8(g + err)      # per-leaf scale = max|.| / 127
    g_hat  = psum(q) * scale / n
    err'   = (g + err) - dequant(q)      # residual, fed back next step

Error feedback keeps the accumulated quantization error bounded.  Over n
replicas the scales meet in a MAX all-reduce (the reference's ``pmax``),
every replica quantizes against that shared scale, the int8 payloads are
summed as int32, and the mean is ``total * gmax / n``.  Without a group
(one replica) ``pmax`` and ``psum`` are identities and ``n`` is 1, so the
mean is the replica's own dequantized value.

**Differentiable collectives.**  :func:`psum` is the reference's ``psum``
inside a function whose value every rank holds: its backward passes the
cotangent through unchanged, so that the ranks' gradients, summed, are
the gradient of the one replicated value.  :func:`all_to_all` moves equal
row blocks between ranks; its backward moves the cotangents back.

**Tensor parallelism** (Megatron's pairs, over the ``"model"`` group).
Every rank of the group computes the same loss; a tensor outside a
rank-local region carries its whole gradient on every rank.  A region
starts where a replicated tensor meets this rank's shard of a weight and
ends where the ranks' partial results meet:

    function            forward            backward
    copy_to             identity           all-reduce (sum)
    psum (reduce_from)  all-reduce (sum)   identity
    gather_from(dim)    all-gather         this rank's slice
    scatter_to(dim)     this rank's slice  all-gather
    all_gather(dim)     all-gather         reduce-scatter
    reduce_scatter(dim) reduce-scatter     all-gather
    all_to_all_dims     all-to-all         the all-to-all back

``gather_from`` / ``scatter_to`` border replicated computation (each
rank's cotangent is whole already); ``all_gather`` / ``reduce_scatter``
border rank-local computation (the cotangents are partial sums), as at
the sequence-sharded residual of Megatron-SP.  :func:`pmax` is a max
all-reduce outside autograd.  Each launch adds one to :data:`TP_CALLS`
under the function's name (``"<name>.grad"`` for a backward's launch).
A group of one rank still launches every collective: only ``None``
skips them.

A ``group`` of None means one rank: every function then runs without a
collective and returns what the one-replica code computes.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def _global_rank(group, r: int) -> int:
    return dist.get_global_rank(group, r) if group is not None else r


# ------------------------------------------------------- island migration

def ring_shift(tree, *, size: int, group, shift: int = 1):
    """Rotate every leaf ``shift`` ranks around the ring of ``group``
    (``size`` ranks): each rank sends its leaf to rank ``(i + shift) %
    size`` and receives rank ``(i - shift) % size``'s.  A ring of one rank
    is the identity."""
    size = int(size)
    if size < 1:
        raise ValueError(f"ring over {size} ranks")
    if size != group_size(group):
        raise ValueError(f"a ring of {size} over a group of "
                         f"{group_size(group)}")
    if size == 1 or shift % size == 0:
        return tree
    me = group_rank(group)
    dst = _global_rank(group, (me + shift) % size)
    src = _global_rank(group, (me - shift) % size)

    def one(v):
        v = v.contiguous()
        out = torch.empty_like(v)
        ops = [dist.P2POp(dist.isend, v, dst, group),
               dist.P2POp(dist.irecv, out, src, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    return tree_map(one, tree)


def gather_islands(tree, *, group, axis: int = 0, tiled: bool = False):
    """Leaf-wise ``all_gather`` over ``group``: every rank ends up holding
    the ranks' values stacked on a new ``axis`` (``tiled=False``) or
    concatenated along it (``tiled=True``), in rank order."""
    n = group_size(group)

    def one(v):
        v = v.contiguous()
        if group is None:
            parts = [v]
        else:
            parts = [torch.empty_like(v) for _ in range(n)]
            dist.all_gather(parts, v, group=group)
        return (torch.cat(parts, dim=axis) if tiled
                else torch.stack(parts, dim=axis))
    return tree_map(one, tree)


# --------------------------------------------- differentiable collectives

#: launches of each differentiable collective (module docstring)
TP_CALLS: collections.Counter = collections.Counter()


def _ar(x: torch.Tensor, group, name: str) -> torch.Tensor:
    """A SUM all-reduce of a contiguous copy of ``x``."""
    TP_CALLS[name] += 1
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _ag(x: torch.Tensor, dim: int, group, name: str) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    TP_CALLS[name] += 1
    xt = x.detach().movedim(dim, 0).contiguous()
    out = xt.new_empty((group_size(group) * xt.shape[0],) + xt.shape[1:])
    dist.all_gather_into_tensor(out, xt, group=group)
    # contiguous, as the tensors it stands for: a reduction over another
    # layout sums in another order
    return out.movedim(0, dim).contiguous()


def _rs(x: torch.Tensor, dim: int, group, name: str) -> torch.Tensor:
    """This rank's block along ``dim`` of the ranks' ``x`` summed."""
    TP_CALLS[name] += 1
    xt = x.detach().movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // group_size(group),) + xt.shape[1:])
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    k = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * k, k)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _ar(x, group, "psum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """SUM all-reduce of ``x`` over ``group`` whose backward passes the
    cotangent through (see the module docstring); ``x`` itself without a
    group."""
    return x if group is None else _PSum.apply(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.group, "copy_to.grad"), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums the cotangent over ``group``: a
    replicated tensor entering rank-local computation."""
    return x if group is None else _CopyTo.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        return _ag(x, dim, group, "all_gather" if partial else "gather_from")

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _rs(g, ctx.dim, ctx.group, "all_gather.grad"), None, \
                None, None
        return _own(g, ctx.dim, ctx.group), None, None, None


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` into replicated computation: the backward
    keeps this rank's slice of the (whole) cotangent."""
    return x if group is None else _Gather.apply(x, dim, group, False)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` into rank-local computation: the backward
    reduce-scatters the (partial) cotangents."""
    return x if group is None else _Gather.apply(x, dim, group, True)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce):
        ctx.dim, ctx.group, ctx.reduce = dim, group, reduce
        if reduce:
            return _rs(x, dim, group, "reduce_scatter")
        return _own(x, dim, group).clone()

    @staticmethod
    def backward(ctx, g):
        name = ("reduce_scatter" if ctx.reduce else "scatter_to") + ".grad"
        return _ag(g, ctx.dim, ctx.group, name), None, None, None


def scatter_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of a replicated tensor; the
    backward all-gathers the blocks' cotangents."""
    return x if group is None else _Scatter.apply(x, dim, group, False)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' partial ``x`` summed, this rank's block along ``dim``
    kept; the backward all-gathers."""
    return x if group is None else _Scatter.apply(x, dim, group, True)


def _a2a_dims(x, split_dim: int, cat_dim: int, group, name: str):
    TP_CALLS[name] += 1
    n = group_size(group)
    send = torch.stack(x.detach().chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat_dim)


class _AllToAllDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _a2a_dims(x, split_dim, cat_dim, group, "all_to_all_dims")

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _a2a_dims(g, cat_dim, split_dim, ctx.group,
                         "all_to_all_dims.grad"), None, None, None


def all_to_all_dims(x: torch.Tensor, split_dim: int, cat_dim: int, group
                    ) -> torch.Tensor:
    """Block ``j`` of ``x`` along ``split_dim`` goes to rank ``j``; the
    blocks received are concatenated along ``cat_dim`` in rank order
    (e.g. head_dim-sharded to sequence-sharded).  Differentiable."""
    if group is None:
        return x
    return _AllToAllDims.apply(x, split_dim, cat_dim, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """MAX all-reduce of ``x`` over ``group`` outside autograd (a new
    tensor); ``x`` without a group."""
    if group is None:
        return x
    TP_CALLS["pmax"] += 1
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`psum` times ``1 / n`` (exact for a power-of-two ``n``, as
    the reference's division by ``n``)."""
    if group is None:
        return x
    return psum(x, group) * (1.0 / group_size(group))


def _all_to_all_raw(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``i`` of ``x``'s leading dim (split in ``n`` equal blocks)
    goes to rank ``i``; the result's block ``j`` came from rank ``j``.
    Differentiable."""
    return _AllToAll.apply(x, group)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """All-reduce of a tensor outside autograd, in place where ``x`` is
    contiguous (the collective needs it so; a contiguous copy otherwise);
    returns the reduced tensor, ``x`` itself without a group."""
    if group is not None:
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=group)
    return x


# ------------------------------------------------ compressed gradient mean

def quantize_int8(x: torch.Tensor):
    """(int8 q, float32 scale) with ``scale = max(max|x|, 1e-30) / 127``
    (a product with the float32 reciprocal of 127, as XLA compiles the
    reference's division) and ``q = clip(round(x / scale), -127, 127)``
    (half to even, as ``jnp.round``)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-30) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(x: torch.Tensor, err: torch.Tensor, group=None):
    """One leaf: the error-feedback int8 mean over the replicas of
    ``group`` (one replica without).  Returns (mean estimate in float32,
    new error)."""
    xf = x.float() + err
    q, scale = quantize_int8(xf)
    if group is None:
        return dequantize_int8(q, scale), xf - dequantize_int8(q, scale)
    # the replicas share the largest scale, so the wire format is exactly
    # int8 plus one float32
    gmax = all_reduce_(scale.clone(), group, dist.ReduceOp.MAX)
    q2 = torch.clamp(torch.round(xf / gmax), -127, 127).to(torch.int8)
    new_err = xf - q2.float() * gmax
    total = all_reduce_(q2.to(torch.int32), group)
    return total.float() * gmax * (1.0 / group_size(group)), new_err


def compressed_grad_mean(grads, err_tree, group=None):
    """Tree version (nested dicts).  Returns (mean gradients in float32,
    new error tree)."""
    if not isinstance(grads, dict):
        return compressed_psum_mean(grads, err_tree, group)
    out = {k: compressed_grad_mean(grads[k], err_tree[k], group)
           for k in grads}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()})


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
