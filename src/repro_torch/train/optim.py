"""Optimizers (PyTorch port of ``repro.train.optim``).

* ``adamw``     — mixed precision: float32 master weights and float32
                  (m, v).
* ``adafactor`` — factored second moments (rows and columns of the last
  two dims), update clipping, no master copy: the choice when Adam's
  states would not fit (kimi-k2's 1 T parameters).  :func:`for_arch`
  picks it above 100 B parameters.

Both work on the reference's leaf layout: a tree of tensors in which a
``pattern`` (or ``enc`` / ``dec``) leaf holds all repeats of a block
stacked on a leading axis (``step.param_tree``).  The layout decides
numbers: AdamW decays a leaf of rank 2 or more, so a pattern block's
(R, d) norm is decayed and ``final_norm`` (d,) is not; Adafactor
factors by a leaf's last two dims and clips each update by its rms over
the whole stacked leaf, all R repeats together.

Both expose ``init(params[, shards]) -> state`` and ``update(grads,
state, params, step[, shards]) -> (params, state)``.  ``shards`` is a
tree of ``sharding.Split`` tuples, one a leaf (``step.leaf_splits``):
a leaf held in blocks over ranks (experts over the data group, a dim
over the model group).  Then the clipping norm sums each leaf's squares
over its groups, and Adafactor factors by the whole leaf's shape, means
its rows and columns over the group that splits them and takes the
update's rms over the whole leaf; one rank gives the bits of the call
without ``shards``.  ``step`` is a 0-d integer tensor; the
learning rate and bias corrections are 0-d float32 tensors on its
device, as XLA computes them.  ``update`` writes the new values into the
tensors of ``params`` and ``state`` and returns them: the reference's
jitted step donates its state, and a second copy of AdamW's state would
not fit beside the first at full width.

``state_specs(params, specs, ctx)`` gives the state's sharding specs
(``distributed.sharding``, as data): AdamW's three trees each take the
parameters' specs plus ZeRO-1's `data` axis; Adafactor's factored rows
and columns take the parameter spec less the reduced dim.
``state_shards(params, shards)`` gives the splits of the state's leaves
as the port holds them (no ZeRO-1), for gathering a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (global_shape, zip_specs,
                                              zero1_specs)
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]
    state_specs: Optional[Callable[[Any, Any, Any], Any]] = None
    state_shards: Optional[Callable[[Any, Any], Any]] = None


def global_norm(tree, shards=None) -> torch.Tensor:
    """The global norm of ``tree``: each leaf's squared sum (summed over
    the groups of its ``shards``, leaves that share groups in one
    all-reduce), added in tree order."""
    leaves = [g.float().square().sum() for g in tree_leaves(tree)]
    if shards is not None:
        splits: list = []                   # a leaf's splits, in tree order
        tree_map(lambda g, sp: splits.append(sp), tree, shards)
        buckets: dict = {}
        for i, sp in enumerate(splits):
            if sp:
                buckets.setdefault(tuple(id(x.group) for x in sp),
                                   (sp, []))[1].append(i)
        for sp, idx in buckets.values():
            summed = torch.stack([leaves[i] for i in idx])
            for x in sp:
                summed = C.all_reduce_(summed, x.group)
            for i, v in zip(idx, summed.unbind()):
                leaves[i] = v
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads, max_norm: float, shards=None):
    """(grads scaled in float32 to a global norm of at most ``max_norm``
    and rounded back to their dtypes, the norm).  Gradients of bfloat16
    parameters are so rounded to bfloat16, as in the reference.
    ``shards``: leaves held in blocks over ranks (module docstring)."""
    norm = global_norm(grads, shards)
    scale = torch.clamp(norm.new_tensor(max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ------------------------------------------------------------------ AdamW

def adamw(lr_fn: Callable[[torch.Tensor], torch.Tensor], *, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params, shards=None):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "master": tree_map(lambda p: p.detach().to(
                    torch.float32, copy=True), params)}

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        grads, _ = clip_by_global_norm(grads, grad_clip, shards)
        t = step.to(torch.float32) + 1.0
        lr = lr_fn(step)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, v, w, p):
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            u = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if w.dim() >= 2:                    # no decay on norms/scalars
                u.add_(weight_decay * w)
            w.sub_(u.mul_(lr))
            p.copy_(w)
        tree_map(upd, grads, state["m"], state["v"], state["master"], params)
        return params, state

    def state_specs(params, specs, ctx):
        z = zero1_specs(params, specs, ctx)
        return {"m": z, "v": z, "master": z}

    def state_shards(params, shards):
        return {"m": shards, "v": shards, "master": shards}

    return Optimizer("adamw", init, update, state_specs, state_shards)


# --------------------------------------------------------------- Adafactor

def adafactor(lr_fn: Callable[[torch.Tensor], torch.Tensor], *,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0,
              min_dim_factored: int = 128) -> Optimizer:
    def factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_factored
                and shape[-2] >= min_dim_factored)

    def init(params, shards=None):
        def one(p, sp=()):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if factored(global_shape(p, sp)):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        if shards is None:
            return {"fac": tree_map(one, params)}
        return {"fac": tree_map(one, params, shards)}

    def pmean(x, sp, dims):
        """The mean over the ranks of the groups that split ``dims``
        (equal blocks: the mean of the blocks' means)."""
        for split in sp:
            if split.dim in dims:
                x = C.all_reduce_(x, split.group) \
                    * (1.0 / C.group_size(split.group))
        return x

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        t = step.to(torch.float32) + 1.0
        beta2 = 1.0 - torch.pow(t, -decay_pow)
        lr = lr_fn(step)

        def upd(g, w, s, sp):
            g = g.float()
            g2 = g.square() + eps
            nd = g.dim()
            if "vr" in s:
                vr = s["vr"].mul_(beta2).add_(
                    (1 - beta2) * pmean(g2.mean(-1), sp, {nd - 1}))
                vc = s["vc"].mul_(beta2).add_(
                    (1 - beta2) * pmean(g2.mean(-2), sp, {nd - 2}))
                r = vr / pmean(vr.mean(-1, keepdim=True), sp, {nd - 2})
                u = g / torch.sqrt(r[..., None] * vc[..., None, :] + eps)
            else:
                v = s["v"].mul_(beta2).add_((1 - beta2) * g2)
                u = g / torch.sqrt(v + eps)
            rms_u = torch.sqrt(pmean(u.square().mean(), sp, range(nd)) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if weight_decay and w.dim() >= 2:
                u = u + weight_decay * w.float()
            w.copy_(w.float() - lr * u)

        def walk(g, w, s, sp):                  # the state's leaves are dicts
            if isinstance(w, dict):
                for k in w:
                    walk(g[k], w[k], s[k], sp[k] if sp is not None else None)
            else:
                upd(g, w, s, sp or ())
        walk(grads, params, state["fac"], shards)
        return params, state

    def state_specs(params, specs, ctx):
        def one(p, s):
            dims = tuple(s) + (None,) * (p.dim() - len(tuple(s)))
            if factored(p.shape):
                return {"vr": dims[:-1], "vc": dims[:-2] + dims[-1:]}
            return {"v": dims}
        return {"fac": zip_specs(one, params, specs)}

    def state_shards(params, shards):
        def one(p, sp):
            nd = p.dim()
            if not factored(global_shape(p, sp)):
                return {"v": sp}
            return {"vr": tuple(x for x in sp if x.dim != nd - 1),
                    "vc": tuple(x if x.dim < nd - 2 else
                                dataclasses.replace(x, dim=nd - 2)
                                for x in sp if x.dim != nd - 2)}
        return {"fac": zip_specs(one, params, shards)}

    return Optimizer("adafactor", init, update, state_specs, state_shards)


def for_arch(arch_param_count: int, lr_fn) -> Optimizer:
    """Launcher policy: Adafactor above 100B params (a memory-bound
    decision: optimizer state that must fit), AdamW otherwise."""
    if arch_param_count > 100e9:
        return adafactor(lr_fn)
    return adamw(lr_fn)
