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

Both expose ``init(params) -> state`` and ``update(grads, state, params,
step[, norm_fn]) -> (params, state)`` (``norm_fn``: AdamW's clipping norm
over leaves sharded across ranks; Adafactor raises for it).  ``step`` is a 0-d integer tensor; the
learning rate and bias corrections are 0-d float32 tensors on its
device, as XLA computes them.  ``update`` writes the new values into the
tensors of ``params`` and ``state`` and returns them: the reference's
jitted step donates its state, and a second copy of AdamW's state would
not fit beside the first at full width.

``state_specs(params, specs, ctx)`` gives the state's sharding specs
(``distributed.sharding``, data only on one card): AdamW's three trees
each take the parameters' specs plus ZeRO-1's `data` axis; Adafactor's
factored rows and columns take the parameter spec less the reduced dim.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed.sharding import zip_specs, zero1_specs
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]
    state_specs: Optional[Callable[[Any, Any, Any], Any]] = None


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum()
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm_fn=None):
    """(grads scaled in float32 to a global norm of at most ``max_norm``
    and rounded back to their dtypes, the norm).  Gradients of bfloat16
    parameters are so rounded to bfloat16, as in the reference.
    ``norm_fn`` (tree -> norm) replaces the local norm, e.g. for leaves
    sharded over ranks (``step.sharded_norm``)."""
    norm = (norm_fn or _global_norm)(grads)
    scale = torch.clamp(norm.new_tensor(max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ------------------------------------------------------------------ AdamW

def adamw(lr_fn: Callable[[torch.Tensor], torch.Tensor], *, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "master": tree_map(lambda p: p.detach().to(
                    torch.float32, copy=True), params)}

    @torch.no_grad()
    def update(grads, state, params, step, norm_fn=None):
        grads, _ = clip_by_global_norm(grads, grad_clip, norm_fn)
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

    return Optimizer("adamw", init, update, state_specs)


# --------------------------------------------------------------- Adafactor

def adafactor(lr_fn: Callable[[torch.Tensor], torch.Tensor], *,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0,
              min_dim_factored: int = 128) -> Optimizer:
    def factored(p):
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if factored(p):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"fac": tree_map(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step, norm_fn=None):
        if norm_fn is not None:
            raise NotImplementedError(
                "Adafactor clips each update by its rms over the whole "
                "leaf; over expert-sharded leaves that needs a reduction "
                "the port does not have")
        t = step.to(torch.float32) + 1.0
        beta2 = 1.0 - torch.pow(t, -decay_pow)
        lr = lr_fn(step)

        def upd(g, w, s):
            g = g.float()
            g2 = g.square() + eps
            if "vr" in s:
                vr = s["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(-1))
                vc = s["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(-2))
                r = vr / vr.mean(-1, keepdim=True)
                u = g / torch.sqrt(r[..., None] * vc[..., None, :] + eps)
            else:
                v = s["v"].mul_(beta2).add_((1 - beta2) * g2)
                u = g / torch.sqrt(v + eps)
            rms_u = torch.sqrt(u.square().mean() + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if weight_decay and w.dim() >= 2:
                u = u + weight_decay * w.float()
            w.copy_(w.float() - lr * u)

        def walk(g, w, s):                      # the state's leaves are dicts
            if isinstance(w, dict):
                for k in w:
                    walk(g[k], w[k], s[k])
            else:
                upd(g, w, s)
        walk(grads, params, state["fac"])
        return params, state

    def state_specs(params, specs, ctx):
        def one(p, s):
            dims = tuple(s) + (None,) * (p.dim() - len(tuple(s)))
            if factored(p):
                return {"vr": dims[:-1], "vc": dims[:-2] + dims[-1:]}
            return {"v": dims}
        return {"fac": zip_specs(one, params, specs)}

    return Optimizer("adafactor", init, update, state_specs)


def for_arch(arch_param_count: int, lr_fn) -> Optimizer:
    """Launcher policy: Adafactor above 100B params (a memory-bound
    decision: optimizer state that must fit), AdamW otherwise."""
    if arch_param_count > 100e9:
        return adafactor(lr_fn)
    return adamw(lr_fn)
