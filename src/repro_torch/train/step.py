"""Train and serve step builders (PyTorch port of ``repro.train.step``).

A model's parameters are modules (one per block); the optimizer and the
checkpoints see the reference's tree, in which each ``pattern`` (or
``enc`` / ``dec``) leaf holds every repeat of a block stacked on a
leading axis.  :func:`param_tree` builds that tree over the model's own
storage, so an update of the tree is an update of the model.

``make_train_step`` follows the reference on both of its paths.  With one
microbatch the gradients are those of the parameters, in their dtype, so
gradient clipping rounds them to bfloat16 for a bfloat16 model.  With
``M > 1`` microbatches, gradients accumulate in ``grad_accum_dtype``
(float32 by default) and are divided by ``M``.

With a data-parallel ``group`` (the reference's GSPMD step on a ``(data,
1)`` mesh) each rank holds its rows of the global batch and the loss and
gradients are the global batch's: ``loss_fn`` normalises by the global
weight sum, and the gradients of the replicated parameters are summed
over the group.  Experts sharded by ``moe.shard_experts`` get their whole
gradient through the MoE block's ``all_to_all`` and are not reduced; the
clipping norm sums their squares over the group.  With ``M > 1``
microbatch ``i`` is each rank's ``i``-th slice of its rows.

With tensor parallelism (a model placed by ``sharding.shard_params``)
every rank of the model group computes the same loss, and every leaf's
gradient is whole on each rank: this rank's block of a split leaf, all
of a replicated one (the layers' ``copy_to`` sums the partial terms).
So the data group's sum is the only reduction; the optimizer sees
:func:`leaf_splits` (the clipping norm sums a split leaf's squares over
its groups, Adafactor reduces over them).

:func:`state_spec_tree` gives the training state's sharding specs as data
(``distributed.sharding``).
"""

from __future__ import annotations

from typing import Callable

import torch

import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.models import encdec, lm
from repro_torch.models.encdec import EncDec, EncDecCfg
from repro_torch.models.layers import dt, map_layout
from repro_torch.train.optim import Optimizer
from repro_torch.train.schedules import f32_reciprocal
from repro_torch.tree import tree_map


def _lib(model):
    return encdec if isinstance(model, EncDec) else lm


@torch.no_grad()
def _share(x):
    """A layout leaf as one tensor: a stacked leaf's parameters become
    views of one new (R, ...) tensor, which is returned."""
    if not isinstance(x, tuple):
        return x
    stacked = torch.stack(x)
    for p, view in zip(x, stacked):
        p.data = view
    return stacked


def param_tree(model) -> dict:
    """The reference's parameter tree over ``model``'s storage, every
    parameter trainable.  On the first call each stacked leaf's block
    parameters are moved into one (R, ...) tensor and become views of it;
    later calls return the same tree.  Place the model on its device
    first: ``Module.to`` would give the parameters storage of their own."""
    tree = getattr(model, "_param_tree", None)
    if tree is None:
        model.requires_grad_(True)
        tree = map_layout(_share, _lib(model).param_layout(model))
        model._param_tree = tree
    return tree


def value_and_grad(model, batch: dict, group=None):
    """(total loss, metrics, gradients) of the model's ``loss_fn`` on
    ``batch``: the gradients in the reference's tree, each in its
    parameter's dtype, stacked leaves stacked.  With a data-parallel
    ``group`` they are this rank's terms (:func:`reduce_grads` sums
    them)."""
    param_tree(model)                   # every parameter trainable
    params = list(model.parameters())
    total, metrics = _lib(model).loss_fn(model, batch, group=group)
    grads = dict(zip(params, torch.autograd.grad(total, params,
                                                 materialize_grads=True)))

    def gather(x):
        if isinstance(x, tuple):
            return torch.stack([grads.pop(p) for p in x])
        return grads.pop(x)
    layout = _lib(model).param_layout(model)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            map_layout(gather, layout))


def expert_sharded(model) -> dict:
    """The parameter tree's mask of leaves that each rank holds a block of
    (experts sharded by ``moe.shard_experts``): True there."""
    def one(x):
        p = x[0] if isinstance(x, tuple) else x
        return getattr(p, "ep_group", None) is not None
    return map_layout(one, _lib(model).param_layout(model))


def leaf_splits(model) -> dict:
    """The parameter tree's ``sharding.Split`` tuple of each leaf (empty
    for a leaf every rank holds whole), dims in the tree's stacked
    layout."""
    return sharding.layout_splits(_lib(model).param_layout(model))


def split_kw(model) -> dict:
    """``{"shards": leaf_splits(model)}`` when a leaf is split over ranks,
    else ``{}``: the optimizers' keyword."""
    splits = leaf_splits(model)
    return {"shards": splits} if any_split(splits) else {}


def any_split(splits) -> bool:
    if isinstance(splits, dict):
        return any(any_split(v) for v in splits.values())
    return bool(splits)


def reduce_grads(grads, sharded, group):
    """The gradients with the replicated leaves summed over ``group``;
    expert-sharded leaves are whole already.  (A gradient may come out of
    autograd with strides of its own on the card; the collective needs
    it contiguous.)"""
    if group is None:
        return grads

    def one(g, s):
        if not s:
            g = g.contiguous()
            dist.all_reduce(g, group=group)
        return g
    return tree_map(one, grads, sharded)


def microbatches(batch: dict, M: int):
    """Yields the ``M`` microbatches of ``batch`` along its leading dim
    (views)."""
    if M == 1:
        yield batch
        return
    for i in range(M):
        yield {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])[i]
               for k, v in batch.items()}


def train_step_parts(model, optimizer: Optimizer, *,
                     num_microbatches: int = 1,
                     grad_accum_dtype: str | None = None, group=None):
    """The train step as ``(start, body, finish)``: ``carry = start()``,
    ``carry = body(carry, mb)`` for each microbatch (the reference's scan
    body), then ``finish(state, carry) -> (state, metrics)``.  The body's
    work is the same for every microbatch, so ``core.hlo_cost`` counts it
    once and scales it by the count.  ``group``: data parallelism (the
    module docstring)."""
    params = param_tree(model)
    M = num_microbatches
    sharded = expert_sharded(model)
    kw = split_kw(model)

    def _update(state, grads, metrics):
        grads = reduce_grads(grads, sharded, group)
        new_params, new_opt = optimizer.update(
            grads, state["opt"], params, state["step"], **kw)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    if M == 1:
        # the gradients of the parameters, in their dtype
        def start():
            return None

        def body(carry, mb):
            _, metrics, grads = value_and_grad(model, mb, group)
            return grads, metrics

        def finish(state, carry):
            grads, metrics = carry
            return _update(state, grads, metrics)
        return start, body, finish

    acc = dt(grad_accum_dtype or "float32")

    def start():
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=acc,
                                               device=p.device), params)
        zero = torch.zeros((), dtype=torch.float32,
                           device=next(model.parameters()).device)
        return zeros, {}, zero

    def body(carry, mb):
        grads, metrics, zero = carry
        _, m, g = value_and_grad(model, mb, group)
        tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
        return grads, {k: metrics.get(k, zero) + v for k, v in m.items()}, \
            zero

    def finish(state, carry):
        grads, metrics, _ = carry
        # XLA divides by the constant M as a product with 1/M
        grads = tree_map(lambda g: g * f32_reciprocal(M), grads)
        metrics = {k: v * f32_reciprocal(M) for k, v in metrics.items()}
        return _update(state, grads, metrics)

    return start, body, finish


def make_train_step(model, optimizer: Optimizer, *,
                    num_microbatches: int = 1,
                    grad_accum_dtype: str | None = None,
                    group=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is :func:`init_state`'s ``{"params", "opt", "step"}`` for
    this ``model``; batch leaves are tensors on its device with a leading
    batch dim (this rank's rows with a data-parallel ``group``) divisible
    by ``num_microbatches``.  The state's tensors are updated in place."""
    params = param_tree(model)
    start, body, finish = train_step_parts(
        model, optimizer, num_microbatches=num_microbatches,
        grad_accum_dtype=grad_accum_dtype, group=group)

    def train_step(state, batch):
        if state["params"] is not params:
            raise ValueError("state['params'] is not this model's "
                             "param_tree; build it with init_state")
        carry = start()
        for mb in microbatches(batch, num_microbatches):
            carry = body(carry, mb)
        return finish(state, carry)

    return train_step


def make_prefill_step(cfg) -> Callable:
    """``step(model, batch) -> (last-position logits, cache or encoder
    output)``."""
    if isinstance(cfg, EncDecCfg):
        @torch.no_grad()
        def step(model, batch):
            enc_out = encdec.encode(model, batch["frontend_embeds"])
            h = encdec.decode_train(model, enc_out, batch["tokens"])
            return encdec.logits_from_h(model, h[:, -1:])[:, 0], enc_out
        return step

    @torch.no_grad()
    def step(model, batch):
        return lm.prefill(model, batch["tokens"],
                          batch.get("frontend_embeds"))
    return step


def make_serve_step(cfg) -> Callable:
    """``step(model, cache, tokens, pos) -> (logits, cache)``."""
    decode = encdec.decode_step if isinstance(cfg, EncDecCfg) \
        else lm.decode_step
    return torch.no_grad()(decode)


def init_state(model, optimizer: Optimizer) -> dict:
    """``{"params": param_tree(model), "opt": optimizer.init(params),
    "step": 0}``, the step a 0-d int32 tensor on the model's device.
    The reference draws the parameters here from a key; the port's come
    from ``init_params(cfg, key, device)`` (the same bits from the same
    key) or ``params_from_numpy``."""
    params = param_tree(model)
    device = next(model.parameters()).device
    return {"params": params, "opt": optimizer.init(params,
                                                    **split_kw(model)),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_spec_tree(cfg, ctx: sharding.ShardCtx, optimizer: Optimizer,
                    abstract_params) -> dict:
    """Sharding specs of :func:`init_state`'s tree: the parameters', the
    optimizer state's (``optimizer.state_specs`` over ``abstract_params``,
    a :func:`param_tree`, e.g. of ``lm.abstract_params(cfg)``) and a
    replicated step."""
    pspecs = sharding.param_specs(cfg, ctx)
    ospecs = optimizer.state_specs(abstract_params, pspecs, ctx)
    return {"params": pspecs, "opt": ospecs, "step": ()}
