"""Magnitude pruning + fine-tune (paper §VII-A, S5 workload).

One-shot per-tensor magnitude pruning to a target weight sparsity followed
by masked fine-tuning — the S5 stage-1 recipe ("prune the smallest
0.1..0.9 of weights away in one shot, and fine-tune").

A "tree" argument is a tensor, or dicts, lists and tuples of tensors; its
leaves are visited in the JAX package's pytree order (dict keys sorted),
and every result keeps its structure.  Masks live on their tensor's
device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def _kept(n: int, sparsity) -> int:
    """``round(n * (1 - sparsity))`` in float32, as the JAX package computes
    it (``n`` rounded to float32 first; half to even), clipped to [0, n]."""
    k = np.float32(n) * (np.float32(1.0) - np.float32(float(sparsity)))
    return int(min(max(np.round(k), np.float32(0.0)), np.float32(n)))


def magnitude_prune_masks(params, sparsity, *, min_size: int = 64):
    """0/1 float32 masks keeping the largest-|w| (1-sparsity) fraction per
    tensor.  Tensors smaller than ``min_size`` (biases, norms) and vectors
    are never pruned.

    Each mask keeps exactly ``round(size * (1 - sparsity))`` entries
    through a stable descending argsort, so value ties break toward the
    lowest flat index, as in the JAX package."""
    def one(p):
        if p.numel() < min_size or p.dim() < 2:
            return torch.ones(p.shape, dtype=torch.float32, device=p.device)
        flat = p.detach().to(torch.float32).abs().reshape(-1)
        n = flat.numel()
        order = torch.argsort(-flat, stable=True)      # ties -> lowest index
        keep = (torch.arange(n, device=p.device) < _kept(n, sparsity)
                ).to(torch.float32)
        mask = torch.zeros(n, dtype=torch.float32, device=p.device)
        mask[order] = keep
        return mask.reshape(p.shape)
    return tree_map(one, params)


def apply_masks(params, masks):
    return tree_map(lambda p, m: (p.to(torch.float32) * m).to(p.dtype),
                     params, masks)


def weight_sparsity(params, masks=None) -> float:
    leaves = tree_leaves(masks if masks is not None else params)
    nz = sum(int((m != 0).sum()) for m in leaves)
    tot = sum(m.numel() for m in leaves)
    return 1.0 - nz / max(tot, 1)


def prune_and_finetune_sweep(params, train_steps: Callable,
                             sparsities: list[float],
                             finetune_steps: int = 50):
    """For each target sparsity: one-shot prune -> masked fine-tune.
    ``train_steps(params, masks, n)`` must return (params, final_metrics).
    Returns [(sparsity, params, metrics), ...] — the Fig. 10 Pareto sweep."""
    out = []
    for s in sparsities:
        masks = magnitude_prune_masks(params, s)
        pruned = apply_masks(params, masks)
        tuned, metrics = train_steps(pruned, masks, finetune_steps)
        tuned = apply_masks(tuned, masks)        # keep exactly masked
        out.append((s, tuned, metrics))
    return out
