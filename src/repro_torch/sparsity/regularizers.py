"""Stage-1 sparsity-aware training losses (paper §VI-B / §VII-A).

* ``tl1_regularizer``  — transformed-L1 activation penalty [63]:
  rho_a(x) = (a+1)|x| / (a + |x|): near-L0 for small a, used to induce ReLU
  activation sparsity on AKD1000-style CNNs (applied to the pre-trained
  baseline, then fine-tuned).
* ``synops_loss``      — Sorbaro et al. [50] synaptic-operation loss: the
  expected downstream synops of each layer's activations (activation count
  weighted by fan-out), matching the paper's Speck training setup.  This is
  the neurocore-aware (M0) training signal: per-LAYER sums are returned so
  imbalanced layers can be targeted.

Differentiable through ``torch.autograd``, with JAX's gradients: ``|x|``
has slope +1 at 0 (``torch.abs`` has 0).  Every sum runs in float32, and
every division by a count is a product with the count's float32
reciprocal, as XLA compiles the JAX package's division by a constant.
XLA's CPU sums run sequentially, torch's pairwise, so the JAX package's
values carry a larger roundoff (2e-6 relative on 768 terms, where the
port's stays within 1e-7 of the exact sum).
"""

from __future__ import annotations

import numpy as np
import torch


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` as XLA runs it: ``x`` times the float32 ``1 / n``."""
    r = np.float32(1.0) / np.float32(n)
    return x * torch.tensor(r, dtype=torch.float32, device=x.device)


def _mean(x: torch.Tensor) -> torch.Tensor:
    return _div(x.sum(), x.numel())


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose gradient is JAX's: +1 for x >= 0, else -1."""
    return torch.where(x >= 0, x, -x)


def tl1_regularizer(acts: list[torch.Tensor], a: float = 1.0,
                    weights=None) -> torch.Tensor:
    """Transformed-L1 penalty over a list of (post-ReLU) activations.

    ``weights`` — optional per-layer multipliers (e.g. the floorline-guided
    weights of :func:`repro_torch.core.guidance.floorline_layer_weights`):
    layer ``l``'s mean penalty is scaled by ``weights[l]`` so bottleneck
    layers are pushed toward sparsity hardest.  ``None`` keeps the
    unweighted element-mean."""
    dev = acts[0].device if acts else None
    total = torch.zeros((), dtype=torch.float32, device=dev)
    if weights is None:
        count = 0
        for x in acts:
            ax = _abs(x.to(torch.float32))
            total = total + ((a + 1.0) * ax / (a + ax)).sum()
            count += x.numel()
        return _div(total, max(count, 1))
    for x, w in zip(acts, weights):
        ax = _abs(x.to(torch.float32))
        total = total + float(w) * _mean((a + 1.0) * ax / (a + ax))
    return _div(total, max(len(acts), 1))


def activation_density(acts: list[torch.Tensor], thresh: float = 0.0):
    """Per-layer and total activation density (fraction > thresh), as
    float32 0-d tensors."""
    per_layer = [_mean((x > thresh).to(torch.float32)) for x in acts]
    total = torch.zeros((), dtype=torch.float32,
                        device=acts[0].device if acts else None)
    for x in acts:
        total = total + (x > thresh).to(torch.float32).sum()
    return per_layer, _div(total, max(sum(x.numel() for x in acts), 1))


def synops_loss(acts: list[torch.Tensor], fanouts: list[int],
                surrogate: str = "abs", weights=None) -> torch.Tensor:
    """Expected synops: sum_l weight_l * fanout_l * E[activity_l].

    ``surrogate``: 'abs' uses |a| (differentiable proxy for spike counts /
    message magnitude); 'count' uses a straight-through 0/1 estimate (the
    0/1 count forward, the identity's gradient backward).
    ``weights`` — optional per-layer multipliers (floorline guidance);
    ``None`` is the unweighted loss."""
    if weights is None:
        weights = [1.0] * len(acts)
    dev = acts[0].device if acts else None
    total = torch.zeros((), dtype=torch.float32, device=dev)
    norm = 0.0
    for x, f, w in zip(acts, fanouts, weights):
        xf = x.to(torch.float32)
        if surrogate == "abs":
            act = _abs(xf)
        else:
            hard = (xf > 0).to(torch.float32)
            act = hard + xf - xf.detach()              # straight-through
        total = total + float(w) * f * _mean(act)
        norm += f
    return _div(total, max(norm, 1.0))
