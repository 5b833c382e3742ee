"""Plain PyTorch version of the ssm state neurons' recurrence."""

from __future__ import annotations

import torch


def ssm_scan_ref(pre: torch.Tensor, x0: torch.Tensor, decay: float,
                 force_active: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``x[t] = decay * x[t-1] + pre[t]`` from ``x0`` over the (T, n)
    pre-activations, one vectorised step at a time; returns the (T, n)
    messages (``|x[t]| + 1`` when ``force_active``, else ``x[t]``) and
    the final state.  ``x0`` is never written."""
    x = x0
    y = torch.empty_like(pre)
    for t in range(pre.shape[0]):
        x = decay * x + pre[t]
        y[t] = x.abs() + 1.0 if force_active else x
    return y, x
