"""Plain PyTorch version of a layer's neuron epilogue: the eager glue that
follows the synaptic forward in ``SimLayer.step_batch``."""

from __future__ import annotations

import torch

#: Neuron codes: the identity (a stateful neuron's messages, computed
#: already), relu, and force-active relu ``|pre| + 1``.
IDENTITY, RELU, FORCE_ACTIVE = 0, 1, 2


def neuron_epilogue_ref(pre: torch.Tensor, macs: torch.Tensor,
                        bias: torch.Tensor | None,
                        gate: torch.Tensor | None, code: int
                        ) -> tuple[torch.Tensor, ...]:
    """Bias, neuron ``code`` and message gate on the (T, n) block ``pre``,
    and the counter maps: returns ``(y_msgs, msgs_out, acts_evented,
    counts, counts64)``, where ``msgs_out`` is ``y_msgs != 0`` and
    ``acts_evented`` is ``macs > 0`` as float32 maps, and ``counts`` the
    per-step message counts (float32 and float64).  The identity without
    bias or gate returns ``pre`` itself as ``y_msgs``."""
    if bias is not None:
        pre = pre + bias
    if code == RELU:
        y = torch.clamp_min(pre, 0.0)
    elif code == FORCE_ACTIVE:
        y = pre.abs() + 1.0
    elif code == IDENTITY:
        y = pre
    else:
        raise ValueError(f"unknown neuron code {code}")
    if gate is not None:
        y = y * gate
    msgs_out = (y != 0).to(torch.float32)
    counts = msgs_out.sum(dim=1)
    return (y, msgs_out, (macs > 0).to(torch.float32), counts,
            counts.to(torch.float64))
