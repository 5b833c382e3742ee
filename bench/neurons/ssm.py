"""The ``ssm`` neuron model: a linear state ``x[t] = decay * x[t-1] +
pre[t]`` from zero; a force-active neuron sends ``|x| + 1``."""

import torch


def messages(layer, pre):
    """(T, n) pre-activations -> the (T, n) messages the layer sends."""
    x = torch.zeros_like(pre[0])
    y = torch.empty_like(pre)
    for t in range(pre.shape[0]):
        x = layer.decay * x + pre[t]
        y[t] = x.abs() + 1.0 if layer.force_active else x
    return y
