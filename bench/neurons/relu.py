"""The ``relu`` neuron model: stateless; a force-active neuron sends
``|pre| + 1``, so every neuron messages every step."""


def messages(layer, pre):
    """(T, n) pre-activations -> the (T, n) messages the layer sends."""
    return pre.abs() + 1.0 if layer.force_active else pre.clamp_min(0.0)
