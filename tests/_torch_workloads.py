"""The reference search suite's workloads (``tests/test_search.py``), built
in both packages from the same numpy draws: bit-identical weights, gates
and inputs."""

from __future__ import annotations

import numpy as np

from repro_torch.neuromorphic import (make_inputs, network_from_numpy,
                                      programmed_fc_network)
from repro_torch.neuromorphic.network import _exact_density_mask

CPU = dict(device="cpu")


def fc_pair(ref, sizes=(192, 256, 256, 128), wd=0.6, ad=0.3, steps=3):
    """``fc_workload``: (reference net, port net, inputs as numpy)."""
    kw = dict(weight_densities=[wd] * (len(sizes) - 1),
              act_densities=[ad] * (len(sizes) - 1), seed=0,
              weight_format="sparse")
    net_r = ref.network.programmed_fc_network(list(sizes), **kw)
    net_p = programmed_fc_network(list(sizes), **kw, **CPU)
    xs = ref.network.make_inputs(sizes[0], ad, steps, seed=1)
    assert np.array_equal(xs, make_inputs(sizes[0], ad, steps, seed=1,
                                          **CPU).numpy())
    return net_r, net_p, xs


def conv_specs(seed=2, fc_out=10, mask_density=0.6):
    """The conv -> conv -> fc stack (8x8x2 input, 3x3 stride-2 convs of 4
    and 8 channels) as field mappings: ``conv_workload``'s by default, the
    ``conv_fc_profile_event`` golden fixture's with ``seed=23, fc_out=12,
    mask_density=None`` (no weight mask, so no mask draws)."""
    rng = np.random.default_rng(seed)
    specs, h, w, c_prev = [], 8, 8, 2
    for i, c in enumerate((4, 8)):
        wgt = rng.normal(0, 1 / 3.0, (3, 3, c_prev, c)).astype(np.float32)
        if mask_density is not None:
            wgt *= _exact_density_mask(wgt.shape, mask_density, rng)
        specs.append(dict(name=f"conv{i}", kind="conv", weights=wgt,
                          stride=2, in_hw=(h, w)))
        h, w, c_prev = h // 2, w // 2, c
    wfc = rng.normal(0, 0.3, (h * w * c_prev, fc_out)).astype(np.float32)
    specs.append(dict(name="fc", kind="fc", weights=wfc))
    return specs


def conv_pair(ref, steps=3):
    """``conv_workload``: (reference net, port net, inputs as numpy)."""
    specs = conv_specs()
    net_r = ref.network.SimNetwork(
        layers=[ref.network.SimLayer(**s) for s in specs], in_size=128)
    net_p = network_from_numpy(specs, 128, **CPU)
    return net_r, net_p, ref.network.make_inputs(128, 0.4, steps, seed=3)

