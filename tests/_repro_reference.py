"""The JAX package as the reference for the PyTorch port's tests.

Under the installed JAX, ``from jax.experimental import enable_x64`` fails,
and with it every import of ``repro.neuromorphic``.  :func:`reference`
aliases ``jax.experimental.enable_x64`` to ``jax.enable_x64`` only while
the port's tests hold the reference, and on exit takes back the alias and
every ``repro`` module it imported.  Other test files in the same worker
process then see exactly the import state they would have seen without
it.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import types

MODULES = {
    "neuromorphic": "repro.neuromorphic",
    "network": "repro.neuromorphic.network",
    "compute": "repro.neuromorphic.compute",
    "noc": "repro.neuromorphic.noc",
    "partition": "repro.neuromorphic.partition",
    "platform": "repro.neuromorphic.platform",
    "timestep": "repro.neuromorphic.timestep",
    "floorline": "repro.core.floorline",
    "partitioner": "repro.core.partitioner",
    "guidance": "repro.core.guidance",
    "kernels": "repro.kernels",
    "em_ops": "repro.kernels.event_matmul.ops",
    "em_ref": "repro.kernels.event_matmul.ref",
    "sd_ops": "repro.kernels.sigma_delta.ops",
    "sd_ref": "repro.kernels.sigma_delta.ref",
    "frontend": "repro.neuromorphic.frontend",
    "registry": "repro.configs.registry",
    "flash_ops": "repro.kernels.flash_attn.ops",
    "flash_ref": "repro.kernels.flash_attn.ref",
    "profile": "repro.sparsity.profile",
    "sd_sparsity": "repro.sparsity.sigma_delta",
    "resilience": "repro.core.resilience",
    "search": "repro.core.search",
    "checkpoint": "repro.train.checkpoint",
}


def _is_repro(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@contextlib.contextmanager
def reference():
    """Yield a namespace of the reference's modules (see :data:`MODULES`)."""
    import jax
    import jax.experimental

    before = {n for n in sys.modules if _is_repro(n)}
    aliased = not hasattr(jax.experimental, "enable_x64")
    if aliased:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        yield types.SimpleNamespace(**{
            key: importlib.import_module(name)
            for key, name in MODULES.items()})
    finally:
        if aliased:
            del jax.experimental.enable_x64
        for name in [n for n in sys.modules
                     if _is_repro(n) and n not in before]:
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if parent and getattr(sys.modules.get(parent), child,
                                  None) is mod:
                delattr(sys.modules[parent], child)
