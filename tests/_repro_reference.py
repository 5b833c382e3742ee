"""The JAX package as the reference for the PyTorch port's tests.

Under the installed JAX, ``from jax.experimental import enable_x64`` fails,
and with it every import of ``repro.neuromorphic``.  :func:`reference`
aliases ``jax.experimental.enable_x64`` to ``jax.enable_x64`` only while
the port's tests hold the reference, and on exit takes back the alias and
every ``repro`` module it imported.  Other test files in the same worker
process then see exactly the import state they would have seen without
it.  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is imported (512
placeholder devices); :func:`reference` puts the variable back as it was
right after the import, before anything can start JAX's backend with it.
"""

from __future__ import annotations

import contextlib
import importlib
import os
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
    "device_search": "repro.core.device_search",
    "checkpoint": "repro.train.checkpoint",
    "sparsity": "repro.sparsity",
    "pruning": "repro.sparsity.pruning",
    "regularizers": "repro.sparsity.regularizers",
    "train": "repro.train",
    "train_data": "repro.train.data",
    "train_sparse": "repro.train.sparse",
    "layers": "repro.models.layers",
    "lm": "repro.models.lm",
    "moe": "repro.models.moe",
    "encdec": "repro.models.encdec",
    "sharding": "repro.distributed.sharding",
    "engine": "repro.serve.engine",
    "optim": "repro.train.optim",
    "schedules": "repro.train.schedules",
    "step": "repro.train.step",
    "loop": "repro.train.loop",
    "collectives": "repro.distributed.collectives",
    "shapes": "repro.configs.shapes",
    "hlo_cost": "repro.core.hlo_cost",
    "tpu_floorline": "repro.core.tpu_floorline",
    "autoshard": "repro.distributed.autoshard",
    "dryrun": "repro.launch.dryrun",
}


def auto_mesh():
    """A one-device ("data", "model") mesh with ``Auto`` axes.  The
    reference's ``single_device_mesh`` makes ``Explicit`` axes under the
    installed JAX, on which its sharding constraints raise; with ``Auto``
    axes its model and serving code run (MoE needs a mesh)."""
    import jax
    import numpy as np
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=np.array(jax.devices()[:1]))


def _is_repro(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


def _import(name: str):
    """``name`` imported with ``XLA_FLAGS`` kept as it was."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


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
            key: _import(name) for key, name in MODULES.items()})
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
