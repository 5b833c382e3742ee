"""Meshes on one card (PyTorch port of ``repro.launch.mesh``).

The reference builds its production meshes, (16, 16) ("data", "model")
on one 256-chip TPU v5e pod and (2, 16, 16) ("pod", "data", "model") on
512 chips, and forces the host's placeholder device count through
``XLA_FLAGS`` before JAX starts.  The port runs on one card: the only
mesh is a single device, and the XLA flag functions have no counterpart.
"""

from __future__ import annotations

import math


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]
              ) -> tuple[str, ...]:
    """A mesh of one device: ``shape`` must hold one device (every entry
    1); returns its axis names.  More than one device raises, as
    ``train.loop.Trainer`` does."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh {tuple(shape)} against axes {tuple(axes)}")
    if math.prod(shape) != 1:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         "devices; the port runs on one device")
    return tuple(axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh, which one card cannot hold."""
    n, shape = (512, (2, 16, 16)) if multi_pod else (256, (16, 16))
    raise RuntimeError(f"the production mesh {shape} needs {n} chips; the "
                       "port runs on one card (launch.dryrun counts each "
                       "cell on it)")
