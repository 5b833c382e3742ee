"""Meshes on one card (PyTorch port of ``repro.launch.mesh``).

The reference builds its production meshes, (16, 16) ("data", "model")
on one 256-chip TPU v5e pod and (2, 16, 16) ("pod", "data", "model") on
512 chips, and forces the host's placeholder device count through
``XLA_FLAGS`` before JAX starts.  The port runs on one card: the only
mesh is a single device, and the XLA flag functions have no counterpart.
"""

from __future__ import annotations

import math

#: The reference's production meshes as axis-name -> size mappings, in axis
#: order: one 256-chip pod and two pods of 256 chips.
PRODUCTION_MESHES = {"pod": {"data": 16, "model": 16},
                     "multipod": {"pod": 2, "data": 16, "model": 16}}


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
    shape = tuple(PRODUCTION_MESHES["multipod" if multi_pod
                                    else "pod"].values())
    n = math.prod(shape)
    raise RuntimeError(f"the production mesh {shape} needs {n} chips; the "
                       "port runs on one card (launch.dryrun counts each "
                       "cell on it)")
